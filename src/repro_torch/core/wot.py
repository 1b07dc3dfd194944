"""WOT — Weight-distribution-Oriented Training constraint (paper §4.1).

Counterpart of ``repro.core.wot`` (``throttle_q`` and
``is_protected_weight``): in every 8-value block of a flattened quantized
weight, the first seven values must lie in [-64, 63]; only the eighth may
be large. That frees bit 6 of bytes 0..6 for the in-place check bits.
"""
from __future__ import annotations

import torch

WOT_LO = -64
WOT_HI = 63
BLOCK = 8


def throttle_q(q_flat: torch.Tensor) -> torch.Tensor:
    """Clamp positions 0..6 of each 8-value block to [-64, 63] (int domain).
    Returns a new tensor; a ragged tail is padded for the clamp and cut."""
    n = q_flat.shape[0]
    pad = (-n) % BLOCK
    out = torch.cat([q_flat, q_flat.new_zeros(pad)]) if pad else q_flat.clone()
    blocks = out.view(-1, BLOCK)
    blocks[:, : BLOCK - 1].clamp_(WOT_LO, WOT_HI)
    return out[:n] if pad else out


_EXCLUDED_NAMES = {"b", "bq", "bk", "bv", "dt_bias", "A_log", "D", "a_param",
                   "scale", "bias", "mean", "var"}
_EXCLUDED_PATH_PARTS = ("ln", "norm", "bn")


def is_protected_weight(path, leaf) -> bool:
    """The paper protects *weights* (matmul/conv/embedding tensors), not
    norm scales or biases. ``path`` is a tuple of keys; ``leaf`` anything
    with ``ndim`` and a torch ``dtype`` (a tensor or a shape record)."""
    dtype = getattr(leaf, "dtype", None)
    if not (getattr(leaf, "ndim", 0) >= 2 and
            getattr(dtype, "is_floating_point", False)):
        return False
    names = [str(p) for p in path]
    if not names:
        return True
    last = names[-1]
    if last in _EXCLUDED_NAMES or last.startswith("b_"):
        return False
    return not any(part in comp for comp in names
                   for part in _EXCLUDED_PATH_PARTS)

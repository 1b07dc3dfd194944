"""WOT — Weight-distribution-Oriented Training constraint (paper §4.1).

Counterpart of ``repro.core.wot``: in every 8-value block of a flattened
quantized weight, the first seven values must lie in [-64, 63]; only the
eighth may be large. That frees bit 6 of bytes 0..6 for the in-place check
bits. The QATT step (:func:`throttle_tensor_`, in place, and
:func:`throttle_tensor`, :func:`throttle_tree`) quantizes the f32 masters,
clamps, and writes the clamped values back into the masters on the route
``backend`` picks (``"cuda"``: one ``quantize_throttle`` kernel call with
its write-back).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree

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


def as_blocks(w: torch.Tensor) -> torch.Tensor:
    """Flatten and zero-pad to whole blocks -> (nblk, 8)."""
    flat = w.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return (F.pad(flat, (0, pad)) if pad else flat).view(-1, BLOCK)


def throttle_tensor_(w: torch.Tensor, *, backend="torch", with_q=False):
    """QATT throttling step on an f32 weight tensor, IN PLACE: quantize,
    clamp positions 0..6 of every block, and write the weights the clamp
    moved back into ``w`` as ``qt * scale`` (the others keep their f32
    value), as the reference's ``throttle_tensor`` computes them. On
    "cuda" one call of the ``quantize_throttle`` kernel with its
    write-back (``w`` contiguous); its plain version is ``w.copy_(
    throttle_tensor(w))``.

    The zero padding of a ragged tail changes neither the scale nor any
    real value's ``q``. With ``with_q`` returns ``(w, q int8 (w.shape),
    scale f32 ())``, else ``w``."""
    from repro_torch.distributed import local
    from repro_torch.protection.backends import get_backend
    if local.is_dtensor(w):   # a sharded master: each shard in place
        return local.throttle_(w, backend=backend, with_q=with_q)
    q, scale = get_backend(backend).quantize_throttle(w, write_back=True,
                                                      with_q=with_q)
    return (w, q, scale) if with_q else w


def throttle_tensor(w: torch.Tensor, *, backend="torch", with_q=False):
    """:func:`throttle_tensor_` on a contiguous copy of ``w``: the QATT step
    of the reference's ``throttle_tensor``, returning a new tensor (with
    ``with_q``: ``(w', q, scale)``)."""
    return throttle_tensor_(w.clone(memory_format=torch.contiguous_format),
                            backend=backend, with_q=with_q)


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
    # a NamedTuple field reads as "", as the reference's GetAttrKey does
    names = ["" if isinstance(p, tree.Field) else str(p) for p in path]
    if not names:
        return True
    last = names[-1]
    if last in _EXCLUDED_NAMES or last.startswith("b_"):
        return False
    return not any(part in comp for comp in names
                   for part in _EXCLUDED_PATH_PARTS)


def throttle_tree(params, predicate=None, *, backend="torch"):
    """:func:`throttle_tensor` on every protected weight of a nested dict
    (``predicate(path, leaf)``, default :func:`is_protected_weight`); other
    leaves pass through. Returns a new tree."""
    pred = predicate or is_protected_weight
    return tree.map_with_path(
        lambda path, w: throttle_tensor(w, backend=backend)
        if pred(path, w) else w, params)


# --------------------------- census / diagnostics ---------------------------


def _large(q_flat: torch.Tensor) -> torch.Tensor:
    blocks = as_blocks(q_flat)
    return (blocks > WOT_HI) | (blocks < WOT_LO)


def count_large_in_protected(q_flat: torch.Tensor) -> torch.Tensor:
    """# of values outside [-64, 63] in positions 0..6 (paper Fig. 3)."""
    return _large(q_flat)[:, : BLOCK - 1].sum()


def large_position_histogram(q_flat: torch.Tensor) -> torch.Tensor:
    """Per-byte-position histogram of large values (paper Fig. 1)."""
    return _large(q_flat).sum(dim=0)


def range_percentages(q_flat) -> dict:
    """% of |q| in [0,32), [32,64), [64,128] (paper Table 1 rows)."""
    if isinstance(q_flat, torch.Tensor):
        q_flat = q_flat.cpu().numpy()
    a = np.abs(np.asarray(q_flat).astype(np.int32))
    n = max(a.size, 1)
    return {
        "[0,32)": float((a < 32).sum()) / n * 100,
        "[32,64)": float(((a >= 32) & (a < 64)).sum()) / n * 100,
        "[64,128]": float((a >= 64).sum()) / n * 100,
    }


def satisfies_constraint(q_flat: torch.Tensor) -> bool:
    return int(count_large_in_protected(q_flat)) == 0

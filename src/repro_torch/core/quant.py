"""Symmetric range-based linear 8-bit quantization (paper §3, Eq. 1).

Counterpart of ``repro.core.quant`` (``compute_scale`` and ``quantize``).
``X^q = round(X * 127 / max|X|)``; ``torch.round`` rounds half to even, as
``jnp.round`` does, so the integers match the reference exactly.
"""
from __future__ import annotations

import torch

QMAX = 127  # 2**(8-1) - 1


def compute_scale(x: torch.Tensor, dim=None, eps: float = 1e-12):
    """Scale such that q = round(x / scale): per tensor (``dim=None``) or
    over ``dim`` with the reduced dims kept."""
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=dim, keepdim=True)
    return amax.clamp_min(eps) / QMAX


def quantize(x: torch.Tensor, scale=None, dim=None):
    """-> (q int8 in [-127, 127], scale)."""
    if scale is None:
        scale = compute_scale(x, dim=dim)
    q = (x / scale).round_().clamp_(-QMAX, QMAX).to(torch.int8)
    return q, scale

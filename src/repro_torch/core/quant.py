"""Symmetric range-based linear 8-bit quantization (paper §3, Eq. 1).

Counterpart of ``repro.core.quant`` (``compute_scale``, ``quantize``,
``dequantize`` and ``fake_quant``). ``X^q = round(X * 127 / max|X|)``;
``torch.round`` rounds half to even, as ``jnp.round`` does, so the integers
match the reference exactly.
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
    # divide by a tensor on amax's device: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, one ulp off the reference
    # (and the quantize kernels) at times
    qmax = torch.full((), QMAX, dtype=amax.dtype, device=amax.device)
    return amax.clamp_min(eps) / qmax


def quantize(x: torch.Tensor, scale=None, dim=None):
    """-> (q int8 in [-127, 127], scale)."""
    if scale is None:
        scale = compute_scale(x, dim=dim)
    q = (x / scale).round_().clamp_(-QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    dtype = scale.dtype if isinstance(scale, torch.Tensor) else torch.float32
    return q.to(dtype) * scale


def fake_quant(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Quantize-dequantize with the straight-through estimator: the value is
    the dequantized weight, the gradient the identity (paper §4.1 QATT).

    Kept as the reference writes it, ``x + (fq - x)`` with the difference
    detached: returning ``fq`` itself would round differently."""
    with torch.no_grad():
        scale = compute_scale(x, dim=dim)
        fq = (x / scale).round_().clamp_(-QMAX, QMAX).mul_(scale)
        delta = fq.sub_(x)
    return x + delta

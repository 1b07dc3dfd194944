"""Symmetric range-based linear 8-bit quantization (paper §3, Eq. 1).

Counterpart of ``repro.core.quant`` (``compute_scale``, ``quantize``,
``dequantize``, ``fake_quant``, ``quantize_bias``, ``int8_acc`` and
``int8_matmul``). ``X^q = round(X * 127 / max|X|)``; ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the integers match the reference
exactly.
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


def quantize_bias(b: torch.Tensor, scale):
    """Biases -> int32 at the accumulator scale (paper §3)."""
    return torch.round(b / scale).to(torch.int32), scale


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Exact int64 integers -> int32 modulo 2^32, as int32 arithmetic
    wraps."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def int8_acc(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator of :func:`int8_matmul`: ``a_q (..., K)
    @ w_q (K, N)`` over int8 values, wrapped modulo 2^32 as the reference's
    int32 dot does.

    PyTorch has no integer matmul on CUDA, so the product is taken in
    float64 on every device: each partial sum is an integer of magnitude at
    most 128^2 * K, below 2^53 for any K under 2^39, so every sum is exact
    whatever the summation order; the result is then wrapped to int32."""
    acc = a_q.to(torch.float64) @ w_q.to(torch.float64)
    return wrap_int32(acc.to(torch.int64))


def int8_matmul(a_q: torch.Tensor, w_q: torch.Tensor, a_scale,
                w_scale) -> torch.Tensor:
    """Quantized matmul with int32 accumulation -> f32 output:
    ``acc.float() * (a_scale * w_scale)``, the scale product formed first,
    in f32."""
    acc = int8_acc(a_q, w_q)
    a_scale = torch.as_tensor(a_scale, dtype=torch.float32, device=acc.device)
    w_scale = torch.as_tensor(w_scale, dtype=torch.float32, device=acc.device)
    return acc.to(torch.float32) * (a_scale * w_scale)

"""Fused in-place-ECC decode + matmul, float path.

Replaces the float path of ``repro/kernels/ecc_qmatmul.py::ecc_qmatmul``
(``csrc/ecc_qmatmul.cu``): ``a (M,K) @ dequant(decode(w_enc (K,N)))`` with
the decode inside the matmul tile, f32 accumulation, and (corrected, DUE)
counts over every weight block. At decode batch it is bound by reading the
encoded weight once (K*N bytes).

The int8, requantize, ABFT, clamp and ``fault_bits`` variants of the
reference are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.core import ecc

from . import build

_FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def ecc_qmatmul_plain(a: torch.Tensor, w_enc: torch.Tensor,
                      w_scale: torch.Tensor):
    """-> ``(out (M, N) f32, flags (2,) int32)`` with
    ``out = a @ (decode(w_enc) * w_scale).astype(a.dtype)`` accumulated in
    f32 and flags = (#single-corrected, #double-detected) blocks."""
    k, n = w_enc.shape
    dec, single, double = ecc.decode64(w_enc.reshape(k, n // 8, 8))
    q = dec.reshape(k, n).view(torch.int8)
    w = (q.to(torch.float32) * w_scale).to(a.dtype)
    out = a.to(torch.float32) @ w.to(torch.float32)
    flags = torch.stack([single.sum(), double.sum()]).to(torch.int32)
    return out, flags


def ecc_qmatmul(a: torch.Tensor, w_enc: torch.Tensor, w_scale=None, *,
                a_scale=None, bias=None, out_dtype=None,
                with_abft: bool = False, clamp=None, fault_bits: int = 0):
    """Kernel wrapper of :func:`ecc_qmatmul_plain` (float ``a`` only);
    returns ``(out (M, N) f32, flags (2,) int32)``."""
    if not a.dtype.is_floating_point:
        raise NotImplementedError("ecc_qmatmul: the int8 accumulator and "
                                  "requantize paths are not ported yet")
    if (a_scale is not None or bias is not None or out_dtype is not None
            or with_abft or clamp is not None or fault_bits):
        raise NotImplementedError("ecc_qmatmul: a_scale/bias/out_dtype/ABFT/"
                                  "clamp/fault_bits are not ported yet")
    if w_scale is None:
        raise ValueError("float activations need w_scale")
    if a.ndim != 2 or w_enc.ndim != 2 or a.shape[1] != w_enc.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(w_enc.shape)}")
    m, k = a.shape
    n = w_enc.shape[1]
    if w_enc.dtype != torch.uint8 or n % 8:
        raise ValueError("w_enc must be uint8 with N % 8 == 0")
    w_scale = torch.as_tensor(w_scale, dtype=torch.float32,
                              device=w_enc.device)
    if not a.is_cuda:
        return ecc_qmatmul_plain(a, w_enc, w_scale)
    if a.dtype not in _FLOAT_DTYPES:
        raise ValueError(f"ecc_qmatmul kernel takes f32 or bf16, got {a.dtype}")
    if not (w_enc.is_cuda and w_enc.device == a.device):
        raise ValueError("a and w_enc must be on the same CUDA device")
    if max(m, n, k) >= 2 ** 31 or m * k >= 2 ** 62:
        raise ValueError("ecc_qmatmul: dimensions exceed the kernel's int32 "
                         "indexing")
    a = a.contiguous()
    w_enc = w_enc.contiguous()
    if w_enc.data_ptr() % 8:
        raise ValueError("w_enc must be 8-byte aligned")
    scale = w_scale.reshape(1).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    flags = torch.zeros(2, dtype=torch.int32, device=a.device)
    if m and n:
        fn = build.entry("ecc_qmatmul_float_launch")
        build.check(fn(a.data_ptr(), w_enc.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), flags.data_ptr(), m, n, k,
                       int(a.dtype == torch.bfloat16),
                       build.stream_ptr(a.device)), "ecc_qmatmul")
        build.COUNTS["ecc_qmatmul"] += 1
    return out, flags

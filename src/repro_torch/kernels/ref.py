"""Plain PyTorch oracles of the fused matmul's guards.

Counterpart of ``repro/kernels/ref.py`` (``ecc_qmatmul_ref``,
``abft_counts`` and ``clamp_counts``): the decode-then-matmul int32
accumulator, the ABFT checksum pair and the activation-range clamp. The
plain version of ``ecc_qmatmul`` and the ``torch`` route of the serve path
use these; the CUDA kernel is held to them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import ecc, quant

# the float-path tolerance of the reference kernel (ecc_qmatmul.py:82-83)
ABFT_RTOL = 1e-4
ABFT_ATOL = 1e-6


def ecc_qmatmul_ref(a_q: torch.Tensor, w_enc: torch.Tensor) -> torch.Tensor:
    """Decode-then-matmul: ``a_q (M, K) int8 @ decode(w_enc (K, N) uint8)``
    -> the exact (M, N) int32 accumulator."""
    k, n = w_enc.shape
    dec, _, _ = ecc.decode64(w_enc.reshape(k, n // 8, 8))
    return quant.int8_acc(a_q, dec.reshape(k, n).view(torch.int8))


def abft_counts(a: torch.Tensor, w: torch.Tensor, acc: torch.Tensor, *,
                rtol: float = ABFT_RTOL, atol: float = ABFT_ATOL):
    """ABFT check of ``acc`` against ``a @ w``: each row sum of ``acc``
    (over all of N) against ``a @ rowsum(w)``, each column sum (over all of
    M) against ``colsum(a) @ w``.

    An integer ``acc`` compares exactly in int32 modular arithmetic, as the
    reference's int32 sums and dots wrap: both sides are taken exactly
    (int64 sums; float64 products and sums of integers below 2^53) and
    wrapped modulo 2^32. A float ``acc`` is compared in f32 within ``atol +
    rtol * (|a| @ |w|)`` of the checksum.

    -> ``(row_bad (M,) int32, col_bad (N,) int32)`` 0/1 flags."""
    if not acc.dtype.is_floating_point:
        a64, w64 = a.to(torch.float64), w.to(torch.float64)
        acc64 = acc.to(torch.int64)
        rs_acc = quant.wrap_int32(acc64.sum(1))
        rs_ref = quant.wrap_int32((a64 @ w64.sum(1)).to(torch.int64))
        cs_acc = quant.wrap_int32(acc64.sum(0))
        cs_ref = quant.wrap_int32((a64.sum(0) @ w64).to(torch.int64))
        row_bad, col_bad = rs_acc != rs_ref, cs_acc != cs_ref
    else:
        a_c, w_c = a.to(torch.float32), w.to(torch.float32)
        acc = acc.to(torch.float32)
        rs_acc, cs_acc = acc.sum(1), acc.sum(0)
        rs_ref = a_c @ w_c.sum(1)
        cs_ref = a_c.sum(0) @ w_c
        a_abs, w_abs = a_c.abs(), w_c.abs()
        rs_sc = a_abs @ w_abs.sum(1)
        cs_sc = a_abs.sum(0) @ w_abs
        row_bad = (rs_acc - rs_ref).abs() > atol + rtol * rs_sc
        col_bad = (cs_acc - cs_ref).abs() > atol + rtol * cs_sc
    return row_bad.to(torch.int32), col_bad.to(torch.int32)


def clamp_counts(y: torch.Tensor, clamp):
    """Activation-range supervision: clip ``y`` to ``[-c, +c]`` and count
    the out-of-range values per row. -> ``(clipped, hits (M,) int32)``."""
    c = torch.as_tensor(clamp, dtype=torch.float32, device=y.device)
    hits = (y.to(torch.float32).abs() > c).sum(-1, dtype=torch.int32)
    cy = c.to(y.dtype)
    return torch.clamp(y, -cy, cy), hits

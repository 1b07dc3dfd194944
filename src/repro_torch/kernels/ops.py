"""Public wrappers over the kernels.

Counterpart of ``repro/kernels/ops.py`` for the raw int8 path of the fused
matmul; the other wrappers of the reference live beside their kernels
(``ecc_decode``, ``ecc_encode``, ``throttle``, ``flash_attention``,
``quant_throttle``).
"""
from __future__ import annotations

import torch

from . import ecc_qmatmul as _qmm


def qmatmul_protected(a_q: torch.Tensor, w_enc: torch.Tensor, a_scale,
                      w_scale) -> torch.Tensor:
    """f32 output = ``(a_q @ decode(w_enc)) * (a_scale * w_scale)``: the raw
    int8 path's exact int32 accumulator, rescaled outside the kernel."""
    acc = _qmm.ecc_qmatmul(a_q, w_enc)
    scale = _qmm._f32(a_scale, acc.device) * _qmm._f32(w_scale, acc.device)
    return acc.to(torch.float32) * scale

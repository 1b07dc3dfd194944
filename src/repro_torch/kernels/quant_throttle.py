"""Fused quantize + WOT throttle of an f32 weight (the QATT inner step).

Replaces ``repro/kernels/quant_throttle.py::quantize_throttle``
(``csrc/quant_throttle.cu``: a global absmax pass and a quantize-and-clamp
pass, two launches per call; bound by device memory, 9 bytes per value).
"""
from __future__ import annotations

import torch

from repro_torch.core import quant, wot

from . import build


def quantize_throttle_plain(w_blocks: torch.Tensor):
    """(nblk, 8) f32 -> (q int8 (nblk, 8) WOT-compliant, scale f32 ()):
    ``quant.quantize`` then ``wot.throttle_q``, exactly."""
    q, scale = quant.quantize(w_blocks)
    return wot.throttle_q(q.reshape(-1)).reshape(w_blocks.shape), scale


def quantize_throttle(w_blocks: torch.Tensor):
    """Kernel wrapper of :func:`quantize_throttle_plain` (same contract,
    any ``nblk >= 1``). One call is two launches and counts once."""
    if w_blocks.dtype != torch.float32 or w_blocks.ndim != 2 or \
            w_blocks.shape[1] != 8 or w_blocks.shape[0] == 0:
        raise ValueError(f"expected (nblk >= 1, 8) float32, got "
                         f"{tuple(w_blocks.shape)} {w_blocks.dtype}")
    if not w_blocks.is_cuda:
        return quantize_throttle_plain(w_blocks)
    w_blocks = w_blocks.contiguous()
    if w_blocks.data_ptr() % 16:
        raise ValueError("w_blocks must be 16-byte aligned")
    dev = w_blocks.device
    q = torch.empty(w_blocks.shape, dtype=torch.int8, device=dev)
    amax = torch.empty((), dtype=torch.int32, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev)
    fn = build.entry("quantize_throttle_launch")
    build.check(fn(w_blocks.data_ptr(), q.data_ptr(), amax.data_ptr(),
                   scale.data_ptr(), w_blocks.shape[0], build.stream_ptr(dev)),
                "quantize_throttle")
    build.COUNTS["quantize_throttle"] += 1
    return q, scale

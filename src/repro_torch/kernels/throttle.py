"""WOT throttle of int8 blocks: positions 0..6 clamped to [-64, 63].

Replaces ``repro/kernels/throttle.py::throttle`` (``csrc/throttle.cu``;
bound by device memory, 2 bytes per value). Unlike the TPU kernel it takes
any ``nblk``.
"""
from __future__ import annotations

import torch

from repro_torch.core import wot

from . import build


def throttle_plain(q_blocks: torch.Tensor) -> torch.Tensor:
    """(nblk, 8) int8 -> WOT-throttled (nblk, 8) int8 (a new tensor)."""
    return wot.throttle_q(q_blocks.reshape(-1)).reshape(q_blocks.shape)


def throttle(q_blocks: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of :func:`throttle_plain` (same contract)."""
    if q_blocks.dtype != torch.int8 or q_blocks.ndim != 2 or \
            q_blocks.shape[1] != 8:
        raise ValueError(f"expected (nblk, 8) int8, got "
                         f"{tuple(q_blocks.shape)} {q_blocks.dtype}")
    if not q_blocks.is_cuda:
        return throttle_plain(q_blocks)
    q_blocks = q_blocks.contiguous()
    if q_blocks.data_ptr() % 8:
        raise ValueError("q_blocks must be 8-byte aligned")
    out = torch.empty_like(q_blocks)
    if q_blocks.shape[0]:
        fn = build.entry("throttle_launch")
        build.check(fn(q_blocks.data_ptr(), out.data_ptr(), q_blocks.shape[0],
                       build.stream_ptr(q_blocks.device)), "throttle")
        build.COUNTS["throttle"] += 1
    return out

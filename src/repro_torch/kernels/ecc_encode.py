"""In-place SEC-DED (64,57,1) block encode.

Replaces ``repro/kernels/ecc_encode.py::ecc_encode`` (``csrc/ecc_codec.cu``,
bound by device memory: 8 bytes read and 8 written per block).
"""
from __future__ import annotations

import torch

from repro_torch.core import ecc

from . import build


def ecc_encode_plain(blocks: torch.Tensor) -> torch.Tensor:
    """(nblk, 8) uint8 WOT-compliant bytes -> encoded (nblk, 8)."""
    return ecc.encode64(blocks)


def ecc_encode(blocks: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of :func:`ecc_encode_plain` (same contract)."""
    if blocks.dtype != torch.uint8 or blocks.ndim != 2 or blocks.shape[1] != 8:
        raise ValueError(f"expected (nblk, 8) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if not blocks.is_cuda:
        return ecc_encode_plain(blocks)
    blocks = blocks.contiguous()
    if blocks.data_ptr() % 8:
        raise ValueError("blocks must be 8-byte aligned")
    out = torch.empty_like(blocks)
    if blocks.shape[0]:
        fn = build.entry("ecc_encode_launch")
        build.check(fn(blocks.data_ptr(), out.data_ptr(), blocks.shape[0],
                       build.stream_ptr(blocks.device)), "ecc_encode")
        build.COUNTS["ecc_encode"] += 1
    return out

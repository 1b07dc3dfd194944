"""In-place SEC-DED (64,57,1) block decode.

Replaces ``repro/kernels/ecc_decode.py::ecc_decode`` (``csrc/ecc_codec.cu``,
bound by device memory: 8 bytes read, 9 written per block).
"""
from __future__ import annotations

import torch

from repro_torch.core import ecc

from . import build


def ecc_decode_plain(enc: torch.Tensor):
    """(nblk, 8) uint8 -> (decoded (nblk, 8) uint8, flags (nblk,) uint8);
    flags bit0 = single-corrected, bit1 = double-detected."""
    dec, single, double = ecc.decode64(enc)
    flags = single.to(torch.uint8) | (double.to(torch.uint8) << 1)
    return dec, flags


def ecc_decode(enc: torch.Tensor):
    """Kernel wrapper of :func:`ecc_decode_plain` (same contract)."""
    if enc.dtype != torch.uint8 or enc.ndim != 2 or enc.shape[1] != 8:
        raise ValueError(f"expected (nblk, 8) uint8, got {tuple(enc.shape)} "
                         f"{enc.dtype}")
    if not enc.is_cuda:
        return ecc_decode_plain(enc)
    enc = enc.contiguous()
    if enc.data_ptr() % 8:
        raise ValueError("encoded blocks must be 8-byte aligned")
    nblk = enc.shape[0]
    dec = torch.empty_like(enc)
    flags = torch.empty(nblk, dtype=torch.uint8, device=enc.device)
    if nblk:
        fn = build.entry("ecc_decode_launch")
        build.check(fn(enc.data_ptr(), dec.data_ptr(), flags.data_ptr(), nblk,
                       build.stream_ptr(enc.device)), "ecc_decode")
        build.COUNTS["ecc_decode"] += 1
    return dec, flags

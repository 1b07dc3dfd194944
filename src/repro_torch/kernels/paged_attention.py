"""Fused ECC page decode + single-token attention over gathered KV strips.

Replaces ``repro/kernels/paged_attention.py::fused_page_attention`` (the
strip kernel; ``csrc/paged_attention.cu``). Per (batch, KV group) the
kernel decodes the encoded K and V strips, dequantizes them with their
per-token scales, serves the ``rep = H/KV`` query heads of the group, masks
tokens past ``pos``, and runs softmax and PV; flags count (corrected, DUE)
over valid tokens. The page-table gather (``kvcache._gather_seq``) stays
outside, as in the reference. Bound by device memory: each strip is read
once.

Schemes: ``faulty`` and ``in-place``; ``parity-zero`` is not ported yet.
The page-chunked online-softmax kernel (``chunked_page_attention``) is
still to port, so the whole strip must fit in shared memory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ecc

from . import build

KV_SCHEMES = ("faulty", "in-place")
# H100: the most dynamic shared memory one block may opt into
SMEM_LIMIT_BYTES = 232448 - 64


def _check_scheme(scheme: str) -> None:
    if scheme not in KV_SCHEMES:
        raise NotImplementedError(f"fused_page_attention: KV scheme {scheme!r}"
                                  f" is not ported; one of {KV_SCHEMES}")


def smem_bytes(s: int, hd: int, rep: int, dtype) -> int:
    """Dynamic shared memory of one CTA: decoded K and V strips in the
    query's type plus the f32 score rows."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * s * hd * itemsize + rep * s * 4


def _reduce_flags(cells: torch.Tensor) -> torch.Tensor:
    """(B, KV, 2) flag cells -> (2,) batch totals."""
    return cells.sum(dim=(0, 1)).to(torch.int32)


def fused_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                               scheme: str = "in-place"):
    """Plain PyTorch version with the kernel's op order.

    q (B, H, 1, hd) float; ke/ve (B, S, KV, hd) uint8; ksc/vsc (B, S) f32;
    pos (B,) int -> ``(o (B, H, 1, hd) q.dtype, flags (2,) int32)``.
    """
    _check_scheme(scheme)
    if kch is not None or vch is not None:
        raise ValueError("the faulty and in-place schemes keep no check bytes")
    b, h, _, hd = q.shape
    s, kv = ke.shape[1], ke.shape[2]
    rep = h // kv
    cdt = q.dtype
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]   # (B,S)

    def strip(enc, sc):
        if scheme == "in-place":
            dec, single, double = ecc.decode64(enc.reshape(b, s, kv, hd // 8, 8))
            cor = single.sum(-1, dtype=torch.int32)                     # (B,S,KV)
            due = double.sum(-1, dtype=torch.int32)
        else:
            dec = enc
            cor = due = torch.zeros((b, s, kv), dtype=torch.int32,
                                    device=enc.device)
        qv = dec.reshape(b, s, kv, hd).view(torch.int8)
        f = (qv.to(torch.float32) * sc[..., None, None]).to(cdt)
        vm = valid[..., None].to(torch.int32)
        return f, torch.stack([(cor * vm).sum(1), (due * vm).sum(1)], -1)

    kf, kcell = strip(ke, ksc)
    vf, vcell = strip(ve, vsc)
    qg = q[:, :, 0].reshape(b, kv, rep, hd)
    sc = torch.einsum("bgrd,bsgd->bgrs", qg, kf)
    sc = sc.to(torch.float32) * float(np.float32(1.0 / np.sqrt(hd)))
    sc = torch.where(valid[:, None, None, :], sc, -1e30)
    pr = torch.softmax(sc, dim=-1).to(cdt)
    o = torch.einsum("bgrs,bsgd->bgrd", pr, vf)
    return o.reshape(b, h, 1, hd), _reduce_flags(kcell + vcell)


def fused_page_attention(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                         scheme: str = "in-place"):
    """Kernel wrapper of :func:`fused_page_attention_plain` (same
    contract)."""
    _check_scheme(scheme)
    if not q.is_cuda:
        return fused_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos,
                                          scheme=scheme)
    if kch is not None or vch is not None:
        raise ValueError("the faulty and in-place schemes keep no check bytes")
    b, h, one, hd = q.shape
    s, kv = ke.shape[1], ke.shape[2]
    if one != 1 or hd % 8 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} vs strips {tuple(ke.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_page_attention takes f32 or bf16 q, got "
                         f"{q.dtype}")
    for name, t, dt in (("ke", ke, torch.uint8), ("ve", ve, torch.uint8),
                        ("ksc", ksc, torch.float32), ("vsc", vsc, torch.float32)):
        if t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name} must be {dt} on {q.device}")
    if ke.shape != (b, s, kv, hd) or ve.shape != ke.shape or \
            ksc.shape != (b, s) or vsc.shape != (b, s) or pos.shape != (b,):
        raise ValueError("strip, scale or pos shapes do not match q")
    smem = smem_bytes(s, hd, h // kv, q.dtype)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"fused_page_attention: S={s} needs {smem} B of shared "
                         f"memory (> {SMEM_LIMIT_BYTES}); long contexts need "
                         f"the chunked kernel, which is not ported yet")
    q3 = q.reshape(b, h, hd).contiguous()
    ke, ve = ke.contiguous(), ve.contiguous()
    ksc, vsc = ksc.contiguous(), vsc.contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q3)
    cells = torch.empty((b, kv, 2), dtype=torch.int32, device=q.device)
    fn = build.entry("fused_page_attention_launch")
    build.check(fn(q3.data_ptr(), ke.data_ptr(), ksc.data_ptr(), ve.data_ptr(),
                   vsc.data_ptr(), pos32.data_ptr(), out.data_ptr(),
                   cells.data_ptr(), b, s, kv, h, hd,
                   int(scheme == "in-place"),
                   float(np.float32(1.0 / np.sqrt(hd))), smem,
                   int(q.dtype == torch.bfloat16),
                   build.stream_ptr(q.device)), "fused_page_attention")
    build.COUNTS["fused_page_attention"] += 1
    return out.reshape(b, h, 1, hd), _reduce_flags(cells)

"""Fused KV write of one layer: the new K and V quantized per token,
WOT-throttled (in-place scheme), encoded and stored into the paged pool
through the page table, in place, in one launch.

The redesign of ``throttle`` for the serve paths (``csrc/kv_write.cu``).
The TPU kernel ``repro/kernels/throttle.py::throttle`` clamps int8 blocks
in a launch of its own; on the serve path its work is the KV write's WOT
clamp, a few instructions of this launch. The function is the reference's
``serving/kvcache.py::_encode_kv`` followed by ``_write_token`` (a decode
token at ``pos``) or ``_write_pages`` (a prefill of whole pages from
position 0), for K and V together (the reference throttles with the plain
``wot.throttle_q``). Bound by the launch at decode (about 100 KB per layer
at batch 4), by device memory at prefill.

Pages, checks and scales written by the kernel are byte-equal to
:func:`kv_write_plain`'s: the scale is the same IEEE division of an exact
max, the quantize the same true division and half-to-even rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant, wot
from repro_torch.protection.schemes import get_scheme

from . import build
from .paged_attention import KV_SCHEMES, SCHEME_IDS


def encode_plain(x: torch.Tensor, scheme: str):
    """float (..., kv, hd) -> (enc uint8 (..., kv, hd), checks (..., kv,
    hd/8) uint8 for parity-zero else None, scale (...,) f32): per-token
    absmax scale over the (kv, hd) slab, quantize, the WOT clamp for the
    in-place scheme (its check bits need bit 6 free), the scheme's encode
    on the plain route."""
    xf = x.to(torch.float32)
    scale = quant.compute_scale(xf, dim=(-2, -1))            # (..., 1, 1)
    q, _ = quant.quantize(xf, scale=scale)
    sch = get_scheme(scheme)
    if sch.requires_wot:   # hd % 8 == 0: blocks run along head_dim
        q = wot.throttle_q(q.reshape(-1)).reshape(q.shape)
    enc, checks = sch.encode(q, "torch")
    return enc, checks, scale[..., 0, 0]


def _write_token(pages, checks, scales, table, enc, ch, sc, pos):
    """Scatter one decode token per row into its page IN PLACE. enc (B, kv,
    hd); sc/pos (B,)."""
    ps = pages.shape[1]
    page = (pos // ps).long()
    phys = torch.gather(table, 1, page[:, None])[:, 0].long()       # (B,)
    slot = (pos % ps).long()
    pages[phys, slot] = enc
    if checks is not None:
        checks[phys, slot] = ch
    scales[phys, slot] = sc


def _write_pages(pages, checks, scales, table, enc, ch, sc):
    """Scatter whole prefill pages IN PLACE. enc (B, npg*ps, kv, hd); sc (B,
    npg*ps)."""
    b = table.shape[0]
    ps = pages.shape[1]
    npg = enc.shape[1] // ps
    idx = table[:, :npg].reshape(-1).long()                  # (B*npg,)
    pages[idx] = enc.reshape(b * npg, ps, *enc.shape[2:])
    if checks is not None:
        checks[idx] = ch.reshape(b * npg, ps, *ch.shape[2:])
    scales[idx] = sc.reshape(b * npg, ps)


def _check(k, v, k_pages, k_checks, k_scale, v_pages, v_checks, v_scale,
           table, pos, scheme):
    """Raise on operands the function does not take -> (B, T, P, ps)."""
    if scheme not in KV_SCHEMES:
        raise ValueError(f"KV scheme {scheme!r}; one of {KV_SCHEMES}")
    if k.dim() != 4 or v.shape != k.shape or v.dtype != k.dtype or \
            k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kv_write: k {tuple(k.shape)} {k.dtype}, v "
                         f"{tuple(v.shape)} {v.dtype}; expected equal "
                         f"(B, T, kv, hd) f32 or bf16")
    b, t, kv, hd = k.shape
    if hd % 8:
        raise ValueError(f"kv_write: head_dim {hd} is not a multiple of 8")
    p, ps = k_pages.shape[:2]
    for name, a, shape, dt in (
            ("k_pages", k_pages, (p, ps, kv, hd), torch.uint8),
            ("v_pages", v_pages, (p, ps, kv, hd), torch.uint8),
            ("k_scale", k_scale, (p, ps), torch.float32),
            ("v_scale", v_scale, (p, ps), torch.float32)):
        if tuple(a.shape) != shape or a.dtype != dt:
            raise ValueError(f"kv_write: {name} {tuple(a.shape)} {a.dtype}; "
                             f"expected {shape} {dt}")
    want = (p, ps, kv, hd // 8) if scheme == "parity-zero" else None
    for name, a in (("k_checks", k_checks), ("v_checks", v_checks)):
        got = None if a is None else tuple(a.shape)
        if got != want or (a is not None and a.dtype != torch.uint8):
            raise ValueError(f"kv_write: {name} {got} under {scheme!r}; "
                             f"expected {want} uint8")
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"kv_write: table {tuple(table.shape)} for a batch "
                         f"of {b}")
    if pos is None:
        if t % ps or t // ps > table.shape[1]:
            raise ValueError(f"kv_write: a prefill writes whole pages from "
                             f"position 0: {t} tokens, pages of {ps}, "
                             f"{table.shape[1]} pages per row")
    elif t != 1 or tuple(pos.shape) != (b,):
        raise ValueError(f"kv_write: a decode write takes one token per row "
                         f"and pos (B,), got T={t}, pos {tuple(pos.shape)}")
    return b, t, p, ps


def kv_write_plain(k, v, k_pages, k_checks, k_scale, v_pages, v_checks,
                   v_scale, table, pos=None, *, scheme: str = "in-place",
                   copy: bool = False):
    """Plain version of :func:`kv_write` (same contract): ``encode_plain``
    then the reference's ``_write_token`` / ``_write_pages``, for K, then
    V."""
    _check(k, v, k_pages, k_checks, k_scale, v_pages, v_checks, v_scale,
           table, pos, scheme)
    out = []
    for x, pages, checks, scales in ((k, k_pages, k_checks, k_scale),
                                     (v, v_pages, v_checks, v_scale)):
        if pos is None:
            enc, ch, sc = encode_plain(x, scheme)
            _write_pages(pages, checks, scales, table, enc, ch, sc)
        else:
            enc, ch, sc = encode_plain(x[:, 0], scheme)
            _write_token(pages, checks, scales, table, enc, ch, sc, pos)
            enc, sc = enc[:, None], sc[:, None]
            ch = None if ch is None else ch[:, None]
        out += [enc, ch, sc]
    return tuple(out) if copy else None


def kv_write(k, v, k_pages, k_checks, k_scale, v_pages, v_checks, v_scale,
             table, pos=None, *, scheme: str = "in-place",
             copy: bool = False):
    """Write one layer's new K and V into its paged pool IN PLACE.

    k, v (B, T, kv, hd) f32 or bf16 (after RoPE); pools (P, ps, kv, hd)
    uint8, scales (P, ps) f32, checks (P, ps, kv, hd/8) uint8 for
    ``parity-zero`` else None; table (B, npg) int32 page ids in [0, P).
    ``pos`` (B,) int: one decode token per row (T = 1) at position
    ``pos[b]``; None: a prefill of T tokens from position 0, T a whole
    number of pages. Returns None, or with ``copy`` the encoded tokens
    ``(k_enc (B, T, kv, hd) uint8, k_checks | None, k_scale (B, T) f32,
    v_enc, v_checks, v_scale)``. One launch for K and V; a page id outside
    [0, P) or a position past the table traps."""
    if not k.is_cuda:
        return kv_write_plain(k, v, k_pages, k_checks, k_scale, v_pages,
                              v_checks, v_scale, table, pos, scheme=scheme,
                              copy=copy)
    b, t, p, ps = _check(k, v, k_pages, k_checks, k_scale, v_pages, v_checks,
                         v_scale, table, pos, scheme)
    pools = (k_pages, k_checks, k_scale, v_pages, v_checks, v_scale)
    if any(a is not None and (not a.is_contiguous() or a.device != k.device)
           for a in pools):
        raise ValueError("kv_write writes the pools in place: they must be "
                         "contiguous and on the tokens' device")
    k, v = k.contiguous(), v.contiguous()
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("kv_write: k and v must be 16-byte aligned")
    kv, hd = k.shape[2:]
    dev = k.device
    table = table.to(device=dev, dtype=torch.int32).contiguous()
    if pos is not None:
        pos = pos.to(device=dev, dtype=torch.int32).contiguous()
    outs = [None] * 6
    if copy:
        has_ch = scheme == "parity-zero"
        for i in (0, 3):
            outs[i] = torch.empty((b, t, kv, hd), dtype=torch.uint8,
                                  device=dev)
            outs[i + 1] = torch.empty((b, t, kv, hd // 8), dtype=torch.uint8,
                                      device=dev) if has_ch else None
            outs[i + 2] = torch.empty((b, t), dtype=torch.float32,
                                      device=dev)
    if b * t:
        fn = build.entry("kv_write_launch")
        ptr = [None if a is None else a.data_ptr() for a in (*pools, *outs)]
        build.check(fn(k.data_ptr(), v.data_ptr(), *ptr, table.data_ptr(),
                       None if pos is None else pos.data_ptr(), b, t,
                       table.shape[1], ps, p, kv * hd, SCHEME_IDS[scheme],
                       int(k.dtype == torch.bfloat16),
                       build.stream_ptr(dev)), "kv_write")
        build.COUNTS["kv_write"] += 1
    return tuple(outs) if copy else None

"""Fused ECC page decode + single-token attention over gathered KV strips.

Two kernels, as in the reference module:

* ``fused_page_attention`` replaces ``repro/kernels/paged_attention.py::
  fused_page_attention`` (the strip kernel; ``csrc/paged_attention.cu``).
  Per (batch, KV group) it decodes the whole encoded K and V strips into
  shared memory, dequantizes them with their per-token scales, serves the
  ``rep = H/KV`` query heads of the group, masks tokens past ``pos``, and
  runs softmax and PV. The strips must fit shared memory
  (:func:`smem_bytes`): at deepseek-7b widths that is 448 tokens of
  page-aligned context (:func:`strip_smem_crossover`).
* ``chunked_page_attention`` replaces ``chunked_page_attention`` (the
  page-chunked online-softmax kernel; ``csrc/chunked_attention.cu``). It
  streams the strips one chunk at a time, so its shared memory is bounded
  by the chunk (:func:`chunked_smem_bytes`) and the context by device
  memory. It is reached through the ``-chunked`` KV presets and held to the
  fp64 :func:`oracle_page_attention` within a tolerance.

Flags count (corrected, DUE) over valid (``<= pos``) tokens. The
page-table gather (``kvcache._gather_seq``) stays outside, as in the
reference. Both kernels are bound by device memory: each strip is read
once. Schemes: ``faulty`` and ``in-place``; ``parity-zero`` is not ported
yet.
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
    """Dynamic shared memory of one strip-kernel CTA: decoded K and V
    strips in the query's type plus the f32 score rows."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * s * hd * itemsize + rep * s * 4


def strip_smem_crossover(hd: int, rep: int, dtype=torch.bfloat16) -> int:
    """Smallest strip length whose strip-kernel shared memory exceeds the
    card's limit: past it only the chunked kernel serves. A page-aligned
    strip must stay below it (448 tokens of 16-token pages at hd 128,
    rep 1, bf16: 516 B per token against 232,384 B)."""
    return SMEM_LIMIT_BYTES // smem_bytes(1, hd, rep, dtype) + 1


def chunked_smem_bytes(chunk: int, hd: int, rep: int) -> int:
    """Dynamic shared memory of one chunked-kernel CTA, in the order the
    kernel lays it out: decoded int8 K and V chunks, their f32 scales, the
    f32 score rows, then q, the accumulator and (m, l, alpha) for the
    ``rep`` heads in f32. Independent of the context length."""
    return 2 * chunk * hd + 2 * chunk * 4 + rep * chunk * 4 + \
        2 * rep * hd * 4 + 3 * rep * 4


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
                         f"memory (> {SMEM_LIMIT_BYTES}); serve long contexts "
                         f"with the chunked kernel: a '-chunked' KV preset "
                         f"(e.g. in-place-chunked) or attention_impl="
                         f"'chunked'")
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


# ---------------------------------------------------------------------------
# page-chunked online-softmax variant: shared memory bounded by the chunk
# ---------------------------------------------------------------------------


def _pad_tokens(a, pad):
    """Zero-pad axis 1 (tokens) of a strip or scale array by ``pad``."""
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))], 1)


def chunked_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                                 scheme: str = "in-place",
                                 chunk_tokens: int = 256):
    """Plain PyTorch version with the op order of the reference's
    ``_chunked_kernel``, all in f32.

    q (B, H, 1, hd) float; ke/ve (B, S, KV, hd) uint8; ksc/vsc (B, S) f32;
    pos (B,) int -> ``(o (B, H, 1, hd) q.dtype, flags (2,) int32)``.
    ``chunk_tokens`` is clamped to S and the tail zero-padded (padded
    tokens sit past every valid ``pos``; zero blocks are codec-clean).
    Per chunk: scores ``q·k * 1/sqrt(hd)`` masked with -1e30, the running
    max, ``p = exp(s - m)`` set to 0 past ``pos``, ``l = alpha*l + sum p``
    and ``acc = acc*alpha + p @ v``; finally ``acc / l`` in q's dtype.
    Chunks wholly past ``pos`` are skipped.
    """
    _check_scheme(scheme)
    if kch is not None or vch is not None:
        raise ValueError("the faulty and in-place schemes keep no check bytes")
    if chunk_tokens < 1:
        raise ValueError(f"chunk_tokens must be positive, got {chunk_tokens}")
    b, h, _, hd = q.shape
    s, kv = ke.shape[1], ke.shape[2]
    rep = h // kv
    chunk = min(chunk_tokens, s)
    pad = (-s) % chunk
    ke, ve = _pad_tokens(ke, pad), _pad_tokens(ve, pad)
    ksc, vsc = _pad_tokens(ksc, pad), _pad_tokens(vsc, pad)
    qf = q[:, :, 0].to(torch.float32).reshape(b, kv, rep, hd)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    m = torch.full((b, kv, rep, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, rep, hd), dtype=torch.float32, device=q.device)
    cells = torch.zeros((b, kv, 2), dtype=torch.int32, device=q.device)
    pos = pos.to(torch.int64)
    for c in range((s + pad) // chunk):
        base = c * chunk
        live = (base <= pos)                                     # (B,)
        if not bool(live.any()):
            break  # every later chunk is past every row's pos
        tok = base + torch.arange(chunk, device=q.device)
        valid = tok[None, :] <= pos[:, None]                     # (B, chunk)

        def strip(enc, sc):
            e = enc[:, base:base + chunk]
            if scheme == "in-place":
                dec, single, double = ecc.decode64(
                    e.reshape(b, chunk, kv, hd // 8, 8))
                vm = valid[..., None, None]
                cor = (single & vm).sum(dim=(1, 3), dtype=torch.int32)
                due = (double & vm).sum(dim=(1, 3), dtype=torch.int32)
            else:
                dec = e
                cor = due = torch.zeros((b, kv), dtype=torch.int32,
                                        device=q.device)
            qv = dec.reshape(b, chunk, kv, hd).view(torch.int8)
            f = qv.to(torch.float32) * sc[:, base:base + chunk, None, None]
            return f.permute(0, 2, 1, 3), torch.stack([cor, due], -1)

        kf, kcell = strip(ke, ksc)                     # (B, KV, chunk, hd)
        vf, vcell = strip(ve, vsc)
        sc = torch.einsum("bgrd,bgsd->bgrs", qf, kf) * scale
        vmask = valid[:, None, None, :]
        sc = torch.where(vmask, sc, -1e30)
        m_cur = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.where(vmask, torch.exp(sc - m_cur), 0.0)
        upd = live[:, None, None, None]
        l = torch.where(upd, alpha * l + p.sum(dim=-1, keepdim=True), l)
        m = torch.where(upd, m_cur, m)
        acc = torch.where(upd, acc * alpha +
                          torch.einsum("bgrs,bgsd->bgrd", p, vf), acc)
        cells = cells + (kcell + vcell) * live[:, None, None].to(torch.int32)
    o = (acc / l).to(q.dtype)
    return o.reshape(b, h, 1, hd), _reduce_flags(cells)


def chunked_page_attention(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                           scheme: str = "in-place", chunk_tokens: int = 256):
    """Kernel wrapper of :func:`chunked_page_attention_plain` (same
    contract)."""
    _check_scheme(scheme)
    if chunk_tokens < 1:
        raise ValueError(f"chunk_tokens must be positive, got {chunk_tokens}")
    if not q.is_cuda:
        return chunked_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos,
                                            scheme=scheme,
                                            chunk_tokens=chunk_tokens)
    if kch is not None or vch is not None:
        raise ValueError("the faulty and in-place schemes keep no check bytes")
    b, h, one, hd = q.shape
    s, kv = ke.shape[1], ke.shape[2]
    if one != 1 or hd % 8 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} vs strips {tuple(ke.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"chunked_page_attention takes f32 or bf16 q, got "
                         f"{q.dtype}")
    for name, t, dt in (("ke", ke, torch.uint8), ("ve", ve, torch.uint8),
                        ("ksc", ksc, torch.float32), ("vsc", vsc, torch.float32)):
        if t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name} must be {dt} on {q.device}")
    if ke.shape != (b, s, kv, hd) or ve.shape != ke.shape or \
            ksc.shape != (b, s) or vsc.shape != (b, s) or pos.shape != (b,):
        raise ValueError("strip, scale or pos shapes do not match q")
    if b * s * kv * hd >= 2 ** 62:
        raise ValueError("chunked_page_attention: strips too large")
    chunk = min(chunk_tokens, s)
    rep = h // kv
    smem = chunked_smem_bytes(chunk, hd, rep)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"chunked_page_attention: a chunk of {chunk} tokens "
                         f"needs {smem} B of shared memory (> "
                         f"{SMEM_LIMIT_BYTES}); use fewer chunk_pages")
    q3 = q.reshape(b, h, hd).contiguous()
    ke, ve = ke.contiguous(), ve.contiguous()
    ksc, vsc = ksc.contiguous(), vsc.contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q3)
    cells = torch.empty((b, kv, 2), dtype=torch.int32, device=q.device)
    fn = build.entry("chunked_page_attention_launch")
    build.check(fn(q3.data_ptr(), ke.data_ptr(), ksc.data_ptr(), ve.data_ptr(),
                   vsc.data_ptr(), pos32.data_ptr(), out.data_ptr(),
                   cells.data_ptr(), b, s, kv, h, hd, chunk,
                   int(scheme == "in-place"),
                   float(np.float32(1.0 / np.sqrt(hd))), smem,
                   int(q.dtype == torch.bfloat16),
                   build.stream_ptr(q.device)), "chunked_page_attention")
    build.COUNTS["chunked_page_attention"] += 1
    return out.reshape(b, h, 1, hd), _reduce_flags(cells)


def oracle_page_attention(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                          scheme: str = "in-place") -> np.ndarray:
    """Float64 NumPy oracle over the same encoded strips -> (B, H, 1, hd).

    The codec decode is integer-exact (the plain codec); dequantization,
    scores, softmax and PV then run in fp64. The chunked kernel is held to
    it within a tolerance (2% of ``max|oracle|`` on the card)."""
    _check_scheme(scheme)

    def dequant(enc, sc):
        b, s, kv, hd = enc.shape
        e = enc.cpu()
        if scheme == "in-place":
            e = ecc.decode64(e.reshape(b, s, kv, hd // 8, 8))[0]
        qv = e.reshape(b, s, kv, hd).view(torch.int8).numpy().astype(np.float64)
        return qv * sc.cpu().numpy().astype(np.float64)[..., None, None]

    kf, vf = dequant(ke, ksc), dequant(ve, vsc)              # (B, S, KV, hd)
    qf = q.to(torch.float32).cpu().numpy().astype(np.float64)
    b, h, _, hd = qf.shape
    s, kv = kf.shape[1], kf.shape[2]
    rep = h // kv
    valid = np.arange(s)[None, :] <= pos.cpu().numpy()[:, None]
    qg = qf[:, :, 0].reshape(b, kv, rep, hd)
    sc = np.einsum("bgrd,bsgd->bgrs", qg, kf) / np.sqrt(hd)
    sc = np.where(valid[:, None, None, :], sc, -np.inf)
    p = np.exp(sc - sc.max(axis=-1, keepdims=True))
    p = p / p.sum(axis=-1, keepdims=True)
    o = np.einsum("bgrs,bsgd->bgrd", p, vf)
    return o.reshape(b, h, 1, hd)

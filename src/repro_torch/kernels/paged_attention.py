"""Fused ECC page decode + single-token attention over the paged KV pool.

Two kernels, as in the reference module, each with two entry points: a
table entry over one layer's pool (P, page_size, KV, hd) read through the
(B, npg) page table (``*_paged``, what ``kvcache.paged_gqa_decode`` calls),
and the reference's strip entry over (B, S, KV, hd) strips, which launches
the same kernel over the strips viewed as a pool of one S-token page per
row (what the parity tests and ``chip_smoke.py`` hold to the reference).
Token ``t`` of row ``b`` sits at ``pool[table[b, t // page_size], t %
page_size]``: shared prefix pages and parking pages need nothing special,
and tokens past ``pos[b]`` are never read. Each call is one launch.

* ``fused_page_attention`` replaces ``repro/kernels/paged_attention.py::
  fused_page_attention`` (the strip kernel; ``csrc/paged_attention.cu``).
  Per (batch, KV group) it loads the encoded K and V of tokens 0..pos at
  once, decodes them in registers into shared memory, dequantizes with the
  per-token scales, serves the ``rep = H/KV`` query heads of the group and
  runs softmax and PV over all warps. The decoded strips must fit shared
  memory (:func:`smem_bytes`): at deepseek-7b widths that is 848 tokens of
  page-aligned context (:func:`strip_smem_crossover`).
* ``chunked_page_attention`` replaces ``chunked_page_attention`` (the
  page-chunked online-softmax kernel; ``csrc/chunked_attention.cu``). A
  (B, KV, splits) grid (:func:`plan_splits`) streams whole 32-token tiles
  through a ``cp.async`` ring per warp, tests the in-place syndromes on the
  tensor cores, and merges the splits' online-softmax partials in split
  order, so its shared memory is bounded (:func:`chunked_smem_bytes`) and
  the context by device memory only. It is reached through the ``-chunked``
  KV presets and held to the fp64 :func:`oracle_page_attention` within a
  tolerance.

Flags count (corrected, DUE) over valid (``<= pos``) tokens, summed to
batch totals ``(2,)`` or, with ``per_slot=True``, to per-batch-row
``(2, B)`` rows (per-request fault attribution for the serving
front-end); the kernels sum them in the launch. Both kernels are bound by
device memory at long contexts (each live token's K and V, and for
``parity-zero`` its check bytes, read once) and by latency at short ones.
The plain versions of the table entries gather the strips
(:func:`gather_strips`, the reference's ``kvcache._gather_seq``) and run
the strip plain versions.

Schemes, as the reference's ``_decode_strip``: ``faulty`` passes bytes
through; ``in-place`` corrects and counts per 8-byte block; ``parity-zero``
reads the ``(..., KV, hd/8)`` check bytes (byte ``j``'s stored parity is
bit ``j % 8`` of check byte ``j // 8``), zeroes every byte whose parity
fails and counts each such BYTE as corrected, never as DUE. The in-place
scheme counts blocks, the parity-zero scheme bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ecc

from . import build

KV_SCHEMES = ("faulty", "parity-zero", "in-place")
SCHEME_IDS = {"faulty": 0, "in-place": 1, "parity-zero": 2}  # the kernels' ids
# H100: the most dynamic shared memory one block may opt into
SMEM_LIMIT_BYTES = 232448 - 64
STRIP_WARPS = 8          # warps of a strip-kernel CTA
# the chunked kernel's CTA: 4 warps, each a ring of 4 stages of 8 tokens;
# a CTA tile is 32 tokens, two pages at the presets' page size
CHUNK_WARPS, CHUNK_WARP_TOKENS, CHUNK_STAGES = 4, 8, 4
CHUNK_TILE = CHUNK_WARPS * CHUNK_WARP_TOKENS
CHUNK_CTAS_PER_SM = 5    # the plan's target: all CTAs resident at once
CHUNK_MIN_TILES = 2      # the fewest tiles a split keeps


def _check_scheme(scheme: str, kch=None, vch=None, shape=None) -> None:
    """Raise on an unknown scheme and, given the strips' ``shape``, on
    check strips that do not fit it: ``parity-zero`` needs (B, S, KV, hd/8)
    uint8 strips, the other schemes keep none."""
    if scheme not in KV_SCHEMES:
        raise ValueError(f"KV scheme {scheme!r}; one of {KV_SCHEMES}")
    if shape is None:
        return
    if scheme != "parity-zero":
        if kch is not None or vch is not None:
            raise ValueError(f"the {scheme} scheme keeps no check bytes")
        return
    b, s, kv, hd = shape
    for name, t in (("kch", kch), ("vch", vch)):
        if t is None:
            raise ValueError("the parity-zero scheme needs the kch/vch "
                             "check strips")
        if t.dtype != torch.uint8 or tuple(t.shape) != (b, s, kv, hd // 8):
            raise ValueError(f"{name} must be (B, S, KV, hd/8) = "
                             f"{(b, s, kv, hd // 8)} uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def smem_bytes(s: int, hd: int, rep: int) -> int:
    """Dynamic shared memory of one strip-kernel CTA, in the order the
    kernel lays it out: decoded int8 K and V strips, their f32 scales, q in
    f32, the f32 score rows, then the eight warps' f32 PV partials and
    their score maxima and exp sums per head."""
    return (2 * _r16(s * hd) + 2 * _r16(4 * s) + 4 * rep * hd
            + _r16(4 * rep * s) + 4 * STRIP_WARPS * rep * hd
            + 8 * STRIP_WARPS * rep)


def strip_smem_crossover(hd: int, rep: int) -> int:
    """Smallest strip length whose strip-kernel shared memory exceeds the
    card's limit: past it only the chunked kernel serves (850 tokens at hd
    128, rep 1: 268 B per token and 4,672 B fixed against 232,384 B; a
    page-aligned strip stops at 848)."""
    s = 1
    while smem_bytes(s, hd, rep) <= SMEM_LIMIT_BYTES:
        s *= 2
    lo, hi = s // 2, s   # smem_bytes(lo) fits, smem_bytes(hi) does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, hd, rep) <= SMEM_LIMIT_BYTES \
            else (lo, mid)
    return hi


def chunked_smem_bytes(hd: int, rep: int, *, checks: bool = False,
                       table_entries: int = 0) -> int:
    """Dynamic shared memory of one chunked-kernel CTA, in the order the
    kernel lays it out: each warp's ring of ``CHUNK_STAGES`` stages (K and
    V rows of ``CHUNK_WARP_TOKENS`` tokens, each padded to whole 512-byte
    syndrome row-groups, their f32 scales and, for ``parity-zero``, their
    check bytes), q in f32, each warp's accumulator and (m, l) per head,
    and the CTA's slice of the page table. Independent of the context."""
    wt = CHUNK_WARP_TOKENS
    stage = 2 * (-(-wt * hd // 512) * 512) + 8 * wt
    if checks:
        stage += 2 * _r16(wt * (hd // 8))
    return (CHUNK_WARPS * CHUNK_STAGES * stage + 4 * rep * hd
            + 4 * CHUNK_WARPS * rep * hd + 8 * CHUNK_WARPS * rep
            + 4 * table_entries)


def plan_splits(b: int, kv: int, s: int, sm_count: int) -> int:
    """Split count of the chunked kernel's (B, KV, splits) grid: as many
    CTAs as ``CHUNK_CTAS_PER_SM`` per SM allows, so that all of them are
    resident at once (a second wave would double the time of its CTAs),
    but no split shorter than ``CHUNK_MIN_TILES`` tiles of the S-token
    strip, and at least 1. A plain function of the shapes: the host does
    not read ``pos`` (:func:`split_token_ranges`)."""
    tiles = -(-s // CHUNK_TILE)
    return max(1, min(CHUNK_CTAS_PER_SM * sm_count // (b * kv),
                      tiles // CHUNK_MIN_TILES))


def split_token_ranges(s: int, n_live: int, splits: int) -> list:
    """The token range ``[t0, t1)`` each split of one row reads, as the
    kernel computes it: split ``sp`` of the row's ``ntl`` tiles of
    ``CHUNK_TILE`` tokens (S = ``s``) takes tiles ``[sp*ntl//splits,
    (sp+1)*ntl//splits)`` and reads their tokens below ``n_live`` (``pos +
    1``)."""
    ntl = -(-s // CHUNK_TILE)
    out = []
    for sp in range(splits):
        c0, c1 = sp * ntl // splits, (sp + 1) * ntl // splits
        out.append((min(c0 * CHUNK_TILE, n_live),
                    min(c1 * CHUNK_TILE, n_live)))
    return out


def chunked_table_entries(npg: int, ps: int, s: int, splits: int) -> int:
    """Page-table entries one chunked CTA's tiles may span: a split holds
    at most ceil(tiles / splits) tiles, starting at a tile boundary that
    may fall inside a page."""
    tps = -(-(-(-s // CHUNK_TILE)) // splits)
    return min(npg, tps * CHUNK_TILE // ps + 2)


def gather_strips(pages, checks, scales, table):
    """Pool -> per-sequence encoded strips: (enc (B, S, kv, hd), checks |
    None, scale (B, S)) with S = pages_per_seq * page_size. The gather the
    kernels replace by reading the pool through ``table`` themselves; it
    is what the reference's ``kvcache._gather_seq`` does, and the serving
    cache's reference path (``backend="torch"``) calls it."""
    b, npg = table.shape
    ps = pages.shape[1]
    idx = table.long()
    enc = pages[idx].reshape(b, npg * ps, *pages.shape[2:])
    ch = None
    if checks is not None:
        ch = checks[idx].reshape(b, npg * ps, *checks.shape[2:])
    sc = scales[idx].reshape(b, npg * ps)
    return enc, ch, sc


def _reduce_flags(cells: torch.Tensor, per_slot: bool) -> torch.Tensor:
    """(B, KV, 2) flag cells -> (2, B) per-slot rows or (2,) batch
    totals, int32 (the plain versions; the kernels reduce in the launch)."""
    if per_slot:
        return cells.sum(dim=1, dtype=torch.int32).T.contiguous()
    return cells.sum(dim=(0, 1), dtype=torch.int32)


def _decode_cells(enc, ch, scheme: str):
    """Plain block decode of encoded strips (..., KV, hd) -> (int8 values,
    corrected (..., KV), due (..., KV)) int32 per token and head: blocks for
    ``in-place``, bytes for ``parity-zero``."""
    lead = enc.shape[:-1]
    if scheme == "in-place":
        dec, single, double = ecc.decode64(enc.reshape(*lead, -1, 8))
        return (dec.reshape(enc.shape).view(torch.int8),
                single.sum(-1, dtype=torch.int32),
                double.sum(-1, dtype=torch.int32))
    zero = torch.zeros(lead, dtype=torch.int32, device=enc.device)
    if scheme == "parity-zero":
        dec, bad = ecc.decode_parity8(enc, ch)
        return dec.view(torch.int8), bad.sum(-1, dtype=torch.int32), zero
    return enc.view(torch.int8), zero, zero


def _lane_tree(x):
    """Sum the last axis (32 lanes) in warp_sum's butterfly: lanes l and
    l + 16, then the halves again, down to one."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _pad_last(x, m):
    """Zero-pad the last axis to a multiple of ``m``."""
    pad = (-x.shape[-1]) % m
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def fused_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                               scheme: str = "in-place",
                               per_slot: bool = False):
    """Plain PyTorch version with the kernel's op order.

    q (B, H, 1, hd) float; ke/ve (B, S, KV, hd) uint8; kch/vch (B, S, KV,
    hd/8) uint8 for ``parity-zero``, else None; ksc/vsc (B, S) f32; pos (B,)
    int -> ``(o (B, H, 1, hd) q.dtype, flags (2,) or (2, B) int32)``.

    The op order is the reference's: K and V dequantized in f32 and rounded
    to q's type, the score dot in f32 rounded to q's type, times 1/sqrt(hd)
    in f32, softmax in f32, probabilities rounded to q's type, the f32 PV
    sum rounded once. The f32 sums run in the strip kernel's order
    (``csrc/paged_attention.cu``), so the two are bit-equal in bf16 (whose
    products are exact in f32): score lanes over words of 4 elements then
    the butterfly; exp sums lane-strided over each warp's tokens, the
    butterfly, then the warps in order; PV per warp over its tokens, then
    the warps in order. Tokens past ``pos`` add exact zeros.
    """
    _check_scheme(scheme, kch, vch, tuple(ke.shape))
    b, h, _, hd = q.shape
    s, kv = ke.shape[1], ke.shape[2]
    rep = h // kv
    cdt = q.dtype
    nw = STRIP_WARPS
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]   # (B,S)

    def strip(enc, ch, sc):
        qv, cor, due = _decode_cells(enc, ch, scheme)           # (B,S,KV)
        f = (qv.to(torch.float32) * sc[..., None, None]).to(cdt)
        vm = valid[..., None].to(torch.int32)
        return f, torch.stack([(cor * vm).sum(1), (due * vm).sum(1)], -1)

    kf, kcell = strip(ke, kch, ksc)
    vf, vcell = strip(ve, vch, vsc)
    kf = kf.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]   # (B,KV,1,S,hd)
    vf = vf.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    qg = q[:, :, 0].to(torch.float32).reshape(b, kv, rep, 1, hd)
    # scores: lane l sums words l, l + 32, ... (4 elements each) in order
    prod = _pad_last(qg * kf, 128)                          # (B,KV,R,S,hd')
    prod = prod.reshape(*prod.shape[:-1], -1, 32, 4)
    lanes = torch.zeros(prod.shape[:-3] + (32,), dtype=torch.float32,
                        device=q.device)
    for m in range(prod.shape[-3]):
        for e in range(4):
            lanes = lanes + prod[..., m, :, e]
    sc = _lane_tree(lanes).to(cdt).to(torch.float32) * \
        float(np.float32(1.0 / np.sqrt(hd)))                    # (B,KV,R,S)
    vmask = valid[:, None, None, :]
    sc = torch.where(vmask, sc, -1e30)
    e = torch.where(vmask, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    # exp sums: token w + nw*(l + 32k) to lane l of warp w, k in order
    ek = _pad_last(e, nw * 32)
    ek = ek.reshape(*ek.shape[:-1], -1, 32, nw)             # (..., k, l, w)
    lanes = torch.zeros(ek.shape[:-3] + (32, nw), dtype=torch.float32,
                        device=q.device)
    for k in range(ek.shape[-3]):
        lanes = lanes + ek[..., k, :, :]
    warps = _lane_tree(lanes.transpose(-1, -2))             # (..., nw)
    total = warps[..., :1]
    for w in range(1, nw):
        total = total + warps[..., w:w + 1]
    pr = (e / total).to(cdt).to(torch.float32)              # (B,KV,R,S)
    # PV: warp w sums its tokens w, w + nw, ... in order, then warp order
    prod = pr[..., None] * vf                               # (B,KV,R,S,hd)
    pad = (-s) % nw
    if pad:
        prod = torch.nn.functional.pad(prod, (0, 0, 0, pad))
    prod = prod.reshape(b, kv, rep, -1, nw, hd)
    acc = torch.zeros((b, kv, rep, nw, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(prod.shape[3]):
        acc = acc + prod[:, :, :, i]
    o = acc[:, :, :, 0]
    for w in range(1, nw):
        o = o + acc[:, :, :, w]
    return (o.to(cdt).reshape(b, h, 1, hd),
            _reduce_flags(kcell + vcell, per_slot))


def _pool_operands(name, q, kp, kc, ks, vp, vc, vs, table, pos, scheme):
    """Check a launch's operands and make them contiguous.

    The pool is (P, ps, KV, hd) uint8 with (P, ps) f32 scales and, for
    ``parity-zero``, (P, ps, KV, hd/8) check bytes; ``table`` (B, npg) int
    names row b's pages, or is None for strips (B, S, KV, hd): the identity
    over one page of S tokens per row. -> (q3 (B, H, hd), operands, table
    int32 or None, pos int32, (B, H, hd, KV, npg, ps, P)). The kernels
    trap on a table entry outside [0, P), as the gather they replace
    raised on one."""
    b, h, one, hd = q.shape
    p, ps, kv = kp.shape[0], kp.shape[1], kp.shape[2]
    if one != 1 or hd % 8 or h % kv or kp.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs pool "
                         f"{tuple(kp.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes f32 or bf16 q, got {q.dtype}")
    _check_scheme(scheme, kc, vc, tuple(kp.shape))
    for tname, t, dt in (("k pool", kp, torch.uint8), ("v pool", vp,
                                                       torch.uint8),
                         ("k scales", ks, torch.float32),
                         ("v scales", vs, torch.float32),
                         ("k checks", kc, torch.uint8),
                         ("v checks", vc, torch.uint8)):
        if t is not None and (t.dtype != dt or t.device != q.device):
            raise ValueError(f"{name}: {tname} must be {dt} on {q.device}")
    if vp.shape != kp.shape or ks.shape != (p, ps) or vs.shape != (p, ps) \
            or pos.shape != (b,):
        raise ValueError(f"{name}: pool, scale or pos shapes do not match q")
    if table is None:
        if p != b:
            raise ValueError(f"{name}: strips of {p} rows for a batch of {b}")
        npg = 1
    else:
        if table.dim() != 2 or table.shape[0] != b or \
                table.device != q.device:
            raise ValueError(f"{name}: table must be (B, npg) on {q.device}")
        npg = table.shape[1]
        table = table.to(torch.int32).contiguous()
    if p * ps * kv * hd >= 2 ** 62 or npg * ps >= 2 ** 31:
        raise ValueError(f"{name}: pool too large")
    ops = [t if t is None else t.contiguous() for t in (kp, kc, ks, vp, vc,
                                                        vs)]
    return (q.reshape(b, h, hd).contiguous(), ops, table,
            pos.to(torch.int32).contiguous(), (b, h, hd, kv, npg, ps, p))


_TICKETS: dict = {}
_SM_COUNT: dict = {}


def _tickets(device, n: int) -> torch.Tensor:
    """The kernels' last-CTA tickets for launches on ``device``'s current
    stream: int32 counters that are 0 between launches (each launch resets
    the ones it used: counter 0 is either kernel's flag ticket, 1 + b*KV +
    g the chunked kernel's split-merge ticket of (b, g)), allocated zeroed
    once per (device, stream) and grown when a launch needs more. Launches
    on one stream run one after another, so each finds its counters at 0;
    two streams never share a buffer. A launch that faults leaves the CUDA
    context in error, so no later launch reads its counters."""
    key = (device, build.stream_ptr(device))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _sm_count(device) -> int:
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device]


def _flags_out(b: int, per_slot: bool, device) -> torch.Tensor:
    return torch.empty((2, b) if per_slot else (2,), dtype=torch.int32,
                       device=device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch_strip(q, kp, kc, ks, vp, vc, vs, table, pos, scheme, per_slot):
    """One launch of the strip kernel over a pool (or strips with table
    None) -> (o (B, H, 1, hd), flags)."""
    q3, ops, table, pos32, (b, h, hd, kv, npg, ps, p) = _pool_operands(
        "fused_page_attention", q, kp, kc, ks, vp, vc, vs, table, pos, scheme)
    s = npg * ps
    smem = smem_bytes(s, hd, h // kv)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"fused_page_attention: S={s} needs {smem} B of shared "
                         f"memory (> {SMEM_LIMIT_BYTES}); serve long contexts "
                         f"with the chunked kernel: a '-chunked' KV preset "
                         f"(e.g. in-place-chunked) or attention_impl="
                         f"'chunked'")
    out = torch.empty_like(q3)
    cells = torch.empty((b, kv, 2), dtype=torch.int32, device=q.device)
    flags = _flags_out(b, per_slot, q.device)
    fn = build.entry("fused_page_attention_launch")
    build.check(fn(q3.data_ptr(), *map(_ptr, ops), _ptr(table),
                   pos32.data_ptr(), out.data_ptr(), cells.data_ptr(),
                   _tickets(q.device, 1).data_ptr(), flags.data_ptr(),
                   b, p, npg, ps, kv, h, hd, SCHEME_IDS[scheme],
                   float(np.float32(1.0 / np.sqrt(hd))), smem,
                   int(q.dtype == torch.bfloat16), int(per_slot),
                   build.stream_ptr(q.device)), "fused_page_attention")
    build.COUNTS["fused_page_attention"] += 1
    return out.reshape(b, h, 1, hd), flags


def fused_page_attention(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                         scheme: str = "in-place", per_slot: bool = False):
    """Kernel wrapper of :func:`fused_page_attention_plain` (same
    contract): one launch over the strips viewed as a pool of one S-token
    page per row."""
    _check_scheme(scheme)
    if not q.is_cuda:
        return fused_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos,
                                          scheme=scheme, per_slot=per_slot)
    return _launch_strip(q, ke, kch, ksc, ve, vch, vsc, None, pos, scheme,
                         per_slot)


def fused_page_attention_paged_plain(q, k_pages, k_checks, k_scale, v_pages,
                                     v_checks, v_scale, table, pos, *,
                                     scheme: str = "in-place",
                                     per_slot: bool = False):
    """Plain version of :func:`fused_page_attention_paged`: the gather
    (:func:`gather_strips`), then :func:`fused_page_attention_plain`."""
    ke, kch, ksc = gather_strips(k_pages, k_checks, k_scale, table)
    ve, vch, vsc = gather_strips(v_pages, v_checks, v_scale, table)
    return fused_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos,
                                      scheme=scheme, per_slot=per_slot)


def fused_page_attention_paged(q, k_pages, k_checks, k_scale, v_pages,
                               v_checks, v_scale, table, pos, *,
                               scheme: str = "in-place",
                               per_slot: bool = False):
    """The strip kernel over one layer's paged pool, read through the page
    table: q (B, H, 1, hd); pools (P, ps, KV, hd) uint8, checks (P, ps, KV,
    hd/8) uint8 for ``parity-zero`` else None, scales (P, ps) f32; table
    (B, npg) int32 page ids in [0, P); pos (B,) int. Equal to
    :func:`fused_page_attention` over the gathered strips (S = npg * ps),
    without the gather. One launch."""
    _check_scheme(scheme)
    if not q.is_cuda:
        return fused_page_attention_paged_plain(
            q, k_pages, k_checks, k_scale, v_pages, v_checks, v_scale, table,
            pos, scheme=scheme, per_slot=per_slot)
    return _launch_strip(q, k_pages, k_checks, k_scale, v_pages, v_checks,
                         v_scale, table, pos, scheme, per_slot)


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
                                 chunk_tokens: int = 256,
                                 per_slot: bool = False):
    """Plain PyTorch version with the op order of the reference's
    ``_chunked_kernel``, all in f32.

    q (B, H, 1, hd) float; ke/ve (B, S, KV, hd) uint8; kch/vch (B, S, KV,
    hd/8) uint8 for ``parity-zero``, else None; ksc/vsc (B, S) f32; pos (B,)
    int -> ``(o (B, H, 1, hd) q.dtype, flags (2,) or (2, B) int32)``.
    ``chunk_tokens`` is clamped to S and the tail zero-padded (padded
    tokens sit past every valid ``pos``; zero blocks are codec-clean).
    Per chunk: scores ``q·k * 1/sqrt(hd)`` masked with -1e30, the running
    max, ``p = exp(s - m)`` set to 0 past ``pos``, ``l = alpha*l + sum p``
    and ``acc = acc*alpha + p @ v``; finally ``acc / l`` in q's dtype.
    Chunks wholly past ``pos`` are skipped.
    """
    _check_scheme(scheme, kch, vch, tuple(ke.shape))
    _check_chunk(chunk_tokens)
    b, h, _, hd = q.shape
    s, kv = ke.shape[1], ke.shape[2]
    rep = h // kv
    chunk = min(chunk_tokens, s)
    pad = (-s) % chunk
    ke, ve = _pad_tokens(ke, pad), _pad_tokens(ve, pad)
    ksc, vsc = _pad_tokens(ksc, pad), _pad_tokens(vsc, pad)
    if kch is not None:  # zero checks of zero bytes are parity-clean
        kch, vch = _pad_tokens(kch, pad), _pad_tokens(vch, pad)
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

        def strip(enc, ch, sc):
            qv, cor, due = _decode_cells(
                enc[:, base:base + chunk],
                None if ch is None else ch[:, base:base + chunk], scheme)
            vm = valid[..., None].to(torch.int32)      # (B, chunk, 1)
            f = qv.to(torch.float32) * sc[:, base:base + chunk, None, None]
            return f.permute(0, 2, 1, 3), torch.stack(
                [(cor * vm).sum(1), (due * vm).sum(1)], -1)

        kf, kcell = strip(ke, kch, ksc)                # (B, KV, chunk, hd)
        vf, vcell = strip(ve, vch, vsc)
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
    return o.reshape(b, h, 1, hd), _reduce_flags(cells, per_slot)


def _launch_chunked(q, kp, kc, ks, vp, vc, vs, table, pos, scheme,
                    per_slot):
    """One launch of the chunked kernel over a pool (or strips with table
    None) -> (o (B, H, 1, hd), flags)."""
    q3, ops, table, pos32, (b, h, hd, kv, npg, ps, p) = _pool_operands(
        "chunked_page_attention", q, kp, kc, ks, vp, vc, vs, table, pos,
        scheme)
    s, rep = npg * ps, h // kv
    splits = plan_splits(b, kv, s, _sm_count(q.device))
    tab = 0 if table is None else chunked_table_entries(npg, ps, s, splits)
    smem = chunked_smem_bytes(hd, rep, checks=scheme == "parity-zero",
                              table_entries=tab)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"chunked_page_attention: hd={hd}, rep={rep} need "
                         f"{smem} B of shared memory (> {SMEM_LIMIT_BYTES})")
    out = torch.empty_like(q3)
    cells = torch.empty((b, kv, splits, 2), dtype=torch.int32,
                        device=q.device)
    flags = _flags_out(b, per_slot, q.device)
    ws = (torch.empty(b * kv * splits * rep * (hd + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    fn = build.entry("chunked_page_attention_launch")
    build.check(fn(q3.data_ptr(), *map(_ptr, ops), _ptr(table),
                   pos32.data_ptr(), out.data_ptr(), cells.data_ptr(),
                   _tickets(q.device, 1 + b * kv).data_ptr(),
                   flags.data_ptr(), _ptr(ws), b, p, npg, ps, kv, h, hd,
                   splits, tab, SCHEME_IDS[scheme],
                   float(np.float32(1.0 / np.sqrt(hd))), smem,
                   int(q.dtype == torch.bfloat16), int(per_slot),
                   build.stream_ptr(q.device)), "chunked_page_attention")
    build.COUNTS["chunked_page_attention"] += 1
    return out.reshape(b, h, 1, hd), flags


def _check_chunk(chunk_tokens: int) -> None:
    if chunk_tokens < 1:
        raise ValueError(f"chunk_tokens must be positive, got {chunk_tokens}")


def chunked_page_attention(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                           scheme: str = "in-place", chunk_tokens: int = 256,
                           per_slot: bool = False):
    """Kernel wrapper of :func:`chunked_page_attention_plain` (same
    contract): one launch over the strips viewed as a pool of one S-token
    page per row. ``chunk_tokens`` sets only the plain version's chunks
    (CPU tensors); it has no effect on CUDA tensors, where the kernel's
    tiles and splits are its own (:func:`plan_splits`); the two agree to
    f32 rounding."""
    _check_scheme(scheme)
    _check_chunk(chunk_tokens)
    if not q.is_cuda:
        return chunked_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos,
                                            scheme=scheme,
                                            chunk_tokens=chunk_tokens,
                                            per_slot=per_slot)
    return _launch_chunked(q, ke, kch, ksc, ve, vch, vsc, None, pos, scheme,
                           per_slot)


def chunked_page_attention_paged_plain(q, k_pages, k_checks, k_scale,
                                       v_pages, v_checks, v_scale, table,
                                       pos, *, scheme: str = "in-place",
                                       chunk_tokens: int = 256,
                                       per_slot: bool = False):
    """Plain version of :func:`chunked_page_attention_paged`: the gather
    (:func:`gather_strips`), then :func:`chunked_page_attention_plain`."""
    ke, kch, ksc = gather_strips(k_pages, k_checks, k_scale, table)
    ve, vch, vsc = gather_strips(v_pages, v_checks, v_scale, table)
    return chunked_page_attention_plain(q, ke, kch, ksc, ve, vch, vsc, pos,
                                        scheme=scheme,
                                        chunk_tokens=chunk_tokens,
                                        per_slot=per_slot)


def chunked_page_attention_paged(q, k_pages, k_checks, k_scale, v_pages,
                                 v_checks, v_scale, table, pos, *,
                                 scheme: str = "in-place",
                                 chunk_tokens: int = 256,
                                 per_slot: bool = False):
    """The chunked kernel over one layer's paged pool, read through the
    page table (operands as :func:`fused_page_attention_paged`). Equal to
    :func:`chunked_page_attention` over the gathered strips, without the
    gather. One launch. ``chunk_tokens`` sets only the plain version's
    chunks (CPU tensors); it has no effect on CUDA tensors, where the
    kernel's tiles and splits are its own (:func:`plan_splits`)."""
    _check_scheme(scheme)
    _check_chunk(chunk_tokens)
    if not q.is_cuda:
        return chunked_page_attention_paged_plain(
            q, k_pages, k_checks, k_scale, v_pages, v_checks, v_scale, table,
            pos, scheme=scheme, chunk_tokens=chunk_tokens, per_slot=per_slot)
    return _launch_chunked(q, k_pages, k_checks, k_scale, v_pages, v_checks,
                           v_scale, table, pos, scheme, per_slot)


def oracle_page_attention(q, ke, kch, ksc, ve, vch, vsc, pos, *,
                          scheme: str = "in-place") -> np.ndarray:
    """Float64 NumPy oracle over the same encoded strips -> (B, H, 1, hd).

    The codec decode is integer-exact (the plain codec); dequantization,
    scores, softmax and PV then run in fp64. The chunked kernel is held to
    it within a tolerance (2% of ``max|oracle|`` on the card)."""
    _check_scheme(scheme, kch, vch, tuple(ke.shape))

    def dequant(enc, ch, sc):
        qv = _decode_cells(enc.cpu(), None if ch is None else ch.cpu(),
                           scheme)[0]
        return (qv.numpy().astype(np.float64) *
                sc.cpu().numpy().astype(np.float64)[..., None, None])

    kf, vf = dequant(ke, kch, ksc), dequant(ve, vch, vsc)    # (B, S, KV, hd)
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

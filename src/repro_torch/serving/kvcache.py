"""Protected paged KV cache — zero-space ECC over serving state.

Counterpart of ``repro.serving.kvcache`` for the presets ``unprotected``,
``parity-zero``, ``in-place`` and their ``-fused`` and ``-chunked`` forms.
Keys/values are int8-quantized per token (absmax over the token's ``(kv,
hd)`` slab, the scale riding the page), WOT-throttled for the in-place
scheme, and encoded into fixed-size pages ``(page_size, kv, hd)`` of a pool
``(nl, P, page_size, kv, hd)`` uint8 (parity-zero adds ``(nl, P,
page_size, kv, hd/8)`` check planes); each sequence reaches its pages
through a page-table row. On the kernel route one ``kv_write`` launch per
layer quantizes, throttles, encodes and stores a step's new K and V (or a
prefill's whole pages). The request front-end sizes the pool on its own
(``n_pages``, with one parking page per slot) and hands pages out through
the refcounted :class:`PageAllocator`, :func:`set_slot_pages`,
:func:`copy_page` (copy-on-write) and :func:`zero_pages`.

Attention decodes pages at use: the reference path gathers the sequence's
encoded strips, block-decodes them, dequantizes and runs the stock
``layers.decode_attention``; the fused path hands the pool and the page
table to the ``fused_page_attention`` kernel (the live strip decoded into
shared memory), and the chunked path to the ``chunked_page_attention``
kernel (a split-KV grid over page tiles, online softmax), which serves
long contexts. Both kernels read the pool through the table themselves:
no gathered copy of the strips is made on their path. The prefill
(:func:`paged_gqa_prefill`) encodes a whole prompt into pages and attends
over the decoded pages. Per-token (corrected, DUE) flags are counted over
valid tokens and returned as values: ``(2,)`` batch totals, or ``(2, B)``
per-slot rows under ``per_slot_flags``.

The port writes tokens into the pools IN PLACE, where the reference
returns new arrays.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.core import ecc
from repro_torch.distributed import local
from repro_torch.kernels import kv_write, paged_attention
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.protection.backends import get_backend
from repro_torch.protection.schemes import ALIASES, get_scheme

__all__ = ["KVProtectionPolicy", "KV_POLICY_PRESETS", "get_kv_policy",
           "supports_paged", "pages_per_seq", "pages_needed",
           "init_paged_cache", "init_cache", "paged_gqa_decode",
           "paged_gqa_prefill", "as_protected_tree", "from_protected_tree",
           "tree_layer_flags", "cache_layer_flags",
           "kv_bytes", "dense_kv_bytes", "PageAllocator", "set_slot_pages",
           "zero_pages", "copy_page"]

# the paper's serving-state menu: parity detects and zeroes, in-place
# corrects singles and detects doubles at zero space
KV_SCHEMES = ("faulty", "parity-zero", "in-place")


@dataclasses.dataclass(frozen=True)
class KVProtectionPolicy:
    """scheme:    "faulty" (unprotected int8 baseline) | "parity-zero" |
               "in-place".
    backend:   block-codec route of the reference path ("torch" | "cuda");
               the prefill's attention follows it too (flash kernel on
               "cuda", ``layers.chunked_causal_attention`` on "torch").
    fused:     decode-at-use attention through a kernel instead of the
               decode-then-attend reference.
    page_size: tokens per page.
    attention_impl: the decode kernel: "strip" holds the whole gathered
               strip in shared memory (``fused_page_attention``, a context
               wall of a few hundred tokens); "chunked" streams page chunks
               through an online softmax (``chunked_page_attention``),
               validated against the fp64 oracle instead of bit for bit.
    chunk_pages: pages per chunk of the chunked attention's plain version
               (its online-softmax steps, kept as the reference's for
               parity); the CUDA kernel's tiles and splits are its own
               (``paged_attention.plan_splits``), so on the card it sets
               nothing.
    per_slot_flags: report KV (corrected, DUE) per batch slot: ``(2, B)``
               rows instead of ``(2,)`` totals, so ``flags["layers_kv"]``
               is (n_layers, 2, B) and the request front-end attributes
               state faults to the request in each slot. Every attention
               path supports it."""

    scheme: str = "in-place"
    backend: str = "torch"
    fused: bool = False
    page_size: int = 16
    attention_impl: str = "strip"
    chunk_pages: int = 16
    per_slot_flags: bool = False

    def __post_init__(self):
        sid = ALIASES.get(self.scheme, self.scheme)
        if sid not in KV_SCHEMES:
            raise ValueError(f"KV scheme {self.scheme!r}; one of {KV_SCHEMES}")
        object.__setattr__(self, "scheme", sid)
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, got {self.page_size}")
        if self.attention_impl not in ("strip", "chunked"):
            raise ValueError(f"attention_impl {self.attention_impl!r}; one "
                             f"of ('strip', 'chunked')")
        if self.chunk_pages <= 0:
            raise ValueError(f"chunk_pages must be positive, "
                             f"got {self.chunk_pages}")

    @property
    def scheme_obj(self):
        return get_scheme(self.scheme)

    @property
    def has_checks(self) -> bool:
        """True when the pools carry out-of-place check planes."""
        return self.scheme == "parity-zero"


# The presets name the scheme and the attention path only; the serve step
# sets the codec route (``backend``) from its own.
KV_POLICY_PRESETS = {
    "unprotected": KVProtectionPolicy(scheme="faulty"),
    "parity-zero": KVProtectionPolicy(scheme="parity-zero"),
    "in-place": KVProtectionPolicy(scheme="in-place"),
    "unprotected-fused": KVProtectionPolicy(scheme="faulty", fused=True),
    "parity-zero-fused": KVProtectionPolicy(scheme="parity-zero", fused=True),
    "in-place-fused": KVProtectionPolicy(scheme="in-place", fused=True),
    # long contexts: the page-chunked online-softmax kernel
    "unprotected-chunked": KVProtectionPolicy(scheme="faulty", fused=True,
                                              attention_impl="chunked"),
    "parity-zero-chunked": KVProtectionPolicy(scheme="parity-zero",
                                              fused=True,
                                              attention_impl="chunked"),
    "in-place-chunked": KVProtectionPolicy(scheme="in-place", fused=True,
                                           attention_impl="chunked"),
}


def get_kv_policy(policy) -> Optional[KVProtectionPolicy]:
    """Resolve a preset name (scheme aliases + optional "-fused" /
    "-chunked" suffix) or pass a policy / None through."""
    if policy is None or isinstance(policy, KVProtectionPolicy):
        return policy
    name = str(policy)
    suffix = next((s for s in ("-fused", "-chunked") if name.endswith(s)), "")
    base = name[: -len(suffix)] if suffix else name
    base = ALIASES.get(base, base)
    base = "unprotected" if base == "faulty" else base
    try:
        return KV_POLICY_PRESETS[base + suffix]
    except KeyError:
        raise ValueError(f"unknown KV policy {policy!r}; one of "
                         f"{sorted(KV_POLICY_PRESETS)}") from None


def supports_paged(cfg: ArchConfig) -> bool:
    """Families whose decode KV state is the dense (B, S, kv, hd) GQA
    cache the paged pool replaces: dense, vlm and moe without MLA. The
    encdec, hybrid and ssm families and MLA serve their dense caches only,
    as in the reference (the hybrid's RG-LRU states and ring, the ssm
    family's recurrent states and MLA's compressed latents are no paged
    pool)."""
    return cfg.family in ("dense", "vlm") or \
        (cfg.family == "moe" and not cfg.use_mla)


def pages_per_seq(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pool pages a request writing ``n_tokens`` positions needs."""
    return -(-n_tokens // page_size)


def init_paged_cache(cfg: ArchConfig, batch: int, max_len: int, policy, *,
                     n_pages: Optional[int] = None, device=None) -> dict:
    """Paged pools:

      k_pages/v_pages   (nl, P, page_size, kv, hd) uint8 encoded pools
      k_checks/v_checks (nl, P, page_size, kv, hd // 8) uint8 (parity only)
      k_scale/v_scale   (nl, P, page_size) f32 per-token scales
      kv_table          (nl, B, pages_per_seq) int32 page tables

    By default the pool is statically partitioned (sequence ``b`` owns pages
    ``b*np .. (b+1)*np`` through an identity table). With ``n_pages`` it is
    sized apart from ``batch`` for the request front-end: pages
    ``0..batch-1`` are per-slot PARKING pages (an idle slot's table row
    points wholly at its own, so its keep-alive writes never touch a live
    request's pages) and pages ``batch..`` are the allocatable pool a
    :class:`PageAllocator` hands out through :func:`set_slot_pages`.

    Zero pages are codec-clean for every scheme (syndrome 0, parity 0), so
    untouched slots decode without phantom flags.
    """
    dev = device_mod.resolve(device)
    policy = get_kv_policy(policy)
    if policy is None:
        raise ValueError("init_paged_cache needs a KV policy")
    if not supports_paged(cfg):   # the reference's error
        raise ValueError(f"paged KV cache supports dense/vlm/moe-gqa decode "
                         f"caches, not family {cfg.family!r}"
                         + (" with MLA" if cfg.use_mla else ""))
    if cfg.head_dim % ecc.BLOCK_BYTES:
        raise ValueError(f"head_dim {cfg.head_dim} must be a multiple of "
                         f"{ecc.BLOCK_BYTES} (ECC blocks run along head_dim)")
    nl, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    ps = policy.page_size
    npg = pages_per_seq(max_len, ps)
    if n_pages is None:
        pool = batch * npg
        table = torch.arange(pool, dtype=torch.int32, device=dev).reshape(
            1, batch, npg).repeat(nl, 1, 1)
    else:
        if n_pages <= batch:
            raise ValueError(f"n_pages={n_pages} leaves no allocatable pages "
                             f"beyond the {batch} per-slot parking pages")
        pool = n_pages
        table = torch.arange(batch, dtype=torch.int32, device=dev).reshape(
            1, batch, 1).repeat(nl, 1, npg)           # slot b parks on page b
    cache = {
        "k_pages": torch.zeros((nl, pool, ps, kv, hd), dtype=torch.uint8,
                               device=dev),
        "v_pages": torch.zeros((nl, pool, ps, kv, hd), dtype=torch.uint8,
                               device=dev),
        "k_scale": torch.zeros((nl, pool, ps), dtype=torch.float32, device=dev),
        "v_scale": torch.zeros((nl, pool, ps), dtype=torch.float32, device=dev),
        "kv_table": table,
    }
    if policy.has_checks:
        for name in ("k_checks", "v_checks"):
            cache[name] = torch.zeros((nl, pool, ps, kv, hd // 8),
                                      dtype=torch.uint8, device=dev)
    return cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, kv_policy=None,
               dtype=torch.bfloat16, device=None) -> dict:
    """Paged + protected cache when a KV policy is given, else the dense
    ``lm.init_cache`` (the hybrid family's: a ring KV cache of
    ``attn_window`` slots beside its RG-LRU states; the ssm family's: its
    state cache, no K or V; MLA's: the latent cache). A KV policy for a
    family without a paged cache (encdec, hybrid, ssm, moe with MLA)
    raises ``ValueError``, as the reference's ``init_paged_cache`` does."""
    if kv_policy is None:
        from repro_torch.models import lm
        return lm.init_cache(cfg, batch, max_len, dtype, device=device)
    return init_paged_cache(cfg, batch, max_len, kv_policy, device=device)


# ---------------------------------------------------------------------------
# codec: per-token quantize (+WOT throttle) -> encode; block decode
# ---------------------------------------------------------------------------


def _encode_kv(kf: torch.Tensor, policy: KVProtectionPolicy):
    """float (..., kv, hd) -> (enc uint8, checks (..., kv, hd/8) uint8 for
    parity-zero else None, scale (...,) f32): the reference's per-token
    quantize (+ WOT throttle for the in-place scheme) and encode, on the
    plain route (``kv_write.encode_plain``; the serve paths encode through
    :func:`_write_kv`)."""
    return kv_write.encode_plain(kf, policy.scheme)


def _decode_kv(enc: torch.Tensor, checks, scheme_id: str, backend="torch"):
    """uint8 (..., kv, hd) -> (q int8, corrected (...,), due (...,)) with
    per-TOKEN int32 counts (so callers can mask them by token validity)."""
    if scheme_id == "faulty":
        z = torch.zeros(enc.shape[:-2], dtype=torch.int32, device=enc.device)
        return enc.view(torch.int8), z, z
    if scheme_id == "parity-zero":
        data, bad = ecc.decode_parity8(enc, checks)
        # zeroing a detected-faulty byte IS this scheme's repair action
        cor = bad.sum(dim=(-2, -1), dtype=torch.int32)
        return data.view(torch.int8), cor, torch.zeros_like(cor)
    if scheme_id != "in-place":
        raise ValueError(f"KV scheme {scheme_id!r}; one of {KV_SCHEMES}")
    blocks = enc.reshape(*enc.shape[:-1], enc.shape[-1] // 8, 8)
    dec, single, double = get_backend(backend).decode64(blocks)
    q = dec.reshape(enc.shape).view(torch.int8)
    return (q, single.sum(dim=(-2, -1), dtype=torch.int32),
            double.sum(dim=(-2, -1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# page-pool plumbing
# ---------------------------------------------------------------------------


def _write_kv(lc: dict, k, v, policy: KVProtectionPolicy, *, pos=None,
              copy: bool = False):
    """Quantize, throttle, encode and store one layer's new K and V (B, T,
    kv, hd) into its pages IN PLACE: a decode token per row at ``pos``, or
    a prefill of whole pages from position 0 (``pos`` None). The "cuda"
    route is one ``kv_write`` launch for K and V; the "torch" route its
    plain version (the reference's ``_encode_kv`` + ``_write_token`` /
    ``_write_pages``). With ``copy`` returns the encoded tokens (``(enc,
    checks, scale)`` for K, then V)."""
    fn = (kv_write.kv_write if get_backend(policy.backend).name == "cuda"
          else kv_write.kv_write_plain)
    return fn(k, v, lc["k_pages"], lc.get("k_checks"), lc["k_scale"],
              lc["v_pages"], lc.get("v_checks"), lc["v_scale"],
              lc["kv_table"], pos, scheme=policy.scheme, copy=copy)


# ---------------------------------------------------------------------------
# page free/reuse: the allocator and table-rewrite API of continuous
# batching (serving.frontend)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Host-side REFCOUNTED free list over the pool's allocatable pages.

    Page ids ``0..reserved-1`` are per-slot parking pages and are never
    handed out. Allocation is deterministic, lowest ids first (a heap), so
    a seeded replay reuses the same physical pages run to run. Prefix
    sharing maps one page into several slots' tables, so every live page
    carries a reference count: :meth:`alloc` hands pages out at count 1,
    :meth:`retain` adds one, and :meth:`free` drops one per page and
    returns the pages whose count reached zero (the caller zeroes exactly
    those). Freeing a page with no live reference raises ("double free"):
    ``free_count + live_count == n_pages - reserved`` always holds.
    """

    def __init__(self, n_pages: int, reserved: int = 0):
        if not 0 <= reserved < n_pages:
            raise ValueError(f"reserved={reserved} outside pool of "
                             f"{n_pages} pages")
        self.n_pages = n_pages
        self.reserved = reserved
        self._free = list(range(reserved, n_pages))
        heapq.heapify(self._free)
        self._refs: dict = {}       # page id -> live reference count

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        """Distinct pages currently out of the pool (any refcount)."""
        return len(self._refs)

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def can(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> tuple:
        """Pop the ``n`` lowest free page ids, each at refcount 1; raises if
        the pool cannot serve them."""
        if not self.can(n):
            raise ValueError(f"page pool exhausted: need {n}, "
                             f"free {len(self._free)}")
        ids = tuple(heapq.heappop(self._free) for _ in range(n))
        for pid in ids:
            self._refs[pid] = 1
        return ids

    def retain(self, page_ids: Sequence[int]) -> None:
        """One more reference per page; only live pages can be retained."""
        for pid in page_ids:
            if self._refs.get(pid, 0) < 1:
                raise ValueError(f"retain of page {pid} with no live "
                                 f"reference")
            self._refs[pid] += 1

    def free(self, page_ids: Sequence[int]) -> tuple:
        """Drop one reference per page -> the pages that re-entered the
        pool. Double frees and parking-page frees raise."""
        released = []
        for pid in page_ids:
            if pid < self.reserved or pid >= self.n_pages:
                raise ValueError(f"page {pid} is not allocatable "
                                 f"(reserved < {self.reserved}, "
                                 f"pool {self.n_pages})")
            refs = self._refs.get(pid, 0)
            if refs < 1:
                raise ValueError(f"double free of page {pid}")
            if refs == 1:
                del self._refs[pid]
                heapq.heappush(self._free, pid)
                released.append(pid)
            else:
                self._refs[pid] = refs - 1
        return tuple(released)

    def live_pages(self) -> tuple:
        """Sorted ids of pages out of the pool (refcount > 0)."""
        return tuple(sorted(self._refs))

    def free_pages(self) -> tuple:
        """Sorted ids of free (allocatable, unreferenced) pages."""
        return tuple(sorted(self._free))


_PAGE_KEYS = ("k_pages", "v_pages", "k_scale", "v_scale", "k_checks",
              "v_checks")


def set_slot_pages(cache: dict, slot: int, page_ids: Sequence[int], *,
                   fill: Optional[int] = None) -> dict:
    """Point ``slot``'s page-table row at ``page_ids`` (logical order) IN
    PLACE, padding the tail with ``fill`` (default: the slot's parking
    page). Tail entries are only gathered, never written, and masked by
    token validity. Returns the cache."""
    table = cache["kv_table"]
    npg = table.shape[2]
    if len(page_ids) > npg:
        raise ValueError(f"{len(page_ids)} pages > pages_per_seq {npg}")
    row = [slot if fill is None else fill] * npg
    row[:len(page_ids)] = [int(p) for p in page_ids]
    table[:, slot, :] = torch.tensor(row, dtype=table.dtype).to(table.device)
    return cache


def copy_page(cache: dict, src: int, dst: int) -> dict:
    """Copy one pool page (encoded bytes, check planes and per-token
    scales) across all layers IN PLACE: the copy-on-write primitive."""
    for key in _PAGE_KEYS:
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    return cache


def zero_pages(cache: dict, page_ids: Sequence[int]) -> dict:
    """Zero the given pool pages (encoded bytes, check planes and scales)
    across all layers IN PLACE. Zero pages are codec-clean for every
    scheme, so a freed page re-enters the pool with no stale carry-over."""
    if len(page_ids) == 0:
        return cache
    ids = torch.tensor(tuple(int(p) for p in page_ids), dtype=torch.long,
                       device=cache["k_pages"].device)
    for key in _PAGE_KEYS:
        if key in cache:
            cache[key][:, ids] = 0
    return cache


# ---------------------------------------------------------------------------
# decode-at-use attention
# ---------------------------------------------------------------------------


def _reference_paged_attention(q, ke, kch, ksc, ve, vch, vsc, pos,
                               policy: KVProtectionPolicy):
    """Decode-then-attend reference over gathered strips: block decode ->
    dequantize -> ``layers.decode_attention``. Returns (o (B, H, 1, hd),
    corrected, due) with flags counted over valid (``<= pos``) tokens:
    scalars, or (B,) rows under ``policy.per_slot_flags``."""
    dtype = q.dtype
    kq, kcor, kdue = _decode_kv(ke, kch, policy.scheme, policy.backend)
    vq, vcor, vdue = _decode_kv(ve, vch, policy.scheme, policy.backend)
    kf = (kq.to(torch.float32) * ksc[..., None, None]).to(dtype)
    vf = (vq.to(torch.float32) * vsc[..., None, None]).to(dtype)
    s = ke.shape[1]
    rep = q.shape[1] // kf.shape[2]
    kh = kf.repeat_interleave(rep, dim=2).transpose(1, 2)      # (B, H, S, hd)
    vh = vf.repeat_interleave(rep, dim=2).transpose(1, 2)
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    o = L.decode_attention(q, kh, vh, valid)
    vm = valid.to(torch.int32)
    dim = 1 if policy.per_slot_flags else None  # (B,) rows: per request
    return (o, ((kcor + vcor) * vm).sum(dim=dim, dtype=torch.int32),
            ((kdue + vdue) * vm).sum(dim=dim, dtype=torch.int32))


def paged_gqa_decode(p, x, cfg: ArchConfig, lc, *, pos,
                     policy: KVProtectionPolicy):
    """Paged, protected drop-in for ``layers.gqa_decode``. x: (B, 1, D);
    ``lc`` is this layer's slice of the paged cache. Encodes the new token
    into its page (in place), then attends over the decoded-at-use pool.
    Returns ``(out, lc, kv_flags)``: (2,) int32, or (2, B) under
    ``policy.per_slot_flags``."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.heads(L._proj(x, p["wq"], p.get("bq")), b, 1, h, hd)
    k = L.heads(L._proj(x, p["wk"], p.get("bk")), b, 1, kv, hd)
    v = L.heads(L._proj(x, p["wv"], p.get("bv")), b, 1, kv, hd)
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    if local.is_dtensor(lc["k_pages"]):   # each data rank's own pages
        o, flags = local.paged_local(
            functools.partial(_paged_attend, policy=policy), lc, q, k, v,
            pos, per_slot=policy.per_slot_flags)
    else:
        o, flags = _paged_attend(lc, q, k, v, pos, policy=policy)
    o = o.transpose(1, 2).reshape(b, 1, h * hd)
    return L._proj(o, p["wo"]), lc, flags


def _paged_attend(lc, q, k, v, pos, *, policy: KVProtectionPolicy):
    """One decode token's K/V write into its page (in place) and the
    attention over the pool -> (o (B, H, 1, hd), flags)."""
    table = lc["kv_table"]
    _write_kv(lc, k, v, policy, pos=pos)
    qh = q.transpose(1, 2)                                   # (B, H, 1, hd)
    pool = (lc["k_pages"], lc.get("k_checks"), lc["k_scale"], lc["v_pages"],
            lc.get("v_checks"), lc["v_scale"], table)
    if policy.attention_impl == "chunked":   # the kernels read the pool
        return paged_attention.chunked_page_attention_paged(
            qh, *pool, pos, scheme=policy.scheme,
            chunk_tokens=policy.chunk_pages * policy.page_size,
            per_slot=policy.per_slot_flags)
    if policy.fused:
        return paged_attention.fused_page_attention_paged(
            qh, *pool, pos, scheme=policy.scheme,
            per_slot=policy.per_slot_flags)
    ke, kch, ksc = paged_attention.gather_strips(*pool[:3], table)
    ve, vch, vsc = paged_attention.gather_strips(*pool[3:6], table)
    o, corrected, due = _reference_paged_attention(
        qh, ke, kch, ksc, ve, vch, vsc, pos, policy)
    return o, torch.stack([corrected, due])


def paged_gqa_prefill(p, x, cfg: ArchConfig, lc, *, positions,
                      policy: KVProtectionPolicy, chunk: int = 2048):
    """Prefill counterpart of :func:`paged_gqa_decode`: project and rope the
    whole sequence, encode it into whole pages (zero-padded; written IN
    PLACE), then attend causally over the DECODED pages, so the logits
    reflect exactly the state later decode steps read. x: (B, S, D).

    Attention follows the codec route: the ``flash_attention`` kernel on
    "cuda", ``layers.chunked_causal_attention`` on "torch". Returns
    ``(out, lc, kv_flags)`` with flags over live tokens: (2,) int32, or
    (2, B) under ``policy.per_slot_flags``."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.heads(L._proj(x, p["wq"], p.get("bq")), b, s, h, hd)
    k = L.heads(L._proj(x, p["wk"], p.get("bk")), b, s, kv, hd)
    v = L.heads(L._proj(x, p["wv"], p.get("bv")), b, s, kv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    pad = (-s) % lc["k_pages"].shape[1]
    if pad:  # zero-pad to whole pages; padded tokens are masked below
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    # the encoded tokens come back as a contiguous copy (B, S', kv, hd)
    ke, kch, ksc, ve, vch, vsc = _write_kv(lc, k, v, policy, copy=True)
    kq, kcor, kdue = _decode_kv(ke, kch, policy.scheme, policy.backend)
    vq, vcor, vdue = _decode_kv(ve, vch, policy.scheme, policy.backend)
    kf = (kq.to(torch.float32) * ksc[..., None, None]).to(x.dtype)[:, :s]
    vf = (vq.to(torch.float32) * vsc[..., None, None]).to(x.dtype)[:, :s]
    rep = h // kv
    qh = L.constrain_heads(q.transpose(1, 2))               # (B, H, S, hd)
    kh = L.constrain_heads(kf.repeat_interleave(rep, dim=2).transpose(1, 2))
    vh = L.constrain_heads(vf.repeat_interleave(rep, dim=2).transpose(1, 2))
    if policy.backend == "cuda":
        from repro_torch.kernels import flash_attention
        o = flash_attention.flash_attention(qh, kh, vh)
    else:
        o = L.chunked_causal_attention(qh, kh, vh, chunk=chunk)
    live = (torch.arange(ke.shape[1], device=x.device) < s).to(
        torch.int32)[None, :]
    dim = 1 if policy.per_slot_flags else None
    flags = torch.stack([((kcor + vcor) * live).sum(dim=dim, dtype=torch.int32),
                         ((kdue + vdue) * live).sum(dim=dim, dtype=torch.int32)])
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return L._proj(o, p["wo"]), lc, flags


def as_protected_tree(cache: dict, policy) -> dict:
    """The k/v pools (and their check planes) as same-shape
    ``ProtectedTensor`` leaves, so the weight fault injector drives KV
    injection unchanged."""
    from repro_torch.protection.tensor import ProtectedTensor
    policy = get_kv_policy(policy)
    return {name: ProtectedTensor(
        enc=cache[f"{name}_pages"], checks=cache.get(f"{name}_checks"),
        scale=cache[f"{name}_scale"][..., None, None],
        scheme_id=policy.scheme, orig_shape=tuple(cache[f"{name}_pages"].shape))
        for name in ("k", "v")}


def from_protected_tree(cache: dict, tree: dict) -> dict:
    """Write a (fault-injected) ``ProtectedTensor`` pair back into a cache:
    a new dict over the injected pools and check planes."""
    new = dict(cache)
    for name in ("k", "v"):
        new[f"{name}_pages"] = tree[name].enc
        if tree[name].checks is not None:
            new[f"{name}_checks"] = tree[name].checks
    return new


def tree_layer_flags(tree: dict, backend="torch") -> torch.Tensor:
    """Per-layer (corrected, due) over a KV ``ProtectedTensor`` pair (from
    :func:`as_protected_tree`) -> (n_layers, 2) int32, the campaign-side
    view of the per-layer rows the serve step reports. Counts the whole
    pool, validity-blind: a fault in a stale slot counts too."""
    out = None
    for name in ("k", "v"):
        pt = tree[name]
        _, cor, due = _decode_kv(pt.enc, pt.checks, pt.scheme_id, backend)
        pair = torch.stack(
            [x.reshape(x.shape[0], -1).sum(-1, dtype=torch.int32)
             for x in (cor, due)], dim=-1)
        out = pair if out is None else out + pair
    return out


def cache_layer_flags(cache: dict, policy, backend=None) -> torch.Tensor:
    """:func:`tree_layer_flags` directly on a paged cache dict (on
    ``backend``, default the policy's)."""
    policy = get_kv_policy(policy)
    return tree_layer_flags(as_protected_tree(cache, policy),
                            backend or policy.backend)


def dense_kv_bytes(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> int:
    """Bytes of the dense cache (per model): every tensor of
    ``lm.init_cache`` (K and V of every layer, the encdec family's cross K
    and V, the hybrid family's ring K and V and RG-LRU states, the ssm
    family's recurrent states and conv histories, MLA's latents and rope
    keys), counted from shapes on
    the ``meta`` device, where nothing is allocated."""
    from repro_torch.models import lm
    cache = lm.init_cache(cfg, batch, max_len, dtype, device="meta")
    return sum(t.numel() * t.element_size() for t in cache.values())


def kv_bytes(cache: dict) -> dict:
    """Where the cache's device memory goes: stored pages, checks, scales,
    tables and their total."""
    out = {"stored": 0, "checks": 0, "scales": 0, "tables": 0}
    for key, a in cache.items():
        nb = a.numel() * a.element_size()
        if key.endswith("_checks"):
            out["checks"] += nb
        elif key.endswith("_scale"):
            out["scales"] += nb
        elif key == "kv_table":
            out["tables"] += nb
        else:
            out["stored"] += nb
    out["total"] = sum(out.values())
    return out

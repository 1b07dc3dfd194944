"""Protected paged KV cache — zero-space ECC over serving state.

Counterpart of ``repro.serving.kvcache`` for the presets ``unprotected``,
``in-place`` and their ``-fused`` and ``-chunked`` forms. Keys/values are
int8-quantized per token (absmax over the token's ``(kv, hd)`` slab, the
scale riding the page), WOT-throttled for the in-place scheme, and encoded
into fixed-size pages ``(page_size, kv, hd)`` of a pool
``(nl, P, page_size, kv, hd)`` uint8; each sequence reaches its pages
through a page-table row.

Attention decodes pages at use: the reference path gathers the sequence's
encoded strips, block-decodes them, dequantizes and runs the stock
``layers.decode_attention``; the fused path hands the gathered strips to
the ``fused_page_attention`` kernel (whole strips in shared memory), and
the chunked path to the ``chunked_page_attention`` kernel (one page chunk
at a time, online softmax), which serves long contexts. The prefill
(:func:`paged_gqa_prefill`) encodes a whole prompt into pages and attends
over the decoded pages. Per-token (corrected, DUE) flags are counted over
valid tokens and returned as values.

The port writes tokens into the pools IN PLACE, where the reference
returns new arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as device_mod
from repro_torch.core import ecc, quant, wot
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.protection.backends import get_backend
from repro_torch.protection.schemes import ALIASES, get_scheme

__all__ = ["KVProtectionPolicy", "KV_POLICY_PRESETS", "get_kv_policy",
           "supports_paged", "pages_per_seq", "pages_needed",
           "init_paged_cache", "init_cache", "paged_gqa_decode",
           "paged_gqa_prefill", "kv_bytes"]

KV_SCHEMES = ("faulty", "in-place")


@dataclasses.dataclass(frozen=True)
class KVProtectionPolicy:
    """scheme:    "faulty" (unprotected int8 baseline) | "in-place".
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
    chunk_pages: pages per chunk of the chunked kernel."""

    scheme: str = "in-place"
    backend: str = "torch"
    fused: bool = False
    page_size: int = 16
    attention_impl: str = "strip"
    chunk_pages: int = 16

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


# The presets name the scheme and the attention path only; the serve step
# sets the codec route (``backend``) from its own.
KV_POLICY_PRESETS = {
    "unprotected": KVProtectionPolicy(scheme="faulty"),
    "in-place": KVProtectionPolicy(scheme="in-place"),
    "unprotected-fused": KVProtectionPolicy(scheme="faulty", fused=True),
    "in-place-fused": KVProtectionPolicy(scheme="in-place", fused=True),
    # long contexts: the page-chunked online-softmax kernel
    "unprotected-chunked": KVProtectionPolicy(scheme="faulty", fused=True,
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
        raise ValueError(f"unknown or unported KV policy {policy!r}; one of "
                         f"{sorted(KV_POLICY_PRESETS)}") from None


def supports_paged(cfg: ArchConfig) -> bool:
    """Families whose decode KV state the paged pool replaces; the port
    has the dense family only."""
    return cfg.family == "dense"


def pages_per_seq(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pool pages a request writing ``n_tokens`` positions needs."""
    return -(-n_tokens // page_size)


def init_paged_cache(cfg: ArchConfig, batch: int, max_len: int, policy, *,
                     device=None) -> dict:
    """Paged pools, statically partitioned (sequence ``b`` owns pages
    ``b*np .. (b+1)*np`` through an identity table):

      k_pages/v_pages  (nl, P, page_size, kv, hd) uint8 encoded pools
      k_scale/v_scale  (nl, P, page_size) f32 per-token scales
      kv_table         (nl, B, pages_per_seq) int32 page tables

    Zero pages are codec-clean (syndrome 0), so untouched slots decode
    without phantom flags.
    """
    dev = device_mod.resolve(device)
    policy = get_kv_policy(policy)
    if policy is None:
        raise ValueError("init_paged_cache needs a KV policy")
    if not supports_paged(cfg):
        raise NotImplementedError(f"paged KV cache for family {cfg.family!r} "
                                  f"is not ported yet")
    if cfg.head_dim % ecc.BLOCK_BYTES:
        raise ValueError(f"head_dim {cfg.head_dim} must be a multiple of "
                         f"{ecc.BLOCK_BYTES} (ECC blocks run along head_dim)")
    nl, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    ps = policy.page_size
    npg = pages_per_seq(max_len, ps)
    pool = batch * npg
    table = torch.arange(pool, dtype=torch.int32, device=dev).reshape(
        1, batch, npg).repeat(nl, 1, 1)
    return {
        "k_pages": torch.zeros((nl, pool, ps, kv, hd), dtype=torch.uint8,
                               device=dev),
        "v_pages": torch.zeros((nl, pool, ps, kv, hd), dtype=torch.uint8,
                               device=dev),
        "k_scale": torch.zeros((nl, pool, ps), dtype=torch.float32, device=dev),
        "v_scale": torch.zeros((nl, pool, ps), dtype=torch.float32, device=dev),
        "kv_table": table,
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, kv_policy=None,
               dtype=torch.bfloat16, device=None) -> dict:
    """Paged + protected cache when a KV policy is given, else the dense
    ``lm.init_cache``."""
    if kv_policy is None:
        from repro_torch.models import lm
        return lm.init_cache(cfg, batch, max_len, dtype, device=device)
    return init_paged_cache(cfg, batch, max_len, kv_policy, device=device)


# ---------------------------------------------------------------------------
# codec: per-token quantize (+WOT throttle) -> encode; block decode
# ---------------------------------------------------------------------------


def _encode_kv(kf: torch.Tensor, policy: KVProtectionPolicy):
    """float (..., kv, hd) -> (enc uint8, checks None, scale (...,) f32)."""
    kf32 = kf.to(torch.float32)
    scale = quant.compute_scale(kf32, dim=(-2, -1))           # (..., 1, 1)
    q, _ = quant.quantize(kf32, scale=scale)
    scheme = policy.scheme_obj
    if scheme.requires_wot:   # hd % 8 == 0: blocks run along head_dim
        q = get_backend(policy.backend).throttle(
            q.reshape(-1, wot.BLOCK)).reshape(q.shape)
    enc, checks = scheme.encode(q, policy.backend)
    return enc, checks, scale[..., 0, 0]


def _decode_kv(enc: torch.Tensor, checks, scheme_id: str, backend="torch"):
    """uint8 (..., kv, hd) -> (q int8, corrected (...,), due (...,)) with
    per-TOKEN int32 counts (so callers can mask them by token validity)."""
    if scheme_id == "faulty":
        z = torch.zeros(enc.shape[:-2], dtype=torch.int32, device=enc.device)
        return enc.view(torch.int8), z, z
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


def _write_token(pages, checks, scales, table, enc, ch, sc, pos):
    """Scatter one decode token into its page IN PLACE. enc (B, kv, hd);
    sc/pos (B,)."""
    ps = pages.shape[1]
    page = (pos // ps).long()
    phys = torch.gather(table, 1, page[:, None])[:, 0].long()       # (B,)
    slot = (pos % ps).long()
    pages[phys, slot] = enc
    if checks is not None:
        checks[phys, slot] = ch
    scales[phys, slot] = sc
    return pages, checks, scales


def _write_pages(pages, checks, scales, table, enc, ch, sc):
    """Scatter whole prefill pages IN PLACE. enc (B, npg*ps, kv, hd);
    sc (B, npg*ps)."""
    b = table.shape[0]
    ps = pages.shape[1]
    npg = enc.shape[1] // ps
    idx = table[:, :npg].reshape(-1).long()                  # (B*npg,)
    pages[idx] = enc.reshape(b * npg, ps, *enc.shape[2:])
    if checks is not None:
        checks[idx] = ch.reshape(b * npg, ps, *ch.shape[2:])
    scales[idx] = sc.reshape(b * npg, ps)
    return pages, checks, scales


def _gather_seq(pages, checks, scales, table):
    """Pool -> per-sequence encoded strips: (enc (B, S, kv, hd), checks |
    None, scale (B, S)) with S = pages_per_seq * page_size."""
    b, npg = table.shape
    ps = pages.shape[1]
    idx = table.long()
    enc = pages[idx].reshape(b, npg * ps, *pages.shape[2:])
    ch = None
    if checks is not None:
        ch = checks[idx].reshape(b, npg * ps, *checks.shape[2:])
    sc = scales[idx].reshape(b, npg * ps)
    return enc, ch, sc


# ---------------------------------------------------------------------------
# decode-at-use attention
# ---------------------------------------------------------------------------


def _reference_paged_attention(q, ke, kch, ksc, ve, vch, vsc, pos,
                               policy: KVProtectionPolicy):
    """Decode-then-attend reference over gathered strips: block decode ->
    dequantize -> ``layers.decode_attention``. Returns (o (B, H, 1, hd),
    corrected, due) with flags counted over valid (``<= pos``) tokens."""
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
    return (o, ((kcor + vcor) * vm).sum(dtype=torch.int32),
            ((kdue + vdue) * vm).sum(dtype=torch.int32))


def paged_gqa_decode(p, x, cfg: ArchConfig, lc, *, pos,
                     policy: KVProtectionPolicy):
    """Paged, protected drop-in for ``layers.gqa_decode``. x: (B, 1, D);
    ``lc`` is this layer's slice of the paged cache. Encodes the new token
    into its page (in place), then attends over the decoded-at-use pool.
    Returns ``(out, lc, kv_flags (2,) int32)``."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L._proj(x, p["wq"], p.get("bq")).reshape(b, 1, h, hd)
    k = L._proj(x, p["wk"], p.get("bk")).reshape(b, 1, kv, hd)
    v = L._proj(x, p["wv"], p.get("bv")).reshape(b, 1, kv, hd)
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    table = lc["kv_table"]
    ke1, kch1, ksc1 = _encode_kv(k[:, 0], policy)            # (B, kv, hd)
    ve1, vch1, vsc1 = _encode_kv(v[:, 0], policy)
    _write_token(lc["k_pages"], lc.get("k_checks"), lc["k_scale"], table,
                 ke1, kch1, ksc1, pos)
    _write_token(lc["v_pages"], lc.get("v_checks"), lc["v_scale"], table,
                 ve1, vch1, vsc1, pos)

    ke, kch, ksc = _gather_seq(lc["k_pages"], lc.get("k_checks"),
                               lc["k_scale"], table)
    ve, vch, vsc = _gather_seq(lc["v_pages"], lc.get("v_checks"),
                               lc["v_scale"], table)
    qh = q.transpose(1, 2)                                   # (B, H, 1, hd)
    if policy.attention_impl == "chunked":
        from repro_torch.kernels import paged_attention
        o, flags = paged_attention.chunked_page_attention(
            qh, ke, kch, ksc, ve, vch, vsc, pos, scheme=policy.scheme,
            chunk_tokens=policy.chunk_pages * policy.page_size)
    elif policy.fused:
        from repro_torch.kernels import paged_attention
        o, flags = paged_attention.fused_page_attention(
            qh, ke, kch, ksc, ve, vch, vsc, pos, scheme=policy.scheme)
    else:
        o, corrected, due = _reference_paged_attention(
            qh, ke, kch, ksc, ve, vch, vsc, pos, policy)
        flags = torch.stack([corrected, due])
    o = o.transpose(1, 2).reshape(b, 1, h * hd)
    return L._proj(o, p["wo"]), lc, flags


def paged_gqa_prefill(p, x, cfg: ArchConfig, lc, *, positions,
                      policy: KVProtectionPolicy, chunk: int = 2048):
    """Prefill counterpart of :func:`paged_gqa_decode`: project and rope the
    whole sequence, encode it into whole pages (zero-padded; written IN
    PLACE), then attend causally over the DECODED pages, so the logits
    reflect exactly the state later decode steps read. x: (B, S, D).

    Attention follows the codec route: the ``flash_attention`` kernel on
    "cuda", ``layers.chunked_causal_attention`` on "torch". Returns
    ``(out, lc, kv_flags (2,) int32)`` with flags over live tokens."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L._proj(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = L._proj(x, p["wk"], p.get("bk")).reshape(b, s, kv, hd)
    v = L._proj(x, p["wv"], p.get("bv")).reshape(b, s, kv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    pad = (-s) % lc["k_pages"].shape[1]
    if pad:  # zero-pad to whole pages; padded tokens are masked below
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    table = lc["kv_table"]
    ke, kch, ksc = _encode_kv(k, policy)                     # (B, S', kv, hd)
    ve, vch, vsc = _encode_kv(v, policy)
    _write_pages(lc["k_pages"], lc.get("k_checks"), lc["k_scale"], table,
                 ke, kch, ksc)
    _write_pages(lc["v_pages"], lc.get("v_checks"), lc["v_scale"], table,
                 ve, vch, vsc)

    kq, kcor, kdue = _decode_kv(ke, kch, policy.scheme, policy.backend)
    vq, vcor, vdue = _decode_kv(ve, vch, policy.scheme, policy.backend)
    kf = (kq.to(torch.float32) * ksc[..., None, None]).to(x.dtype)[:, :s]
    vf = (vq.to(torch.float32) * vsc[..., None, None]).to(x.dtype)[:, :s]
    rep = h // kv
    qh = q.transpose(1, 2)                                   # (B, H, S, hd)
    kh = kf.repeat_interleave(rep, dim=2).transpose(1, 2)
    vh = vf.repeat_interleave(rep, dim=2).transpose(1, 2)
    if policy.backend == "cuda":
        from repro_torch.kernels import flash_attention
        o = flash_attention.flash_attention(qh, kh, vh)
    else:
        o = L.chunked_causal_attention(qh, kh, vh, chunk=chunk)
    live = (torch.arange(ke.shape[1], device=x.device) < s).to(
        torch.int32)[None, :]
    flags = torch.stack([((kcor + vcor) * live).sum(dtype=torch.int32),
                         ((kdue + vdue) * live).sum(dtype=torch.int32)])
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return L._proj(o, p["wo"]), lc, flags


def as_protected_tree(cache: dict, policy) -> dict:
    """The k/v pools as same-shape ``ProtectedTensor`` leaves, so the weight
    fault injector drives KV injection unchanged."""
    from repro_torch.protection.tensor import ProtectedTensor
    policy = get_kv_policy(policy)
    return {name: ProtectedTensor(
        enc=cache[f"{name}_pages"], checks=None,
        scale=cache[f"{name}_scale"][..., None, None],
        scheme_id=policy.scheme, orig_shape=tuple(cache[f"{name}_pages"].shape))
        for name in ("k", "v")}


def from_protected_tree(cache: dict, tree: dict) -> dict:
    """Write a (fault-injected) ``ProtectedTensor`` pair back into a cache."""
    new = dict(cache)
    for name in ("k", "v"):
        new[f"{name}_pages"] = tree[name].enc
    return new


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

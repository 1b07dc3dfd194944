"""Model building blocks of every family (pure functions over dicts).

Counterpart of ``repro.models.layers``: RMS and layer norms, RoPE,
single-token GQA attention (over a dense cache, or a ring of ``window``
slots), full-sequence GQA attention (training, the cache-less forward and
the bidirectional encoder; causal, or over a sliding window), chunked
causal attention, cross-attention, MLA (DeepSeek's multi-head latent
attention: over a full sequence, and one token over the compressed latent
cache), the SwiGLU and GELU MLPs, the capacity-based top-k MoE, the RG-LRU
recurrent block with its depthwise causal conv (full sequence and single
step), the Mamba2 mixer (the SSD chunked scan over a full sequence, the
single-step recurrence over its state), embedding and logits. ``wt`` is
the weight transform of QAT training (fake-quant): it applies to
projection weights and the head only, never to the embedding lookup or
to norms, and defaults to the identity so the serve paths are
untouched. Where the reference routes fault flags, ABFT counts and
calibration absmaxes through module-level sinks
(``layers.record_flags``, ``record_abft``, ``record_act``), the port
hands each decode-at-use view the methods of a :class:`FlagRecorder`
that the serve step creates per step and the model drains per layer, so
they come back as values.

The sharding context (:func:`set_sharding_ctx`; a sharded cell's step sets
its own for the duration of each call, ``launch.specs``) pins internals to
a layout as the reference's does: attention heads over 'model'
(:func:`constrain_heads`), the MoE dispatch buffers, the residual stream
(``lm._constrain_residual``). With a context that holds a ``mesh`` and a
DTensor input, :func:`constrain` is ``x.redistribute(mesh, placements)``;
otherwise it returns ``x``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import local


def Identity(w):
    return w


# --------------------------------------------------------------------------
# sharding context: {"dp": ("pod", "data") | "data", "model": "model", "sp":
# bool, "model_size": int, "mesh": DeviceMesh | None}; None => no constraints
# --------------------------------------------------------------------------

SHARDING_CTX: dict | None = None


def set_sharding_ctx(ctx: dict | None):
    global SHARDING_CTX
    SHARDING_CTX = ctx


def constrain(x, *spec):
    """Pin ``x`` to the layout ``P(*spec)`` (axes that do not divide their
    dimension dropped): a DTensor is redistributed over the context's
    mesh; anything else, or no context, passes through."""
    if SHARDING_CTX is None or SHARDING_CTX.get("mesh") is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed import sharding as sh
    from repro_torch.protection.plan import _drop_nondividing
    mesh = SHARDING_CTX["mesh"]
    spec = _drop_nondividing(sh.P(*spec), tuple(x.shape), sh.mesh_sizes(mesh))
    return x.redistribute(mesh, sh.to_placements(spec, mesh))


def ctx_dp():
    return SHARDING_CTX.get("dp") if SHARDING_CTX else None


def constrain_heads(t):
    """(B, H, S, D) attention tensor -> heads over 'model' when the head
    count divides the axis, so softmax and scores stay local per shard.
    Off under sequence parallelism, where S owns the 'model' axis (the
    reference measured the two constraints together forcing full
    rematerialization)."""
    if SHARDING_CTX is None or SHARDING_CTX.get("sp"):
        return t
    msize = SHARDING_CTX.get("model_size", 1)
    if t.shape[1] % msize == 0:
        return constrain(t, ctx_dp(), "model", None, None)
    return t


class FlagRecorder:
    """The per-step channels of one serve step, prefill or calibration
    pass: every decode-at-use view records into it, and the model drains it
    once per layer.

    * (corrected, due) memory-fault counts: :meth:`record` / :meth:`drain`;
    * with ``abft=True``, (checksum mismatches, clamp hits) of the guarded
      matmuls: :meth:`record_abft` / :meth:`drain_abft` — scalars, or with
      ``abft_rows=B`` per-slot (B,) rows that drain to (2, B), as the
      reference's per-slot ABFT sink;
    * the calibration channel, each matmul's activation absmax by leaf
      path, kept as device tensors: :meth:`record_act` /
      :meth:`drain_acts`."""

    def __init__(self, device, *, abft: bool = False, abft_rows=None):
        self.device = device
        self.abft = abft
        self.abft_rows = abft_rows
        self._pairs: list = []
        self._abft: list = []
        self._acts: dict = {}

    def _sum(self, pairs, rows=None) -> torch.Tensor:
        """Sum and clear recorded pairs -> (2,) int32, or (2, rows) when
        each entry is a (rows,) vector, in one stack and one reduction
        however many pairs there are."""
        shape = () if rows is None else (rows,)
        if not pairs:
            return torch.zeros((2, *shape), dtype=torch.int32,
                               device=self.device)
        vals = torch.stack([torch.as_tensor(x).reshape(shape).to(
            device=self.device, dtype=torch.int32) for p in pairs for x in p])
        pairs.clear()
        return vals.view(-1, 2, *shape).sum(0, dtype=torch.int32)

    def record(self, corrected, due) -> None:
        self._pairs.append((corrected, due))

    def drain(self) -> torch.Tensor:
        """Sum and clear the recorded pairs -> (2,) int32."""
        return self._sum(self._pairs)

    def record_abft(self, mismatches, clamp_hits) -> None:
        self._abft.append((mismatches, clamp_hits))

    def drain_abft(self) -> torch.Tensor:
        """Sum and clear the (mismatches, clamp hits) pairs -> (2,) int32,
        or (2, abft_rows) per-slot rows."""
        return self._sum(self._abft, self.abft_rows)

    def record_act(self, path: str, absmax) -> None:
        prev = self._acts.get(path)
        self._acts[path] = absmax if prev is None else torch.maximum(prev,
                                                                     absmax)

    def drain_acts(self) -> dict:
        """Clear and return the recorded ``{leaf path: absmax}`` map."""
        out, self._acts = self._acts, {}
        return out


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x, w, eps=1e-6):
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w.to(x.dtype)


def layer_norm(x, w, b, eps=1e-5):
    """``(x - mean) * rsqrt(var + eps) * w + b`` in f32 with the population
    variance, cast to x's dtype once, as the reference computes it."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def apply_norm(x, p, kind):
    if kind == "rms":
        return rms_norm(x, p["w"])
    if kind == "layer":
        return layer_norm(x, p["w"], p["b"])
    raise ValueError(f"norm {kind!r}; one of ('rms', 'layer')")


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    """``1 / theta ** (2i / head_dim)`` in f64, built on ``device`` (a host
    array copied per call would stall the host on the card every layer)."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device).to(torch.float32)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)          # broadcast heads
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _attend_chunk(q, k, v, mask, scale):
    """q (B,H,Sq,D) k/v (B,H,Sk,D[v]) mask (Sq,Sk) or None -> (o, m, l);
    ``o`` in v's dtype, ``m`` and ``l`` f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1)                            # (B,H,Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)                             # (B,H,Sq)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o, m, l


def chunked_causal_attention(q, k, v, *, chunk: int = 2048,
                             window: int = 0) -> torch.Tensor:
    """Online-softmax causal attention, the plain route's prefill attention.

    q,k,v: (B, H, S, D) (k/v already GQA-broadcast). ``window > 0``
    restricts each query to a sliding local window (the chunk becomes the
    window). Returns (B, H, S, Dv). Query chunk ``i`` attends its diagonal
    chunk first, then merges key chunks ``0..i-1`` in order (``i-1`` only
    when windowed), as the reference's triangle path does. The reference
    turns the triangle off under sequence parallelism (its per-chunk slices
    would land on single shards); here a sharded q is attended per head on
    local tensors (``local.per_head``), so the triangle always applies and
    gives the reference's values.
    """
    if local.is_dtensor(q):   # each rank attends its own heads
        return local.per_head(chunked_causal_attention, q, k, v, chunk=chunk,
                              window=window)
    b, h, s, d = q.shape
    dv = v.shape[-1]
    scale = 1.0 / np.sqrt(d)
    if window:
        if window >= s:
            window = 0      # window covers everything -> plain causal
        else:
            chunk = window  # one previous chunk == the window
    chunk = min(chunk, s)
    if s % chunk:  # zero-pad the tail; padded keys are causally invisible
        pad = chunk - s % chunk  # to real queries, padded rows are cut off
        grow = lambda t: F.pad(t, (0, 0, 0, pad))
        out = chunked_causal_attention(grow(q), grow(k), grow(v), chunk=chunk,
                                       window=window)
        return out[:, :, :s]
    nq = s // chunk
    qc = q.reshape(b, h, nq, chunk, d)
    kc = k.reshape(b, h, nq, chunk, d)
    vc = v.reshape(b, h, nq, chunk, dv)
    idx = torch.arange(chunk, device=q.device)
    diag_mask = idx[:, None] >= idx[None, :]
    # windowed: only keys of the previous chunk strictly newer than q - chunk
    prev_mask = (idx[:, None] < idx[None, :]) if window else None
    outs = []
    for i in range(nq):
        qi = qc[:, :, i]
        o, m, l = _attend_chunk(qi, kc[:, :, i], vc[:, :, i], diag_mask, scale)
        prev = ([i - 1] if i else []) if window else range(i)
        for j in prev:
            o2, m2, l2 = _attend_chunk(qi, kc[:, :, j], vc[:, :, j], prev_mask,
                                       scale)
            mnew = torch.maximum(m, m2)
            a1, a2 = torch.exp(m - mnew), torch.exp(m2 - mnew)
            o = o * a1[..., None].to(o.dtype) + o2 * a2[..., None].to(o.dtype)
            l = l * a1 + l2 * a2
            m = mnew
        outs.append(o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype))
    return torch.stack(outs, dim=2).reshape(b, h, s, dv)


def decode_attention(q, k_cache, v_cache, length_mask=None):
    """q: (B,H,1,D); caches: (B,H,Skv,D). Full-cache single-token attention
    (a sharded cache attends shard by shard: ``distributed.local``)."""
    if local.is_dtensor(k_cache):
        return local.cache_attention(q, k_cache, v_cache, length_mask,
                                     decode_attention)
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_cache).to(torch.float32) * scale
    if length_mask is not None:
        s = torch.where(length_mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v_cache)


def gqa_params_shape(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
         "wo": (h * hd, d)}
    if cfg.qkv_bias:
        p.update({"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)})
    return p


def heads(t, b, s, n, hd):
    """A projection's (B, S, n*hd) output -> (B, S, n, hd). A DTensor split
    over its last dim by more shards than ``n`` divides into is gathered
    on that dim first (the heads cannot be cut there)."""
    if local.is_dtensor(t):
        t = local.splittable(t, n)
    return t.reshape(b, s, n, hd)


def _proj(x, w, b=None, wt=Identity):
    w = wt(w)
    if getattr(w, "decode_at_use", False):
        y = w.matmul(x)  # decode-at-use view: fused kernel or inline decode
    else:
        if local.is_dtensor(w):   # a sharded weight: lay the operands out
            x, w = local.tp_operands(x, w)
            y = local.grad_as_output(x @ w.to(x.dtype))
        else:
            y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def gqa_attention(p, x, cfg, *, positions, wt=Identity, causal=True,
                  window=0, chunk=2048, attention="torch"):
    """Attention over a full sequence (training, cache-less forward).
    x: (B, S, D); positions: (B, S) int. ``attention`` routes the causal
    attention: "torch" (:func:`chunked_causal_attention`) or "cuda" (the
    flash kernel). ``window > 0`` restricts each query to the ``window``
    newest keys up to itself on both routes; a window of at least S covers
    every key and is dropped, as :func:`chunked_causal_attention` drops
    it."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = heads(_proj(x, p["wq"], p.get("bq"), wt), b, s, h, hd)
    k = heads(_proj(x, p["wk"], p.get("bk"), wt), b, s, kv, hd)
    v = heads(_proj(x, p["wv"], p.get("bv"), wt), b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    rep = h // kv    # GQA broadcast kv -> h
    k = local.whole_grad(k.repeat_interleave(rep, dim=2), 2)
    v = local.whole_grad(v.repeat_interleave(rep, dim=2), 2)
    q, k, v = (constrain_heads(t.transpose(1, 2)) for t in (q, k, v))
    if causal and attention == "cuda":
        from repro_torch.kernels import flash_attention
        o = flash_attention.flash_attention(q, k, v,
                                            window=window if window < s else 0)
    elif causal:
        o = chunked_causal_attention(q, k, v, chunk=chunk, window=window)
    else:  # bidirectional (an encoder)
        o = full_attention(q, k, v)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return _proj(o, p["wo"], None, wt)


def full_attention(q, k, v):
    """Unmasked attention (an encoder, cross-attention): q (B, H, Sq, D),
    k/v (B, H, Sk, D[v]) -> (B, H, Sq, Dv)."""
    if local.is_dtensor(q):
        return local.per_head(full_attention, q, k, v)
    o, _, l = _attend_chunk(q, k, v, None, 1.0 / np.sqrt(q.shape[-1]))
    return o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype)


def gqa_decode(p, x, cfg, cache, *, pos, window=0):
    """Single-token decode over a dense cache. x: (B,1,D); cache: {"k","v":
    (B, Smax, kv, hd)} — this layer's slice, written IN PLACE (the port
    updates the cache where the reference returns a new one).

    ``window > 0`` makes the cache a ring: token ``pos`` goes to slot ``pos
    % Smax``, and slot j, which holds the newest token t <= pos with t %
    Smax == j (age ``(pos - j) % Smax``), is attended iff its age is below
    ``min(window, Smax)`` and at most ``pos`` (it was written), as the
    reference masks it. Returns (out, cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = heads(_proj(x, p["wq"], p.get("bq")), b, 1, h, hd)
    k = heads(_proj(x, p["wk"], p.get("bk")), b, 1, kv, hd)
    v = heads(_proj(x, p["wv"], p.get("bv")), b, 1, kv, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    smax = cache["k"].shape[1]
    slot = pos % smax if window else pos
    local.put_rows(cache["k"], rows, slot, k[:, 0].to(cache["k"].dtype))
    local.put_rows(cache["v"], rows, slot, v[:, 0].to(cache["v"].dtype))
    rep = h // kv
    kh = cache["k"].repeat_interleave(rep, dim=2).transpose(1, 2)  # (B,H,S,hd)
    vh = cache["v"].repeat_interleave(rep, dim=2).transpose(1, 2)
    slots = torch.arange(smax, device=x.device)[None, :]
    if window:
        age = (pos[:, None] - slots) % smax
        valid = (age < min(window, smax)) & (age <= pos[:, None])
    else:
        valid = slots <= pos[:, None]
    o = decode_attention(q.transpose(1, 2), kh, vh, valid)
    o = o.transpose(1, 2).reshape(b, 1, h * hd)
    return _proj(o, p["wo"]), cache


# --------------------------------------------------------------------------
# cross-attention (the encoder-decoder's decoder)
# --------------------------------------------------------------------------


def cross_params_shape(cfg):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": (d, h * hd), "wk": (d, h * hd), "wv": (d, h * hd),
            "wo": (h * hd, d)}


def cross_kv(p, enc_out, cfg, wt=Identity):
    """Cross-attention K and V from the encoder's output: (B, Se, H, hd)
    each, with ``n_heads`` heads (not ``n_kv_heads``)."""
    b, se, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.head_dim
    k = _proj(enc_out, p["wk"], None, wt).reshape(b, se, h, hd)
    v = _proj(enc_out, p["wv"], None, wt).reshape(b, se, h, hd)
    return k, v


def cross_attention(p, x, kv, cfg, wt=Identity):
    """x: (B, Sd, D); kv: (k, v) each (B, Se, H, hd). Every query attends
    over every encoder position (no mask)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = heads(_proj(x, p["wq"], None, wt), b, s, h, hd).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kv)
    o = full_attention(q, k, v)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return _proj(o, p["wo"], None, wt)


# --------------------------------------------------------------------------
# MLA attention (deepseek v2/v3): a compressed KV cache
# --------------------------------------------------------------------------


def mla_params_shape(cfg):
    d, h = cfg.d_model, cfg.n_heads
    r, qn, qr, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    p = {"w_dkv": (d, r + qr),     # compress: the kv latent + a shared rope key
         "w_uk": (r, h * qn),      # latent -> per-head nope keys
         "w_uv": (r, h * vd),      # latent -> per-head values
         "wo": (h * vd, d)}
    if cfg.q_lora_rank:
        p["w_dq"] = (d, cfg.q_lora_rank)
        p["w_uq"] = (cfg.q_lora_rank, h * (qn + qr))
    else:
        p["wq"] = (d, h * (qn + qr))
    return p


def _mla_q(p, x, cfg, wt=Identity):
    """The queries, split into their nope and rope parts (B, S, H, qn) and
    (B, S, H, qr): one projection ``wq`` (v2), or the low-rank pair
    ``w_dq`` -> ``w_uq`` (v3's ``q_lora_rank``)."""
    b, s, _ = x.shape
    h, qn, qr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = _proj(_proj(x, p["w_dq"], None, wt), p["w_uq"], None, wt)
    else:
        q = _proj(x, p["wq"], None, wt)
    q = heads(q, b, s, h, qn + qr)
    return q[..., :qn], q[..., qn:]


def _mla_kv_in(p, x, cfg, positions, wt=Identity):
    """The compressed stream: the latent (B, S, r) and the shared rope key
    (B, S, 1, qr), roped at ``positions``."""
    r = cfg.kv_lora_rank
    dkv = _proj(x, p["w_dkv"], None, wt)
    k_rope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)
    return dkv[..., :r], k_rope


def mla_attention(p, x, cfg, *, positions, wt=Identity, chunk=2048,
                  attention="torch"):
    """MLA over a full sequence (training, the cache-less forward). x: (B,
    S, D); positions: (B, S). The keys are [W_uk(latent), the shared rope
    key] (``qk_nope_dim + qk_rope_dim`` dims), the values W_uv(latent)
    (``v_head_dim``), with the scale ``1/sqrt(qk_nope_dim + qk_rope_dim)``.
    ``attention`` routes the causal attention: "torch"
    (:func:`chunked_causal_attention`) or "cuda" (the flash kernel, built
    for this head split). Profiler range: ``mla``."""
    b, s, _ = x.shape
    h, qn, qr, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    with torch.profiler.record_function("mla"):
        q_nope, q_rope = _mla_q(p, x, cfg, wt)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        latent, k_rope = _mla_kv_in(p, x, cfg, positions, wt)
        k_nope = heads(_proj(latent, p["w_uk"], None, wt), b, s, h, qn)
        v = heads(_proj(latent, p["w_uv"], None, wt), b, s, h, vd)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, qr)], dim=-1)
        q, k, v = (constrain_heads(t.transpose(1, 2)) for t in (q, k, v))
        if attention == "cuda":
            from repro_torch.kernels import flash_attention
            o = flash_attention.flash_attention(q, k, v)
        else:
            o = chunked_causal_attention(q, k, v, chunk=chunk)
        o = o.transpose(1, 2).reshape(b, s, h * vd)
    return _proj(o, p["wo"], None, wt)


def mla_decode(p, x, cfg, cache, *, pos):
    """MLA decode over the compressed cache: {"latent": (B, Smax, r),
    "k_rope": (B, Smax, qr)} — this layer's slice, written IN PLACE at
    ``pos``. As in the reference, every step re-expands all ``Smax``
    cached latents through ``w_uk`` and ``w_uv`` (one projection of B·Smax
    rows each) and masks the slots past ``pos``; the scores are the nope
    and rope dot products summed in x's dtype, then scaled in f32.
    Returns (out (B, 1, D), cache). Profiler range: ``mla``."""
    b = x.shape[0]
    h, qn, qr, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    with torch.profiler.record_function("mla"):
        q_nope, q_rope = _mla_q(p, x, cfg)
        q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
        latent, k_rope = _mla_kv_in(p, x, cfg, pos[:, None])
        rows = torch.arange(b, device=x.device)
        lat_c, kr_c = cache["latent"], cache["k_rope"]
        local.put_rows(lat_c, rows, pos, latent[:, 0].to(lat_c.dtype))
        local.put_rows(kr_c, rows, pos, k_rope[:, 0, 0].to(kr_c.dtype))
        smax = lat_c.shape[1]
        k_nope = heads(_proj(lat_c, p["w_uk"]), b, smax, h, qn)
        v = heads(_proj(lat_c, p["w_uv"]), b, smax, h, vd)
        args = (q_nope, q_rope, k_nope, kr_c, v, pos)
        if any(local.is_dtensor(t) for t in args):
            # each rank attends its own (batch row, head) pairs
            o = local.rows_heads(_mla_decode_core, args, (2, 2, 2, None, 2,
                                                          None),
                                 (b, 1, h, vd), 2)
        else:
            o = _mla_decode_core(*args)
        o = o.reshape(b, 1, h * vd)
    return _proj(o, p["wo"]), cache


def _mla_decode_core(q_nope, q_rope, k_nope, kr_c, v, pos):
    """MLA's decode attention over the expanded cache: the nope and rope
    scores summed in the queries' dtype, scaled in f32, the slots past
    ``pos`` masked -> (B, 1, H, vd)."""
    smax = k_nope.shape[1]
    s1 = torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
    s2 = torch.einsum("bqhd,bkd->bhqk", q_rope, kr_c.to(q_rope.dtype))
    sc = (s1 + s2).to(torch.float32) / np.sqrt(q_nope.shape[-1] +
                                               q_rope.shape[-1])
    valid = torch.arange(smax, device=pos.device)[None, :] <= pos[:, None]
    sc = torch.where(valid[:, None, None, :], sc, -1e30)
    pr = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", pr, v)


# --------------------------------------------------------------------------
# RG-LRU (the hybrid family's recurrent block)
# --------------------------------------------------------------------------


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, L, C); w: (K, C). Tap i reads the
    input ``K - 1 - i`` steps back (zeros before the start), summed in the
    reference's order in x's dtype."""
    k = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, : x.shape[1]]
        out = out + xi * w[i].to(x.dtype)
    return out


def rglru_params_shape(cfg):
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {"w_x": (d, w), "w_y_gate": (d, w),
            "conv_w": (cfg.ssm_conv_width or 4, w),
            "w_input_gate": (w, w), "w_a_gate": (w, w), "a_param": (w,),
            "w_out": (w, d)}


_C_RGLRU = 8.0


def _dense(w, dtype):
    """A weight as a tensor in ``dtype``: a decode-at-use view decodes the
    whole leaf (``ProtectedWeight.astype``, the ``ecc_decode`` kernel on
    the card), a tensor is cast. The RG-LRU's two gate matmuls take their
    weights so, as the reference's ``wt(w).astype(x.dtype)`` does."""
    if getattr(w, "decode_at_use", False):
        return w.astype(dtype)
    return w.to(dtype)


def _rglru_coeffs(x_in, i_gate, a_gate, a_param):
    """The recurrence's f32 coefficients: ``a = exp(-8 softplus(a_param)
    sigmoid(a_gate))`` and ``b = sqrt(max(1 - a^2, 1e-12)) (i_gate *
    x_in)``."""
    log_a = -_C_RGLRU * F.softplus(a_param) * torch.sigmoid(a_gate)
    a = torch.exp(log_a.to(torch.float32))
    gated = (i_gate * x_in).to(torch.float32)
    return a, torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * gated


def _linear_scan(a, b):
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` over axis 1, as a
    log-depth doubling scan: for d = 1, 2, 4, ... each step composes
    position t with t - d (``a_t a_{t-d}``, ``a_t b_{t-d} + b_t``), so an
    L-step recurrence takes ceil(log2 L) whole-tensor passes, not L small
    ones; multiplying the a's never underflows to a wrong value the way a
    cumulative sum of ``log a`` exponentiated would. It sums in another
    order than the reference's ``associative_scan``."""
    d, n = 1, a.shape[1]
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rglru_scan(x_in, i_gate, a_gate, a_param):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t) over L, in f32,
    returned in x_in's dtype."""
    a, b = _rglru_coeffs(x_in, i_gate, a_gate, a_param)
    return _linear_scan(a, b).to(x_in.dtype)


def rglru_block(p, x, cfg, wt=Identity):
    """The recurrent block over a full sequence (training, the cache-less
    forward). x: (B, S, D)."""
    xw = _proj(x, p["w_x"], None, wt)
    xw = F.silu(_causal_conv(xw, p["conv_w"]))
    i_gate = torch.sigmoid(xw @ _dense(wt(p["w_input_gate"]), xw.dtype))
    a_gate = xw @ _dense(wt(p["w_a_gate"]), xw.dtype)
    h = _rglru_scan(xw, i_gate, a_gate, p["a_param"])
    y_gate = F.gelu(_proj(x, p["w_y_gate"], None, wt), approximate="tanh")
    return _proj(h * y_gate, p["w_out"], None, wt)


def rglru_decode(p, x, cfg, cache):
    """One step of the recurrence. x: (B, 1, D); cache: {"h": (B, w),
    "conv": (B, K-1, w)} — this layer's slice, written IN PLACE: ``h`` is
    rounded to x's dtype every step (then stored in the cache's), as in
    the reference. Returns (out (B, 1, D), cache). Profiler ranges:
    ``rglru`` (the step's PyTorch ops), within it ``rglru_gates`` (the two
    gate weights' dequantization and matmuls)."""
    with torch.profiler.record_function("rglru"):
        xw = _proj(x[:, 0], p["w_x"])                   # (B, w)
        hist = torch.cat([cache["conv"], xw[:, None]], dim=1)
        xw = F.silu(torch.einsum("bkc,kc->bc", hist,
                                 p["conv_w"].to(hist.dtype)))
        with torch.profiler.record_function("rglru_gates"):
            i_gate = torch.sigmoid(xw @ _dense(p["w_input_gate"], xw.dtype))
            a_gate = xw @ _dense(p["w_a_gate"], xw.dtype)
        a, b = _rglru_coeffs(xw, i_gate, a_gate, p["a_param"])
        h = (cache["h"].to(torch.float32) * a + b).to(x.dtype)
        y_gate = F.gelu(_proj(x[:, 0], p["w_y_gate"]), approximate="tanh")
        out = _proj(h * y_gate, p["w_out"])[:, None]
        local.assign(cache["h"], h)
        local.assign(cache["conv"], hist[:, 1:])
    return out, cache


# --------------------------------------------------------------------------
# Mamba2 (SSD) mixer (the ssm family)
# --------------------------------------------------------------------------


def mamba2_params_shape(cfg):
    d, di, n, hd = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = di // hd
    return {
        "w_in": (d, 2 * di + 2 * n + h),   # [x, z, B, C, dt]
        "conv_w": (cfg.ssm_conv_width, di + 2 * n),
        "A_log": (h,), "D": (h,), "dt_bias": (h,),
        "w_out": (di, d),
    }


def _ssd_chunked(x, dt, A, B, C, chunk):
    """The SSD chunked scan. x: (b, l, h, p); dt: (b, l, h) f32; A: (h,)
    f32; B, C: (b, l, n). Returns y (b, l, h, p) in x's dtype and the
    final state (b, h, p, n).

    The reference's 4-operand einsums, written pairwise so that no
    intermediate has more than five dimensions (a (b, c, q, s, h, p) one
    would take 10.7 GB in bf16 at 2 x 4,096 tokens of mamba2-2.7b): the
    elementwise factors fold first, then one batched matmul contracts over
    s (or n). The casts are the reference's: ``cum`` stays f32; the
    decays, ``cb`` and ``dt`` are cast to x's dtype before the products.
    The causal mask goes before the ``exp`` (the non-causal entries are
    positive and would overflow). The scan across chunks is a loop over
    them that rounds the carried state to x's dtype every chunk, as the
    reference's ``lax.scan`` does."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"the SSD chunked scan needs a length that is a "
                         f"multiple of its chunk: length {l}, chunk {chunk} "
                         f"(the reference reshapes by l // chunk)")
    nc, dtype = l // chunk, x.dtype
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    dtx = dtc.to(dtype)

    cum = torch.cumsum(dtc * A, dim=2)                     # (b,c,q,h) f32
    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,c,q,s,h)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill_(~causal, -torch.inf)).to(dtype)
    del seg
    cb = (Cc @ Bc.transpose(-1, -2)).to(dtype)             # (b,c,q,s)
    # out of place: in f32 ``decay`` is exp's own output, which exp's
    # backward reads
    m = decay * cb[..., None]                              # (b,c,q,s,h)
    del decay
    xdt = xc * dtx[..., None]                              # (b,c,s,h,p)
    y = m.permute(0, 1, 4, 2, 3) @ xdt.permute(0, 1, 3, 2, 4)  # (b,c,h,q,p)
    del m
    y = y.permute(0, 1, 3, 2, 4)                           # (b,c,q,h,p)

    # chunk states: S_c = sum_s exp(cum_last - cum_s) dt_s B_s x_s^T
    last = cum[:, :, -1:, :]                               # (b,c,1,h)
    dec_s = torch.exp(last - cum).to(dtype)                # (b,c,s,h)
    xw = (xc * (dec_s * dtx)[..., None]).permute(0, 1, 3, 4, 2)  # (b,c,h,p,s)
    S = (xw.reshape(b, nc, h * p, chunk) @ Bc).reshape(b, nc, h, p, n)
    del xw, xdt
    chunk_decay = torch.exp(last[:, :, 0, :])              # (b,c,h) f32

    s_prev = torch.zeros((b, h, p, n), dtype=dtype, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None].to(dtype) + S[:, c]
    s_prevs = torch.stack(prevs, dim=1)                    # (b,c,h,p,n)

    # inter-chunk: y[t] = C_t . exp(cum_t) S_prev
    dec_q = torch.exp(cum).to(dtype)                       # (b,c,q,h)
    cs = Cc @ s_prevs.reshape(b, nc, h * p, n).transpose(-1, -2)  # (b,c,q,hp)
    y_inter = cs.reshape(b, nc, chunk, h, p) * dec_q[..., None]
    return (y + y_inter).reshape(b, l, h, p), s_prev


def _mamba2_in(p, zxbcdt, cfg):
    """The fused projection's output split into the conv input [x, B, C],
    z and dt (the reference's order [x, z, B, C, dt]); ``dt`` is
    ``softplus(dt + dt_bias)`` in f32 and ``A = -exp(A_log)``."""
    di, n = cfg.d_inner, cfg.ssm_state
    xi, z, B, C, dt = torch.split(zxbcdt, [di, di, n, n, cfg.ssm_heads], -1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    return torch.cat([xi, B, C], dim=-1), z, dt, A


def mamba2_block(p, x, cfg, wt=Identity):
    """The mixer over a full sequence (training, the cache-less forward).
    x: (B, S, D). ``conv_w`` goes through :func:`_dense`, as the RG-LRU's
    gates do. Profiler range: ``ssd`` (the chunked scan)."""
    b, s, _ = x.shape
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    conv_in, z, dt, A = _mamba2_in(p, _proj(x, p["w_in"], None, wt), cfg)
    conv_out = F.silu(_causal_conv(conv_in, _dense(p["conv_w"], x.dtype)))
    xi, B, C = torch.split(conv_out, [di, n, n], dim=-1)
    xh = heads(xi, b, s, h, hd)
    with torch.profiler.record_function("ssd"):
        y, _ = _ssd_chunked(xh, dt, A, B, C, min(cfg.ssm_chunk, s))
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di) * F.silu(z)
    return _proj(y, p["w_out"], None, wt)


def mamba2_decode(p, x, cfg, cache):
    """One step of the SSD recurrence. x: (B, 1, D); cache: {"state": (B,
    h, hd, n), "conv": (B, K-1, di+2n)} — this layer's slice, written IN
    PLACE: the state is ``state * exp(dt A) + dt x B^T`` in x's dtype,
    rounded to it every step (then stored in the cache's), and ``y = state
    C`` reads the updated state, as in the reference. Returns (out (B, 1,
    D), cache). Profiler range: ``mamba2`` (the step's PyTorch ops)."""
    b = x.shape[0]
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    with torch.profiler.record_function("mamba2"):
        conv_in, z, dt, A = _mamba2_in(p, _proj(x[:, 0], p["w_in"]), cfg)
        hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)  # (B,K,c)
        conv_out = F.silu(torch.einsum("bkc,kc->bc", hist,
                                       _dense(p["conv_w"], hist.dtype)))
        xi, B, C = torch.split(conv_out, [di, n, n], dim=-1)
        da = torch.exp(dt * A)                             # (B, h) f32
        xh = xi.reshape(b, h, hd)
        upd = (dt.to(x.dtype)[:, :, None] * xh)[..., None] * B[:, None, None]
        state = cache["state"] * da[:, :, None, None].to(x.dtype) + upd
        y = (state.reshape(b, h * hd, n) @ C[:, :, None]).reshape(b, h, hd)
        y = y + xh * p["D"].to(x.dtype)[None, :, None]
        y = y.reshape(b, di) * F.silu(z)
        out = _proj(y, p["w_out"])[:, None]
        local.assign(cache["state"], state)
        local.assign(cache["conv"], hist[:, 1:])
    return out, cache


# --------------------------------------------------------------------------
# MLPs, embedding, logits
# --------------------------------------------------------------------------


def swiglu_params_shape(cfg, d_ff=None):
    f = d_ff or cfg.d_ff
    d = cfg.d_model
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def swiglu(p, x, wt=Identity):
    g = F.silu(_proj(x, p["w_gate"], None, wt))
    return _proj(g * _proj(x, p["w_up"], None, wt), p["w_down"], None, wt)


# --------------------------------------------------------------------------
# MoE: capacity-based gather dispatch per batch row
# --------------------------------------------------------------------------


def moe_params_shape(cfg):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": (d, e),
         "we_gate": (e, d, f), "we_up": (e, d, f), "we_down": (e, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p.update({"ws_gate": (d, fs), "ws_up": (d, fs), "ws_down": (fs, d)})
    return p


def moe_capacity(cfg, n_tokens: int) -> int:
    """Slots per expert in one routing group of ``n_tokens``: ``ceil(n k /
    E * capacity_factor)`` rounded up to a multiple of 8, at least 8."""
    c = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts *
                    cfg.capacity_factor))
    return max(8, (c + 7) // 8 * 8)


def top_k_lower_first(x, k: int):
    """The ``k`` largest entries along the last axis, largest first, the
    lower index first among equal values (``jax.lax.top_k``'s rule;
    ``torch.topk`` breaks ties in no stated order): a stable descending
    sort, cut to ``k``. -> (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def queue_positions(eid, n_experts: int) -> tuple:
    """Each (token, k) pair's place in its expert's queue, per routing
    group. eid: (g, nk) expert ids in (token, k) order. The queues are a
    stable sort by expert id, so a queue keeps (token, k) order. ->
    (order (g, nk): the sort; starts, counts (g, E): each queue's first
    sorted index and length; pos (g, nk): each pair's place, 0-based). A
    pair is kept iff its place is below the capacity."""
    g, nk = eid.shape
    dev = eid.device
    order = torch.argsort(eid, dim=1, stable=True)
    sorted_eid = eid.gather(1, order)
    experts = torch.arange(n_experts, device=dev).expand(g, n_experts)
    starts = torch.searchsorted(sorted_eid, experts.contiguous(),
                                side="left")
    counts = torch.diff(starts, dim=1,
                        append=torch.full((g, 1), nk, device=dev))
    pos_sorted = torch.arange(nk, device=dev)[None, :] - \
        starts.gather(1, sorted_eid)
    pos = torch.zeros_like(pos_sorted).scatter_(1, order, pos_sorted)
    return order, starts, counts, pos


def _expert_ffn(xe, p, wt):
    """The routed experts' SwiGLU over their capacity slots. xe: (E, N,
    D), expert-major: three batched matmuls against the whole (E, D, F)
    and (E, F, D) leaves, each decoded whole (``_dense``), as the
    reference's einsums take ``wt(leaf).astype(x.dtype)``."""
    g = F.silu(torch.bmm(xe, _dense(wt(p["we_gate"]), xe.dtype)))
    u = torch.bmm(xe, _dense(wt(p["we_up"]), xe.dtype))
    return torch.bmm(g * u, _dense(wt(p["we_down"]), xe.dtype))


def moe(p, x, cfg, wt=Identity):
    """x: (B, S, D) -> (B, S, D). The reference's grouped dispatch: each
    batch row is a routing group with ``moe_capacity(cfg, S)`` slots per
    expert. The router's logits are taken in x's dtype, its softmax in
    f32; the top ``k`` gates by :func:`top_k_lower_first`, renormalized and
    cast to x's dtype. The (token, k) pairs queue at their expert in a
    stable sort by expert id; a pair whose place in its queue is past
    the capacity is dropped (its share of the output rides the residual).
    Dispatch and combine are gathers; the experts' SwiGLU runs over every
    (expert, slot), empty slots zero. Shared experts (a SwiGLU of
    ``n_shared_experts * moe_d_ff``) add to every token. Profiler ranges:
    ``moe_router`` (the router's decode, logits, top-k and queue
    positions) and ``moe_experts`` (the dispatch, the three expert leaves'
    decodes and products, the combine)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, s)
    nk = s * k
    dev = x.device
    with torch.profiler.record_function("moe_router"):
        logits = (x @ _dense(wt(p["router"]), x.dtype)).to(torch.float32)
        gates = torch.softmax(logits, dim=-1)                 # (g, s, e)
        topw, topi = top_k_lower_first(gates, k)              # (g, s, k)
        topw = (topw / topw.sum(dim=-1, keepdim=True)).to(x.dtype)
        eid = topi.reshape(b, nk)
        if local.is_dtensor(eid):   # each rank queues its own groups
            order, starts, counts, pos = local.per_row(
                lambda t: queue_positions(t, e), eid)
        else:
            order, starts, counts, pos = queue_positions(eid, e)
    with torch.profiler.record_function("moe_experts"):
        # the capacity grid: slot (e, c) <- sorted index starts[e] + c
        c_idx = torch.arange(cap, device=dev)
        grid_j = (starts[:, :, None] + c_idx).clamp(0, nk - 1).reshape(
            b, e * cap)
        grid_valid = (c_idx < counts[:, :, None]).reshape(b, e * cap)
        tok_sorted = (torch.arange(nk, device=dev) // k).expand(
            b, nk).gather(1, order)                           # token of j
        src_tok = tok_sorted.gather(1, grid_j)                # (g, e*cap)
        xe = x.gather(1, src_tok[..., None].expand(b, e * cap, d))
        xe = torch.where(grid_valid[..., None], xe, 0)
        xe = constrain(xe.reshape(b, e, cap, d), ctx_dp(), "model", None,
                       None)                              # EP all-to-all
        # expert-major for the batched products: (e, g*cap, d)
        xe = xe.transpose(0, 1).reshape(e, b * cap, d)
        ye = _expert_ffn(xe, p, wt)
        ye = constrain(ye.reshape(e, b, cap, d).transpose(0, 1), ctx_dp(),
                       "model", None, None)
        yflat = ye.reshape(b, e * cap, d)
        # each (token, k) pair's slot, for the combine gather
        keep = pos < cap
        slot = torch.where(keep, eid * cap + pos, 0)
        token_y = yflat.gather(1, slot[..., None].expand(b, nk, d))
        token_y = torch.where(keep[..., None], token_y, 0)
        y = (token_y.reshape(b, s, k, d) * topw[..., None]).sum(dim=2)
    if cfg.n_shared_experts:
        y = y + swiglu({"w_gate": p["ws_gate"], "w_up": p["ws_up"],
                        "w_down": p["ws_down"]}, x, wt)
    return y


def gelu_mlp_params_shape(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": (d, f), "b_up": (f,), "w_down": (f, d), "b_down": (d,)}


def gelu_mlp(p, x, wt=Identity):
    """The biased GELU MLP. The tanh form of GELU: the reference's
    ``jax.nn.gelu`` defaults to it (torch's default is the erf form)."""
    h = F.gelu(_proj(x, p["w_up"], p["b_up"], wt), approximate="tanh")
    return _proj(h, p["w_down"], p["b_down"], wt)


def embed(tokens, emb, dtype=torch.bfloat16):
    if local.is_dtensor(emb) or local.is_dtensor(tokens):
        return local.embed(emb, tokens, dtype)
    return emb.to(dtype)[tokens]


def logits(x, head, wt=Identity):
    """x @ head: a decode-at-use view (``ecc_qmatmul`` on the kernel
    route), or a plain tensor — a tied head, the decoded embedding
    transposed — through ``torch.matmul``, as the reference multiplies it
    outside any kernel."""
    return _proj(x, wt(head))

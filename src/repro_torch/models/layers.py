"""Model building blocks of the dense decoder (pure functions over dicts).

Counterpart of the dense subset of ``repro.models.layers``: norms, RoPE,
single-token GQA attention, full-sequence GQA attention (training and
the cache-less forward), chunked causal attention, SwiGLU, embedding and
logits. ``wt`` is the weight transform of QAT training (fake-quant): it
applies to projection weights and the head only, never to the embedding
lookup or to norms, and defaults to the identity so the serve paths are
untouched. Where the reference routes fault flags, ABFT counts and
calibration absmaxes through module-level sinks (``layers.record_flags``,
``record_abft``, ``record_act``), the port hands each decode-at-use view
the methods of a :class:`FlagRecorder` that the serve step creates per
step and the model drains per layer, so they come back as values.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def Identity(w):
    return w


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


def apply_norm(x, p, kind):
    if kind != "rms":
        raise NotImplementedError(f"norm {kind!r} is not ported yet (rms only)")
    return rms_norm(x, p["w"])


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
    when windowed), as the reference's triangle path does.
    """
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
    """q: (B,H,1,D); caches: (B,H,Skv,D). Full-cache single-token attention."""
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


def _proj(x, w, b=None, wt=Identity):
    w = wt(w)
    if getattr(w, "decode_at_use", False):
        y = w.matmul(x)  # decode-at-use view: fused kernel or inline decode
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
    flash kernel; no window)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _proj(x, p["wq"], p.get("bq"), wt).reshape(b, s, h, hd)
    k = _proj(x, p["wk"], p.get("bk"), wt).reshape(b, s, kv, hd)
    v = _proj(x, p["wv"], p.get("bv"), wt).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    rep = h // kv    # GQA broadcast kv -> h
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if causal and attention == "cuda":
        if window:
            raise NotImplementedError("the flash kernel has no sliding "
                                      "window")
        from repro_torch.kernels import flash_attention
        o = flash_attention.flash_attention(q, k, v)
    elif causal:
        o = chunked_causal_attention(q, k, v, chunk=chunk, window=window)
    else:  # bidirectional (an encoder)
        o, _, l = _attend_chunk(q, k, v, None, 1.0 / np.sqrt(hd))
        o = o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return _proj(o, p["wo"], None, wt)


def gqa_decode(p, x, cfg, cache, *, pos):
    """Single-token decode over a dense cache. x: (B,1,D); cache: {"k","v":
    (B, Smax, kv, hd)} — this layer's slice, written IN PLACE (the port
    updates the cache where the reference returns a new one).
    Returns (out, cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(b, 1, h, hd)
    k = _proj(x, p["wk"], p.get("bk")).reshape(b, 1, kv, hd)
    v = _proj(x, p["wv"], p.get("bv")).reshape(b, 1, kv, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    smax = cache["k"].shape[1]
    rep = h // kv
    kh = cache["k"].repeat_interleave(rep, dim=2).transpose(1, 2)  # (B,H,S,hd)
    vh = cache["v"].repeat_interleave(rep, dim=2).transpose(1, 2)
    valid = torch.arange(smax, device=x.device)[None, :] <= pos[:, None]
    o = decode_attention(q.transpose(1, 2), kh, vh, valid)
    o = o.transpose(1, 2).reshape(b, 1, h * hd)
    return _proj(o, p["wo"]), cache


# --------------------------------------------------------------------------
# MLP, embedding, logits
# --------------------------------------------------------------------------


def swiglu_params_shape(cfg, d_ff=None):
    f = d_ff or cfg.d_ff
    d = cfg.d_model
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def swiglu(p, x, wt=Identity):
    g = F.silu(_proj(x, p["w_gate"], None, wt))
    return _proj(g * _proj(x, p["w_up"], None, wt), p["w_down"], None, wt)


def embed(tokens, emb, dtype=torch.bfloat16):
    return emb.to(dtype)[tokens]


def logits(x, head, wt=Identity):
    return _proj(x, wt(head))

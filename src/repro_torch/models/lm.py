"""Decoder LM of the dense and vlm families: parameter init, the
cache-less full-sequence forward and its loss (training), KV cache, the
decode step and the prefill into a paged KV cache.

Counterpart of the dense and vlm families of ``repro.models.lm``. The vlm
family (PaliGemma's backbone) is the dense decoder with the Gemma input
scale ``sqrt(d_model)``, tied embeddings (the head is ``embed.T``) and,
in ``forward`` and ``loss_fn`` only, precomputed image-patch embeddings
prepended to the tokens. Per-layer params are stacked along a leading L
axis, as in the reference; a Python loop over layers takes the place of
``lax.scan``. Other families (MoE, MLA, SSM, hybrid, enc-dec) are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch import tree

from . import layers as L
from .config import ArchConfig

FAMILIES = ("dense", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(one of {FAMILIES})")


def _norm_shape(cfg):
    return {"w": (cfg.d_model,)}


def _layer_shapes(cfg: ArchConfig) -> dict:
    """Per-layer (pre-stacking) param shapes of the scanned decoder block."""
    _check_family(cfg)
    return {"attn": L.gqa_params_shape(cfg), "mlp": L.swiglu_params_shape(cfg),
            "ln1": _norm_shape(cfg), "ln2": _norm_shape(cfg)}


def n_scan_layers(cfg: ArchConfig) -> int:
    return cfg.n_layers


def _init_kind(name: str, shp: tuple):
    """The reference's per-name init: norm weights one, biases zero, the
    rest normal with std 0.02 (vectors) or 1/sqrt(fan_in) (matrices)."""
    if name == "w":
        return "ones", None
    if name == "b" or name.startswith("b_"):
        return "zeros", None
    return "normal", (0.02 if len(shp) < 2 else 1.0 / np.sqrt(shp[-2]))


def _leaf_specs(cfg: ArchConfig):
    """Yield ``(path, full shape, (kind, std))`` for every leaf, in the
    order :func:`init_params` draws them."""
    v, d = cfg.vocab_padded, cfg.d_model
    yield ("embed",), (v, d), ("normal", 0.02)
    for name, shp in sorted(_norm_shape(cfg).items()):
        yield ("final_norm", name), shp, _init_kind(name, shp)
    if not cfg.tie_embeddings:   # tied: the head is embed.T, no leaf
        yield ("head",), (d, v), ("normal", 1.0 / np.sqrt(d))
    nl = n_scan_layers(cfg)
    for sub, shapes in sorted(_layer_shapes(cfg).items()):
        for name, shp in sorted(shapes.items()):
            yield ("layers", sub, name), (nl, *shp), _init_kind(name, shp)


def param_shapes(cfg: ArchConfig) -> dict:
    """The f32 parameter tree as ``ShapeDtype`` records (nothing
    allocated)."""
    from repro_torch.protection.plan import ShapeDtype
    out: dict = {}
    for path, shape, _ in _leaf_specs(cfg):
        tree.set_path(out, path, ShapeDtype(tuple(shape), torch.float32))
    return out


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                leaf_fn=None) -> dict:
    """Random f32 parameters with the reference's shapes and distributions,
    drawn leaf by leaf from one ``torch.Generator`` on ``device`` (default
    ``"cuda"``). ``leaf_fn(path, tensor)``, when given, replaces each leaf
    right after it is drawn — e.g. ``plan.encode_leaf`` — so a model that
    does not fit twice in memory is built and encoded one leaf at a time.
    """
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: dict = {}
    for path, shape, (kind, std) in _leaf_specs(cfg):
        if kind == "ones":
            t = torch.ones(shape, device=dev)
        elif kind == "zeros":
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev).mul_(std)
        tree.set_path(out, path,
                      leaf_fn(path, t) if leaf_fn is not None else t)
        del t
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """Dense KV cache ``{"k", "v": (L, B, max_len, kv, hd)}``."""
    dev = device_mod.resolve(device)
    _check_family(cfg)
    shape = (n_scan_layers(cfg), batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _embed_in(cfg: ArchConfig, tokens, emb, dtype, prefix_embeds=None):
    """The token embeddings, after the vlm's image-patch prefix when one is
    given; the vlm scales the whole sequence by ``sqrt(d_model)`` rounded
    to the activation dtype first (Gemma's convention: 45.25 in bf16 at
    d_model 2048), as the reference does."""
    x = L.embed(tokens, emb, dtype)
    if cfg.family == "vlm":
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype,
                             device=x.device)
    return x


def _head(cfg: ArchConfig, params):
    """The output head: the embedding transposed when tied."""
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _take(i: int, tree):
    """Layer ``i`` of a stacked subtree: tensors index their leading axis,
    leaves with a ``layer`` method (``ProtectedTensor``) slice themselves."""
    if isinstance(tree, dict):
        return {k: _take(i, v) for k, v in tree.items()}
    layer = getattr(tree, "layer", None)
    return layer(i) if layer is not None else tree[i]


def _unstack(sub, n: int) -> list:
    """A stacked subtree -> its ``n`` per-layer subtrees. Tensors are
    unbound once (their backward stacks the layer gradients in one
    allocation, where indexing per layer would allocate a full-size zero
    gradient per layer); other leaves slice themselves as in :func:`_take`."""
    if isinstance(sub, dict):
        per = {k: _unstack(v, n) for k, v in sub.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    if isinstance(sub, torch.Tensor):
        return list(sub.unbind(0))
    return [_take(i, sub) for i in range(n)]


def _block_full(cfg: ArchConfig, lp, x, positions, wt, chunk,
                attention="torch"):
    """One dense decoder block over a full sequence."""
    nk = cfg.norm
    x = x + L.gqa_attention(lp["attn"], L.apply_norm(x, lp["ln1"], nk), cfg,
                            positions=positions, wt=wt, chunk=chunk,
                            attention=attention)
    return x + L.swiglu(lp["mlp"], L.apply_norm(x, lp["ln2"], nk), wt)


def forward(cfg: ArchConfig, params, tokens, *, wt=L.Identity,
            dtype=torch.bfloat16, chunk: int = 2048, layer_transform=None,
            collect_flags=False, collect_acts=False, recorder=None,
            attention="torch", prefix_embeds=None, enc_embeds=None):
    """tokens: (B, S) int -> logits (B, S', V). For the vlm family
    ``prefix_embeds`` (B, P, D), precomputed image-patch embeddings, is
    prepended (S' = P + S); other families take none. ``wt`` transforms
    each projection weight and the head at use (a tied head is the
    transposed embedding; the lookup reads the raw one) (QAT's fake-quant;
    per layer slice, as the reference's scan applies it);
    ``layer_transform`` maps
    each layer's param slice. With ``cfg.remat`` each layer is recomputed
    in the backward pass (``torch.utils.checkpoint``) instead of keeping
    its activations. ``attention`` routes the causal attention: "torch"
    (``layers.chunked_causal_attention``) or "cuda" (the flash kernel).

    ``collect_flags`` / ``collect_acts`` drain the ``recorder``
    (:class:`layers.FlagRecorder`) once per layer, as the reference drains
    its sinks per scanned layer, and return ``(logits, flags)``,
    ``(logits, acts)`` or ``(logits, flags, acts)``: ``flags["layers"]``
    (L, 2) per-layer (corrected, due), plus ``flags["layers_abft"]`` (L, 2)
    (mismatches, clamp hits) when the recorder's ABFT channel is on;
    ``acts["layers"]`` ``{leaf path: (L,) f32 absmax}``. The output head
    records after the layers and stays in the recorder for the caller."""
    _check_family(cfg)
    if (collect_flags or collect_acts) and recorder is None:
        raise ValueError("collect_flags / collect_acts drain a recorder: "
                         "pass layers.FlagRecorder")
    if prefix_embeds is not None and cfg.family != "vlm":
        raise ValueError(f"prefix_embeds feed the vlm family, not "
                         f"{cfg.family!r}")
    if enc_embeds is not None:
        raise NotImplementedError("encoder embeddings come with the enc-dec "
                                  "family")
    x = _embed_in(cfg, tokens, params["embed"], dtype, prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)

    def blk(x, lp):
        if layer_transform is not None:
            lp = layer_transform(lp)
        return _block_full(cfg, lp, x, positions, wt, chunk, attention)

    layer_flags, layer_abft, layer_acts = [], [], []
    for lp in _unstack(params["layers"], n_scan_layers(cfg)):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, lp, use_reentrant=False)
        else:
            x = blk(x, lp)
        if collect_flags:
            _drain_layer(recorder, layer_flags, layer_abft)
        if collect_acts:
            layer_acts.append(recorder.drain_acts())
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    out = L.logits(x, _head(cfg, params), wt)
    if not (collect_flags or collect_acts):
        return out
    extra = ()
    if collect_flags:
        extra += (_layer_rows(layer_flags, layer_abft),)
    if collect_acts:
        extra += ({"layers": {p: torch.stack([d[p] for d in layer_acts])
                              for p in layer_acts[0]}},)
    return (out, *extra)


def loss_fn(cfg: ArchConfig, params, batch, *, wt=L.Identity,
            dtype=torch.bfloat16, chunk: int = 2048):
    """Causal-LM cross entropy: mean of the f32 ``logsumexp`` minus the
    target logit. batch: {"tokens", "targets"} (B, S) int, and for the vlm
    family optionally ``"prefix_embeds"`` (B, P, D): the loss then covers
    the text positions only, the last S."""
    targets = batch["targets"]
    logits = forward(cfg, params, batch["tokens"], wt=wt, dtype=dtype,
                     chunk=chunk, prefix_embeds=batch.get("prefix_embeds"))
    if cfg.family == "vlm":
        logits = logits[:, -targets.shape[1]:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, *,
                dtype=torch.bfloat16, layer_transform=None, recorder=None,
                kv_policy=None):
    """One decode step. tokens: (B,1) int; pos: (B,) int.

    Returns ``(logits (B,1,V), cache)``; the cache is updated in place. With
    a ``recorder`` (:class:`layers.FlagRecorder`) it also returns a flags
    dict: ``"layers"`` (L, 2) int32 per-layer (corrected, due) drained from
    the recorder after each layer, ``"layers_abft"`` (L, 2) (checksum
    mismatches, clamp hits) when the recorder's ABFT channel is on, and —
    for a paged protected KV cache (marked by its ``"k_pages"`` pools,
    served under ``kv_policy``) — ``"layers_kv"`` (L, 2) KV counts. The
    output head's counts stay in the recorder for the caller to drain.
    """
    _check_family(cfg)
    x = _embed_in(cfg, tokens, params["embed"], dtype)
    paged = "k_pages" in cache
    if paged:
        from repro_torch.serving import kvcache
        kvp = kvcache.get_kv_policy(kv_policy)
        if kvp is None:
            raise ValueError("cache is paged (k_pages present) but no "
                             "kv_policy was passed to decode_step")
    layer_flags, kv_flags, abft_flags = [], [], []
    for i in range(n_scan_layers(cfg)):
        lp = _take(i, params["layers"])
        if layer_transform is not None:
            lp = layer_transform(lp)
        lc = {k: v[i] for k, v in cache.items()}
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        if paged:
            o, _, kvf = kvcache.paged_gqa_decode(lp["attn"], h, cfg, lc,
                                                 pos=pos, policy=kvp)
            kv_flags.append(kvf)
        else:
            o, _ = L.gqa_decode(lp["attn"], h, cfg, lc, pos=pos)
        x = x + o
        x = x + L.swiglu(lp["mlp"], L.apply_norm(x, lp["ln2"], cfg.norm))
        _drain_layer(recorder, layer_flags, abft_flags)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    logits = L.logits(x, _head(cfg, params))
    if recorder is None:
        return logits, cache
    flags = _layer_rows(layer_flags, abft_flags)
    if paged:
        flags["layers_kv"] = torch.stack(kv_flags)
    return logits, cache, flags


def _drain_layer(recorder, layer_flags: list, abft_flags: list) -> None:
    """Drain one layer's (corrected, due) and, with the ABFT channel on,
    its (mismatches, clamp hits) from ``recorder``."""
    if recorder is None:
        return
    layer_flags.append(recorder.drain())
    if recorder.abft:
        abft_flags.append(recorder.drain_abft())


def _layer_rows(layer_flags: list, abft_flags: list) -> dict:
    flags = {"layers": torch.stack(layer_flags)}
    if abft_flags:
        flags["layers_abft"] = torch.stack(abft_flags)
    return flags


def prefill_with_cache(cfg: ArchConfig, params, cache, tokens, *,
                       dtype=torch.bfloat16, chunk: int = 2048,
                       layer_transform=None, recorder=None, kv_policy=None):
    """Full-sequence prefill that fills a paged protected KV cache.

    tokens: (B, S) int; ``cache`` from ``serving.kvcache.init_paged_cache``
    with room for S tokens. Every layer's K/V is encoded into its pages
    (in place) and the attention runs over the decoded pages, so the logits
    reflect exactly the state later :func:`decode_step` calls read. Returns
    ``(logits (B, S, V), cache)``; with a ``recorder`` also a flags dict
    with ``"layers"`` (weight) and ``"layers_kv"`` (KV) per-layer
    (corrected, due) rows and, with the recorder's ABFT channel on,
    ``"layers_abft"``, as :func:`decode_step` returns them.
    """
    from repro_torch.serving import kvcache
    if "k_pages" not in cache:
        raise ValueError("prefill_with_cache expects a paged cache "
                         "(serving.kvcache.init_paged_cache)")
    kvp = kvcache.get_kv_policy(kv_policy)
    if kvp is None:
        raise ValueError("kv_policy is required for a paged cache")
    if not kvcache.supports_paged(cfg):
        raise NotImplementedError(f"paged prefill for family {cfg.family!r} "
                                  f"is not ported yet")
    x = _embed_in(cfg, tokens, params["embed"], dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    layer_flags, kv_flags, abft_flags = [], [], []
    for i in range(n_scan_layers(cfg)):
        lp = _take(i, params["layers"])
        if layer_transform is not None:
            lp = layer_transform(lp)
        lc = {k: v[i] for k, v in cache.items()}
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        o, _, kvf = kvcache.paged_gqa_prefill(lp["attn"], h, cfg, lc,
                                              positions=positions, policy=kvp,
                                              chunk=chunk)
        x = x + o
        x = x + L.swiglu(lp["mlp"], L.apply_norm(x, lp["ln2"], cfg.norm))
        kv_flags.append(kvf)
        _drain_layer(recorder, layer_flags, abft_flags)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    logits = L.logits(x, _head(cfg, params))
    if recorder is None:
        return logits, cache
    return logits, cache, {**_layer_rows(layer_flags, abft_flags),
                           "layers_kv": torch.stack(kv_flags)}

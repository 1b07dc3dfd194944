"""LM of every family (dense, vlm, encdec, hybrid, ssm, moe): parameter init,
the cache-less full-sequence forward and its loss (training), KV cache,
the decode step and the prefill into a paged KV cache.

Counterpart of ``repro.models.lm``.
The vlm family (PaliGemma's backbone) is the dense decoder with the Gemma
input scale ``sqrt(d_model)``, tied embeddings (the head is ``embed.T``)
and, in ``forward`` and ``loss_fn`` only, precomputed image-patch
embeddings prepended to the tokens. The encdec family (Whisper's
backbone) has layer norms with biases, a bidirectional encoder over
precomputed frame embeddings (``enc_embeds``, in ``forward`` and
``loss_fn``), and decoder blocks of causal self-attention,
cross-attention over the encoder's output and a biased GELU MLP; its
decode step reads the cross-attention K and V from the cache
(``cross_k``, ``cross_v``). The hybrid family (RecurrentGemma) stacks
super-blocks of two RG-LRU sublayers and one local-attention sublayer
(each followed by a SwiGLU MLP) in ``layers``, and the ``n_layers % 3``
RG-LRU layers left over in a second stacked subtree, ``tail``, with its
own flags row; it has the Gemma input scale and a tied head, and its
decode cache holds each RG-LRU's state and conv history and a ring KV
cache of ``attn_window`` slots. The ssm family (Mamba2) stacks one
Mamba2 mixer per layer (an RMS norm before it, no MLP, no attention); its
decode cache is each layer's recurrent state and conv history, and holds
no K or V. The moe family (DeepSeek-V2/V3) has attention (MLA over a
compressed latent cache ``{"latent", "k_rope"}`` where the config sets
``use_mla``, else GQA over the dense or paged KV cache), then a
capacity-based top-k MoE with shared experts, each after its RMS norm.
Per-layer params are stacked along a leading L axis, as in the
reference; a Python loop over layers takes the place of ``lax.scan``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch import tree
from repro_torch.distributed import local

from . import layers as L
from .config import ArchConfig

FAMILIES = ("dense", "vlm", "encdec", "hybrid", "ssm", "moe")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(one of {FAMILIES})")


def _norm_shape(cfg):
    return {"w": (cfg.d_model,)} if cfg.norm == "rms" else \
        {"w": (cfg.d_model,), "b": (cfg.d_model,)}


def _layer_shapes(cfg: ArchConfig) -> dict:
    """Per-layer (pre-stacking) param shapes of the scanned decoder block."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return {"attn": L.gqa_params_shape(cfg),
                "cross": L.cross_params_shape(cfg),
                "mlp": L.gelu_mlp_params_shape(cfg),
                "ln1": _norm_shape(cfg), "ln2": _norm_shape(cfg),
                "ln3": _norm_shape(cfg)}
    if cfg.family == "hybrid":
        # a super-block of 3 layers: [rglru, rglru, local attention]
        blk = {}
        for i in range(2):
            blk.update(_rg_shapes(cfg, f"rg{i}"))
        blk.update({"attn": L.gqa_params_shape(cfg),
                    "attn_mlp": L.swiglu_params_shape(cfg),
                    "attn_ln1": _norm_shape(cfg),
                    "attn_ln2": _norm_shape(cfg)})
        return blk
    if cfg.family == "ssm":
        return {"mixer": L.mamba2_params_shape(cfg), "ln1": _norm_shape(cfg)}
    if cfg.family == "moe":
        return {"attn": L.mla_params_shape(cfg) if cfg.use_mla
                else L.gqa_params_shape(cfg),
                "moe": L.moe_params_shape(cfg),
                "ln1": _norm_shape(cfg), "ln2": _norm_shape(cfg)}
    return {"attn": L.gqa_params_shape(cfg), "mlp": L.swiglu_params_shape(cfg),
            "ln1": _norm_shape(cfg), "ln2": _norm_shape(cfg)}


def _rg_shapes(cfg: ArchConfig, name: str) -> dict:
    """One RG-LRU layer's subtrees: the block, its MLP and their norms."""
    return {name: L.rglru_params_shape(cfg),
            f"{name}_mlp": L.swiglu_params_shape(cfg),
            f"{name}_ln1": _norm_shape(cfg), f"{name}_ln2": _norm_shape(cfg)}


def _enc_layer_shapes(cfg: ArchConfig) -> dict:
    """Per-layer param shapes of the encoder block."""
    return {"attn": L.gqa_params_shape(cfg),
            "mlp": L.gelu_mlp_params_shape(cfg),
            "ln1": _norm_shape(cfg), "ln2": _norm_shape(cfg)}


def n_scan_layers(cfg: ArchConfig) -> int:
    """Stacked layers of ``layers``: the hybrid family's are super-blocks
    of three."""
    if cfg.family == "hybrid":
        return cfg.n_layers // 3
    return cfg.n_layers


def hybrid_tail_layers(cfg: ArchConfig) -> int:
    """The hybrid family's RG-LRU layers after the last super-block (the
    ``tail`` subtree); 0 for other families."""
    if cfg.family != "hybrid":
        return 0
    return cfg.n_layers - 3 * (cfg.n_layers // 3)


def _init_kind(name: str, shp: tuple):
    """The reference's per-name init: Mamba2's ``A_log`` log(linspace(1,
    16, h)) in every layer, ``dt_bias`` 0.5 and ``D`` one, the RG-LRU's
    ``a_param`` 1.3, norm weights one, biases zero, conv kernels normal
    with std 0.1, the rest normal with std 0.02 (vectors) or 1/sqrt(fan_in)
    (matrices)."""
    if name == "A_log":
        return "log_linspace", (1.0, 16.0)
    if name == "dt_bias":
        return "full", 0.5
    if name == "a_param":
        return "full", 1.3
    if name in ("w", "D"):
        return "ones", None
    if name == "b" or name.startswith("b_"):
        return "zeros", None
    if name.startswith("conv"):
        return "normal", 0.1
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
    stacks = [("layers", n_scan_layers(cfg), _layer_shapes(cfg))]
    if hybrid_tail_layers(cfg):
        stacks.append(("tail", hybrid_tail_layers(cfg),
                       _rg_shapes(cfg, "rg0")))
    if cfg.family == "encdec":
        stacks.append(("enc_layers", cfg.enc_layers, _enc_layer_shapes(cfg)))
    for key, nl, subs in stacks:
        for sub, shapes in sorted(subs.items()):
            for name, shp in sorted(shapes.items()):
                yield (key, sub, name), (nl, *shp), _init_kind(name, shp)
    if cfg.family == "encdec":
        for name, shp in sorted(_norm_shape(cfg).items()):
            yield ("enc_final_norm", name), shp, _init_kind(name, shp)


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
    for path, shape, (kind, val) in _leaf_specs(cfg):
        if kind == "ones":
            t = torch.ones(shape, device=dev)
        elif kind == "full":
            t = torch.full(shape, val, device=dev)
        elif kind == "zeros":
            t = torch.zeros(shape, device=dev)
        elif kind == "log_linspace":   # f64, rounded once to f32
            t = torch.log(torch.linspace(*val, shape[-1], dtype=torch.float64,
                                         device=dev)).float()
            t = t.expand(shape).contiguous()
        else:
            t = torch.randn(shape, generator=gen, device=dev).mul_(val)
        tree.set_path(out, path,
                      leaf_fn(path, t) if leaf_fn is not None else t)
        del t
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """Dense KV cache ``{"k", "v": (L, B, max_len, kv, hd)}``; the encdec
    family adds the cross-attention ``{"cross_k", "cross_v": (L, B,
    enc_seq, H, hd)}``, zero until the caller fills them. The hybrid
    family's K and V are a ring of ``attn_window`` slots whatever
    ``max_len`` is, beside each super-block's RG-LRU states ``rg{0,1}_h``
    (L, B, w) and conv histories ``rg{0,1}_conv`` (L, B, K-1, w), and the
    tail's ``tail_h`` and ``tail_conv``. The ssm family's cache is its
    state cache alone, whatever ``max_len`` is: ``{"state": (L, B, h, hd,
    n), "conv": (L, B, K-1, di + 2n)}``, no K or V. The moe family with
    MLA caches the compressed stream: ``{"latent": (L, B, max_len,
    kv_lora_rank), "k_rope": (L, B, max_len, qk_rope_dim)}``. Every state
    is in ``dtype``, as in the reference."""
    dev = device_mod.resolve(device)
    _check_family(cfg)
    nl = n_scan_layers(cfg)
    if cfg.family == "ssm":
        return {"state": torch.zeros((nl, batch, cfg.ssm_heads,
                                      cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=dtype, device=dev),
                "conv": torch.zeros((nl, batch, cfg.ssm_conv_width - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=dtype, device=dev)}
    if cfg.family == "moe" and cfg.use_mla:
        return {"latent": torch.zeros((nl, batch, max_len, cfg.kv_lora_rank),
                                      dtype=dtype, device=dev),
                "k_rope": torch.zeros((nl, batch, max_len, cfg.qk_rope_dim),
                                      dtype=dtype, device=dev)}
    slots = cfg.attn_window if cfg.family == "hybrid" else max_len
    shape = (nl, batch, slots, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.family == "hybrid":
        w = cfg.lru_width or cfg.d_model
        hist = (cfg.ssm_conv_width or 4) - 1
        for name, n in [(f"rg{i}", nl) for i in range(2)] + \
                [("tail", hybrid_tail_layers(cfg))]:
            if n:
                cache[f"{name}_h"] = torch.zeros((n, batch, w), dtype=dtype,
                                                 device=dev)
                cache[f"{name}_conv"] = torch.zeros((n, batch, hist, w),
                                                    dtype=dtype, device=dev)
    if cfg.family == "encdec":
        cross = (nl, batch, cfg.enc_seq, cfg.n_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(cross, dtype=dtype, device=dev)
        cache["cross_v"] = torch.zeros(cross, dtype=dtype, device=dev)
    return cache


def set_sharding_ctx(ctx: dict | None):
    """The launcher's and the dry-run's sharding context (see
    ``layers.set_sharding_ctx``; None: no constraints)."""
    L.set_sharding_ctx(ctx)


def _constrain_residual(x):
    """Sequence-parallel residual stream: (B, S, D) -> P(dp, model, None)."""
    ctx = L.SHARDING_CTX
    if ctx is None:
        return x
    dp, mdl = ctx["dp"], ctx["model"]
    if ctx.get("sp") and x.shape[1] % ctx.get("model_size", 1) == 0:
        return L.constrain(x, dp, mdl, None)
    return L.constrain(x, dp, None, None)


def _embed_in(cfg: ArchConfig, tokens, emb, dtype, prefix_embeds=None):
    """The token embeddings, after the vlm's image-patch prefix when one is
    given; the vlm and hybrid families scale the whole sequence by
    ``sqrt(d_model)`` rounded to the activation dtype first (Gemma's
    convention: 45.25 in bf16 at d_model 2048, 50.5 at 2560), as the
    reference does."""
    x = L.embed(tokens, emb, dtype)
    if cfg.family in ("vlm", "hybrid"):
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


def _scoped_lt(layer_transform, scope: str):
    """``layer_transform`` is one callable (applied to every stacked
    subtree) or a ``{"layers" | "tail" | "enc_layers": fn}`` dict that
    routes each stacked subtree by its own (paths like ``rg0/...`` exist
    in both the hybrid decoder and its tail)."""
    if layer_transform is None or not isinstance(layer_transform, dict):
        return layer_transform
    return layer_transform.get(scope)


def _rg_full(cfg: ArchConfig, lp, x, name: str, wt):
    """One RG-LRU layer over a full sequence: the recurrent block, then
    its MLP, each after its norm."""
    nk = cfg.norm
    x = x + L.rglru_block(lp[name], L.apply_norm(x, lp[f"{name}_ln1"], nk),
                          cfg, wt)
    return x + L.swiglu(lp[f"{name}_mlp"],
                        L.apply_norm(x, lp[f"{name}_ln2"], nk), wt)


def _block_full(cfg: ArchConfig, lp, x, positions, wt, chunk,
                attention="torch", enc_out=None):
    """One decoder block over a full sequence: dense, with cross-attention
    over ``enc_out`` and the GELU MLP (encdec), a hybrid super-block
    (two RG-LRU layers, then local attention over ``attn_window`` keys
    with the chunk cut to the window, as the reference cuts it), one
    Mamba2 mixer (ssm), or attention (MLA or GQA) and the MoE (moe)."""
    nk = cfg.norm
    if cfg.family == "ssm":
        return x + L.mamba2_block(lp["mixer"], L.apply_norm(x, lp["ln1"], nk),
                                  cfg, wt)
    if cfg.family == "moe":
        x = x + gqa_or_mla(cfg, lp["attn"], L.apply_norm(x, lp["ln1"], nk),
                           positions, wt, chunk, attention)
        return x + L.moe(lp["moe"], L.apply_norm(x, lp["ln2"], nk), cfg, wt)
    if cfg.family == "hybrid":
        for i in range(2):
            x = _rg_full(cfg, lp, x, f"rg{i}", wt)
        x = x + L.gqa_attention(
            lp["attn"], L.apply_norm(x, lp["attn_ln1"], nk), cfg,
            positions=positions, wt=wt, window=cfg.attn_window,
            chunk=min(chunk, cfg.attn_window or chunk), attention=attention)
        return x + L.swiglu(lp["attn_mlp"],
                            L.apply_norm(x, lp["attn_ln2"], nk), wt)
    x = x + L.gqa_attention(lp["attn"], L.apply_norm(x, lp["ln1"], nk), cfg,
                            positions=positions, wt=wt, chunk=chunk,
                            attention=attention)
    if cfg.family != "encdec":
        return x + L.swiglu(lp["mlp"], L.apply_norm(x, lp["ln2"], nk), wt)
    kv = L.cross_kv(lp["cross"], enc_out, cfg, wt)
    x = x + L.cross_attention(lp["cross"], L.apply_norm(x, lp["ln2"], nk),
                              kv, cfg, wt)
    return x + L.gelu_mlp(lp["mlp"], L.apply_norm(x, lp["ln3"], nk), wt)


def gqa_or_mla(cfg: ArchConfig, p, x, positions, wt, chunk,
               attention="torch"):
    """Full-sequence attention of a moe block: MLA where the config sets
    ``use_mla``, else GQA."""
    if cfg.use_mla:
        return L.mla_attention(p, x, cfg, positions=positions, wt=wt,
                               chunk=chunk, attention=attention)
    return L.gqa_attention(p, x, cfg, positions=positions, wt=wt,
                           chunk=chunk, attention=attention)


def _enc_block(cfg: ArchConfig, lp, x, positions, wt):
    """One bidirectional encoder block."""
    nk = cfg.norm
    x = x + L.gqa_attention(lp["attn"], L.apply_norm(x, lp["ln1"], nk), cfg,
                            positions=positions, wt=wt, causal=False)
    return x + L.gelu_mlp(lp["mlp"], L.apply_norm(x, lp["ln2"], nk), wt)


def _run_stack(cfg: ArchConfig, block, x, stacked, n: int, *, lt,
               collect_flags, collect_acts, recorder):
    """Run ``block(x, lp)`` over the ``n`` layers of a stacked subtree
    (``lt`` maps each layer's slice; remat as ``forward`` says), draining
    the recorder per layer -> (x, per-layer (corrected, due) rows, ABFT
    rows, acts)."""
    def blk(x, lp):
        if lt is not None:
            lp = lt(lp)
        return block(x, lp)

    layer_flags, layer_abft, layer_acts = [], [], []
    for lp in _unstack(stacked, n):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, lp, use_reentrant=False)
        else:
            x = blk(x, lp)
        if collect_flags:
            _drain_layer(recorder, layer_flags, layer_abft)
        if collect_acts:
            layer_acts.append(recorder.drain_acts())
    return x, layer_flags, layer_abft, layer_acts


def _stack_acts(layer_acts: list) -> dict:
    return {p: torch.stack([d[p] for d in layer_acts]) for p in layer_acts[0]}


def _encode(cfg: ArchConfig, params, enc_embeds, *, wt=L.Identity,
            dtype=torch.bfloat16, layer_transform=None, collect_flags=False,
            collect_acts=False, recorder=None):
    """The bidirectional encoder over frame embeddings (B, Se, D) -> (the
    final-normed output (B, Se, D) in ``dtype``, per-layer (corrected, due)
    rows, ABFT rows, acts), as the reference's ``_encode``."""
    x = enc_embeds.to(dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, fl, ab, acts = _run_stack(
        cfg, lambda x, lp: _enc_block(cfg, lp, x, positions, wt), x,
        params["enc_layers"], cfg.enc_layers,
        lt=_scoped_lt(layer_transform, "enc_layers"),
        collect_flags=collect_flags, collect_acts=collect_acts,
        recorder=recorder)
    return L.apply_norm(x, params["enc_final_norm"], cfg.norm), fl, ab, acts


def forward(cfg: ArchConfig, params, tokens, *, wt=L.Identity,
            dtype=torch.bfloat16, chunk: int = 2048, layer_transform=None,
            collect_flags=False, collect_acts=False, recorder=None,
            attention="torch", prefix_embeds=None, enc_embeds=None):
    """tokens: (B, S) int -> logits (B, S', V). For the vlm family
    ``prefix_embeds`` (B, P, D), precomputed image-patch embeddings, is
    prepended (S' = P + S); for the encdec family ``enc_embeds`` (B, Se,
    D), precomputed frame embeddings, feed the encoder, whose output every
    decoder block cross-attends; other families take neither. ``wt``
    transforms each projection weight and the head at use (a tied head is
    the transposed embedding; the lookup reads the raw one) (QAT's
    fake-quant; per layer slice, as the reference's scan applies it);
    ``layer_transform`` maps each layer's param slice: one callable, or a
    ``{"layers" | "tail" | "enc_layers": fn}`` dict with one per stacked
    subtree.
    With ``cfg.remat`` each layer is recomputed in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations. ``attention`` routes the causal attention: "torch"
    (``layers.chunked_causal_attention``) or "cuda" (the flash kernel).

    ``collect_flags`` / ``collect_acts`` drain the ``recorder``
    (:class:`layers.FlagRecorder`) once per layer, as the reference drains
    its sinks per scanned layer, and return ``(logits, flags)``,
    ``(logits, acts)`` or ``(logits, flags, acts)``: ``flags["layers"]``
    (L, 2) per-layer (corrected, due), plus ``flags["layers_abft"]`` (L, 2)
    (mismatches, clamp hits) when the recorder's ABFT channel is on;
    ``acts["layers"]`` ``{leaf path: (L,) f32 absmax}``; the encdec family
    adds the encoder's rows under ``"enc_layers"`` (and
    ``"enc_layers_abft"``), the hybrid family its tail's under ``"tail"``
    (and ``"tail_abft"``). The output head records after the layers and
    stays in the recorder for the caller."""
    _check_family(cfg)
    if (collect_flags or collect_acts) and recorder is None:
        raise ValueError("collect_flags / collect_acts drain a recorder: "
                         "pass layers.FlagRecorder")
    if prefix_embeds is not None and cfg.family != "vlm":
        raise ValueError(f"prefix_embeds feed the vlm family, not "
                         f"{cfg.family!r}")
    if (enc_embeds is not None) != (cfg.family == "encdec"):
        raise ValueError(f"enc_embeds feed the encdec family (and it needs "
                         f"them), not {cfg.family!r}")
    flags, acts = {}, {}
    enc_out = None
    if cfg.family == "encdec":
        enc_out, fl, ab, ea = _encode(
            cfg, params, enc_embeds, wt=wt, dtype=dtype,
            layer_transform=layer_transform, collect_flags=collect_flags,
            collect_acts=collect_acts, recorder=recorder)
        if collect_flags:
            flags.update(_layer_rows(fl, ab, "enc_layers"))
        if collect_acts:
            acts["enc_layers"] = _stack_acts(ea)
    x = _embed_in(cfg, tokens, params["embed"], dtype, prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, fl, ab, la = _run_stack(
        cfg, lambda x, lp: _block_full(cfg, lp, _constrain_residual(x),
                                       positions, wt, chunk, attention,
                                       enc_out),
        x, params["layers"], n_scan_layers(cfg),
        lt=_scoped_lt(layer_transform, "layers"),
        collect_flags=collect_flags, collect_acts=collect_acts,
        recorder=recorder)
    if cfg.family == "hybrid" and "tail" in params:
        x, tfl, tab, tla = _run_stack(
            cfg, lambda x, lp: _rg_full(cfg, lp, x, "rg0", wt), x,
            params["tail"], hybrid_tail_layers(cfg),
            lt=_scoped_lt(layer_transform, "tail"),
            collect_flags=collect_flags, collect_acts=collect_acts,
            recorder=recorder)
        if collect_flags:
            flags.update(_layer_rows(tfl, tab, "tail"))
        if collect_acts:
            acts["tail"] = _stack_acts(tla)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    out = L.logits(x, _head(cfg, params), wt)
    if not (collect_flags or collect_acts):
        return out
    extra = ()
    if collect_flags:
        extra += ({**_layer_rows(fl, ab), **flags},)
    if collect_acts:
        extra += ({"layers": _stack_acts(la), **acts},)
    return (out, *extra)


def loss_fn(cfg: ArchConfig, params, batch, *, wt=L.Identity,
            dtype=torch.bfloat16, chunk: int = 2048):
    """Causal-LM cross entropy: mean of the f32 ``logsumexp`` minus the
    target logit. batch: {"tokens", "targets"} (B, S) int; for the vlm
    family optionally ``"prefix_embeds"`` (B, P, D): the loss then covers
    the text positions only, the last S; for the encdec family
    ``"enc_embeds"`` (B, Se, D), the encoder's frames."""
    targets = batch["targets"]
    logits = forward(cfg, params, batch["tokens"], wt=wt, dtype=dtype,
                     chunk=chunk, prefix_embeds=batch.get("prefix_embeds"),
                     enc_embeds=batch.get("enc_embeds"))
    if cfg.family == "vlm":
        logits = logits[:, -targets.shape[1]:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    if local.is_dtensor(logits):   # the vocab may be split over shards
        tgt = local.take_last(logits, targets)
    else:
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
    The encdec family cross-attends the cache's ``cross_k`` and
    ``cross_v`` (read, never written) after the self-attention, then runs
    the GELU MLP after ``ln3``; the encoder does not run here. The hybrid
    family steps each super-block's two RG-LRU states and attends its ring
    of ``attn_window`` slots, then steps the tail's RG-LRU layers, whose
    counts come back in a ``"tail"`` (T, 2) row (and ``"tail_abft"``).
    The ssm family steps each layer's Mamba2 state and conv history. The
    moe family attends through MLA over its latent cache (or GQA over the
    dense or paged KV cache without ``use_mla``), then runs the MoE.
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
    lt = _scoped_lt(layer_transform, "layers")
    layer_flags, kv_flags, abft_flags = [], [], []
    for i in range(n_scan_layers(cfg)):
        lp = _take(i, params["layers"])
        if lt is not None:
            lp = lt(lp)
        # the tail's states have their own leading axis
        lc = {k: v[i] for k, v in cache.items() if not k.startswith("tail")}
        if cfg.family in ("hybrid", "ssm"):
            step = _hybrid_decode if cfg.family == "hybrid" else _ssm_decode
            x = step(cfg, lp, x, lc, pos)
            _drain_layer(recorder, layer_flags, abft_flags)
            continue
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        if cfg.family == "moe" and cfg.use_mla:
            o, _ = L.mla_decode(lp["attn"], h, cfg, lc, pos=pos)
        elif paged:
            o, _, kvf = kvcache.paged_gqa_decode(lp["attn"], h, cfg, lc,
                                                 pos=pos, policy=kvp)
            kv_flags.append(kvf)
        else:
            o, _ = L.gqa_decode(lp["attn"], h, cfg, lc, pos=pos)
        x = x + o
        if cfg.family == "moe":
            x = x + L.moe(lp["moe"], L.apply_norm(x, lp["ln2"], cfg.norm),
                          cfg)
        elif cfg.family == "encdec":
            h = L.apply_norm(x, lp["ln2"], cfg.norm)
            x = x + L.cross_attention(lp["cross"], h,
                                      (lc["cross_k"], lc["cross_v"]), cfg)
            x = x + L.gelu_mlp(lp["mlp"], L.apply_norm(x, lp["ln3"],
                                                       cfg.norm))
        else:
            x = x + L.swiglu(lp["mlp"], L.apply_norm(x, lp["ln2"], cfg.norm))
        _drain_layer(recorder, layer_flags, abft_flags)
    tail_flags, tail_abft = [], []
    if cfg.family == "hybrid" and "tail" in params:
        lt = _scoped_lt(layer_transform, "tail")
        for i in range(hybrid_tail_layers(cfg)):
            lp = _take(i, params["tail"])
            if lt is not None:
                lp = lt(lp)
            x = _rg_decode(cfg, lp, x, {"h": cache["tail_h"][i],
                                        "conv": cache["tail_conv"][i]}, "rg0")
            _drain_layer(recorder, tail_flags, tail_abft)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    logits = L.logits(x, _head(cfg, params))
    if recorder is None:
        return logits, cache
    flags = _layer_rows(layer_flags, abft_flags)
    if tail_flags:
        flags.update(_layer_rows(tail_flags, tail_abft, "tail"))
    if paged:
        flags["layers_kv"] = torch.stack(kv_flags)
    return logits, cache, flags


def _rg_decode(cfg: ArchConfig, lp, x, state: dict, name: str):
    """One RG-LRU layer's decode step over its ``{"h", "conv"}`` state
    (stepped in place), then its MLP."""
    nk = cfg.norm
    o, _ = L.rglru_decode(lp[name], L.apply_norm(x, lp[f"{name}_ln1"], nk),
                          cfg, state)
    x = x + o
    return x + L.swiglu(lp[f"{name}_mlp"],
                        L.apply_norm(x, lp[f"{name}_ln2"], nk))


def _hybrid_decode(cfg: ArchConfig, lp, x, lc: dict, pos):
    """One hybrid super-block's decode step: its two RG-LRU layers over
    ``rg{0,1}_h`` / ``rg{0,1}_conv``, then local attention over the ring
    ``k`` / ``v`` (``gqa_decode`` with the window, in a ``local_attention``
    profiler range) and its MLP; every state of ``lc`` (this layer's
    slice) is written in place."""
    nk = cfg.norm
    for i in range(2):
        x = _rg_decode(cfg, lp, x, {"h": lc[f"rg{i}_h"],
                                    "conv": lc[f"rg{i}_conv"]}, f"rg{i}")
    with torch.profiler.record_function("local_attention"):
        o, _ = L.gqa_decode(lp["attn"], L.apply_norm(x, lp["attn_ln1"], nk),
                            cfg, {"k": lc["k"], "v": lc["v"]}, pos=pos,
                            window=cfg.attn_window)
    x = x + o
    return x + L.swiglu(lp["attn_mlp"], L.apply_norm(x, lp["attn_ln2"], nk))


def _ssm_decode(cfg: ArchConfig, lp, x, lc: dict, pos):
    """One Mamba2 layer's decode step over this layer's ``state`` and
    ``conv`` (stepped in place)."""
    o, _ = L.mamba2_decode(lp["mixer"], L.apply_norm(x, lp["ln1"], cfg.norm),
                           cfg, lc)
    return x + o


def _drain_layer(recorder, layer_flags: list, abft_flags: list) -> None:
    """Drain one layer's (corrected, due) and, with the ABFT channel on,
    its (mismatches, clamp hits) from ``recorder``."""
    if recorder is None:
        return
    layer_flags.append(recorder.drain())
    if recorder.abft:
        abft_flags.append(recorder.drain_abft())


def _layer_rows(layer_flags: list, abft_flags: list,
                key: str = "layers") -> dict:
    flags = {key: torch.stack(layer_flags)}
    if abft_flags:
        flags[f"{key}_abft"] = torch.stack(abft_flags)
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
        raise ValueError(f"paged prefill unsupported for family "
                         f"{cfg.family!r}")
    x = _embed_in(cfg, tokens, params["embed"], dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    layer_flags, kv_flags, abft_flags = [], [], []
    lt = _scoped_lt(layer_transform, "layers")
    for i in range(n_scan_layers(cfg)):
        lp = _take(i, params["layers"])
        if lt is not None:
            lp = lt(lp)
        lc = {k: v[i] for k, v in cache.items()}
        x = _constrain_residual(x)
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        o, _, kvf = kvcache.paged_gqa_prefill(lp["attn"], h, cfg, lc,
                                              positions=positions, policy=kvp,
                                              chunk=chunk)
        x = x + o
        h2 = L.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + (L.moe(lp["moe"], h2, cfg) if cfg.family == "moe"
                 else L.swiglu(lp["mlp"], h2))
        kv_flags.append(kvf)
        _drain_layer(recorder, layer_flags, abft_flags)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    logits = L.logits(x, _head(cfg, params))
    if recorder is None:
        return logits, cache
    return logits, cache, {**_layer_rows(layer_flags, abft_flags),
                           "layers_kv": torch.stack(kv_flags)}

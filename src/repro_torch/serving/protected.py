"""Protected serving: the decode-at-use serve step, prefill and int8
calibration.

Counterpart of ``repro.serving.protected``. Weights stay resident as
``ProtectedTensor`` leaves; every projection decodes its weight at the
point of use — through the fused decode+matmul kernel on the ``cuda``
route, or inline per leaf on the ``torch`` route — so no decoded copy of
the tree is kept. The serve step returns logits and the (corrected, DUE)
counts each layer's decodes observed, plus (checksum mismatches, clamp
hits) rows when the plan guards its matmuls (``plan.with_abft``,
``with_act_quant(..., clamp=True)``). ``act_quant`` serves the
projections over the int8 path; :func:`calibrate_act_scales` derives its
static scales. The prefill fills a paged protected KV cache from a prompt,
or without a KV policy runs the cache-less ``lm.forward``. The reference's
ablations are kept: ``decode_at_use=False`` decodes the whole tree each
step (or each prefill), ``decode_per_step=False`` serves a tree decoded
once outside the step. A plan that carries a KV policy
(``plan.with_kv_policy``) sets the default ``kv_policy``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.protection.backends import get_backend
from repro_torch.protection.fused import ProtectedWeight, is_matmul_weight
from repro_torch.protection.policy import (decode_leaf_with_flags,
                                           decode_tree)
from repro_torch.protection.tensor import ProtectedTensor, is_protected_tensor

from . import kvcache

STACKED_KEYS = ("layers", "tail", "enc_layers")


class _Router:
    """Per-leaf decode route: the plan's backend for a planned leaf, else
    the serve step's ``backend``; and each leaf's activation-quant, ABFT and
    clamp decisions.

    act_quant: None (float activations) | "dynamic" | "static" (applied to
    every capable leaf; "static" to the calibrated ones) | "plan" (each
    leaf's ``LeafPlan.act_quant``). calibrate=True runs the float path and
    records each matmul's activation absmax by leaf path. abft_per_slot
    makes every guarded view report per-row (per-slot) ABFT vectors."""

    def __init__(self, plan, backend, *, act_quant=None, calibrate=False,
                 abft_per_slot=False):
        if act_quant not in (None, "static", "dynamic", "plan"):
            raise ValueError(f"act_quant {act_quant!r}; one of "
                             f"(None, 'static', 'dynamic', 'plan')")
        self.plan = plan
        self.backend = get_backend(backend)
        self.act_quant = act_quant
        self.calibrate = calibrate
        self.abft_per_slot = abft_per_slot

    def _leaf(self, path: str):
        return self.plan.leaves.get(path) if self.plan is not None else None

    @property
    def any_abft(self) -> bool:
        """True when a planned leaf carries an ABFT or clamp decision: the
        step then opens the recorder's ABFT channel."""
        return self.plan is not None and any(
            lp.abft or lp.clamp is not None for lp in self.plan)

    def abft_for(self, path: str) -> tuple:
        """-> (abft enabled, clamp bound | None) for one leaf."""
        lp = self._leaf(path)
        return (False, None) if lp is None else (bool(lp.abft), lp.clamp)

    def act_for(self, path: str) -> tuple:
        """-> (act_quant mode | None, a_scale | None) for one leaf."""
        lp = self._leaf(path)
        if self.act_quant is None:
            return None, None
        if self.act_quant == "dynamic":
            return "dynamic", None
        if self.act_quant == "static":
            # the calibrated set defines what serves int8
            if lp is not None and lp.a_scale is not None:
                return "static", lp.a_scale
            return None, None
        return (lp.act_quant, lp.a_scale) if lp is not None else (None, None)

    def backend_for(self, path: str):
        lp = self._leaf(path)
        if lp is not None and lp.protected:
            return get_backend(lp.backend)
        return self.backend

    def wrap(self, path: str, pt: ProtectedTensor, dtype,
             recorder: L.FlagRecorder):
        """Decode-at-use view for a matmul-consumed leaf; leaves indexed
        elementwise (conv kernels) decode inline right here."""
        be = self.backend_for(path)
        if not is_matmul_weight(path):
            w, corrected, due = decode_leaf_with_flags(pt, dtype, backend=be)
            recorder.record(corrected, due)
            return w
        aq, a_scale = self.act_for(path)
        abft, clamp = self.abft_for(path)
        return ProtectedWeight(
            pt, be, record=recorder.record, act_quant=aq, a_scale=a_scale,
            abft=abft, clamp=clamp, record_abft=recorder.record_abft,
            abft_per_slot=self.abft_per_slot, observe=(functools.partial(recorder.record_act, path)
                     if self.calibrate else None))


def _scan_ready(subtree, prefix: str, router: _Router, dtype,
                recorder: L.FlagRecorder):
    """Stacked subtree ready for the layer loop: same-shape images stay
    encoded (sliced per layer by ``ProtectedTensor.layer``); flat-padded
    images, which flatten across layers, decode here (their flags land in
    the "top" row)."""

    def prep(path, leaf):
        if not (is_protected_tensor(leaf) and leaf.is_flat):
            return leaf
        w, corrected, due = decode_leaf_with_flags(
            leaf, dtype,
            backend=router.backend_for(f"{prefix}/{tree.path_str(path)}"))
        recorder.record(corrected, due)
        return w

    return tree.map_with_path(prep, subtree)


def _layer_transform(router: _Router, dtype, recorder: L.FlagRecorder):
    """``{stacked key: fn}``: each fn wraps every protected leaf of one
    layer's params in its view, resolving the route by the leaf's full
    plan path (``layers/...``, ``tail/...``, ``enc_layers/...``)."""

    def scoped(prefix):
        def lt(lp):
            def wrap(path, leaf):
                if not is_protected_tensor(leaf):
                    return leaf
                return router.wrap(f"{prefix}/{tree.path_str(path)}", leaf,
                                   dtype, recorder)
            return tree.map_with_path(wrap, lp)
        return lt
    return {k: scoped(k) for k in STACKED_KEYS}


def _use_tree(enc_params, router: _Router, dtype, recorder: L.FlagRecorder):
    """enc tree -> params the model runs with decode at use: stacked
    subtrees stay encoded, top-level protected leaves become views
    (``embed`` decodes to a real tensor — it is indexed, not matmul'd; a
    tied head is that one tensor transposed, so the "top" row counts the
    embedding once and there is no head leaf)."""
    out = {}
    for key, sub in enc_params.items():
        if key in STACKED_KEYS:
            out[key] = _scan_ready(sub, key, router, dtype, recorder)
        elif is_protected_tensor(sub):
            if key == "embed":
                with torch.profiler.record_function("embed_decode"):
                    w, corrected, due = decode_leaf_with_flags(
                        sub, dtype, backend=router.backend_for(key))
                recorder.record(corrected, due)
                out[key] = w
            else:
                out[key] = router.wrap(key, sub, dtype, recorder)
        else:
            out[key] = sub
    return out


def make_plan(params, policy=None, *, mesh=None, param_spec_fn=None):
    """The serving :class:`~repro_torch.protection.ProtectionPlan` of a
    parameter tree (or its shape records): scheme, layout, backend and,
    with ``param_spec_fn``, the sharding spec of every leaf, resolved once
    for :func:`make_serve_step`, :func:`make_prefill` and the dry-run's
    cells (``policy`` defaults to in-place on every weight)."""
    from repro_torch import protection
    return protection.make_plan(policy or protection.default_policy(),
                                params, mesh=mesh,
                                param_spec_fn=param_spec_fn)


def _kv_policy(kv_policy, attention_impl, backend, plan=None):
    """Resolve the KV policy (default: the plan's), apply the
    ``attention_impl`` override and set the codec route to the step's
    ``backend``."""
    if kv_policy is None and plan is not None:
        kv_policy = plan.kv_policy
    kvp = kvcache.get_kv_policy(kv_policy)
    if attention_impl is not None:
        if kvp is None:
            raise ValueError("attention_impl override needs a kv_policy")
        kvp = dataclasses.replace(kvp, attention_impl=attention_impl)
    if kvp is not None:
        kvp = dataclasses.replace(kvp, backend=backend)
    return kvp


def _top_rows(recorder: L.FlagRecorder, top) -> dict:
    """The step's "top" rows, drained after the model: the output head
    decodes (and is checked) last."""
    rows = {"top": top + recorder.drain()}
    if recorder.abft:
        rows["top_abft"] = recorder.drain_abft()
    return rows


def _decoder(plan, dtype, backend):
    """The whole-tree decode of the ablations: the plan's (each leaf on its
    planned route) or the step's ``backend`` for every leaf."""
    if plan is not None:
        return lambda enc_params: plan.decode_tree(enc_params, dtype)
    be = get_backend(backend)
    return lambda enc_params: decode_tree(enc_params, dtype, backend=be)


def make_serve_step(cfg: ArchConfig, *, plan=None,
                    decode_per_step: bool = True, decode_at_use=None,
                    dtype=torch.bfloat16, backend="torch", with_flags=None,
                    kv_policy=None, attention_impl=None, act_quant=None):
    """``serve_step(enc_params, cache, tokens, pos) -> (logits, cache,
    flags)``, or ``(logits, cache)`` with ``with_flags=False``.

    ``with_flags`` defaults to True on the decode-at-use step (the
    reference's default is False) and to False on the whole-tree paths,
    which discard flags: asking them for flags raises ``ValueError``, as
    the reference does. ``decode_at_use`` defaults to ``decode_per_step``.
    ``decode_at_use=False`` is the whole-tree ablation: every step decodes
    the whole tree (the plan's routes, else ``backend``), then runs the
    model on the float weights; ``decode_per_step=False`` serves
    ``enc_params`` as given: a tree decoded once, outside the step (e.g.
    ``plan.decode_tree(enc)``). ``act_quant`` needs the decode-at-use step
    (``ValueError`` otherwise).

    Decode at use: each weight decodes at its point of use. ``plan`` routes
    each planned leaf by its backend; without one, ``backend`` ("torch" |
    "cuda") is the route. ``backend`` is also the route of the paged KV
    cache's encode and decode: it replaces the KV policy's own. flags:
    ``"top"`` (2,) for the embedding and the head, ``"layers"`` (L, 2)
    per-layer (corrected, DUE) counts (the hybrid family's tail layers in
    ``"tail"`` (T, 2); the ssm family and the moe family over its latent
    cache have these two rows only), and with
    a paged protected KV cache (``kv_policy``) ``"layers_kv"`` (L, 2).
    When the plan guards leaves (``plan.with_abft`` or clamps) the flags
    also carry (checksum mismatches, clamp hits) rows: ``"top_abft"``
    (2,) and ``"layers_abft"`` (L, 2). Under a KV policy with ``per_slot_flags``
    the KV rows are (L, 2, B) and the ABFT rows per slot as well:
    ``"top_abft"`` (2, B), ``"layers_abft"`` (L, 2, B) (the request
    front-end's per-request attribution). ``attention_impl`` ("strip" |
    "chunked") overrides the resolved KV policy's attention routing — the
    switch onto the page-chunked kernel for long contexts. ``act_quant`` (None |
    "dynamic" | "static" | "plan") serves the projections over the int8
    path (see :class:`_Router`). ``kv_policy`` defaults to the plan's
    (``plan.with_kv_policy``).
    """
    kvp = _kv_policy(kv_policy, attention_impl, backend, plan)
    if decode_at_use is None:
        decode_at_use = decode_per_step
    at_use = decode_at_use and decode_per_step
    if with_flags is None:
        with_flags = at_use
    if act_quant is not None and not at_use:
        raise ValueError("act_quant needs the decode-at-use serve step (the "
                         "whole-tree decode paths serve float weights)")
    if not at_use:
        if with_flags:
            raise ValueError("with_flags needs the decode-at-use serve step "
                             "(the whole-tree decode paths discard flags)")
        decode = _decoder(plan, dtype, backend)

        def whole_tree_step(enc_params, cache, tokens, pos):
            params = decode(enc_params) if decode_per_step else enc_params
            return lm.decode_step(cfg, params, cache, tokens, pos,
                                  dtype=dtype, kv_policy=kvp)

        return whole_tree_step
    per_slot = kvp is not None and kvp.per_slot_flags
    router = _Router(plan, backend, act_quant=act_quant,
                     abft_per_slot=per_slot)
    track_abft = router.any_abft

    def serve_step(enc_params, cache, tokens, pos):
        recorder = L.FlagRecorder(
            tokens.device, abft=track_abft,
            abft_rows=tokens.shape[0] if per_slot else None)
        params = _use_tree(enc_params, router, dtype, recorder)
        top = recorder.drain()
        logits, cache, flags = lm.decode_step(
            cfg, params, cache, tokens, pos, dtype=dtype,
            layer_transform=_layer_transform(router, dtype, recorder),
            recorder=recorder, kv_policy=kvp)
        if not with_flags:
            return logits, cache
        return logits, cache, {**_top_rows(recorder, top), **flags}

    return serve_step


def make_prefill(cfg: ArchConfig, *, plan=None, dtype=torch.bfloat16,
                 chunk: int = 2048, backend="torch",
                 decode_at_use: bool = True, with_flags: bool = False,
                 act_quant=None, kv_policy=None, attention_impl=None):
    """The decode-at-use prefill, routed as :func:`make_serve_step`
    (``act_quant`` included).

    With a ``kv_policy``: ``prefill(enc_params, cache, tokens) -> (logits,
    cache)`` fills the paged protected KV cache through
    ``lm.prefill_with_cache`` so decode steps continue from it. Without
    one: ``prefill(enc_params, tokens, extras=None) -> logits``, the
    cache-less ``lm.forward``; ``extras`` are its keyword inputs beside
    the tokens, as in the reference (``{"enc_embeds": frames}`` for the
    encdec family, whose encoder then decodes its images at use too).
    ``with_flags`` adds the flags dict: ``"top"``, ``"layers"``,
    ``"layers_kv"`` (paged), ``"enc_layers"`` (encdec), ``"tail"``
    (hybrid) and, for a guarded
    plan, ``"top_abft"`` and the ``*_abft`` rows. ``backend`` routes the codec and
    the attention (the flash kernel on "cuda", with the hybrid family's
    sliding window where it is shorter than the prompt); ``chunk`` is the
    plain route's attention chunk. ``kv_policy`` defaults to the plan's.
    ``decode_at_use=False`` is the whole-tree ablation: the prefill decodes
    the whole tree first (the plan's routes, else ``backend``) and runs on
    the float weights, with the same call forms; it takes neither
    ``act_quant`` nor ``with_flags`` (``ValueError``, as the reference).
    """
    kvp = _kv_policy(kv_policy, attention_impl, backend, plan)
    attention = get_backend(backend).name
    if not decode_at_use:
        if act_quant is not None:
            raise ValueError("act_quant needs the decode-at-use prefill")
        if with_flags:
            raise ValueError("with_flags needs the decode-at-use prefill")
        decode = _decoder(plan, dtype, backend)
        if kvp is None:
            def whole_tree_forward(enc_params, tokens, extras=None):
                return lm.forward(cfg, decode(enc_params), tokens,
                                  dtype=dtype, chunk=chunk,
                                  attention=attention, **(extras or {}))
            return whole_tree_forward

        def whole_tree_prefill(enc_params, cache, tokens):
            return lm.prefill_with_cache(cfg, decode(enc_params), cache,
                                         tokens, dtype=dtype, chunk=chunk,
                                         kv_policy=kvp)
        return whole_tree_prefill
    router = _Router(plan, backend, act_quant=act_quant)
    track_abft = router.any_abft

    def run(enc_params, cache, tokens, extras=None):
        recorder = L.FlagRecorder(tokens.device, abft=track_abft)
        params = _use_tree(enc_params, router, dtype, recorder)
        top = recorder.drain()
        lt = _layer_transform(router, dtype, recorder)
        if kvp is not None:
            logits, cache, flags = lm.prefill_with_cache(
                cfg, params, cache, tokens, dtype=dtype, chunk=chunk,
                layer_transform=lt, recorder=recorder, kv_policy=kvp)
        else:
            logits, flags = lm.forward(
                cfg, params, tokens, dtype=dtype, chunk=chunk,
                layer_transform=lt, collect_flags=True, recorder=recorder,
                attention=attention, **(extras or {}))
        return logits, cache, {**_top_rows(recorder, top), **flags}

    if kvp is None:
        def prefill(enc_params, tokens, extras=None):
            logits, _, flags = run(enc_params, None, tokens, extras)
            return (logits, flags) if with_flags else logits
        return prefill

    def prefill(enc_params, cache, tokens):
        logits, cache, flags = run(enc_params, cache, tokens)
        return (logits, cache, flags) if with_flags else (logits, cache)

    return prefill


def calibrate_act_scales(cfg: ArchConfig, enc_params, tokens, *, plan=None,
                         backend="torch", dtype=torch.bfloat16,
                         chunk: int = 2048) -> dict:
    """Static activation scales from a small batch.

    Runs the float decode-at-use cache-less prefill over ``tokens`` (B, S)
    with every projection's activation absmax recorded at its point of use,
    routed as serving routes it, so exactly the leaves that will consume
    the scales observe them; each stacked leaf takes its maximum over the
    layers. Returns ``{leaf path: a_scale}`` with ``a_scale = max(absmax,
    1e-12) / 127`` (the floor of ``quant.compute_scale``: an all-zero
    activation must not bake a zero scale); feed it to
    ``plan.with_act_quant("static", scales)``. The maxima stay on the
    device until one transfer at the end.

    The encdec family raises ``ValueError``: the reference calibrates
    through ``lm.forward`` without encoder frames and cannot run it for
    this family (``repro/models/lm.py:343`` reads the missing frames).
    """
    if cfg.family == "encdec":
        raise ValueError(
            "calibrate_act_scales cannot calibrate the encdec family: the "
            "reference's calibration runs lm.forward without encoder frames "
            "and fails at repro/models/lm.py:343 (enc_embeds is None)")
    router = _Router(plan, backend, calibrate=True)
    recorder = L.FlagRecorder(tokens.device)
    params = _use_tree(enc_params, router, dtype, recorder)
    _, acts = lm.forward(cfg, params, tokens, dtype=dtype, chunk=chunk,
                         layer_transform=_layer_transform(router, dtype,
                                                          recorder),
                         collect_acts=True, recorder=recorder,
                         attention=get_backend(backend).name)
    maxima = {p: v.max() for sub in acts.values() for p, v in sub.items()}
    maxima.update(recorder.drain_acts())  # the head records after the layers
    values = torch.stack(list(maxima.values())).tolist()
    return {p: max(v, 1e-12) / 127.0 for p, v in zip(maxima, values)}

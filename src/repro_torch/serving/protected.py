"""Protected serving: the decode-at-use serve step and prefill.

Counterpart of ``repro.serving.protected`` in its decode-at-use mode with
flags. Weights stay resident as ``ProtectedTensor`` leaves; every
projection decodes its weight at the point of use — through the fused
decode+matmul kernel on the ``cuda`` route, or inline per leaf on the
``torch`` route — so no decoded copy of the tree is kept. The serve step
returns logits and the (corrected, DUE) counts each layer's decodes
observed; the prefill fills a paged protected KV cache from a prompt. The
whole-tree decode ablations, the cache-less prefill (``lm.forward``),
activation quantization, ABFT and calibration are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.protection.backends import get_backend
from repro_torch.protection.fused import ProtectedWeight, is_matmul_weight
from repro_torch.protection.policy import decode_leaf_with_flags
from repro_torch.protection.tensor import ProtectedTensor, is_protected_tensor

from . import kvcache

STACKED_KEYS = ("layers",)


class _Router:
    """Per-leaf decode route: the plan's backend for a planned leaf, else
    the serve step's ``backend``."""

    def __init__(self, plan, backend):
        self.plan = plan
        self.backend = get_backend(backend)

    def backend_for(self, path: str):
        lp = self.plan.leaves.get(path) if self.plan is not None else None
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
        return ProtectedWeight(pt, be, record=recorder.record)


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
    """Wrap each protected leaf of one layer's params in its view, resolving
    the route by the leaf's full plan path."""

    def lt(lp):
        def wrap(path, leaf):
            if not is_protected_tensor(leaf):
                return leaf
            return router.wrap(f"layers/{tree.path_str(path)}", leaf, dtype,
                               recorder)
        return tree.map_with_path(wrap, lp)
    return lt


def _use_tree(enc_params, router: _Router, dtype, recorder: L.FlagRecorder):
    """enc tree -> params the model runs with decode at use: stacked
    subtrees stay encoded, top-level protected leaves become views
    (``embed`` decodes to a real tensor — it is indexed, not matmul'd)."""
    out = {}
    for key, sub in enc_params.items():
        if key in STACKED_KEYS:
            out[key] = _scan_ready(sub, key, router, dtype, recorder)
        elif is_protected_tensor(sub):
            if key == "embed":
                w, corrected, due = decode_leaf_with_flags(
                    sub, dtype, backend=router.backend_for(key))
                recorder.record(corrected, due)
                out[key] = w
            else:
                out[key] = router.wrap(key, sub, dtype, recorder)
        else:
            out[key] = sub
    return out


def _kv_policy(kv_policy, attention_impl, backend):
    """Resolve the KV policy, apply the ``attention_impl`` override and set
    the codec route to the step's ``backend``."""
    kvp = kvcache.get_kv_policy(kv_policy)
    if attention_impl is not None:
        if kvp is None:
            raise ValueError("attention_impl override needs a kv_policy")
        kvp = dataclasses.replace(kvp, attention_impl=attention_impl)
    if kvp is not None:
        kvp = dataclasses.replace(kvp, backend=backend)
    return kvp


def make_serve_step(cfg: ArchConfig, *, plan=None, dtype=torch.bfloat16,
                    backend="torch", kv_policy=None,
                    attention_impl=None):
    """``serve_step(enc_params, cache, tokens, pos) -> (logits, cache,
    flags)``.

    Decode at use: each weight decodes at its point of use. ``plan`` routes
    each planned leaf by its backend; without one, ``backend`` ("torch" |
    "cuda") is the route. ``backend`` is also the route of the paged KV
    cache's encode and decode: it replaces the KV policy's own. flags: ``"top"`` (2,) for the embedding and the
    head, ``"layers"`` (L, 2) per-layer (corrected, DUE) counts, and with a
    paged protected KV cache (``kv_policy``) ``"layers_kv"`` (L, 2).
    ``attention_impl`` ("strip" | "chunked") overrides the resolved KV
    policy's attention routing — the switch onto the page-chunked kernel
    for long contexts.
    """
    kvp = _kv_policy(kv_policy, attention_impl, backend)
    router = _Router(plan, backend)

    def serve_step(enc_params, cache, tokens, pos):
        recorder = L.FlagRecorder(tokens.device)
        params = _use_tree(enc_params, router, dtype, recorder)
        top = recorder.drain()
        logits, cache, flags = lm.decode_step(
            cfg, params, cache, tokens, pos, dtype=dtype,
            layer_transform=_layer_transform(router, dtype, recorder),
            recorder=recorder, kv_policy=kvp)
        top = top + recorder.drain()  # the output head decodes last
        return logits, cache, {"top": top, **flags}

    return serve_step


def make_prefill(cfg: ArchConfig, *, plan=None, dtype=torch.bfloat16,
                 chunk: int = 2048, backend="torch",
                 decode_at_use: bool = True, with_flags: bool = False,
                 act_quant=None, kv_policy=None, attention_impl=None):
    """``prefill(enc_params, cache, tokens) -> (logits, cache)`` (``+
    flags`` with ``with_flags=True``).

    Decode at use, routed as in :func:`make_serve_step`: it fills the paged
    protected KV cache through ``lm.prefill_with_cache`` so decode steps
    continue from it. flags: ``"top"``, ``"layers"`` and ``"layers_kv"``
    rows as the serve step returns them. ``backend`` routes the KV codec
    and the attention (the flash kernel on "cuda"); ``chunk`` is the
    plain route's attention chunk. The whole-tree decode ablation
    (``decode_at_use=False``), ``act_quant`` and the cache-less form
    (no ``kv_policy``, ``lm.forward``) raise ``NotImplementedError``.
    """
    if not decode_at_use:
        raise NotImplementedError("the whole-tree decode prefill ablation "
                                  "(decode_at_use=False) is not ported yet: "
                                  "it comes with the whole-tree decode "
                                  "ablations of the serve step")
    if act_quant is not None:
        raise NotImplementedError("act_quant (int8 activations) is not "
                                  "ported yet: it comes with the ABFT and "
                                  "int8 paths of ecc_qmatmul")
    kvp = _kv_policy(kv_policy, attention_impl, backend)
    if kvp is None:
        raise NotImplementedError("the cache-less prefill (lm.forward) is "
                                  "not ported yet: it comes with the "
                                  "lm.forward/gqa_attention slice; pass a "
                                  "kv_policy")
    router = _Router(plan, backend)

    def prefill(enc_params, cache, tokens):
        recorder = L.FlagRecorder(tokens.device)
        params = _use_tree(enc_params, router, dtype, recorder)
        top = recorder.drain()
        logits, cache, flags = lm.prefill_with_cache(
            cfg, params, cache, tokens, dtype=dtype, chunk=chunk,
            layer_transform=_layer_transform(router, dtype, recorder),
            recorder=recorder, kv_policy=kvp)
        if not with_flags:
            return logits, cache
        top = top + recorder.drain()  # the output head decodes last
        return logits, cache, {"top": top, **flags}

    return prefill

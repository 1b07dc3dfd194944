"""Shape-only stand-ins for every dry-run cell, and the sharded step that
runs one.

Counterpart of ``repro.launch.specs``: ``train_cell``, ``decode_cell``,
``prefill_cell`` and ``cell(cfg, shape, mesh)`` return ``(step_fn, args,
in_specs, out_specs)``. ``args`` are ``ShapeDtype`` records (nothing is
allocated); ``in_specs`` and ``out_specs`` are ``distributed.sharding.P``
trees (a ``P`` where a subtree stands covers every leaf under it, as a JAX
prefix spec does). Where the reference jits the step with these shardings
and lets GSPMD partition it, :func:`sharded` runs the step on DTensors
placed by the specs: the aten ops between the weights propagate their
placements, each kernel runs on its local shard (``distributed.local``),
and the outputs are laid out by ``out_specs``. :func:`materialize` turns
``args`` into seeded values (or fake tensors, for the dry-run) and places
them.

``mesh`` is a ``DeviceMesh``, or a plain ``{axis: size}`` dict where only
the specs are wanted (the dry-run's planning of a mesh no rank holds).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch import protection, tree
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models import layers, lm
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.protection.plan import ShapeDtype, _drop_nondividing
from repro_torch.serving import kvcache, protected
from repro_torch.training import optim, train

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sds(shape, dtype):
    return ShapeDtype(tuple(shape), dtype)


def _device_mesh(mesh):
    """The DeviceMesh, or None for a sizes dict."""
    return None if isinstance(mesh, dict) else mesh


def _bound(step, ctx):
    """``step`` under the sharding context ``ctx`` for the duration of each
    call, the caller's context restored after it. The reference's jit bakes
    the context in when it traces the step; the port reads it while the
    step runs, so a cell's step carries its own."""
    @functools.wraps(step)
    def run(*args, **kw):
        prev = layers.SHARDING_CTX
        lm.set_sharding_ctx(ctx)
        try:
            return step(*args, **kw)
        finally:
            lm.set_sharding_ctx(prev)
    return run


def batch_struct(cfg: ArchConfig, shape: ShapeConfig):
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s), torch.int32),
             "targets": _sds((b, s), torch.int32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = _sds((b, cfg.n_patches, cfg.d_model),
                                      torch.bfloat16)
    if cfg.family == "encdec":
        batch["enc_embeds"] = _sds((b, cfg.enc_seq, cfg.d_model),
                                   torch.bfloat16)
    return batch


def _sanitize(spec_tree, sds_tree, mesh):
    """Drop mesh axes from dims they don't divide (B=1 cells, odd head
    counts, enc_seq=1500, ...). One rule, shared with the plan layer."""
    sizes = sh.mesh_sizes(mesh)
    return sh.map_specs(
        lambda spec, sds: _drop_nondividing(spec, tuple(sds.shape), sizes),
        spec_tree, sds_tree)


def param_gib(cfg: ArchConfig) -> float:
    """Analytic total param size in GiB at cfg.param_dtype."""
    item = torch.empty((), dtype=_DTYPES[cfg.param_dtype]).element_size()
    return float(sum(math.prod(l.shape) * item for _, l in
                     tree.leaves_with_path(lm.param_shapes(cfg)))) / 2**30


def _param_struct(cfg: ArchConfig, dtype) -> dict:
    return tree.map_with_path(lambda _, l: _sds(l.shape, dtype),
                              lm.param_shapes(cfg))


def train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *, fsdp=None,
               sp=True, chunk=2048, seqs_per_shard=8, microbatch=None,
               backend="torch"):
    """Training step cell: (step_fn, args, in_specs, out_specs).

    Few microbatches (FSDP gathers and gradient reductions repeat per
    microbatch), FSDP auto-off when params + momentum fit model-sharded
    only (< 5 GiB per chip), as the reference's perf defaults. The step
    runs under the cell's sharding context (sequence-parallel residual by
    default). ``backend``
    routes the QATT throttle ("cuda": the ``quantize_throttle`` kernel on
    each shard)."""
    sizes = sh.mesh_sizes(mesh)
    dp = ("pod", "data") if "pod" in sizes else "data"
    dp_size = sizes.get("pod", 1) * sizes["data"]
    if microbatch is None:
        n_micro = max(1, shape.global_batch // (dp_size * seqs_per_shard))
    else:
        n_micro = microbatch
    cfg = cfg.with_(microbatch=n_micro)
    if fsdp is None:
        fsdp = 2 * param_gib(cfg) / sizes["model"] > 5.0
    ctx = {"dp": dp, "model": "model", "sp": sp,
           "model_size": sizes["model"], "mesh": _device_mesh(mesh)}
    params = _param_struct(cfg, _DTYPES[cfg.param_dtype])
    opt = optim.SgdState(params)
    batch = batch_struct(cfg, shape)

    pspec = _sanitize(sh.param_specs(params, fsdp=fsdp), params, mesh)
    ospec = optim.SgdState(pspec)
    bspec = _sanitize(sh.batch_specs(batch, multi_pod="pod" in sizes),
                      batch, mesh)

    step = _bound(train.make_train_step(cfg, chunk=chunk, backend=backend),
                  ctx)
    in_sh = (pspec, ospec, bspec)
    out_sh = (pspec, ospec, P())
    return step, (params, opt, batch), in_sh, out_sh


def _serving_fsdp_auto(cfg, mesh) -> bool:
    """int8 weight images: shard over 'data' too only when model-axis-only
    sharding would blow device memory (count GiB / model_shards > 5)."""
    count_gib = param_gib(cfg.with_(param_dtype="float32")) / 4
    return count_gib / sh.mesh_sizes(mesh)["model"] > 5.0


def serving_plan(cfg: ArchConfig, mesh, *, fsdp=None, policy=None):
    """One materialized ProtectionPlan per serving cell: scheme, layout,
    backend and sharding spec of every weight leaf (abstract params,
    nothing allocated) -> ``(plan, abstract)``."""
    if fsdp is None:
        fsdp = _serving_fsdp_auto(cfg, mesh)
    abstract = lm.param_shapes(cfg)
    return protected.make_plan(
        abstract, policy, mesh=sh.mesh_sizes(mesh),
        param_spec_fn=functools.partial(sh.param_spec, fsdp=fsdp)), abstract


def encoded_struct(plan, abstract) -> dict:
    """The encoded tree of ``abstract`` under ``plan`` as shape records: a
    protected leaf's ``ProtectedTensor`` of its image, check bytes (one per
    8-byte block) and f32 scale; raw leaves as they are."""
    def one(path, leaf):
        lp = plan._leaf(path)
        if not lp.protected:
            return leaf
        es = tuple(lp.enc_shape)
        checks = (_sds((*es[:-1], es[-1] // 8), torch.uint8)
                  if lp.check_bytes else None)
        return protection.ProtectedTensor(
            enc=_sds(es, torch.uint8), checks=checks,
            scale=_sds((), torch.float32), scheme_id=lp.scheme_id,
            orig_shape=tuple(lp.shape))
    return tree.map_with_path(one, abstract)


def _cache_struct(cfg, b, s, kvp) -> dict:
    cache = kvcache.init_cache(cfg, b, s, kv_policy=kvp, device="meta")
    return tree.map_with_path(lambda _, t: _sds(t.shape, t.dtype), cache)


def decode_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *, fsdp=None,
                decode_per_step=True, decode_at_use=None, with_flags=False,
                policy=None, plan=None, abstract=None, act_quant=None,
                kv_policy=None, backend="torch"):
    """Protected-serving decode cell (one new token, a cache of seq_len).

    Plan-driven: ``plan`` (or ``policy``, materialized here) decides scheme
    and backend per leaf and supplies the encoded tree's specs, flat-padded
    images' 1-D specs included. ``decode_at_use`` (default: follows
    ``decode_per_step``) picks the decode-at-use step; False the
    whole-tree ablation. ``with_flags`` adds the per-layer (corrected, DUE)
    rows as a third (replicated) output. ``act_quant`` serves the int8
    path; ``kv_policy`` the paged protected KV cache. ``backend`` is the
    step's route ("cuda": the kernels, each on its shard). The logits'
    out-spec shards the batch over 'data' only when the real data-axis
    size divides it. The step runs with no sharding context, as the
    reference traces it."""
    kvp = kvcache.get_kv_policy(kv_policy)
    if plan is None:
        plan, abstract = serving_plan(cfg, mesh, fsdp=fsdp, policy=policy)
    elif abstract is None:
        abstract = lm.param_shapes(cfg)
    b, s = shape.global_batch, shape.seq_len
    enc = encoded_struct(plan, abstract)
    cache = _cache_struct(cfg, b, s, kvp)
    tokens = _sds((b, 1), torch.int32)
    pos = _sds((b,), torch.int32)

    espec = plan.spec_tree(enc)   # the plan sanitized against the mesh
    cspec = _sanitize(sh.cache_specs(cache), cache, mesh)
    tspec, posspec = _sanitize((P("data", None), P("data")), (tokens, pos),
                               mesh)

    step = _bound(protected.make_serve_step(
        cfg, plan=plan, decode_per_step=decode_per_step,
        decode_at_use=decode_at_use, with_flags=with_flags,
        act_quant=act_quant, kv_policy=kvp, backend=backend), None)
    data_size = sh.mesh_sizes(mesh).get("data", 1)
    in_sh = (espec, cspec, tspec, posspec)
    lspec = (P("data", None, "model") if b % data_size == 0
             else P(None, None, "model"))
    out_sh = (lspec, cspec, P()) if with_flags else (lspec, cspec)
    return step, (enc, cache, tokens, pos), in_sh, out_sh


def prefill_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *, fsdp=None,
                 chunk=2048, sp=None, decode_at_use=True, with_flags=False,
                 policy=None, plan=None, abstract=None, act_quant=None,
                 backend="torch"):
    """Protected-serving prefill cell: full-sequence forward -> logits.

    ``sp`` auto: off when head-sharded attention can engage (n_heads
    divides the model axis) or for attention-free archs; on otherwise, as
    the reference chooses. The step runs under the cell's sharding
    context."""
    if fsdp is None:
        fsdp = _serving_fsdp_auto(cfg, mesh)
    sizes = sh.mesh_sizes(mesh)
    if sp is None:
        heads_ok = cfg.n_heads and cfg.n_heads % sizes["model"] == 0
        sp = not (heads_ok or cfg.family == "ssm")
    dp = ("pod", "data") if "pod" in sizes else "data"
    ctx = {"dp": dp, "model": "model", "sp": sp,
           "model_size": sizes["model"], "mesh": _device_mesh(mesh)}
    b, s = shape.global_batch, shape.seq_len
    if plan is None:
        plan, abstract = serving_plan(cfg, mesh, fsdp=fsdp, policy=policy)
    elif abstract is None:
        abstract = lm.param_shapes(cfg)
    enc = encoded_struct(plan, abstract)
    tokens = _sds((b, s), torch.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["prefix_embeds"] = _sds((b, cfg.n_patches, cfg.d_model),
                                       torch.bfloat16)
    if cfg.family == "encdec":
        extras["enc_embeds"] = _sds((b, cfg.enc_seq, cfg.d_model),
                                    torch.bfloat16)

    espec = plan.spec_tree(enc)
    tspec = _sanitize(P(dp, None), tokens, mesh)
    xspec = _sanitize({k: sh.batch_spec(k, v, dp=dp)
                       for k, v in extras.items()}, extras, mesh)

    prefill = protected.make_prefill(cfg, plan=plan, chunk=chunk,
                                     decode_at_use=decode_at_use,
                                     with_flags=with_flags,
                                     act_quant=act_quant, backend=backend)

    def step(enc_params, tokens, extras):
        return prefill(enc_params, tokens, extras)

    step = _bound(step, ctx)
    in_sh = (espec, tspec, xspec)
    s_out = s + (cfg.n_patches if cfg.family == "vlm" else 0)
    lspec = _sanitize(P(dp, None, "model"),
                      _sds((b, s_out, cfg.vocab_padded), torch.bfloat16),
                      mesh)
    out_sh = (lspec, P()) if with_flags else lspec
    return step, (enc, tokens, extras), in_sh, out_sh


def cell(cfg: ArchConfig, shape: ShapeConfig, mesh, **kw):
    if shape.kind == "train":
        return train_cell(cfg, shape, mesh,
                          **{k: v for k, v in kw.items()
                             if k not in ("policy", "plan", "abstract",
                                          "decode_at_use", "with_flags",
                                          "act_quant")})
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh, **kw)
    return decode_cell(cfg, shape, mesh,
                       **{k: v for k, v in kw.items()
                          if k in ("fsdp", "decode_per_step", "decode_at_use",
                                   "with_flags", "policy", "plan",
                                   "abstract", "act_quant", "kv_policy",
                                   "backend")})


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (O(S^2) " \
                      "attention / O(S) KV cache at 524k is not deployable)"
    return True, ""


# ---------------------------------------------------------------------------
# running a cell
# ---------------------------------------------------------------------------


def place(values, specs, mesh):
    """Place every tensor of ``values`` as a DTensor by the spec tree
    ``specs`` (prefix specs allowed); a ``ProtectedTensor`` takes its
    spec's fields; leaves that are DTensors already, and non-tensors,
    pass through."""
    from torch.distributed.tensor import DTensor

    def one(spec, leaf):
        if isinstance(leaf, DTensor) or spec is None:
            return leaf
        if protection.is_protected_tensor(leaf):
            if not protection.is_protected_tensor(spec):
                spec = protection.ProtectedTensor(
                    enc=spec, checks=None if leaf.checks is None else P(),
                    scale=P(), scheme_id=leaf.scheme_id,
                    orig_shape=leaf.orig_shape)
            return sh.distribute_tree({"x": leaf}, {"x": spec}, mesh)["x"]
        if isinstance(leaf, torch.Tensor):
            return sh.distribute(leaf, spec, mesh)
        return leaf
    return sh.map_specs(one, specs, values)


def lay_out(values, specs, mesh):
    """Redistribute every DTensor output to its out-spec; a plain tensor
    output (flags counted over the mesh already) becomes a replicated
    DTensor."""
    from repro_torch.distributed import local

    def one(spec, leaf):
        if not isinstance(leaf, torch.Tensor) or spec is None:
            return leaf
        d = local.as_dtensor(leaf, mesh)
        return d.redistribute(mesh, sh.to_placements(spec, mesh))
    return sh.map_specs(one, specs, values)


def sharded(step, mesh, in_specs, out_specs):
    """``step`` over DTensors: inputs placed by ``in_specs`` (values that
    are DTensors already pass through), plain tensors made inside the step
    replicated implicitly, outputs laid out by ``out_specs``."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        args = place(tuple(args), tuple(in_specs), mesh)
        with implicit_replication():
            out = step(*args)
            return lay_out(out, out_specs, mesh)
    return run


def materialize(args, *, seed: int = 0, device="cpu", fake: bool = False):
    """Shape records -> tensors: seeded normals for floats (std 0.02),
    zeros for integers and ``ProtectedTensor`` fields, or uninitialized
    fake tensors under the caller's ``FakeTensorMode`` (``fake``)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)

    def make(sds):
        if sds is None:
            return None
        if fake or not sds.dtype.is_floating_point:
            return torch.zeros(sds.shape, dtype=sds.dtype, device=device) \
                if not fake else torch.empty(sds.shape, dtype=sds.dtype,
                                             device=device)
        return (torch.randn(sds.shape, generator=gen) * 0.02).to(
            device=device, dtype=sds.dtype)

    def one(_, leaf):
        if protection.is_protected_tensor(leaf):
            return dataclasses.replace(
                leaf, enc=make(leaf.enc), checks=make(leaf.checks),
                scale=make(leaf.scale) if not fake else
                torch.ones((), device=device))
        if isinstance(leaf, ShapeDtype):
            return make(leaf)
        return leaf
    return tree.map_with_path(one, args)

"""The reference's sharded cases of ``test_torch_distributed.py``, run in a
subprocess with 8 host devices (``XLA_FLAGS`` must be set before JAX
starts): ``python tests/torch_dist_ref.py IN.npz OUT_PREFIX``.

Reads the shared inputs, writes ``OUT_PREFIX.npz`` (arrays) and
``OUT_PREFIX.json`` (specs). The cells are those of
``torch_dist_cases.py`` (its ``TRAINS``, ``DECODES`` and ``GUARDS``).
Meshes are built with ``AxisType.Auto``: this tree's JAX makes Explicit
axes by default, on which the reference's ``with_sharding_constraint``
raises.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402


def nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def flat(tree, prefix: str) -> dict:
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def mesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))


def faulted(enc, data):
    """The (abstract) encoded tree with the test's faulted images, checks
    and scales in place, and its raw leaves' weights."""
    import dataclasses

    from repro.protection.tensor import is_protected_tensor

    def one(path, pt):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        if not is_protected_tensor(pt):   # a raw leaf: the weight itself
            return jnp.asarray(data["qwen/" + name], pt.dtype)
        name = "qenc/" + name
        return dataclasses.replace(
            pt, enc=jnp.asarray(data[name + "#enc"]),
            checks=(None if pt.checks is None
                    else jnp.asarray(data[name + "#checks"])),
            scale=jnp.asarray(data[name + "#scale"]))
    return jax.tree_util.tree_map_with_path(one, enc,
                                            is_leaf=is_protected_tensor)


def main(inp: str, out: str):
    from jax.experimental.shard_map import shard_map

    from repro import configs, protection
    from repro.distributed.pipeline import make_pipeline_fn
    from repro.launch import specs as S
    from repro.models.config import ShapeConfig
    from repro.serving import kvcache
    from repro.training import optim
    from repro.training.compress import compressed_psum
    from torch_dist_cases import DECODES, TRAINS, decode_key, train_key

    data = dict(np.load(inp))
    arrays, specs = {}, {}

    # the sharded QATT step (tests/test_distributed.py's body, Auto mesh)
    cfg = configs.get_smoke("minitron-4b").with_(microbatch=2)
    m24 = mesh((2, 4), ("data", "model"))
    as_named = lambda t: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(m24, s) if isinstance(s, P) else s,
        t, is_leaf=lambda x: isinstance(x, P))
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "targets": jnp.asarray(data["targets"])}
    for fsdp in TRAINS:
        step, args, in_sh, out_sh = S.train_cell(
            cfg, ShapeConfig("t", 32, 8, "train"), m24, chunk=16, fsdp=fsdp)
        params = jax.tree.map(jnp.asarray, nest(data, "params/"))
        with m24:
            f = jax.jit(step, in_shardings=as_named(in_sh),
                        out_shardings=as_named(out_sh))
            p2, o2, loss = f(params, optim.sgd_init(params), batch)
        arrays.update(flat(p2, train_key(fsdp) + "_masters/"))
        arrays[train_key(fsdp) + "_loss"] = np.asarray(loss)

    # compressed_psum over 8 ranks (tests/test_distributed.py's input)
    m8 = mesh((8,), ("data",))
    g = jnp.asarray(data["psum_g"])

    def body(g, r):
        from repro.core import quant
        mean, nr = compressed_psum(g[0], r[0], "data")
        t = g[0] + r[0]
        scale = jax.lax.pmax(quant.compute_scale(t), "data")
        q = jnp.clip(jnp.round(t / scale), -quant.QMAX,
                     quant.QMAX).astype(jnp.int8)
        return mean[None], nr[None], q[None]

    with m8:
        mean, nr, q = shard_map(body, mesh=m8,
                                in_specs=(P("data"), P("data")),
                                out_specs=(P("data"),) * 3)(
            g, jnp.zeros_like(g))
    arrays.update(psum_mean=np.asarray(mean), psum_res=np.asarray(nr),
                  psum_q=np.asarray(q))

    # GPipe over 4 stages (tests/test_distributed.py's shapes)
    m4 = mesh((4,), ("stage",))
    pipe = make_pipeline_fn(lambda w, x: jnp.tanh(x @ w), 4, 8, m4, "stage")
    with m4:
        arrays["pipe"] = np.asarray(pipe(jnp.asarray(data["pipe_ws"]),
                                         jnp.asarray(data["pipe_xs"])))

    # the decode cells (tests/test_distributed.py:170-198's), two steps
    # over the faulted images
    qcfg = configs.get_smoke("qwen1.5-4b")
    policy = protection.get_policy_preset("attn-inplace-mlp-secded")
    qparams = jax.tree.map(jnp.asarray, nest(data, "qwen/"))
    for b, kv, fsdp in DECODES:
        key = decode_key(b, kv, fsdp)
        plan, abstract = S.serving_plan(qcfg, m24, policy=policy, fsdp=fsdp)
        step, _, in_sh, out_sh = S.decode_cell(
            qcfg, ShapeConfig("d", 64, b, "decode"), m24, plan=plan,
            abstract=abstract, with_flags=True, kv_policy=kv)
        specs[key] = [
            [list(e) if isinstance(e, tuple) else e for e in tuple(s)]
            for s in jax.tree.leaves(out_sh[:2],
                                     is_leaf=lambda x: isinstance(x, P))]
        # every field is the test's, so the encoding is traced only
        enc = faulted(jax.eval_shape(plan.encode_tree, qparams), data)
        cache = kvcache.init_cache(qcfg, b, 64, kv_policy=kv)
        tokens = jnp.asarray(data[f"dec_tokens_{b}"])
        with m24:
            f = jax.jit(step, in_shardings=as_named(in_sh),
                        out_shardings=as_named(out_sh))
            for t in range(2):
                logits, cache, flags = f(enc, cache, tokens[:, t:t + 1],
                                         jnp.full((b,), t, jnp.int32))
        arrays[key + "/logits"] = np.asarray(logits.astype(jnp.float32))
        for k, v in flags.items():
            arrays[key + f"/flags/{k}"] = np.asarray(v)
    guarded(data, arrays)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(specs, f)


def guarded(data, arrays):
    """The guarded decode cells of ``torch_dist_cases.GUARDS`` (int8 at
    use; ABFT with clamps), two steps each over the faulted images, f32
    activations."""
    from repro import configs, protection
    from repro.launch import specs as S
    from repro.models import lm
    from repro.models.config import ShapeConfig
    from repro.serving import kvcache, protected
    from torch_dist_cases import GUARDS, guard_cell, guard_key

    qcfg = configs.get_smoke("qwen1.5-4b")
    policy = protection.get_policy_preset("attn-inplace-mlp-secded")
    qparams = jax.tree.map(jnp.asarray, nest(data, "qwen/"))
    m24 = mesh((2, 4), ("data", "model"))
    as_named = lambda t: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(m24, s) if isinstance(s, P) else s,
        t, is_leaf=lambda x: isinstance(x, P))
    shape = ShapeConfig("d", 64, 8, "decode")
    for mode in GUARDS:
        key = guard_key(mode)
        plan, abstract = S.serving_plan(qcfg, m24, policy=policy)
        plan, step, in_sh, out_sh = guard_cell(
            S, protected, qcfg, plan, shape, m24, mode, jnp.float32,
            abstract=abstract)
        lm.set_sharding_ctx(None)
        enc = faulted(jax.eval_shape(plan.encode_tree, qparams), data)
        cache = kvcache.init_cache(qcfg, 8, 64, dtype=jnp.float32)
        tokens = jnp.asarray(data["dec_tokens_8"])
        with m24:
            f = jax.jit(step, in_shardings=as_named(in_sh),
                        out_shardings=as_named(out_sh))
            for t in range(2):
                logits, cache, flags = f(enc, cache, tokens[:, t:t + 1],
                                         jnp.full((8,), t, jnp.int32))
        arrays[key + "/logits"] = np.asarray(logits.astype(jnp.float32))
        for k, v in flags.items():
            arrays[key + f"/flags/{k}"] = np.asarray(v)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

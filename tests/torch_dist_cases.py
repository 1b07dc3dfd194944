"""The port's sharded cases of ``test_torch_distributed.py``: every rank of
one gloo process group (8 ranks on the CPU, a ``FileStore``) runs them all,
so torch is imported once per rank; rank 0 pickles the results.

The train and decode cases also run the port's unsharded step on the same
inputs, so the test holds the sharded result to it and to the reference's
sharded result (``torch_dist_ref.py``, which runs the same cells).
"""
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8
# (batch, KV preset, fsdp) of the decode cells; fsdp None: the 5 GiB rule
# (off at smoke size)
DECODES = [(8, None, None), (8, "in-place", None), (3, None, None),
           (3, "in-place", None), (8, "in-place", True), (3, None, True)]
# fsdp of the train cells
TRAINS = [None, True]
# the guarded decode cells (batch 8, the faulted images): "int8" dynamic
# per-token activation quantization at use, "guarded" every matmul leaf
# with ABFT and a clamp of GUARD_CLAMP
GUARDS = ["int8", "guarded"]
GUARD_CLAMP = 0.35


def guard_key(mode) -> str:
    return f"decode_8_{mode}"


def decode_key(b, kv, fsdp) -> str:
    return f"decode_{b}_{kv}" + ("_fsdp" if fsdp else "")


def train_key(fsdp) -> str:
    return "train" + ("_fsdp" if fsdp else "")


def _nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def _flat(tree_, prefix: str) -> dict:
    from repro_torch import tree
    return {prefix + tree.path_str(p): v.detach().cpu().numpy()
            for p, v in tree.leaves_with_path(tree_)}


def _spec_leaves(specs) -> list:
    """A spec tree's specs in JAX's leaf order (dict keys sorted), each as a
    list of entries."""
    from repro_torch.distributed.sharding import P
    if isinstance(specs, P):
        return [[list(e) if isinstance(e, tuple) else e for e in specs]]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [s for x in specs for s in _spec_leaves(x)]


def _full(x):
    from repro_torch.distributed import local
    return x.full_tensor() if local.is_dtensor(x) else x


def case_train(data, res, mesh):
    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models.config import ShapeConfig
    from repro_torch.training import optim, train
    cfg = configs.get_smoke("minitron-4b").with_(microbatch=2)
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "targets")}
    for fsdp in TRAINS:
        key = train_key(fsdp)
        step, _, in_sh, out_sh = S.train_cell(
            cfg, ShapeConfig("t", 32, 8, "train"), mesh, chunk=16, fsdp=fsdp)
        params = _nest(data, "params/")
        p2, _, loss = S.sharded(step, mesh, in_sh, out_sh)(
            params, optim.sgd_init(params), batch)
        res[key + "_loss"] = float(loss.full_tensor())
        res.update(_flat(sh.local_tree(p2), key + "_masters/"))
        res[key + "_wq_placements"] = str(
            p2["layers"]["attn"]["wq"].placements)
    if dist.get_rank() == 0:   # the cell's microbatching: 8 // (2 * 8) -> 1
        p1 = _nest(data, "params/")
        u1, _, uloss = train.make_train_step(cfg.with_(microbatch=1),
                                             chunk=16)(
            p1, optim.sgd_init(p1), batch)
        res["train_loss_unsharded"] = float(uloss)
        res.update(_flat(u1, "train_unsharded/"))


def _faulted(enc, data):
    """The port's encoded tree with the reference's faulted images
    (``qenc/<path>#enc|checks|scale``) in place of its own."""
    import dataclasses

    from repro_torch import protection, tree

    def one(path, pt):
        if not protection.is_protected_tensor(pt):
            return pt
        name = "qenc/" + tree.path_str(path)
        img = torch.from_numpy(data[name + "#enc"])
        checks = (torch.from_numpy(data[name + "#checks"])
                  if pt.checks is not None else None)
        assert img.shape == pt.enc.shape and img.dtype == pt.enc.dtype, name
        assert (checks is None) == (name + "#checks" not in data), name
        return dataclasses.replace(
            pt, enc=img, checks=checks,
            scale=torch.from_numpy(np.array(data[name + "#scale"])))
    return tree.map_with_path(one, enc)


def case_decode(data, res, mesh):
    from repro_torch import configs, protection, tree
    from repro_torch.launch import specs as S
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving import kvcache
    cfg = configs.get_smoke("qwen1.5-4b")
    policy = protection.get_policy_preset("attn-inplace-mlp-secded")
    params = _nest(data, "qwen/")
    for b, kv, fsdp in DECODES:
        key = decode_key(b, kv, fsdp)
        shape = ShapeConfig("d", 64, b, "decode")
        plan, _ = S.serving_plan(cfg, mesh, policy=policy, fsdp=fsdp)
        step, _, in_sh, out_sh = S.decode_cell(
            cfg, shape, mesh, plan=plan, with_flags=True, kv_policy=kv)
        res[key + "/out_specs"] = _spec_leaves(out_sh[:2])
        enc = _faulted(plan.encode_tree(params), data)
        placed = S.place((enc,), (in_sh[0],), mesh)[0]
        cache = kvcache.init_cache(cfg, b, 64, kv_policy=kv, device="cpu")
        unsharded = tree.map_with_path(lambda _, t: t.clone(), cache)
        tokens = torch.from_numpy(data[f"dec_tokens_{b}"])
        run = S.sharded(step, mesh, in_sh, out_sh)
        for t in range(2):   # two steps: the second reads the first's K/V
            pos = torch.full((b,), t, dtype=torch.int32)
            logits, cache, flags = run(placed, cache, tokens[:, t:t + 1],
                                       pos)
            if fsdp is None:
                u_logits, unsharded, u_flags = step(
                    enc, unsharded, tokens[:, t:t + 1], pos)
        res[key + "/logits"] = _full(logits).float().numpy()
        res[key + "/logits_placements"] = str(logits.placements)
        res[key + "/wq_enc_placements"] = str(
            placed["layers"]["attn"]["wq"].enc.placements)
        for k, v in flags.items():
            res[key + f"/flags/{k}"] = _full(v).numpy()
        if fsdp is None:
            res[key + "/logits_unsharded"] = u_logits.float().numpy()
            for k, v in u_flags.items():
                res[key + f"/flags_unsharded/{k}"] = v.numpy()


def guard_cell(S, protected, cfg, plan, shape, mesh, mode, dtype, **kw):
    """The guarded decode cell of ``mode`` in either package (``S`` its
    ``launch.specs``, ``protected`` its ``serving.protected``): the cell's
    in and out specs, and its serve step with f32 activations ``dtype``
    -> (plan, step, in_sh, out_sh)."""
    aq = {}
    if mode == "int8":
        aq["act_quant"] = "dynamic"
    else:
        plan = plan.with_abft(True, clamps={p: GUARD_CLAMP
                                            for p in plan.leaves})
    _, _, in_sh, out_sh = S.decode_cell(cfg, shape, mesh, plan=plan,
                                        with_flags=True, **aq, **kw)
    step = protected.make_serve_step(cfg, plan=plan, with_flags=True,
                                     dtype=dtype, **aq)
    return plan, step, in_sh, out_sh


def case_guarded(data, res, mesh):
    """The int8 and the guarded decode cells: two sharded steps over the
    faulted images, beside the unsharded step on the same inputs."""
    from repro_torch import configs, protection, tree
    from repro_torch.launch import specs as S
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving import kvcache, protected
    cfg = configs.get_smoke("qwen1.5-4b")
    policy = protection.get_policy_preset("attn-inplace-mlp-secded")
    params = _nest(data, "qwen/")
    shape = ShapeConfig("d", 64, 8, "decode")
    for mode in GUARDS:
        key = guard_key(mode)
        plan, _ = S.serving_plan(cfg, mesh, policy=policy)
        plan, step, in_sh, out_sh = guard_cell(
            S, protected, cfg, plan, shape, mesh, mode, torch.float32)
        step = S._bound(step, None)
        enc = _faulted(plan.encode_tree(params), data)
        placed = S.place((enc,), (in_sh[0],), mesh)[0]
        cache = kvcache.init_cache(cfg, 8, 64, dtype=torch.float32,
                                   device="cpu")
        unsharded = tree.map_with_path(lambda _, t: t.clone(), cache)
        tokens = torch.from_numpy(data["dec_tokens_8"])
        run = S.sharded(step, mesh, in_sh, out_sh)
        for t in range(2):
            pos = torch.full((8,), t, dtype=torch.int32)
            logits, cache, flags = run(placed, cache, tokens[:, t:t + 1],
                                       pos)
            u_logits, unsharded, u_flags = step(enc, unsharded,
                                                tokens[:, t:t + 1], pos)
        res[key + "/logits"] = _full(logits).float().numpy()
        res[key + "/logits_unsharded"] = u_logits.float().numpy()
        for k, v in flags.items():
            res[key + f"/flags/{k}"] = _full(v).numpy()
        for k, v in u_flags.items():
            res[key + f"/flags_unsharded/{k}"] = v.numpy()


# the sharded_matmul cases: (parallel rule's spec, act_quant, abft, clamp,
# per-slot rows) over a (64, 128) in-place image and an (8, 1, 64) input
# split over 'data'
MATMULS = [(spec, aq, abft, clamp, per_slot)
           for spec in (("model", None), (None, "model"), (None, None))
           for aq, abft, clamp, per_slot in (
               (None, True, 0.05, False), ("dynamic", False, None, False),
               ("dynamic", True, 0.5, False), ("static", False, 1.0, False),
               (None, True, 0.05, True), ("dynamic", True, 0.5, True))]


def matmul_key(i) -> str:
    return f"matmul_{i}"


def case_matmuls(data, res, mesh):
    """``ProtectedWeight.matmul`` over a sharded image under each case of
    ``MATMULS`` against the same view over the whole image: outputs and
    every count."""
    from repro_torch import protection
    from repro_torch.distributed import sharding as sh
    from repro_torch.protection.fused import ProtectedWeight
    w = torch.from_numpy(data["mm_w"])
    x = torch.from_numpy(data["mm_x"]).to(torch.bfloat16)
    pt = protection.ProtectionPolicy(default_scheme="in-place").encode_leaf(
        w, "in-place")
    img = pt.enc.clone()
    img.view(-1)[::997] ^= 1      # single flips: corrected, counted once
    pt = dataclasses.replace(pt, enc=img)
    xd = sh.distribute(x, sh.P("data", None, None), mesh)
    for i, (spec, aq, abft, clamp, per_slot) in enumerate(MATMULS):
        outs = {}
        for name, leaf, arg in (
                ("whole", pt, x),
                ("sharded", dataclasses.replace(
                    pt, enc=sh.distribute(pt.enc, sh.P(*spec), mesh)), xd)):
            got = {"flags": [], "abft": []}
            view = ProtectedWeight(
                leaf, "torch", act_quant=aq, abft=abft, clamp=clamp,
                a_scale=0.02 if aq == "static" else None,
                record=lambda c, d, g=got: g["flags"].append((int(c),
                                                              int(d))),
                record_abft=lambda m, h, g=got: g["abft"].append(
                    (_full(m).numpy().copy(), _full(h).numpy().copy())),
                abft_per_slot=per_slot)
            y = view.matmul(arg)
            outs[name] = (_full(y).float().numpy(), got)
        res[matmul_key(i)] = outs


def case_collectives(data, res, mesh):
    """A master whose shards have different absmaxes: the throttle (both
    routes' plain version on the CPU) and the scale must be the global
    ones."""
    from repro_torch.core import quant, wot
    from repro_torch.distributed import sharding as sh
    w = torch.from_numpy(data["absmax_w"])
    d = sh.distribute(w.clone(), sh.P("data", "model"), mesh)
    res["shard_absmax"] = float(d.to_local().abs().max())
    res["scale_sharded"] = float(quant.compute_scale(d).full_tensor())
    res["scale_whole"] = float(quant.compute_scale(w))
    wot.throttle_tensor_(d)
    res["throttle_sharded"] = d.full_tensor().numpy()
    res["throttle_whole"] = wot.throttle_tensor(w).numpy()


def case_pipeline(data, res):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import make_pipeline_fn
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "stage"))
    ws = torch.from_numpy(data["pipe_ws"])
    xs = torch.from_numpy(data["pipe_xs"])
    pipe = make_pipeline_fn(lambda w, x: torch.tanh(x @ w), 4, 8, mesh,
                            "stage")
    res["pipe"] = pipe(ws, xs).numpy()
    seq = xs
    for s in range(4):
        seq = torch.tanh(seq @ ws[s])
    res["pipe_sequential"] = seq.numpy()


def case_psum(data, res):
    from repro_torch.training.compress import compressed_psum
    g = torch.from_numpy(data["psum_g"])[dist.get_rank()]
    mean, nr, q = compressed_psum(g, torch.zeros_like(g), dist.group.WORLD,
                                  with_payload=True)
    got = [torch.empty_like(t) for t in (mean, nr, q) for _ in range(WORLD)]
    for i, t in enumerate((mean, nr, q)):
        dist.all_gather(got[i * WORLD:(i + 1) * WORLD], t.contiguous())
    res["psum_mean"] = torch.stack(got[:WORLD]).numpy()
    res["psum_res"] = torch.stack(got[WORLD:2 * WORLD]).numpy()
    res["psum_q"] = torch.stack(got[2 * WORLD:]).numpy()


def case_restore(data, res, tmp):
    """A protected checkpoint restored onto a 2x2 mesh (ranks 0-3) equals
    the unsharded restore."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import lm
    from repro_torch.training import checkpoint, optim
    cfg = configs.get_smoke("qwen1.5-4b")
    params = _nest(data, "qwen/")
    state = (params, optim.sgd_init(params))
    path = os.path.join(tmp, "ckpt")
    if dist.get_rank() == 0:
        checkpoint.save(path, state, step=3, protected=True, device="cpu")
    dist.barrier()
    m22 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("data", "model"))
    if m22.get_coordinate() is not None:
        pspec = sh.param_specs(lm.param_shapes(cfg))
        got, step = checkpoint.restore(path, state, device="cpu",
                                       shardings=(pspec, optim.SgdState(
                                           pspec)), mesh=m22)
        whole, _ = checkpoint.restore(path, state, device="cpu")
        if dist.get_rank() == 0:
            res["restore_step"] = step
            res["restore_sharded"] = {**_flat(sh.local_tree(got[0]), "p/"),
                                      **_flat(sh.local_tree(got[1]), "m/")}
            res["restore_whole"] = {**_flat(whole[0], "p/"),
                                    **_flat(whole[1], "m/")}
            res["restore_placements"] = str(got[0]["layers"]["attn"]["wq"]
                                            .placements)
        else:
            sh.local_tree(got[0]), sh.local_tree(got[1])
    dist.barrier()


def run_rank(rank: int, store: str, inp: str, out: str, tmp: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    from repro_torch.launch.mesh import make_production_mesh
    data = dict(np.load(inp))
    res: dict = {}
    mesh = make_production_mesh(shape=(2, 4), device="cpu")
    case_train(data, res, mesh)
    case_decode(data, res, mesh)
    case_guarded(data, res, mesh)
    case_matmuls(data, res, mesh)
    case_collectives(data, res, mesh)
    case_pipeline(data, res)
    case_psum(data, res)
    case_restore(data, res, tmp)
    dist.barrier()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()

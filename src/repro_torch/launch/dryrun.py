"""Multi-pod dry-run: trace every (arch x shape x mesh) cell as one rank of
the production mesh, with nothing allocated.

Counterpart of ``repro.launch.dryrun``, with its CLI flags and its record
keys. The reference AOT-compiles each cell's jitted step for 512
placeholder host devices and reads XLA's ``memory_analysis`` and
``cost_analysis`` plus the parsed HLO. The port has no compiler to ask:
it starts a fake process group (backend ``"fake"``) at the mesh's world
size, builds the production ``DeviceMesh`` over it, places the cell's
arguments as DTensors of fake tensors (``FakeTensorMode``: nothing is
allocated), runs the sharded step once as rank 0 on the plain ``torch``
route (the stand-in for the reference's XLA route; a kernel cannot run on
fake tensors, so none is launched), and counts that rank's work
(``launch.op_analysis``).

What differs from XLA's fields:

* ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes`` are
  the rank's local shard bytes of the step's arguments and outputs;
  ``alias_size_in_bytes`` the bytes of the arguments the step updates in
  place (the reference's donated buffers: the cache of a decode cell, the
  masters and momentum of a train cell); there is no temporary size and
  no generated code, so ``peak_memory_in_bytes`` is absent and
  ``hbm_bytes`` is the live-set estimate args + outputs - aliases, the
  reference's host-backend formula without its temporaries;
* ``cost``: ``{"flops", "bytes accessed"}`` from the op analysis (the
  rank's local FLOPs and buffer bytes), where XLA's cost analysis counts
  loop bodies once;
* ``hlo_flops``, ``hlo_buffer_bytes`` and ``collectives`` keep their keys
  and come from the op analysis of the rank's run; ``lower_s`` is the
  seconds to build and place the cell, ``compile_s`` the seconds of the
  traced run; ``--save-hlo`` writes the rank's collective trace
  (``CommDebugMode``'s table) instead of HLO text.

Usage:
  python -m repro_torch.launch.dryrun --device cpu --arch phi3-medium-14b \\
      --shape train_4k
  python -m repro_torch.launch.dryrun --device cpu --all [--multi-pod]
  python -m repro_torch.launch.dryrun --device cpu --smoke --arch \\
      deepseek-7b --shape decode_32k --policy attn-inplace-mlp-secded \\
      --mesh 2x4 --devices 8
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback


def _mesh_name(multi_pod: bool, mesh_shape) -> str:
    if mesh_shape is not None:
        return "x".join(str(s) for s in mesh_shape)
    return "2x16x16" if multi_pod else "16x16"


def _mesh_dims(multi_pod: bool, mesh_shape) -> tuple:
    if mesh_shape is not None:
        return tuple(int(s) for s in mesh_shape)
    return (2, 16, 16) if multi_pod else (16, 16)


def _peak_bytes(mem: dict):
    """Per-rank live-set estimate: args + outputs - aliases (no
    temporaries are known); XLA's own peak where a record carries it."""
    if "peak_memory_in_bytes" in mem:
        return mem["peak_memory_in_bytes"]
    if "argument_size_in_bytes" not in mem:
        return None
    return (mem.get("argument_size_in_bytes", 0) +
            mem.get("output_size_in_bytes", 0) +
            mem.get("temp_size_in_bytes", 0) -
            mem.get("alias_size_in_bytes", 0))


def _plan_record(plan) -> dict:
    """The JSONL protection block: per-scheme stored bytes + totals."""
    s = plan.summary()
    return {"protected_bytes": s["protected_bytes"],
            "unprotected_bytes": s["unprotected_bytes"],
            "weight_bytes": s["weight_bytes"],
            "check_bytes": s["check_bytes"],
            "pad_bytes": s["pad_bytes"],
            "by_scheme": {sid: d["stored_bytes"]
                          for sid, d in s["by_scheme"].items()},
            "by_backend": s["by_backend"],
            "n_flat_sharded": s["n_flat_sharded"]}


def _local_bytes(tree_) -> int:
    """Bytes of every tensor of a tree on this rank (a DTensor's local
    shard; a ``ProtectedTensor``'s image, checks and scale)."""
    import torch

    from repro_torch import protection, tree
    from repro_torch.distributed import local

    def one(t):
        if not isinstance(t, torch.Tensor):
            return 0
        t = t.to_local() if local.is_dtensor(t) else t
        return t.numel() * t.element_size()

    total = 0
    for _, leaf in tree.leaves_with_path(tree_):
        if protection.is_protected_tensor(leaf):
            total += one(leaf.enc) + one(leaf.checks) + one(leaf.scale)
        else:
            total += one(leaf)
    return total


def _fake_world(n: int) -> bool:
    """Start a fake process group of ``n`` ranks (this process is rank 0)
    unless one is running -> whether this call started it."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is running; the mesh needs {n}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return True


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, fsdp=None,
             sp=True, decode_per_step=True, decode_at_use=None, chunk=2048,
             save_hlo: str | None = None, microbatch=None,
             policy: str | None = None, smoke: bool = False, layers=None,
             with_flags=None, mesh_shape=None, act_quant: str | None = None,
             baseline: dict | None = None, kv_policy: str | None = None,
             device=None) -> dict:
    """Trace one cell as rank 0 of its mesh and return its JSONL record.

    The arguments are the reference's (``policy``, ``decode_at_use``,
    ``act_quant``, ``layers``, ``baseline``, ``kv_policy`` as documented
    there); ``device`` (default ``"cuda"``, raising without a GPU unless
    ``"cpu"`` is asked for) is where the fake tensors say they live."""
    import torch.distributed as dist

    from repro_torch import configs, protection
    from repro_torch import device as device_mod
    from repro_torch.launch import op_analysis, specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import SHAPES

    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": _mesh_name(multi_pod, mesh_shape), "fsdp": fsdp, "sp": sp,
           "smoke": smoke}
    serving = shape.kind != "train"
    if kv_policy is not None and shape.kind != "decode":
        kv_policy = None  # the paged cache is decode-step state
    if decode_at_use is None:
        decode_at_use = decode_per_step
    if shape.kind == "decode" and not decode_per_step:
        decode_at_use = False  # decode-once baseline: weights arrive decoded
    if act_quant and not (serving and decode_at_use):
        act_quant = None  # int8 activations ride the at-use serving path only
    if serving:
        rec["decode_mode"] = (
            "at-use-int8" if act_quant else
            "at-use" if decode_at_use else
            "per-step" if (decode_per_step or shape.kind == "prefill")
            else "once")
        if act_quant:
            rec["act_quant"] = act_quant
    if policy and serving:
        rec["policy"] = policy
    ok, why = specs.cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return _tag_cell(rec)
    dev = device_mod.resolve(device)
    t0 = time.time()
    own = False
    try:
        dims = _mesh_dims(multi_pod, mesh_shape)
        own = _fake_world(math.prod(dims))
        mesh = make_production_mesh(multi_pod=multi_pod, shape=dims,
                                    device=dev)
        kw = ({"decode_per_step": decode_per_step} if shape.kind == "decode"
              else {"chunk": chunk})
        if serving:
            kw["decode_at_use"] = decode_at_use
            if act_quant:
                kw["act_quant"] = act_quant
        if shape.kind == "train" and microbatch is not None:
            kw["microbatch"] = microbatch
        if shape.kind == "train":
            kw["sp"] = sp  # prefill uses its own default (sp off)
        if policy and serving:
            pol = protection.get_policy_preset(policy)
            plan, abstract = specs.serving_plan(cfg, mesh, fsdp=fsdp,
                                                policy=pol)
            flags = decode_at_use if with_flags is None else with_flags
            kw.update(plan=plan, abstract=abstract, with_flags=flags)
            rec["protection"] = _plan_record(plan)
            rec["protection"]["flags_output"] = bool(flags)
        if kv_policy:
            from repro_torch.serving import kvcache
            kvp = kvcache.get_kv_policy(kv_policy)
            kw["kv_policy"] = kvp
            rec["kv_policy"] = kv_policy
            b_, s_ = shape.global_batch, shape.seq_len
            cache_abs = kvcache.init_paged_cache(cfg, b_, s_, kvp,
                                                 device="meta")
            rec["kv"] = {**kvcache.kv_bytes(cache_abs),
                         "dense_bytes": kvcache.dense_kv_bytes(cfg, b_, s_),
                         "scheme": kvp.scheme, "fused": kvp.fused,
                         "page_size": kvp.page_size}
        step, args, in_sh, out_sh = specs.cell(cfg, shape, mesh, fsdp=fsdp,
                                               **kw)
        # the state a step updates in place (the reference donates it)
        donate = (0, 1) if shape.kind == "train" else \
            ((1,) if shape.kind == "decode" else ())
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True):
            vals = specs.place(specs.materialize(args, device=dev,
                                                 fake=True),
                               tuple(in_sh), mesh)
            t_lower = time.time() - t0
            out, stats = op_analysis.compute_stats(
                specs.sharded(step, mesh, in_sh, out_sh), *vals,
                trace=save_hlo)
            t_run = time.time() - t0 - t_lower
            arg_b = _local_bytes(vals)
            out_b = _local_bytes(out)
            alias_b = sum(_local_bytes(vals[i]) for i in donate)
        rec.update(
            status="ok", lower_s=round(t_lower, 1),
            compile_s=round(t_run, 1),
            memory={"argument_size_in_bytes": int(arg_b),
                    "output_size_in_bytes": int(out_b),
                    "alias_size_in_bytes": int(alias_b)},
            cost={"flops": stats["flops"],
                  "bytes accessed": stats["buffer_bytes"]},
            hlo_flops=stats["flops"], hlo_buffer_bytes=stats["buffer_bytes"],
            collectives={"total_wire_bytes": stats["total_wire_bytes"],
                         **stats["collectives"]},
            n_devices=int(math.prod(dims)),
        )
        rec["hbm_bytes"] = _peak_bytes(rec["memory"])
        if baseline and baseline.get("status") == "ok":
            base_peak = _peak_bytes(baseline.get("memory", {}))
            if rec["hbm_bytes"] is not None and base_peak is not None:
                rec["hbm_delta_bytes"] = rec["hbm_bytes"] - base_peak
            rec["wire_delta_bytes"] = (
                rec["collectives"]["total_wire_bytes"] -
                baseline.get("collectives", {}).get("total_wire_bytes", 0))
            rec["baseline_policy"] = baseline.get("policy")
        del out, vals
    except Exception as e:  # noqa: BLE001 - recorded, as the reference does
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:],
                   elapsed_s=round(time.time() - t0, 1))
    finally:
        if own:
            dist.destroy_process_group()
    return _tag_cell(rec)


def _tag_cell(rec: dict) -> dict:
    """Stamp the record with its unique grid coordinate (one string key to
    group on)."""
    parts = [rec["arch"], rec["shape"], rec["mesh"]]
    for axis in ("policy", "decode_mode", "act_quant", "kv_policy"):
        if rec.get(axis):
            parts.append(f"{axis}={rec[axis]}")
    rec["cell"] = ":".join(parts)
    return rec


def _parse_mesh(s: str | None):
    if not s:
        return None
    return tuple(int(d) for d in s.lower().split("x"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--fsdp", choices=["auto", "on", "off"], default="auto")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--no-decode-per-step", action="store_true")
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--save-hlo", default=None,
                    help="write the traced rank's collective table here "
                         "(the port has no HLO)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's smoke config (CI-sized grids)")
    ap.add_argument("--layers", type=int, default=None,
                    help="override n_layers (depth scaling for the "
                         "decoded-tree accounting at smoke scale)")
    ap.add_argument("--serve-modes", default="at-use,per-step",
                    help="comma list of decode modes traced per policy "
                         "serving cell (at-use | per-step)")
    ap.add_argument("--act-quant", action="store_true",
                    help="also trace an int8 activation-quantized at-use "
                         "cell per policy serving cell (decode_mode "
                         "'at-use-int8', dynamic per-token scales), diffed "
                         "against the float at-use cell")
    ap.add_argument("--mesh", default=None, metavar="DxM[xP]",
                    help="override mesh dims, e.g. 2x4 (data x model)")
    ap.add_argument("--devices", type=int, default=512,
                    help="ranks of the fake process group (the mesh's own "
                         "size when --mesh is given)")
    ap.add_argument("--policy", default=None,
                    help="comma-separated protection presets to sweep over "
                         "serving cells (each diffed vs the 'unprotected' "
                         "baseline cell)")
    ap.add_argument("--kv-policy", default=None,
                    help="comma-separated KV protection presets (see "
                         "repro_torch.serving.kvcache.KV_POLICY_PRESETS) "
                         "swept over decode cells; protected-KV cells diff "
                         "their live bytes vs the 'unprotected' paged cell "
                         "of the same (cell, policy, mode)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded ok in --out")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live (default cuda; the "
                         "CPU only when asked for)")
    args = ap.parse_args(argv)

    from repro_torch import configs, protection
    from repro_torch import device as device_mod
    from repro_torch.models.config import SHAPES
    from repro_torch.serving import kvcache

    device_mod.resolve(args.device)
    mesh_shape = _parse_mesh(args.mesh)
    if mesh_shape is not None and math.prod(mesh_shape) != args.devices \
            and args.devices != 512:
        ap.error(f"--mesh {args.mesh} has {math.prod(mesh_shape)} ranks, "
                 f"--devices says {args.devices}")
    policies = [p.strip() for p in args.policy.split(",") if p.strip()] \
        if args.policy else []
    for p in policies:
        if p not in protection.POLICY_PRESETS:
            ap.error(f"unknown policy preset {p!r}; one of "
                     f"{sorted(protection.POLICY_PRESETS)}")
    kv_policies = [p.strip() for p in args.kv_policy.split(",") if p.strip()] \
        if args.kv_policy else []
    for p in kv_policies:
        if p not in kvcache.KV_POLICY_PRESETS:
            ap.error(f"unknown kv policy preset {p!r}; one of "
                     f"{sorted(kvcache.KV_POLICY_PRESETS)}")
    # the unprotected paged cell is every protected-KV cell's baseline
    kv_policies.sort(key=lambda p: p != "unprotected")

    cells = []
    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    modes = [m.strip() for m in args.serve_modes.split(",") if m.strip()]
    for m in modes:
        if m not in ("at-use", "per-step"):
            ap.error(f"unknown serve mode {m!r}; one of at-use, per-step")
    if args.act_quant:
        if args.no_decode_per_step:
            ap.error("--act-quant needs the decode-at-use serving path; "
                     "drop --no-decode-per-step")
        modes.append("at-use-int8")
    if args.no_decode_per_step:
        modes = [None]  # decode-once baseline: the mode axis is meaningless

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    prev = {}  # resumed records, so delta baselines survive --resume
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    key = (r["arch"], r["shape"], r["mesh"], r.get("policy"),
                           r.get("decode_mode"), r.get("kv_policy"))
                    done.add(key)
                    prev[key] = r

    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]
    common = dict(fsdp=fsdp, sp=not args.no_sp,
                  decode_per_step=not args.no_decode_per_step,
                  chunk=args.chunk, save_hlo=args.save_hlo,
                  microbatch=args.microbatch, smoke=args.smoke,
                  layers=args.layers, mesh_shape=mesh_shape,
                  device=args.device)

    def emit(rec):
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        status = rec["status"]
        extra = rec.get("reason") or rec.get("error", "")
        flops = rec.get("cost", {}).get("flops", 0)
        deltas = ""
        if "wire_delta_bytes" in rec:
            deltas = (f" dHBM={rec.get('hbm_delta_bytes', 0):+.3g}B "
                      f"dwire={rec['wire_delta_bytes']:+.3g}B")
        print(f"  -> {status} flops={flops:.3g} "
              f"coll={rec.get('collectives', {}).get('total_wire_bytes', 0):.3g}B"
              f"{deltas} {extra[:120]}", flush=True)

    for a, s, mp in cells:
        mesh_name = _mesh_name(mp, mesh_shape)
        serving = SHAPES[s].kind != "train"
        cell_policies = policies if (policies and serving) else [None]
        cell_modes = modes if (policies and serving) else [None]
        cell_kvs = kv_policies if (kv_policies
                                   and SHAPES[s].kind == "decode") else [None]
        baseline = None
        base_mode = ("at-use" if not args.no_decode_per_step else
                     "per-step" if SHAPES[s].kind == "prefill" else "once")
        if cell_policies != [None] and any(p != "unprotected"
                                           for p in cell_policies):
            # the delta baseline: same cell, int8 storage, zero checks,
            # decode-at-use
            bkey = (a, s, mesh_name, "unprotected", base_mode, None)
            if bkey in done:
                baseline = prev.get(bkey)
            else:
                print(f"[cell] {a} {s} {mesh_name} policy=unprotected "
                      f"(baseline) ...", flush=True)
                baseline = run_cell(a, s, mp, policy="unprotected", **common)
                emit(baseline)
                done.add(bkey)
                prev[bkey] = baseline
        for pol in cell_policies:
            for mode in cell_modes:
                for kvp in cell_kvs:
                    key_mode = mode if mode is not None else \
                        (base_mode if serving else None)
                    if (pol == "unprotected" and baseline is not None
                            and mode == base_mode and kvp is None):
                        continue  # already emitted as the baseline
                    if (a, s, mesh_name, pol, key_mode, kvp) in done:
                        print(f"[skip-done] {a} {s} {mesh_name} {pol or ''} "
                              f"{key_mode or ''} {kvp or ''}", flush=True)
                        continue
                    print(f"[cell] {a} {s} {mesh_name}"
                          f"{f' policy={pol}' if pol else ''}"
                          f"{f' mode={mode}' if mode else ''}"
                          f"{f' kv={kvp}' if kvp else ''} ...", flush=True)
                    kw = dict(common)
                    if mode is not None:
                        kw["decode_at_use"] = mode != "per-step"
                        if mode == "at-use-int8":
                            kw["act_quant"] = "dynamic"
                    rec = run_cell(a, s, mp, policy=pol, baseline=baseline,
                                   kv_policy=kvp, **kw)
                    if mode == "at-use-int8":
                        _diff_float_at_use(rec, prev.get(
                            (a, s, mesh_name, pol, "at-use", kvp)))
                    if (kvp not in (None, "unprotected")
                            and rec.get("status") == "ok"):
                        _diff_unprotected_kv(rec, prev.get(
                            (a, s, mesh_name, pol, key_mode, "unprotected")))
                    emit(rec)
                    if rec.get("status") in ("ok", "skipped"):
                        done.add((a, s, mesh_name, pol, key_mode, kvp))
                        prev[(a, s, mesh_name, pol, key_mode, kvp)] = rec


def _diff_float_at_use(rec: dict, frec) -> None:
    """The int8 cell's deltas against the float at-use cell of the same
    (cell, policy); null where that cell is missing."""
    if rec.get("status") != "ok":
        return
    deltas = {"hbm_delta_bytes": None, "wire_delta_bytes": None}
    if frec and frec.get("status") == "ok":
        fpeak = _peak_bytes(frec.get("memory", {}))
        peak = _peak_bytes(rec.get("memory", {}))
        if None not in (peak, fpeak):
            deltas["hbm_delta_bytes"] = peak - fpeak
        fwire = frec.get("collectives", {}).get("total_wire_bytes")
        if fwire is not None:
            deltas["wire_delta_bytes"] = (
                rec["collectives"]["total_wire_bytes"] - fwire)
    rec["vs_float_at_use"] = deltas


def _diff_unprotected_kv(rec: dict, trec) -> None:
    """A protected-KV cell's live-bytes delta against the unprotected paged
    cell of the same (cell, policy, mode)."""
    kv_delta = {"hbm_delta_bytes": None, "hbm_ratio": None}
    if trec and trec.get("status") == "ok":
        tpeak = _peak_bytes(trec.get("memory", {}))
        peak = _peak_bytes(rec.get("memory", {}))
        if None not in (peak, tpeak) and tpeak:
            kv_delta["hbm_delta_bytes"] = peak - tpeak
            kv_delta["hbm_ratio"] = (peak - tpeak) / tpeak
    rec["kv_vs_unprotected"] = kv_delta


if __name__ == "__main__":
    main()

"""Burst-load serving benchmark: seeded request waves through the
continuous-batching front-end, priced against twins.

Counterpart of the reference's ``benchmarks/burst_sim.py``: replays one
deterministic wave workload (``serving.frontend.make_waves``) through the
request front-end under each KV policy and fault rate of a grid, and
writes per cell ``telemetry_<tag>.jsonl`` and ``requests_<tag>.csv``, and
a ``summary.json`` with the per-cell roll-ups and three comparisons:

* ``slo``: each protected KV policy's p99 per-token latency against the
  unprotected twin at the same fault rate;
* ``scrub_slo`` (``--scrub-every N``): every cell runs twice, without and
  with the budgeted self-healing slice (``--repair`` adds MILR repair;
  ``--weight-fault-rate`` faults the weights of the faulted scrub twins),
  which ends in a full at-rest pass; priced against its own baseline,
  with the residual DUE state;
* ``abft_slo`` (``--abft``): a checksum-guarded twin of every no-scrub
  cell against its unguarded baseline.

  PYTHONPATH=src python -m repro_torch.benchmarks.burst_sim --device cpu \\
      --smoke [--kv-policies unprotected,in-place] [--fault-rates 0,1e-3] \\
      [--scrub-every 1 --repair --weight-fault-rate 1e-3] [--abft] \\
      [--out-dir DIR]

Every cell runs three times: the first warms up, the two measured runs
double as the bit-determinism check and each latency percentile takes the
smaller of the pair. The port's fault streams are torch generators seeded
from ``--seed`` and the step, so its injected bits are not the
reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.models import lm
from repro_torch.protection import plan as plan_mod
from repro_torch.serving import frontend, kvcache, protected, telemetry


def _cell_tag(policy: str, rate: float, scrub_every: int = 0,
              abft: bool = False) -> str:
    tag = f"{policy}_r{rate:g}"
    if scrub_every:
        tag = f"{tag}_scrub{scrub_every}"
    return f"{tag}_abft" if abft else tag


def run_grid(cfg, enc, plan, waves, *, kv_policies, fault_rates, slots,
             max_len, n_pages, seed, out_dir=None, prefix_sharing=False,
             scrub_every=0, repair=False, weight_fault_rate=0.0,
             abft_plan=None, backend=None, device=None, log=print):
    """(KV policy x fault rate) grid over one workload -> ``{tag: {"summary",
    "results"}}``. ``scrub_every > 0`` adds a self-healing twin of every
    cell (tag ``_scrubN``; with ``repair`` a MILR kit; its faulted cells
    also take ``weight_fault_rate`` on the weights); ``abft_plan`` adds a
    guarded twin of every no-scrub cell (tag ``_abft``)."""
    dev = device_mod.resolve(device)
    backend = backend or device_mod.default_backend(dev)
    cells = {}
    for pol_name in kv_policies:
        kvp = dataclasses.replace(kvcache.get_kv_policy(pol_name),
                                  per_slot_flags=True)
        steps = {False: protected.make_serve_step(
            cfg, plan=plan, backend=backend, kv_policy=kvp)}
        if abft_plan is not None:
            steps[True] = protected.make_serve_step(
                cfg, plan=abft_plan, backend=backend, kv_policy=kvp)
        for rate in fault_rates:
            variants = [(s, False)
                        for s in ([0, scrub_every] if scrub_every else [0])]
            if abft_plan is not None:
                variants.append((0, True))
            for scrub, abft_on in variants:
                tag = _cell_tag(pol_name, rate, scrub, abft_on)
                tpath = (os.path.join(out_dir, f"telemetry_{tag}.jsonl")
                         if out_dir else None)
                kw = dict(plan=abft_plan if abft_on else plan, waves=waves,
                          slots=slots, max_len=max_len, n_pages=n_pages,
                          kv_policy=kvp, fault_rate=rate, fault_seed=seed,
                          serve_step=steps[abft_on],
                          prefix_sharing=prefix_sharing, scrub_every=scrub,
                          repair=repair and scrub > 0,
                          # the rate-0 scrub twin stays fault-free, so it
                          # prices the scrub alone
                          weight_fault_rate=(weight_fault_rate
                                             if scrub and rate > 0 else 0.0),
                          backend=backend, device=dev)
                warm_ev, _, warm_res = frontend.run_burst(cfg, enc, **kw)
                ev_a, summ_a, res_a = frontend.run_burst(cfg, enc, **kw)
                events, summ, results = frontend.run_burst(
                    cfg, enc, telemetry_path=tpath, **kw)
                views = [telemetry.deterministic_view(e)
                         for e in (warm_ev, ev_a, events)]
                deterministic = (views[0] == views[1] == views[2]
                                 and warm_res == res_a == results)
                for sect in ("per_token_ms", "ttft_s"):
                    summ[sect] = {k: (min(v, summ_a[sect][k])
                                      if v is not None
                                      and summ_a[sect][k] is not None else v)
                                  for k, v in summ[sect].items()}
                summ["cell"] = {"kv_policy": pol_name, "fault_rate": rate,
                                "seed": seed, "slots": slots,
                                "max_len": max_len,
                                "prefix_sharing": prefix_sharing,
                                "scrub_every": scrub,
                                "repair": repair and scrub > 0,
                                "abft": abft_on,
                                "weight_fault_rate": kw["weight_fault_rate"],
                                "bit_deterministic": deterministic}
                if out_dir:
                    telemetry.write_requests_csv(
                        events, os.path.join(out_dir, f"requests_{tag}.csv"))
                cells[tag] = {"summary": summ, "results": results}
                p99 = summ["per_token_ms"]["p99"]
                heal = summ["healing"]
                log(f"[burst] {tag}: {summ['requests']['finished']}/"
                    f"{summ['requests']['submitted']} finished in "
                    f"{summ['steps']} steps, "
                    f"{summ['throughput']['tokens_per_step']:.2f} tok/step, "
                    f"p99 per-token "
                    + (f"{p99:.2f}ms" if p99 is not None else "n/a")
                    + f", DUE total {summ['due']['total']}, leaked pages "
                    f"{summ['pool']['leaked_pages']}"
                    + (f", scrub corrected w={heal['w_corrected']} "
                       f"kv={heal['kv_corrected']}, final DUE "
                       f"{heal['final_due']['w']}w/{heal['final_due']['kv']}kv"
                       if scrub and heal["final_due"] else ""))
    return cells


def _ratio(a, b):
    return a / b if (a and b) else None


def slo_section(cells, kv_policies, fault_rates):
    """Per (protected policy, rate): p99 per-token latency against the
    unprotected twin at that rate."""
    if "unprotected" not in kv_policies:
        return []
    rows = []
    for pol in kv_policies:
        if pol == "unprotected":
            continue
        for rate in fault_rates:
            base = cells[_cell_tag("unprotected", rate)]
            prot = cells[_cell_tag(pol, rate)]
            b99 = base["summary"]["per_token_ms"]["p99"]
            p99 = prot["summary"]["per_token_ms"]["p99"]
            rows.append({
                "kv_policy": pol, "fault_rate": rate,
                "p99_per_token_ms": p99,
                "unprotected_p99_per_token_ms": b99,
                "p99_ratio": _ratio(p99, b99),
                "due_total": prot["summary"]["due"]["total"],
                "leaked_pages": prot["summary"]["pool"]["leaked_pages"],
                "tokens_match_unprotected":
                    prot["results"] == base["results"] if rate == 0 else None})
    return rows


def scrub_slo_section(cells, kv_policies, fault_rates, scrub_every):
    """Per (policy, rate): the self-healing twin against its own no-scrub
    baseline, with the scrub totals and the residual at-rest DUE state."""
    rows = []
    if not scrub_every:
        return rows
    for pol in kv_policies:
        for rate in fault_rates:
            base = cells[_cell_tag(pol, rate)]
            twin = cells[_cell_tag(pol, rate, scrub_every)]
            b99 = base["summary"]["per_token_ms"]["p99"]
            s99 = twin["summary"]["per_token_ms"]["p99"]
            heal = twin["summary"]["healing"]
            rows.append({
                "kv_policy": pol, "fault_rate": rate,
                "scrub_every": scrub_every, "p99_per_token_ms": s99,
                "noscrub_p99_per_token_ms": b99,
                "p99_ratio": _ratio(s99, b99),
                "scrub_passes": heal["scrub_passes"],
                "w_corrected": heal["w_corrected"],
                "kv_corrected": heal["kv_corrected"],
                "final_due": heal["final_due"],
                "leaked_pages": twin["summary"]["pool"]["leaked_pages"],
                "tokens_match_noscrub": twin["results"] == base["results"]})
    return rows


def abft_slo_section(cells, kv_policies, fault_rates):
    """Per (policy, rate): the ABFT-guarded twin against its unguarded
    baseline, with its mismatch and clamp totals."""
    rows = []
    for pol in kv_policies:
        for rate in fault_rates:
            twin = cells.get(_cell_tag(pol, rate, abft=True))
            if twin is None:
                continue
            base = cells[_cell_tag(pol, rate)]
            summ = twin["summary"]
            b99 = base["summary"]["per_token_ms"]["p99"]
            a99 = summ["per_token_ms"]["p99"]
            rows.append({
                "kv_policy": pol, "fault_rate": rate,
                "p99_per_token_ms": a99, "noabft_p99_per_token_ms": b99,
                "p99_ratio": _ratio(a99, b99),
                "abft_mismatches": summ["abft"]["mismatches_total"],
                "clamp_hits": summ["abft"]["clamp_hits_total"],
                "leaked_pages": summ["pool"]["leaked_pages"],
                "bit_deterministic": summ["cell"]["bit_deterministic"],
                "tokens_match_noabft": twin["results"] == base["results"]})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-7b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the micro-run: 2 waves x 3 requests on 2 slots")
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--wave-size", type=int, default=6)
    ap.add_argument("--gap-steps", type=int, default=8)
    ap.add_argument("--prompt-len", default="4,12",
                    help="lo,hi prompt-length range (the per-request "
                         "suffix with --shared-prefix-len)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="one common prefix of this many tokens on every "
                         "prompt, served with the prefix cache")
    ap.add_argument("--max-new", default="4,8")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--pages", type=int, default=None,
                    help="pool size with the parking pages (default: full "
                         "occupancy)")
    ap.add_argument("--kv-policies", default="unprotected,in-place")
    ap.add_argument("--fault-rates", default="0",
                    help="comma list of per-bit KV fault rates")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="all-in-place",
                    choices=sorted(plan_mod.POLICY_PRESETS),
                    help="weight-protection preset")
    ap.add_argument("--scrub-every", type=int, default=0,
                    help="run a self-healing twin of every cell, scrubbing "
                         "every N steps, plus the at-rest pass")
    ap.add_argument("--repair", action="store_true",
                    help="attach a MILR repair kit to the scrub twins")
    ap.add_argument("--weight-fault-rate", type=float, default=0.0,
                    help="per-bit weight fault rate of the faulted scrub "
                         "twins, on the KV injection cadence")
    ap.add_argument("--abft", action="store_true",
                    help="run an ABFT-guarded twin of every no-scrub cell")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--backend", default=None, choices=("torch", "cuda"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    if args.smoke:
        args.waves, args.wave_size, args.gap_steps = 2, 3, 4
        args.slots, args.max_len = 2, 16
        args.prompt_len, args.max_new = "3,6", "2,4"
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    dev = device_mod.resolve(args.device)
    backend = args.backend or device_mod.default_backend(dev)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.load_all()
    cfg = configs.get_smoke(args.arch)
    kv_policies = args.kv_policies.split(",")
    fault_rates = [float(r) for r in args.fault_rates.split(",")]
    p_lo, p_hi = (int(x) for x in args.prompt_len.split(","))
    n_lo, n_hi = (int(x) for x in args.max_new.split(","))
    print(f"[burst] {cfg.name} smoke config, {args.waves} waves x "
          f"{args.wave_size} reqs, slots={args.slots}, kv={kv_policies}, "
          f"rates={fault_rates}, seed={args.seed}, backend={backend}, "
          f"device={dev}")
    plan = plan_mod.get_policy_preset(args.policy, backend=backend).plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, args.seed, device=dev, leaf_fn=plan.encode_leaf)
    sharing = args.shared_prefix_len > 0
    waves = frontend.make_waves(
        seed=args.seed, n_waves=args.waves, wave_size=args.wave_size,
        vocab=cfg.vocab, prompt_len=(p_lo, p_hi), max_new=(n_lo, n_hi),
        gap_steps=args.gap_steps, shared_prefix_len=args.shared_prefix_len)
    with torch.no_grad():
        cells = run_grid(
            cfg, enc, plan, waves, kv_policies=kv_policies,
            fault_rates=fault_rates, slots=args.slots, max_len=args.max_len,
            n_pages=args.pages, seed=args.seed, out_dir=args.out_dir,
            prefix_sharing=sharing, scrub_every=args.scrub_every,
            repair=args.repair, weight_fault_rate=args.weight_fault_rate,
            abft_plan=plan.with_abft() if args.abft else None,
            backend=backend, device=dev)
    out = {
        "schema": telemetry.SUMMARY_SCHEMA, "arch": cfg.name,
        "workload": {"seed": args.seed, "waves": args.waves,
                     "wave_size": args.wave_size,
                     "gap_steps": args.gap_steps,
                     "prompt_len": [p_lo, p_hi], "max_new": [n_lo, n_hi],
                     "shared_prefix_len": args.shared_prefix_len,
                     "prefix_sharing": sharing,
                     "scrub_every": args.scrub_every, "repair": args.repair,
                     "weight_fault_rate": args.weight_fault_rate,
                     "abft": args.abft},
        "cells": {tag: c["summary"] for tag, c in cells.items()},
        "slo": slo_section(cells, kv_policies, fault_rates),
        "scrub_slo": scrub_slo_section(cells, kv_policies, fault_rates,
                                       args.scrub_every),
        "abft_slo": abft_slo_section(cells, kv_policies, fault_rates),
    }
    for row in out["scrub_slo"]:
        fd = row["final_due"]
        print(f"[burst] scrub SLO {row['kv_policy']} @rate "
              f"{row['fault_rate']}: p99 ratio {row['p99_ratio']} vs "
              f"no-scrub" + (f", final DUE {fd['w']}w/{fd['kv']}kv"
                             if fd else ""))
    if args.out_dir:
        path = os.path.join(args.out_dir, "summary.json")
        telemetry.write_summary(out, path)
        print(f"[burst] wrote {path}")
    return out


if __name__ == "__main__":
    main()

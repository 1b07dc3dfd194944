"""Paper Table 2: accuracy drop under memory faults, per protection scheme.

Counterpart of the reference's ``benchmarks/fault_injection.py``:
{faulty, parity-zero, secded72, in-place} x fault rates {1e-6..1e-3} (+ an
amplified 3e-3 row where small-model effects show), several trials, on
CNNs the port trains with WOT. Each (model, scheme) encodes once and runs
its (trial x rate) grid through ``repro_torch.protection.run_campaign``;
``--policy`` adds one row under a mixed-scheme preset
(``protection.POLICY_PRESETS``); ``--compute`` adds the ABFT compute-fault
coverage rows.

  PYTHONPATH=src python -m repro_torch.benchmarks.fault_injection \\
      --device cpu --trials 2 [--models resnet18 vgg16] [--batch scan|vmap] \\
      [--scale 0.25 --img 32] [--json PATH] [--policy PRESET] [--compute]

On the card (the default ``--device cuda``) the codecs run as the CUDA
kernels. The output lines are the reference's: ``#`` comment lines, then
one ``table2_<model>_<scheme>,<us>,ovh=..._drops=...`` line per row.
``--json`` writes every ``CampaignResult`` to the given path.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import device as device_mod
from repro_torch import protection
from repro_torch.protection import campaign
from repro_torch.training.cnn_experiments import (eval_policy,
                                                  run_scheme_campaign,
                                                  train_cnn_wot)

RATES = (1e-6, 1e-5, 1e-4, 1e-3, 3e-3)
SCHEMES = ("faulty", "parity-zero", "secded72", "in-place")


def run(models=("resnet18",), trials=5, rates=RATES, verbose=True,
        batch="scan", json_path=None, policy=None, compute=False,
        device=None, scale=0.25, img=32, pre_steps=80, wot_steps=40):
    """Table 2 of ``models``, trained at ``scale``/``img`` on ``device``.
    ``policy`` (a ``protection.POLICY_PRESETS`` name) adds one row
    ``policy:<name>`` under that mixed-scheme preset, over every >= 2-D
    leaf as the scheme rows. ``compute`` adds the COMPUTE-fault rows
    (``compute_campaign``, targets ``acc`` and ``wdec``): ABFT detection
    coverage, not accuracy drop.
    -> ``{(model, row): (space overhead, row, clean)}``."""
    dev = device_mod.resolve(device)
    rows = list(SCHEMES) + ([f"policy:{policy}"] if policy else [])
    results, campaigns = {}, {}
    for name in models:
        params, fwd, tmpl = train_cnn_wot(name, pre_steps=pre_steps,
                                          wot_steps=wot_steps, scale=scale,
                                          img=img, device=dev)
        for i, scheme in enumerate(SCHEMES):
            res = run_scheme_campaign(params, fwd, tmpl, scheme, rates=rates,
                                      trials=trials, batch=batch, key=i,
                                      img=img, device=dev)
            campaigns[(name, scheme)] = res
            results[(name, scheme)] = (res.space_overhead, res.row(),
                                       res.clean)
        if policy:
            pol = protection.get_policy_preset(
                policy, predicate=lambda p, l: getattr(l, "ndim", 0) >= 2,
                backend=device_mod.default_backend(dev))
            res = run_scheme_campaign(params, fwd, tmpl, None, policy=pol,
                                      rates=rates, trials=trials, batch=batch,
                                      key=len(SCHEMES), img=img, device=dev)
            campaigns[(name, rows[-1])] = res
            results[(name, rows[-1])] = (res.space_overhead, res.row(),
                                         res.clean)
        if compute:
            # per-element rates over the probe surface: a CNN's matmul
            # leaves are its small fc layers, so the memory grid's rates
            # would inject next to nothing
            for j, tgt in enumerate(("acc", "wdec")):
                campaigns[(name, f"compute:{tgt}")] = \
                    campaign.compute_campaign(
                        params, rates=(1e-3, 1e-2, 1e-1), trials=trials,
                        batch=batch, key=100 + j, target=tgt, probe_m=64,
                        device=dev)
        if verbose:
            _report(name, params, campaigns, rates, compute, rows)
    if json_path:
        with open(json_path, "w") as f:
            json.dump({f"{m}/{s}": c.to_dict()
                       for (m, s), c in campaigns.items()}, f, indent=2)
        if verbose:
            print(f"# wrote {json_path}")
    return results


def _report(name, params, campaigns, rates, compute, rows):
    clean = campaigns[(name, SCHEMES[0])].clean
    report = protection.coverage(params, eval_policy("in-place"))
    print(f"# {name}: clean int8+WOT accuracy {clean:.3f}")
    print("# " + report.summary().replace("\n", "\n# "))
    mine = [c for (m, _), c in campaigns.items() if m == name]
    first = campaigns[(name, SCHEMES[0])]
    print(f"# campaign [{first.platform}/{first.batch}, {first.device}]: "
          f"{len(SCHEMES)} warm-ups {sum(c.compile_s for c in mine):.1f}s, "
          f"full grid sweep {sum(c.wall_clock_s for c in mine):.2f}s")
    print(f"# {'scheme':11s} {'ovh%':5s} " +
          " ".join(f"{r:>13.0e}" for r in rates))
    for scheme in rows:
        res = campaigns[(name, scheme)]
        cells = " ".join(f"{d * 100:6.2f}±{s * 100:4.1f}"
                         for d, s in res.row())
        print(f"# {scheme:11s} {res.space_overhead * 100:4.1f}%  {cells}")
    if compute:
        for tgt in ("acc", "wdec"):
            res = campaigns[(name, f"compute:{tgt}")]
            cov = " ".join(f"{r:.0e}:{m * 100:6.2f}%"
                           for r, m in zip(res.rates, res.mean()))
            print(f"# abft-coverage target={tgt}: {cov}  (checksum false "
                  f"positives at rate 0: {res.clean:.0f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--models", nargs="+", default=["resnet18"])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--batch", default="scan", choices=("vmap", "scan"),
                    help="grid layout: scan runs one cell at a time, vmap "
                         "decodes each leaf's cells together")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write every CampaignResult here as JSON")
    ap.add_argument("--policy", default=None,
                    choices=sorted(protection.POLICY_PRESETS),
                    help="extra row under a mixed-scheme weight-protection "
                         "preset")
    ap.add_argument("--compute", action="store_true",
                    help="extra rows: ABFT detection coverage of injected "
                         "COMPUTE faults (accumulator and decoded-weight "
                         "corruption), per target")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="width multiplier of the CNNs (1.0: published)")
    ap.add_argument("--img", type=int, default=32,
                    help="input size (224: ImageNet's)")
    ap.add_argument("--pre-steps", type=int, default=80)
    ap.add_argument("--wot-steps", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    t0 = time.time()
    results = run(models=tuple(args.models), trials=args.trials,
                  batch=args.batch, json_path=args.json, policy=args.policy,
                  compute=args.compute, device=args.device, scale=args.scale,
                  img=args.img, pre_steps=args.pre_steps,
                  wot_steps=args.wot_steps)
    us = (time.time() - t0) * 1e6
    for (name, scheme), (ovh, row, clean) in results.items():
        drops = "/".join(f"{d * 100:.2f}" for d, _ in row)
        print(f"table2_{name}_{scheme},{us:.0f},ovh={ovh:.3f}_drops={drops}")
    return results


if __name__ == "__main__":
    main()

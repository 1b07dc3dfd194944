"""Roofline tables from the port's dry-run JSONL files.

Counterpart of the reference's ``benchmarks/report.py``: one Markdown
table per file, a row per ``ok`` cell (``roofline.analyze``). The port's
records carry no XLA peak memory (``launch.op_analysis`` counts no
temporaries), so the memory column is what the record does hold: a
rank's argument + output - aliased bytes (the dry-run's ``hbm_bytes``).

  PYTHONPATH=src python -m repro_torch.benchmarks.report [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from repro_torch import device as device_mod

from . import roofline

FILES = (("results/dryrun_16x16.jsonl",
          "Baseline, single-pod 16x16 (256 ranks)"),
         ("results/dryrun_2x16x16.jsonl",
          "Baseline, multi-pod 2x16x16 (512 ranks)"),
         ("results/dryrun_16x16_opt.jsonl",
          "Optimized, single-pod 16x16 (256 ranks)"),
         ("results/dryrun_2x16x16_opt.jsonl",
          "Optimized, multi-pod 2x16x16 (512 ranks)"))


def table(path: str, caption: str) -> str:
    rows = []
    skips = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r["status"] == "ok":
                a = roofline.analyze(r)
                a["_live"] = r["hbm_bytes"]
                rows.append(a)
            elif r["status"] == "skipped":
                skips.append((r["arch"], r["shape"]))
    rows.sort(key=lambda x: (x["arch"], x["shape"]))
    out = [f"**{caption}** ({len(rows)} cells ok, {len(skips)} skipped)\n"]
    out.append("| arch | shape | compute s | memory s | collective s | "
               "dominant | MODEL_FLOPS | useful | roofline frac | "
               "args+out-alias GB |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | {r['model_flops']:.2e} | "
            f"{r['useful_flops_ratio']:.3f} | {r['roofline_fraction']:.4f} | "
            f"{r['_live'] / 1e9:.1f} |")
    if skips:
        out.append("")
        out.append("Skipped (long_500k on pure full-attention archs): " +
                   ", ".join(f"{a}/{s}" for a, s in skips))
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the tables are computed "
                         "from the records alone")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)
    for path, cap in FILES:
        try:
            print(table(path, cap))
            print()
        except FileNotFoundError:
            pass


if __name__ == "__main__":
    main()

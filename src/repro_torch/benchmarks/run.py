"""Benchmark runner of the port: one function per paper table or figure.
Prints ``name,us_per_call,derived`` CSV rows (the reference's
``benchmarks/run.py`` over the port's modules).

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "route)")
    args = ap.parse_args(argv)
    from repro_torch import device as device_mod
    device_mod.resolve(args.device)

    from . import (fault_injection, kernel_bench, weight_distribution,
                   wot_admm_compare, wot_training)

    dev = ["--device", args.device]   # explicit argv: not run.py's own
    print("name,us_per_call,derived")
    kernel_bench.main(dev)
    weight_distribution.main(dev)
    wot_training.main(dev)
    fault_injection.main(dev)
    wot_admm_compare.main(dev)

    # roofline rows where a dry-run result file exists
    for path in ("results/dryrun_16x16.jsonl", "results/dryrun_2x16x16.jsonl"):
        if os.path.exists(path):
            from . import roofline
            roofline.main([path, *dev])


if __name__ == "__main__":
    main()

"""Paper Table 1 + Figure 1: weight distribution of 8-bit quantized CNNs.

Counterpart of the reference's ``benchmarks/weight_distribution.py``:
pretrains the paper's three CNNs (synthetic data, Adam standing in for
ImageNet pretraining) and reports (a) the % of |q| in [0,32) / [32,64) /
[64,128] (Table 1 'Percentage' rows), (b) the position histogram of large
values within 8-byte blocks (Figure 1) and (c) f32 against int8 accuracy
(Table 1 'Accuracy' rows).

  PYTHONPATH=src python -m repro_torch.benchmarks.weight_distribution \\
      --device cpu [--steps 100] [--scale 0.25 --img 32] [--json PATH]

Output lines are the reference's: ``table1_<model>,<us>,acc_f32=...``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import tree
from repro_torch.core import quant, wot
from repro_torch.training.cnn_experiments import accuracy, pretrain


@torch.no_grad()
def weight_stats(params):
    """-> (number of weights of >= 2-D leaves, Table-1 percentages, Fig-1
    position histogram)."""
    qs = [quant.quantize(leaf)[0].reshape(-1)
          for _, leaf in tree.leaves_with_path(params) if leaf.ndim >= 2]
    q = torch.cat(qs)
    hist = wot.large_position_histogram(q).cpu().numpy()
    return q.numel(), wot.range_percentages(q), hist


def run(steps=100, verbose=True, device=None, scale=0.25, img=32):
    dev = device_mod.resolve(device)
    rows = []
    for name in ("vgg16", "resnet18", "squeezenet"):
        t0 = time.time()
        params, fwd, tmpl = pretrain(name, steps=steps, scale=scale, img=img,
                                     device=dev)
        acc_f32 = accuracy(params, fwd, tmpl, quantized=False, img=img)
        acc_int8 = accuracy(params, fwd, tmpl, quantized=True, img=img)
        n, pct, hist = weight_stats(params)
        us = (time.time() - t0) * 1e6 / max(steps, 1)
        rows.append((name, us, n, acc_f32, acc_int8, pct, hist))
        if verbose:
            print(f"# {name}: {n} weights, acc f32={acc_f32:.3f} "
                  f"int8={acc_int8:.3f}")
            print(f"#   |q| pct (Table 1): {pct}")
            print(f"#   large-value position histogram (Fig 1): "
                  f"{np.asarray(hist).tolist()}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    rows = run(steps=args.steps, device=args.device, scale=args.scale,
               img=args.img)
    for name, us, n, a32, a8, pct, hist in rows:
        print(f"table1_{name},{us:.0f},"
              f"acc_f32={a32:.3f}_int8={a8:.3f}_small_pct="
              f"{pct['[0,32)'] + pct['[32,64)']:.2f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({name: {"us_per_step": us, "weights": n,
                              "acc_f32": a32, "acc_int8": a8, "pct": pct,
                              "large_position_hist": np.asarray(h).tolist()}
                       for name, us, n, a32, a8, pct, h in rows}, f, indent=2)
    return rows


if __name__ == "__main__":
    main()

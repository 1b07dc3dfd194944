"""Paper Figures 3 & 4: WOT/QATT convergence.

Counterpart of the reference's ``benchmarks/wot_training.py``. Tracks, per
WOT iteration: (a) the number of large values in protected positions
BEFORE throttling (Fig 3: falls toward 0) and (b) accuracy before against
after throttling (Fig 4: the gap closes, recovering the quantized
baseline). Fails if the WOT constraint does not hold at the end.

  PYTHONPATH=src python -m repro_torch.benchmarks.wot_training \\
      --device cpu [--pre-steps 100 --wot-steps 40] [--scale 0.25 --img 32] \\
      [--json PATH]

Output line is the reference's: ``fig3_fig4_wot,<us>,final_acc=...``.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import device as device_mod
from repro_torch.training.cnn_experiments import (accuracy, large_count,
                                                  pretrain, wot_finetune)


def run(name="resnet18", pre_steps=100, wot_steps=40, verbose=True,
        device=None, scale=0.25, img=32):
    dev = device_mod.resolve(device)
    params, fwd, tmpl = pretrain(name, steps=pre_steps, scale=scale, img=img,
                                 device=dev)
    acc_base = accuracy(params, fwd, tmpl, quantized=True, img=img)
    n_large0 = large_count(params)
    t0 = time.time()
    params, tmpl, curve = wot_finetune(params, fwd, tmpl, steps=wot_steps,
                                       img=img, track=True)
    us = (time.time() - t0) * 1e6 / max(wot_steps, 1)
    final_acc = accuracy(params, fwd, tmpl, quantized=True, img=img)
    if verbose:
        print(f"# {name} baseline int8 accuracy: {acc_base:.3f}, "
              f"initial large values: {n_large0}")
        print("# iter  large_before_throttle  acc_before  acc_after (Fig3/4)")
        for s, pre, a, b in curve:
            if a is not None:
                print(f"#  {s:3d}  {pre:6d}  {a:.3f}  {b:.3f}")
        print(f"# final WOT accuracy: {final_acc:.3f} "
              f"(baseline {acc_base:.3f})")
    if large_count(params) != 0:
        raise RuntimeError("WOT constraint violated after fine-tuning")
    return us, acc_base, final_acc, curve, n_large0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pre-steps", type=int, default=100)
    ap.add_argument("--wot-steps", type=int, default=40)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    us, acc_base, final_acc, curve, n0 = run(
        pre_steps=args.pre_steps, wot_steps=args.wot_steps,
        device=args.device, scale=args.scale, img=args.img)
    print(f"fig3_fig4_wot,{us:.0f},final_acc={final_acc:.3f}"
          f"_baseline={acc_base:.3f}_large_init={n0}_large_final=0")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"us_per_step": us, "acc_base": acc_base,
                       "final_acc": final_acc, "large_init": n0,
                       "curve": curve}, f, indent=2)
    return us, acc_base, final_acc, curve, n0


if __name__ == "__main__":
    main()

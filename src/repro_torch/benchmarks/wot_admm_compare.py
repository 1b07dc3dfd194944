"""Paper §4.1 comparison: ADMM-based WOT against QATT.

Counterpart of the reference's ``benchmarks/wot_admm_compare.py``. The
paper rejects ADMM because it "cannot help reduce the number of large
values in the first seven positions" and the final hard clamp costs
accuracy. Both start from the same pretrained model; it reports the
accuracies after each method (through the QAT fake-quant) and ADMM's
large-value count before its clamp.

  PYTHONPATH=src python -m repro_torch.benchmarks.wot_admm_compare \\
      --device cpu [--steps 25 --pre-steps 80] [--scale 0.25 --img 32] \\
      [--json PATH]

Output line is the reference's:
``admm_vs_qatt,<us>,qatt=..._admm=..._admm_residual_large=...``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import device as device_mod
from repro_torch.data import synthetic
from repro_torch.training import admm, train
from repro_torch.training.cnn_experiments import (_batch, _norm, accuracy,
                                                  large_count, pretrain,
                                                  wot_finetune)


def run(name="resnet18", steps=25, verbose=True, device=None, scale=0.25,
        img=32, pre_steps=80, backend=None, record=None):
    """-> ``(pretrained accuracy, QATT accuracy, ADMM accuracy, ADMM's
    large values before its clamp)``. ``backend`` is the throttle's
    route (default the device's). ``record``, a dict if given, receives
    the details: the large-value counts of the pretrained model, after
    QATT and after ADMM's clamp, ADMM's per-step count in ``W`` and in
    ``Z``, its losses, and the seconds of each method."""
    dev = device_mod.resolve(device)
    be = device_mod.default_backend(dev) if backend is None else backend
    params0, fwd, tmpl = pretrain(name, steps=pre_steps, scale=scale,
                                  img=img, device=dev)
    acc0 = accuracy(params0, fwd, tmpl, quantized=True, img=img)
    n0 = large_count(params0)

    # --- QATT (the paper's adopted method) ---
    t0 = time.time()
    p_qatt, tmpl, _ = wot_finetune(params0, fwd, tmpl, steps=steps, img=img,
                                   backend=be)
    qatt_s = time.time() - t0
    qatt_acc = accuracy(p_qatt, fwd, tmpl, quantized=True, img=img)
    qatt_large = large_count(p_qatt)

    # --- ADMM (the paper's rejected method) ---
    def loss_fn(p, batch):
        lg = fwd(p, _norm(batch["images"]), wt=train.qat_wt).to(
            torch.float32)
        tgt = lg.gather(-1, batch["labels"].long()[:, None])[:, 0]
        return (torch.logsumexp(lg, dim=-1) - tgt).mean()

    step = admm.make_admm_step(loss_fn, lr=1e-3, gamma=1e-3, backend=be)
    state = admm.admm_init(params0)
    p = params0
    curve, z_large, losses = [], [], []
    t0 = time.time()
    for s in range(steps):
        b, tmpl = synthetic.image_batch(4, 64, img, seed=0, step=2000 + s,
                                        templates=tmpl)
        p, state, loss = step(p, state, _batch(b, dev))
        curve.append(large_count(p))
        z_large.append(large_count(state.z))
        losses.append(float(loss))
    admm_large_pre = large_count(p)
    p_admm = admm.finalize(p, backend=be)  # lossy hard clamp (paper)
    admm_s = time.time() - t0
    admm_acc = accuracy(p_admm, fwd, tmpl, quantized=True, img=img)

    if verbose:
        print(f"# {name}: pretrain acc={acc0:.3f}, large values={n0}")
        print(f"# QATT : final acc={qatt_acc:.3f}, large-before-clamp ~0 "
              f"(post {qatt_large})")
        print(f"# ADMM : final acc={admm_acc:.3f}, large-before-clamp "
              f"{admm_large_pre} (trajectory {curve[::5]})")
    if record is not None:
        record.update(pretrain_large=n0, qatt_large=qatt_large,
                      admm_curve=curve, admm_z_large=z_large,
                      admm_losses=losses, admm_final_large=large_count(p_admm),
                      qatt_s=qatt_s, admm_s=admm_s)
    return acc0, qatt_acc, admm_acc, admm_large_pre


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--pre-steps", type=int, default=80)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    t0 = time.time()
    record: dict = {}
    acc0, qatt_acc, admm_acc, admm_large = run(
        steps=args.steps, device=args.device, scale=args.scale, img=args.img,
        pre_steps=args.pre_steps, record=record)
    print(f"admm_vs_qatt,{(time.time() - t0) * 1e6:.0f},"
          f"qatt={qatt_acc:.3f}_admm={admm_acc:.3f}"
          f"_admm_residual_large={admm_large}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"pretrain_acc": acc0, "qatt_acc": qatt_acc,
                       "admm_acc": admm_acc, "admm_residual_large": admm_large,
                       **record}, f, indent=2)
    return acc0, qatt_acc, admm_acc, admm_large


if __name__ == "__main__":
    main()

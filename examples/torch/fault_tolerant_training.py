"""Fault-tolerance demo of the PyTorch + CUDA port: training survives a
simulated node crash, and the recovered weights survive memory faults.

Trains with async ECC-protected checkpoints, "crashes" mid-run, then
resumes from the latest checkpoint — final params are bitwise-reproducible
vs an uninterrupted run (deterministic per-step data pipeline). The finale
runs an on-device fault campaign (``repro_torch.protection.
fidelity_campaign``) on the recovered weights: unprotected storage loses
weights at every rate, in-place zero-space ECC decodes ~everything back —
the whole rate sweep in one batched sweep (``batch="scan"`` keeps memory
flat at LM size).

The flow of ``examples/fault_tolerant_training.py``:

  PYTHONPATH=src python examples/torch/fault_tolerant_training.py \\
      [--device cpu]
"""
import argparse
import os
import pathlib
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch import configs, protection, tree  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training import checkpoint, optim, train  # noqa: E402

CKPT = os.path.join(tempfile.gettempdir(), "repro_ft_demo")


def _clone(state):
    return tree.map_with_path(lambda _, t: t.clone(), state)


def run(params, opt, step_fn, cfg, start, end, dev, ckpt_mgr=None, every=5):
    """Steps ``start``..``end`` - 1 (the train step updates ``params`` and
    ``opt`` in place)."""
    for s in range(start, end):
        b = synthetic.token_batch(cfg.vocab_padded, 4, 32, seed=0, step=s)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, opt, loss = step_fn(params, opt, b)
        if ckpt_mgr and (s + 1) % every == 0:
            ckpt_mgr.save((params, opt), s + 1)
    if ckpt_mgr:
        ckpt_mgr.wait()
    return params, opt, float(loss)


def main(argv=None, *, ckpt=CKPT, steps=20, crash=13):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    backend = device_mod.default_backend(dev)
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = configs.get_smoke("deepseek-7b").with_(microbatch=2)
    params0 = lm.init_params(cfg, 0, device=dev)
    opt0 = optim.sgd_init(params0)
    step_fn = train.make_train_step(cfg, lr=1e-3, chunk=16, backend=backend)

    print(f"[ft] uninterrupted run: {steps} steps")
    p_ref, _, _ = run(*_clone((params0, opt0)), step_fn, cfg, 0, steps, dev)

    print(f"[ft] run with checkpoints, crash at step {crash}")
    ck = checkpoint.AsyncCheckpointer(ckpt, protected=False, device=dev)
    p, o, _ = run(*_clone((params0, opt0)), step_fn, cfg, 0, crash, dev, ck,
                  every=5)
    del p, o  # "node failure": in-memory state lost

    last = checkpoint.latest_step(ckpt)
    print(f"[ft] resuming from checkpoint step {last}")
    (p, o), s0 = checkpoint.restore(ckpt, (params0, opt0), device=dev)
    p_resumed, _, _ = run(p, o, step_fn, cfg, s0, steps, dev)

    err = max(float((a - tree.get_path(p_resumed, path)).abs().max())
              for path, a in tree.leaves_with_path(p_ref))
    print(f"[ft] resumed-vs-uninterrupted max param diff: {err:.2e}")
    if err >= 1e-6:
        raise RuntimeError(f"the resumed run differs by {err:.2e}")
    print("[ft] crash-resume reproduces the uninterrupted run exactly")

    print("[ft] memory-fault campaign on the recovered weights "
          "(batched sweep, 2 trials/rate)")
    rates = (1e-5, 1e-4, 1e-3)
    fidelity = {}
    for scheme in ("faulty", "in-place"):
        res = protection.fidelity_campaign(
            p_resumed, scheme, rates=rates, trials=2, key=42, batch="scan",
            device=dev)
        fidelity[scheme] = res.mean()
        cells = "  ".join(f"{r:.0e}:{m * 100:7.3f}%"
                          for r, m in zip(res.rates, res.mean()))
        print(f"[ft] {scheme:9s} decode fidelity {cells} "
              f"(overhead {res.space_overhead * 100:.1f}%, "
              f"sweep {res.wall_clock_s:.2f}s)")
    if not (fidelity["in-place"][0] >= fidelity["faulty"][0]
            and fidelity["in-place"][-1] > 0.999):
        raise RuntimeError(f"in-place fidelity {fidelity['in-place']} "
                           f"against faulty {fidelity['faulty']}")
    print("[ft] in-place zero-space ECC keeps the recovered weights intact "
          "under memory faults")
    return err, fidelity


if __name__ == "__main__":
    main()

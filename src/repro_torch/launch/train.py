"""QATT training entry point: QAT with WOT throttling on synthetic tokens.

Counterpart of ``python -m repro.launch.train``: trains the smoke config of
an architecture with the paper's loop — fake-quantized forward and backward
over f32 masters, gradient accumulation folded into SGD momentum, and the
WOT throttle of every protected weight after every update.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --steps 30 [--batch 8 --seq 64 --lr 3e-3] [--no-wot] \\
      [--backend torch|cuda] [--device cuda|cpu]

The backend (the throttle's route) defaults to the kernels (``cuda``) on
the card and to the plain route (``torch``) on the CPU. :func:`train`
takes any config, e.g. a depth-cut full-width ``configs.get("deepseek-7b")``.
Checkpointing (``--ckpt``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.training import optim
from repro_torch.training import train as train_mod


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


default_backend = device_mod.default_backend


def train(cfg, *, steps: int = 30, batch: int = 8, seq: int = 64,
          lr: float = 3e-3, wot: bool = True, seed: int = 0, chunk: int = 64,
          backend=None, device=None, log=print) -> dict:
    """Run ``steps`` QATT steps of ``cfg`` on ``synthetic.token_batch``
    batches (seed ``seed``, step index ``0..steps-1``) from random params
    drawn from ``seed``.

    Returns ``{"params", "opt_state", "losses", "step_ms"}``: the per-step
    losses (floats) and times (host clock, each step ended by a device
    sync).
    """
    dev = device_mod.resolve(device)
    if backend is None:
        backend = default_backend(dev)
    log(f"[train] {cfg.name} ({cfg.family}) layers={cfg.n_layers} "
        f"d={cfg.d_model} vocab={cfg.vocab_padded}, batch {batch} x {seq}, "
        f"{cfg.microbatch} microbatches, wot={wot}, backend={backend}, "
        f"device={dev}")
    params = lm.init_params(cfg, seed, device=dev)
    opt_state = optim.sgd_init(params)
    step_fn = train_mod.make_train_step(cfg, lr=lr, wot_throttle=wot,
                                        chunk=chunk, backend=backend)
    losses, step_ms = [], []
    for step in range(steps):
        b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=seed,
                                  step=step)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        _sync(dev)
        t0 = time.time()
        params, opt_state, loss = step_fn(params, opt_state, b)
        loss = float(loss)
        _sync(dev)
        step_ms.append(1e3 * (time.time() - t0))
        losses.append(loss)
        log(f"  step {step:4d} loss {loss:.4f} ({step_ms[-1]:.1f} ms)")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_ms": step_ms}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None,
                    help="not ported yet (training/checkpoint.py)")
    ap.add_argument("--no-wot", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None, choices=("torch", "cuda"),
                    help="the throttle's route; default: cuda on the card, "
                         "torch on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    if args.ckpt:
        raise NotImplementedError("--ckpt: checkpointing is not ported yet")
    cfg = configs.get_smoke(args.arch)
    cfg = cfg.with_(microbatch=max(1, args.batch // 4))
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, wot=not args.no_wot, seed=args.seed, chunk=64,
                 backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()

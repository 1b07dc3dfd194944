"""QATT training entry point: QAT with WOT throttling on synthetic tokens.

Counterpart of ``python -m repro.launch.train``: trains the smoke config of
an architecture with the paper's loop — fake-quantized forward and backward
over f32 masters, gradient accumulation folded into SGD momentum, and the
WOT throttle of every protected weight after every update.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --steps 30 [--batch 8 --seq 64 --lr 3e-3] [--no-wot] \\
      [--backend torch|cuda] [--device cuda|cpu] \\
      [--ckpt DIR --ckpt-every 10]

The backend (the throttle's route) defaults to the kernels (``cuda``) on
the card and to the plain route (``torch``) on the CPU. :func:`train`
takes any config, e.g. a depth-cut full-width ``configs.get("deepseek-7b")``.
With ``--ckpt DIR`` it resumes from the latest checkpoint under ``DIR``
(if any) and checkpoints ``(params, opt_state)`` every ``--ckpt-every``
steps and at the end, in the background, ECC-protected
(``training/checkpoint.py``), as the reference CLI does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.training import checkpoint, optim
from repro_torch.training import train as train_mod


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


default_backend = device_mod.default_backend


def train(cfg, *, steps: int = 30, batch: int = 8, seq: int = 64,
          lr: float = 3e-3, wot: bool = True, seed: int = 0, chunk: int = 64,
          backend=None, device=None, prefix_embeds=None, enc_embeds=None,
          ckpt=None, ckpt_every: int = 10, protected: bool = True,
          log=print) -> dict:
    """Run ``steps`` QATT steps of ``cfg`` on ``synthetic.token_batch``
    batches (seed ``seed``, step index ``0..steps-1``) from random params
    drawn from ``seed``. A vlm batch also carries image-patch embeddings
    (batch, n_patches, d_model): ``prefix_embeds`` if given, else zeros in
    bf16, as the reference CLI feeds them; the loss covers the ``seq``
    text positions. (All-zero patches stay zero through every layer, where
    the RMS norm's backward scales by 1/sqrt(eps) = 1,000: at
    paligemma-3b's depth of 18 layers the loss's gradient is NaN, in the
    reference as in the port; at 12 it is finite. Non-zero patches, such
    as a real image's, train.) An encdec batch carries frame embeddings
    (batch, enc_seq, d_model) for the encoder: ``enc_embeds`` if given,
    else the reference CLI's, ``np.random.default_rng(0).normal`` in bf16
    (drawn with NumPy, so they are the same values).

    With ``ckpt`` (a directory), resumes from ``checkpoint.latest_step``
    there, if any, and runs the steps from it to ``steps``; an
    ``AsyncCheckpointer`` (``protected`` + in-place ECC, on ``device``)
    saves ``(params, opt_state)`` after every ``ckpt_every``-th step and
    after the last, then the run waits for it.

    Returns ``{"params", "opt_state", "losses", "step_ms", "start"}``: the
    per-step losses (floats) and times (host clock, each step ended by a
    device sync) of the steps run, and the step it started from.
    """
    dev = device_mod.resolve(device)
    if backend is None:
        backend = default_backend(dev)
    rows = {"vlm": f"{cfg.n_patches} patches + {seq} tokens",
            "encdec": f"({cfg.enc_seq} frames + {seq} tokens)"}.get(
        cfg.family, f"{seq}")
    log(f"[train] {cfg.name} ({cfg.family}) layers={cfg.n_layers} "
        f"d={cfg.d_model} vocab={cfg.vocab_padded}, batch {batch} x {rows}, "
        f"{cfg.microbatch} microbatches, wot={wot}, backend={backend}, "
        f"device={dev}")
    params = lm.init_params(cfg, seed, device=dev)
    opt_state = optim.sgd_init(params)
    start, ckpt_mgr = 0, None
    if ckpt:
        ckpt_mgr = checkpoint.AsyncCheckpointer(ckpt, protected=protected,
                                                device=dev)
        if checkpoint.latest_step(ckpt) is not None:
            (params, opt_state), start = checkpoint.restore(
                ckpt, (params, opt_state), device=dev)
            log(f"[train] resumed from step {start}")
    step_fn = train_mod.make_train_step(cfg, lr=lr, wot_throttle=wot,
                                        chunk=chunk, backend=backend)
    extras = {}
    if cfg.family == "vlm":
        extras["prefix_embeds"] = torch.zeros(
            (batch, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
            device=dev) if prefix_embeds is None else prefix_embeds
    if cfg.family == "encdec":
        extras["enc_embeds"] = reference_frames(cfg, batch, dev) \
            if enc_embeds is None else enc_embeds
    losses, step_ms = [], []
    for step in range(start, steps):
        b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=seed,
                                  step=step)
        b = {**{k: torch.from_numpy(v).to(dev) for k, v in b.items()},
             **extras}
        _sync(dev)
        t0 = time.time()
        params, opt_state, loss = step_fn(params, opt_state, b)
        loss = float(loss)
        _sync(dev)
        step_ms.append(1e3 * (time.time() - t0))
        losses.append(loss)
        log(f"  step {step:4d} loss {loss:.4f} ({step_ms[-1]:.1f} ms)")
        if ckpt_mgr and (step + 1) % ckpt_every == 0:
            ckpt_mgr.save((params, opt_state), step + 1)
    if ckpt_mgr:
        ckpt_mgr.save((params, opt_state), steps)
        ckpt_mgr.wait()
        log(f"[train] checkpointed to {ckpt}")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_ms": step_ms, "start": start}


def reference_frames(cfg, batch: int, device) -> torch.Tensor:
    """The reference training CLI's encoder frames: (batch, enc_seq,
    d_model) drawn by ``np.random.default_rng(0).normal`` in f64, rounded
    to bf16 once on the device."""
    x = np.random.default_rng(0).normal(size=(batch, cfg.enc_seq,
                                              cfg.d_model))
    return torch.from_numpy(x).to(device).to(torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the arch's smoke config (the default, as the "
                         "reference's)")
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="resume from and checkpoint (protected) into DIR")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-wot", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None, choices=("torch", "cuda"),
                    help="the throttle's route; default: cuda on the card, "
                         "torch on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    cfg = configs.get_smoke(args.arch)
    cfg = cfg.with_(microbatch=max(1, args.batch // 4))
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, wot=not args.no_wot, seed=args.seed, chunk=64,
                 backend=args.backend, device=args.device, ckpt=args.ckpt,
                 ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()

"""End-to-end run of the PyTorch + CUDA port: train a ~100M-param LM
for a few hundred steps with the full production stack — QAT + WOT, SGD
momentum, grad accumulation, async ECC-protected checkpointing — then
verify the deployable int8 weights satisfy the WOT constraint and serve
them under injected faults.

The flow of ``examples/train_lm_wot.py``; on the card (default) the
throttle, the codecs and the fused decode-at-use matmuls are the kernels:

  PYTHONPATH=src python examples/torch/train_lm_wot.py [--steps 200] \\
      [--ckpt DIR] [--device cpu]
"""
import argparse
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import math  # noqa: E402

import torch  # noqa: E402

from repro_torch import configs, protection, tree  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import quant, wot  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import protected  # noqa: E402
from repro_torch.training import checkpoint, optim, train  # noqa: E402


def reduced_config():
    """~100M params: the qwen family at a reduced width."""
    return configs.get("qwen1.5-4b").with_(
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=1536, vocab=16384, microbatch=2, remat=False)


def main(argv=None, *, cfg=None, batch=8, seq=128):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    backend = device_mod.default_backend(dev)

    cfg = cfg or reduced_config()
    n_params = sum(math.prod(s.shape) for _, s in
                   tree.leaves_with_path(lm.param_shapes(cfg)))
    print(f"[lm] {cfg.name}-reduced: {n_params / 1e6:.1f}M params")

    params = lm.init_params(cfg, 0, device=dev)
    opt = optim.sgd_init(params)
    ckpt = checkpoint.AsyncCheckpointer(args.ckpt, protected=True,
                                        device=dev)
    step_fn = train.make_train_step(cfg, lr=3e-3, chunk=64, backend=backend)

    t0 = time.time()
    B, S = batch, seq
    for step in range(args.steps):
        b = synthetic.token_batch(cfg.vocab_padded, B, S, seed=0, step=step)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, opt, loss = step_fn(params, opt, b)
        if step % 20 == 0:
            tok_s = B * S * (step + 1) / (time.time() - t0)
            print(f"  step {step:4d} loss {float(loss):.4f} "
                  f"({tok_s:.0f} tok/s)")
        if (step + 1) % 100 == 0:
            ckpt.save((params, opt), step + 1)
    ckpt.wait()

    # deployable weights satisfy WOT
    bad = 0
    for _, leaf in tree.leaves_with_path(params):
        if leaf.ndim >= 2:
            q, _ = quant.quantize(leaf)
            bad += int(wot.count_large_in_protected(q.reshape(-1)))
    print(f"[lm] WOT violations in deployable int8 weights: {bad}")

    # protected serving under faults
    print("[lm] " + protection.coverage(params).summary()
          .replace("\n", "\n[lm] "))
    enc = protection.encode_tree(params, protection.ProtectionPolicy(
        backend=backend))
    enc_faulty = protection.inject_tree(enc, 1e-4, seed=1)
    serve = protected.make_serve_step(cfg, backend=backend,
                                      with_flags=False)
    cache = lm.init_cache(cfg, 2, 64, device=dev)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    for t in range(8):
        logits, cache = serve(enc_faulty, cache, toks,
                              torch.full((2,), t, dtype=torch.int32,
                                         device=dev))
        toks = logits.argmax(-1).to(torch.int32)
    finite = bool(torch.isfinite(logits.float()).all())
    print(f"[lm] served 8 tokens from fault-injected encoded weights: "
          f"{finite}")
    return bad, finite


if __name__ == "__main__":
    main()

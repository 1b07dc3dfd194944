"""Protected-serving example of the PyTorch + CUDA port: batched decode
with ECC-encoded weights under active memory faults, across architectures
(dense / MoE / SSM / hybrid), driven entirely through the
``repro_torch.protection`` policy API.

The flow of ``examples/serve_protected.py``; on the card (default) every
projection decodes at use through the fused kernel:

  PYTHONPATH=src python examples/torch/serve_protected.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch import configs, protection  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import protected  # noqa: E402

ARCHS = ("deepseek-7b", "deepseek-v2-236b", "mamba2-2.7b",
         "recurrentgemma-2b")


def main(argv=None, *, archs=ARCHS):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    backend = device_mod.default_backend(dev)
    policy = protection.ProtectionPolicy(default_scheme="in-place",
                                         backend=backend)
    out = {}
    for arch in archs:
        cfg = configs.get_smoke(arch)
        params = lm.init_params(cfg, 0, device=dev)
        report = policy.coverage(params)
        enc = policy.encode_tree(params)
        serve = protected.make_serve_step(cfg, backend=backend,
                                          with_flags=False)
        B = 4
        pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)

        # clean pass
        clean, _ = serve(enc, lm.init_cache(cfg, B, 64, device=dev), tok,
                         pos)

        # serve with faults injected into the resident weight images
        faulty_enc = protection.inject_tree(enc, 1e-5, seed=42)
        dirty, _ = serve(faulty_enc, lm.init_cache(cfg, B, 64, device=dev),
                         tok, pos)
        err = float((clean.float() - dirty.float()).abs().max())
        out[arch] = err
        print(f"{arch:20s} batch={B}: {report.n_protected} tensors "
              f"protected ({report.protected_bytes / 2**20:.1f} MiB, "
              f"{report.n_unprotected} unprotected), fault-injected vs clean "
              f"logits max|diff| = {err:.2e} (singles corrected in-place)")
    return out


if __name__ == "__main__":
    main()

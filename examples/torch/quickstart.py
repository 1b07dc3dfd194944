"""Quickstart of the PyTorch + CUDA port: the paper's full pipeline.

1. Pretrain a small CNN (stands in for the paper's ImageNet models).
2. WOT fine-tune: QAT + throttling (paper §4.1 QATT) with SGD momentum.
3. Quantize to int8; the WOT constraint holds -> in-place ECC is applicable.
4. Encode (zero space overhead!), inject memory faults, decode, evaluate —
   protection matches standard SEC-DED ECC at 0% space cost.

The flow of ``examples/quickstart.py`` through ``repro_torch``, on the card
(the kernels) by default:

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.training.cnn_experiments import (  # noqa: E402
    accuracy, eval_with_scheme, large_count, pretrain, wot_finetune)


def main(argv=None, *, pre_steps=100, wot_steps=40, trials=3):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    print("=== In-Place Zero-Space Memory Protection: quickstart ===")
    print("[1] fp32 pretraining (stands in for ImageNet weights) ...")
    params, fwd, tmpl = pretrain("resnet18", steps=pre_steps, device=dev)
    print(f"    fp32 accuracy: {accuracy(params, fwd, tmpl):.3f}, "
          f"int8: {accuracy(params, fwd, tmpl, quantized=True):.3f}, "
          f"WOT-violating large values: {large_count(params)}")

    print("[2] WOT fine-tune (QAT + throttling, SGD momentum) ...")
    params, tmpl, _ = wot_finetune(params, fwd, tmpl, steps=wot_steps)
    print(f"    int8+WOT accuracy: "
          f"{accuracy(params, fwd, tmpl, quantized=True):.3f}, "
          f"large values: {large_count(params)} (constraint satisfied)")

    rate = 1e-3
    print(f"[3] memory faults at rate {rate}: accuracy per scheme")
    for scheme in ("faulty", "zero", "ecc", "in-place"):
        accs = [eval_with_scheme(params, fwd, tmpl, scheme, rate, 100 * s)[0]
                for s in range(trials)]
        _, ovh = eval_with_scheme(params, fwd, tmpl, scheme, 0.0, 0)
        print(f"    {scheme:9s}: accuracy {sum(accs) / trials:.3f} "
              f"(space overhead {ovh * 100:4.1f}%)")
    print("in-place zero-space ECC == standard ECC protection at 0% cost")


if __name__ == "__main__":
    main()

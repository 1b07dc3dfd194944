"""The port's four examples (``examples/torch/``), each the flow of its
reference example (``examples/*.py``) through ``repro_torch``: every
``main`` runs here on the CPU at smoke settings and prints its claim line;
without ``--device cpu`` each raises where there is no GPU.
``test_torch_gpu.py`` runs the two training examples on the card."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ("quickstart", "serve_protected", "train_lm_wot",
         "fault_tolerant_training")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    """The pipeline at 4 pretraining and 2 WOT steps, one trial a scheme:
    the WOT constraint holds after fine-tuning and every scheme's line
    prints, with in-place's 0% overhead."""
    _load("quickstart").main(["--device", "cpu"], pre_steps=4, wot_steps=2,
                             trials=1)
    out = capsys.readouterr().out
    assert "large values: 0 (constraint satisfied)" in out
    assert "in-place : accuracy" in out and "(space overhead  0.0%)" in out
    assert out.rstrip().endswith(
        "in-place zero-space ECC == standard ECC protection at 0% cost")


def test_serve_protected(capsys):
    """The four archs' smoke configs: in-place at 1e-5 corrects every
    single flip, so the faulted logits equal the clean ones."""
    errs = _load("serve_protected").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert set(errs) == {"deepseek-7b", "deepseek-v2-236b", "mamba2-2.7b",
                         "recurrentgemma-2b"}
    assert out.count("max|diff| = 0.00e+00 (singles corrected in-place)") \
        == 4


def test_train_lm_wot(capsys, tmp_path):
    """Two steps of qwen1.5-4b smoke at 4 x 32 with a protected async
    checkpointer, the WOT count over the deployable int8 weights, the
    coverage report and 8 served tokens from fault-injected images."""
    cfg = configs.get_smoke("qwen1.5-4b").with_(microbatch=2)
    _, finite = _load("train_lm_wot").main(
        ["--device", "cpu", "--steps", "2", "--ckpt", str(tmp_path / "ck")],
        cfg=cfg, batch=4, seq=32)
    out = capsys.readouterr().out
    assert finite
    assert "[lm] WOT violations in deployable int8 weights:" in out
    assert "[lm] protection coverage:" in out
    assert "served 8 tokens from fault-injected encoded weights: True" in out


def test_fault_tolerant_training(capsys, tmp_path):
    """8 steps with a crash after 6 (a checkpoint at 5): the resumed run
    equals the uninterrupted one exactly, and in-place keeps the recovered
    weights intact where unprotected storage loses some."""
    err, fid = _load("fault_tolerant_training").main(
        ["--device", "cpu"], ckpt=str(tmp_path / "ft"), steps=8, crash=6)
    out = capsys.readouterr().out
    assert err == 0.0
    assert "[ft] resuming from checkpoint step 5" in out
    assert "crash-resume reproduces the uninterrupted run exactly" in out
    assert fid["in-place"][-1] > fid["faulty"][-1]
    assert out.rstrip().endswith("intact under memory faults")


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_cuda(monkeypatch, name):
    mod = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])

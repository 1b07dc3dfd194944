"""Serve-step parity of the port against the reference in bf16, the
serving dtype, plus the encoded tree and the CLI.

Flags must be exactly equal (they depend only on the stored bytes). Logits
get a looser tolerance than in f32 (``test_torch_serve.py``): every
activation is rounded to bf16 (8 significant bits) after each op, and XLA
and PyTorch round at different places — XLA fuses elementwise chains that
PyTorch evaluates op by op — so a one-ulp bf16 difference (~0.4%) early in
a layer propagates to the logits. The same tokens are fed to both.
"""
import jax
import numpy as np
import pytest
import torch

import torch_parity as P
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.protection import policy as tpolicy

BF16_ATOL = 5e-2   # logits are O(1); a few bf16 ulps after two layers


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("kv,backend,port_kv", [
    (None, "torch", None), ("in-place", "torch", "in-place"),
    ("in-place", "cuda", "in-place-fused")],
    ids=["dense-kv", "paged-kv", "kernel-route"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b",
                                  "paligemma-3b"])
def test_serve_step_parity_bf16(arch, kv, backend, port_kv, faulted):
    exported, fed, ref_logits, _, ref_flags = P.reference_run(
        arch, kv, "bfloat16", faulted)
    logits, _, flags = P.port_run(arch, port_kv, "bfloat16", exported, fed,
                                  backend=backend)
    P.assert_flags_equal(ref_flags, flags)
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b",
                                  "paligemma-3b"])
def test_encode_tree_matches_reference(arch):
    """The port's plan encodes the reference's weights to the same images,
    scales and coverage."""
    _, jplan, params, jenc = P._reference_model(arch)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    plan = tpolicy.ProtectionPolicy().plan(tparams)
    enc = plan.encode_tree(tparams)
    ref = P.export(jenc)
    assert sorted(enc) == sorted(ref)   # paligemma-3b: tied, no "head"
    for key in [k for k in ("embed", "head") if k in ref]:
        np.testing.assert_array_equal(enc[key].enc.numpy(), ref[key]["enc"])
        assert enc[key].scale.item() == float(ref[key]["scale"])
    for sub in ("attn", "mlp"):
        for name, pt in enc["layers"][sub].items():
            np.testing.assert_array_equal(pt.enc.numpy(),
                                          ref["layers"][sub][name]["enc"])
    js, ts = jplan.summary(), plan.summary()
    for k in ("n_protected", "n_unprotected", "protected_bytes",
              "weight_bytes", "pad_bytes"):
        assert ts[k] == js[k], k
    assert plan.coverage().summary().splitlines()[0] == \
        jplan.coverage().summary().splitlines()[0]


def test_cli_runs_on_cpu_when_asked(capsys):
    serve.main(["--device", "cpu", "--tokens", "2", "--batch", "2",
                "--kv-policy", "in-place-fused", "--backend", "cuda",
                "--fault-rate", "1e-3"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "corrected" in out and "KV decode-at-use" in out


def test_serve_returns_fault_positions_and_counts_them():
    """Every injected single-flip block is corrected and every double-flip
    block flagged, once per step (the rate leaves no block three flips)."""
    res = serve.serve(tconfigs.get_smoke("minitron-4b"), batch=2, tokens=2,
                      fault_rate=2e-4, device="cpu", log=lambda *_: None)
    singles = doubles = 0
    for pos in res["weight_positions"].values():
        _, c = torch.unique(pos // 64, return_counts=True)
        singles += int((c == 1).sum())
        doubles += int((c == 2).sum())
        assert int((c >= 3).sum()) == 0
    assert res["flags"]["corrected"] == 2 * singles > 0
    assert res["flags"]["due"] == 2 * doubles
    assert res["logits"].shape == (2, 2, 512)


def test_correctable_only_faults_give_the_clean_run_bit_for_bit():
    """With at most one flip per code block in the weights and the KV
    pools, every flip is corrected at use: the logits and tokens equal the
    clean run's exactly and each flipped weight block is counted once per
    step."""
    cfg = tconfigs.get_smoke("deepseek-7b")
    kw = dict(batch=2, tokens=4, kv_policy="in-place", device="cpu",
              log=lambda *_: None)
    clean = serve.serve(cfg, **kw)
    hit = serve.serve(cfg, fault_rate=2e-3, correctable_only=True, **kw)
    n_blocks = 0
    for pos in (*hit["weight_positions"].values(),
                *hit["kv_positions"].values()):
        _, c = torch.unique(pos // 64, return_counts=True)
        assert int(c.max()) == 1
    for pos in hit["weight_positions"].values():
        n_blocks += pos.numel()
    assert n_blocks > 0 and hit["kv_positions"]
    assert hit["flags"]["corrected"] == 4 * n_blocks
    assert hit["flags"]["due"] == 0 and hit["flags"]["kv_due"] == 0
    assert torch.equal(hit["logits"], clean["logits"])
    assert torch.equal(hit["tokens"], clean["tokens"])

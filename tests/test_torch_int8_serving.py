"""Guarded int8 serving in the port against the reference's XLA route:
plan decisions, ``ProtectedWeight``'s int8 and guarded paths, calibration
and the CLI. ``test_torch_guarded_serve.py`` holds the cache-less prefill
and the serve step under ``act_quant``, ABFT and clamps.

Both packages see the same weights (the reference's, carried across with
``repro_torch.convert``) and the same inputs; int8 and guarded outputs are
compared bit for bit, counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro import protection as jprotection
from repro.core import quant as jquant
from repro.protection.fused import ProtectedWeight as JProtectedWeight
from repro.serving import protected as jprot
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import quant
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.protection.fused import ProtectedWeight
from repro_torch.serving import protected as tprot

# calibration absmax in f32: XLA's and PyTorch's f32 activations (norms,
# rope, softmax) differ in the last ulp
CAL_RTOL = 1e-5


# ---------------------------------------------------------------------------
# plan decisions
# ---------------------------------------------------------------------------


def _decisions(plan):
    return {p: (lp.act_quant, lp.a_scale, lp.abft, lp.clamp)
            for p, lp in plan.leaves.items()}


def _guard_summary(plan):
    s = plan.summary()
    return {k: s[k] for k in ("act_quant", "n_abft", "n_clamped")}


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen1.5-4b"])
def test_plan_decisions_and_summaries_equal_the_reference(arch):
    _, jplan, _, scales = P.calibrated_model(arch)
    tplan = P.port_plan(arch)
    some = "layers/attn/wq"
    for make in (lambda p: p.with_act_quant("dynamic"),
                 lambda p: p.with_act_quant("static", scales),
                 lambda p: p.with_act_quant("static", scales, clamp=True),
                 lambda p: p.with_abft(),
                 lambda p: p.with_abft(clamps={some: 3.5}).with_abft(False),
                 lambda p: p.with_act_quant("static", scales,
                                            clamp=True).with_abft(True)):
        assert _decisions(make(tplan)) == _decisions(make(jplan))
        assert _guard_summary(make(tplan)) == _guard_summary(make(jplan))
    assert _guard_summary(tplan) == _guard_summary(jplan)
    for bad, match in ((lambda p: p.with_act_quant("static"), "calibrated"),
                       (lambda p: p.with_act_quant("sometimes"), "mode"),
                       (lambda p: p.with_act_quant("dynamic", clamp=True),
                        "clamp")):
        with pytest.raises(ValueError, match=match):
            bad(tplan)


# ---------------------------------------------------------------------------
# ProtectedWeight
# ---------------------------------------------------------------------------


def _leaf(seed, k=64, n=128):
    rng = np.random.default_rng(seed)
    w = rng.integers(-64, 64, size=(k, n)).astype(np.float32) * 0.01
    jpt = jprotection.ProtectionPolicy().encode_leaf(jnp.asarray(w),
                                                     "in-place")
    tpt = convert.protected_from_numpy(P.export(jpt), device="cpu")
    x = rng.normal(size=(3, 5, k)).astype(np.float32)
    return jpt, tpt, x


@pytest.mark.parametrize("abft", [False, True])
@pytest.mark.parametrize("mode", [None, "dynamic", "static"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_protected_weight_matches_the_reference(backend, mode, abft):
    """bf16 activations through the int8 (static / dynamic) and float
    views, guarded or not: outputs bit-equal to the reference's XLA view,
    ABFT records (0, 0) on clean weights."""
    jpt, tpt, x = _leaf(6)
    kw = dict(act_quant=mode, a_scale=0.02 if mode == "static" else None)
    seen_j, seen_t = [], []
    jv = JProtectedWeight(jpt, "xla", abft=abft, record_abft=lambda m, h:
                          seen_j.append((int(m), int(h))), **kw)
    tv = ProtectedWeight(tpt, backend, abft=abft, record_abft=lambda m, h:
                         seen_t.append((int(m), int(h))), **kw)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jv.matmul(xj), np.float32)
    got = tv.matmul(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert seen_t == seen_j == ([(0, 0)] if abft else [])


def test_protected_weight_raw_int8_needs_static_scale():
    """As tests/test_int8_serving.py:186."""
    jpt, tpt, _ = _leaf(7, 32, 32)
    q = torch.ones((2, 32), dtype=torch.int8)
    with pytest.raises(TypeError, match="static a_scale"):
        ProtectedWeight(tpt, "cuda").matmul(q)
    for backend in ("torch", "cuda"):
        out = ProtectedWeight(tpt, backend, act_quant="static",
                              a_scale=0.05).matmul(q)
        want = JProtectedWeight(jpt, "xla", act_quant="static",
                                a_scale=0.05).matmul(jnp.ones((2, 32),
                                                              jnp.int8))
        assert out.dtype == torch.bfloat16 and out.shape == (2, 32)
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(want, np.float32))


def test_protected_weight_observe_records_device_absmax():
    _, tpt, x = _leaf(8)
    seen = []
    ProtectedWeight(tpt, "torch", observe=seen.append).matmul(
        torch.from_numpy(x))
    assert isinstance(seen[0], torch.Tensor) and seen[0].ndim == 0
    assert float(seen[0]) == float(np.abs(x).max())
    with pytest.raises(NotImplementedError, match="per_slot"):
        ProtectedWeight(tpt, "torch", abft=True, abft_per_slot=True)


# ---------------------------------------------------------------------------
# calibration and the cache-less prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b",
                                  "qwen1.5-4b"])
def test_calibrate_act_scales_matches_the_reference(arch):
    cfg, _, exported, scales = P.calibrated_model(arch)
    enc = convert.protected_from_numpy(exported, device="cpu")
    toks = torch.from_numpy(P.seeded_tokens(cfg, P.CAL_SHAPE, 3)).long()
    for backend in ("torch", "cuda"):
        got = tprot.calibrate_act_scales(cfg, enc, toks, plan=P.port_plan(arch),
                                         backend=backend,
                                         dtype=torch.float32, chunk=16)
        assert sorted(got) == sorted(scales)
        assert "layers/attn/wq" in got and "head" in got
        for p in scales:
            np.testing.assert_allclose(got[p], scales[p], rtol=CAL_RTOL,
                                       err_msg=p)


def test_calibration_floors_zero_activation_scale():
    """As tests/test_int8_serving.py:216: all-zero calibration activations
    give the floor scale 1e-12 / 127, not 0, on both packages, and the
    static plan serves finite logits."""
    cfg = tconfigs.get_smoke("minitron-4b")
    params = P.reference_params("minitron-4b")
    params = dict(params, embed=np.zeros_like(params["embed"]))
    jparams = P.jax_params(params)
    jplan = jprotection.ProtectionPolicy().plan(jparams)
    jenc = jax.jit(jplan.encode_tree)(jparams)
    jscales = jprot.calibrate_act_scales(cfg, jenc, jnp.zeros((2, 16),
                                                              jnp.int32),
                                         plan=jplan, chunk=16)
    tplan = P.port_plan("minitron-4b")
    tenc = convert.protected_from_numpy(P.export(jenc), device="cpu")
    scales = tprot.calibrate_act_scales(cfg, tenc,
                                        torch.zeros((2, 16),
                                                    dtype=torch.long),
                                        plan=tplan, chunk=16)
    assert scales == jscales and all(s == 1e-12 / 127 for s in scales.values())
    step = tprot.make_serve_step(cfg, plan=tplan.with_act_quant("static",
                                                                scales),
                                 act_quant="plan")
    logits, _, _ = step(tenc, lm.init_cache(cfg, 2, 32, device="cpu"),
                        torch.zeros((2, 1), dtype=torch.long),
                        torch.zeros((2,), dtype=torch.int32))
    assert bool(torch.isfinite(logits.float()).all())


def test_serve_cli_runs_guarded_on_the_cpu(capsys):
    res = serve.main(["--device", "cpu", "--abft", "--act-clamp",
                      "--tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "[serve] ABFT guard:" in out
    assert "[serve] ABFT compute-fault accounting: 0 checksum mismatches" \
        in out
    assert res["abft"]["mismatches"] == 0 and res["scales"]
    cfg = tconfigs.get_smoke("qwen1.5-4b")
    for aq in ("static", "dynamic"):
        r = serve.serve(cfg, batch=2, tokens=2, device="cpu", abft=True,
                        act_quant=aq, log=lambda *_: None)
        assert r["abft"]["mismatches"] == 0 and r["flags"]["due"] == 0
        assert bool(torch.isfinite(r["logits"].float()).all())
    assert quant.QMAX == jquant.QMAX

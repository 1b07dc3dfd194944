"""ADMM-based WOT (``repro_torch.training.admm``) against the reference's
``repro.training.admm``: one ADMM step from identical params, momentum,
Z and U (its ``(params, z, u, loss)``), on both of the port's routes;
``finalize`` meeting the WOT constraint, bit-equal to the reference's;
and the port's ``wot_admm_compare`` on the CPU at width 1/8, which prints
the reference's line.

The model is a two-layer MLP with a QAT forward, written in both
packages, whose weights are spread so that the projection moves some of
them. The reference runs eagerly (``jax.disable_jit``): under jit XLA
forms the throttle's scale through a reciprocal, one ulp off at times
(tests/test_torch_train.py)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro.core import quant as jquant
from repro.core import wot as jwot
from repro.training import admm as jadmm
from repro.training import optim as joptim
from repro_torch import tree
from repro_torch.benchmarks import wot_admm_compare
from repro_torch.core import quant, wot
from repro_torch.training import admm

# the W-step's gradients are summed in another order (f32 noise): the
# masters within this after one step at lr 1e-2 (read: 2.4e-7, an ulp of
# their values up to ~4), and Z and U with them (read: the same), the
# momentum within STEP_TOL / lr (read: 2.1e-6)
STEP_TOL = 1e-6


def _params(seed=0):
    rng = np.random.default_rng(seed)

    def w(*s):
        return (rng.standard_normal(s) * rng.uniform(0.5, 3, s)).astype(
            np.float32)
    return {"l1": {"w": w(16, 40), "b": w(40)},
            "l2": {"w": w(40, 4), "b": w(4)}}


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((8, 16)).astype(np.float32),
            "y": rng.integers(0, 4, 8).astype(np.int32)}


def _jloss(p, b):
    h = jax.nn.relu(b["x"] @ jquant.fake_quant(p["l1"]["w"]) + p["l1"]["b"])
    lg = h @ jquant.fake_quant(p["l2"]["w"]) + p["l2"]["b"]
    return jnp.mean(jax.nn.logsumexp(lg, -1) - jnp.take_along_axis(
        lg, b["y"][:, None], 1)[:, 0])


def _tloss(p, b):
    h = torch.relu(b["x"] @ quant.fake_quant(p["l1"]["w"]) + p["l1"]["b"])
    lg = h @ quant.fake_quant(p["l2"]["w"]) + p["l2"]["b"]
    tgt = lg.gather(-1, b["y"].long()[:, None])[:, 0]
    return (torch.logsumexp(lg, -1) - tgt).mean()


def _state(p, seed=2):
    """A mid-run ADMM state: seeded momentum, Z = a projection of W, U a
    small seeded residual."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(
        np.float32), p)
    u = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(
        np.float32), p)
    with jax.disable_jit():
        z = jax.tree.map(np.asarray, jadmm._project(P.jax_params(p)))
    return m, z, u


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_admm_step_matches_reference(route):
    p, b = _params(), _batch()
    m, z, u = _state(p)
    kw = dict(lr=1e-2, gamma=1e-2)
    jstate = jadmm.AdmmState(joptim.SgdState(P.jax_params(m)),
                             P.jax_params(z), P.jax_params(u))
    with jax.disable_jit():
        jp, js, jl = jadmm.make_admm_step(_jloss, **kw)(
            P.jax_params(p), jstate, P.jax_params(b))
    tstate = admm.AdmmState(admm.optim.SgdState(P.port_params(m)),
                            P.port_params(z), P.port_params(u))
    tp, ts, tl = admm.make_admm_step(_tloss, backend=route, **kw)(
        P.port_params(p), tstate,
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(tl) - float(jl)) < 1e-6
    assert P.max_diff(tp, jp) < STEP_TOL
    assert P.max_diff(ts.opt.momentum, js.opt.momentum) < STEP_TOL / 1e-2
    assert P.max_diff(ts.z, js.z) < STEP_TOL
    assert P.max_diff(ts.u, js.u) < STEP_TOL
    # the projection moved weights, and Z is the projection of W + U
    assert P.max_diff(ts.z, jax.tree.map(
        lambda a, c: np.asarray(a) + np.asarray(c), jp, js.u)) > 0.1
    want_z = admm._project(tree.map_with_path(
        lambda path, w: w + tree.get_path(tstate.u, path), tp))
    assert P.max_diff(ts.z, tree.map_with_path(
        lambda _, t: t.numpy(), want_z)) == 0


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_finalize_meets_the_constraint_bit_equal_to_reference(route):
    """Eight passes clamp every protected leaf into S (no large value in
    positions 0..6 at the leaf's own scale), as the reference's do."""
    p = _params(3)
    p["l1"]["w"][::3] *= 40.0      # a few large rows the clamp must move
    got = admm.finalize(P.port_params(p), backend=route)
    with jax.disable_jit():
        want = jax.tree.map(np.asarray, jadmm.finalize(P.jax_params(p)))
    for path, t in tree.leaves_with_path(got):
        assert t.numpy().tobytes() == tree.get_path(want, path).tobytes()
        if wot.is_protected_weight(path, t):
            q, _ = quant.quantize(t)
            assert wot.satisfies_constraint(q.reshape(-1)), path
            jq, _ = jquant.quantize(jnp.asarray(tree.get_path(p, path)))
            assert not jwot.satisfies_constraint(jq.reshape(-1))


def test_admm_init_matches_reference():
    p = _params()
    js = jadmm.admm_init(P.jax_params(p))
    ts = admm.admm_init(P.port_params(p))
    assert P.max_diff(ts.z, js.z) == 0 and P.max_diff(ts.u, js.u) == 0
    assert P.max_diff(ts.opt.momentum, js.opt.momentum) == 0
    w = ts.z["l1"]["w"]
    assert w.data_ptr() != tree.get_path(P.port_params(p),
                                         ("l1", "w")).data_ptr()


def test_wot_admm_compare_prints_the_reference_line(capsys, tmp_path):
    """The CLI on the CPU at width 1/8 (few steps): the reference's output
    line, QATT's large-value count at 0 and ADMM's clamped model too."""
    out = tmp_path / "admm.json"
    wot_admm_compare.main(["--device", "cpu", "--scale", "0.125",
                           "--pre-steps", "10", "--steps", "4",
                           "--json", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"admm_vs_qatt,\d+,qatt=\d\.\d{3}_admm=\d\.\d{3}"
                        r"_admm_residual_large=\d+", lines[-1]), lines[-1]
    assert lines[0].startswith("# resnet18: pretrain acc=")
    import json
    rec = json.loads(out.read_text())
    assert rec["qatt_large"] == 0 and rec["admm_final_large"] == 0
    assert len(rec["admm_curve"]) == len(rec["admm_z_large"]) == 4


def test_four_passes_leave_large_values_as_in_the_reference():
    """ADMM's Z-step does not reach the projection's fixed point: where no
    eighth-position value is large, each throttle pass shrinks the scale
    to 63/127 of itself and exposes new large values. After the Z-step's
    four passes the re-quantized leaf holds as many large values in the
    port as in the reference (eager), bit for bit, and some; eight passes
    (``finalize``) leave none here."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    w.reshape(-1, 8)[:, 7] *= 0.01          # no large eighth value
    p = {"w": w}
    got = admm._project(P.port_params(p))["w"]
    with jax.disable_jit():
        want = np.asarray(jadmm._project(P.jax_params(p))["w"])
    assert got.numpy().tobytes() == want.tobytes()
    q, _ = quant.quantize(got)
    n = int(wot.count_large_in_protected(q.reshape(-1)))
    jq, _ = jquant.quantize(jnp.asarray(want))
    assert n == int(jwot.count_large_in_protected(jq.reshape(-1))) > 0
    q8, _ = quant.quantize(admm.finalize(P.port_params(p))["w"])
    assert wot.satisfies_constraint(q8.reshape(-1))

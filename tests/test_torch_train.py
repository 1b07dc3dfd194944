"""The port's QATT training path against the reference: fake-quant, the
WOT throttle, the fused momentum, whole train steps, the synthetic data
and the CLI (the forward, its loss and gradients: test_torch_forward.py).

Weights come from the reference's ``lm.init_params`` through NumPy; the
batches from ``synthetic.token_batch``. Tolerances are stated beside each
comparison. The throttle and ``token_batch`` are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quant as jquant
from repro.core import wot as jwot
from repro.data import synthetic as jsynthetic
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro.training import train as jtrain
from repro_torch import configs, convert, tree
from repro_torch.core import quant, wot
from repro_torch.data import synthetic
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.training import optim, train

import torch_parity as P

# XLA and PyTorch sum the f32 matmuls in different orders
F32_ATOL = 1e-4
# bf16 activations: the two frameworks round them at different places
# (tests/test_torch_forward.py)
BF16_MAX_ATOL = 0.125

_ref_params, _port, _jax, _batch, _max_diff = (
    P.reference_params, P.port_params, P.jax_params, P.token_batch,
    P.max_diff)


def test_fake_quant_and_dequantize_match_reference():
    x = np.random.default_rng(0).standard_normal((6, 16)).astype(np.float32)
    want = np.asarray(jquant.fake_quant(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    y = quant.fake_quant(t)
    np.testing.assert_array_equal(y.detach().numpy(), want)   # bit for bit
    (y * torch.arange(16.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.broadcast_to(np.arange(16.0), (6, 16)))
    np.testing.assert_array_equal(
        np.asarray(jax.grad(lambda v: jnp.sum(jquant.fake_quant(v)))(
            jnp.asarray(x))), np.ones_like(x))
    q, scale = quant.quantize(torch.from_numpy(x))
    jq, jscale = jquant.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(quant.dequantize(q, scale).numpy(),
                                  np.asarray(jquant.dequantize(jq, jscale)))


def test_throttle_tensor_and_tree_are_bit_exact():
    """Two layers stacked: the throttle scales the whole stacked leaf."""
    p = _ref_params("deepseek-7b")
    # spread the weights so the throttle moves some of them, and add a
    # ragged (non-block) leaf
    rng = np.random.default_rng(4)
    p = jax.tree.map(lambda a: (a * rng.uniform(0.5, 3, a.shape)).astype(
        np.float32), p)
    p["odd"] = rng.standard_normal((5, 7)).astype(np.float32)
    # the reference eagerly: under jit XLA rewrites the product q * scale
    # of the moved weights and changes some by one ulp against its own
    # eager result (388 of the embedding's 32,768 here)
    ref = jax.tree.map(np.asarray, jwot.throttle_tree(_jax(p)))
    for route in ("torch", "cuda"):
        got = wot.throttle_tree(_port(p), backend=route)
        moved = 0
        for path, t in tree.leaves_with_path(got):
            r = tree.get_path(ref, path)
            assert t.numpy().tobytes() == r.tobytes(), path
            moved += int((t.numpy() != tree.get_path(p, path)).sum())
        assert moved > 0
        w = _port(p)["layers"]["mlp"]["w_up"]
        out, q, scale = wot.throttle_tensor(w, backend=route, with_q=True)
        jq, jscale = jquant.quantize(jnp.asarray(p["layers"]["mlp"]["w_up"]))
        jq = jwot.throttle_q(jq.reshape(-1)).reshape(jq.shape)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        assert wot.satisfies_constraint(q.reshape(-1))


def test_census_matches_reference():
    q = np.random.default_rng(5).integers(-127, 128, 1001).astype(np.int8)
    jq = jnp.asarray(q)
    t = torch.from_numpy(q)
    assert int(wot.count_large_in_protected(t)) == int(
        jwot.count_large_in_protected(jq))
    np.testing.assert_array_equal(
        wot.large_position_histogram(t).numpy(),
        np.asarray(jwot.large_position_histogram(jq)))
    assert wot.range_percentages(t) == jwot.range_percentages(q)
    assert wot.satisfies_constraint(t) == jwot.satisfies_constraint(jq)


def test_fused_momentum_matches_sgd_update():
    """Fused accumulate-into-momentum == accumulate, then ``sgd_update``."""
    tcfg = configs.get_smoke("qwen1.5-4b").with_(microbatch=2, remat=False)
    p = _ref_params("qwen1.5-4b")
    b = {k: torch.from_numpy(v)
         for k, v in _batch("qwen1.5-4b", 4, 16, step=2).items()}
    lr, mu, wd = 1e-3, 0.9, 1e-4
    p1, o1, _ = train.make_train_step(
        tcfg, lr=lr, mu=mu, wd=wd, wot_throttle=False, chunk=16,
        bf16_weights=False)(_port(p), optim.sgd_init(_port(p)), b)
    tp = _port(p)
    grads = []
    for sl in (slice(0, 2), slice(2, 4)):
        for _, t in tree.leaves_with_path(tp):
            t.grad = None
            t.requires_grad_()
        lm.loss_fn(tcfg, tp, {k: v[sl] for k, v in b.items()},
                   wt=train.qat_wt, chunk=16).backward()
        grads.append(tree.map_with_path(lambda _, t: t.grad.clone(), tp))
    g = tree.map_with_path(lambda path, a: (a + tree.get_path(grads[1], path))
                           / 2, grads[0])
    with torch.no_grad():
        p2, o2 = optim.sgd_update(_port(p), g, optim.sgd_init(_port(p)),
                                  lr=lr, mu=mu, wd=wd)
    assert _max_diff(p1, tree.map_with_path(lambda _, t: t.numpy(), p2)) \
        < 5e-6
    assert _max_diff(o1.momentum, tree.map_with_path(
        lambda _, t: t.numpy(), o2.momentum)) < 5e-6 / lr


@pytest.mark.parametrize("bf16", [False, True])
def test_train_steps_match_reference(bf16):
    """One and three steps from the same params, momentum and batches.

    f32 (bf16_weights off, f32 activations): masters within 2e-6 and
    momentum within 2e-5 after each step (f32 gradients summed in another
    order, times lr 1e-3 for the masters). With the defaults (bf16 weights
    and activations): masters within 5e-4, momentum within 5e-2. Both
    frameworks sum the embedding gradient in bf16, in different orders,
    so a row that many tokens share differs by a few bf16 ulps of its sum
    (up to 0.035 in the momentum of values up to 1.8; every other leaf
    stays within 1e-5 in the masters)."""
    arch = "qwen1.5-4b"
    cfg = jconfigs.get_smoke(arch).with_(microbatch=2)
    tcfg = configs.get_smoke(arch).with_(microbatch=2)
    p = _ref_params(arch)
    m = jax.tree.map(lambda a: (0.01 * np.random.default_rng(a.size)
                                .standard_normal(a.shape)).astype(np.float32),
                     p)
    kw = dict(lr=1e-3, chunk=8, bf16_weights=bf16)
    if bf16:
        jlfn = tlfn = None
    else:
        jlfn = lambda p, b: jlm.loss_fn(cfg, p, b, wt=jtrain.qat_wt,
                                        dtype=jnp.float32, chunk=8)
        tlfn = lambda p, b: lm.loss_fn(tcfg, p, b, wt=train.qat_wt,
                                       dtype=torch.float32, chunk=8)
    jstep = jax.jit(jtrain.make_train_step(cfg, loss_fn=jlfn, **kw))
    tstep = train.make_train_step(tcfg, loss_fn=tlfn, **kw)
    jp, jo = _jax(p), joptim.SgdState(_jax(m))
    tp, to = _port(p), convert.sgd_state_from_numpy(m, device="cpu")
    tol, mtol = (5e-4, 5e-2) if bf16 else (2e-6, 2e-5)
    for step in range(3):
        b = _batch(arch, 4, 16, step=step)
        jp, jo, jl = jstep(jp, jo, _jax(b))
        tp, to, tl = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert abs(float(tl) - float(jl)) < (BF16_MAX_ATOL / 10 if bf16
                                             else F32_ATOL / 10)
        assert _max_diff(tp, jp) < tol, step
        assert _max_diff(to.momentum, jo.momentum) < mtol, step


def test_loss_decreases_over_eight_steps():
    """As the reference's test: its params (key 0), batches of seed 1."""
    tcfg = configs.get_smoke("minitron-4b").with_(microbatch=2)
    params = _port(_ref_params("minitron-4b"))
    opt = optim.sgd_init(params)
    step = train.make_train_step(tcfg, lr=5e-3, chunk=16)
    losses = []
    for s in range(8):
        b = _batch("minitron-4b", 4, 32, step=s)
        params, opt, loss = step(params, opt, {k: torch.from_numpy(v)
                                               for k, v in b.items()})
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for path, w in tree.leaves_with_path(params):
        if wot.is_protected_weight(path, w):
            q, _ = quant.quantize(w)
            assert wot.satisfies_constraint(q.reshape(-1)), path


@pytest.mark.parametrize("step,shard", [(0, 0), (5, 1)])
def test_token_batch_equals_reference(step, shard):
    a = synthetic.token_batch(1000, 4, 33, seed=3, step=step,
                              shard_index=shard, shard_count=2)
    b = jsynthetic.token_batch(1000, 4, 33, seed=3, step=step,
                               shard_index=shard, shard_count=2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_runs_on_cpu(capsys, tmp_path):
    out = launch_train.main(["--device", "cpu", "--steps", "3"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "step    2" in capsys.readouterr().out
    # --ckpt checkpoints at the end (its resume: test_torch_checkpoint.py)
    from repro_torch.training import checkpoint
    launch_train.main(["--device", "cpu", "--steps", "1", "--ckpt",
                       str(tmp_path)])
    assert checkpoint.latest_step(str(tmp_path)) == 1


def test_train_deploy_serve_slice():
    """The slice end to end on the CPU: train two QATT steps, deploy the
    masters on both routes (byte-equal to each other and to the
    reference's encode of the same masters, scales bit-equal), and serve
    the deployed weights clean and with correctable faults only (bit-equal
    logits, every flipped block counted once per step)."""
    from repro.protection import policy as jpolicy
    from repro_torch.launch import serve as launch_serve
    from repro_torch.protection.policy import ProtectionPolicy
    tcfg = configs.get_smoke("deepseek-7b").with_(microbatch=2)
    out = launch_train.train(tcfg, steps=2, batch=4, seq=16, lr=5e-3,
                             chunk=8, device="cpu", backend="cuda",
                             log=lambda *_: None)
    params = out["params"]
    enc = {r: ProtectionPolicy(backend=r).encode_tree(params)
           for r in ("torch", "cuda")}
    jenc = jax.jit(jpolicy.ProtectionPolicy().encode_tree)(
        jax.tree.map(jnp.asarray, tree.map_with_path(
            lambda _, t: t.numpy(), params)))
    n = 0
    for path, pt in tree.leaves_with_path(enc["cuda"]):
        other = tree.get_path(enc["torch"], path)
        if not hasattr(pt, "enc"):
            continue
        ref = tree.get_path(jenc, path)
        n += 1
        assert torch.equal(pt.enc, other.enc), path
        assert pt.scale.numpy().tobytes() == other.scale.numpy().tobytes()
        np.testing.assert_array_equal(pt.enc.numpy(), np.asarray(ref.enc))
        # the scale against the reference's eager compute_scale: under jit
        # XLA divides by 127 through a reciprocal, one ulp off at times
        w = jnp.asarray(tree.get_path(params, path).numpy())
        assert float(pt.scale) == float(jquant.compute_scale(w))
    assert n == 9
    kw = dict(batch=2, tokens=3, backend="cuda", kv_policy="in-place-fused",
              device="cpu", weights=enc["cuda"], log=lambda *_: None)
    clean = launch_serve.serve(tcfg, **kw)
    fixed = launch_serve.serve(tcfg, fault_rate=1e-3, correctable_only=True,
                               **kw)
    flipped = sum(int(p.numel()) for p in fixed["weight_positions"].values())
    assert flipped > 0
    assert fixed["flags"]["corrected"] == 3 * flipped
    assert fixed["flags"]["due"] == 0
    assert torch.equal(fixed["logits"], clean["logits"])
    assert torch.equal(fixed["tokens"], clean["tokens"])

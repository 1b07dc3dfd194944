"""QATT training of the hybrid, ssm and moe families in the port against
the reference: the SSD chunked scan's input gradients at f32 (the scan
once wrote into ``exp``'s output, which ``exp``'s backward reads; inside
the remat'ed block the version check did not see it and the gradients
were silently wrong), then one and two train steps of recurrentgemma-2b,
mamba2-2.7b, deepseek-v2-236b and deepseek-v3-671b smoke from the same
params, momentum and batches, at f32 and with the bf16 defaults.

Weights come from the reference's ``lm.init_params`` through NumPy, the
momentum from the qwen test's seeded draws (test_torch_train.py), the
batches from ``synthetic.token_batch``; each reference step is jitted once
per module. Tolerances are stated beside each comparison.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro import configs as jconfigs
from repro.core import quant as jquant
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro.training import train as jtrain
from repro_torch import configs, convert, tree
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.training import train

ARCHS = ("recurrentgemma-2b", "mamba2-2.7b", "deepseek-v2-236b",
         "deepseek-v3-671b")
MOE = ("deepseek-v2-236b", "deepseek-v3-671b")
LR, BATCH, SEQ, MICRO = 1e-3, 4, 16, 2
# f32: the gradients are summed in another order (f32 noise, times lr 1e-3
# in the masters); as test_torch_train.py holds qwen
F32_TOL, F32_MTOL = 2e-6, 2e-5
# the bf16 defaults: as test_torch_train.py holds qwen (both frameworks
# sum the embedding's gradient in bf16, in different orders; read at most
# 0.041 in the momentum, deepseek-v2-236b's second step)
BF16_TOL, BF16_MTOL = 5e-4, 5e-2
# the step's loss, as test_torch_train.py holds qwen's (a tenth of the
# forward tests' logit tolerances)
LOSS_F32, LOSS_BF16 = 1e-5, 0.0125
# the SSD's input gradients at f32: sums in another order, relative to the
# gradient's largest magnitude
SSD_GRAD_RTOL = 1e-5
# at most this share of (token, layer) pairs may route to another top-k set
# in the bf16 forward (test_torch_moe.py::BF16_ROUTE_FLIP_SHARE)
BF16_ROUTE_FLIP_SHARE = 0.1
MOE_CANDIDATE_ROWS = 8


# ---------------------------------------------------------------------------
# the SSD chunked scan's backward
# ---------------------------------------------------------------------------


def _ssd_inputs(b, l, h, p, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, l, h, p),
            np.log1p(np.exp(f(b, l, h))).astype(np.float32),     # dt > 0
            -np.exp(0.5 * f(h)).astype(np.float32),               # A < 0
            f(b, l, n), f(b, l, n))


@pytest.mark.parametrize("l,chunk", [(16, 16), (64, 16)])
def test_ssd_chunked_input_gradients_match_reference(l, chunk):
    """f32, one chunk and four: the gradients of sum(y * gy) + sum(state *
    gs) with respect to x, dt, A, B and C, against the reference's
    ``jax.grad``; the port's scan is called directly (outside any
    checkpoint, where an in-place write into a saved tensor raises)."""
    b, h, p, n = 2, 3, 4, 5
    ins = _ssd_inputs(b, l, h, p, n, seed=l)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(x, dt, A, B, C):
        y, s = jL._ssd_chunked(x, dt, A, B, C, chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in ins])
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, s = L._ssd_chunked(*ts, chunk)
    ((y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()
     ).backward()
    for name, t, w in zip("x dt A B C".split(), ts, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= SSD_GRAD_RTOL * np.abs(w).max(), (name, err)


def test_mamba2_block_gradients_under_checkpoint_match_reference():
    """The path that hid the fault: the whole f32 loss of mamba2-2.7b
    smoke (every block under ``torch.utils.checkpoint``), 2 x 16 tokens,
    no QAT: every leaf's gradient within 1e-5 of the reference's (read:
    A_log 3.83e-5 against 4.66e-4 before the repair)."""
    arch = "mamba2-2.7b"
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    p = P.reference_params(arch)
    b = P.token_batch(arch, 2, 16)
    want = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(
        cfg, p, b, dtype=jnp.float32, chunk=8)))(P.jax_params(p),
                                                  P.jax_params(b))
    tp = P.port_params(p)
    for _, t in tree.leaves_with_path(tp):
        t.requires_grad_()
    lm.loss_fn(tcfg, tp, {k: torch.from_numpy(v) for k, v in b.items()},
               dtype=torch.float32, chunk=8).backward()
    grads = tree.map_with_path(lambda _, t: t.grad, tp)
    assert P.max_diff(grads, jax.tree.map(np.asarray, want)) < 1e-5


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def _momentum(p):
    """The qwen test's seeded initial momentum (test_torch_train.py)."""
    return jax.tree.map(lambda a: (0.01 * np.random.default_rng(a.size)
                                   .standard_normal(a.shape)).astype(
        np.float32), p)


def _dividing_scale(x, axis=None, eps=1e-12):
    """The reference's ``quant.compute_scale`` as its eager step computes
    it, a true division by 127, kept so under ``jax.jit``: XLA rewrites a
    division by a constant into a product with its f32 reciprocal, one ulp
    off the division now and then. The port divides."""
    amax = jnp.max(jnp.abs(x), axis=axis, keepdims=axis is not None)
    return jnp.maximum(amax, eps) / jax.lax.optimization_barrier(
        jnp.float32(jquant.QMAX))


# f32 rows where the jitted reference's reciprocal scale shows: at
# deepseek-v2-236b's second step it moved one weight across a rounding
# boundary (loss 1.4e-5 off, the routing the same in both packages), so
# its reference step divides as its eager step does
DIVIDING_REFERENCE = ("deepseek-v2-236b",)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, bf16, divide=False):
    """The reference's train step, jitted; ``divide``: traced with
    :func:`_dividing_scale` as its ``quant.compute_scale``."""
    cfg = jconfigs.get_smoke(arch).with_(microbatch=MICRO)
    lfn = None if bf16 else (lambda p, b: jlm.loss_fn(
        cfg, p, b, wt=jtrain.qat_wt, dtype=jnp.float32, chunk=8))
    step = jtrain.make_train_step(cfg, lr=LR, chunk=8, bf16_weights=bf16,
                                  loss_fn=lfn)
    if not divide:
        return jax.jit(step)

    def traced(*args):
        with mock.patch.object(jquant, "compute_scale", _dividing_scale):
            return step(*args)
    return jax.jit(traced)


def _port_step(arch, bf16):
    tcfg = configs.get_smoke(arch).with_(microbatch=MICRO)
    lfn = None if bf16 else (lambda p, b: lm.loss_fn(
        tcfg, p, b, wt=train.qat_wt, dtype=torch.float32, chunk=8))
    return train.make_train_step(tcfg, lr=LR, chunk=8, bf16_weights=bf16,
                                 loss_fn=lfn)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_train_steps_match_reference(arch):
    """Two QATT steps at f32 (f32 masters, weights and activations) from
    the same params, momentum and batches: masters within F32_TOL and
    momentum within F32_MTOL after each step, every leaf held. The port
    runs as it is; the reference's jitted step takes the fake-quant scale
    as absmax x f32(1/127), and for the rows of DIVIDING_REFERENCE it
    divides instead, as its eager step does (an eager step takes tens of
    seconds here)."""
    p = P.reference_params(arch)
    m = _momentum(p)
    jstep = _reference_step(arch, False, arch in DIVIDING_REFERENCE)
    tstep = _port_step(arch, False)
    jp, jo = P.jax_params(p), joptim.SgdState(P.jax_params(m))
    tp, to = P.port_params(p), convert.sgd_state_from_numpy(m, device="cpu")
    for step in range(2):
        b = P.token_batch(arch, BATCH, SEQ, step=step)
        jp, jo, jl = jstep(jp, jo, P.jax_params(b))
        tp, to, tl = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert abs(float(tl) - float(jl)) < LOSS_F32, step
        assert P.max_diff(tp, jp) < F32_TOL, step
        assert P.max_diff(to.momentum, jo.momentum) < F32_MTOL, step


_REF_ROUTING: list = []   # the reference's top-k indices, call by call


@functools.lru_cache(maxsize=None)
def _reference_bf16_forward(arch):
    """The reference's bf16 QAT forward, jitted, recording its moe routing
    (``jax.lax.top_k``'s indices, through a debug callback) into
    ``_REF_ROUTING`` at every call."""
    cfg = jconfigs.get_smoke(arch)
    real = jax.lax.top_k

    def spy(x, k):
        w, i = real(x, k)
        jax.debug.callback(lambda a: _REF_ROUTING.append(np.asarray(a)), i,
                           ordered=True)
        return w, i

    def fwd(p, t):
        jax.lax.top_k = spy     # while tracing only
        try:
            return jlm.forward(cfg, p, t, wt=jtrain.qat_wt_bf16,
                               dtype=jnp.bfloat16, chunk=8)
        finally:
            jax.lax.top_k = real
    return jax.jit(fwd)


def _rows_routed_alike(arch, jp, tp, tokens, monkeypatch):
    """The bf16 QAT forward of both packages over ``tokens`` (B, S) from
    their own params: -> (rows whose every (token, layer) pair took the
    same top-k set in both, share of pairs routed differently). A row is
    its own routing group and attends only to itself, so its gradient is
    the same function in both packages exactly when its routing is."""
    _REF_ROUTING.clear()
    _reference_bf16_forward(arch)(jp, jnp.asarray(tokens))
    jax.effects_barrier()
    tstore: list = []
    real = L.top_k_lower_first

    def spy(x, k):
        w, i = real(x, k)
        tstore.append(i.numpy())
        return w, i
    with monkeypatch.context() as mp, torch.no_grad():
        mp.setattr(L, "top_k_lower_first", spy)
        lm.forward(configs.get_smoke(arch), tp, torch.from_numpy(tokens),
                   wt=train.qat_wt_bf16, dtype=torch.bfloat16, chunk=8)
    assert len(_REF_ROUTING) == len(tstore) > 0
    flips = np.stack([(np.sort(j, -1) != np.sort(t, -1)).any(-1)
                      for j, t in zip(_REF_ROUTING, tstore)])  # (L, B, S)
    return ~flips.any((0, 2)), float(flips.mean())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_steps_match_reference(arch, monkeypatch):
    """Two QATT steps with the defaults (bf16 weights and activations):
    masters within BF16_TOL and momentum within BF16_MTOL after each step.

    The moe family in bf16 routes a few tokens to other experts in the two
    packages (a gate within a bf16 rounding of the k-th one), and such a
    row's gradient is another function. So for it each step's batch is
    the first BATCH rows routed alike of MOE_CANDIDATE_ROWS seeded rows
    (at most BF16_ROUTE_FLIP_SHARE of the pairs route differently), and
    that batch is checked to route alike on its own too."""
    moe = arch in MOE
    p = P.reference_params(arch)
    m = _momentum(p)
    jstep, tstep = _reference_step(arch, True), _port_step(arch, True)
    jp, jo = P.jax_params(p), joptim.SgdState(P.jax_params(m))
    tp, to = P.port_params(p), convert.sgd_state_from_numpy(m, device="cpu")
    for step in range(2):
        b = P.token_batch(arch, MOE_CANDIDATE_ROWS if moe else BATCH, SEQ,
                          step=step)
        if moe:
            alike, share = _rows_routed_alike(arch, jp, tp, b["tokens"],
                                              monkeypatch)
            assert share <= BF16_ROUTE_FLIP_SHARE, share
            rows = np.flatnonzero(alike)[:BATCH]
            assert rows.size == BATCH, alike
            b = {k: v[rows] for k, v in b.items()}
            assert _rows_routed_alike(arch, jp, tp, b["tokens"],
                                      monkeypatch)[0].all()
        jp, jo, jl = jstep(jp, jo, P.jax_params(b))
        tp, to, tl = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert abs(float(tl) - float(jl)) < LOSS_BF16, step
        assert P.max_diff(tp, jp) < BF16_TOL, step
        assert P.max_diff(to.momentum, jo.momentum) < BF16_MTOL, step

"""Guarded and int8 serving of the hybrid, ssm and moe families against
the reference's XLA route: recurrentgemma-2b, mamba2-2.7b and
deepseek-v2-236b smoke under the three guarded modes of
``torch_parity.guarded`` (static int8 with clamps and ABFT, dynamic int8
with ABFT, float with ABFT and clamps), the decode step and the cache-less
prefill, on both of the port's routes (on the CPU the ``cuda`` route's
kernel wrappers take their plain versions).

Both packages serve the same weights, tokens and calibrated scales (the
reference's). Flag dicts, ABFT rows included, must be exactly equal;
logits agree within ``F32_TOL``. The hybrid smoke config (6 layers) has
no tail; the tail's ``"tail_abft"`` decode row is held on the 8-layer
model against the reference's cache-less forward over the same token,
because the reference's own guarded decode with a tail raises
``UnexpectedTracerError`` (its tail scan leaves ABFT tracers in the
sink): :func:`test_reference_guarded_decode_with_a_tail` records that,
and compares the row directly the day it runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro import configs as jconfigs
from repro import protection as jprotection
from repro.models import lm as jlm
from repro.serving import protected as jprot
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.protection import ProtectionPolicy
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import protected as tprot

# f32 serving, as test_torch_guarded_serve.py: exact int32 accumulators, f32
# activations around them a last ulp apart
F32_TOL = 1e-3
# Dynamic int8 quantizes each token's activations by its own absmax: an
# activation one f32 ulp from a rounding boundary moves one int8 step. In
# deepseek-v2-236b's dynamic prefill, token (1, 4) is such a token: the
# port's own logits move by 0.0353 when the embedding scale moves by one
# ulp, and the reference's differ from the port's by that much there. At
# most BOUNDARY_TOKENS tokens of a prefill may differ past F32_TOL, each by
# at most BOUNDARY_ATOL.
BOUNDARY_TOKENS, BOUNDARY_ATOL = 1, 0.05
BATCH, STEPS, MAX_LEN, PROMPT = 2, 2, 32, 16
ARCHS = ("recurrentgemma-2b", "mamba2-2.7b", "deepseek-v2-236b")
MODES = ("static-clamp-abft", "dynamic-abft", "float-abft-clamp")


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, mode):
    cfg, jplan, exported, scales = P.calibrated_model(arch)
    _, _, _, jenc = P._reference_model(arch)
    jp, aq = P.guarded(jplan, scales, mode)
    step = jax.jit(jprot.make_serve_step(cfg, plan=jp, with_flags=True,
                                         dtype=jnp.float32, act_quant=aq))
    cache = jlm.init_cache(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    fed = P.seeded_tokens(cfg, (STEPS, BATCH, 1), 11)
    logits, flags = [], []
    for t in range(STEPS):
        lg, cache, fl = step(jenc, cache, jnp.asarray(fed[t]),
                             jnp.full((BATCH,), t, jnp.int32))
        logits.append(np.asarray(lg[:, 0], np.float32))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return exported, fed, np.stack(logits), flags


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_guarded_decode_matches_the_reference(arch, mode):
    exported, fed, ref_logits, ref_flags = _reference_decode(arch, mode)
    cfg, _, _, scales = P.calibrated_model(arch)
    tp, aq = P.guarded(P.port_plan(arch), scales, mode)
    enc = convert.protected_from_numpy(exported, device="cpu")
    for backend in ("torch", "cuda"):
        step = tprot.make_serve_step(cfg, plan=tp, backend=backend,
                                     dtype=torch.float32, act_quant=aq)
        cache = tkv.init_cache(cfg, BATCH, MAX_LEN, dtype=torch.float32,
                               device="cpu")
        for t in range(STEPS):
            lg, cache, fl = step(enc, cache, torch.from_numpy(fed[t]).long(),
                                 torch.full((BATCH,), t, dtype=torch.int32))
            P.assert_flag_dict_equal(ref_flags[t],
                                     {k: v.numpy() for k, v in fl.items()})
            np.testing.assert_allclose(lg[:, 0].numpy(), ref_logits[t],
                                       rtol=F32_TOL, atol=F32_TOL)
    assert "layers_abft" in ref_flags[0] and "top_abft" in ref_flags[0]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_guarded_prefill_matches_the_reference(arch, mode):
    """The cache-less prefill (``lm.forward`` with flags)."""
    cfg, jplan, exported, scales = P.calibrated_model(arch)
    _, _, _, jenc = P._reference_model(arch)
    toks = P.seeded_tokens(cfg, (BATCH, PROMPT), 5)
    jp, aq = P.guarded(jplan, scales, mode)
    ref_logits, ref_flags = jax.jit(jprot.make_prefill(
        cfg, plan=jp, chunk=16, with_flags=True, dtype=jnp.float32,
        act_quant=aq))(jenc, jnp.asarray(toks))
    tp, _ = P.guarded(P.port_plan(arch), scales, mode)
    enc = convert.protected_from_numpy(exported, device="cpu")
    for backend in ("torch", "cuda"):
        logits, flags = tprot.make_prefill(
            cfg, plan=tp, chunk=16, with_flags=True, dtype=torch.float32,
            act_quant=aq, backend=backend)(enc, torch.from_numpy(toks).long())
        P.assert_flag_dict_equal({k: np.asarray(v)
                                  for k, v in ref_flags.items()},
                                 {k: v.numpy() for k, v in flags.items()})
        _assert_prefill_logits(logits.numpy(), np.asarray(ref_logits),
                               dynamic=aq == "dynamic")


def _assert_prefill_logits(got, ref, *, dynamic):
    if not dynamic:
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
        return
    d = np.abs(got - ref) - F32_TOL * np.abs(ref)
    off = d.max(-1) > F32_TOL                       # (B, S) tokens
    assert off.sum() <= BOUNDARY_TOKENS, np.argwhere(off)
    assert np.abs(got - ref)[off].max(initial=0) <= BOUNDARY_ATOL


def test_int8_conv_arch_prefill_matches_the_reference():
    """The counterpart of the reference's
    ``test_int8_serving.py::test_int8_conv_arch_prefill_runs`` (mamba2-2.7b,
    seed 2, dynamic int8, chunk 16) on its XLA route: conv kernels decode
    to tensors, matmul projections quantize; flags equal and logits within
    ``F32_TOL`` in f32, and the default bf16 prefill finite."""
    cfg = jconfigs.get_smoke("mamba2-2.7b")
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(
        jax.random.PRNGKey(2))
    plan = jprot.make_plan(params, jprotection.ProtectionPolicy(
        backend="xla"))
    jenc = plan.encode_tree(params)
    toks = np.zeros((2, 16), np.int32)
    ref_logits, ref_flags = jax.jit(jprot.make_prefill(
        cfg, plan=plan, chunk=16, act_quant="dynamic", with_flags=True,
        dtype=jnp.float32))(jenc, jnp.asarray(toks), {})
    tcfg = tconfigs.get_smoke("mamba2-2.7b")
    tplan = ProtectionPolicy().plan(tlm.param_shapes(tcfg))
    enc = convert.protected_from_numpy(P.export(jenc), device="cpu")
    for backend in ("torch", "cuda"):
        logits, flags = tprot.make_prefill(
            tcfg, plan=tplan, chunk=16, act_quant="dynamic", with_flags=True,
            dtype=torch.float32, backend=backend)(
            enc, torch.from_numpy(toks).long(), {})
        P.assert_flag_dict_equal({k: np.asarray(v)
                                  for k, v in ref_flags.items()},
                                 {k: v.numpy() for k, v in flags.items()})
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=F32_TOL, atol=F32_TOL)
    out = tprot.make_prefill(tcfg, plan=tplan, chunk=16,
                             act_quant="dynamic")(
        enc, torch.from_numpy(toks).long(), {})
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(
        out.float()).all())


@functools.lru_cache(maxsize=None)
def _tail_model():
    """recurrentgemma-2b smoke at 8 layers (two super-blocks and a 2-layer
    tail): (cfg, reference plan, encoded tree, f32 scales)."""
    cfg = jconfigs.get_smoke("recurrentgemma-2b").with_(n_layers=8)
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    plan = jprotection.ProtectionPolicy(backend="xla").plan(params)
    enc = jax.jit(plan.encode_tree)(params)
    toks = jnp.asarray(P.seeded_tokens(cfg, P.CAL_SHAPE, 3))
    scales = jprot.calibrate_act_scales(cfg, enc, toks, plan=plan,
                                        backend="xla", dtype=jnp.float32,
                                        chunk=16)
    return cfg, plan, enc, scales


@pytest.mark.parametrize("mode", MODES)
def test_tail_abft_decode_row_matches_the_reference_forward(mode):
    """The port's guarded decode at position 0 of the 8-layer model against
    the reference's cache-less forward over the same token: the
    ``layers_abft`` and ``tail_abft`` rows and every ECC row equal."""
    cfg, jplan, jenc, scales = _tail_model()
    tok = P.seeded_tokens(cfg, (BATCH, 1), 7)
    jp, aq = P.guarded(jplan, scales, mode)
    _, ref = jax.jit(jprot.make_prefill(
        cfg, plan=jp, chunk=16, with_flags=True, dtype=jnp.float32,
        act_quant=aq))(jenc, jnp.asarray(tok))
    tcfg = tconfigs.get_smoke("recurrentgemma-2b").with_(n_layers=8)
    tp, _ = P.guarded(ProtectionPolicy().plan(tlm.param_shapes(tcfg)),
                      scales, mode)
    enc = convert.protected_from_numpy(P.export(jenc), device="cpu")
    for backend in ("torch", "cuda"):
        step = tprot.make_serve_step(tcfg, plan=tp, backend=backend,
                                     dtype=torch.float32, act_quant=aq)
        cache = tkv.init_cache(tcfg, BATCH, MAX_LEN, dtype=torch.float32,
                               device="cpu")
        _, _, flags = step(enc, cache, torch.from_numpy(tok).long(),
                           torch.zeros((BATCH,), dtype=torch.int32))
        assert "tail_abft" in flags
        for k in ("layers_abft", "tail_abft", "layers", "tail", "top"):
            np.testing.assert_array_equal(flags[k].numpy(),
                                          np.asarray(ref[k]), err_msg=k)


def test_reference_guarded_decode_with_a_tail():
    """The reference's guarded decode of a hybrid model with a tail: today
    it raises ``UnexpectedTracerError`` (the tail's scan appends ABFT
    tracers to the global sink, which the serve step drains outside the
    scan). Should it run, its rows are held to the port's directly."""
    cfg, jplan, jenc, _ = _tail_model()
    tok = P.seeded_tokens(cfg, (BATCH, 1), 7)
    step = jprot.make_serve_step(cfg, plan=jplan.with_abft(True),
                                 with_flags=True, dtype=jnp.float32)
    cache = jlm.init_cache(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    try:
        _, _, ref = step(jenc, cache, jnp.asarray(tok),
                         jnp.zeros((BATCH,), jnp.int32))
    except jax.errors.UnexpectedTracerError:
        return
    tcfg = tconfigs.get_smoke("recurrentgemma-2b").with_(n_layers=8)
    tp = ProtectionPolicy().plan(tlm.param_shapes(tcfg)).with_abft(True)
    enc = convert.protected_from_numpy(P.export(jenc), device="cpu")
    _, _, flags = tprot.make_serve_step(tcfg, plan=tp, dtype=torch.float32)(
        enc, tkv.init_cache(tcfg, BATCH, MAX_LEN, dtype=torch.float32,
                            device="cpu"),
        torch.from_numpy(tok).long(), torch.zeros((BATCH,), dtype=torch.int32))
    P.assert_flag_dict_equal({k: np.asarray(v) for k, v in ref.items()},
                             {k: v.numpy() for k, v in flags.items()})

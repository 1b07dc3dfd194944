"""The guarded serve paths of the port against the reference's XLA route:
the cache-less prefill and the decode step under ``act_quant`` ("static",
"dynamic", "plan") with ABFT and activation clamps, clean and faulted, for
deepseek-7b smoke, minitron-4b smoke (GQA), qwen1.5-4b smoke (qkv
bias) and paligemma-3b smoke (vlm: tied head, one KV head), on both of the port's routes (on the CPU the ``cuda`` route's
kernel wrappers take their plain versions).

Both packages serve the same weights, fault mask, tokens and calibrated
scales (the reference's). Flags and the ``top_abft`` / ``layers_abft``
rows must be exactly equal; logits agree within ``F32_TOL``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro.models import lm as jlm
from repro.serving import protected as jprot
from repro_torch import convert
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import protected as tprot

# f32 serving: the int8 accumulators are exact on both sides; the f32
# activations around them (norms, rope, softmax) differ in the last ulp,
# which can move a quantized activation across a rounding boundary
F32_TOL = 1e-3
BATCH, STEPS, MAX_LEN = 2, 2, 32


@pytest.mark.parametrize("mode", ["static-clamp-abft", "dynamic-abft",
                                  "float-abft-clamp"])
def test_cache_less_prefill_matches_the_reference(mode):
    """``make_prefill`` without a KV policy runs ``lm.forward`` with flags:
    logits and every flags row, ABFT rows included, as the reference's."""
    arch = "minitron-4b"
    cfg, jplan, exported, scales = P.calibrated_model(arch)
    _, _, _, jenc = P._reference_model(arch)
    toks = P.seeded_tokens(cfg, (BATCH, 16), 5)
    jp, aq = P.guarded(jplan, scales, mode)
    ref_logits, ref_flags = jax.jit(jprot.make_prefill(
        cfg, plan=jp, chunk=16, with_flags=True, dtype=jnp.float32,
        act_quant=aq))(jenc, jnp.asarray(toks))
    tp, _ = P.guarded(P.port_plan(arch), scales, mode)
    enc = convert.protected_from_numpy(exported, device="cpu")
    for backend in ("torch", "cuda"):
        prefill = tprot.make_prefill(cfg, plan=tp, chunk=16, with_flags=True,
                                     dtype=torch.float32, act_quant=aq,
                                     backend=backend)
        logits, flags = prefill(enc, torch.from_numpy(toks).long())
        P.assert_flag_dict_equal(
            {k: np.asarray(v) for k, v in ref_flags.items()},
            {k: v.numpy() for k, v in flags.items()})
        assert "layers_abft" in flags and "top_abft" in flags
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=F32_TOL, atol=F32_TOL)
    plain = tprot.make_prefill(cfg, chunk=16)
    assert plain(enc, torch.from_numpy(toks).long()).shape == (
        BATCH, 16, cfg.vocab_padded)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, mode):
    cfg, jplan, _, scales = P.calibrated_model(arch)
    jp, aq = P.guarded(jplan, scales, mode)
    return jax.jit(jprot.make_serve_step(cfg, plan=jp, with_flags=True,
                                         dtype=jnp.float32, act_quant=aq))


@functools.lru_cache(maxsize=None)
def _reference_serve(arch, mode, faulted):
    cfg, _, exported, _ = P.calibrated_model(arch)
    _, _, _, jenc = P._reference_model(arch)
    if faulted:
        exported = P._flip_exported(exported, seed=17)
        jenc = P._reimport(jenc, exported)
    step = _reference_step(arch, mode)
    cache = jlm.init_cache(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    fed = P.seeded_tokens(cfg, (STEPS, BATCH, 1), 11)
    logits, flags = [], []
    for t in range(STEPS):
        lg, cache, fl = step(jenc, cache, jnp.asarray(fed[t]),
                             jnp.full((BATCH,), t, jnp.int32))
        logits.append(np.asarray(lg[:, 0], np.float32))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return exported, fed, np.stack(logits), flags


def _port_serve(arch, mode, exported, fed, backend):
    cfg, _, _, scales = P.calibrated_model(arch)
    tp, aq = P.guarded(P.port_plan(arch), scales, mode)
    enc = convert.protected_from_numpy(exported, device="cpu")
    step = tprot.make_serve_step(cfg, plan=tp, backend=backend,
                                 dtype=torch.float32, act_quant=aq)
    cache = tkv.init_cache(cfg, BATCH, MAX_LEN, dtype=torch.float32,
                           device="cpu")
    logits, flags = [], []
    for t in range(STEPS):
        lg, cache, fl = step(enc, cache, torch.from_numpy(fed[t]).long(),
                             torch.full((BATCH,), t, dtype=torch.int32))
        logits.append(lg[:, 0].numpy())
        flags.append({k: v.numpy() for k, v in fl.items()})
    return np.stack(logits), flags


SERVE_CASES = [("deepseek-7b", m) for m in ("static-clamp-abft", "static",
                                            "dynamic-abft",
                                            "float-abft-clamp")] + [
    ("minitron-4b", "static-clamp-abft"), ("qwen1.5-4b", "static-clamp-abft"),
    ("qwen1.5-4b", "dynamic-abft"), ("paligemma-3b", "static-clamp-abft")]


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("arch,mode", SERVE_CASES)
def test_guarded_serve_step_matches_the_reference(arch, mode, faulted):
    """Flags, ``top_abft`` and ``layers_abft`` exactly equal on both routes;
    logits within ``F32_TOL``; no mismatch on clean or memory-faulted
    weights (ABFT watches the compute; the decode feeds it)."""
    exported, fed, ref_logits, ref_flags = _reference_serve(arch, mode,
                                                            faulted)
    for backend in ("torch", "cuda"):
        logits, flags = _port_serve(arch, mode, exported, fed, backend)
        for r, g in zip(ref_flags, flags):
            P.assert_flag_dict_equal(r, g)
        np.testing.assert_allclose(logits, ref_logits, rtol=F32_TOL,
                                   atol=F32_TOL)
    guarded = mode != "static"
    assert ("layers_abft" in flags[0]) == guarded
    if guarded:
        assert all(int(f["layers_abft"][:, 0].sum()) == 0 for f in flags)
    if faulted:
        assert sum(int(f["layers"][:, 0].sum()) for f in flags) > 0

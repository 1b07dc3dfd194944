"""The whole-tree decode ablations of the serve step and the prefill against
the reference's XLA route.

``make_serve_step(decode_at_use=False)`` decodes the whole tree every
step, ``make_serve_step(decode_per_step=False)`` serves a tree decoded once
outside the step, and ``make_prefill(decode_at_use=False)`` decodes the
whole tree before the cache-less forward. deepseek-7b, recurrentgemma-2b,
mamba2-2.7b, deepseek-v2-236b and whisper-base smoke (whisper's prefill
over seeded ``enc_embeds`` frames), in f32, on both of the port's routes:
the plan's codec route is "torch" or "cuda" (on the CPU the ``cuda``
route's wrappers take their plain versions). Logits agree with the
reference's within ``F32_TOL``. Also: ``with_flags=False`` returns the
reference's ``(logits, cache)``, and a whole-tree path refuses
``act_quant`` and ``with_flags`` with the reference's ``ValueError``.
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
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.protection import ProtectionPolicy
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import protected as tprot

# f32 on both sides; the sums around the matmuls differ in the last ulps
F32_TOL = 1e-4
BATCH, STEPS, MAX_LEN, PROMPT = 2, 2, 32, 12
ARCHS = ("deepseek-7b", "recurrentgemma-2b", "mamba2-2.7b",
         "deepseek-v2-236b", "whisper-base")
MODES = {"whole-tree": dict(decode_at_use=False),
         "decode-once": dict(decode_per_step=False)}


def _frames(cfg, seed=5):
    """(BATCH, enc_seq, d_model) encoder frames, bf16 values as f32."""
    x = np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _reference_steps(arch, mode):
    """The reference's ablation over ``STEPS`` fed tokens -> (fed, logits
    (T, B, V))."""
    cfg, plan, _, enc = P._reference_model(arch)
    step = jax.jit(jprot.make_serve_step(cfg, plan=plan, dtype=jnp.float32,
                                         **MODES[mode]))
    params = enc if mode == "whole-tree" else jax.jit(
        lambda e: plan.decode_tree(e, jnp.float32))(enc)
    cache = jlm.init_cache(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    fed = P.seeded_tokens(cfg, (STEPS, BATCH, 1), 11)
    logits = []
    for t in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(fed[t]),
                         jnp.full((BATCH,), t, jnp.int32))
        logits.append(np.asarray(lg[:, 0], np.float32))
    return fed, np.stack(logits)


def _port(arch, backend):
    cfg = tconfigs.get_smoke(arch)
    plan = ProtectionPolicy(backend=backend).plan(tlm.param_shapes(cfg))
    enc = convert.protected_from_numpy(
        P.export(P._reference_model(arch)[3]), device="cpu")
    return cfg, plan, enc


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_tree_serve_step_matches_the_reference(arch, mode, backend):
    fed, ref = _reference_steps(arch, mode)
    cfg, plan, enc = _port(arch, backend)
    step = tprot.make_serve_step(cfg, plan=plan, backend=backend,
                                 dtype=torch.float32, **MODES[mode])
    params = enc if mode == "whole-tree" else plan.decode_tree(
        enc, torch.float32)
    cache = tkv.init_cache(cfg, BATCH, MAX_LEN, dtype=torch.float32,
                           device="cpu")
    for t in range(STEPS):
        out = step(params, cache, torch.from_numpy(fed[t]).long(),
                   torch.full((BATCH,), t, dtype=torch.int32))
        assert len(out) == 2          # the whole-tree paths carry no flags
        lg, cache = out
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[t], rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {t}")


@functools.lru_cache(maxsize=None)
def _reference_prefill(arch):
    cfg, plan, _, enc = P._reference_model(arch)
    toks = P.seeded_tokens(cfg, (BATCH, PROMPT), 4)
    extras = ({"enc_embeds": jnp.asarray(_frames(cfg))}
              if cfg.family == "encdec" else {})
    logits = jax.jit(jprot.make_prefill(cfg, plan=plan, dtype=jnp.float32,
                                        chunk=16, decode_at_use=False))(
        enc, jnp.asarray(toks), extras)
    return toks, np.asarray(logits)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_tree_prefill_matches_the_reference(arch, backend):
    toks, ref = _reference_prefill(arch)
    cfg, plan, enc = _port(arch, backend)
    extras = ({"enc_embeds": torch.from_numpy(_frames(cfg))}
              if cfg.family == "encdec" else None)
    logits = tprot.make_prefill(cfg, plan=plan, backend=backend,
                                dtype=torch.float32, chunk=16,
                                decode_at_use=False)(
        enc, torch.from_numpy(toks).long(), extras)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=F32_TOL,
                               atol=F32_TOL)


def test_with_flags_false_returns_the_references_form():
    """``with_flags=False`` on the decode-at-use step returns ``(logits,
    cache)``, as the reference's default does, with the same logits as the
    flagged step; the flagged step keeps its three-tuple."""
    arch = "deepseek-7b"
    cfg, plan, _, jenc = P._reference_model(arch)
    jcache = jlm.init_cache(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    tok = P.seeded_tokens(cfg, (BATCH, 1), 3)
    ref = jax.jit(jprot.make_serve_step(cfg, plan=plan, dtype=jnp.float32))(
        jenc, jcache, jnp.asarray(tok), jnp.zeros((BATCH,), jnp.int32))
    assert len(ref) == 2
    tcfg, tplan, enc = _port(arch, "torch")
    outs = {}
    for flags in (False, True):
        cache = tkv.init_cache(tcfg, BATCH, MAX_LEN, dtype=torch.float32,
                               device="cpu")
        outs[flags] = tprot.make_serve_step(
            tcfg, plan=tplan, dtype=torch.float32, with_flags=flags)(
            enc, cache, torch.from_numpy(tok).long(),
            torch.zeros((BATCH,), dtype=torch.int32))
    assert len(outs[False]) == 2 and len(outs[True]) == 3
    assert torch.equal(outs[False][0], outs[True][0])
    np.testing.assert_allclose(outs[False][0].numpy(), np.asarray(ref[0]),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("make", ["serve_step", "prefill"])
def test_whole_tree_paths_raise_the_references_errors(make):
    """act_quant and with_flags need decode at use, in both packages."""
    arch = "deepseek-7b"
    jcfg, jplan, _, _ = P._reference_model(arch)
    cfg, plan, _ = _port(arch, "torch")
    for kw, match in ((dict(act_quant="dynamic"), "act_quant"),
                      (dict(with_flags=True), "with_flags")):
        for mod, c, p in ((jprot, jcfg, jplan), (tprot, cfg, plan)):
            with pytest.raises(ValueError, match=match):
                getattr(mod, f"make_{make}")(c, plan=p, decode_at_use=False,
                                             **kw)
    if make == "serve_step":
        with pytest.raises(ValueError, match="with_flags"):
            tprot.make_serve_step(cfg, plan=plan, decode_per_step=False,
                                  with_flags=True)

"""Shared drivers for the serve-step parity tests of the port
(``test_torch_serve*.py``): run the reference's decode-at-use serve step
(XLA route) and the port's on the same weights, fault mask and tokens.

Weights come from the reference's ``lm.init_params`` and its encoded tree
is carried across with ``repro_torch.convert``; a fault mask is drawn once
with NumPy and XORed into both packages' encoded images.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs, protection
from repro.core import faults as jfaults
from repro.models import lm as jlm
from repro.protection.tensor import is_protected_tensor
from repro.serving import kvcache as jkv
from repro.serving import protected as jprot
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.data import synthetic
from repro_torch.models import lm as tlm
from repro_torch.protection import ProtectionPolicy as TProtectionPolicy
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import protected as tprot

# every arch the port serves: the parity tests run each one's smoke config
ARCHS = tuple(tconfigs.ARCH_IDS)
# the archs with a paged KV cache (the encdec family serves its dense cache
# only, in the reference too)
PAGED_ARCHS = tuple(a for a in ARCHS
                    if tkv.supports_paged(tconfigs.get_smoke(a)))
BATCH, STEPS, MAX_LEN = 2, 3, 32
FAULT_RATE = 2e-3
CAL_SHAPE = (2, 16)   # calibration tokens of the int8 tests


def export(enc):
    """Reference encoded tree -> nested dict of NumPy arrays, protected
    leaves as ``{"enc", "checks", "scale", "scheme_id", "orig_shape"}``."""
    if isinstance(enc, dict):
        return {k: export(v) for k, v in enc.items()}
    if is_protected_tensor(enc):
        return {"enc": np.asarray(enc.enc),
                "checks": (None if enc.checks is None
                           else np.asarray(enc.checks)),
                "scale": np.asarray(enc.scale), "scheme_id": enc.scheme_id,
                "orig_shape": tuple(enc.orig_shape)}
    return np.asarray(enc)


def _flip_exported(tree, seed):
    """XOR one seeded NumPy fault mask into every exported image."""
    counter = [seed]

    def walk(t):
        if isinstance(t, dict) and "scheme_id" in t:
            counter[0] += 1
            img = t["enc"]
            return {**t, "enc": jfaults.inject(img.reshape(-1), FAULT_RATE,
                                               counter[0]).reshape(img.shape)}
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return t
    return walk(tree)


def _reimport(enc, exported):
    """Reference encoded tree with the (faulted) exported images."""
    if isinstance(enc, dict):
        return {k: _reimport(v, exported[k]) for k, v in enc.items()}
    if is_protected_tensor(enc):
        return dataclasses.replace(enc, enc=jnp.asarray(exported["enc"]))
    return enc


@functools.lru_cache(maxsize=None)
def _reference_model(arch):
    cfg = configs.get_smoke(arch)
    # jitted: one compile instead of one per eager op
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.PRNGKey(0))
    plan = protection.ProtectionPolicy(backend="xla").plan(params)
    return cfg, plan, params, jax.jit(plan.encode_tree)(params)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, kv, dtype):
    cfg, plan, _, _ = _reference_model(arch)
    return jax.jit(jprot.make_serve_step(
        cfg, plan=plan, with_flags=True, kv_policy=kv,
        dtype=getattr(jnp, dtype)))


@functools.lru_cache(maxsize=None)
def reference_run(arch, kv, dtype, faulted):
    """-> (exported encoded tree, tokens fed per step, logits (T,B,V) f32,
    greedy tokens (T,B), flags per step as NumPy dicts)."""
    cfg, _, _, enc = _reference_model(arch)
    exported = export(enc)
    if faulted:
        exported = _flip_exported(exported, seed=17)
        enc = _reimport(enc, exported)
    step = _reference_step(arch, kv, dtype)
    jdt = getattr(jnp, dtype)
    cache = (jkv.init_cache(cfg, BATCH, MAX_LEN, kv_policy=kv, dtype=jdt)
             if kv is None else jkv.init_cache(cfg, BATCH, MAX_LEN,
                                               kv_policy=kv))
    tok = jnp.zeros((BATCH, 1), jnp.int32)
    fed, logits, greedy, flags = [], [], [], []
    for t in range(STEPS):
        fed.append(np.asarray(tok))
        lg, cache, fl = step(enc, cache, tok, jnp.full((BATCH,), t, jnp.int32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        logits.append(np.asarray(lg[:, 0].astype(jnp.float32)))
        greedy.append(np.asarray(tok[:, 0]))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return exported, fed, np.stack(logits), np.stack(greedy), flags


def port_run(arch, kv, dtype, exported, fed, *, backend="torch"):
    """The port's serve step on the same weights and fed tokens."""
    cfg = tconfigs.get_smoke(arch)
    enc = convert.protected_from_numpy(exported, device="cpu")
    tdt = getattr(torch, dtype)
    step = tprot.make_serve_step(cfg, backend=backend, kv_policy=kv,
                                 dtype=tdt)
    cache = tkv.init_cache(cfg, BATCH, MAX_LEN, kv_policy=kv, dtype=tdt,
                           device="cpu")
    logits, greedy, flags = [], [], []
    for t in range(STEPS):
        lg, cache, fl = step(enc, cache, torch.tensor(fed[t], dtype=torch.long),
                             torch.full((BATCH,), t, dtype=torch.int32))
        logits.append(lg[:, 0].float().numpy())
        greedy.append(lg.argmax(-1)[:, 0].numpy())
        flags.append({k: v.numpy() for k, v in fl.items()})
    return np.stack(logits), np.stack(greedy), flags


def assert_flags_equal(ref, port):
    for r, p in zip(ref, port):
        assert sorted(r) == sorted(p)
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


@functools.lru_cache(maxsize=None)
def reference_params(arch, seed=0):
    """The reference's smoke-config f32 params of ``arch`` as NumPy."""
    cfg = configs.get_smoke(arch)
    p = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def max_diff(port_tree, ref_tree) -> float:
    """Largest |port - reference| over the leaves of a port tree."""
    out = 0.0
    for path, t in tree.leaves_with_path(port_tree):
        r = tree.get_path(ref_tree, path)
        out = max(out, float(np.abs(t.detach().numpy() - np.asarray(r)).max()))
    return out


def port_params(tree_np):
    return convert.params_from_numpy(tree_np, device="cpu")


def jax_params(tree_np):
    return jax.tree.map(jnp.asarray, tree_np)


def token_batch(arch, b, s, step=0):
    """A (b, s) batch of the smoke config's vocabulary, seed 1."""
    cfg = tconfigs.get_smoke(arch)
    return synthetic.token_batch(cfg.vocab_padded, b, s, seed=1, step=step)


def seeded_tokens(cfg, shape, seed):
    """int32 tokens of ``cfg``'s vocabulary from a NumPy seed."""
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


@functools.lru_cache(maxsize=None)
def calibrated_model(arch):
    """(cfg, reference plan, exported encoded tree, the reference's f32
    activation scales from ``CAL_SHAPE`` tokens of seed 3)."""
    cfg, plan, _, enc = _reference_model(arch)
    toks = jnp.asarray(seeded_tokens(cfg, CAL_SHAPE, 3))
    scales = jprot.calibrate_act_scales(cfg, enc, toks, plan=plan,
                                        backend="xla", dtype=jnp.float32,
                                        chunk=16)
    return cfg, plan, export(enc), scales


def port_plan(arch):
    """The port's default plan of ``arch``'s smoke config."""
    cfg = tconfigs.get_smoke(arch)
    return TProtectionPolicy().plan(tlm.param_shapes(cfg))


def guarded(plan, scales, mode):
    """(plan, act_quant) of one guarded serving mode, on either package."""
    if mode == "static-clamp-abft":
        return plan.with_act_quant("static", scales,
                                   clamp=True).with_abft(True), "plan"
    if mode == "static":
        return plan.with_act_quant("static", scales), "static"
    if mode == "dynamic-abft":
        return plan.with_abft(True), "dynamic"
    if mode == "float-abft-clamp":
        return plan.with_abft(True, clamps={
            p: s * 127 for p, s in scales.items()}), None
    return plan, None


def assert_flag_dict_equal(ref, got):
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)

"""The port's fused page attention against the reference.

On the CPU the wrapper runs its plain PyTorch version, held against
``kvcache._reference_paged_attention`` and the fp64
``paged_attention.oracle_page_attention`` of the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.kernels import paged_attention as jpa
from repro.serving import kvcache as jkv
from repro_torch.kernels import paged_attention
from repro_torch.serving import kvcache


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _kv_strips(rng, b, s, kv, hd, rate=0.0):
    """Float K/V encoded through BOTH packages' ``_encode_kv`` (asserted
    byte-equal), then optionally faulted with one shared mask."""
    jpol = jkv.get_kv_policy("in-place")
    tpol = kvcache.get_kv_policy("in-place")
    out = []
    for i in range(2):
        f = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
        je, _, jsc = jkv._encode_kv(jnp.asarray(f), jpol)
        te, _, tsc = kvcache._encode_kv(_t(f), tpol)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        enc = np.asarray(je)
        if rate:
            enc = jfaults.inject(enc.reshape(-1), rate, 100 + i).reshape(
                enc.shape)
        out += [enc, np.asarray(jsc)]
    return out


@pytest.mark.parametrize("b,h,kv,s,dtype", [
    (2, 4, 4, 32, "float32"), (3, 4, 2, 16, "float32"),
    (2, 4, 2, 32, "bfloat16")])
def test_fused_page_attention_plain_matches_reference(b, h, kv, s, dtype):
    """Plain version against ``_reference_paged_attention`` (flags exact,
    output to f32 rounding; bf16 to one bf16 ulp of the probabilities) and
    against the fp64 oracle."""
    hd = 16
    rng = np.random.default_rng(b * 100 + s)
    ke, ksc, ve, vsc = _kv_strips(rng, b, s, kv, hd, rate=4e-3)
    q = rng.standard_normal((b, h, 1, hd)).astype(np.float32)
    pos = np.array([s - 1, 5, 0][:b], np.int32)
    jdt = getattr(jnp, dtype)
    jq = jnp.asarray(q).astype(jdt)
    jo, jc, jd = jkv._reference_paged_attention(
        jq, jnp.asarray(ke), None, jnp.asarray(ksc), jnp.asarray(ve), None,
        jnp.asarray(vsc), jnp.asarray(pos), jkv.get_kv_policy("in-place"))
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(getattr(torch, dtype))
    o, flags = paged_attention.fused_page_attention(
        tq, _t(ke), None, _t(ksc), _t(ve), None, _t(vsc), _t(pos))
    assert flags.tolist() == [int(jc), int(jd)]
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    oracle = jpa.oracle_page_attention(
        jq, jnp.asarray(ke), None, jnp.asarray(ksc), jnp.asarray(ve), None,
        jnp.asarray(vsc), jnp.asarray(pos))
    otol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(o.float().numpy(), oracle, rtol=otol, atol=otol)
    # the port's own reference path agrees with its kernel module
    ro, rc, rd = kvcache._reference_paged_attention(
        tq, _t(ke), None, _t(ksc), _t(ve), None, _t(vsc), _t(pos),
        kvcache.get_kv_policy("in-place"))
    assert [int(rc), int(rd)] == flags.tolist()
    torch.testing.assert_close(ro, o, rtol=1e-6, atol=1e-6)


def test_paged_attention_faulty_scheme_and_budget():
    rng = np.random.default_rng(2)
    b, h, kv, s, hd = 2, 2, 2, 16, 8
    raw = rng.integers(-127, 128, size=(b, s, kv, hd), dtype=np.int8)
    sc = np.full((b, s), 0.01, np.float32)
    q = torch.randn(b, h, 1, hd)
    pos = torch.tensor([3, 15])
    o, flags = paged_attention.fused_page_attention(
        q, _t(raw.view(np.uint8)), None, _t(sc), _t(raw.view(np.uint8)), None,
        _t(sc), pos, scheme="faulty")
    assert flags.tolist() == [0, 0] and o.shape == (b, h, 1, hd)
    with pytest.raises(ValueError, match="KV scheme"):
        paged_attention.fused_page_attention(
            q, None, None, None, None, None, None, pos, scheme="secded72")
    with pytest.raises(ValueError, match="check strips"):
        paged_attention.fused_page_attention(
            q, _t(raw.view(np.uint8)), None, _t(sc), _t(raw.view(np.uint8)),
            None, _t(sc), pos, scheme="parity-zero")
    assert paged_attention.smem_bytes(64, 128, 1, torch.bfloat16) == \
        2 * 64 * 128 * 2 + 64 * 4


@pytest.mark.parametrize("name", sorted(kvcache.KV_POLICY_PRESETS))
def test_kv_presets_equal_the_reference(name):
    """Same scheme, attention path, chunking and page size as the reference
    preset, and the counterpart of its codec route."""
    mine, ref = kvcache.get_kv_policy(name), jkv.get_kv_policy(name)
    assert (mine.scheme, mine.fused, mine.page_size, mine.attention_impl,
            mine.chunk_pages) == (ref.scheme, ref.fused, ref.page_size,
                                  ref.attention_impl, ref.chunk_pages)
    assert mine.backend == {"xla": "torch", "pallas": "cuda"}[ref.backend]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_serve_step_sets_the_kv_codec_route(backend, monkeypatch):
    """The serve step's backend, not the preset, routes the KV encode."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.protection.policy import ProtectionPolicy
    from repro_torch.serving import protected

    seen = set()
    encode_kv = kvcache._encode_kv

    def spy(kf, policy):
        seen.add(policy.backend)
        return encode_kv(kf, policy)
    monkeypatch.setattr(kvcache, "_encode_kv", spy)
    cfg = configs.get_smoke("minitron-4b")
    plan = ProtectionPolicy(backend=backend).plan(lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device="cpu", leaf_fn=plan.encode_leaf)
    step = protected.make_serve_step(cfg, plan=plan, backend=backend,
                                     kv_policy="in-place-fused")
    cache = kvcache.init_cache(cfg, 2, 16, kv_policy="in-place-fused",
                               device="cpu")
    step(enc, cache, torch.zeros((2, 1), dtype=torch.long),
         torch.zeros((2,), dtype=torch.int32))
    assert seen == {backend}

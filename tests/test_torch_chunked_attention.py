"""The port's page-chunked attention against the reference.

The reference's Pallas chunked kernel cannot run here (its TPU compiler
parameters do not build on this JAX), so the port's plain version — what
the wrapper runs for CPU tensors — is held to the reference's fp64
``oracle_page_attention`` within ``ORACLE_RTOL`` of ``max|oracle|`` (the
reference's own gate for its chunked kernel), and its flags to the
reference's XLA decode-then-attend path exactly. K/V are encoded through
both packages' ``_encode_kv`` (byte-equal) and faulted with one shared
NumPy mask.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.kernels import paged_attention as jpa
from repro.serving import kvcache as jkv
from repro_torch.kernels import build, paged_attention
from repro_torch.serving import kvcache

ORACLE_RTOL = 0.02
F32_TOL = 1e-5      # the port's own fp64 oracle vs the reference's
STRIP_F32_TOL = 1e-5   # chunked vs strip in f32: summation order only
STRIP_BF16_TOL = 3e-2  # the strip kernel rounds scores and p to bf16


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _strips(rng, b, s, kv, hd, scheme, rate):
    """Encoded K/V through both packages (asserted byte-equal), faulted."""
    jpol = jkv.KVProtectionPolicy(scheme=scheme)
    tpol = kvcache.KVProtectionPolicy(scheme=scheme)
    out = []
    for i in range(2):
        f = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
        je, _, jsc = jkv._encode_kv(jnp.asarray(f), jpol)
        te, _, tsc = kvcache._encode_kv(_t(f), tpol)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        enc = np.asarray(je)
        if rate:
            enc = jfaults.inject(enc.reshape(-1), rate, 70 + i).reshape(
                enc.shape)
        out += [enc, np.asarray(jsc)]
    return out


def _reference_flags(q, ke, ksc, ve, vsc, pos, scheme):
    _, c, d = jkv._reference_paged_attention(
        jnp.asarray(q), jnp.asarray(ke), None, jnp.asarray(ksc),
        jnp.asarray(ve), None, jnp.asarray(vsc), jnp.asarray(pos),
        jkv.KVProtectionPolicy(scheme=scheme))
    return [int(c), int(d)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk,pos", [
    (96, 64, (95, 31)), (256, 64, (200, 0)), (50, 16, (49, 33)),
    (40, 256, (39, 7))],
    ids=["pad-tail", "skipped-chunks", "ragged", "chunk-clamped"])
@pytest.mark.parametrize("scheme", ["faulty", "in-place"])
def test_chunked_plain_matches_the_fp64_oracle(scheme, s, chunk, pos, dtype):
    """Ragged positions, GQA rep 2, S not always a multiple of the chunk,
    shared injected flips; flags exactly the reference's."""
    rng = np.random.default_rng(s + chunk)
    b, kv, hd, rep = 2, 2, 16, 2
    ke, ksc, ve, vsc = _strips(rng, b, s, kv, hd, scheme, rate=3e-3)
    q = rng.standard_normal((b, kv * rep, 1, hd)).astype(np.float32)
    jq = jnp.asarray(q).astype(getattr(jnp, dtype))
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(getattr(torch, dtype))
    pos = np.asarray(pos, np.int32)
    args = (_t(ke), None, _t(ksc), _t(ve), None, _t(vsc), _t(pos))
    o, flags = paged_attention.chunked_page_attention(
        tq, *args, scheme=scheme, chunk_tokens=chunk)
    assert o.dtype == tq.dtype and o.shape == (b, kv * rep, 1, hd)
    oracle = jpa.oracle_page_attention(
        jq, jnp.asarray(ke), None, jnp.asarray(ksc), jnp.asarray(ve), None,
        jnp.asarray(vsc), jnp.asarray(pos), scheme=scheme)
    err = np.abs(o.double().numpy() - oracle).max()
    assert err <= ORACLE_RTOL * np.abs(oracle).max(), err
    mine = paged_attention.oracle_page_attention(tq, *args, scheme=scheme)
    np.testing.assert_allclose(mine, oracle, rtol=F32_TOL, atol=F32_TOL)
    assert flags.tolist() == _reference_flags(jq, ke, ksc, ve, vsc, pos,
                                              scheme)
    if scheme == "in-place":
        assert flags.tolist()[0] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_tracks_the_strip_kernel_at_short_length(dtype):
    rng = np.random.default_rng(9)
    b, s, kv, hd, rep = 3, 48, 2, 16, 2
    ke, ksc, ve, vsc = _strips(rng, b, s, kv, hd, "in-place", rate=4e-3)
    q = torch.from_numpy(
        rng.standard_normal((b, kv * rep, 1, hd)).astype(np.float32)).to(
            getattr(torch, dtype))
    args = (q, _t(ke), None, _t(ksc), _t(ve), None, _t(vsc),
            torch.tensor([47, 16, 0]))
    oc, fc = paged_attention.chunked_page_attention(*args, chunk_tokens=16)
    of, ff = paged_attention.fused_page_attention(*args)
    assert fc.tolist() == ff.tolist()
    tol = STRIP_F32_TOL if dtype == "float32" else STRIP_BF16_TOL
    torch.testing.assert_close(oc.float(), of.float(), rtol=tol, atol=tol)


def test_chunked_plain_skips_chunks_past_every_pos():
    """A chunk wholly past ``pos`` is never read: garbage there (even
    double flips) changes neither the output nor the flags."""
    rng = np.random.default_rng(4)
    b, s, kv, hd = 1, 64, 1, 8
    ke, ksc, ve, vsc = _strips(rng, b, s, kv, hd, "in-place", rate=0)
    q = torch.randn(b, 2, 1, hd)
    pos = torch.tensor([20])
    a = paged_attention.chunked_page_attention(
        q, _t(ke), None, _t(ksc), _t(ve), None, _t(vsc), pos, chunk_tokens=32)
    ke2, ve2 = ke.copy(), ve.copy()
    ke2[:, 32:] ^= 3
    ve2[:, 32:] = 255
    b_ = paged_attention.chunked_page_attention(
        q, _t(ke2), None, _t(ksc), _t(ve2), None, _t(vsc), pos,
        chunk_tokens=32)
    assert torch.equal(a[0], b_[0]) and a[1].tolist() == b_[1].tolist() == \
        [0, 0]


def test_shared_memory_accounting():
    """The strip kernel's context wall at deepseek-7b widths (hd 128, rep 1):
    268 B per token (int8 K and V, two scales, a score) and 4,672 B fixed
    (q, eight warp partials, maxima and sums), crossover 850 tokens, 848
    page-aligned;
    the chunked kernel's need is independent of the context."""
    per_token = paged_attention.smem_bytes(17, 128, 1) - \
        paged_attention.smem_bytes(13, 128, 1)
    assert per_token == 4 * 268
    assert paged_attention.smem_bytes(0, 128, 1) == 4672
    xo = paged_attention.strip_smem_crossover(128, 1)
    assert xo == 850
    wall = (xo - 1) // 16 * 16
    assert wall == 848
    lim = paged_attention.SMEM_LIMIT_BYTES
    assert paged_attention.smem_bytes(wall, 128, 1) <= lim
    assert paged_attention.smem_bytes(wall + 16, 128, 1) > lim
    # four warps x four stages of (8-token K and V rows, 16 scales), q,
    # the warps' accumulators and (m, l), the page-table slice
    c = paged_attention.chunked_smem_bytes(128, 1, table_entries=27)
    assert c == 4 * 4 * (2 * 1024 + 64) + 128 * 4 + 4 * 128 * 4 + 8 * 4 + \
        27 * 4
    assert c <= lim
    cp = paged_attention.chunked_smem_bytes(128, 1, checks=True,
                                            table_entries=27)
    assert cp - c == 4 * 4 * 2 * 128


def test_chunked_wrapper_validation():
    q = torch.randn(1, 2, 1, 8)
    ke = torch.zeros((1, 16, 1, 8), dtype=torch.uint8)
    sc = torch.ones(1, 16)
    pos = torch.tensor([3])
    with pytest.raises(ValueError, match="chunk_tokens"):
        paged_attention.chunked_page_attention(q, ke, None, sc, ke, None, sc,
                                               pos, chunk_tokens=0)
    with pytest.raises(ValueError, match="KV scheme"):
        paged_attention.chunked_page_attention(q, ke, None, sc, ke, None, sc,
                                               pos, scheme="secded72")
    with pytest.raises(ValueError, match="check strips"):
        paged_attention.chunked_page_attention(q, ke, None, sc, ke, None, sc,
                                               pos, scheme="parity-zero")
    before = build.COUNTS["chunked_page_attention"]
    paged_attention.chunked_page_attention(q, ke, None, sc, ke, None, sc, pos)
    assert build.COUNTS["chunked_page_attention"] == before


@pytest.mark.parametrize("name", ["unprotected-fused", "unprotected-chunked",
                                  "in-place-chunked"])
def test_new_presets_equal_the_reference(name):
    mine, ref = kvcache.get_kv_policy(name), jkv.get_kv_policy(name)
    for field in ("scheme", "fused", "page_size", "attention_impl",
                  "chunk_pages"):
        assert getattr(mine, field) == getattr(ref, field), field


@pytest.mark.parametrize("name", [
    "in-place", "inplace", "inplace-fused", "inplace-chunked", "none",
    "none-fused", "faulty-chunked", "unprotected", "unprotected-chunked"])
def test_get_kv_policy_resolves_like_the_reference(name):
    mine, ref = kvcache.get_kv_policy(name), jkv.get_kv_policy(name)
    for field in ("scheme", "fused", "attention_impl", "chunk_pages"):
        assert getattr(mine, field) == getattr(ref, field), field


def test_policy_validation_and_unknown_names():
    for name in ("flash", "in-place-flash", "secded72-chunked"):
        with pytest.raises(ValueError):
            kvcache.get_kv_policy(name)
    kvp = kvcache.get_kv_policy("in-place")
    with pytest.raises(ValueError, match="attention_impl"):
        dataclasses.replace(kvp, attention_impl="flash")
    with pytest.raises(ValueError, match="chunk_pages"):
        dataclasses.replace(kvp, chunk_pages=0)
    assert kvcache.pages_needed(33, 16) == 3 and kvcache.pages_needed(32, 16) \
        == 2
    from repro_torch import configs
    assert kvcache.supports_paged(configs.get("deepseek-7b"))

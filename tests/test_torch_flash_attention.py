"""The port's causal flash attention and chunked causal attention against
the reference.

``flash_attention``'s plain version — what the wrapper runs for CPU
tensors — is held to the reference's Pallas ``flash_attention`` run in
interpret mode, in f32 (``F32_TOL``: the same op order, summed in another
order) and in bf16 (``BF16_TOL``: one bf16 ulp of an O(1) output, where a
probability rounded to bf16 on one side lands on the other side of a
rounding boundary). For a ragged S, which the reference kernel refuses,
it is held to an fp64 causal attention. The plain route's
``chunked_causal_attention`` is held to the reference's in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.models import layers as jlayers
from repro_torch.kernels import build, flash_attention
from repro_torch.models import layers

F32_TOL = 1e-5
BF16_TOL = 1e-2
F64_TOL = 1e-5


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _causal_f64(q, k, v):
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = q.shape[2]
    sc = q @ k.swapaxes(-1, -2) / np.sqrt(q.shape[-1])
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


@pytest.mark.parametrize("shape,bq,bk", [
    ((2, 3, 128, 16), 64, 64), ((1, 2, 256, 32), 64, 64),
    ((1, 2, 256, 16), 128, 64), ((2, 1, 64, 8), 64, 64)])
def test_flash_plain_matches_the_reference_kernel_f32(shape, bq, bk):
    q, k, v = _qkv(sum(shape), shape)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), bq=bq, bk=bk,
                                         interpret=True))
    out = flash_attention.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bq=bq,
        bk=bk)
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", [(2, 2, 128, 16), (1, 2, 192, 32)])
def test_flash_plain_matches_the_reference_kernel_bf16(shape):
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in _qkv(7 + shape[2], shape))
    ref = np.asarray(jfa.flash_attention(q, k, v, bq=64, bk=64,
                                         interpret=True).astype(jnp.float32))
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
         for x in (q, k, v)]
    out = flash_attention.flash_attention(*t)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=BF16_TOL)


@pytest.mark.parametrize("s", [1, 37, 100, 130])
def test_flash_plain_masks_a_ragged_length(s):
    q, k, v = _qkv(s, (2, 2, s, 16))
    out = flash_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), _causal_f64(q, k, v),
                               rtol=F64_TOL, atol=F64_TOL)
    cca = layers.chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        chunk=32)
    np.testing.assert_allclose(out.numpy(), cca.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_matches_the_reference_kernel_head_dim_256(dtype):
    """Head dim 256 (paligemma-3b, recurrentgemma-2b), which the kernel
    now takes: the plain version against the reference kernel in
    interpret mode, at the kernel's tiles."""
    shape = (1, 2, 128, 256)
    q, k, v = _qkv(256, shape)
    if dtype == "f32":
        ref = np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=64, bk=64,
            interpret=True))
        out = flash_attention.flash_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
        np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL,
                                   atol=F32_TOL)
        return
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jfa.flash_attention(jq, jk, jv, bq=64, bk=64,
                                         interpret=True).astype(jnp.float32))
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
         for x in (jq, jk, jv)]
    out = flash_attention.flash_attention(*t)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=BF16_TOL)


@pytest.mark.parametrize("s", [37, 130])
def test_flash_plain_masks_a_ragged_length_head_dim_256(s):
    q, k, v = _qkv(s + 256, (1, 2, s, 256))
    out = flash_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), _causal_f64(q, k, v),
                               rtol=F64_TOL, atol=F64_TOL)


def test_flash_kernel_head_dims_cover_256():
    """Every head dim the kernel takes is one the plain version serves,
    256 included (the prefill of the head-dim-256 families)."""
    assert flash_attention.KERNEL_HEAD_DIMS == (16, 32, 64, 128, 256)


def test_flash_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, (1, 2, 70, 16)))
    before = build.COUNTS["flash_attention"]
    assert torch.equal(flash_attention.flash_attention(q, k, v),
                       flash_attention.flash_attention_plain(q, k, v))
    assert build.COUNTS["flash_attention"] == before
    with pytest.raises(ValueError, match="positive"):
        flash_attention.flash_attention_plain(q, k, v, bk=0)
    with pytest.raises(ValueError, match="must match"):
        flash_attention.flash_attention_plain(q, k[:, :1], v)


@pytest.mark.parametrize("s,chunk,window", [
    (40, 16, 0), (37, 2048, 0), (48, 16, 16), (50, 8, 8), (96, 8, 0),
    (64, 16, 100)],
    ids=["chunks", "one-chunk-ragged", "window", "window-ragged",
         "many-chunks", "window-covers-all"])
def test_chunked_causal_attention_matches_the_reference_f32(s, chunk,
                                                            window):
    q, k, v = _qkv(s + chunk, (2, 3, s, 16))
    ref = np.asarray(jlayers.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk,
        window=window))
    out = layers.chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        chunk=chunk, window=window)
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


# MLA's head split: the smoke configs' (16 + 8, 16) and the full configs'
# (128 + 64, 128); ragged S included
@pytest.mark.parametrize("d,dv,s", [(24, 16, 40), (24, 16, 37),
                                    (192, 128, 128), (192, 128, 70)])
def test_flash_plain_takes_its_own_v_head_dim(d, dv, s):
    """The plain version with v's own head dim against the reference's
    ``chunked_causal_attention`` (the MLA forward's attention, scale
    1/sqrt(d)) in f32, and against an fp64 causal attention."""
    rng = np.random.default_rng(d + dv + s)
    q, k = (rng.standard_normal((2, 3, s, d)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 3, s, dv)).astype(np.float32)
    ref = np.asarray(jlayers.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16))
    out = flash_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert tuple(out.shape) == (2, 3, s, dv)
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(out.numpy(), _causal_f64(q, k, v),
                               rtol=F64_TOL, atol=F64_TOL)


def test_flash_kernel_raises_on_every_head_pair_it_was_not_built_for():
    """The kernel route takes exactly the pairs it was built for: (d, d)
    for d in KERNEL_HEAD_DIMS and the splits of KERNEL_HEAD_SPLITS, which
    are (192, 128) alone; every other (DQK, DV) raises before a launch."""
    assert flash_attention.KERNEL_HEAD_SPLITS == ((192, 128),)
    dims = sorted({8 * i for i in range(1, 33)} | {24, 192})
    built = {(d, d) for d in flash_attention.KERNEL_HEAD_DIMS} | \
        set(flash_attention.KERNEL_HEAD_SPLITS)
    for d in dims:
        for dv in dims:
            if (d, dv) in built:
                flash_attention.check_kernel_head_dims(d, dv)
                continue
            with pytest.raises(ValueError, match="head dims"):
                flash_attention.check_kernel_head_dims(d, dv)

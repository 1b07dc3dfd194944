"""The port's fused-matmul kernel module against the reference.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the reference's XLA route (the decode-then-matmul float path).
``test_torch_gpu.py`` holds each CUDA kernel against its plain version on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.protection import policy as jpolicy
from repro_torch.kernels import ecc_qmatmul


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _encoded_weight(rng, k, n, rate=0.0, seed=0):
    """A reference-encoded (k, n) in-place image, optionally faulted."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    pt = jpolicy.ProtectionPolicy().encode_leaf(jnp.asarray(w), "in-place")
    enc = np.asarray(pt.enc)
    if rate:
        enc = jfaults.inject(enc.reshape(-1), rate, seed).reshape(enc.shape)
    return enc, float(pt.scale)


@pytest.mark.parametrize("m,k,n", [(4, 64, 128), (3, 40, 24), (1, 128, 8)])
def test_ecc_qmatmul_plain_matches_reference_f32(m, k, n):
    """Float path, f32: decode + dequantize + f32 matmul equals the
    reference's decode-then-matmul (``decode_leaf_with_flags`` then ``@``)
    to f32 summation-order rounding; flags exactly."""
    rng = np.random.default_rng(m * k + n)
    enc, scale = _encoded_weight(rng, k, n, rate=5e-3, seed=k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    jpt = jpolicy.ProtectedTensor(enc=jnp.asarray(enc), checks=None,
                                  scale=jnp.float32(scale),
                                  scheme_id="in-place", orig_shape=(k, n))
    jw, jc, jd = jpolicy.decode_leaf_with_flags(jpt, jnp.float32)
    ref = np.asarray(jnp.asarray(a) @ jw)
    out, flags = ecc_qmatmul.ecc_qmatmul(_t(a), _t(enc),
                                         torch.tensor(scale), with_flags=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert flags.tolist() == [int(jc), int(jd)]
    assert flags.tolist() != [0, 0]


def test_ecc_qmatmul_bf16_activations_round_weights_like_reference():
    """bf16 ``a``: the decoded tile is rounded to bf16 before an f32
    accumulation, as in the reference kernel's float path."""
    rng = np.random.default_rng(9)
    enc, scale = _encoded_weight(rng, 64, 32)
    a = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    jpt = jpolicy.ProtectedTensor(enc=jnp.asarray(enc), checks=None,
                                  scale=jnp.float32(scale),
                                  scheme_id="in-place", orig_shape=(64, 32))
    jw = jpolicy.decode_leaf(jpt, jnp.bfloat16)
    ref = np.asarray(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                     .astype(jnp.float32) @ jw.astype(jnp.float32))
    out = ecc_qmatmul.ecc_qmatmul(a, _t(enc), torch.tensor(scale))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_ecc_qmatmul_unported_paths_raise():
    """Every path of the reference is ported; what still raises are the
    reference's own argument guards (ecc_qmatmul.py:312-332)."""
    enc = torch.zeros((8, 8), dtype=torch.uint8)
    q = torch.zeros((2, 8), dtype=torch.int8)
    assert ecc_qmatmul.ecc_qmatmul(q, enc).dtype == torch.int32
    with pytest.raises(ValueError, match="clamp"):
        ecc_qmatmul.ecc_qmatmul(q, enc, clamp=1.0)
    with pytest.raises(ValueError, match="w_scale"):
        ecc_qmatmul.ecc_qmatmul(torch.zeros((2, 8)), enc, with_abft=True)

"""The port's quantize-throttle and throttle kernels (their plain versions
and the CPU route of their wrappers) against the reference's Pallas
kernels in interpret mode and against ``quant.quantize`` +
``wot.throttle_q``; the deploy encode on both routes against the
reference's. Every check is exact: byte-equal q and bit-equal scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import wot as jwot
from repro.kernels import quant_throttle as jqt
from repro.kernels import throttle as jthr
from repro.protection import policy as jpolicy
from repro_torch.core import wot
from repro_torch.kernels import quant_throttle, throttle
from repro_torch.protection import backends
from repro_torch.protection.policy import ProtectionPolicy


def _ties(nblk, rng):
    """Blocks whose quantization lands on exact rounding ties: absmax is
    127 * 2^-7, so the scale is 2^-7 and w / scale = k + 0.5 exactly; also
    +-63.5, -64.5 (around the WOT bounds) and -0.0."""
    k = rng.integers(-127, 127, size=(nblk, 8)).astype(np.float32) + 0.5
    k[:, 0] = 63.5
    k[:, 1] = -64.5
    k[:, 2] = -63.5
    k[:, 3] = -0.0
    k[0, 4] = 127.0
    return (k * np.float32(2.0 ** -7)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(3)
    return {
        "normal-ragged": rng.standard_normal((1037, 8)).astype(np.float32),
        "normal-4096": (3 * rng.standard_normal((4096, 8))).astype(np.float32),
        "ties": _ties(513, rng),
        "zeros": np.zeros((5, 8), np.float32),
        "one-block": rng.standard_normal((1, 8)).astype(np.float32),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_quantize_throttle_matches_reference(name):
    w = INPUTS[name]
    jq, jscale = jqt.quantize_throttle(jnp.asarray(w), interpret=True)
    # the reference's own definition: quantize, then throttle_q
    rq, rscale = jquant.quantize(jnp.asarray(w))
    rq = jwot.throttle_q(rq.reshape(-1)).reshape(w.shape)
    np.testing.assert_array_equal(np.asarray(jq), np.asarray(rq))
    assert np.float32(rscale) == np.float32(jscale)
    t = torch.from_numpy(w)
    for fn in (quant_throttle.quantize_throttle_plain,
               quant_throttle.quantize_throttle,
               backends.get_backend("cuda").quantize_throttle):
        q, scale = fn(t)
        assert q.dtype == torch.int8 and q.shape == t.shape
        assert scale.dtype == torch.float32 and scale.shape == ()
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert scale.numpy().tobytes() == np.float32(jscale).tobytes()
        assert int(wot.count_large_in_protected(q.reshape(-1))) == 0
    if name == "zeros":   # the eps clamp: scale 1e-12 / 127, q all zero
        assert float(scale) == np.float32(np.float32(1e-12) / 127)
        assert not q.any()


@pytest.mark.parametrize("nblk", [1, 7, 1000, 4096])
def test_throttle_matches_reference(nblk):
    rng = np.random.default_rng(nblk)
    q = rng.integers(-128, 128, size=(nblk, 8)).astype(np.int8)
    q[0, :] = [-128, 127, -65, 64, -64, 63, 0, -128]
    want = np.asarray(jthr.throttle(jnp.asarray(q), interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jwot.throttle_q(jnp.asarray(q.reshape(-1))))
        .reshape(q.shape))
    t = torch.from_numpy(q)
    for fn in (throttle.throttle_plain, throttle.throttle,
               backends.get_backend("cuda").throttle):
        got = fn(t)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(t, torch.from_numpy(q))   # input untouched


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        quant_throttle.quantize_throttle(
            torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        quant_throttle.quantize_throttle(torch.zeros(0, 8))
    with pytest.raises(ValueError):
        throttle.throttle(torch.zeros(4, 4, dtype=torch.int8))


# (5, 7) and (3, 13) are not block multiples: the flat-padded layout
@pytest.mark.parametrize("shape", [(5, 7), (3, 13), (4, 16, 24)])
@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_encode_leaf_both_routes_match_reference(shape, route):
    w = np.random.default_rng(len(shape)).standard_normal(shape)
    w = (w * 3).astype(np.float32)
    jpt = jpolicy.ProtectionPolicy().encode_leaf(jnp.asarray(w), "in-place")
    pt = ProtectionPolicy(backend=route).encode_leaf(torch.from_numpy(w),
                                                     "in-place")
    np.testing.assert_array_equal(pt.enc.numpy(), np.asarray(jpt.enc))
    assert pt.scale.numpy().tobytes() == np.asarray(
        jpt.scale, np.float32).tobytes()
    assert pt.is_flat == jpt.is_flat and pt.orig_shape == jpt.orig_shape


# the write-back leaves: ragged (value counts not a multiple of 8), ties,
# an all-zero leaf and a one-block leaf, as 2-D masters
WRITE_BACK = {
    "normal-ragged": INPUTS["normal-ragged"].reshape(-1)[:1037 * 7].reshape(
        1037, 7),
    "ragged-tail": INPUTS["normal-4096"].reshape(-1)[:4093 * 7].reshape(
        4093, 7),
    "ties": INPUTS["ties"].reshape(57, 72),
    "zeros-ragged": np.zeros((5, 7), np.float32),
    "one-block": INPUTS["one-block"].reshape(2, 4),
}


@pytest.mark.parametrize("name", sorted(WRITE_BACK))
@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_throttle_tensor_in_place_matches_reference(name, route):
    """``wot.throttle_tensor_`` (the kernel's write-back on the "cuda"
    route, its plain version for CPU tensors) writes the reference's
    ``wot.throttle_tensor`` into the masters bit for bit; q and scale are
    the reference's quantize-throttle of the zero-padded blocks."""
    w = WRITE_BACK[name]
    want = np.asarray(jwot.throttle_tensor(jnp.asarray(w)))
    t = torch.from_numpy(w.copy())
    out, q, scale = wot.throttle_tensor_(t, backend=route, with_q=True)
    assert out is t
    assert t.numpy().tobytes() == want.tobytes()
    jq, jscale = jqt.quantize_throttle(jnp.asarray(
        np.pad(w.reshape(-1), (0, (-w.size) % 8)).reshape(-1, 8)),
        interpret=True)
    np.testing.assert_array_equal(q.numpy().reshape(-1),
                                  np.asarray(jq).reshape(-1)[: w.size])
    assert scale.numpy().tobytes() == np.float32(jscale).tobytes()
    # the out-of-place form leaves its input alone and agrees
    src = torch.from_numpy(w.copy())
    assert wot.throttle_tensor(src, backend=route).numpy().tobytes() == \
        want.tobytes()
    assert src.numpy().tobytes() == w.tobytes()
    if name in ("ties", "ragged-tail"):   # the clamp did move masters
        assert (want != w).any()


def test_write_back_without_q():
    w = WRITE_BACK["ties"]
    t = torch.from_numpy(w.copy())
    q, scale = quant_throttle.quantize_throttle(t, write_back=True,
                                                with_q=False)
    assert q is None and scale.shape == ()
    assert t.numpy().tobytes() == np.asarray(
        jwot.throttle_tensor(jnp.asarray(w))).tobytes()
    with pytest.raises(ValueError):
        quant_throttle.quantize_throttle(torch.zeros(0), write_back=True)
    with pytest.raises(ValueError):
        quant_throttle.quantize_throttle(torch.zeros(3, dtype=torch.float64),
                                         write_back=True)

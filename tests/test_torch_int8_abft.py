"""The fused matmul's int8, requantize, ABFT, clamp and ``fault_bits`` paths
in the port against the reference's XLA route, on the same int8 inputs.

On the CPU the wrapper runs its plain version; both are held here to
``ref.ecc_qmatmul_ref``, ``quant.int8_matmul`` / ``int8_acc`` and
``ref.abft_counts`` / ``ref.clamp_counts`` of the reference (its Pallas
kernel does not run on this JAX). Integer results and requantized outputs
are compared bit for bit, counts exactly. ``test_torch_gpu.py`` holds the
CUDA kernel to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ecc as jecc
from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro_torch.core import quant
from repro_torch.kernels import ecc_qmatmul, ops, ref

QMM = ecc_qmatmul.ecc_qmatmul
PLAIN = ecc_qmatmul.ecc_qmatmul_plain


def _wot_weights(rng, shape):
    w = rng.integers(-64, 64, size=shape).astype(np.int8)
    flat = w.reshape(-1)
    flat[7::8] = rng.integers(-128, 128, size=flat[7::8].size)
    return flat.reshape(shape)


def _enc(wq):
    k, n = wq.shape
    return np.asarray(jecc.encode64(jnp.asarray(
        wq.view(np.uint8).reshape(k, n // 8, 8)))).reshape(k, n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    wq = _wot_weights(rng, (k, n))
    enc = _enc(wq)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    return rng, wq, enc, a


def _f32(x):
    return np.asarray(x, np.float32)


SHAPES = [(32, 64, 128), (45, 100, 72), (1, 8, 8), (37, 200, 136)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_accumulator_byte_exact(m, k, n):
    _, wq, enc, a = _case(m + n, m, k, n)
    want = np.asarray(jref.ecc_qmatmul_ref(jnp.asarray(a), jnp.asarray(enc)))
    for fn in (QMM, PLAIN):
        got = fn(_t(a), _t(enc))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.ecc_qmatmul_ref(_t(a), _t(enc)).numpy(), want)
    np.testing.assert_array_equal(
        quant.int8_acc(_t(a), _t(wq)).numpy(),
        np.asarray(jquant.int8_acc(jnp.asarray(a), jnp.asarray(wq))))


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.float16])
@pytest.mark.parametrize("form", ["scalar", "rows", "rows1"])
@pytest.mark.parametrize("m,k,n", SHAPES[:2])
def test_requantize_bit_exact(m, k, n, form, out_dtype):
    """``(acc * (a_scale * w_scale))`` cast to bf16 (default), f32 or f16,
    bit for bit against the reference's XLA rescale of its accumulator."""
    rng, _, enc, a = _case(m * n, m, k, n)
    rows = rng.uniform(0.005, 0.05, size=(m,)).astype(np.float32)
    a_scale = {"scalar": np.float32(0.02), "rows": rows,
               "rows1": rows[:, None]}[form]
    w_scale = np.float32(0.013)
    out = QMM(_t(a), _t(enc), torch.tensor(w_scale),
              a_scale=torch.tensor(a_scale), out_dtype=out_dtype)
    acc = jref.ecc_qmatmul_ref(jnp.asarray(a), jnp.asarray(enc))
    jdt = {None: jnp.bfloat16, torch.float32: jnp.float32,
           torch.float16: jnp.float16}[out_dtype]
    want = (acc.astype(jnp.float32) * (
        jnp.asarray(a_scale).reshape(-1, 1) * jnp.float32(w_scale))
            ).astype(jdt)
    assert out.dtype == (out_dtype or torch.bfloat16)
    np.testing.assert_array_equal(_f32(out.float().numpy()), _f32(want))
    # the same value path as quant.int8_matmul, the serve path's inline route
    want2 = jquant.int8_matmul(jnp.asarray(a), _dec(enc),
                               jnp.asarray(a_scale).reshape(-1, 1),
                               jnp.float32(w_scale)).astype(jdt)
    np.testing.assert_array_equal(_f32(out.float().numpy()), _f32(want2))


def _dec(enc):
    k, n = enc.shape
    dec, _, _ = jecc.decode64(jnp.asarray(enc).reshape(k, n // 8, 8))
    return jnp.asarray(np.asarray(dec).reshape(k, n).view(np.int8))


def test_requantize_int32_bias_add():
    """As tests/test_int8_serving.py:63: the bias is added to the int32
    accumulator before the rescale."""
    rng, _, enc, a = _case(9, 16, 64, 64)
    bias = rng.integers(-5000, 5000, size=(64,)).astype(np.int32)
    out = QMM(_t(a), _t(enc), torch.tensor(np.float32(0.02)),
              a_scale=torch.tensor(np.float32(0.01)), bias=_t(bias))
    acc = jref.ecc_qmatmul_ref(jnp.asarray(a), jnp.asarray(enc)) + bias[None]
    want = (acc.astype(jnp.float32) * (jnp.float32(0.01) * jnp.float32(0.02))
            ).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_f32(out.float().numpy()), _f32(want))
    q, s = quant.quantize_bias(torch.tensor([0.3, -1.7, 250.0]),
                               torch.tensor(0.01))
    jq, _ = jquant.quantize_bias(jnp.asarray([0.3, -1.7, 250.0]),
                                 jnp.float32(0.01))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_guards_raise_as_the_reference():
    """tests/test_int8_serving.py:80 and tests/test_abft.py:193."""
    rng, _, enc, a = _case(2, 4, 32, 32)
    a, enc = _t(a), _t(enc)
    for fn in (QMM, PLAIN):
        out = fn(a, enc, torch.tensor(0.1), a_scale=torch.tensor(0.1),
                 out_dtype=torch.float32)
        assert out.dtype == torch.float32
        with pytest.raises(ValueError, match="requantize epilogue needs "
                                             "w_scale"):
            fn(a, enc, a_scale=torch.tensor(0.1))
        with pytest.raises(ValueError, match="bias"):
            fn(a, enc, bias=torch.zeros(32, dtype=torch.int32))
        with pytest.raises(ValueError, match="a_scale"):
            fn(a.to(torch.bfloat16), enc, torch.tensor(0.1),
               a_scale=torch.tensor(0.1))
        with pytest.raises(ValueError, match="clamp"):
            fn(a, enc, clamp=1.0)
        with pytest.raises(ValueError, match="w_scale"):
            fn(a.float(), enc)


@pytest.mark.parametrize("m,k,n", [(32, 64, 128), (45, 100, 72),
                                   (16, 256, 64)])
def test_float_abft_zero_false_positives(m, k, n):
    """As tests/test_abft.py:43: clean weights give no mismatch, and the
    guarded output is bit-identical to the unguarded one; the counts equal
    the reference's ``abft_counts`` of the same accumulator."""
    rng = np.random.default_rng(m + n)
    enc = _enc(_wot_weights(rng, (k, n)))
    a = rng.normal(size=(m, k)).astype(np.float32)
    out, flags, (rows, col_mm) = QMM(_t(a), _t(enc), 0.01, with_flags=True,
                                     with_abft=True)
    assert rows.shape == (m, 2) and int(rows.sum()) == 0 and int(col_mm) == 0
    assert flags.tolist() == [0, 0]
    assert torch.equal(out, QMM(_t(a), _t(enc), 0.01))
    w = np.asarray(_dec(enc), np.float32) * np.float32(0.01)
    jr, jc = jref.abft_counts(jnp.asarray(a), jnp.asarray(w),
                              jnp.asarray(out.numpy()))
    assert int(np.asarray(jr).sum()) == 0 and int(np.asarray(jc).sum()) == 0


@pytest.mark.parametrize("m,k,n", SHAPES[:2])
def test_int8_paths_abft_zero_false_positives(m, k, n):
    _, _, enc, a = _case(m * n, m, k, n)
    out, (rows, col_mm) = QMM(_t(a), _t(enc), with_abft=True)
    assert int(rows.sum()) == 0 and int(col_mm) == 0
    assert torch.equal(out, QMM(_t(a), _t(enc)))
    sc = torch.tensor(np.float32(0.02))
    out, (rows, col_mm) = QMM(_t(a), _t(enc), sc, a_scale=sc, with_abft=True)
    assert int(rows.sum()) == 0 and int(col_mm) == 0
    assert torch.equal(out, QMM(_t(a), _t(enc), sc, a_scale=sc))


@pytest.mark.parametrize("bit", list(range(31)))
def test_fault_bits_detected_on_the_int_paths(bit):
    """Every int bit flipped into accumulator element (0, 0) trips both
    checksums on both exact paths, on row 0 only, and the counts equal the
    reference's ``abft_counts`` of the same faulted accumulator."""
    _, _, enc, a = _case(bit, 16, 64, 64)
    acc, (rows, col_mm) = QMM(_t(a), _t(enc), with_abft=True,
                              fault_bits=1 << bit)
    clean = np.asarray(jref.ecc_qmatmul_ref(jnp.asarray(a), jnp.asarray(enc)))
    dirty = clean.copy()
    dirty[0, 0] ^= np.int32(1 << bit)
    np.testing.assert_array_equal(acc.numpy(), dirty)
    jr, jc = jref.abft_counts(jnp.asarray(a), _dec(enc), jnp.asarray(dirty))
    np.testing.assert_array_equal(rows[:, 0].numpy(), np.asarray(jr))
    assert int(col_mm) == int(np.asarray(jc).sum()) == 1
    assert int(rows[0, 0]) == 1 and int(rows[1:, 0].sum()) == 0
    sc = torch.tensor(np.float32(0.02))
    _, (rows, col_mm) = QMM(_t(a), _t(enc), sc, a_scale=sc, with_abft=True,
                            fault_bits=1 << bit)
    assert int(rows[0, 0]) == 1 and int(col_mm) == 1
    assert int(rows[1:, 0].sum()) == 0


@pytest.mark.parametrize("bit", list(range(23, 31)))
def test_fault_bits_float_exponent_detected(bit):
    """Float-path detection is tolerance-gated: every exponent-bit flip of
    element (0, 0) fires, as the reference's ``abft_counts`` says of the
    same faulted accumulator."""
    rng = np.random.default_rng(bit)
    enc = _enc(_wot_weights(rng, (64, 64)))
    a = rng.normal(size=(16, 64)).astype(np.float32)
    out, (rows, col_mm) = QMM(_t(a), _t(enc), 0.01, with_abft=True,
                              fault_bits=1 << bit)
    clean = QMM(_t(a), _t(enc), 0.01)
    flipped = clean.clone()
    flipped.view(torch.int32)[0, 0] ^= 1 << bit
    assert torch.equal(out.view(torch.int32), flipped.view(torch.int32))
    w = np.asarray(_dec(enc), np.float32) * np.float32(0.01)
    jr, jc = jref.abft_counts(jnp.asarray(a), jnp.asarray(w),
                              jnp.asarray(out.numpy()))
    np.testing.assert_array_equal(rows[:, 0].numpy(), np.asarray(jr))
    assert int(col_mm) == int(np.asarray(jc).sum())
    assert int(rows[0, 0]) == 1 and int(col_mm) == 1


def test_abft_row_sum_that_wraps_int32():
    """Row sums past 2^31 wrap: the comparison is modulo 2^32 on both
    sides, so a clean wide accumulator gives no mismatch and a flipped one
    is caught, as the reference's int32 ``abft_counts`` says."""
    k, n, m = 256, 2048, 2
    wq = np.full((k, n), 63, np.int8)
    wq[:, 7::8] = 127
    enc = _enc(wq)
    a = np.full((m, k), 127, np.int8)
    acc = QMM(_t(a), _t(enc))
    assert int(acc.to(torch.int64).sum(1).max()) >= 2 ** 31
    for bits in (0, 1 << 30):
        acc, (rows, col_mm) = QMM(_t(a), _t(enc), with_abft=True,
                                  fault_bits=bits)
        jr, jc = jref.abft_counts(jnp.asarray(a), jnp.asarray(wq),
                                  jnp.asarray(acc.numpy()))
        np.testing.assert_array_equal(rows[:, 0].numpy(), np.asarray(jr))
        assert int(col_mm) == int(np.asarray(jc).sum()) == int(bool(bits))
        assert int(rows[0, 0]) == int(bool(bits))


@pytest.mark.parametrize("path", ["requant", "float"])
def test_clamp_matches_reference_and_counts_hits(path):
    """As tests/test_abft.py:170: the clipped values and per-row hits equal
    ``ref.clamp_counts`` of the f32 epilogue output, with the checksums
    off (the mismatch column stays 0)."""
    rng, _, enc, a = _case(21, 16, 64, 64)
    a_scale, w_scale = np.float32(0.02), np.float32(0.013)
    if path == "requant":
        y = (jref.ecc_qmatmul_ref(jnp.asarray(a), jnp.asarray(enc))
             .astype(jnp.float32) * (a_scale * w_scale))
        args = (_t(a), _t(enc), torch.tensor(w_scale))
        kw = dict(a_scale=torch.tensor(a_scale))
        cast = jnp.bfloat16
    else:
        a = rng.normal(size=(16, 64)).astype(np.float32)
        args = (_t(a), _t(enc), torch.tensor(w_scale))
        kw = {}
        y = jnp.asarray(QMM(*args).numpy())
        cast = jnp.float32
    c = float(np.quantile(np.abs(np.asarray(y)), 0.9))
    out, (rows, col_mm) = QMM(*args, clamp=c, **kw)
    want, hits = jref.clamp_counts(y, c)
    assert int(np.asarray(hits).sum()) > 0
    np.testing.assert_array_equal(rows[:, 1].numpy(), np.asarray(hits))
    assert int(rows[:, 0].sum()) == 0 and int(col_mm) == 0
    np.testing.assert_array_equal(_f32(out.float().numpy()),
                                  _f32(want.astype(cast)))
    got, th = ref.clamp_counts(_t(y), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(th.numpy(), np.asarray(hits))


def test_qmatmul_protected_is_the_raw_path_rescaled():
    """``ops.qmatmul_protected`` (reference ops.py:25-29) equals the raw
    accumulator times ``a_scale * w_scale`` in f32, bit for bit."""
    _, _, enc, a = _case(5, 8, 64, 64)
    a_s, w_s = np.float32(0.02), np.float32(0.013)
    out = ops.qmatmul_protected(_t(a), _t(enc), torch.tensor(a_s),
                                torch.tensor(w_s))
    acc = jref.ecc_qmatmul_ref(jnp.asarray(a), jnp.asarray(enc))
    want = acc.astype(jnp.float32) * (jnp.float32(a_s) * jnp.float32(w_s))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_fault_bits_are_a_value_change_of_one_element():
    """As tests/test_abft.py:151: the product carries the fault."""
    _, _, enc, a = _case(5, 8, 64, 64)
    clean = QMM(_t(a), _t(enc)).numpy()
    dirty, _ = QMM(_t(a), _t(enc), with_abft=True, fault_bits=1 << 7)
    dirty = dirty.numpy()
    assert dirty[0, 0] == clean[0, 0] ^ (1 << 7)
    np.testing.assert_array_equal(dirty.reshape(-1)[1:], clean.reshape(-1)[1:])

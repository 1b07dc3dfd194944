"""Port (repro_torch) vs reference (repro) on the codecs, quantization, WOT
and fault injection. Integers must match byte for byte.

Inputs are drawn once with NumPy and handed to both packages.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ecc as jecc
from repro.core import faults as jfaults
from repro.core import quant as jquant
from repro.core import wot as jwot
from repro.kernels import ecc_decode as jdec
from repro.kernels import ecc_encode as jenc
from repro.protection import policy as jpolicy
from repro_torch.core import ecc, faults, quant, wot
from repro_torch.kernels import ecc_decode, ecc_encode
from repro_torch.protection import policy

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _wot_blocks(rng, n):
    q = rng.integers(-64, 64, size=(n, 8), dtype=np.int8)
    q[:, 7] = rng.integers(-127, 128, size=n, dtype=np.int8)
    return q.view(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_tables_equal_reference():
    np.testing.assert_array_equal(ecc.COLS64, jecc.COLS64)
    np.testing.assert_array_equal(ecc.ROWMASK64, jecc.ROWMASK64)
    np.testing.assert_array_equal(ecc.COLS64_BYBYTE, jecc.COLS64_BYBYTE)
    assert ecc.CHECK_BIT == jecc.CHECK_BIT and ecc.BLOCK_BYTES == 8


def test_cuda_header_tables_equal_python_tables():
    """csrc/secded64.cuh carries the packed tables as literals; they must be
    the ones core.ecc builds."""
    src = (CSRC / "secded64.cuh").read_text()
    rows = re.search(r"ROWMASK\[7\] = \{(.*?)\};", src, re.S).group(1)
    assert [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)ull", rows)] == \
        list(ecc.ROWMASK64_PACKED)
    syn = re.search(r"SYN2BIT\[128\] = \{(.*?)\};", src, re.S).group(1)
    assert [int(x) for x in re.findall(r"\d+", syn)] == ecc.SYN2BIT.tolist()
    mask = re.search(r"CHECK_MASK = 0x([0-9a-f]+)ull", src).group(1)
    assert int(mask, 16) == ecc.CHECK_MASK64


def test_encode64_matches_reference():
    blocks = _wot_blocks(np.random.default_rng(0), 4096)
    ref = np.asarray(jecc.encode64(jnp.asarray(blocks)))
    np.testing.assert_array_equal(ecc.encode64(_t(blocks)).numpy(), ref)
    np.testing.assert_array_equal(ecc_encode.ecc_encode(_t(blocks)).numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode64_all_single_and_double_flips(seed):
    """All 64 single and 2016 double flips of a random encoded block:
    decoded bytes and flags equal the reference's; singles restore the
    block, doubles are flagged DUE."""
    base = np.asarray(jecc.encode64(jnp.asarray(
        _wot_blocks(np.random.default_rng(seed), 1))))[0]
    w = int(base.view("<u8")[0])
    masks = [1 << i for i in range(64)] + \
        [(1 << i) | (1 << j) for i in range(64) for j in range(i + 1, 64)]
    cases = np.array([w ^ m for m in masks], dtype="<u8").view(np.uint8)
    cases = cases.reshape(-1, 8)
    jd, js, jdd = (np.asarray(x) for x in jecc.decode64(jnp.asarray(cases)))
    d, s, dd = ecc.decode64(_t(cases))
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(dd.numpy(), jdd)
    assert s[:64].all() and not s[64:].any() and dd[64:].all()
    restored = np.asarray(jecc.restore_sign_bits(jnp.asarray(base)))
    np.testing.assert_array_equal(d[:64].numpy(), np.tile(restored, (64, 1)))
    np.testing.assert_array_equal(
        ecc.restore_sign_bits(_t(base)).numpy(), restored)


def test_decode_wrapper_matches_pallas_kernel_interpret():
    """The port's ecc_decode wrapper (plain route on CPU) against the
    reference's Pallas kernel in interpret mode, on faulted blocks."""
    rng = np.random.default_rng(3)
    enc = np.asarray(jecc.encode64(jnp.asarray(_wot_blocks(rng, 512))))
    flat = jfaults.inject(enc.reshape(-1), 2e-2, 5).reshape(enc.shape)
    jd, jf = jdec.ecc_decode(jnp.asarray(flat), blk_n=128)
    d, f = ecc_decode.ecc_decode(_t(flat))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert (f.numpy() == 1).any() and (f.numpy() == 2).any()


def test_encode_wrapper_matches_pallas_kernel_interpret():
    blocks = _wot_blocks(np.random.default_rng(4), 256)
    ref = jenc.ecc_encode(jnp.asarray(blocks), blk_n=128)
    np.testing.assert_array_equal(ecc_encode.ecc_encode(_t(blocks)).numpy(),
                                  np.asarray(ref))


def test_quantize_and_throttle_exact():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 24)).astype(np.float32)
    # exact .5 ties after scaling: round half to even must agree
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 127, -127],
                        np.float32) * (np.abs(x).max() / 127)
    js = np.asarray(jquant.compute_scale(jnp.asarray(x)))
    jq, _ = jquant.quantize(jnp.asarray(x))
    q, s = quant.quantize(_t(x))
    assert s.item() == js.item()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    per_row = quant.compute_scale(_t(x), dim=1)
    np.testing.assert_array_equal(
        per_row.numpy(), np.asarray(jquant.compute_scale(jnp.asarray(x), axis=1)))
    for n in (888, 893):
        flat = rng.integers(-127, 128, size=n, dtype=np.int8)
        np.testing.assert_array_equal(
            wot.throttle_q(_t(flat)).numpy(),
            np.asarray(jwot.throttle_q(jnp.asarray(flat))))


@pytest.mark.parametrize("path,shape", [
    (("layers", "attn", "wq"), (2, 3)),
    (("layers", "ln1", "w"), (2, 64)),
    (("layers", "attn", "bq"), (2, 64)),
    (("embed",), (512, 64)),
    (("final_norm", "w"), (64,)),
    (("layers", "mlp", "b_up"), (2, 8)),
])
def test_is_protected_weight_matches_reference(path, shape):
    import jax
    jpath = tuple(jax.tree_util.DictKey(k) for k in path)
    ref = jwot.is_protected_weight(jpath, jnp.zeros(shape, jnp.float32))
    assert wot.is_protected_weight(path, torch.zeros(shape)) == ref


@pytest.mark.parametrize("shape", [(3, 16, 24), (5, 7)])
def test_encode_leaf_matches_reference(shape):
    """Quantize + throttle + encode of one leaf, same-shape and flat-padded
    layouts: byte-equal images and equal scales."""
    w = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    jpt = jpolicy.ProtectionPolicy().encode_leaf(jnp.asarray(w), "in-place")
    pt = policy.ProtectionPolicy().encode_leaf(_t(w), "in-place")
    np.testing.assert_array_equal(pt.enc.numpy(), np.asarray(jpt.enc))
    assert pt.scale.item() == float(jpt.scale)
    assert pt.is_flat == jpt.is_flat and pt.orig_shape == jpt.orig_shape
    dec, c, d = policy.decode_leaf_with_flags(pt, torch.float32)
    jdec_w, jc, jd = jpolicy.decode_leaf_with_flags(jpt, jnp.float32)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec_w))
    assert (int(c), int(d)) == (int(jc), int(jd))


def test_host_fault_sampler_and_flips_match_reference():
    img = np.random.default_rng(7).integers(0, 256, 4096, dtype=np.uint8)
    pos = faults.sample_positions(img.size * 8, 1e-2, 11)
    np.testing.assert_array_equal(
        pos, jfaults.sample_positions(img.size * 8, 1e-2, 11))
    np.testing.assert_array_equal(faults.flip_bits_np(img, pos),
                                  jfaults.flip_bits_np(img, pos))
    np.testing.assert_array_equal(faults.inject(img, 1e-2, 11),
                                  jfaults.inject(img, 1e-2, 11))


def test_device_injector_xor_semantics_and_positions():
    """A position drawn twice cancels; the returned positions are exactly
    the bits that differ, and the same mask through the reference's host
    flipper gives the same image."""
    img = np.random.default_rng(8).integers(0, 256, 64, dtype=np.uint8)
    drawn = torch.tensor([3, 3, 17, 17, 17, 100, 511, 0, 9], dtype=torch.int64)
    flat = _t(img)
    live = faults.flip_positions_(flat, drawn)
    assert live.tolist() == [0, 9, 17, 100, 511]
    np.testing.assert_array_equal(flat.numpy(),
                                  jfaults.flip_bits_np(img, drawn.numpy()))
    gen = torch.Generator().manual_seed(0)
    big = torch.zeros(1 << 14, dtype=torch.uint8)
    out, live = faults.inject_torch(big, 1e-2, gen)
    diff = np.unpackbits(out.numpy(), bitorder="little").nonzero()[0]
    np.testing.assert_array_equal(diff, live.numpy())
    # pairs drawn twice cancel: about n^2 / n_bits of the n draws are lost
    n, n_bits = faults.n_faults(big.numel() * 8, 1e-2), big.numel() * 8
    assert n - 3 * n * n // n_bits <= live.numel() <= n


def test_device_injector_keeps_one_flip_per_block():
    """``one_per_block`` keeps the lowest surviving position of each 64-bit
    block, so every flip is correctable; the image changes at exactly the
    returned positions."""
    img = np.random.default_rng(9).integers(0, 256, 64, dtype=np.uint8)
    drawn = torch.tensor([3, 3, 17, 63, 64, 100, 127, 128, 511],
                         dtype=torch.int64)
    flat = _t(img)
    live = faults.flip_positions_(flat, drawn, one_per_block=True)
    assert live.tolist() == [17, 64, 128, 511]
    np.testing.assert_array_equal(flat.numpy(),
                                  jfaults.flip_bits_np(img, live.numpy()))
    gen = torch.Generator().manual_seed(1)
    big = torch.zeros(1 << 14, dtype=torch.uint8)
    out, live = faults.inject_torch(big, 2e-2, gen, one_per_block=True)
    diff = np.unpackbits(out.numpy(), bitorder="little").nonzero()[0]
    np.testing.assert_array_equal(diff, live.numpy())
    _, per_block = torch.unique(live // 64, return_counts=True)
    assert int(per_block.max()) == 1 and live.numel() > 100

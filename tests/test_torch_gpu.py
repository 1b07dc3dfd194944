"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Every test here is ``gpu``-marked and skips without a CUDA device.

The file imports neither JAX nor the reference (the machine with the card
need not have JAX), so it runs there alone:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import ecc
from repro_torch.core import wot
from repro_torch.kernels import (build, ecc_decode, ecc_encode, ecc_qmatmul,
                                 flash_attention, paged_attention,
                                 quant_throttle, throttle)
from repro_torch.protection.policy import ProtectionPolicy
from repro_torch.serving import kvcache

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _flip(blocks, every, gen):
    """Flip one random bit in every ``every``-th block and a second one in
    every ``3*every``-th, in place (blocks: contiguous (n, 8) uint8)."""
    words = blocks.view(torch.int64)[:, 0]
    for step in (every, 3 * every):
        idx = torch.arange(0, words.numel(), step, device=words.device)
        bits = torch.randint(0, 64, idx.shape, generator=gen,
                             device=words.device)
        words[idx] ^= torch.ones_like(bits) << bits


def _encoded_weight(k, n, dev, gen):
    w = torch.randn((k, n), generator=gen, device=dev)
    pt = ProtectionPolicy().encode_leaf(w, "in-place")
    _flip(pt.enc.view(-1, 8), 97, gen)
    return pt.enc, pt.scale


def test_gpu_codec_kernels_match_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    enc, _ = _encoded_weight(256, 512, cuda, gen)
    x = enc.view(-1, 8)
    before = build.COUNTS["ecc_decode"]
    kd, kf = ecc_decode.ecc_decode(x)
    assert build.COUNTS["ecc_decode"] == before + 1
    pd, pf = ecc_decode.ecc_decode_plain(x)
    assert torch.equal(kd, pd) and torch.equal(kf, pf)
    assert bool((kf == 1).any()) and bool((kf == 2).any())
    assert torch.equal(ecc_encode.ecc_encode(kd),
                       ecc_encode.ecc_encode_plain(kd))
    assert torch.equal(ecc.restore_sign_bits(ecc_encode.ecc_encode(kd)), kd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# m picks the kernel's rows per thread: 1 and 4 -> 1, 6 -> 2, 9 -> 4,
# 37 -> 8 in two passes over K
@pytest.mark.parametrize("m,k,n", [(37, 200, 72), (4, 64, 8), (1, 520, 136),
                                   (6, 96, 24), (9, 136, 64)])
def test_gpu_qmatmul_kernel_matches_plain(cuda, dtype, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    w, s = _encoded_weight(k, n, cuda, gen)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    ko, kf = ecc_qmatmul.ecc_qmatmul(a, w, s, with_flags=True)
    po, pf = ecc_qmatmul.ecc_qmatmul_plain(a, w, s, with_flags=True)
    assert kf.tolist() == pf.tolist() and kf.tolist() != [0, 0]
    # both sum the same f32 products in different orders
    torch.testing.assert_close(ko, po, rtol=1e-4, atol=1e-4)


def _leaves(x) -> list:
    """The tensors of a nested tuple, in order."""
    if isinstance(x, tuple):
        return [t for e in x for t in _leaves(e)]
    return [x]


def _assert_same(got, want):
    """Every returned tensor equal byte for byte (dtype included)."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), (x, y)


def _int8_case(m, k, n, dev, gen):
    w, s = _encoded_weight(k, n, dev, gen)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    return a, w, s


# ragged M, N and K; 37 and 70 rows take the M > 32 row chunks
INT8_SHAPES = [(37, 200, 72), (4, 64, 8), (1, 520, 136), (9, 136, 64),
               (70, 100, 136)]


@pytest.mark.parametrize("kind", ["raw", "raw-abft", "scalar", "rows-bias",
                                  "f32-abft", "f16-clamp-abft"])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_gpu_qmatmul_int8_paths_match_plain(cuda, kind, m, k, n):
    """The exact paths: int32 accumulators byte-equal, requantized outputs
    bit-equal, flags, row and column counts and clamp hits equal."""
    gen = torch.Generator(device=cuda).manual_seed(m * k + n)
    a, w, s = _int8_case(m, k, n, cuda, gen)
    rows = 0.01 + 0.04 * torch.rand((m, 1), generator=gen, device=cuda)
    bias = torch.randint(-5000, 5000, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    kw = {"raw": {}, "raw-abft": dict(with_abft=True),
          "scalar": dict(a_scale=torch.tensor(0.02, device=cuda)),
          "rows-bias": dict(a_scale=rows, bias=bias),
          "f32-abft": dict(a_scale=rows[:, 0], out_dtype=torch.float32,
                           with_abft=True),
          "f16-clamp-abft": dict(a_scale=rows, out_dtype=torch.float16,
                                 with_abft=True, clamp=2.0)}[kind]
    args = (a, w) if kind.startswith("raw") else (a, w, s)
    before = build.COUNTS["ecc_qmatmul"]
    got = ecc_qmatmul.ecc_qmatmul(*args, with_flags=True, **kw)
    assert build.COUNTS["ecc_qmatmul"] == before + 1
    want = ecc_qmatmul.ecc_qmatmul_plain(*args, with_flags=True, **kw)
    _assert_same(got, want)
    assert got[1].tolist() != [0, 0]
    if kind == "f16-clamp-abft":
        assert int(got[2][0][:, 1].sum()) > 0        # the clamp hit
    if "abft" in kind:                              # no false positive
        assert int(got[2][0][:, 0].sum()) == 0 and int(got[2][1]) == 0


def _clamp_between(y):
    """A clamp bound near the 90% quantile of |y| in the widest gap among
    its neighbours, so the kernel's and the plain version's summation
    orders cannot put a value on the other side of it."""
    v = y.abs().flatten().sort().values
    i = int(0.9 * (v.numel() - 1))
    lo, hi = max(i - 50, 0), min(i + 50, v.numel() - 1)
    gaps = v[lo + 1:hi + 1] - v[lo:hi]
    j = lo + int(gaps.argmax())
    return float((v[j] + v[j + 1]) / 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(37, 200, 72), (4, 64, 8), (9, 136, 64)])
def test_gpu_qmatmul_float_abft_clamp_match_plain(cuda, dtype, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + 7 * n)
    w, s = _encoded_weight(k, n, cuda, gen)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    c = _clamp_between(ecc_qmatmul.ecc_qmatmul_plain(a, w, s))
    ko, kf, (kr, kc) = ecc_qmatmul.ecc_qmatmul(a, w, s, with_flags=True,
                                               with_abft=True, clamp=c)
    po, pf, (pr, pc) = ecc_qmatmul.ecc_qmatmul_plain(
        a, w, s, with_flags=True, with_abft=True, clamp=c)
    assert kf.tolist() == pf.tolist()
    assert torch.equal(kr, pr) and int(kc) == int(pc) == 0
    assert int(kr[:, 1].sum()) > 0 and int(kr[:, 0].sum()) == 0
    torch.testing.assert_close(ko, po, rtol=1e-4, atol=1e-4)
    # the guarded output equals the unguarded one where nothing was clipped
    plain = ecc_qmatmul.ecc_qmatmul(a, w, s)
    assert torch.equal(ko[ko.abs() < c], plain[ko.abs() < c])


@pytest.mark.parametrize("path", ["raw", "requant", "float"])
def test_gpu_qmatmul_fault_bits_detected(cuda, path):
    """Every int bit (0..30) on the int paths, every exponent bit (23..30)
    on the float path, flipped into element (0, 0): rows[0, 0] == 1,
    col_mm == 1, on the kernel and the plain version alike."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a, w, s = _int8_case(40, 96, 128, cuda, gen)
    if path == "float":
        a = torch.randn((40, 96), generator=gen, device=cuda)
        a[0] *= 64   # |acc[0, 0]| away from [1, 2): no flip to inf / NaN
    args = (a, w) if path == "raw" else (a, w, s)
    kw = dict(a_scale=torch.tensor(0.02, device=cuda)) \
        if path == "requant" else {}
    for bit in (range(23, 31) if path == "float" else range(31)):
        got = ecc_qmatmul.ecc_qmatmul(*args, with_abft=True,
                                      fault_bits=1 << bit, **kw)
        want = ecc_qmatmul.ecc_qmatmul_plain(*args, with_abft=True,
                                             fault_bits=1 << bit, **kw)
        rows, col_mm = got[1]
        assert torch.equal(rows, want[1][0]) and int(col_mm) == int(want[1][1])
        assert int(rows[0, 0]) == 1 and int(col_mm) == 1, bit
        assert int(rows[1:, 0].sum()) == 0


def test_gpu_qmatmul_head_width_row_sum_wraps(cuda):
    """A head-width strip (N = 102,400) of extreme int8 values: its row sums
    pass 2^31 and wrap; the kernel's unsigned sums and the plain version's
    wrapped int64 sums agree, with no mismatch clean and the flip found."""
    k, n = 256, 102400
    q = torch.full((k, n), 63, dtype=torch.int8, device=cuda)
    q[:, 7::8] = 127
    w = ecc.encode64(q.view(torch.uint8).reshape(k, n // 8, 8)).reshape(k, n)
    a = torch.full((4, k), 127, dtype=torch.int8, device=cuda)
    acc = ecc_qmatmul.ecc_qmatmul(a, w)
    assert int(acc.to(torch.int64).sum(1).max()) >= 2 ** 31
    for bits in (0, 1 << 30):
        got = ecc_qmatmul.ecc_qmatmul(a, w, with_abft=True, fault_bits=bits)
        want = ecc_qmatmul.ecc_qmatmul_plain(a, w, with_abft=True,
                                             fault_bits=bits)
        _assert_same(got, want)
        assert int(got[1][0][0, 0]) == int(got[1][1]) == int(bool(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_page_attention_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, h, kv, s, hd = 3, 4, 2, 32, 16
    pol = kvcache.get_kv_policy("in-place")
    ke, _, ksc = kvcache._encode_kv(
        torch.randn((b, s, kv, hd), generator=gen, device=cuda), pol)
    ve, _, vsc = kvcache._encode_kv(
        torch.randn((b, s, kv, hd), generator=gen, device=cuda), pol)
    _flip(ke.view(-1, 8), 7, gen)
    _flip(ve.view(-1, 8), 11, gen)
    q = torch.randn((b, h, 1, hd), generator=gen, device=cuda).to(dtype)
    args = (q, ke, None, ksc, ve, None, vsc,
            torch.tensor([31, 7, 0], device=cuda))
    ko, kf = paged_attention.fused_page_attention(*args)
    po, pf = paged_attention.fused_page_attention_plain(*args)
    assert kf.tolist() == pf.tolist() and kf.tolist() != [0, 0]
    # same op order; f32 sums in another order (bf16: one rounding apart)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["faulty", "in-place"])
# 100 tokens in chunks of 32: the last chunk is ragged; 16 covers all pos
@pytest.mark.parametrize("s,chunk", [(100, 32), (48, 16), (40, 256)])
def test_gpu_chunked_attention_kernel_matches_plain(cuda, dtype, scheme, s,
                                                    chunk):
    gen = torch.Generator(device=cuda).manual_seed(s + chunk)
    b, h, kv, hd = 3, 4, 2, 16
    pol = kvcache.KVProtectionPolicy(scheme=scheme)
    ke, _, ksc = kvcache._encode_kv(
        torch.randn((b, s, kv, hd), generator=gen, device=cuda), pol)
    ve, _, vsc = kvcache._encode_kv(
        torch.randn((b, s, kv, hd), generator=gen, device=cuda), pol)
    _flip(ke.view(-1, 8), 7, gen)
    _flip(ve.view(-1, 8), 11, gen)
    q = torch.randn((b, h, 1, hd), generator=gen, device=cuda).to(dtype)
    args = (q, ke, None, ksc, ve, None, vsc,
            torch.tensor([s - 1, s // 2, 0], device=cuda))
    before = build.COUNTS["chunked_page_attention"]
    ko, kf = paged_attention.chunked_page_attention(
        *args, scheme=scheme, chunk_tokens=chunk)
    assert build.COUNTS["chunked_page_attention"] == before + 1
    po, pf = paged_attention.chunked_page_attention_plain(
        *args, scheme=scheme, chunk_tokens=chunk)
    assert kf.tolist() == pf.tolist()
    assert (kf.tolist() != [0, 0]) == (scheme == "in-place")
    # all f32 in the same op order, summed in another order; bf16 output
    # rounds once, so at most one bf16 ulp apart
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)


def _parity_strips(b, s, kv, hd, dev, gen):
    """Parity-zero K/V strips with flipped data AND check bytes."""
    pol = kvcache.get_kv_policy("parity-zero")
    out = []
    for every in (7, 11):
        e, c, sc = kvcache._encode_kv(
            torch.randn((b, s, kv, hd), generator=gen, device=dev), pol)
        _flip(e.view(-1, 8), every, gen)
        c.view(-1)[::every + 2] ^= 1 << torch.randint(
            0, 8, (c.view(-1)[::every + 2].numel(),), generator=gen,
            device=dev).to(torch.uint8)
        out += [e, c, sc]
    return out


def _bad_valid_bytes(ke, kc, ve, vc, pos):
    """Bad bytes (parity mismatches) of valid (<= pos) tokens."""
    s = ke.shape[1]
    valid = (torch.arange(s, device=ke.device)[None, :] <= pos[:, None])
    return sum(int((ecc.decode_parity8(e, c)[1].sum((-2, -1)) * valid).sum())
               for e, c in ((ke, kc), (ve, vc)))


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_page_attention_parity_zero_matches_plain(cuda, dtype, per_slot):
    """The strip kernel's parity-zero path: output as close to its plain
    version as the in-place path's, flags equal, the corrected count = bad
    bytes of valid tokens, DUE 0; per-slot rows (2, B) sum to the
    totals."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, h, kv, s, hd = 3, 4, 2, 48, 16
    ke, kc, ksc, ve, vc, vsc = _parity_strips(b, s, kv, hd, cuda, gen)
    q = torch.randn((b, h, 1, hd), generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([47, 20, 0], device=cuda)
    args = (q, ke, kc, ksc, ve, vc, vsc, pos)
    before = build.COUNTS["fused_page_attention"]
    ko, kf = paged_attention.fused_page_attention(
        *args, scheme="parity-zero", per_slot=per_slot)
    assert build.COUNTS["fused_page_attention"] == before + 1
    po, pf = paged_attention.fused_page_attention_plain(
        *args, scheme="parity-zero", per_slot=per_slot)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)
    assert torch.equal(kf, pf) and kf.dtype == torch.int32
    assert tuple(kf.shape) == ((2, b) if per_slot else (2,))
    tot = kf.sum(-1) if per_slot else kf
    assert tot.tolist() == [_bad_valid_bytes(ke, kc, ve, vc, pos), 0]
    assert int(tot[0]) > 0


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(100, 32), (48, 16)])
def test_gpu_chunked_attention_parity_zero_matches_plain(cuda, dtype, s,
                                                         chunk, per_slot):
    gen = torch.Generator(device=cuda).manual_seed(s + chunk + 1)
    b, h, kv, hd = 3, 4, 2, 16
    ke, kc, ksc, ve, vc, vsc = _parity_strips(b, s, kv, hd, cuda, gen)
    q = torch.randn((b, h, 1, hd), generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([s - 1, s // 2, 0], device=cuda)
    args = (q, ke, kc, ksc, ve, vc, vsc, pos)
    ko, kf = paged_attention.chunked_page_attention(
        *args, scheme="parity-zero", chunk_tokens=chunk, per_slot=per_slot)
    po, pf = paged_attention.chunked_page_attention_plain(
        *args, scheme="parity-zero", chunk_tokens=chunk, per_slot=per_slot)
    assert torch.equal(kf, pf)
    tot = kf.sum(-1) if per_slot else kf
    assert tot.tolist() == [_bad_valid_bytes(ke, kc, ve, vc, pos), 0]
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["strip", "chunked"])
@pytest.mark.parametrize("scheme", ["faulty", "in-place"])
def test_gpu_attention_per_slot_rows_match_plain(cuda, kernel, scheme):
    gen = torch.Generator(device=cuda).manual_seed(9)
    b, h, kv, s, hd = 4, 4, 2, 32, 16
    pol = kvcache.KVProtectionPolicy(scheme=scheme)
    ke, _, ksc = kvcache._encode_kv(
        torch.randn((b, s, kv, hd), generator=gen, device=cuda), pol)
    ve, _, vsc = kvcache._encode_kv(
        torch.randn((b, s, kv, hd), generator=gen, device=cuda), pol)
    _flip(ke.view(-1, 8), 5, gen)
    _flip(ve.view(-1, 8), 9, gen)
    q = torch.randn((b, h, 1, hd), generator=gen, device=cuda)
    args = (q, ke, None, ksc, ve, None, vsc,
            torch.tensor([31, 12, 3, 0], device=cuda))
    fn, plain = ((paged_attention.fused_page_attention,
                  paged_attention.fused_page_attention_plain)
                 if kernel == "strip" else
                 (paged_attention.chunked_page_attention,
                  paged_attention.chunked_page_attention_plain))
    _, rows = fn(*args, scheme=scheme, per_slot=True)
    _, prow = plain(*args, scheme=scheme, per_slot=True)
    _, tot = fn(*args, scheme=scheme)
    assert torch.equal(rows, prow) and tuple(rows.shape) == (2, b)
    assert torch.equal(rows.sum(1, dtype=torch.int32), tot)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# 128: whole tiles; 100 and 1: a ragged S
@pytest.mark.parametrize("s,d", [(128, 16), (100, 64), (1, 128), (200, 128),
                                 (70, 32)])
def test_gpu_flash_attention_kernel_matches_plain(cuda, dtype, s, d):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((2, 3, s, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    before = build.COUNTS["flash_attention"]
    ko = flash_attention.flash_attention(q, k, v)
    assert build.COUNTS["flash_attention"] == before + 1
    po = flash_attention.flash_attention_plain(q, k, v)
    # same op order, f32 sums in another order; bf16 probabilities can
    # round across a boundary, and the output rounds once
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)


def _tie_blocks(nblk, dev, gen):
    """f32 blocks whose quantization lands on exact rounding ties (scale
    2^-7, w / scale = k + 0.5), +-63.5 and -64.5 around the WOT bounds,
    and -0.0."""
    k = torch.randint(-127, 127, (nblk, 8), generator=gen, device=dev).float()
    k += 0.5
    k[:, 0], k[:, 1], k[:, 2], k[:, 3] = 63.5, -64.5, -63.5, -0.0
    k[0, 4] = 127.0
    return k * 2.0 ** -7


# 1 block, ragged sizes, and one leaf over 2^31 bytes (2^26 + 3 blocks of
# 32 bytes: byte offsets past the int32 range)
@pytest.mark.parametrize("nblk,kind", [(1, "normal"), (1037, "normal"),
                                       (100_003, "ties"), (64, "zeros"),
                                       (2 ** 26 + 3, "normal")])
def test_gpu_quantize_throttle_kernel_matches_plain(cuda, nblk, kind):
    gen = torch.Generator(device=cuda).manual_seed(nblk)
    if kind == "ties":
        w = _tie_blocks(nblk, cuda, gen)
    elif kind == "zeros":
        w = torch.zeros((nblk, 8), device=cuda)
    else:
        w = 3 * torch.randn((nblk, 8), generator=gen, device=cuda)
    before = build.COUNTS["quantize_throttle"]
    kq, ks = quant_throttle.quantize_throttle(w)
    assert build.COUNTS["quantize_throttle"] == before + 1
    pq, ps = quant_throttle.quantize_throttle_plain(w)
    assert torch.equal(kq, pq)                       # byte for byte
    assert ks.view(torch.int32).item() == ps.view(torch.int32).item()
    assert int(wot.count_large_in_protected(kq.reshape(-1))) == 0


@pytest.mark.parametrize("nblk", [1, 2048, 4_194_305, 2 ** 28 + 5])
def test_gpu_throttle_kernel_matches_plain(cuda, nblk):
    gen = torch.Generator(device=cuda).manual_seed(nblk)
    q = torch.randint(-128, 128, (nblk, 8), generator=gen, device=cuda,
                      dtype=torch.int8)
    q[0] = torch.tensor([-128, 127, -65, 64, -64, 63, 0, -128])
    before = build.COUNTS["throttle"]
    kq = throttle.throttle(q)
    assert build.COUNTS["throttle"] == before + 1
    assert torch.equal(kq, throttle.throttle_plain(q))


@pytest.mark.parametrize("shape", [(5, 7), (2, 64, 96), (3, 13)])
def test_gpu_throttle_tensor_and_encode_routes_agree(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    w = 3 * torch.randn(shape, generator=gen, device=cuda)
    k = wot.throttle_tensor(w, backend="cuda", with_q=True)
    p = wot.throttle_tensor(w, backend="torch", with_q=True)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    ke = ProtectionPolicy(backend="cuda").encode_leaf(w, "in-place")
    pe = ProtectionPolicy(backend="torch").encode_leaf(w, "in-place")
    assert torch.equal(ke.enc, pe.enc) and torch.equal(ke.scale, pe.scale)

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
                                 flash_attention, kv_write, paged_attention,
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


# M across both regimes (<= 32: split-K decode tiles; > 32: 128-row
# prefill tiles); (1037, 1000) has ragged K and N and rows that are not
# 16-byte aligned (element and 8-byte copies), (1024, 1152) aligned rows
@pytest.mark.parametrize("path", ["float", "int8", "requant-abft-clamp"])
@pytest.mark.parametrize("kn", [(1037, 1000), (1024, 1152)])
@pytest.mark.parametrize("m", [1, 4, 8, 32, 33, 128, 300])
def test_gpu_qmatmul_regimes_match_plain(cuda, path, kn, m):
    """The tensor-core regimes against the plain version: flags exact, int
    paths byte-equal, the float path within 1e-4, at split-K plans and
    multi-tile M."""
    k, n = kn
    plan = ecc_qmatmul.plan_launch(m, n, k, torch.bfloat16)
    assert plan.regime == ("small" if m <= ecc_qmatmul.SMALL_M else "large")
    assert plan.splits > 1 or plan.m_tiles > 1
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    w, s = _encoded_weight(k, n, cuda, gen)
    if path == "float":
        a = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        got = ecc_qmatmul.ecc_qmatmul(a, w, s, with_flags=True)
        want = ecc_qmatmul.ecc_qmatmul_plain(a, w, s, with_flags=True)
        assert got[1].tolist() == want[1].tolist() != [0, 0]
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        return
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    if path == "int8":
        args, kw = (a, w), {}
    else:
        rows = 0.01 + 0.04 * torch.rand((m, 1), generator=gen, device=cuda)
        bias = torch.randint(-5000, 5000, (n,), generator=gen, device=cuda,
                             dtype=torch.int32)
        y = ecc_qmatmul.ecc_qmatmul_plain(a, w, s, a_scale=rows, bias=bias,
                                          out_dtype=torch.float32)
        args, kw = (a, w, s), dict(a_scale=rows, bias=bias, with_abft=True,
                                   clamp=float(y.abs().quantile(0.9)))
    got = ecc_qmatmul.ecc_qmatmul(*args, with_flags=True, **kw)
    want = ecc_qmatmul.ecc_qmatmul_plain(*args, with_flags=True, **kw)
    _assert_same(got, want)
    assert got[1].tolist() != [0, 0]


# phi3-medium-14b's w_up and w_down, paligemma-3b's wk and wv (one KV head
# of 256), and whisper-base's projections (K 512 -> N 512 and 2,048, K
# 2,048 -> N 512) and head (K 512 -> N 51,968: few K blocks for the
# split-K grid) at the decode step's M = 4; mamba2-2.7b's fused w_in (K
# 2,560 -> N 10,576 = 82 x 128 + 80: the last N tile is ragged) and w_out
# (5,120 -> 2,560) in the decode regime (M = 4) and the prefill regime (M
# = 33, the least M of its 128-row tiles, and 520: five M tiles, the last
# ragged)
MODEL_SHAPES = [(4, 5120, 17920), (4, 17920, 5120), (4, 2048, 256),
                (4, 512, 512), (4, 512, 2048), (4, 2048, 512),
                (4, 512, 51968)] + [(m, k, n) for m in (4, 33, 520)
                                    for k, n in ((2560, 10576),
                                                 (5120, 2560))]


@pytest.mark.parametrize("m,k,n", MODEL_SHAPES)
def test_gpu_qmatmul_model_shapes_match_plain(cuda, m, k, n):
    """The float path at the new archs' shapes: flags exact, within 2e-4
    of sum |a| |w| of the plain version on every output, a ragged last N
    tile's included (both sum the same exact f32 products in other
    orders, over up to 17,920 terms: chip_smoke.py's QMM_RTOL), a launch
    repeated bit for bit."""
    plan = ecc_qmatmul.plan_launch(m, n, k, torch.bfloat16)
    assert plan.regime == ("small" if m <= ecc_qmatmul.SMALL_M else "large")
    gen = torch.Generator(device=cuda).manual_seed(k + n + m - 4)
    w, s = _encoded_weight(k, n, cuda, gen)
    a = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    ko, kf = ecc_qmatmul.ecc_qmatmul(a, w, s, with_flags=True)
    po, pf = ecc_qmatmul.ecc_qmatmul_plain(a, w, s, with_flags=True)
    assert kf.tolist() == pf.tolist() and kf.tolist() != [0, 0]
    wq = ecc.decode64(w.reshape(k, n // 8, 8))[0].view(torch.int8)
    mag = a.float().abs() @ (wq.reshape(k, n).float().abs() * s)
    assert bool(((ko - po).abs() <= 2e-4 * mag + 1e-6).all())
    again = ecc_qmatmul.ecc_qmatmul(a, w, s)
    assert torch.equal(again.view(torch.int32), ko.view(torch.int32))


def test_gpu_qmatmul_split_k_repeats_bit_equal(cuda):
    """Two launches of the float path at a split-K decode shape give the
    same bits: the split partials are added in a fixed order."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    w, s = _encoded_weight(4096, 1024, cuda, gen)
    a = torch.randn((8, 4096), generator=gen, device=cuda).to(torch.bfloat16)
    assert ecc_qmatmul.plan_launch(8, 1024, 4096, a.dtype).splits > 1
    first = ecc_qmatmul.ecc_qmatmul(a, w, s, with_abft=True)
    for _ in range(3):
        again = ecc_qmatmul.ecc_qmatmul(a, w, s, with_abft=True)
        assert torch.equal(first[0].view(torch.int32),
                           again[0].view(torch.int32))
        assert torch.equal(first[1][0], again[1][0])


def test_gpu_mamba2_decode_step_routes_agree(cuda):
    """One decode-at-use step of full-width mamba2-2.7b cut to 2 layers,
    from a seeded state cache (state std 0.5, conv history std 1), on the
    kernel route and the plain route: flags equal (the weights carry
    correctable flips), logits within 0.25 at most and 0.02 on average
    (chip_smoke.py's 2-layer E2E limits); on the ``cuda`` route
    the step launches ``ecc_decode`` 1 + 2 times (the embedding and each
    layer's ``conv_w``) and ``ecc_qmatmul`` 2 x 2 + 1 times."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import protected

    cfg = configs.get("mamba2-2.7b").with_(n_layers=2)
    plan = ProtectionPolicy().plan(lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=cuda, leaf_fn=plan.encode_leaf)
    gen = torch.Generator(device=cuda).manual_seed(5)
    enc, _ = policy_mod.inject_tree_device(enc, 1e-5, gen,
                                           one_per_block=True)
    base = lm.init_cache(cfg, 4, 1, device=cuda)
    for name, t in base.items():
        std = 0.5 if name == "state" else 1.0
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda) * std)
    tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device=cuda)
    pos = torch.zeros((4,), dtype=torch.int32, device=cuda)
    out = {}
    for r in ("cuda", "torch"):
        cache = {k: v.clone() for k, v in base.items()}
        before = dict(build.COUNTS)
        step = protected.make_serve_step(cfg, backend=r)
        out[r] = step(enc, cache, tok, pos)
        torch.cuda.synchronize()
        launched = {k: build.COUNTS[k] - before[k] for k in build.COUNTS
                    if build.COUNTS[k] != before[k]}
        want = {"ecc_decode": 3, "ecc_qmatmul": 5} if r == "cuda" else {}
        assert launched == want, (r, launched)
    lg, _, fl = out["cuda"]
    lo, _, fo = out["torch"]
    assert {k: v.tolist() for k, v in fl.items()} == \
        {k: v.tolist() for k, v in fo.items()}
    assert int(fl["layers"][:, 0].sum()) > 0
    d = (lg.float() - lo.float()).abs()
    assert bool(torch.isfinite(lg.float()).all())
    assert float(d.max()) <= 0.25 and float(d.mean()) <= 0.02


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
# 128: whole tiles; 100, 1, 300: a ragged S; 256: the tensor-core route's
# Q fragments re-read from shared memory
@pytest.mark.parametrize("s,d", [(128, 16), (100, 64), (1, 128), (200, 128),
                                 (70, 32), (300, 256), (64, 256)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# (S, window, D): whole tiles; a window that is not a multiple of 64 and
# a ragged S; a window shorter than a tile (rows whose first loaded tile
# is wholly masked); a window of at least S; recurrentgemma-2b's head dim
@pytest.mark.parametrize("s,window,d", [(256, 64, 64), (300, 100, 128),
                                        (200, 20, 32), (130, 500, 16),
                                        (700, 256, 256), (333, 97, 256)])
def test_gpu_flash_attention_window_matches_plain(cuda, dtype, s, window,
                                                  d):
    """The sliding window: the kernel against its plain version (the same
    tiles walked per query tile), at the tolerances of the causal test."""
    gen = torch.Generator(device=cuda).manual_seed(s + window + d)
    q, k, v = (torch.randn((2, 3, s, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    before = build.COUNTS["flash_attention"]
    ko = flash_attention.flash_attention(q, k, v, window=window)
    assert build.COUNTS["flash_attention"] == before + 1
    po = flash_attention.flash_attention_plain(q, k, v, window=window)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)
    if window >= s:   # covers every key: the causal kernel's result
        torch.testing.assert_close(
            ko.float(), flash_attention.flash_attention(q, k, v).float(),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# MLA's head split (192, 128): whole tiles, ragged S, one row
@pytest.mark.parametrize("s", [256, 200, 1])
def test_gpu_flash_attention_mla_split_matches_plain(cuda, dtype, s):
    """q and k of 192 dims, v of 128: the kernel against its plain version
    at the tolerances of the causal test; the output takes v's head dim.
    Every other unequal pair raises before a launch."""
    gen = torch.Generator(device=cuda).manual_seed(s + 192)
    q, k = (torch.randn((2, 3, s, 192), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn((2, 3, s, 128), generator=gen, device=cuda).to(dtype)
    before = build.COUNTS["flash_attention"]
    ko = flash_attention.flash_attention(q, k, v)
    assert build.COUNTS["flash_attention"] == before + 1
    assert tuple(ko.shape) == (2, 3, s, 128)
    po = flash_attention.flash_attention_plain(q, k, v)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)
    for dv in (64, 192, 256):
        with pytest.raises(ValueError, match="head dims"):
            flash_attention.flash_attention(q, k, v[..., :1].expand(
                2, 3, s, dv).contiguous())
    assert build.COUNTS["flash_attention"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_flash_attention_whisper_decoder_shape(cuda, dtype):
    """whisper-base's decoder self-attention over 448 text positions at
    batch 8 (8 heads of 64): within the tolerance above of the plain
    version, and of SDPA (causal) within that of the plain version plus
    one bf16 rounding of the output."""
    gen = torch.Generator(device=cuda).manual_seed(448)
    q, k, v = (torch.randn((8, 8, 448, 64), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    ko = flash_attention.flash_attention(q, k, v)
    po = flash_attention.flash_attention_plain(q, k, v)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ko.float(), po.float(), rtol=tol, atol=tol)
    so = torch.nn.functional.scaled_dot_product_attention(
        q.float(), k.float(), v.float(), is_causal=True)
    torch.testing.assert_close(ko.float(), so, rtol=2 * tol + 2 ** -8,
                               atol=2 * tol)


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


def _paged_pool(b, npg, ps, kv, hd, scheme, dev, gen):
    """One layer's pool as the serving front-end lays it out: parking pages
    0..B-1, then the rows' pages in a shuffled order, two spare; rows 0 and
    1 share their first page (a common prefix) and the last row's last page
    is its parking page, past its pos. Data (and check) bytes flipped.
    -> (pool operands (kp, kc, ks, vp, vc, vs), table (B, npg) int32,
    pos (B,) int32)."""
    n_pages = b + b * npg + 2
    pol = kvcache.KVProtectionPolicy(scheme=scheme)
    pool = []
    for every in (7, 11):
        e, c, sc = kvcache._encode_kv(
            torch.randn((n_pages, ps, kv, hd), generator=gen, device=dev),
            pol)
        _flip(e.view(-1, 8), every, gen)
        if c is not None:
            c.view(-1)[::every + 2] ^= 1 << torch.randint(
                0, 8, (c.view(-1)[::every + 2].numel(),), generator=gen,
                device=dev).to(torch.uint8)
        pool += [e, c, sc]
    perm = torch.randperm(n_pages - b, generator=gen, device=dev) + b
    table = perm[: b * npg].reshape(b, npg).to(torch.int32)
    table[1, 0] = table[0, 0]
    table[b - 1, npg - 1] = b - 1
    s = npg * ps
    pos = torch.tensor([s - 1, s // 2, (npg - 1) * ps - 1, 0, s - 2][:b],
                       dtype=torch.int32, device=dev)
    pos[b - 1] = min(int(pos[b - 1]), (npg - 1) * ps - 1)
    return pool, table, pos


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("scheme", ["faulty", "in-place", "parity-zero"])
# (B, H, KV, hd, pages, page_size): rep 1, 2 and 3 (minitron's), hd 24
# (8-byte copies, check rows of 3 bytes), and paligemma-3b's rep 8 over one
# KV head of 256 at S 272 (the strip kernel stops at 287 tokens there)
@pytest.mark.parametrize("shape", [(3, 4, 4, 128, 5, 16),
                                   (4, 4, 2, 16, 4, 16),
                                   (3, 6, 2, 32, 3, 16),
                                   (3, 2, 1, 24, 6, 8),
                                   (4, 8, 1, 256, 17, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["strip", "chunked"])
def test_gpu_paged_table_entries_match_plain(cuda, kernel, dtype, shape,
                                             scheme, per_slot):
    """The table entries against their plain versions (the gather, then the
    strip plain version): the strip kernel bit-equal in bf16 (the plain
    version repeats its f32 summation order step for step, and products of
    bf16 values are exact in f32) and both kernels to f32 rounding
    otherwise; flags and per-slot rows exactly equal; one launch per
    call."""
    b, h, kv, hd, npg, ps = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + len(scheme))
    pool, table, pos = _paged_pool(b, npg, ps, kv, hd, scheme, cuda, gen)
    q = torch.randn((b, h, 1, hd), generator=gen, device=cuda).to(dtype)
    fn, plain = ((paged_attention.fused_page_attention_paged,
                  paged_attention.fused_page_attention_paged_plain)
                 if kernel == "strip" else
                 (paged_attention.chunked_page_attention_paged,
                  paged_attention.chunked_page_attention_paged_plain))
    name = ("fused_page_attention" if kernel == "strip"
            else "chunked_page_attention")
    before = build.COUNTS[name]
    ko, kf = fn(q, *pool, table, pos, scheme=scheme, per_slot=per_slot)
    assert build.COUNTS[name] == before + 1
    po, pf = plain(q, *pool, table, pos, scheme=scheme, per_slot=per_slot)
    assert torch.equal(kf, pf) and kf.dtype == torch.int32
    assert tuple(kf.shape) == ((2, b) if per_slot else (2,))
    assert (int(kf.sum()) > 0) == (scheme != "faulty")
    if dtype == torch.float32:
        torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-5)
    elif kernel == "strip":
        assert torch.equal(ko, po), \
            f"{int((ko != po).sum())} outputs differ from the plain version"
    else:   # one bf16 ulp (2^-8 .. 2^-7 relative) plus f32 noise
        torch.testing.assert_close(ko.float(), po.float(), rtol=2.0 ** -7,
                                   atol=1e-5)


_BAD_TABLE = """
import sys, torch
from repro_torch.kernels import paged_attention
from repro_torch.serving import kvcache
dev = torch.device("cuda")
pol = kvcache.KVProtectionPolicy(scheme="in-place")
pool = []
for _ in range(2):
    e, c, sc = kvcache._encode_kv(torch.randn((6, 16, 2, 64), device=dev),
                                  pol)
    pool += [e, c, sc]
table = torch.tensor([[2, 3], [4, int(sys.argv[2])]], dtype=torch.int32,
                     device=dev)
pos = torch.tensor([31, 20], dtype=torch.int32, device=dev)
q = torch.randn((2, 2, 1, 64), device=dev).to(torch.bfloat16)
fn = getattr(paged_attention, sys.argv[1])
try:
    fn(q, *pool, table, pos)
    torch.cuda.synchronize()
except RuntimeError as err:
    print("launch failed:", err)
    sys.exit(3)
print("ran")
"""


@pytest.mark.parametrize("bad", [6, -1])
@pytest.mark.parametrize("kernel", ["fused_page_attention_paged",
                                    "chunked_page_attention_paged"])
def test_gpu_paged_table_entry_out_of_range_fails(cuda, kernel, bad):
    """A table entry outside [0, P) makes the launch fail with a CUDA
    error, as the gather the kernels replace raised, instead of reading
    outside the pool. In a child process: the error ends its CUDA context.
    A valid id (5) runs."""
    import os
    import pathlib
    import subprocess
    import sys
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    for page, want in ((5, 0), (bad, 3)):
        r = subprocess.run([sys.executable, "-c", _BAD_TABLE, kernel,
                            str(page)], env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == want, (page, r.stdout, r.stderr[-2000:])


@pytest.mark.parametrize("kernel", ["strip", "chunked"])
def test_gpu_paged_call_is_one_launch(cuda, kernel):
    """A table-entry call on the serve path (int32 table and pos) is one
    kernel launch: no gather, no flag reduction, no cast."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    pool, table, pos = _paged_pool(4, 8, 16, 4, 128, "in-place", cuda, gen)
    q = torch.randn((4, 4, 1, 128), generator=gen, device=cuda).to(
        torch.bfloat16)
    fn = (paged_attention.fused_page_attention_paged if kernel == "strip"
          else paged_attention.chunked_page_attention_paged)
    fn(q, *pool, table, pos, per_slot=True)      # tickets allocated once
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(q, *pool, table, pos, per_slot=True)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1, on_card


# (B, KV, S): the plan's split counts 32, 4, 2 and 1 (132 SMs)
@pytest.mark.parametrize("b,kv,s,splits", [(1, 1, 2048, 32), (2, 2, 256, 4),
                                           (8, 32, 128, 2), (4, 32, 16, 1)])
def test_gpu_chunked_splits_match_plain_and_repeat(cuda, b, kv, s, splits):
    """The chunked kernel at several split counts: within f32 rounding of
    its plain version, flags equal, and a second launch bit-equal to the
    first (splits merge in split order, no float atomics)."""
    assert paged_attention.plan_splits(
        b, kv, s, paged_attention._sm_count(cuda)) == splits or \
        paged_attention._sm_count(cuda) != 132
    gen = torch.Generator(device=cuda).manual_seed(b + kv + s)
    pol = kvcache.get_kv_policy("in-place")
    ke, _, ksc = kvcache._encode_kv(
        torch.randn((b, s, kv, 128), generator=gen, device=cuda), pol)
    ve, _, vsc = kvcache._encode_kv(
        torch.randn((b, s, kv, 128), generator=gen, device=cuda), pol)
    _flip(ke.view(-1, 8), 13, gen)
    _flip(ve.view(-1, 8), 17, gen)
    q = torch.randn((b, kv, 1, 128), generator=gen, device=cuda).to(
        torch.bfloat16)
    pos = torch.tensor([s - 1, s // 3, 5, 0, s - 7, 40, 64, 1][:b],
                       dtype=torch.int32, device=cuda)
    args = (q, ke, None, ksc, ve, None, vsc, pos)
    ko, kf = paged_attention.chunked_page_attention(*args)
    ko2, kf2 = paged_attention.chunked_page_attention(*args)
    assert torch.equal(ko, ko2) and torch.equal(kf, kf2)
    po, pf = paged_attention.chunked_page_attention_plain(*args)
    assert torch.equal(kf, pf) and int(kf[0]) > 0
    torch.testing.assert_close(ko.float(), po.float(), rtol=1e-2, atol=1e-2)


# paligemma-3b's decode attention: 8 query heads over one KV head of 256,
# at the long-context path's S 2,064 and a short S
@pytest.mark.parametrize("b,s", [(4, 2064), (1, 272)])
def test_gpu_chunked_rep8_head_dim_256_matches_plain(cuda, b, s):
    """The chunked kernel at rep 8 and hd 256 (one CTA per SM): within one
    bf16 ulp of its plain version, flags equal, a second launch
    bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(b + s)
    pol = kvcache.get_kv_policy("in-place")
    ke, _, ksc = kvcache._encode_kv(
        torch.randn((b, s, 1, 256), generator=gen, device=cuda), pol)
    ve, _, vsc = kvcache._encode_kv(
        torch.randn((b, s, 1, 256), generator=gen, device=cuda), pol)
    _flip(ke.view(-1, 8), 13, gen)
    _flip(ve.view(-1, 8), 17, gen)
    q = torch.randn((b, 8, 1, 256), generator=gen, device=cuda).to(
        torch.bfloat16)
    pos = torch.tensor([s - 1, s // 3, 5, 0][:b], dtype=torch.int32,
                       device=cuda)
    args = (q, ke, None, ksc, ve, None, vsc, pos)
    ko, kf = paged_attention.chunked_page_attention(*args)
    ko2, kf2 = paged_attention.chunked_page_attention(*args)
    assert torch.equal(ko, ko2) and torch.equal(kf, kf2)
    po, pf = paged_attention.chunked_page_attention_plain(*args)
    assert torch.equal(kf, pf) and int(kf[0]) > 0
    torch.testing.assert_close(ko.float(), po.float(), rtol=2.0 ** -7,
                               atol=1e-5)


# 1 block, ragged value counts, ties, an all-zero leaf and one leaf over
# 2^31 bytes, as the train step's write-back sees them
@pytest.mark.parametrize("n,kind", [(8, "normal"), (3, "normal"),
                                    (1037 * 7, "normal"),
                                    (800_003, "ties"), (45, "zeros"),
                                    (2 ** 29 + 5, "normal")])
def test_gpu_quantize_throttle_write_back_matches_plain(cuda, n, kind):
    """The write-back (masters updated in place where the clamp moved q)
    bit-equal to the plain route, q byte-equal, scale bit-equal, with and
    without q; one counted call."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    if kind == "ties":
        w = _tie_blocks(-(-n // 8), cuda, gen).reshape(-1)[:n]
    elif kind == "zeros":
        w = torch.zeros(n, device=cuda)
    else:
        w = 3 * torch.randn(n, generator=gen, device=cuda)
    w = w.clone()
    pw = w.clone()
    pq, ps = quant_throttle.quantize_throttle_plain(pw, write_back=True)
    for with_q in (True, False):
        kw = w.clone()
        before = build.COUNTS["quantize_throttle"]
        kq, ks = quant_throttle.quantize_throttle(kw, write_back=True,
                                                  with_q=with_q)
        assert build.COUNTS["quantize_throttle"] == before + 1
        assert torch.equal(kw.view(torch.int32), pw.view(torch.int32))
        assert ks.view(torch.int32).item() == ps.view(torch.int32).item()
        assert (kq is None) != with_q
        if with_q:
            assert torch.equal(kq, pq)
            assert int(wot.count_large_in_protected(kq)) == 0
    if kind == "ties":
        assert bool((pw != w).any())


def _kv_case(b, kv, hd, npg, ps, scheme, dtype, t, dev, gen):
    """Random pools (bytes the write does not own stay random), a shuffled
    table with a page shared by rows 0 and 1 and the last row parked on
    its parking page, K/V (B, t, kv, hd) with per-token magnitudes spread
    over e^+-3, and pos (decode, t = 1: ragged positions, no two rows on
    one slot) or None (prefill of t tokens from 0)."""
    n_pages = b + b * npg + 2
    pools = []
    for _ in range(2):
        pools += [torch.randint(0, 256, (n_pages, ps, kv, hd), generator=gen,
                                device=dev, dtype=torch.uint8),
                  torch.randint(0, 256, (n_pages, ps, kv, hd // 8),
                                generator=gen, device=dev, dtype=torch.uint8)
                  if scheme == "parity-zero" else None,
                  torch.randn((n_pages, ps), generator=gen, device=dev)]
    perm = torch.randperm(n_pages - b, generator=gen, device=dev) + b
    table = perm[: b * npg].reshape(b, npg).to(torch.int32)
    mag = torch.exp(6 * torch.rand((2, b, t, 1, 1), generator=gen,
                                   device=dev) - 3)
    x = (torch.randn((2, b, t, kv, hd), generator=gen, device=dev) * mag)
    pos = None
    if t == 1:
        table[1, 0] = table[0, 0]
        table[b - 1, :] = b - 1
        pos = torch.tensor([3, 2 * ps + 1, npg * ps - 1, 0][:b - 1] + [0],
                           dtype=torch.int32, device=dev)
    return x[0].to(dtype), x[1].to(dtype), pools, table, pos


# (B, KV, hd, pages per row, page size): hd 16 to 128, the KV heads of rep
# 1, 2 and 3 at H = 4 and 6, hd 24 (three-byte check rows), 40 KV heads
# of 128 (D = 5,120: more blocks than threads) and paligemma-3b's one KV
# head of 256
@pytest.mark.parametrize("shape", [(3, 4, 128, 5, 16), (4, 2, 16, 4, 16),
                                   (3, 2, 32, 3, 16), (3, 1, 24, 6, 8),
                                   (2, 40, 128, 2, 16), (4, 1, 256, 4, 16)])
@pytest.mark.parametrize("scheme", ["faulty", "in-place", "parity-zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_gpu_kv_write_matches_plain(cuda, phase, dtype, scheme, shape):
    """kv_write against kv_write_plain: pools, check planes and the
    returned copies byte-equal, scales bit-equal; one launch for K and V."""
    b, kv, hd, npg, ps = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + len(scheme))
    t = 1 if phase == "decode" else (npg - 1) * ps
    k, v, pools, table, pos = _kv_case(b, kv, hd, npg, ps, scheme, dtype, t,
                                       cuda, gen)
    kp = [None if a is None else a.clone() for a in pools]
    pp = [None if a is None else a.clone() for a in pools]
    before = build.COUNTS["kv_write"]
    kc = kv_write.kv_write(k, v, *kp, table, pos, scheme=scheme, copy=True)
    assert build.COUNTS["kv_write"] == before + 1
    pc = kv_write.kv_write_plain(k, v, *pp, table, pos, scheme=scheme,
                                 copy=True)
    torch.cuda.synchronize()
    for a, c in zip(kp + list(kc), pp + list(pc)):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))
    changed = sum(int((a != c).sum()) for a, c in zip(kp, pools)
                  if a is not None)
    assert changed > 0


_BAD_KV_TABLE = """
import sys, torch
from repro_torch.kernels import kv_write
dev = torch.device("cuda")
pools = []
for _ in range(2):
    pools += [torch.zeros((6, 16, 2, 64), dtype=torch.uint8, device=dev),
              None, torch.zeros((6, 16), device=dev)]
table = torch.tensor([[2, 3], [4, int(sys.argv[1])]], dtype=torch.int32,
                     device=dev)
pos = torch.tensor([31, 20], dtype=torch.int32, device=dev)
k = torch.randn((2, 1, 2, 64), device=dev).to(torch.bfloat16)
try:
    kv_write.kv_write(k, k, *pools, table, pos)
    torch.cuda.synchronize()
except RuntimeError as err:
    print("launch failed:", err)
    sys.exit(3)
print("ran")
"""


@pytest.mark.parametrize("bad", [6, -1])
def test_gpu_kv_write_out_of_range_page_fails(cuda, bad):
    """A table entry outside [0, P) makes the KV write's launch fail with a
    CUDA error instead of writing outside the pool, as the paged-attention
    kernels do. In a child process: the error ends its CUDA context. A
    valid id (5) runs."""
    import os
    import pathlib
    import subprocess
    import sys
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    for page, want in ((5, 0), (bad, 3)):
        r = subprocess.run([sys.executable, "-c", _BAD_KV_TABLE, str(page)],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == want, (page, r.stdout, r.stderr[-2000:])


@pytest.mark.parametrize("scheme", ["faulty", "parity-zero", "secded72",
                                    "in-place"])
def test_gpu_campaign_routes_give_equal_grids(cuda, scheme):
    """A Table-2 column of a seeded ResNet18 (width 1/8, 32 x 32 input) on
    the kernel route and on the plain route, both on the card and fed the
    same per-cell seeds: equal grids cell for cell, equal clean values,
    and the kernel route launches the codec kernels."""
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    from repro_torch.training import cnn_experiments as ce
    params = cnn.init_resnet18(0, n_classes=4, scale=0.125, img_size=32,
                               device=cuda)
    _, tmpl = synthetic.image_batch(4, 1, 32, seed=0, step=0)
    before = build.COUNTS["ecc_encode"] + build.COUNTS["ecc_decode"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res = {route: ce.run_scheme_campaign(
            params, cnn.resnet18, tmpl, scheme, rates=(1e-3, 1e-2),
            trials=2, key=3, batch="scan", backend=route, device=cuda)
            for route in ("cuda", "torch")}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert res["cuda"].grid == res["torch"].grid
    assert res["cuda"].clean == res["torch"].clean
    assert (res["cuda"].platform, res["cuda"].backend) == ("cuda", "cuda")
    if scheme == "in-place":
        assert build.COUNTS["ecc_encode"] + build.COUNTS["ecc_decode"] > \
            before


def test_gpu_campaign_vmap_equals_scan_and_counts_flips(cuda):
    """On the card: the batched layout's DUE and corrected grids equal the
    one-cell ones, and each cell's counts equal the blocks its recomputed
    positions hit twice and an odd number of times."""
    from repro_torch.core import faults
    from repro_torch.protection import campaign
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = {"a": [torch.randn(512, 256, generator=gen, device=cuda),
               torch.randn(96, 3, generator=gen, device=cuda)]}
    enc = ProtectionPolicy(backend="cuda").encode_tree(w)
    rates = (1e-4, 1e-3)
    got = {}
    for batch in ("vmap", "scan"):
        for what in ("due", "corrected"):
            got[batch, what] = campaign.due_campaign(
                enc, rates=rates, trials=2, key=5, batch=batch, what=what,
                device=cuda).grid
    assert got["vmap", "due"] == got["scan", "due"]
    assert got["vmap", "corrected"] == got["scan", "corrected"]
    for r, rate in enumerate(rates):
        for t in range(2):
            g = campaign.cell_generator(5, r, t, cuda)
            odd = two = 0
            for pt in (enc["a"][0], enc["a"][1]):
                _, live = faults.inject_torch_rate(pt.enc, rate, g,
                                                   max(rates))
                _, hits = torch.unique(live // 64, return_counts=True)
                assert hits.numel() == 0 or int(hits.max()) <= 3
                odd += int((hits % 2 == 1).sum())
                two += int((hits == 2).sum())
            assert got["scan", "corrected"][r][t] == odd
            assert got["scan", "due"][r][t] == two


def test_gpu_cnn_forward_matches_cpu(cuda):
    """The three CNNs' forwards on the card (f32, TF32 off) against the
    CPU's on the same weights."""
    from repro_torch import tree
    from repro_torch.models import cnn
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, (init, fwd) in cnn.CNNS.items():
            p = init(1, n_classes=4, scale=0.25, img_size=64, device="cpu")
            x = torch.randn(2, 64, 64, 3, generator=torch.Generator()
                            .manual_seed(2))
            want = fwd(p, x)
            pc = tree.map_with_path(lambda _, t: t.to(cuda), p)
            got = fwd(pc, x.to(cuda)).cpu()
            assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), name
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("shape", [(4096, 11008), (2, 4096, 4096)])
def test_gpu_scrub_round_trip_at_full_width(cuda, shape):
    """A deepseek-7b-width leaf on the ``cuda`` route: scrubbing a clean
    leaf leaves every bit as it was; with single flips in every 97th block
    the scrub writes back the clean image (each flip counted once), as the
    plain route does; a DUE leaf is left as it was. The scrub launches the
    decode and encode kernels."""
    from repro_torch.serving import scrubber
    gen = torch.Generator(device=cuda).manual_seed(3)
    pt = ProtectionPolicy(backend="cuda").encode_leaf(
        torch.randn(shape, generator=gen, device=cuda), "in-place")
    clean = pt.enc.clone()
    counts = (build.COUNTS["ecc_decode"], build.COUNTS["ecc_encode"])
    same, cor, due = scrubber.scrub_leaf(pt, "cuda")
    assert (cor, due) == (0, 0) and torch.equal(same.enc, clean)
    assert build.COUNTS["ecc_decode"] > counts[0]
    assert build.COUNTS["ecc_encode"] > counts[1]
    dirty = pt.enc.clone()
    words = dirty.view(-1, 8).view(torch.int64)[:, 0]
    idx = torch.arange(0, words.numel(), 97, device=cuda)
    bits = torch.randint(0, 64, idx.shape, generator=gen, device=cuda)
    words[idx] ^= torch.ones_like(bits) << bits
    dpt = type(pt)(enc=dirty, checks=None, scale=pt.scale,
                   scheme_id="in-place", orig_shape=pt.orig_shape)
    healed, cor, due = scrubber.scrub_leaf(dpt, "cuda")
    plain, pcor, pdue = scrubber.scrub_leaf(dpt, "torch")
    assert (cor, due) == (pcor, pdue) == (idx.numel(), 0)
    assert torch.equal(healed.enc, clean) and torch.equal(plain.enc, clean)
    words[1] ^= 0b11                     # two flips in block 1: DUE
    kept, _, due = scrubber.scrub_leaf(dpt, "cuda")
    assert due == 1 and kept is dpt


@pytest.mark.parametrize("shape", [(4096, 11008), (30, 4096, 4096)])
def test_gpu_transcode_in_place_to_secded72_and_back(cuda, shape):
    """``transcode_leaf`` in place -> secded72 -> in place at a full-width
    leaf (with single flips, corrected on the way): byte-equal to the plain
    route at each hop and back at the clean image."""
    from repro_torch.protection.plan import transcode_leaf
    gen = torch.Generator(device=cuda).manual_seed(4)
    pt = ProtectionPolicy(backend="cuda").encode_leaf(
        torch.randn(shape, generator=gen, device=cuda), "in-place")
    clean = pt.enc.clone()
    words = pt.enc.view(-1, 8).view(torch.int64)[:, 0]
    words[::101] ^= 1 << 9
    hops = []
    for route in ("cuda", "torch"):
        mid, cor, due = transcode_leaf(pt, "secded72", backend=route)
        back, cor2, due2 = transcode_leaf(mid, "in-place", backend=route)
        assert (int(cor), int(due), int(cor2), int(due2)) == (
            words[::101].numel(), 0, 0, 0)
        hops.append((mid, back))
    (km, kb), (pm, pb) = hops
    assert torch.equal(km.enc, pm.enc) and torch.equal(km.checks, pm.checks)
    assert torch.equal(kb.enc, pb.enc) and torch.equal(kb.enc, clean)


# ---------------------------------------------------------------------------
# distribution: the sharded cells on a world-1 NCCL mesh (chip_smoke.py
# phase 21 at smoke size)
# ---------------------------------------------------------------------------


@pytest.fixture
def world1(cuda, tmp_path):
    """A world-1 NCCL process group (a FileStore, no network) and its (1, 1)
    ('data', 'model') mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_production_mesh(shape=(1, 1), device="cuda")
    finally:
        dist.destroy_process_group()


def _launches(fn):
    before = dict(build.COUNTS)
    out = fn()
    return out, {k: v - before[k] for k, v in build.COUNTS.items()}


def test_gpu_sharded_decode_cell_is_the_unsharded_step(world1):
    """deepseek-7b smoke, in-place plan on the kernel route, in-place fused
    paged KV with per-slot rows, weight flips: 3 lockstep steps of the
    sharded cell give the unsharded step's logits, flags, per-slot rows and
    pools bit for bit, through ecc_qmatmul, the paged kernel and
    kv_write."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.protection import policy as policy_mod
    cfg = configs.get_smoke("deepseek-7b")
    kvp = dataclasses.replace(kvcache.get_kv_policy("in-place-fused"),
                              per_slot_flags=True)
    plan, ab = specs.serving_plan(cfg, world1,
                                  policy=ProtectionPolicy(backend="cuda"))
    step, _, in_sh, out_sh = specs.decode_cell(
        cfg, ShapeConfig("d", 64, 4, "decode"), world1, plan=plan,
        abstract=ab, with_flags=True, kv_policy=kvp, backend="cuda")
    enc = lm.init_params(cfg, 0, device="cuda", leaf_fn=plan.encode_leaf)
    gen = torch.Generator(device="cuda").manual_seed(1)
    enc, _ = policy_mod.inject_tree_device(enc, 2e-3, gen)
    cache = kvcache.init_cache(cfg, 4, 64, kv_policy=kvp, device="cuda")
    ucache = tree.map_with_path(lambda _, t: t.clone(), cache)
    run = specs.sharded(step, world1, in_sh, out_sh)
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    seen = {}
    for t in range(3):
        pos = torch.full((4,), t, dtype=torch.int32, device="cuda")
        (lg, cache, fl), n = _launches(lambda: run(enc, cache, tok, pos))
        for k, v in n.items():
            seen[k] = seen.get(k, 0) + v
        ulg, ucache, ufl = step(enc, ucache, tok, pos)
        assert torch.equal(lg.to_local(), ulg)
        for k, v in ufl.items():
            assert torch.equal(fl[k].to_local(), v), k
        tok = ulg.argmax(-1).to(torch.int32)
    for k in ("k_pages", "v_pages", "k_scale", "v_scale", "kv_table"):
        assert torch.equal(cache[k].to_local(), ucache[k]), k
    assert all(seen[k] > 0 for k in ("ecc_qmatmul", "fused_page_attention",
                                     "kv_write")), seen


def test_gpu_sharded_train_cell_is_the_unsharded_step(world1):
    """minitron-4b smoke, 2 microbatches, (8, 32): one sharded QATT step on
    the kernel route gives the unsharded step's loss and masters bit for
    bit, its throttle through quantize_throttle's two passes."""
    from repro_torch import configs, tree
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.training import optim, train
    cfg = configs.get_smoke("minitron-4b").with_(microbatch=2)
    step, _, in_sh, out_sh = specs.train_cell(
        cfg, ShapeConfig("t", 32, 8, "train"), world1, chunk=16,
        microbatch=2, backend="cuda")
    run = specs.sharded(step, world1, in_sh, out_sh)
    params = lm.init_params(cfg, 0, device="cuda")
    uparams = tree.map_with_path(lambda _, t: t.clone(), params)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab, (8, 32), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "targets")}
    (p2, _, loss), n = _launches(lambda: run(params, optim.sgd_init(params),
                                             batch))
    assert n["quantize_throttle"] > 0
    up, _, uloss = train.make_train_step(cfg, chunk=16, backend="cuda")(
        uparams, optim.sgd_init(uparams), batch)
    assert torch.equal(loss.to_local(), uloss)
    for path, w in tree.leaves_with_path(sh.local_tree(p2)):
        assert torch.equal(w, tree.get_path(up, path)), path


def test_gpu_quantize_throttle_two_passes_equal_one_call(cuda):
    """The sharded throttle's entry (absmax pass, the caller's all-reduce,
    quantize pass) is the one-call launcher bit for bit (identity reduce)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((4096, 11008), generator=gen, device=cuda)
    a, b = w.clone(), w.clone()
    qa, sa = quant_throttle.quantize_throttle(a, write_back=True)
    qb, sb = quant_throttle.quantize_throttle(b, write_back=True,
                                              amax_reduce=lambda x: x)
    assert torch.equal(a, b) and torch.equal(qa, qb) and torch.equal(sa, sb)


def test_gpu_compressed_psum_is_compress_at_world_one(world1):
    import torch.distributed as dist

    from repro_torch.training import compress
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn(1 << 20, generator=gen, device="cuda")
    r = torch.randn(1 << 20, generator=gen, device="cuda") * 1e-3
    mean, nr, q = compress.compressed_psum(g, r, dist.group.WORLD,
                                           with_payload=True)
    q0, s0, r0 = compress.compress(g, r)
    assert torch.equal(q, q0) and torch.equal(nr, r0)
    assert torch.equal(mean, compress.decompress(q0, s0))


def test_gpu_sharded_restore_equals_restore(world1, tmp_path):
    from repro_torch import configs, tree
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import lm
    from repro_torch.training import checkpoint, optim
    cfg = configs.get_smoke("deepseek-7b")
    params = lm.init_params(cfg, 0, device="cuda")
    state = (params, optim.sgd_init(params))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, state, step=1, protected=True, device="cuda")
    pspec = sh.param_specs(lm.param_shapes(cfg))
    got, _ = checkpoint.restore(path, state, device="cuda",
                                shardings=(pspec, optim.SgdState(pspec)),
                                mesh=world1)
    whole, _ = checkpoint.restore(path, state, device="cuda")
    for part_got, part_whole in zip(got, whole):
        for p, w in tree.leaves_with_path(part_whole):
            assert torch.equal(tree.get_path(part_got, p).to_local(), w), p

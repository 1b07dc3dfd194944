"""The launch plan of the port's ``ecc_qmatmul`` kernel, checked on the CPU.

``ecc_qmatmul.plan_launch(m, n, k, a_dtype)`` is a pure function of the
shapes and dtype that picks the kernel's regime (split-K decode tiles for
M <= ``SMALL_M``, 128-row prefill tiles above, CUDA-core FMAs for f32), its
CTA tile and its K splits. The kernel counts a weight block's (corrected,
DUE) flags in the CTAs of M tile 0 only, over each split's K range, so the
flags stay exact only if those ranges partition ``[0, K)`` in whole 64-row
tiles and every (K tile, column strip) is walked by exactly one counting
CTA. Shapes: every deepseek-7b projection and the head at the decode,
burst, route-check, calibration, int8-prefill and prefill batches, and
ragged K, N and M.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.kernels import ecc_qmatmul as Q


def _deepseek_weights():
    cfg = get("deepseek-7b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    return [(d, d), (d, f), (f, d), (d, v)]


DECODE_M = (1, 4, 8)                 # decode batch, burst slots
PREFILL_M = (1000, 1024, 2048, 8192)  # routes, calibration, int8, prefill
RAGGED = [(37, 1000, 1037), (33, 1152, 1024), (300, 72, 136), (5, 8, 64),
          (17, 1040, 65), (129, 136, 4097), (16, 8, 1), (2, 520, 200)]
CASES = [(m, n, k) for k, n in _deepseek_weights()
         for m in DECODE_M + PREFILL_M] + RAGGED
DTYPES = [torch.bfloat16, torch.int8, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,n,k", CASES)
def test_plan_k_ranges_partition_whole_tiles(m, n, k, dtype):
    plan = Q.plan_launch(m, n, k, dtype)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits >= 1
    assert plan.splits <= max(1, plan.k_tiles)
    assert plan.k_tiles * Q.TILE_K >= k > (plan.k_tiles - 1) * Q.TILE_K
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 % Q.TILE_K == 0 and k0 < k1
        assert k1 % Q.TILE_K == 0 or k1 == k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,n,k", CASES)
def test_plan_counts_each_block_once(m, n, k, dtype):
    """The counting CTAs (M tile 0, every column strip and split) walk each
    (K tile, column strip) of the weight exactly once, and the CTA tiles
    cover the output."""
    plan = Q.plan_launch(m, n, k, dtype)
    assert plan.m_tiles * plan.bm >= m > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= n > (plan.n_tiles - 1) * plan.bn
    cover = np.zeros((plan.k_tiles, plan.n_tiles), np.int64)
    for s in range(plan.splits):
        k0, k1 = plan.k_ranges(k)[s]
        cover[k0 // Q.TILE_K:-(-k1 // Q.TILE_K)] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=str)
@pytest.mark.parametrize("m", DECODE_M)
@pytest.mark.parametrize("kn", _deepseek_weights())
def test_plan_decode_shapes_fill_the_card(kn, m, dtype):
    """At every deepseek-7b decode shape the split-K grid holds at least
    two CTAs per SM of the H100 (264)."""
    k, n = kn
    plan = Q.plan_launch(m, n, k, dtype)
    assert plan.regime == "small"
    assert plan.ctas >= Q.MIN_CTAS == 264


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=str)
def test_plan_regime_switches_at_the_threshold(dtype):
    small = Q.plan_launch(Q.SMALL_M, 4096, 4096, dtype)
    large = Q.plan_launch(Q.SMALL_M + 1, 4096, 4096, dtype)
    assert (small.regime, small.bm, small.m_tiles) == ("small", 32, 1)
    assert (large.regime, large.bm) == ("large", 128)
    assert Q.plan_launch(Q.SMALL_BM16, 4096, 4096, dtype).bm == 16
    assert Q.plan_launch(Q.SMALL_BM16 + 1, 4096, 4096, dtype).bm == 32
    # once the M x N tiles fill the card, the prefill does not split K
    assert Q.plan_launch(8192, 4096, 4096, dtype).splits == 1


@pytest.mark.parametrize("m", [1, 4, 32, 33, 8192])
def test_plan_f32_keeps_the_fma_route(m):
    plan = Q.plan_launch(m, 4096, 4096, torch.float32)
    assert plan.regime == "fma" and plan.splits == 1 and plan.bn == 64


def test_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="f32, bf16 or int8"):
        Q.plan_launch(4, 64, 64, torch.float16)

"""Fused in-place-ECC decode + matmul: float, int8 and requantize paths,
with ABFT checksums, activation clamps and an injected accumulator fault.

Replaces ``repro/kernels/ecc_qmatmul.py::ecc_qmatmul``
(``csrc/ecc_qmatmul.cu``): ``a (M, K) @ decode(w_enc (K, N))`` with the
decode inside the matmul tile and (corrected, DUE) counts over every
weight block. Three activation paths, as the reference's:

* float ``a`` (f32 / bf16, needs ``w_scale``) -> (M, N) f32: the decoded
  tile is dequantized, rounded to ``a``'s type and accumulated in f32;
* int8 ``a`` -> the exact (M, N) int32 accumulator (``w_scale`` unused);
* int8 ``a`` + ``a_scale`` (scalar, ``(M,)`` or ``(M, 1)``; needs
  ``w_scale``) -> the requantize epilogue ``float(acc [+ bias]) *
  (a_scale * w_scale)`` cast to ``out_dtype`` (bf16 by default).

``with_abft`` checks the accumulator's row sums against ``a @ rowsum(w)``
and its column sums against ``colsum(a) @ w`` (exact in int32 modular
arithmetic on the int paths, within ``ref.ABFT_RTOL`` of an |a|·|w| scale
on the float path); ``clamp`` clips the f32 epilogue output to ±clamp and
counts the hits per row; ``fault_bits`` XORs a pattern into accumulator
element (0, 0) after the full-K accumulation, before every check. The
counts are those of the reference's XLA route (``ref.abft_counts``: each
row checked over all of N, each column over all of M).

The kernel runs one of three regimes, chosen by :func:`plan_launch`, a
pure function of ``(M, N, K, a.dtype)``:

* ``"small"`` (bf16 / int8, M <= :data:`SMALL_M`: decode and burst
  steps), bound by reading the encoded weight once (K*N bytes): 16- (M <=
  16) or 32-row x 128-column output tiles, split over K into at least
  :data:`MIN_CTAS` CTAs (two per SM of the H100), the split count chosen
  to balance the busiest SM's K tiles;
* ``"large"`` (bf16 / int8, M > :data:`SMALL_M`: prefill, calibration,
  int8 prefill), bound by its 2MKN operations: 128 x 128 output tiles on
  ``mma.sync`` (bf16 -> f32, s8 -> s32), split over K by the same rule
  (one split once the tiles fill the card);
* ``"fma"`` (f32 activations, any M): CUDA-core FMAs (no exact f32
  tensor-core path; TF32 stays off), no split.

Both tensor-core regimes decode each weight tile once per CTA in shared
memory (the syndrome test on binary ``mma.sync`` AND-popcounts, the exact
decode only for flagged blocks), count flags only in the CTAs of the
first M tile and split K into whole 64-row tiles, so the flags never
depend on the plan. Split partials go to an f32 / int32 workspace that a
finish pass adds in split order: a repeated launch is bit-equal, and the
int paths stay byte-equal to the plain version.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import ecc, quant

from . import build, ref

_OUT_KINDS = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2,
              torch.float16: 3}
_A_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the launch plan (csrc/ecc_qmatmul.cu; its Regime enum and tile sizes)
SMALL_M = 32          # the largest M of the split-K decode regime
TILE_K = 64           # weight rows per K tile; split ranges are whole tiles
SMS = 132             # the H100's streaming multiprocessors
MIN_CTAS = 2 * SMS    # the least grid of the tensor-core regimes
CTA_START_TILES = 1   # a CTA's pipeline fill and epilogue, in K-tile times
_TILES = {"small": (32, 128), "large": (128, 128)}   # (BM, BN)
SMALL_BM16 = 16       # M <= 16 takes 16-row tiles (four CTAs an SM)
_REGIMES = {"fma": 0, "small": 1, "large": 2}
_FMA_BN = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the kernel: its regime, CTA tile (``bm`` rows x ``bn``
    columns), grid (``m_tiles`` x ``n_tiles`` x ``splits``) and the K tiles
    each split walks. Only the CTAs of M tile 0 count flags."""
    regime: str
    bm: int
    bn: int
    m_tiles: int
    n_tiles: int
    k_tiles: int
    splits: int

    @property
    def ctas(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def k_ranges(self, k: int) -> list:
        """``[(k0, k1)]`` per split, as the kernel computes them: split
        ``s`` walks tiles ``s*T//S`` to ``(s+1)*T//S`` of ``T`` 64-row
        tiles (the last one cut at ``k``)."""
        t, s = self.k_tiles, self.splits
        return [(TILE_K * (i * t // s), min(k, TILE_K * ((i + 1) * t // s)))
                for i in range(s)]


def _splits(tiles: int, k_tiles: int) -> int:
    """K splits for ``tiles`` output tiles: at least :data:`MIN_CTAS` CTAs
    (where K has the tiles), then the fewest splits that minimize the
    busiest SM's work, ``ceil(CTAs / SMS)`` CTAs of ``ceil(k_tiles /
    splits) + CTA_START_TILES`` tile times each (the decode makes every
    CTA bound by its SM's integer throughput)."""
    lo = max(1, min(k_tiles, -(-MIN_CTAS // tiles)))
    return min(range(lo, max(lo, k_tiles) + 1), key=lambda s: (
        -(-tiles * s // SMS) * (-(-k_tiles // s) + CTA_START_TILES), s))


@functools.lru_cache(maxsize=4096)
def plan_launch(m: int, n: int, k: int, a_dtype) -> Plan:
    """The kernel's launch plan for ``a (m, k) @ w (k, n)`` with ``a`` of
    ``a_dtype``: a pure function of the shapes and dtype."""
    if a_dtype not in _A_KINDS:
        raise ValueError(f"ecc_qmatmul kernel takes f32, bf16 or int8, got "
                         f"{a_dtype}")
    k_tiles = -(-k // TILE_K)
    if a_dtype == torch.float32:
        bm = 4 if m <= 4 else 8 if m <= 8 else 16 if m <= 16 else 32
        return Plan("fma", bm, _FMA_BN, -(-m // bm), -(-n // _FMA_BN),
                    k_tiles, 1)
    regime = "small" if m <= SMALL_M else "large"
    bm, bn = _TILES[regime]
    if m <= SMALL_BM16:
        bm = SMALL_BM16
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    return Plan(regime, bm, bn, m_tiles, n_tiles, k_tiles,
                _splits(m_tiles * n_tiles, k_tiles))


def _path(a, w_scale, a_scale, bias, clamp) -> str:
    """The reference's path choice and argument guards (ecc_qmatmul.py:
    312-332) -> "float" | "int8" | "requant"."""
    float_path = a.dtype.is_floating_point
    if float_path and w_scale is None:
        raise ValueError("float activations need w_scale for the in-tile "
                         "dequantization")
    if float_path and a_scale is not None:
        raise ValueError("a_scale is the int8 requantize epilogue; float "
                         "activations carry their own scale")
    requant = not float_path and a_scale is not None
    if requant and w_scale is None:
        raise ValueError("the requantize epilogue needs w_scale")
    if bias is not None and not requant:
        raise ValueError("bias is only fused by the requantize epilogue")
    path = "float" if float_path else ("requant" if requant else "int8")
    if clamp is not None and path == "int8":
        raise ValueError("clamp guards the f32 epilogue output; the raw "
                         "int8-accumulator path has none")
    return path


def _f32(x, device) -> torch.Tensor:
    """A scale or bound as an f32 tensor on ``device``; a Python number is
    filled on the device (no host copy, no sync)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _out_dtype(path, out_dtype):
    if path == "float":
        return torch.float32
    if path == "int8":
        return torch.int32
    return torch.bfloat16 if out_dtype is None else out_dtype


def _returns(out, flags, rows, col_mm, with_flags, track):
    outs = (out,)
    if with_flags:
        outs += (flags,)
    if track:
        outs += ((rows, col_mm),)
    return outs if len(outs) > 1 else out


def ecc_qmatmul_plain(a: torch.Tensor, w_enc: torch.Tensor, w_scale=None, *,
                      a_scale=None, bias=None, out_dtype=None,
                      with_flags: bool = False, with_abft: bool = False,
                      clamp=None, fault_bits: int = 0):
    """Plain PyTorch version, in the reference's order: decode; the f32
    dot of ``a`` and the dequantized weight rounded to ``a``'s type (float
    path) or ``quant.int8_acc`` (int paths); ``fault_bits`` into element
    (0, 0); ``ref.abft_counts``; ``+ bias`` in int32 and ``* (a_scale *
    w_scale)`` in f32; ``ref.clamp_counts``; the cast to the output type.

    Returns ``out``, then ``flags (2,) int32`` (#single-corrected,
    #double-detected blocks) with ``with_flags``, then ``(rows (M, 2)
    int32, col_mm int32 ())`` when ABFT or the clamp is on: per row
    (checksum mismatches, clamp hits) and the column-check mismatches."""
    path = _path(a, w_scale, a_scale, bias, clamp)
    k, n = w_enc.shape
    m = a.shape[0]
    dev = a.device
    dec, single, double = ecc.decode64(w_enc.reshape(k, n // 8, 8))
    q = dec.reshape(k, n).view(torch.int8)
    if path == "float":
        w = (q.to(torch.float32) * _f32(w_scale, dev)).to(a.dtype)
        acc = a.to(torch.float32) @ w.to(torch.float32)
    else:
        w = q
        acc = quant.int8_acc(a, q)
    if fault_bits and m and n:
        bits = acc.view(torch.int32) if path == "float" else acc
        bits[0, 0] ^= int(fault_bits)
    track = with_abft or clamp is not None
    rows = torch.zeros((m, 2), dtype=torch.int32, device=dev)
    col_mm = torch.zeros((), dtype=torch.int32, device=dev)
    if with_abft:
        row_bad, col_bad = ref.abft_counts(a, w, acc)
        rows[:, 0] = row_bad
        col_mm = col_bad.sum(dtype=torch.int32)
    if path == "int8":
        out = acc
    else:
        res = acc
        if path == "requant":
            if bias is not None:
                acc = acc + bias.to(device=dev, dtype=torch.int32)
            s = _f32(a_scale, dev).reshape(-1, 1) * _f32(w_scale, dev)
            res = acc.to(torch.float32) * s
        if clamp is not None:
            res, rows[:, 1] = ref.clamp_counts(res, clamp)
        out = res.to(_out_dtype(path, out_dtype))
    flags = torch.stack([single.sum(), double.sum()]).to(torch.int32)
    return _returns(out, flags, rows, col_mm, with_flags, track)


def ecc_qmatmul(a: torch.Tensor, w_enc: torch.Tensor, w_scale=None, *,
                a_scale=None, bias=None, out_dtype=None,
                with_flags: bool = False, with_abft: bool = False,
                clamp=None, fault_bits: int = 0):
    """Kernel wrapper of :func:`ecc_qmatmul_plain`, same arguments and
    returns. A CUDA tensor launches the kernel (or raises); a CPU tensor
    runs the plain version."""
    if a.ndim != 2 or w_enc.ndim != 2 or a.shape[1] != w_enc.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(w_enc.shape)}")
    m, k = a.shape
    n = w_enc.shape[1]
    if w_enc.dtype != torch.uint8 or n % 8:
        raise ValueError("w_enc must be uint8 with N % 8 == 0")
    if not 0 <= int(fault_bits) < 2 ** 31:
        raise ValueError("fault_bits must be a non-negative int32 pattern")
    path = _path(a, w_scale, a_scale, bias, clamp)
    out_dt = _out_dtype(path, out_dtype)
    if out_dt not in _OUT_KINDS:
        raise ValueError(f"out_dtype {out_dt}; one of {list(_OUT_KINDS)}")
    kw = dict(a_scale=a_scale, bias=bias, out_dtype=out_dtype,
              with_flags=with_flags, with_abft=with_abft, clamp=clamp,
              fault_bits=fault_bits)
    if not a.is_cuda:
        return ecc_qmatmul_plain(a, w_enc, w_scale, **kw)
    if not (w_enc.is_cuda and w_enc.device == a.device):
        raise ValueError("a and w_enc must be on the same CUDA device")
    plan = plan_launch(m, n, k, a.dtype)
    if max(m, n, k) >= 2 ** 31 or -(-m // 32) > 65535 or \
            plan.m_tiles > 65535:
        raise ValueError("ecc_qmatmul: dimensions exceed the kernel's int32 "
                         "indexing or its grid")
    dev = a.device
    a = a.contiguous()
    w_enc = w_enc.contiguous()
    if w_enc.data_ptr() % 8:
        raise ValueError("w_enc must be 8-byte aligned")
    ws = _f32(1.0 if w_scale is None else w_scale, dev).reshape(1)
    asc, stride = None, 0
    if path == "requant":
        asc = _f32(a_scale, dev).reshape(-1).contiguous()
        if asc.numel() not in (1, m):
            raise ValueError(f"a_scale must be a scalar, (M,) or (M, 1); got "
                             f"{asc.numel()} values for M = {m}")
        stride = int(asc.numel() == m and m != 1)
    bias_t = None
    if bias is not None:
        bias_t = bias.to(device=dev, dtype=torch.int32).reshape(-1)
        if bias_t.numel() != n:
            raise ValueError(f"bias must be (N,) = ({n},)")
        bias_t = bias_t.contiguous()
    clamp_t = None if clamp is None else _f32(clamp, dev).reshape(1)
    track = with_abft or clamp is not None
    # the finish pass (split sum, fault, ABFT sums, epilogue) reads the
    # raw accumulators from a workspace; without it the kernel writes out.
    # On the tensor-core regimes it also sums per-CTA flag partials, so
    # the counts need zeroing only for the guarded rows or the atomics.
    finish = (plan.splits > 1 or path == "requant" or with_abft
              or clamp is not None or bool(fault_bits))
    partials = finish and plan.regime != "fma"
    out = torch.empty((m, n), dtype=out_dt, device=dev)
    zeroed = track or not (partials and m and n)
    counts = (torch.zeros if zeroed else torch.empty)(
        2 * m + 3, dtype=torch.int32, device=dev)
    flags, rows, col_mm = (counts[:2], counts[2:2 * m + 2].view(m, 2),
                           counts[-1])
    rbuf = cbuf = None
    if with_abft:  # 2 sums of int32 (as unsigned) or 3 of f64 per row/col
        sums = torch.zeros(3 * (m + n), dtype=torch.float64, device=dev)
        rbuf, cbuf = sums[:3 * m], sums[3 * m:]

    def ptr(t):
        return None if t is None else t.data_ptr()

    part = flag_part = None
    if finish and m and n:
        part = torch.empty(plan.splits * m * n, device=dev, dtype=(
            torch.float32 if path == "float" else torch.int32))
    if partials and m and n:
        flag_part = torch.empty(2 * plan.n_tiles * plan.splits,
                                dtype=torch.int32, device=dev)
    if m and n:
        fn = build.entry("ecc_qmatmul_launch")
        build.check(fn(a.data_ptr(), _A_KINDS[a.dtype], w_enc.data_ptr(),
                       ws.data_ptr(), ptr(asc), stride, ptr(bias_t),
                       ptr(clamp_t), out.data_ptr(), _OUT_KINDS[out_dt],
                       flags.data_ptr(), rows.data_ptr(), ptr(rbuf),
                       ptr(cbuf), col_mm.data_ptr(), m, n, k,
                       int(fault_bits), _REGIMES[plan.regime], plan.splits,
                       ptr(part), ptr(flag_part), build.stream_ptr(dev)),
                    "ecc_qmatmul")
        build.COUNTS["ecc_qmatmul"] += 1
    return _returns(out, flags, rows, col_mm, with_flags, track)

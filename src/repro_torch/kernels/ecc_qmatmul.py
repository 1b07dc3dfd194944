"""Fused in-place-ECC decode + matmul: float, int8 and requantize paths,
with ABFT checksums, activation clamps and an injected accumulator fault.

Replaces ``repro/kernels/ecc_qmatmul.py::ecc_qmatmul``
(``csrc/ecc_qmatmul.cu``): ``a (M, K) @ decode(w_enc (K, N))`` with the
decode inside the matmul tile and (corrected, DUE) counts over every
weight block. At decode batch it is bound by reading the encoded weight
once (K*N bytes). Three activation paths, as the reference's:

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
"""
from __future__ import annotations

import torch

from repro_torch.core import ecc, quant

from . import build, ref

_OUT_KINDS = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2,
              torch.float16: 3}
_A_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
    if a.dtype not in _A_KINDS:
        raise ValueError(f"ecc_qmatmul kernel takes f32, bf16 or int8, got "
                         f"{a.dtype}")
    if not (w_enc.is_cuda and w_enc.device == a.device):
        raise ValueError("a and w_enc must be on the same CUDA device")
    mc = 4 if m <= 4 else 8 if m <= 8 else 16 if m <= 16 else 32
    if max(m, n, k) >= 2 ** 31 or -(-m // mc) > 65535:
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
    out = torch.empty((m, n), dtype=out_dt, device=dev)
    # the zeroed outputs and scratch in one allocation each (one memset)
    counts = torch.zeros(2 * m + 3, dtype=torch.int32, device=dev)
    flags, rows, col_mm = (counts[:2], counts[2:2 * m + 2].view(m, 2),
                           counts[-1])
    rbuf = cbuf = None
    if with_abft:  # 2 sums of int32 (as unsigned) or 3 of f64 per row/col
        sums = torch.zeros(3 * (m + n), dtype=torch.float64, device=dev)
        rbuf, cbuf = sums[:3 * m], sums[3 * m:]

    def ptr(t):
        return None if t is None else t.data_ptr()

    if m and n:
        fn = build.entry("ecc_qmatmul_launch")
        build.check(fn(a.data_ptr(), _A_KINDS[a.dtype], w_enc.data_ptr(),
                       ws.data_ptr(), ptr(asc), stride, ptr(bias_t),
                       ptr(clamp_t), out.data_ptr(), _OUT_KINDS[out_dt],
                       flags.data_ptr(), rows.data_ptr(), ptr(rbuf),
                       ptr(cbuf), col_mm.data_ptr(), m, n, k,
                       int(fault_bits), build.stream_ptr(dev)),
                    "ecc_qmatmul")
        build.COUNTS["ecc_qmatmul"] += 1
    return _returns(out, flags, rows, col_mm, with_flags, track)

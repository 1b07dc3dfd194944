"""Fused quantize + WOT throttle of an f32 weight (the QATT inner step),
optionally writing the moved values back into the f32 masters in place.

Replaces ``repro/kernels/quant_throttle.py::quantize_throttle``
(``csrc/quant_throttle.cu``: a global absmax pass and a quantize-and-clamp
pass, two launches per call; bound by device memory: 9 bytes per value for
the deploy's q, about 8 for the train step's in-place write-back, which
also computes the reference's ``core/wot.py::throttle_tensor``).
"""
from __future__ import annotations

import torch

from repro_torch.core import quant, wot

from . import build


def _scale(w: torch.Tensor, amax_reduce):
    """``quant.compute_scale(w)``, its absmax first joined across the shards
    by ``amax_reduce`` when one is given."""
    if amax_reduce is None:
        return quant.compute_scale(w)
    amax = amax_reduce(w.abs().amax())
    qmax = torch.full((), quant.QMAX, dtype=amax.dtype, device=amax.device)
    return amax.clamp_min(1e-12) / qmax


def quantize_throttle_plain(w: torch.Tensor, *, write_back: bool = False,
                            with_q: bool = True, amax_reduce=None):
    """Plain version of :func:`quantize_throttle` (same contract):
    ``quant.quantize`` then ``wot.throttle_q``, exactly; the write-back is
    the reference's ``where(q == qt, w, qt * scale)`` copied into ``w``."""
    if not write_back:
        q, scale = quant.quantize(w, scale=_scale(w, amax_reduce))
        return wot.throttle_q(q.reshape(-1)).reshape(w.shape), scale
    n = w.numel()
    qt, scale = quantize_throttle_plain(wot.as_blocks(w),
                                        amax_reduce=amax_reduce)
    qt = qt.reshape(-1)[:n].reshape(w.shape)
    q = (w / scale).round_().clamp_(-quant.QMAX, quant.QMAX)
    w.copy_(torch.where(q == qt, w, qt.to(w.dtype) * scale))
    return (qt if with_q else None), scale


def quantize_throttle(w: torch.Tensor, *, write_back: bool = False,
                      with_q: bool = True, amax_reduce=None):
    """Quantize ``w`` per tensor and WOT-clamp positions 0..6 of every
    8-value block -> ``(q int8 (w.shape), scale f32 ())``.

    Without ``write_back`` ``w`` is (nblk >= 1, 8) f32 blocks and is not
    modified. With ``write_back`` ``w`` is any contiguous f32 tensor of at
    least one value (a ragged last block counts as zero-padded, which
    changes neither the scale nor any real value's q) and every value the
    clamp moved is set to ``qt * scale`` IN PLACE; ``with_q=False`` then
    skips q (returned as None). One call is two launches and counts once.

    ``amax_reduce`` (a local shard of a sharded tensor): a function that
    joins the f32 absmax across the shards (an all-reduce MAX), called
    between the two passes, so the scale is the whole tensor's."""
    if write_back:
        if w.dtype != torch.float32 or w.numel() == 0:
            raise ValueError(f"expected a float32 tensor of >= 1 value, got "
                             f"{tuple(w.shape)} {w.dtype}")
    elif w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != 8 or \
            w.shape[0] == 0:
        raise ValueError(f"expected (nblk >= 1, 8) float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if not w.is_cuda:
        return quantize_throttle_plain(w, write_back=write_back,
                                       with_q=with_q, amax_reduce=amax_reduce)
    if write_back and not w.is_contiguous():
        raise ValueError("the write-back updates w in place: it must be "
                         "contiguous")
    w = w.contiguous()
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned")
    dev = w.device
    q = torch.empty(w.shape, dtype=torch.int8, device=dev) \
        if with_q or not write_back else None
    amax = torch.empty((), dtype=torch.int32, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev)
    args = (w.data_ptr(), None if q is None else q.data_ptr(),
            amax.data_ptr(), scale.data_ptr(), w.numel(), int(write_back))
    if amax_reduce is None:
        fn = build.entry("quantize_throttle_launch")
        build.check(fn(*args, build.stream_ptr(dev)), "quantize_throttle")
    else:   # pass 1, the global absmax, pass 2
        fn = build.entry("quantize_throttle_pass_launch")
        build.check(fn(*args, 1, build.stream_ptr(dev)), "quantize_throttle")
        amax.copy_(amax_reduce(amax.view(torch.float32)).view(torch.int32))
        build.check(fn(*args, 2, build.stream_ptr(dev)), "quantize_throttle")
    build.COUNTS["quantize_throttle"] += 1
    return q, scale

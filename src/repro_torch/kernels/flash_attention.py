"""Causal flash attention (online softmax) for the prefill.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (its
``_kernel`` and the ``_norm_kernel`` second pass; ``csrc/flash_attention.cu``).
The prefill attends over the decoded pages through it on the ``cuda``
route, so no score matrix reaches device memory. One CTA per (B·H, query
tile of 64 rows) walks the key tiles of 64 up to the causal diagonal
keeping the running (m, l, o) state on chip and normalizes at the end —
one kernel computing what the TPU's two passes compute. At prefill shapes
it is bound by its operations (2·B·H·S²·D for the causal triangle), not by
its bytes.

Routes by dtype: bf16 runs on the tensor cores (``mma.sync`` m16n8k16,
FlashAttention-2 layout: a warp per 16 query rows, K and V bf16 in a
two-stage ``cp.async`` ring, P rounded to bf16 in registers as the plain
version's ``p.to(v.dtype)``); f32 runs on CUDA-core FMAs (no exact f32
tensor-core path; TF32 stays off). Both take head dims
:data:`KERNEL_HEAD_DIMS` and the plain version's arithmetic per 64-key
tile; only the order of the f32 sums differs.

Unlike the reference, which asserts that S divides into tiles, a ragged S
is masked: keys past S are causally invisible to every real query, and
query rows past S are not written.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

NEG_INF = -1e30
# the kernel's tiles: query rows per CTA and keys per online-softmax step
KERNEL_BQ = KERNEL_BK = 64
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_plain(q, k, v, *, bq: int = KERNEL_BQ,
                          bk: int = KERNEL_BK):
    """Plain PyTorch version with the reference kernel's op order.

    q,k,v: (B, H, S, D) -> (B, H, S, D) in q's dtype, causal. Per key tile
    of ``bk`` keys (``bk`` clamped to S; a ragged tail is zero-padded and
    masked): scores from the inputs' values with f32 accumulation (not
    rounded), times ``1/sqrt(D)``, masked with -1e30; ``m_new = max(m,
    rowmax)``, ``p = exp(s - m_new)``, ``alpha = exp(m - m_new)``,
    ``l = l*alpha + sum p``, ``o = o*alpha + p.astype(v.dtype) @ v`` in f32;
    finally ``o / max(l, 1e-30)`` in q's dtype. Query tiles do not change
    the arithmetic (a tile past the diagonal only multiplies by 1 and adds
    0), so ``bq`` only has to be positive.
    """
    if bq < 1 or bk < 1:
        raise ValueError(f"tile sizes must be positive, got {(bq, bk)}")
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must match")
    bk = min(bk, s)
    pad = (-s) % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    scale = float(np.float32(1.0 / np.sqrt(d)))
    qf = q.to(torch.float32)
    qpos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for j in range((s + pad) // bk):
        kj = k[:, :, j * bk:(j + 1) * bk]
        vj = v[:, :, j * bk:(j + 1) * bk]
        sc = qf @ kj.to(torch.float32).transpose(-1, -2) * scale
        kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
        sc = torch.where(qpos >= kpos, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p.to(v.dtype).to(torch.float32) @ \
            vj.to(torch.float32)
        m = m_new
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention(q, k, v, *, bq: int = KERNEL_BQ, bk: int = KERNEL_BK):
    """Kernel wrapper of :func:`flash_attention_plain` (same contract). GQA
    callers broadcast KV heads beforehand. The kernel's tiles are fixed at
    64 x 64 and its head dims at :data:`KERNEL_HEAD_DIMS`; it raises on
    others."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, bq=bq, bk=bk)
    if (bq, bk) != (KERNEL_BQ, KERNEL_BK):
        raise ValueError(f"flash_attention kernel tiles are "
                         f"{(KERNEL_BQ, KERNEL_BK)}, got {(bq, bk)}")
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must match")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes f32 or bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
    if b * h > 65535 or b * h * s * d >= 2 ** 62:
        raise ValueError("flash_attention: the kernel takes at most 65535 "
                         "batch-heads")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel():
        fn = build.entry("flash_attention_launch")
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b * h, s, d,
                       float(np.float32(1.0 / np.sqrt(d))),
                       int(q.dtype == torch.bfloat16),
                       build.stream_ptr(q.device)), "flash_attention")
        build.COUNTS["flash_attention"] += 1
    return out

"""Causal flash attention (online softmax) for the prefill, optionally
over a sliding window.

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
:data:`KERNEL_HEAD_DIMS` (queries, keys and values alike) and the
(query-key, value) head splits :data:`KERNEL_HEAD_SPLITS` (MLA's 192/128:
128 nope + 64 rope dims per query and key, 128 per value; the scale is
``1/sqrt(192)``), and the plain version's arithmetic per 64-key tile; only
the order of the f32 sums differs.

Unlike the reference, which asserts that S divides into tiles, a ragged S
is masked: keys past S are causally invisible to every real query, and
query rows past S are not written.

``window > 0`` (the hybrid family's local attention; the reference's
models compute it with ``chunked_causal_attention(window=)`` and never
reach its flash kernel) lets query q see key j iff ``0 <= q - j <
window``. A query tile then starts at the first key tile that holds a
visible key for its first row, so the work is about S * window, not S^2 /
2. A row whose first visible key lies past that tile sees a wholly masked
tile first: it accumulates ``p = exp(-1e30 - (-1e30)) = 1`` there, and the
next tile's ``alpha = exp(-1e30 - m)`` is exactly 0 in f32, which wipes
it. The plain version walks the same tiles per query tile, so both take
that path on the same rows. ``window = 0`` is the causal kernel,
unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

NEG_INF = -1e30
# the kernel's tiles: query rows per CTA and keys per online-softmax step
KERNEL_BQ = KERNEL_BK = 64
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
# (query-key head dim, value head dim) pairs with DQK != DV
KERNEL_HEAD_SPLITS = ((192, 128),)


def _check_shapes(q, k, v):
    """q and k (B, H, S, D), v (B, H, S, Dv)."""
    if k.shape != q.shape or v.shape[:-1] != q.shape[:-1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must match (v may have its own "
                         f"head dim)")


def flash_attention_plain(q, k, v, *, bq: int = KERNEL_BQ,
                          bk: int = KERNEL_BK, window: int = 0):
    """Plain PyTorch version with the reference kernel's op order.

    q,k: (B, H, S, D), v: (B, H, S, Dv) -> (B, H, S, Dv) in q's dtype,
    causal, and with ``window > 0`` blind to keys ``window`` or more
    positions back (see the module docstring; ``window = 0`` means no
    window). Each query tile of
    ``bq`` rows (zero-padded past S) walks the key tiles of ``bk`` keys
    (``bk`` clamped to S; a ragged tail is zero-padded and masked) as the
    kernel walks them: from the tile holding its first row's oldest visible
    key (tile 0 without a window) to its last row's diagonal, every query
    tile at once, step r visiting tile ``lo + r``. Per key tile: scores
    from the inputs' values with f32 accumulation (not rounded), times
    ``1/sqrt(D)``, masked with -1e30; ``m_new = max(m, rowmax)``, ``p =
    exp(s - m_new)``, ``alpha = exp(m - m_new)``, ``l = l*alpha + sum p``,
    ``o = o*alpha + p.astype(v.dtype) @ v`` in f32; finally ``o / max(l,
    1e-30)`` in q's dtype. A step past a query tile's diagonal is wholly
    masked and leaves its state exactly as it was (``p = 0``, ``alpha =
    1``: every row has seen its own key by then), so ``bq`` changes the
    arithmetic only where a window starts a walk.
    """
    if bq < 1 or bk < 1:
        raise ValueError(f"tile sizes must be positive, got {(bq, bk)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, h, s, d = q.shape
    _check_shapes(q, k, v)
    dv = v.shape[-1]
    window = window or s
    bk = min(bk, s)
    dev = q.device
    nq, nk = -(-s // bq), -(-s // bk)
    qt = torch.nn.functional.pad(q, (0, 0, 0, nq * bq - s)).to(
        torch.float32).reshape(b, h, nq, bq, d)
    kt, vt = (torch.nn.functional.pad(t, (0, 0, 0, nk * bk - s)).reshape(
        b, h, nk, bk, t.shape[-1]) for t in (k, v))
    q0 = torch.arange(nq, device=dev) * bq
    lo = torch.clamp(q0 - window + 1, min=0) // bk
    hi = torch.clamp(q0 + bq - 1, max=s - 1) // bk
    qpos = (q0[:, None] + torch.arange(bq, device=dev))[:, :, None]
    scale = float(np.float32(1.0 / np.sqrt(d)))
    m = torch.full((b, h, nq, bq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    o = torch.zeros((b, h, nq, bq, dv), dtype=torch.float32, device=dev)
    for r in range(int((hi - lo).max()) + 1):
        j = lo + r
        live = j <= hi
        j = torch.clamp(j, max=nk - 1)
        kj, vj = kt[:, :, j], vt[:, :, j]               # (b, h, nq, bk, d)
        sc = qt @ kj.to(torch.float32).transpose(-1, -2) * scale
        kpos = (j * bk)[:, None, None] + torch.arange(bk, device=dev)
        age = qpos - kpos
        sc = torch.where((age >= 0) & (age < window) & live[:, None, None],
                         sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p.to(v.dtype).to(torch.float32) @ \
            vj.to(torch.float32)
        m = m_new
    out = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(b, h, nq * bq, dv)[:, :, :s].contiguous()


def check_kernel_head_dims(d: int, dv: int) -> None:
    """Raise ``ValueError`` unless the kernel was built for the (query-key,
    value) head dims ``(d, dv)``: ``d == dv`` in :data:`KERNEL_HEAD_DIMS`,
    or a pair of :data:`KERNEL_HEAD_SPLITS`."""
    if not (d == dv and d in KERNEL_HEAD_DIMS) and \
            (d, dv) not in KERNEL_HEAD_SPLITS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS} (v's equal to q's) and the "
                         f"(q/k, v) splits {KERNEL_HEAD_SPLITS}, got "
                         f"{(d, dv)}")


def flash_attention(q, k, v, *, bq: int = KERNEL_BQ, bk: int = KERNEL_BK,
                    window: int = 0):
    """Kernel wrapper of :func:`flash_attention_plain` (same contract). GQA
    callers broadcast KV heads beforehand. The kernel's tiles are fixed at
    64 x 64 and its head dims at :data:`KERNEL_HEAD_DIMS` (v's the same as
    q's) and :data:`KERNEL_HEAD_SPLITS`; it raises on others. DTensors
    (heads or batch split over a mesh) run on their local heads."""
    from repro_torch.distributed import local
    if local.is_dtensor(q):
        return local.per_head(flash_attention, q, k, v, bq=bq, bk=bk,
                              window=window)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, bq=bq, bk=bk, window=window)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if (bq, bk) != (KERNEL_BQ, KERNEL_BK):
        raise ValueError(f"flash_attention kernel tiles are "
                         f"{(KERNEL_BQ, KERNEL_BK)}, got {(bq, bk)}")
    b, h, s, d = q.shape
    _check_shapes(q, k, v)
    dv = v.shape[-1]
    check_kernel_head_dims(d, dv)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes f32 or bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
    if b * h > 65535 or b * h * s * d >= 2 ** 62:
        raise ValueError("flash_attention: the kernel takes at most 65535 "
                         "batch-heads")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(v)
    if q.numel():
        fn = build.entry("flash_attention_launch")
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b * h, s, d, dv,
                       float(np.float32(1.0 / np.sqrt(d))),
                       int(q.dtype == torch.bfloat16), int(window),
                       build.stream_ptr(q.device)), "flash_attention")
        build.COUNTS["flash_attention"] += 1
    return out

"""Int8 gradient compression with error feedback.

Counterpart of ``compress``, ``decompress`` and ``compress_tree`` of
``repro.training.compress``, bit-equal to them: at the data-parallel
reduction boundary, int8 payloads cut the all-reduce's bytes 4x against
f32, and the residual each worker keeps (error feedback, Karimireddy et
al. 2019) leaves SGD's convergence unharmed. The reference's
``compressed_psum`` (the mean all-reduce of the int8 payloads across a
mesh axis) comes with the port's sharded trainer.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import quant


def compress(g: torch.Tensor, residual: torch.Tensor):
    """``g + residual -> (q int8, scale, new residual)``."""
    t = g + residual
    scale = quant.compute_scale(t)
    q = torch.clamp(torch.round(t / scale), -quant.QMAX,
                    quant.QMAX).to(torch.int8)
    deq = q.to(t.dtype) * scale
    return q, scale, t - deq


def decompress(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale


def compress_tree(grads, residuals):
    """:func:`compress` on every leaf -> ``(q tree, scale tree, residual
    tree)``, each shaped as ``grads``."""
    out = [compress(g, tree.get_path(residuals, path))
           for path, g in tree.leaves_with_path(grads)]
    return tuple(tree.unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))

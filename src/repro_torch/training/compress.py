"""Int8 gradient compression with error feedback.

Counterpart of ``compress``, ``decompress`` and ``compress_tree`` of
``repro.training.compress``, bit-equal to them: at the data-parallel
reduction boundary, int8 payloads cut the all-reduce's bytes 4x against
f32, and the residual each worker keeps (error feedback, Karimireddy et
al. 2019) leaves SGD's convergence unharmed. :func:`compressed_psum` is
the mean all-reduce of the int8 payloads across a process group.
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


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group, *,
                    with_payload: bool = False):
    """Mean all-reduce of ``g`` in int8 instead of f32 (4x fewer
    data-parallel bytes) over ``group`` (a process group, a 1-D device
    mesh or ``(mesh, dim)``). Every rank quantizes against the *global*
    max scale (one all-reduce MAX of a scalar) so the int8 payloads are
    summable (an int32 all-reduce SUM), and keeps its own quantization
    error as the new residual (error feedback) -> ``(mean, new residual)``,
    the reference's op for op; ``with_payload`` adds this rank's int8
    payload."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    t = g + residual
    scale = funcol.all_reduce(quant.compute_scale(t), "max", group)
    q = torch.clamp(torch.round(t / scale), -quant.QMAX,
                    quant.QMAX).to(torch.int8)
    new_res = t - q.to(t.dtype) * scale
    total = funcol.all_reduce(q.to(torch.int32), "sum", group)
    n = torch.tensor(float(_group_size(group, dist)), dtype=torch.float32,
                     device=t.device)
    mean = total.to(torch.float32) * scale / n
    return (mean, new_res, q) if with_payload else (mean, new_res)


def _group_size(group, dist) -> int:
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.size(dim)
    if hasattr(group, "mesh_dim_names"):
        return group.size()
    return dist.get_world_size(group)

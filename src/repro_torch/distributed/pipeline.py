"""Pipeline parallelism (GPipe-style) over a 'stage' mesh axis.

Counterpart of ``repro.distributed.pipeline``: layers are split into S
stages, one per rank of the ``stage`` axis, and microbatches stream
through with point-to-point boundaries (the reference's
``collective_permute``); the bubble fraction is (S-1)/(S-1+M). The
production meshes use DP (+pod) x TP; this is the substrate beyond them.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _stage_mesh(mesh, axis: str):
    return mesh[axis] if mesh.ndim > 1 else mesh


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def make_pipeline_fn(stage_fn: Callable, n_stages: int, n_micro: int,
                     mesh, axis: str = "stage"):
    """``stage_fn(stage_params, x) -> x``, applied S times in sequence.

    Returns ``pipe(params_stacked, x_micro)``: ``params_stacked`` has a
    leading stage axis (a DTensor sharded over ``axis``, or a whole tensor
    or tree of which each rank takes its stage's slice) and ``x_micro`` is
    (n_micro, mb, ...), the same on every rank. Each of the ``n_micro + S -
    1`` steps runs one stage per rank: stage 0 ingests microbatch t, the
    last stage emits microbatch t - S + 1, and every stage sends its output
    to the next (``isend``/``irecv``, cyclic as the reference's
    permutation). The last stage's outputs then reach every rank of the
    axis (one all-reduce of a one-hot sum) -> (n_micro, mb, ...)."""
    assert n_micro >= n_stages, "need >= S microbatches to fill the pipe"
    smesh = _stage_mesh(mesh, axis)
    group = smesh.get_group()
    sid = smesh.get_local_rank()
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)

    def take(a):
        a = _local(a)
        return a[0] if a.shape[0] == 1 else a[sid]

    def pipe(params_stacked, x_micro):
        from repro_torch import tree
        params = tree.map_with_path(lambda _, a: take(a), params_stacked)
        xs = _local(x_micro)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            inject = xs[min(t, n_micro - 1)].to(buf.dtype) if sid == 0 \
                else buf
            y = stage_fn(params, inject)
            if sid == n_stages - 1 and t >= n_stages - 1:
                outs[t - n_stages + 1] = y.to(outs.dtype)
            y = y.contiguous()
            recv = torch.empty_like(y)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y, nxt, group),
                    dist.P2POp(dist.irecv, recv, prv, group)]):
                req.wait()
            buf = recv
        if sid != n_stages - 1:
            outs = torch.zeros_like(outs)
        dist.all_reduce(outs, group=group)
        return outs

    return pipe

"""Per-rank operation counts of one sharded step, for the dry-run and the
roofline: the counterpart of ``repro.launch.hlo_analysis``.

The reference parses the compiled, post-SPMD XLA HLO text of a step:
dot/convolution FLOPs from shapes, buffer traffic, and collective wire
bytes with loop trip counts. PyTorch has no HLO, so nothing here parses
text: the port runs the step once, as one rank of a fake process group
(``torch.distributed`` backend ``"fake"``, at the mesh's world size), on
fake tensors (``FakeTensorMode``: nothing is allocated, no kernel is
launched), and counts what that rank executes:

* FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` over the rank's
  local ops (the DTensor-level ops are let through to DTensor, so the
  matmuls counted are the ones on this rank's shards; a Python loop over
  layers runs every layer, so no trip-count inference is needed);
* buffer bytes: each local op's output bytes, plus its operand bytes for
  the ops that read whole operands (the reference's materializing set:
  matmuls, gathers and scatters, copies, concatenations), views excluded;
* collectives by ``torch.distributed.tensor.debug.CommDebugMode`` (counts
  per kind) and their wire bytes per rank from the operand and result
  bytes of each functional collective, with the reference's ring factors
  (:func:`_wire`, unchanged).

The HLO-text parsers (``_shape_bytes``, ``_group_size``,
``_split_computations``, the while-loop trip counts) have no counterpart.
The record has the reference's shape: ``{"flops", "buffer_bytes",
"collectives": {kind: {"count", "wire_bytes"}}, "total_wire_bytes"}``.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (what DTensor and the port issue) -> the kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
# ops whose operands are read whole (the reference's materializing set)
_READS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "index",
          "gather", "scatter", "scatter_add", "index_put", "index_put_",
          "copy", "copy_", "cat", "embedding"}
_VIEWS = {"view", "_unsafe_view", "reshape", "transpose", "t", "permute",
          "expand", "select", "slice", "unsqueeze", "squeeze", "as_strided",
          "detach", "alias", "unbind", "split", "split_with_sizes",
          "lift_fresh", "_to_copy_view"}


def _wire(kind: str, ob: float, rb: float, n: int) -> float:
    """Wire bytes per device of one collective (ring algorithms): the
    reference's factors."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-gather":
        return frac * rb
    if kind == "all-reduce":
        return 2 * frac * ob
    if kind in ("reduce-scatter", "all-to-all"):
        return frac * ob
    return float(ob)


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(e) for e in x)
    return 0


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _group_size(name) -> int:
    from torch.distributed import distributed_c10d as c10d
    try:
        return c10d._resolve_process_group(name).size()
    except (RuntimeError, ValueError, KeyError):
        return 1


_PROPAGATING = [0]


@contextlib.contextmanager
def _not_counting_propagation():
    """DTensor works out an op's output shape by running it once on fake
    tensors of the *global* shape: that run is not the rank's work, so the
    counters skip it."""
    from torch.distributed.tensor import _sharding_prop as sp
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(sp.ShardingPropagator, name, None)
    if orig is None:
        yield
        return

    def wrapped(self, *args, **kwargs):
        _PROPAGATING[0] += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING[0] -= 1

    setattr(sp.ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(sp.ShardingPropagator, name, orig)


class _LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` over a rank's local ops: DTensor-level ops are
    handed to DTensor first (as ``CommDebugMode`` does), so only the ops
    on this rank's shards are counted."""

    def __enter__(self):
        from torch.utils.flop_counter import _FlopCounterMode

        class _Local(_FlopCounterMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if _has_dtensor(types):
                    return NotImplemented
                if _PROPAGATING[0]:
                    return func(*args, **(kwargs or {}))
                return super().__torch_dispatch__(func, types, args, kwargs)

        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _Local(self)
        self.mode.__enter__()
        return self


class _Traffic(TorchDispatchMode):
    """Buffer bytes of a rank's local ops and the wire bytes of its
    collectives, per kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.wire = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _PROPAGATING[0]:
            return out
        name = func._overloadpacket.__name__
        kind = _KINDS.get(name)
        if kind is not None:
            ob, rb = _bytes(args[0]), _bytes(out)
            if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
                n = int(args[-2])
            elif kind == "collective-permute":
                n = 2
            else:
                n = _group_size(args[-1]) if isinstance(args[-1], str) \
                    else 2
            self.wire[kind] += _wire(kind, ob, rb, n)
        elif name not in _VIEWS:
            self.bytes += _bytes(out)
            if name in _READS:
                self.bytes += _bytes(list(args))
        return out


def compute_stats(fn, *args, trace=None, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once, counting this rank's work ->
    ``(out, {"flops", "buffer_bytes", "collectives": {kind: {"count",
    "wire_bytes"}}, "total_wire_bytes"})``. Plain tensors count as they
    are; DTensors by their local shards. ``trace``: a path to write
    ``CommDebugMode``'s table of the run's collectives to."""
    from torch.distributed.tensor.debug import CommDebugMode
    flops = _LocalFlopCounter(display=False)
    comm = CommDebugMode()
    traffic = _Traffic()
    with _not_counting_propagation(), flops, comm, traffic:
        out = fn(*args, **kwargs)
    if trace:
        comm.log_comm_debug_tracing_table_to_file(trace, noise_level=1)
    counts: dict = defaultdict(int)
    for op, c in comm.get_comm_counts().items():
        name = getattr(op, "__name__", str(op)).split(".")[-1]
        kind = _KINDS.get(name)
        if kind is not None:
            counts[kind] += c
    coll = {k: {"count": int(counts.get(k, 0)),
                "wire_bytes": float(traffic.wire.get(k, 0.0))}
            for k in sorted(set(counts) | set(traffic.wire))}
    return out, {"flops": float(flops.get_total_flops()),
                 "buffer_bytes": float(traffic.bytes),
                 "collectives": coll,
                 "total_wire_bytes": sum(v["wire_bytes"]
                                         for v in coll.values())}

"""Sharding rules: DP + FSDP over 'data' (and 'pod'), TP/EP over 'model'.

Counterpart of ``repro.distributed.sharding``. The rules are pure
functions of a leaf's path and rank, name for name the reference's:

  in-projections  (D_in, D_out)  -> P(data, model)   (column parallel + FSDP)
  out-projections (D_in, D_out)  -> P(model, data)   (row parallel + FSDP)
  expert weights  (E, D, F)      -> P(model, data, None)   (EP + FSDP)
  embeddings      (V, D)         -> P(model, data)
  1-D params / norms / convs     -> replicated

KV caches shard sequence over 'model' and batch over 'data'.

:class:`P` is the port's partition spec: a tuple of per-dimension entries,
each None, an axis name or a tuple of axis names, so ``tuple(spec)``
compares entry for entry with JAX's ``PartitionSpec``. Where the reference
turns specs into ``NamedSharding``s (``to_named``), the port turns them into
DTensor placements over a ``torch.distributed`` device mesh
(:func:`to_placements`) and places a tree's leaves by them
(:func:`distribute_tree`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.protection.tensor import ProtectedTensor, is_protected_tensor

IN_PROJ = {"wq", "wk", "wv", "w_gate", "w_up", "w_y_gate", "w_input_gate",
           "w_a_gate", "w_dkv", "w_dq", "w_uq", "w_uk", "w_uv", "router",
           "ws_gate", "ws_up"}
OUT_PROJ = {"wo", "w_down", "w_out", "ws_down"}
EXPERT_IN = {"we_gate", "we_up"}
EXPERT_OUT = {"we_down"}
PACKED_IN = {"w_in"}  # mamba2 packed projection: model-sharding would split
                      # the [x,z,B,C,dt] concat across shards -> data only


class P(tuple):
    """A partition spec: one entry per tensor dimension (None, an axis name,
    or a tuple of axis names, major first); missing trailing entries are
    None. ``P("data", None) == ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _path_names(path) -> list:
    """Dict keys and sequence indices of a path as strings; a NamedTuple
    field is skipped, as the reference's ``GetAttrKey`` has neither a
    ``key`` nor an ``idx``."""
    return [str(p) for p in path if not isinstance(p, tree.Field)]


def param_spec(path, leaf, *, data="data", model="model",
               fsdp: bool = True) -> P:
    names = _path_names(path)
    name = names[-1]
    d = data if fsdp else None
    base: Optional[tuple]

    if name in ("embed",):
        base = (model, d)
    elif name in ("head",):
        base = (d, model)
    elif name in EXPERT_IN:
        base = (model, d, None)
    elif name in EXPERT_OUT:
        base = (model, None, d)
    elif name in PACKED_IN:
        base = (d, None)
    elif name in IN_PROJ:
        base = (d, model)
    elif name in OUT_PROJ:
        base = (model, d)
    else:
        base = ()  # norms, biases, convs, scalars -> replicated

    ndim = getattr(leaf, "ndim", len(getattr(leaf, "shape", ())))
    if base and ndim == len(base) + 1:   # stacked layer axis
        base = (None, *base)
    elif base and ndim != len(base):     # unexpected rank -> replicate
        base = ()
    return P(*base)


def param_specs(params, **kw):
    return tree.map_with_path(lambda p, l: param_spec(p, l, **kw), params)


def cache_spec(path, leaf, *, data="data", model="model") -> P:
    names = _path_names(path)
    name = names[-1]
    ndim = leaf.ndim
    if name in ("k", "v", "cross_k", "cross_v"):       # (L,B,S,kv,hd)
        return P(None, data, model, None, None)
    if name in ("k_pages", "v_pages", "k_checks", "v_checks"):
        # (L, P, ps, kv, hd | hd/8) paged pools: identity page tables are
        # batch-major, so the pool dim follows the batch ('data') sharding;
        # pages are indivisible ECC units, so ps/kv/hd stay whole
        return P(None, data, None, None, None)
    if name in ("k_scale", "v_scale"):                 # (L,P,ps)
        return P(None, data, None)
    if name == "kv_table":                             # (L,B,npg) - tiny;
        return P(None, None, None)                     # replicate
    if name in ("latent", "k_rope"):                   # (L,B,S,r)
        return P(None, data, model, None)
    if name == "state":                                # (L,B,h,p,n)
        return P(None, data, None, None, None)
    if name.endswith("_h") or name == "h":             # (L,B,w)
        return P(None, data, None)
    if name.endswith("conv"):                          # (L,B,k-1,c)
        return P(None, data, None, None)
    return P(*([None] * ndim))


def cache_specs(cache, **kw):
    return tree.map_with_path(lambda p, l: cache_spec(p, l, **kw), cache)


def batch_spec(name: str, leaf, *, dp) -> P:
    ndim = leaf.ndim
    return P(dp, *([None] * (ndim - 1)))


def batch_specs(batch, *, multi_pod: bool = False):
    dp = ("pod", "data") if multi_pod else "data"
    return {k: batch_spec(k, v, dp=dp) for k, v in batch.items()}


def _is_spec(x) -> bool:
    """A :class:`P`, or a tuple of DTensor placements."""
    if isinstance(x, P):
        return True
    from torch.distributed.tensor import Placement
    return (isinstance(x, tuple) and bool(x)
            and all(isinstance(e, Placement) for e in x))


def map_specs(fn, specs, shapes):
    """``fn(spec, leaf)`` over a spec tree and the tree it describes -> a
    tree shaped as ``specs``; a :class:`P` (or None) where ``shapes`` holds
    a subtree stands for every leaf under it, as a JAX prefix spec does;
    a ``ProtectedTensor`` of specs pairs with its leaf whole."""
    if _is_spec(specs) or specs is None:
        if is_protected_tensor(shapes) or _is_leaf(shapes):
            return fn(specs, shapes)
        return tree.map_with_path(lambda _, l: fn(specs, l), shapes)
    if is_protected_tensor(specs):
        return fn(specs, shapes)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], shapes[k]) for k in specs}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*[map_specs(fn, a, b)
                             for a, b in zip(specs, shapes)])
    return type(specs)(map_specs(fn, a, b) for a, b in zip(specs, shapes))


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def mesh_sizes(mesh) -> Optional[dict]:
    """``{axis: size}`` of a ``DeviceMesh``, or a plain ``{axis: size}``
    dict as it is (a mesh the planner sizes without its ranks); None for
    no mesh."""
    if mesh is None:
        return None
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def to_placements(spec, mesh) -> tuple:
    """A :class:`P` -> DTensor placements, one per mesh dimension: ``Shard(d)``
    where tensor dimension ``d`` names the mesh axis, else ``Replicate()``.

    A dimension that names several axes (``P(("data", "model"))``) is split
    by each in turn, in the mesh's order, which makes the first axis major:
    shard ``i * model + j`` lands at mesh coordinate ``(i, j)``, as JAX lays
    it out. An entry that lists its axes in another order than the mesh
    raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r} orders the axes {axes} of "
                             f"dimension {dim} against the mesh's {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def distribute(t, spec, mesh):
    """One tensor -> a DTensor placed by ``spec`` (or a tuple of
    placements). Every rank holds the whole tensor (a checkpoint read, a
    seeded init): each keeps its own chunk, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    placements = to_placements(spec, mesh) if isinstance(spec, P) else spec
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def spec_at(specs, path: tuple):
    """The spec that a (prefix) spec tree gives the leaf at ``path``."""
    for k in path:
        if specs is None or _is_spec(specs) or is_protected_tensor(specs):
            break
        specs = tree.get_path(specs, (k,))
    return specs


def distribute_tree(params, specs, mesh):
    """Place every tensor leaf of ``params`` by the spec at the same path of
    ``specs`` (a :class:`P` or placements); a ``ProtectedTensor`` takes its
    spec's ``enc``, ``checks`` and ``scale``. Other leaves pass through."""

    def place(path, leaf):
        spec = tree.get_path(specs, path)
        if is_protected_tensor(leaf):
            return ProtectedTensor(
                enc=distribute(leaf.enc, spec.enc, mesh),
                checks=(None if leaf.checks is None else
                        distribute(leaf.checks, spec.checks, mesh)),
                scale=(distribute(leaf.scale, spec.scale, mesh)
                       if isinstance(leaf.scale, torch.Tensor)
                       else leaf.scale),
                scheme_id=leaf.scheme_id, orig_shape=leaf.orig_shape)
        if isinstance(leaf, torch.Tensor):
            return distribute(leaf, spec, mesh)
        return leaf
    return tree.map_with_path(place, params)


def local_tree(tree_):
    """Every DTensor of a tree (``ProtectedTensor`` fields too) -> its
    whole value gathered on every rank (a test's or a report's view;
    never before a kernel)."""
    from torch.distributed.tensor import DTensor

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def one(_, leaf):
        if is_protected_tensor(leaf):
            return ProtectedTensor(
                enc=full(leaf.enc),
                checks=None if leaf.checks is None else full(leaf.checks),
                scale=full(leaf.scale), scheme_id=leaf.scheme_id,
                orig_shape=leaf.orig_shape)
        return full(leaf)
    return tree.map_with_path(one, tree_)

"""``ProtectionPlan`` — materialized per-leaf protection decisions.

Counterpart of ``repro.protection.plan``: built once from ``(policy,
params)`` (tensors or :class:`ShapeDtype` records), it holds each leaf's
:class:`LeafPlan` — scheme (per-leaf rules), layout, backend and where it
came from (rule, autotune table, policy), the autotune table's tile hints,
stored bytes and the serve-time activation-quant, ABFT and clamp
decisions — and encodes a tree (or one leaf at a time, for models that do
not fit twice in memory) under it. It also carries the serving-state (KV)
policy (:meth:`ProtectionPlan.with_kv_policy`), and diffs against another
plan of the same tree (:class:`PlanDiff`) and migrates an encoded tree
toward it leaf by leaf (:meth:`ProtectionPlan.migrate_step`, through
:func:`transcode_leaf`). :data:`POLICY_PRESETS` are the reference's named
mixed-scheme policies. Built with a mesh (a ``DeviceMesh`` or a plain
``{axis: size}`` dict) and a ``param_spec_fn``, every leaf also carries its
sharding spec (``LeafPlan.spec``, a ``ProtectedTensor`` of
``distributed.sharding.P`` for a protected leaf): a same-shape image
inherits the weight's spec, sanitized against the mesh's sizes; a
flat-padded image gets a 1-D spec over ('data', 'model') while every shard
keeps whole 8-byte blocks (:meth:`ProtectionPlan.spec_tree`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core import quant, wot

from .backends import get_backend
from .schemes import get_scheme
from .tensor import ProtectedTensor, is_protected_tensor

__all__ = ["LeafPlan", "ProtectionPlan", "make_plan", "ShapeDtype",
           "LeafDiff", "PlanDiff", "transcode_leaf", "POLICY_PRESETS",
           "get_policy_preset"]

BLOCK = 8
FLAT_SHARD_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a leaf that is not built yet."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf's resolved decision (see the reference's field docs).

    backend_src: where the backend came from: "rule" | "autotune" |
               "policy" ("" when unprotected).
    tiles, int8_tiles, tiles_src: the autotune table's (bm, bn, bk) and
               int8 (bm, bn, 0) hints for the per-layer matmul
               ``shape[-2:]`` and their source ("exact" | "nearest" | "");
               recorded as the reference records them, and ignored by the
               CUDA kernels, which choose their own tiles.
    act_quant: None (float activations) | "dynamic" (per-token absmax) |
               "static" (calibrated ``a_scale``), set by
               :meth:`ProtectionPlan.with_act_quant`.
    a_scale:   the calibrated static activation scale, or None.
    abft:      verify ABFT checksums on this leaf's matmuls
               (:meth:`ProtectionPlan.with_abft`).
    clamp:     activation-range bound (absmax) of the epilogue output, hits
               counted; None leaves the output unclipped.
    spec:      the leaf's sharding spec (a ``ProtectedTensor`` of specs
               for a protected leaf), or None without a ``param_spec_fn``."""
    path: str
    scheme_id: Optional[str]
    reason: str
    backend: str
    layout: str                 # "same-shape" | "flat-padded" | "raw"
    shape: tuple
    n_weights: int
    enc_shape: tuple
    pad_bytes: int
    check_bytes: int
    stored_bytes: int
    backend_src: str = ""
    tiles: Optional[tuple] = None
    int8_tiles: Optional[tuple] = None
    tiles_src: str = ""
    act_quant: Optional[str] = None
    a_scale: Optional[float] = None
    abft: bool = False
    clamp: Optional[float] = None
    spec: Any = dataclasses.field(default=None, compare=False)

    @property
    def protected(self) -> bool:
        return self.scheme_id is not None

    @property
    def flat_sharded(self) -> bool:
        """True when a flat-padded image got a real (non-replicated) spec."""
        return (self.layout == "flat-padded" and self.spec is not None
                and tuple(self.spec.enc) != ())


@dataclasses.dataclass(frozen=True)
class LeafDiff:
    """One leaf whose protection decision differs between two plans."""

    path: str
    from_scheme: Optional[str]
    to_scheme: Optional[str]
    from_backend: str
    to_backend: str
    stored_bytes_delta: int

    @property
    def scheme_changed(self) -> bool:
        return self.from_scheme != self.to_scheme


@dataclasses.dataclass(frozen=True)
class PlanDiff:
    """Ordered per-leaf delta between two plans of the SAME tree;
    ``paths`` (the scheme changes, in plan order) is the work list a
    ``serving.scrubber.Migrator`` drains, one leaf at a time."""

    entries: tuple

    @property
    def paths(self) -> tuple:
        """Leaves whose scheme changes: a backend-only change rewrites no
        byte."""
        return tuple(e.path for e in self.entries if e.scheme_changed)

    @property
    def empty(self) -> bool:
        return not self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def summary(self) -> dict:
        moves: dict = {}
        for e in self.entries:
            if e.scheme_changed:
                k = f"{e.from_scheme}->{e.to_scheme}"
                moves[k] = moves.get(k, 0) + 1
        return {"n_changed": len(self.entries),
                "n_scheme_changes": len(self.paths), "moves": moves,
                "stored_bytes_delta": sum(e.stored_bytes_delta
                                          for e in self.entries)}


def transcode_leaf(pt: ProtectedTensor, to_scheme, *, backend="torch"):
    """Re-encode one stored image under another scheme without a float
    round trip: decode to int8 (correcting what the old code can), WOT-clamp
    if the new scheme needs it (idempotent on a throttled encode), encode.
    The quantized values, and every logit, are kept bit for bit.
    -> ``(new_pt, corrected, due)``, the flags of the old image's decode
    (DUE blocks carry what the old decode returned; repair is a pass of its
    own)."""
    frm = get_scheme(pt.scheme_id)
    to = get_scheme(to_scheme)
    be = get_backend(backend)
    q, corrected, due = frm.decode_with_flags(pt.enc, pt.checks, be)
    if to.requires_wot:
        q = wot.throttle_q(q.reshape(-1)).reshape(q.shape)
    enc, checks = to.encode(q, be)
    new = ProtectedTensor(enc=enc, checks=checks, scale=pt.scale,
                          scheme_id=to.scheme_id,
                          orig_shape=tuple(pt.orig_shape))
    return new, corrected, due


class ProtectionPlan:
    """Ordered ``{path: LeafPlan}`` for one ``(policy, tree)``, plus the
    serving-state ``kv_policy`` (None unless set) and the mesh axes the
    specs were sized for (None without a mesh)."""

    def __init__(self, policy, leaves: dict, *, kv_policy=None,
                 mesh_axes=None):
        self.policy = policy
        self.leaves = leaves
        self.kv_policy = kv_policy
        self.mesh_axes = mesh_axes

    def __len__(self) -> int:
        return len(self.leaves)

    def __iter__(self):
        return iter(self.leaves.values())

    def __getitem__(self, path: str) -> LeafPlan:
        return self.leaves[path]

    def _leaf(self, path) -> LeafPlan:
        p = tree.path_str(path)
        try:
            return self.leaves[p]
        except KeyError:
            raise KeyError(f"leaf {p!r} is not in this ProtectionPlan (plan "
                           f"built for a different tree?)") from None

    @property
    def protected(self) -> list:
        return [lp for lp in self if lp.protected]

    @property
    def unprotected(self) -> list:
        return [lp for lp in self if not lp.protected]

    def by_scheme(self) -> dict:
        out: dict = {}
        for lp in self.protected:
            d = out.setdefault(lp.scheme_id, {"n_tensors": 0, "weight_bytes": 0,
                                              "stored_bytes": 0,
                                              "check_bytes": 0, "pad_bytes": 0})
            d["n_tensors"] += 1
            d["weight_bytes"] += lp.n_weights
            d["stored_bytes"] += lp.stored_bytes
            d["check_bytes"] += lp.check_bytes
            d["pad_bytes"] += lp.pad_bytes
        return out

    def by_backend(self) -> dict:
        out: dict = {}
        for lp in self.protected:
            out[lp.backend] = out.get(lp.backend, 0) + 1
        return out

    def summary(self) -> dict:
        prot, unprot = self.protected, self.unprotected
        return {
            "n_leaves": len(self.leaves),
            "n_protected": len(prot),
            "n_unprotected": len(unprot),
            "protected_bytes": sum(lp.stored_bytes for lp in prot),
            "unprotected_bytes": sum(lp.stored_bytes for lp in unprot),
            "weight_bytes": sum(lp.n_weights for lp in prot),
            "pad_bytes": sum(lp.pad_bytes for lp in prot),
            "check_bytes": sum(lp.check_bytes for lp in prot),
            "by_scheme": self.by_scheme(),
            "by_backend": self.by_backend(),
            "n_flat_padded": sum(lp.layout == "flat-padded" for lp in prot),
            "n_flat_sharded": sum(lp.flat_sharded for lp in prot),
            "tiles_src": self._count(prot, "tiles_src"),
            "act_quant": self._count(prot, "act_quant"),
            "n_abft": sum(lp.abft for lp in prot),
            "n_clamped": sum(lp.clamp is not None for lp in prot),
            "kv_policy": ({"scheme": self.kv_policy.scheme,
                           "fused": self.kv_policy.fused,
                           "attention_impl": self.kv_policy.attention_impl,
                           "page_size": self.kv_policy.page_size}
                          if self.kv_policy is not None else None),
        }

    @staticmethod
    def _count(leaves, field) -> dict:
        """{value: count} over truthy values of one LeafPlan field."""
        out: dict = {}
        for lp in leaves:
            v = getattr(lp, field)
            if v:
                out[v] = out.get(v, 0) + 1
        return out

    def _matmul_leaf(self, lp) -> bool:
        return lp.protected and len(lp.shape) >= 2

    def with_act_quant(self, mode: str = "dynamic",
                       scales: Optional[dict] = None, *,
                       clamp: bool = False) -> "ProtectionPlan":
        """A new plan whose protected matmul leaves (ndim >= 2) carry
        activation-quant decisions for the int8 serve path: "dynamic"
        (per-token absmax at use) for every one of them, or "static" for
        exactly the leaves in ``scales`` (``{path: a_scale}`` from
        ``serving.protected.calibrate_act_scales``). ``clamp=True`` (static
        only) also sets each calibrated leaf's clamp to ``a_scale * 127``,
        the absmax the scale came from."""
        if mode not in ("static", "dynamic"):
            raise ValueError(f"act-quant mode {mode!r}; one of "
                             f"('static', 'dynamic')")
        if mode == "static" and not scales:
            raise ValueError("static activation quantization needs calibrated"
                             " scales — run calibrate_act_scales() first")
        if clamp and mode != "static":
            raise ValueError("clamp ranges come from calibrated absmax — use "
                             "mode='static' with calibrate_act_scales()")
        scales = scales or {}
        leaves = {}
        for p, lp in self.leaves.items():
            if not self._matmul_leaf(lp):
                leaves[p] = lp
            elif mode == "dynamic":
                leaves[p] = dataclasses.replace(lp, act_quant="dynamic")
            elif p in scales:
                s = float(scales[p])
                leaves[p] = dataclasses.replace(
                    lp, act_quant="static", a_scale=s,
                    clamp=s * quant.QMAX if clamp else lp.clamp)
            else:
                leaves[p] = lp
        return ProtectionPlan(self.policy, leaves, kv_policy=self.kv_policy,
                              mesh_axes=self.mesh_axes)

    def with_abft(self, enabled: bool = True, *,
                  clamps: Optional[dict] = None) -> "ProtectionPlan":
        """A new plan whose protected matmul leaves verify ABFT checksums at
        every use (``enabled``); ``clamps`` maps leaf paths to activation
        bounds fused into the same epilogue (leaves not in it keep their
        clamp)."""
        clamps = clamps or {}
        leaves = {}
        for p, lp in self.leaves.items():
            if not self._matmul_leaf(lp):
                leaves[p] = lp
            else:
                leaves[p] = dataclasses.replace(
                    lp, abft=bool(enabled),
                    clamp=float(clamps[p]) if p in clamps else lp.clamp)
        return ProtectionPlan(self.policy, leaves, kv_policy=self.kv_policy,
                              mesh_axes=self.mesh_axes)

    def with_kv_policy(self, kv_policy) -> "ProtectionPlan":
        """A new plan that also carries the paged KV cache's policy (a
        ``serving.kvcache.KVProtectionPolicy`` or preset name); the serve
        step and the prefill default their ``kv_policy`` from it."""
        from repro_torch.serving import kvcache  # serving builds on us
        return ProtectionPlan(self.policy, self.leaves,
                              kv_policy=kvcache.get_kv_policy(kv_policy),
                              mesh_axes=self.mesh_axes)

    # -- plan diff and rolling migration ------------------------------------

    def diff(self, other: "ProtectionPlan") -> PlanDiff:
        """Per-leaf delta against ``other`` (the target), in this plan's
        order; both plans must cover the same leaves."""
        if set(self.leaves) != set(other.leaves):
            missing = set(self.leaves) ^ set(other.leaves)
            raise ValueError(
                f"plans cover different trees ({len(self.leaves)} vs "
                f"{len(other.leaves)} leaves; e.g. {sorted(missing)[:3]})")
        entries = []
        for p, lp in self.leaves.items():
            tp = other.leaves[p]
            if lp.scheme_id == tp.scheme_id and lp.backend == tp.backend:
                continue
            entries.append(LeafDiff(
                path=p, from_scheme=lp.scheme_id, to_scheme=tp.scheme_id,
                from_backend=lp.backend, to_backend=tp.backend,
                stored_bytes_delta=tp.stored_bytes - lp.stored_bytes))
        return PlanDiff(entries=tuple(entries))

    def with_leaves(self, leaves: dict) -> "ProtectionPlan":
        """A new plan with some leaves replaced (``{path: LeafPlan}``)."""
        unknown = set(leaves) - set(self.leaves)
        if unknown:
            raise KeyError(f"not in this plan: {sorted(unknown)[:3]}")
        return ProtectionPlan(self.policy, {**self.leaves, **leaves},
                              kv_policy=self.kv_policy,
                              mesh_axes=self.mesh_axes)

    def migrate_step(self, enc_tree, target: "ProtectionPlan",
                     paths) -> tuple:
        """Promote the leaves ``paths`` to their ``target`` scheme in the
        encoded tree (:func:`transcode_leaf` on the target leaf's backend)
        and adopt the target's ``LeafPlan`` for them.
        -> ``(new_enc_tree, new_plan, records)``, one ``{path, from, to,
        corrected, due}`` record per promoted leaf, in plan order. The
        serve step keeps working across the swap: decode dispatches on
        each ``ProtectedTensor.scheme_id``."""
        want = set(paths)
        todo = [p for p in self.leaves if p in want]
        if len(todo) != len(want):
            raise KeyError(f"paths not in plan: "
                           f"{sorted(want - set(todo))[:3]}")
        todo_set = set(todo)
        for p in todo:
            if target.leaves[p].scheme_id is None:
                raise ValueError(f"target leaves {p!r} unprotected — "
                                 "migration only moves between schemes")
        records = []

        def mig(path, leaf):
            p = tree.path_str(path)
            if p not in todo_set:
                return leaf
            if not is_protected_tensor(leaf):
                raise ValueError(f"{p!r} is not a ProtectedTensor in the "
                                 "encoded tree")
            tp = target.leaves[p]
            new, cor, due = transcode_leaf(leaf, tp.scheme_id,
                                           backend=tp.backend or "torch")
            records.append({"path": p, "from": leaf.scheme_id,
                            "to": tp.scheme_id, "corrected": int(cor),
                            "due": int(due)})
            return new

        new_tree = tree.map_with_path(mig, enc_tree)
        new_plan = self.with_leaves({p: target.leaves[p] for p in todo})
        return new_tree, new_plan, records

    def coverage(self):
        from .policy import CoverageEntry, CoverageReport
        return CoverageReport([
            CoverageEntry(lp.path, lp.scheme_id, lp.reason, lp.n_weights,
                          lp.stored_bytes, lp.pad_bytes) for lp in self])

    def encode_leaf(self, path, w):
        """Encode one leaf under its planned scheme and backend (unprotected
        leaves pass through) — the hook that lets a model be built and
        encoded one leaf at a time."""
        lp = self._leaf(path)
        if not lp.protected:
            return w
        return self.policy.encode_leaf(w, lp.scheme_id, backend=lp.backend)

    def encode_tree(self, params):
        """float params -> tree with ``ProtectedTensor`` leaves, each under
        its planned scheme and backend."""
        return tree.map_with_path(self.encode_leaf, params)

    def decode_tree(self, enc_tree, dtype=torch.bfloat16):
        """Decode with each leaf's planned backend: one tree may mix
        schemes and backends."""
        from .policy import decode_leaf

        def dec(path, leaf):
            if not is_protected_tensor(leaf):
                return leaf
            return decode_leaf(leaf, dtype,
                               backend=self._leaf(path).backend)
        return tree.map_with_path(dec, enc_tree)

    def spec_tree(self, enc_tree):
        """Sharding specs for an encoded tree, from the plan's materialized
        per-leaf specs (flat-padded images sharded when block-aligned)."""
        def spec(path, leaf):
            lp = self._leaf(path)
            if lp.spec is None:
                raise ValueError(
                    f"plan has no spec for {lp.path!r} — build it with "
                    f"make_plan(..., param_spec_fn=...) to use spec_tree()")
            return lp.spec
        return tree.map_with_path(spec, enc_tree)


def _drop_nondividing(spec, shape, sizes):
    """Drop mesh axes from dims they don't divide (the dry-run's sanitize
    pass, applied at plan time when the mesh is known)."""
    from repro_torch.distributed.sharding import P
    if sizes is None or not isinstance(spec, P):
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim_size, entry in zip(shape, dims):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        prod = math.prod(sizes.get(n, 0) for n in names)
        out.append(entry if prod and dim_size % prod == 0 else None)
    return P(*out)


def _flat_spec(enc_len: int, sizes):
    """1-D sharded spec for a flat-padded image over ('data', 'model') when
    every shard keeps whole 8-byte ECC blocks; replicated otherwise."""
    from repro_torch.distributed.sharding import P
    if sizes is None:
        return P()
    axes = tuple(a for a in FLAT_SHARD_AXES if a in sizes)
    if not axes:
        return P()
    n_shards = math.prod(sizes[a] for a in axes)
    if n_shards <= 1 or enc_len % (BLOCK * n_shards) != 0:
        return P()
    return P(axes)


def make_plan(policy, params, *, mesh=None,
              param_spec_fn: Optional[Callable] = None) -> ProtectionPlan:
    """Materialize a :class:`ProtectionPlan`; only shapes, dtypes and paths
    of ``params`` are read.

    mesh:          optional ``DeviceMesh`` or ``{axis: size}`` dict; sizes
                   the flat-padded images' 1-D specs and sanitizes the
                   same-shape specs against the axis sizes.
    param_spec_fn: ``(path, leaf) -> P`` for weight leaves (the rule table
                   serving uses, ``distributed.sharding.param_spec``);
                   without it the plan has no specs and
                   :meth:`ProtectionPlan.spec_tree` raises."""
    from repro_torch.distributed.sharding import P, mesh_sizes
    sizes = mesh_sizes(mesh)
    leaves: dict = {}
    for path, leaf in tree.leaves_with_path(params):
        p = tree.path_str(path)
        sid, reason = policy._plan(path, leaf)
        shape = tuple(leaf.shape)
        n = int(math.prod(shape))
        if sid is None:
            itemsize = torch.empty((), dtype=leaf.dtype).element_size()
            spec = None
            if param_spec_fn is not None:
                spec = _drop_nondividing(param_spec_fn(path, leaf), shape,
                                         sizes)
            leaves[p] = LeafPlan(p, None, reason, "", "raw", shape, n, (), 0, 0,
                                 n * itemsize, spec=spec)
            continue
        scheme = get_scheme(sid)
        aligned = len(shape) >= 1 and shape[-1] % BLOCK == 0
        pad = 0 if aligned else (-n) % BLOCK
        checks = int((n + pad) * scheme.check_ratio)
        be, be_src = policy.resolve_backend(p, shape)
        # tile hints for the per-layer matmul: a stacked (L, K, N) leaf is
        # sliced to (K, N), so the trailing two dims key the lookup
        tiles = int8_tiles = None
        tiles_src = ""
        if policy.autotune is not None and len(shape) >= 2:
            tiles, f_src = policy.autotune.lookup_tiles_src(shape[-2:])
            int8_tiles, i_src = policy.autotune.lookup_tiles_src(
                shape[-2:], key="int8_tiles")
            srcs = {s for s in (f_src, i_src) if s}
            tiles_src = ("nearest" if "nearest" in srcs
                         else "exact" if srcs else "")
        spec = None
        if param_spec_fn is not None:
            if aligned:
                enc_spec = _drop_nondividing(
                    param_spec_fn(path, ShapeDtype(shape, torch.uint8)),
                    shape, sizes)
            else:
                enc_spec = _flat_spec(n + pad, sizes)
            spec = ProtectedTensor(enc=enc_spec,
                                   checks=P() if checks else None,
                                   scale=P(), scheme_id=scheme.scheme_id,
                                   orig_shape=shape)
        leaves[p] = LeafPlan(
            p, scheme.scheme_id, "", be.name,
            "same-shape" if aligned else "flat-padded", shape, n,
            shape if aligned else (n + pad,), pad, checks, n + pad + checks,
            backend_src=be_src, tiles=tiles, int8_tiles=int8_tiles,
            tiles_src=tiles_src, spec=spec)
    return ProtectionPlan(policy, leaves,
                          mesh_axes=tuple(sizes) if sizes else None)


# MLP / FFN / expert projections: what attn-inplace-mlp-secded moves to the
# standard SEC-DED(72,64) code (the reference's pattern)
_MLP_PAT = (r"(^|/)(mlp|ffn|w_gate|w_up|w_down|"
            r"we_gate|we_up|we_down|ws_gate|ws_up|ws_down)(/|$)")

# preset name -> ProtectionPolicy keyword arguments (the reference's)
POLICY_PRESETS: dict = {
    "all-in-place": {},
    "all-secded72": {"default_scheme": "secded72"},
    "attn-inplace-mlp-secded": {"default_scheme": "in-place",
                                "rules": [(_MLP_PAT, "secded72")]},
    "unprotected": {"default_scheme": "faulty"},
}


def get_policy_preset(name: str, **overrides):
    """A named preset ``ProtectionPolicy``; keyword arguments override the
    preset's (e.g. ``predicate=``, ``backend=``, ``autotune=``)."""
    from .policy import ProtectionPolicy
    try:
        kw = dict(POLICY_PRESETS[name])
    except KeyError:
        raise ValueError(f"unknown policy preset {name!r}; one of "
                         f"{sorted(POLICY_PRESETS)}") from None
    kw.update(overrides)
    return ProtectionPolicy(**kw)

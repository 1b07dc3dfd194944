"""``ProtectionPlan`` — materialized per-leaf protection decisions.

Counterpart of ``repro.protection.plan`` for a single-scheme policy: built
once from ``(policy, params)`` (tensors or :class:`ShapeDtype` records), it
holds each leaf's :class:`LeafPlan` — scheme, layout, backend, stored
bytes and the serve-time activation-quant, ABFT and clamp decisions — and
encodes a tree (or one leaf at a time, for models that do not fit twice in
memory) under it. Presets, mesh specs, diffs and autotune tiles are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import quant

from .schemes import get_scheme

__all__ = ["LeafPlan", "ProtectionPlan", "make_plan", "ShapeDtype"]

BLOCK = 8


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

    act_quant: None (float activations) | "dynamic" (per-token absmax) |
               "static" (calibrated ``a_scale``), set by
               :meth:`ProtectionPlan.with_act_quant`.
    a_scale:   the calibrated static activation scale, or None.
    abft:      verify ABFT checksums on this leaf's matmuls
               (:meth:`ProtectionPlan.with_abft`).
    clamp:     activation-range bound (absmax) of the epilogue output, hits
               counted; None leaves the output unclipped."""
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
    act_quant: Optional[str] = None
    a_scale: Optional[float] = None
    abft: bool = False
    clamp: Optional[float] = None

    @property
    def protected(self) -> bool:
        return self.scheme_id is not None


class ProtectionPlan:
    """Ordered ``{path: LeafPlan}`` for one ``(policy, tree)``."""

    def __init__(self, policy, leaves: dict):
        self.policy = policy
        self.leaves = leaves

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
            "act_quant": self._count(prot, "act_quant"),
            "n_abft": sum(lp.abft for lp in prot),
            "n_clamped": sum(lp.clamp is not None for lp in prot),
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
        return ProtectionPlan(self.policy, leaves)

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
        return ProtectionPlan(self.policy, leaves)

    def coverage(self):
        from .policy import CoverageEntry, CoverageReport
        return CoverageReport([
            CoverageEntry(lp.path, lp.scheme_id, lp.reason, lp.n_weights,
                          lp.stored_bytes, lp.pad_bytes) for lp in self])

    def encode_leaf(self, path, w):
        """Encode one leaf under its planned scheme (unprotected leaves pass
        through) — the hook that lets a model be built and encoded one leaf
        at a time."""
        lp = self._leaf(path)
        if not lp.protected:
            return w
        return self.policy.encode_leaf(w, lp.scheme_id)

    def encode_tree(self, params):
        """float params -> tree with ``ProtectedTensor`` leaves."""
        return tree.map_with_path(self.encode_leaf, params)


def make_plan(policy, params) -> ProtectionPlan:
    """Materialize a :class:`ProtectionPlan`; only shapes, dtypes and paths
    of ``params`` are read."""
    leaves: dict = {}
    for path, leaf in tree.leaves_with_path(params):
        p = tree.path_str(path)
        sid, reason = policy._plan(path, leaf)
        shape = tuple(leaf.shape)
        n = int(math.prod(shape))
        if sid is None:
            itemsize = torch.empty((), dtype=leaf.dtype).element_size()
            leaves[p] = LeafPlan(p, None, reason, "", "raw", shape, n, (), 0, 0,
                                 n * itemsize)
            continue
        scheme = get_scheme(sid)
        aligned = len(shape) >= 1 and shape[-1] % BLOCK == 0
        pad = 0 if aligned else (-n) % BLOCK
        checks = int((n + pad) * scheme.check_ratio)
        leaves[p] = LeafPlan(
            p, scheme.scheme_id, "", policy.backend.name,
            "same-shape" if aligned else "flat-padded", shape, n,
            shape if aligned else (n + pad,), pad, checks, n + pad + checks)
    return ProtectionPlan(policy, leaves)

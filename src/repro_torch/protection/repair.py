"""MILR-style algebraic weight recovery: the last resort after a DUE.

Counterpart of ``repro.protection.repair``. When an 8-byte block takes a
second hit the code detects it but cannot correct it (a DUE), and the
scrubber refuses to write the leaf back (``serving.scrubber``). MILR
(Ponader et al.) observes that a linear layer's weights are
over-determined by known input/output pairs: with ``y = x @ q`` pinned for
the clean int8 image ``q``, any set of corrupted rows ``R`` solves from

    x[:, R] @ q[R] = y - x[:, ~R] @ q[~R]

when ``|R| <= n_samples``. The solve targets integers, so rounding the
least-squares solution reproduces the original rows bit for bit, and the
residual against the pinned outputs is checked before anything is
re-encoded.

The :class:`RepairKit` is built once from the freshly encoded tree
(:func:`build_repair_kit`): per repairable leaf a seeded probe matrix ``x``
(n_samples, K), its clean response ``y`` (float64), and a ``secded72``
twin of the leaf's image, the quarantine fallback. When reconstruction is
impossible (a flat-padded leaf has no rows, more rows are corrupted than
there are samples, or the residual is over tolerance) :func:`repair_leaf`
quarantines instead: the twin replaces the leaf. Either way the returned
leaf decodes clean.

As in the reference the solves run in NumPy float64 on the host, with the
same generator draws, so a kit's probes and its repaired rows are the
reference's bit for bit; its responses ``x @ q`` go through BLAS
(``np.matmul``) where the reference's ``einsum`` sums in another order,
within ~1e-11 relative (seconds instead of minutes for a full-width
model's embedding and head). The decodes and encodes run on the leaf's
device and route.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import ecc, wot

from .backends import get_backend
from .schemes import get_scheme
from .tensor import ProtectedTensor, is_protected_tensor

__all__ = ["LeafKit", "RepairKit", "build_repair_kit", "repair_leaf",
           "repair_tree", "due_block_mask"]

_REPAIRABLE = ("in-place", "secded72")   # schemes with localizable DUEs


def due_block_mask(pt: ProtectedTensor, *, backend="torch"):
    """Decode a leaf's stored image with per-block flags.

    -> ``(q, double)`` as NumPy: the decoded int8 image (``pt.enc``'s
    shape; garbage inside DUE blocks) and the bool DUE mask over 8-byte
    blocks, shape ``(*enc.shape[:-1], enc.shape[-1] // 8)``: where a leaf
    has a DUE, not only that it has one."""
    if pt.scheme_id not in _REPAIRABLE:
        raise ValueError(f"scheme {pt.scheme_id!r} has no localizable DUE "
                         f"(one of {_REPAIRABLE})")
    enc = pt.enc
    blocks = enc.reshape(*enc.shape[:-1], enc.shape[-1] // 8, 8)
    if pt.scheme_id == "in-place":
        dec, _, double = get_backend(backend).decode64(blocks)
    else:
        dec, _, double = ecc.decode72(blocks, pt.checks)
    q = dec.reshape(enc.shape).view(torch.int8)
    return q.cpu().numpy(), double.cpu().numpy().astype(bool)


@dataclasses.dataclass(frozen=True)
class LeafKit:
    """Pinned calibration of one leaf.

    x:    (n_samples, K) float64 probe inputs (None when the leaf has no
          row structure: quarantine is its only recovery).
    y:    the clean response ``x @ q`` in float64: (n, N) for a 2-D leaf,
          (L, n, N) per stacked layer (None when x is None).
    twin: ``secded72`` encode of the clean image, or None (``twins=False``).
    """

    x: Optional[np.ndarray]
    y: Optional[np.ndarray]
    twin: Optional[ProtectedTensor]

    @property
    def solvable(self) -> bool:
        return self.x is not None


@dataclasses.dataclass(frozen=True)
class RepairKit:
    """Per-path :class:`LeafKit` map and the knobs repair runs under."""

    entries: dict
    n_samples: int
    tol: float

    def __contains__(self, path: str) -> bool:
        return path in self.entries

    def __len__(self) -> int:
        return len(self.entries)


def build_repair_kit(enc_tree, *, seed: int = 0, n_samples: int = 32,
                     tol: float = 1e-3, backend="torch",
                     twins: bool = True) -> RepairKit:
    """Pin (x, y) probe pairs and ``secded72`` twins from a CLEAN tree
    (raises ``ValueError`` on a tree with a DUE). Same-shape 2-D and
    stacked 3-D leaves get a solvable kit, flat-padded ones twin-only
    coverage. ``seed`` drives a NumPy generator of its own, drawn leaf by
    leaf in tree order, as the reference draws it."""
    rng = np.random.default_rng(seed)
    entries = {}
    for path, leaf in tree.leaves_with_path(enc_tree):
        if not is_protected_tensor(leaf) or leaf.scheme_id not in _REPAIRABLE:
            continue
        q, double = due_block_mask(leaf, backend=backend)
        if double.any():
            raise ValueError(f"{tree.path_str(path)}: tree has DUEs — a "
                             "repair kit must be pinned from a clean tree")
        twin = None
        if twins:
            enc_t, checks_t = get_scheme("secded72").encode(
                torch.from_numpy(q).to(leaf.enc.device), backend)
            twin = ProtectedTensor(enc=enc_t, checks=checks_t,
                                   scale=leaf.scale, scheme_id="secded72",
                                   orig_shape=tuple(leaf.orig_shape))
        x = y = None
        if not leaf.is_flat and q.ndim in (2, 3):
            x = rng.standard_normal((n_samples, q.shape[-2]))
            y = x @ q.astype(np.float64)    # (n, N) or (L, n, N)
        entries[tree.path_str(path)] = LeafKit(x=x, y=y, twin=twin)
    return RepairKit(entries=entries, n_samples=n_samples, tol=tol)


def _solve_rows(x, y, q, rows, requires_wot):
    """Rows ``rows`` of one (K, N) int8 matrix from the pinned (x, y) pair:
    float64 least squares, rounded, WOT-clamped when the scheme needs
    bit 6 free. -> the repaired int8 matrix."""
    ok = ~rows
    a = x[:, rows]                                       # (n, r)
    b = y - x[:, ok] @ q[ok].astype(np.float64)          # (n, N)
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)          # (r, N)
    rec = np.clip(np.rint(sol), -127, 127).astype(np.int8)
    if requires_wot:
        rec = wot.throttle_q(torch.from_numpy(rec.reshape(-1))).numpy(
        ).reshape(rec.shape)
    out = q.copy()
    out[rows] = rec
    return out


def repair_leaf(pt: ProtectedTensor, kit: LeafKit, *,
                tol: Optional[float] = None, n_samples: Optional[int] = None,
                backend="torch"):
    """Repair one DUE-carrying leaf -> ``(new_pt, report)``.

    ``report["status"]``: "clean" (no DUE, leaf unchanged), "repaired"
    (the solve's residual is under ``tol``: re-encoded under the same
    scheme, bit-equal to the pre-fault image when the solve is
    determined), "quarantined" (the ``secded72`` twin replaces the leaf)
    or "unrecoverable" (no solve and no twin: leaf unchanged)."""
    q, double = due_block_mask(pt, backend=backend)
    report = {"scheme": pt.scheme_id, "due_blocks": int(double.sum()),
              "rows": 0, "residual": None}
    if not double.any():
        report["status"] = "clean"
        return pt, report

    def quarantine():
        if kit.twin is None:
            report["status"] = "unrecoverable"
            return pt, report
        report["status"] = "quarantined"
        return kit.twin, report

    if not kit.solvable:
        return quarantine()
    limit = n_samples if n_samples is not None else kit.x.shape[0]
    requires_wot = get_scheme(pt.scheme_id).requires_wot
    x, y = kit.x, kit.y
    stacked = q.ndim == 3
    out_layers = []
    worst = 0.0
    n_rows = 0
    for ql, yl, dl in zip(q if stacked else q[None], y if stacked else y[None],
                          double if stacked else double[None]):
        rows = dl.any(axis=-1)                    # (K,) DUE rows
        n_rows += int(rows.sum())
        if not rows.any():
            out_layers.append(ql)
            continue
        if int(rows.sum()) > limit:
            report["rows"] = n_rows
            return quarantine()
        fixed = _solve_rows(x, yl, ql, rows, requires_wot)
        resid = np.abs(x @ fixed.astype(np.float64) - yl)
        worst = max(worst, float(resid.max() / (np.abs(yl).max() + 1e-12)))
        out_layers.append(fixed)
    report["rows"] = n_rows
    report["residual"] = worst
    if worst > (tol if tol is not None else 1e-3):
        return quarantine()
    q_new = np.stack(out_layers) if stacked else out_layers[0]
    enc, checks = get_scheme(pt.scheme_id).encode(
        torch.from_numpy(q_new).to(pt.enc.device), backend)
    report["status"] = "repaired"
    return ProtectedTensor(enc=enc, checks=checks, scale=pt.scale,
                           scheme_id=pt.scheme_id,
                           orig_shape=tuple(pt.orig_shape)), report


def repair_tree(enc_tree, kit: RepairKit, *, paths=None, backend="torch"):
    """Repair every kit-covered leaf in ``paths`` (default: all covered
    leaves) that carries a DUE -> ``(new_tree, reports)``, one ``{path,
    status, rows, residual, due_blocks, scheme}`` per leaf found dirty."""
    want = None if paths is None else set(paths)
    reports = []

    def fix(path, leaf):
        p = tree.path_str(path)
        if (not is_protected_tensor(leaf) or p not in kit.entries
                or (want is not None and p not in want)
                or leaf.scheme_id not in _REPAIRABLE):
            return leaf
        new_leaf, rep = repair_leaf(leaf, kit.entries[p], tol=kit.tol,
                                    backend=backend)
        if rep["status"] == "clean":
            return leaf
        reports.append({"path": p, **rep})
        return new_leaf

    return tree.map_with_path(fix, enc_tree), reports

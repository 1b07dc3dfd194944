"""Scrub and rolling plan migration: the self-healing loop.

Counterpart of ``repro.serving.scrubber``. The paper's in-place (64,57,1)
code corrects a single flipped bit only when the weight is decoded;
nothing writes the corrected bytes back, so under serve traffic
correctable errors stay in memory until a second hit in the same 8-byte
block turns them into a DUE. Two host-driven actors close the loop, each
budgeted per serve step:

``Scrubber``
    Walks the encoded weight tree and the live KV pages (``leaves_per_step``
    / ``pages_per_step`` a call): decode, re-encode, write back, so the
    corrections land. Two safety rules:

    * a leaf, or a (layer, page) slab of the KV pools, that decodes with a
      DUE is NEVER written back: re-encoding would compute checks
      consistent with the corruption and erase the detection. It is
      reported instead (``due_paths``, the KV ``due_slabs``) for
      :mod:`repro_torch.protection.repair`.
    * free and parking pages have known content (zero), so
      :meth:`Scrubber.scrub_free` re-zeroes them, clearing even DUE
      patterns.

    A clean codeword decodes and re-encodes to the same bytes, so scrubbing
    a clean leaf leaves every bit as it was. On the ``cuda`` route an
    in-place leaf or page scrubs through the ``ecc_decode`` and
    ``ecc_encode`` kernels.

``Migrator``
    Drains a :meth:`ProtectionPlan.diff` a few leaves a step while serving
    (``ProtectionPlan.migrate_step``); the serve step keeps working across
    the swap, its decode dispatching on each ``ProtectedTensor.scheme_id``.

Both are synchronous with the serve loop ("background" means budgeted per
step), so a seeded run stays deterministic. Weight scrubs return new
leaves, as the reference's do; KV scrubs write the pools IN PLACE, as the
port's cache updates do everywhere.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.protection.schemes import get_scheme
from repro_torch.protection.tensor import ProtectedTensor, is_protected_tensor

from . import kvcache

__all__ = ["Scrubber", "Migrator", "scrub_tree", "scrub_leaf"]


def scrub_leaf(pt: ProtectedTensor, backend="torch") -> tuple:
    """Decode one leaf and, unless it has a DUE, re-encode it.
    -> ``(leaf, corrected, due)``: a new leaf over the re-encoded image, or
    ``pt`` itself when a DUE forbids the write-back."""
    sch = get_scheme(pt.scheme_id)
    q, cor, due = sch.decode_with_flags(pt.enc, pt.checks, backend)
    cor, due = torch.stack([cor, due]).tolist()
    if due:
        return pt, cor, due
    enc, checks = sch.encode(q, backend)
    return ProtectedTensor(enc=enc, checks=checks, scale=pt.scale,
                           scheme_id=pt.scheme_id,
                           orig_shape=tuple(pt.orig_shape)), cor, due


def _scrubbable(leaf) -> bool:
    """Protected leaves whose scheme stores a codeword ("faulty" stores raw
    bytes: nothing to correct, nothing to write back)."""
    return is_protected_tensor(leaf) and leaf.scheme_id != "faulty"


def scrub_tree(enc_tree, *, backend="torch"):
    """One full pass over every protected leaf (no budget, no cursor) ->
    ``(new_tree, stats)``: the at-rest check after a run drains."""
    return Scrubber(leaves_per_step=0, backend=backend).scrub_weights(
        enc_tree, n=-1)


class Scrubber:
    """Budgeted decode -> re-encode -> write-back over weights and KV pages,
    with two wrap-around cursors (weight leaf, KV work list) so successive
    calls cover the whole tree and pool round robin whatever the budget."""

    def __init__(self, *, leaves_per_step: int = 1, pages_per_step: int = 4,
                 backend="torch"):
        if leaves_per_step < 0 or pages_per_step < 0:
            raise ValueError("scrub budgets must be >= 0")
        self.leaves_per_step = leaves_per_step
        self.pages_per_step = pages_per_step
        self.backend = backend
        self._wcur = 0          # weight-leaf cursor
        self._pcur = 0          # KV work-list cursor

    def scrub_weights(self, enc_tree, *, n: Optional[int] = None):
        """Scrub the next ``n`` protected leaves (default the per-step
        budget; ``n=-1`` every leaf) -> ``(new_tree, stats)``, stats
        ``scanned / corrected / due / wrote / due_paths`` (``due_paths``:
        the leaves left for repair, in tree order)."""
        flat = list(tree.leaves_with_path(enc_tree))
        idxs = [i for i, (_, leaf) in enumerate(flat) if _scrubbable(leaf)]
        stats = {"scanned": 0, "corrected": 0, "due": 0, "wrote": 0,
                 "due_paths": []}
        if not idxs:
            return enc_tree, stats
        budget = self.leaves_per_step if n is None else n
        budget = len(idxs) if budget < 0 else min(budget, len(idxs))
        if budget == 0:
            return enc_tree, stats
        leaves = [leaf for _, leaf in flat]
        start = self._wcur % len(idxs)
        for j in range(budget):
            i = idxs[(start + j) % len(idxs)]
            leaves[i], cor, due = scrub_leaf(leaves[i], self.backend)
            stats["scanned"] += 1
            stats["corrected"] += cor
            stats["due"] += due
            if due:
                stats["due_paths"].append(tree.path_str(flat[i][0]))
            else:
                stats["wrote"] += 1
        self._wcur = (start + budget) % len(idxs)
        return tree.unflatten_like(enc_tree, leaves), stats

    def scrub_kv(self, cache: dict, policy, *, occupied, busy=(),
                 n: Optional[int] = None):
        """Scrub the next ``n`` live pages (default the per-step budget;
        ``n=-1`` the whole work list) IN PLACE. ``occupied`` is the live
        page list (``PageAllocator.live_pages``); ``busy`` pages, the
        in-flight slots' current write targets, are skipped this pass.
        -> ``(cache, stats)`` with ``scanned / corrected / due /
        due_slabs`` (a slab is one layer x page write-back unit)."""
        stats = {"scanned": 0, "corrected": 0, "due": 0, "due_slabs": 0}
        policy = kvcache.get_kv_policy(policy)
        if policy.scheme == "faulty":
            return cache, stats
        work = sorted(set(occupied) - set(busy))
        if not work:
            return cache, stats
        budget = self.pages_per_step if n is None else n
        budget = len(work) if budget < 0 else min(budget, len(work))
        if budget == 0:
            return cache, stats
        start = self._pcur % len(work)
        ids = [work[(start + j) % len(work)] for j in range(budget)]
        self._pcur = (start + budget) % len(work)
        sch = policy.scheme_obj
        idx = torch.tensor(ids, dtype=torch.long,
                           device=cache["k_pages"].device)
        totals = []
        for name in ("k", "v"):
            pool = cache[f"{name}_pages"]
            checks = cache.get(f"{name}_checks")
            enc = pool[:, idx]                       # (nl, n, ps, kv, hd)
            ch = None if checks is None else checks[:, idx]
            q, cor, due = kvcache._decode_kv(enc, ch, sch.scheme_id,
                                             self.backend)
            new_enc, new_ch = sch.encode(q, self.backend)
            bad = due.sum(dim=-1) > 0                # (nl, n) slab DUE
            keep = bad[:, :, None, None, None]
            pool[:, idx] = torch.where(keep, enc, new_enc)
            if checks is not None:
                checks[:, idx] = torch.where(keep, ch, new_ch)
            totals += [cor.sum(), due.sum(), bad.sum()]
        kc, kd, kb, vc, vd, vb = torch.stack(totals).tolist()
        stats.update(scanned=len(ids), corrected=kc + vc, due=kd + vd,
                     due_slabs=kb + vb)
        return cache, stats

    def scrub_free(self, cache: dict, alloc) -> dict:
        """Re-zero every free and parking page IN PLACE: unlike decoding,
        this clears even DUE patterns ("free means zero")."""
        ids = tuple(range(alloc.reserved)) + alloc.free_pages()
        return kvcache.zero_pages(cache, ids) if ids else cache


class Migrator:
    """Drains ``plan.diff(target)`` a few leaves a step, while serving.

    ``pending`` holds the scheme-change paths in plan order; :meth:`step`
    promotes the next ``leaves_per_step`` through
    ``ProtectionPlan.migrate_step``; ``self.plan`` always reflects the
    promotions so far and ``records`` one ``{path, from, to, corrected,
    due}`` per promoted leaf."""

    def __init__(self, plan, target, *, leaves_per_step: int = 1):
        if leaves_per_step < 1:
            raise ValueError("leaves_per_step must be >= 1")
        self.diff = plan.diff(target)
        self.pending = list(self.diff.paths)
        self.plan = plan
        self.target = target
        self.leaves_per_step = leaves_per_step
        self.records: list = []

    @property
    def done(self) -> bool:
        return not self.pending

    @property
    def promoted(self) -> int:
        return len(self.records)

    def step(self, enc_tree):
        """Promote the next batch -> ``(new_tree, records)`` (empty once
        the migration has drained)."""
        if not self.pending:
            return enc_tree, []
        batch = self.pending[:self.leaves_per_step]
        self.pending = self.pending[self.leaves_per_step:]
        enc_tree, self.plan, recs = self.plan.migrate_step(
            enc_tree, self.target, batch)
        self.records.extend(recs)
        return enc_tree, recs

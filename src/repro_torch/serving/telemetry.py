"""JSONL telemetry of the request-level serving front-end.

Counterpart of ``repro.serving.telemetry``, with the same event schema and
the same summary schema strings, so the reference's loader reads the
port's files and the two front-ends' event streams compare field by
field. The front-end (:mod:`repro_torch.serving.frontend`) emits one flat
JSON event per lifecycle transition plus one per serve step; this module
owns the event stream (:class:`TelemetryCollector`), the determinism
contract (:func:`deterministic_view`) and the roll-up into SLO-facing
numbers (:func:`summarize`).

Determinism contract
--------------------
Every event field derives from the logical step counter — the
deterministic clock — EXCEPT wall-clock measurements, suffixed ``_s``
(seconds) or ``_ms`` (milliseconds). ``deterministic_view`` strips exactly
those fields; two runs of the same seeded burst must give identical
deterministic views, while the wall fields feed the latency percentiles.

Events
------
========== =================================================================
event      fields
========== =================================================================
init       slots, n_pages, pool_free, page_size, max_len, scheme, fused,
           attention_impl, per_slot_flags, prefix_sharing, scrub_every,
           repair
enqueue    rid, step, prompt_len, max_new, [t_s]
reject     rid, step, reason
admit      rid, step, slot, n_pages, queue_depth, pool_free; with prefix
           sharing also n_pages_solo, pages_shared, tokens_reused,
           cow_copied
cow        rid, step, slot, src, dst  (a shared page got a private clone)
first_token rid, step, slot, ttft_steps, [ttft_s]
finish     rid, step, slot, n_generated, kv_corrected, kv_due, pool_free,
           [ttft_s, tpot_ms]; when the plan guards matmuls and the request
           saw hits, also abft_mismatches, clamp_hits
step       step, active, queue_depth, pool_free, pool_cached,
           kv_corrected, kv_due, w_corrected, w_due, [step_ms]; with a
           guarded plan also abft_mismatches, clamp_hits
========== =================================================================

The reference's self-healing events (scrub, scrub_final, migrate, repair)
keep their roll-up here, so a summary has the same shape; the port's
front-end does not emit them yet. ``pool_cached`` counts prefix-cache-held
pages; the leak check is ``initial_free - final_free - final_cached ==
0``.
"""

from __future__ import annotations

import csv
import json
import math
from typing import IO, Optional

__all__ = [
    "TelemetryCollector", "deterministic_view", "percentile",
    "summarize", "write_summary", "load_summary", "write_requests_csv",
    "SUMMARY_SCHEMA", "SUPPORTED_SCHEMAS",
]

# v2 adds the ``healing`` roll-up (scrub / migrate / repair totals and the
# residual at-rest DUE state); v1 summaries still load via load_summary.
# The ``abft`` roll-up (compute-fault mismatches + clamp hits) extends v2
# ADDITIVELY — abft-less event streams roll up to all-zero counts, so v2
# consumers keep working and no v3 fork is needed.
SUMMARY_SCHEMA = "burst_sim/v2"
SUPPORTED_SCHEMAS = ("burst_sim/v1", "burst_sim/v2")

_WALL_SUFFIXES = ("_s", "_ms")


class TelemetryCollector:
    """Accumulates events in order; optionally streams them to a JSONL
    file as they arrive. Events are plain dicts with an ``event`` type
    key — see the module docstring for the vocabulary."""

    def __init__(self, path: Optional[str] = None):
        self.events: list = []
        self._fh: Optional[IO] = open(path, "w") if path else None

    def emit(self, event: str, **fields) -> dict:
        rec = {"event": event, **fields}
        self.events.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def deterministic_view(events) -> list:
    """Strip wall-clock fields (``*_s`` / ``*_ms``) — what's left must be
    bit-identical across two runs of the same seeded burst."""
    return [{k: v for k, v in e.items()
             if not k.endswith(_WALL_SUFFIXES)} for e in events]


def percentile(xs, q: float):
    """Nearest-rank percentile (deterministic, no interpolation):
    the smallest x such that at least ``q``% of samples are <= x."""
    if not xs:
        return None
    xs = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def _pcts(xs) -> dict:
    return {"p50": percentile(xs, 50), "p95": percentile(xs, 95),
            "p99": percentile(xs, 99)}


def summarize(events) -> dict:
    """Roll an event stream up into the burst summary: throughput,
    p50/p95/p99 TTFT and per-token latency, queue depth, per-request DUE,
    and the page-pool accounting (leaked == initial free - final free)."""
    by = {}
    for e in events:
        by.setdefault(e["event"], []).append(e)
    steps = by.get("step", [])
    finishes = by.get("finish", [])
    n_gen = sum(f["n_generated"] for f in finishes)
    wall = sum(s.get("step_ms", 0.0) for s in steps) / 1e3
    due_per_req = [f["kv_due"] for f in finishes]
    init = by.get("init", [])
    pool0 = init[0]["pool_free"] if init else (
        steps[0]["pool_free"] if steps else None)
    pool1 = steps[-1]["pool_free"] if steps else None
    cached = steps[-1].get("pool_cached", 0) if steps else 0
    admits = by.get("admit", [])
    peak_in_use = max(((pool0 - s["pool_free"]) for s in steps),
                      default=0) if pool0 is not None else None
    return {
        "schema": SUMMARY_SCHEMA,
        "requests": {
            "submitted": len(by.get("enqueue", [])),
            "finished": len(finishes),
            "rejected": len(by.get("reject", [])),
        },
        "steps": len(steps),
        "gen_tokens": n_gen,
        "throughput": {
            "tokens_per_step": (n_gen / len(steps)) if steps else 0.0,
            "tokens_per_s": (n_gen / wall) if wall > 0 else None,
        },
        "ttft_steps": _pcts([f["ttft_steps"]
                             for f in by.get("first_token", [])]),
        "ttft_s": _pcts([f["ttft_s"] for f in by.get("first_token", [])
                         if "ttft_s" in f]),
        "per_token_ms": _pcts([f["tpot_ms"] for f in finishes
                               if "tpot_ms" in f]),
        "queue_depth": {
            "max": max((s["queue_depth"] for s in steps), default=0),
            "mean": (sum(s["queue_depth"] for s in steps) / len(steps))
                    if steps else 0.0,
        },
        "due": {
            "total": sum(due_per_req),
            "corrected_total": sum(f["kv_corrected"] for f in finishes),
            "max_per_request": max(due_per_req, default=0),
            "requests_with_due": sum(1 for d in due_per_req if d > 0),
        },
        "pool": {
            "initial_free": pool0,
            "final_free": pool1,
            "cached_pages": cached,
            "peak_pages_in_use": peak_in_use,
            # cached pages are referenced on purpose (the prefix index
            # pins them) — everything else must have come back
            "leaked_pages": (pool0 - pool1 - cached)
                            if pool0 is not None else None,
        },
        "sharing": {
            "pages_shared": sum(a.get("pages_shared", 0) for a in admits),
            "tokens_reused": sum(a.get("tokens_reused", 0)
                                 for a in admits),
            "cow_copies": len(by.get("cow", [])),
            "pages_allocated_total": sum(a["n_pages"] for a in admits),
            "solo_pages_total": sum(a.get("n_pages_solo", a["n_pages"])
                                    for a in admits),
        },
        "healing": _healing_rollup(by),
        "abft": _abft_rollup(steps, finishes),
    }


def _abft_rollup(steps, finishes) -> dict:
    """Additive v2 extension: the compute-fault (ABFT) channel. Step
    events carry per-step mismatch/clamp totals; finish events carry the
    per-request attribution. Streams from abft-less runs roll up to all
    zeros — same summary shape either way, no schema fork."""
    mm_req = [f.get("abft_mismatches", 0) for f in finishes]
    return {
        "mismatches_total": sum(s.get("abft_mismatches", 0) for s in steps),
        "clamp_hits_total": sum(s.get("clamp_hits", 0) for s in steps),
        "max_per_request": max(mm_req, default=0),
        "requests_with_mismatch": sum(1 for m in mm_req if m > 0),
        "requests_with_clamp": sum(
            1 for f in finishes if f.get("clamp_hits", 0) > 0),
    }


def _healing_rollup(by: dict) -> dict:
    """The v2 self-healing roll-up: scrub totals, migration progress,
    repair outcomes, and the residual at-rest DUE state from the final
    full pass (None when the run never scrubbed at the end)."""
    scrubs = by.get("scrub", [])
    repairs = by.get("repair", [])
    promotes = [m for m in by.get("migrate", [])
                if m.get("phase") == "promote"]
    finals = by.get("scrub_final", [])
    statuses = {}
    for r in repairs:
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    return {
        "scrub_passes": len(scrubs),
        "w_scanned": sum(s["w_scanned"] for s in scrubs),
        "w_corrected": sum(s["w_corrected"] for s in scrubs),
        "kv_scanned": sum(s["kv_scanned"] for s in scrubs),
        "kv_corrected": sum(s["kv_corrected"] for s in scrubs),
        "due_leaves_seen": sum(s["w_due"] for s in scrubs),
        "repairs": statuses,
        "migrated_leaves": len(promotes),
        "final_due": ({"w": finals[-1]["w_due"],
                       "kv": finals[-1]["kv_due"],
                       "w_corrected": finals[-1]["w_corrected"],
                       "kv_corrected": finals[-1]["kv_corrected"],
                       "w_repaired": finals[-1]["w_repaired"]}
                      if finals else None),
    }


def write_summary(summary: dict, path: str):
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")


def load_summary(path: str) -> dict:
    """Load a burst summary, accepting every schema in
    ``SUPPORTED_SCHEMAS``. v1 summaries (pre-healing) are upgraded in
    memory — ``healing`` becomes None so v2 consumers can branch on it —
    and keep their original ``schema`` string so provenance is visible."""
    with open(path) as fh:
        s = json.load(fh)
    schema = s.get("schema")
    if schema not in SUPPORTED_SCHEMAS:
        raise ValueError(f"unsupported burst summary schema {schema!r} "
                         f"(supported: {SUPPORTED_SCHEMAS})")
    if schema == "burst_sim/v1":
        s.setdefault("healing", None)
    # pre-ABFT summaries (either schema) lack the additive abft roll-up
    s.setdefault("abft", None)
    return s


def write_requests_csv(events, path: str):
    """One CSV row per request joining its lifecycle events — the
    analytics-friendly flat view next to the summary JSON."""
    rows: dict = {}
    for e in events:
        rid = e.get("rid")
        if rid is None:
            continue
        row = rows.setdefault(rid, {"rid": rid})
        ev = e["event"]
        if ev == "enqueue":
            row.update(enqueue_step=e["step"], prompt_len=e["prompt_len"],
                       max_new=e["max_new"])
        elif ev == "reject":
            row.update(rejected=1, reject_reason=e["reason"])
        elif ev == "admit":
            row.update(admit_step=e["step"], slot=e["slot"],
                       n_pages=e["n_pages"],
                       pages_shared=e.get("pages_shared"),
                       tokens_reused=e.get("tokens_reused"),
                       cow_copied=e.get("cow_copied"))
        elif ev == "first_token":
            row.update(first_token_step=e["step"],
                       ttft_steps=e["ttft_steps"],
                       ttft_s=e.get("ttft_s"))
        elif ev == "finish":
            row.update(finish_step=e["step"], n_generated=e["n_generated"],
                       kv_corrected=e["kv_corrected"], kv_due=e["kv_due"],
                       abft_mismatches=e.get("abft_mismatches"),
                       clamp_hits=e.get("clamp_hits"),
                       tpot_ms=e.get("tpot_ms"))
    fields = ["rid", "enqueue_step", "prompt_len", "max_new", "rejected",
              "reject_reason", "admit_step", "slot", "n_pages",
              "pages_shared", "tokens_reused", "cow_copied",
              "first_token_step", "ttft_steps", "ttft_s", "finish_step",
              "n_generated", "kv_corrected", "kv_due", "abft_mismatches",
              "clamp_hits", "tpot_ms"]
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=fields, restval="")
        w.writeheader()
        for rid in sorted(rows):
            w.writerow(rows[rid])

"""Request-level serving front-end: slot-based continuous batching over
the paged protected KV cache.

Counterpart of ``repro.serving.frontend``: a :class:`RequestQueue` with
admission control, a per-slot lifecycle (prefill -> decode -> finish,
pages freed back to the pool and zeroed) and a seeded burst driver
(:func:`make_waves`, :func:`run_burst`), all through ONE serve step
(``serving.protected.make_serve_step``) over a churning request mix.

* **One step.** Prefill is fed token by token through the decode step: an
  active slot's next input token is ``prompt[consumed]`` while the prompt
  lasts, then its own last sampled token; ``pos = consumed``. The step
  that consumes the LAST prompt token yields the first generated token.
* **Parking pages.** Pool pages ``0..slots-1`` are reserved, one per slot
  (``kvcache.init_paged_cache(..., n_pages=)``); an idle slot's table row
  points wholly at its own parking page, so its keep-alive token (pos 0)
  never touches a live request's pages.
* **Determinism.** Greedy argmax sampling, FIFO admission, lowest-id-first
  page allocation, fault injection seeded from ``fault_seed`` and the
  logical step: a seeded replay gives the same
  ``telemetry.deterministic_view``.
* **Per-request fault attribution.** The front-end forces
  ``per_slot_flags`` on every KV policy, so ``flags["layers_kv"]`` is
  (n_layers, 2, B) and each finish event carries the (corrected, DUE)
  counts of that request's cached tokens; with a guarded plan the ABFT
  rows are per slot too (``abft_mismatches`` / ``clamp_hits``).
* **Prefix sharing + copy-on-write.** With ``prefix_sharing=True`` an index
  maps each published full-page prompt prefix (keyed by the ENTIRE token
  prefix through that page) to its page; admission maps hits into the new
  slot's table through allocator refcounts and skips their prefill steps.
  A prompt ending exactly on a shared page boundary re-consumes its last
  token and therefore writes into the last shared page, which gets a
  private copy-on-write clone. Pages re-enter the pool (zeroed) only when
  their last reference drops; under pool pressure admission evicts cached
  pages least-recently-hit first.

* **Self-healing.** With ``scrub_every > 0`` each matching step runs a
  budgeted scrub pass (:mod:`repro_torch.serving.scrubber`) over the
  encoded weights and the live KV pages BEFORE the serve compute, so
  corrected bits land before anything decodes them; weight leaves the
  scrub refuses to write back (DUE) go to MILR repair or quarantine when a
  ``repair_kit`` is attached. :meth:`ServingFrontend.start_migration`
  drains a plan diff leaf by leaf between steps, and
  :meth:`ServingFrontend.final_scrub` checks the at-rest state after the
  run. All of it emits ``scrub`` / ``migrate`` / ``repair`` /
  ``scrub_final`` telemetry within the determinism contract.

The port updates the cache IN PLACE where the reference returns new
arrays.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.models.config import ArchConfig
from repro_torch.protection import policy as policy_mod
from repro_torch.protection import repair as repair_mod

from . import kvcache, scrubber, telemetry
from . import protected as sp

__all__ = ["Request", "RequestQueue", "ServingFrontend", "make_waves",
           "run_burst"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: up to ``max_new`` tokens after ``prompt``;
    ``arrival_step`` is the logical step the burst driver submits it at."""
    rid: int
    prompt: tuple
    max_new: int
    arrival_step: int = 0

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new


class RequestQueue:
    """FIFO admission queue. ``push`` rejects what can NEVER be served (past
    the per-slot table or the allocatable pool); transient exhaustion
    just queues."""

    def __init__(self, max_total_tokens: int, max_pages: int,
                 page_size: int):
        self.max_total_tokens = max_total_tokens
        self.max_pages = max_pages
        self.page_size = page_size
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def reject_reason(self, req: Request) -> Optional[str]:
        if req.total_tokens > self.max_total_tokens:
            return (f"prompt+max_new {req.total_tokens} exceeds max_len "
                    f"{self.max_total_tokens}")
        need = kvcache.pages_needed(req.total_tokens, self.page_size)
        if need > self.max_pages:
            return (f"needs {need} pages, pool only has "
                    f"{self.max_pages} allocatable")
        return None

    def push(self, req: Request) -> Optional[str]:
        """Queue ``req``, or return why it can never be admitted."""
        reason = self.reject_reason(req)
        if reason is None:
            self._q.append(req)
        return reason

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def pop(self) -> Request:
        return self._q.popleft()


class _Slot:
    """Mutable per-slot lifecycle state (host side)."""

    __slots__ = ("req", "consumed", "generated", "pages", "enqueue_step",
                 "admit_step", "first_step", "enqueue_s", "first_s",
                 "kv_corrected", "kv_due", "abft_mismatches", "clamp_hits")

    def __init__(self, req: Request, pages, step: int, enqueue_step: int,
                 enqueue_s: float):
        self.req = req
        self.consumed = 0
        self.generated: list = []
        self.pages = pages
        self.enqueue_step = enqueue_step
        self.admit_step = step
        self.first_step: Optional[int] = None
        self.enqueue_s = enqueue_s
        self.first_s: Optional[float] = None
        self.kv_corrected = 0
        self.kv_due = 0
        self.abft_mismatches = 0
        self.clamp_hits = 0


class ServingFrontend:
    """Continuous-batching loop: :meth:`submit` requests, call :meth:`step`
    (or :meth:`run`) until drained. Emits telemetry throughout; finished
    requests land in :attr:`results` as ``{rid: [token, ...]}``. After each
    step :attr:`last_flags` holds that step's flags dict (on the device)
    and :attr:`last_active` the slots that served a request in it.

    ``backend`` routes the weight and KV codecs, the scrub and the
    attention ("cuda": the kernels; default: the kernels on the card, the
    plain route on the CPU); ``device`` defaults to the card.
    ``scrub_every`` (0: off) scrubs ``scrub_weight_leaves`` weight leaves
    and ``scrub_kv_pages`` live pages every that many steps;
    ``repair_kit`` (``protection.repair.build_repair_kit``) repairs the
    weight leaves a scrub finds with a DUE."""

    def __init__(self, cfg: ArchConfig, enc_params, *, plan=None,
                 slots: int = 4, max_len: int = 128,
                 n_pages: Optional[int] = None, kv_policy="in-place",
                 serve_step=None, collector=None, dtype=torch.bfloat16,
                 act_quant: Optional[str] = None,
                 prefix_sharing: bool = False, scrub_every: int = 0,
                 scrub_weight_leaves: int = 1, scrub_kv_pages: int = 4,
                 repair_kit=None, backend=None, device=None):
        if scrub_every < 0:
            raise ValueError("scrub_every must be >= 0")
        self.device = device_mod.resolve(device)
        if backend is None:
            backend = device_mod.default_backend(self.device)
        self.backend = backend
        kvp = kvcache.get_kv_policy(kv_policy)
        # per-request attribution on every path (see the module docstring)
        kvp = dataclasses.replace(kvp, per_slot_flags=True)
        self.cfg, self.policy, self.slots_n = cfg, kvp, slots
        self.plan = plan
        self.prefix_sharing = bool(prefix_sharing)
        self._prefix_index: dict = {}   # full-prefix tokens -> page id
        self._published: dict = {}      # page id -> its index key
        self._prefix_meta: dict = {}    # index key -> [last_hit, seq]
        self._prefix_seq = 0
        npg = kvcache.pages_per_seq(max_len, kvp.page_size)
        self.max_len = npg * kvp.page_size
        if n_pages is None:
            n_pages = slots + slots * npg      # parking + full occupancy
        self.cache = kvcache.init_paged_cache(cfg, slots, self.max_len, kvp,
                                              n_pages=n_pages,
                                              device=self.device)
        self.allocator = kvcache.PageAllocator(n_pages, reserved=slots)
        self.queue = RequestQueue(self.max_len, self.allocator.free_count,
                                  kvp.page_size)
        if serve_step is None:
            serve_step = sp.make_serve_step(cfg, plan=plan, backend=backend,
                                            kv_policy=kvp, dtype=dtype,
                                            act_quant=act_quant)
        self.serve_step = serve_step
        self.enc_params = enc_params
        self.telemetry = collector or telemetry.TelemetryCollector()
        self.step_no = 0
        self.results: dict = {}
        self.last_flags: Optional[dict] = None
        self.last_active: tuple = ()
        self._slots: list = [None] * slots
        self._pending_meta: dict = {}   # rid -> (enqueue_step, enqueue_s)
        self.scrub_every = scrub_every
        self.repair_kit = repair_kit
        self.scrubber = scrubber.Scrubber(
            leaves_per_step=scrub_weight_leaves,
            pages_per_step=scrub_kv_pages, backend=backend)
        self._migrator: Optional[scrubber.Migrator] = None
        self._migrate_every = 1
        self.telemetry.emit("init", slots=slots, n_pages=n_pages,
                            pool_free=self.allocator.free_count,
                            page_size=kvp.page_size, max_len=self.max_len,
                            scheme=kvp.scheme, fused=kvp.fused,
                            attention_impl=kvp.attention_impl,
                            per_slot_flags=kvp.per_slot_flags,
                            prefix_sharing=self.prefix_sharing,
                            scrub_every=scrub_every,
                            repair=repair_kit is not None)

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request):
        now = time.perf_counter()
        reason = self.queue.push(req)
        if reason is not None:
            self.telemetry.emit("reject", rid=req.rid, step=self.step_no,
                                reason=reason)
            return
        self._pending_meta[req.rid] = (self.step_no, now)
        self.telemetry.emit("enqueue", rid=req.rid, step=self.step_no,
                            prompt_len=len(req.prompt),
                            max_new=req.max_new, t_s=now)

    # -- prefix sharing ----------------------------------------------------

    def _lookup_shared(self, prompt) -> tuple:
        """Longest run of published full-page prefixes of ``prompt``
        (matched on the entire token prefix through each page)."""
        ps = self.policy.page_size
        pids, j = [], 1
        while j * ps <= len(prompt):
            key = tuple(prompt[:j * ps])
            pid = self._prefix_index.get(key)
            if pid is None:
                break
            self._prefix_meta[key][0] = self.step_no   # LRU touch
            pids.append(pid)
            j += 1
        return tuple(pids)

    def _evict_prefix_cache(self, need: int, keep=()):
        """Drop cached prefix pages least-recently-hit first (publication
        order breaks ties; never those in ``keep``) until the allocator can
        serve ``need`` pages. An entry's page is released only if no live
        slot still maps it."""
        keep = set(keep)
        order = sorted(self._prefix_index,
                       key=lambda k: tuple(self._prefix_meta[k]))
        for key in order:
            if self.allocator.can(need):
                return
            pid = self._prefix_index[key]
            if pid in keep:
                continue
            del self._prefix_index[key]
            del self._prefix_meta[key]
            del self._published[pid]
            released = self.allocator.free((pid,))
            if released:
                kvcache.zero_pages(self.cache, released)

    def drop_prefix_cache(self) -> int:
        """Release every cached prefix page (the index's own references);
        pages still mapped by live slots survive until those finish.
        Returns the number of entries dropped."""
        n = len(self._prefix_index)
        self._evict_prefix_cache(self.allocator.n_pages + 1)
        return n

    def _maybe_publish(self, s: _Slot):
        """After ``s.consumed`` advanced: a page boundary just crossed
        inside the prompt publishes that page (the index takes a
        reference)."""
        ps = self.policy.page_size
        if s.consumed % ps != 0 or s.consumed > len(s.req.prompt):
            return
        key = tuple(s.req.prompt[:s.consumed])
        if key in self._prefix_index:
            return
        pid = s.pages[s.consumed // ps - 1]
        self._prefix_index[key] = pid
        self._prefix_meta[key] = [self.step_no, self._prefix_seq]
        self._prefix_seq += 1
        self._published[pid] = key
        self.allocator.retain((pid,))

    # -- admission ---------------------------------------------------------

    def _admit(self):
        """FIFO head-of-line admission while a slot is free AND the pool
        can serve the head request's whole page budget; with prefix sharing
        the budget shrinks by the cached full-page prefix, plus one CoW
        target when the prompt ends exactly on a shared page boundary."""
        while self.queue.peek() is not None:
            free_slot = next((i for i, s in enumerate(self._slots)
                              if s is None), None)
            if free_slot is None:
                return
            req = self.queue.peek()
            ps = self.policy.page_size
            npg = kvcache.pages_needed(req.total_tokens, ps)
            shared = (self._lookup_shared(req.prompt)
                      if self.prefix_sharing else ())
            plen = len(req.prompt)
            # a fully shared prompt still re-consumes its last token and
            # therefore WRITES into the last shared page: a private clone
            cow = bool(shared) and len(shared) * ps == plen
            need = npg - len(shared) + (1 if cow else 0)
            if not self.allocator.can(need) and self.prefix_sharing:
                self._evict_prefix_cache(need, keep=shared)
            if not self.allocator.can(need):
                return                      # transient exhaustion: wait
            self.queue.pop()
            fresh = self.allocator.alloc(need)
            if cow:
                src, dst = shared[-1], fresh[0]
                self.allocator.retain(shared[:-1])
                kvcache.copy_page(self.cache, src, dst)
                pages = shared[:-1] + (dst,) + fresh[1:]
            else:
                self.allocator.retain(shared)
                pages = shared + fresh
            kvcache.set_slot_pages(self.cache, free_slot, pages)
            enq_step, enq_s = self._pending_meta.pop(req.rid)
            slot = _Slot(req, pages, self.step_no, enq_step, enq_s)
            # shared pages' K/V is already in the pool: skip those tokens
            slot.consumed = min(len(shared) * ps, plen - 1)
            self._slots[free_slot] = slot
            ev = dict(rid=req.rid, step=self.step_no, slot=free_slot,
                      n_pages=need, queue_depth=len(self.queue),
                      pool_free=self.allocator.free_count)
            if self.prefix_sharing:
                ev.update(n_pages_solo=npg, pages_shared=len(shared),
                          tokens_reused=slot.consumed, cow_copied=int(cow))
            self.telemetry.emit("admit", **ev)
            if cow:
                self.telemetry.emit("cow", rid=req.rid, step=self.step_no,
                                    slot=free_slot, src=shared[-1],
                                    dst=fresh[0])

    # -- self-healing: scrub, repair, migrate ------------------------------

    def start_migration(self, target_plan, *, leaves_per_step: int = 1,
                        every: int = 1) -> "scrubber.Migrator":
        """Begin a rolling migration to ``target_plan``: every ``every``
        steps the next ``leaves_per_step`` scheme-changed leaves are
        transcoded and the front-end's plan swapped for the promoted one.
        Serving continues throughout: decode dispatches on each leaf's own
        scheme id."""
        if self.plan is None:
            raise ValueError("front-end was built without a plan — "
                             "nothing to diff a migration against")
        if self._migrator is not None and not self._migrator.done:
            raise RuntimeError("a migration is already in flight")
        self._migrator = scrubber.Migrator(self.plan, target_plan,
                                           leaves_per_step=leaves_per_step)
        self._migrate_every = max(1, every)
        self.telemetry.emit("migrate", step=self.step_no, phase="start",
                            pending=len(self._migrator.pending))
        return self._migrator

    @property
    def migration_done(self) -> bool:
        return self._migrator is None or self._migrator.done

    def _busy_pages(self) -> set:
        """Each active slot's current write-target page."""
        ps = self.policy.page_size
        return {s.pages[min(s.consumed // ps, len(s.pages) - 1)]
                for s in self._slots if s is not None}

    def _repair(self, due_paths):
        """Hand scrub-detected DUE leaves to MILR repair or quarantine."""
        self.enc_params, reports = repair_mod.repair_tree(
            self.enc_params, self.repair_kit, paths=due_paths,
            backend=self.backend)
        for r in reports:
            self.telemetry.emit("repair", step=self.step_no, **r)
        return reports

    def _heal(self):
        """The per-step maintenance slice, after admission and BEFORE the
        serve compute, so written-back corrections land before anything
        decodes them."""
        mig = self._migrator
        if (mig is not None and not mig.done
                and self.step_no % self._migrate_every == 0):
            self.enc_params, recs = mig.step(self.enc_params)
            self.plan = mig.plan
            for r in recs:
                self.telemetry.emit("migrate", step=self.step_no,
                                    phase="promote",
                                    pending=len(mig.pending), **r)
        if self.scrub_every and self.step_no % self.scrub_every == 0:
            self.enc_params, wst = self.scrubber.scrub_weights(
                self.enc_params)
            if wst["due_paths"] and self.repair_kit is not None:
                self._repair(wst["due_paths"])
            self.cache, kst = self.scrubber.scrub_kv(
                self.cache, self.policy,
                occupied=self.allocator.live_pages(),
                busy=self._busy_pages())
            self.telemetry.emit(
                "scrub", step=self.step_no,
                w_scanned=wst["scanned"], w_corrected=wst["corrected"],
                w_due=wst["due"], kv_scanned=kst["scanned"],
                kv_corrected=kst["corrected"], kv_due=kst["due"])

    def final_scrub(self) -> dict:
        """One full at-rest pass after the loop drains: every protected
        weight leaf (DUE leaves repaired or quarantined with a kit, then
        counted again), every live KV page, and the re-zeroing of free and
        parking pages. Emits ``scrub_final`` and returns its fields:
        ``w_due`` / ``kv_due`` are the residual uncorrectable state."""
        self.enc_params, wst = self.scrubber.scrub_weights(self.enc_params,
                                                           n=-1)
        repaired = 0
        wst2 = wst
        if wst["due_paths"] and self.repair_kit is not None:
            repaired = len(self._repair(wst["due_paths"]))
            self.enc_params, wst2 = self.scrubber.scrub_weights(
                self.enc_params, n=-1)
        self.cache, kst = self.scrubber.scrub_kv(
            self.cache, self.policy, occupied=self.allocator.live_pages(),
            n=-1)
        self.cache = self.scrubber.scrub_free(self.cache, self.allocator)
        out = {"w_scanned": wst["scanned"], "w_corrected": wst["corrected"],
               "w_repaired": repaired, "w_due": wst2["due"],
               "kv_scanned": kst["scanned"],
               "kv_corrected": kst["corrected"], "kv_due": kst["due"]}
        self.telemetry.emit("scrub_final", step=self.step_no, **out)
        return out

    # -- the serving loop --------------------------------------------------

    @property
    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _finish(self, idx: int):
        s = self._slots[idx]
        now = time.perf_counter()
        n_gen = len(s.generated)
        self.results[s.req.rid] = list(s.generated)
        # park the row, then drop this slot's references; only pages whose
        # LAST reference died re-enter the pool, zeroed before any reuse
        kvcache.set_slot_pages(self.cache, idx, ())
        released = self.allocator.free(s.pages)
        if released:
            kvcache.zero_pages(self.cache, released)
        self._slots[idx] = None
        ev = {"rid": s.req.rid, "step": self.step_no, "slot": idx,
              "n_generated": n_gen, "kv_corrected": int(s.kv_corrected),
              "kv_due": int(s.kv_due), "pool_free": self.allocator.free_count}
        if s.abft_mismatches or s.clamp_hits:
            ev["abft_mismatches"] = int(s.abft_mismatches)
            ev["clamp_hits"] = int(s.clamp_hits)
        if s.first_s is not None:
            ev["ttft_s"] = s.first_s - s.enqueue_s
            ev["tpot_ms"] = ((now - s.first_s) / max(1, n_gen - 1)) * 1e3
        self.telemetry.emit("finish", **ev)

    def step(self):
        """One loop iteration: admit, run the serve step over all slots
        (idle slots feed a keep-alive token into their parking page),
        sample greedily, advance lifecycles, emit telemetry."""
        self._admit()
        self._heal()
        t0 = time.perf_counter()
        tokens = np.zeros((self.slots_n, 1), np.int64)
        pos = np.zeros((self.slots_n,), np.int32)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.consumed < len(s.req.prompt):
                tokens[i, 0] = s.req.prompt[s.consumed]
            else:
                tokens[i, 0] = s.generated[-1]
            pos[i] = s.consumed
        logits, self.cache, flags = self.serve_step(
            self.enc_params, self.cache,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device))
        # one device -> host transfer per step: sampled tokens (B), the
        # per-slot KV rows (2, B), the weight totals (2,) and, with a
        # guarded plan, the per-slot ABFT rows (2, B)
        b = self.slots_n
        parts = [logits[:, -1, :].argmax(dim=-1),
                 flags["layers_kv"].sum(0).reshape(-1),
                 (flags["top"] + flags["layers"].sum(0)).reshape(-1)]
        ab = flags.get("layers_abft")
        if ab is not None:
            parts.append((ab.sum(0) + flags["top_abft"]).reshape(-1))
        host = torch.cat([x.to(torch.int64) for x in parts]).cpu().numpy()
        sampled, kv, w = (host[:b], host[b:3 * b].reshape(2, b),
                          host[3 * b:3 * b + 2])
        if ab is not None:
            ab = host[3 * b + 2:].reshape(2, b)
        t1 = time.perf_counter()
        self.last_flags = flags
        self.last_active = tuple(i for i, s in enumerate(self._slots)
                                 if s is not None)

        for i, s in enumerate(self._slots):
            if s is None:
                continue
            s.kv_corrected += int(kv[0, i])
            s.kv_due += int(kv[1, i])
            if ab is not None:
                s.abft_mismatches += int(ab[0, i])
                s.clamp_hits += int(ab[1, i])
            s.consumed += 1
            if self.prefix_sharing:
                self._maybe_publish(s)
            if s.consumed >= len(s.req.prompt):
                s.generated.append(int(sampled[i]))
                if s.first_step is None:
                    s.first_step, s.first_s = self.step_no, t1
                    self.telemetry.emit(
                        "first_token", rid=s.req.rid, step=self.step_no,
                        slot=i, ttft_steps=self.step_no - s.enqueue_step,
                        ttft_s=t1 - s.enqueue_s)
        for i, s in enumerate(self._slots):
            if s is not None and len(s.generated) >= s.req.max_new:
                self._finish(i)
        # after the finishes, so pool_free reflects this step's frees
        ev = dict(step=self.step_no, active=self.active,
                  queue_depth=len(self.queue),
                  pool_free=self.allocator.free_count,
                  pool_cached=len(self._prefix_index),
                  kv_corrected=int(kv[0].sum()), kv_due=int(kv[1].sum()),
                  w_corrected=int(w[0]), w_due=int(w[1]))
        if ab is not None:
            ev["abft_mismatches"] = int(ab[0].sum())
            ev["clamp_hits"] = int(ab[1].sum())
        self.telemetry.emit("step", **ev, step_ms=(t1 - t0) * 1e3)
        self.step_no += 1

    def run(self, max_steps: int = 10_000):
        """Step until queue and slots drain (or ``max_steps``)."""
        for _ in range(max_steps):
            if not self.queue.peek() and self.active == 0:
                return
            self.step()
        if self.queue.peek() or self.active:
            raise RuntimeError(f"not drained after {max_steps} steps: "
                               f"{len(self.queue)} queued, "
                               f"{self.active} active")


# ---------------------------------------------------------------------------
# burst-load driver
# ---------------------------------------------------------------------------


def make_waves(*, seed: int, n_waves: int, wave_size: int, vocab: int,
               prompt_len=(4, 12), max_new=(4, 8), gap_steps: int = 8,
               shared_prefix_len: int = 0) -> list:
    """Deterministic burst workload: ``n_waves`` waves of ``wave_size``
    requests, wave *w* arriving at step ``w * gap_steps``; tokens and
    lengths from ``numpy.random.default_rng(seed)``, drawn in the
    reference's order, so both packages get the same requests.
    ``shared_prefix_len > 0`` prepends ONE common prefix of that many
    tokens to every prompt (``prompt_len`` then ranges over the suffix,
    which may be empty)."""
    rng = np.random.default_rng(seed)
    shared = tuple(int(t) for t in
                   rng.integers(1, vocab, size=shared_prefix_len))
    lo_p, hi_p = prompt_len
    lo_n, hi_n = max_new
    reqs, rid = [], 0
    for w in range(n_waves):
        for _ in range(wave_size):
            plen = int(rng.integers(lo_p, hi_p + 1))
            reqs.append(Request(
                rid=rid,
                prompt=shared + tuple(int(t) for t in
                                      rng.integers(1, vocab, size=plen)),
                max_new=int(rng.integers(lo_n, hi_n + 1)),
                arrival_step=w * gap_steps))
            rid += 1
    return reqs


def _step_generator(device, seed: int, step: int) -> torch.Generator:
    """The fault stream of one logical step: a generator seeded from the
    run's seed and the step, so a replay injects the same bits."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + step)
    return gen


def run_burst(cfg: ArchConfig, enc_params, *, plan=None, waves: Sequence,
              slots: int = 4, max_len: int = 128,
              n_pages: Optional[int] = None, kv_policy="in-place",
              fault_rate: float = 0.0, fault_seed: int = 0,
              inject_every: int = 4, correctable_only: bool = False,
              telemetry_path: Optional[str] = None, serve_step=None,
              max_steps: int = 10_000, dtype=torch.bfloat16,
              prefix_sharing: bool = False,
              scrub_every: int = 0, scrub_weight_leaves: int = 1,
              scrub_kv_pages: int = 4, repair: bool = False, repair_kit=None,
              weight_fault_rate: float = 0.0,
              before_step: Optional[Callable] = None,
              after_step: Optional[Callable] = None, backend=None,
              device=None):
    """Replay a seeded wave workload through the front-end, optionally
    injecting faults into the live KV pools (and their check planes) every
    ``inject_every`` steps at per-bit ``fault_rate``; ``weight_fault_rate``
    injects into the encoded weights on the same cadence from a stream of
    its own. Each injection draws from a ``torch.Generator`` seeded from
    ``fault_seed`` and the logical step, so a replay injects the same bits
    (torch cannot replay ``jax.random``: the reference's bits differ).
    ``correctable_only`` keeps at most one flip per 64-bit block over the
    whole run (a block once hit takes no second flip).

    ``before_step(fe)`` runs before each step (after submissions and
    injection) and ``after_step(fe)`` after it: the hooks through which a
    test applies the same fault masks to two front-ends or reads each
    step's per-slot flags (``fe.last_flags``). Returns ``(events, summary,
    results)``.

    ``scrub_every > 0`` turns on the budgeted self-healing slice
    (``scrub_weight_leaves`` / ``scrub_kv_pages`` a pass) and ends the run
    with :meth:`ServingFrontend.final_scrub`, so the summary's ``healing``
    roll-up reports the residual at-rest DUE state; ``repair=True`` pins a
    MILR repair kit from the (clean) entry tree first, seeded from
    ``fault_seed``, or pass a ``repair_kit`` built before faults."""
    col = telemetry.TelemetryCollector(telemetry_path)
    try:
        kit = repair_kit
        if repair and kit is None:
            kit = repair_mod.build_repair_kit(
                enc_params, seed=fault_seed,
                backend=backend or device_mod.default_backend(
                    device_mod.resolve(device)))
        fe = ServingFrontend(cfg, enc_params, plan=plan, slots=slots,
                             max_len=max_len, n_pages=n_pages,
                             kv_policy=kv_policy, serve_step=serve_step,
                             collector=col, dtype=dtype,
                             prefix_sharing=prefix_sharing,
                             scrub_every=scrub_every,
                             scrub_weight_leaves=scrub_weight_leaves,
                             scrub_kv_pages=scrub_kv_pages, repair_kit=kit,
                             backend=backend, device=device)
        pending = sorted(waves, key=lambda r: (r.arrival_step, r.rid))
        i = 0
        hits = ({}, {}) if correctable_only else (None, None)  # KV, weights
        for _ in range(max_steps):
            while i < len(pending) and pending[i].arrival_step <= fe.step_no:
                fe.submit(pending[i])
                i += 1
            if i >= len(pending) and not fe.queue.peek() and fe.active == 0:
                break
            if fe.active > 0 and fe.step_no % inject_every == 0:
                if fault_rate > 0:
                    tree = kvcache.as_protected_tree(fe.cache, fe.policy)
                    dirty, _ = policy_mod.inject_tree_device(
                        tree, fault_rate,
                        _step_generator(fe.device, fault_seed, fe.step_no),
                        one_per_block=correctable_only, hit_blocks=hits[0])
                    fe.cache = kvcache.from_protected_tree(fe.cache, dirty)
                if weight_fault_rate > 0:
                    fe.enc_params, _ = policy_mod.inject_tree_device(
                        fe.enc_params, weight_fault_rate,
                        _step_generator(fe.device, fault_seed + 1_000_003,
                                        fe.step_no),
                        one_per_block=correctable_only, hit_blocks=hits[1])
            if before_step is not None:
                before_step(fe)
            fe.step()
            if after_step is not None:
                after_step(fe)
        else:
            raise RuntimeError(f"burst not drained after {max_steps} steps")
        if scrub_every > 0:
            fe.final_scrub()
    finally:
        col.close()
    return col.events, telemetry.summarize(col.events), fe.results

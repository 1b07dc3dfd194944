"""Fault campaigns — the paper's Table 2 on the card.

Counterpart of ``repro.protection.campaign``. A campaign encodes the model
**once**, then runs the whole (rate x trial) grid of inject -> decode ->
eval on the tree's device:

* every cell (rate ``r``, trial ``t``) draws from its own
  ``torch.Generator``, seeded by :func:`cell_seed` ``(key, r, t)`` on the
  tree's device, and draws the protected leaves in tree order; each leaf
  samples the fixed budget ``n_faults(bits, max(rates))`` of positions and
  keeps the first ``round(bits * rate)`` (``core.faults.inject_torch_rate``),
  so a cell's flips depend on its seed alone, whatever the layout;
* ``batch="vmap"`` stacks the cells' dirty images of each leaf and decodes
  them in one call (one kernel launch a leaf on the ``cuda`` route), then
  evaluates cell by cell; ``batch="scan"`` runs one cell after another at
  one cell's memory. Both give the same grid, cell for cell. (The kernels
  are bound with ``ctypes``, so ``torch.func.vmap`` cannot trace the
  decode; the "vmap" layout is a batched one.)
* accuracy decodes a cell's tree leaf by leaf and runs the forward once;
  decode fidelity and the DUE/corrected counts are summed leaf by leaf, so
  no clean or dirty f32 copy of the whole tree is ever held.

The reference compiles one program per campaign; the port has no compile.
``CampaignResult.compile_s`` keeps its name and now holds the seconds of
the clean evaluation, which runs first and so carries the warm-up (a kernel
build, cuDNN's choice of algorithms); ``wall_clock_s`` is the grid alone.

The host path (``policy.inject_tree`` NumPy injection) stays the
cross-check oracle: :func:`run_campaign_host` draws the reference's exact
bits, so its grid equals the reference's cell for cell. The device grids
draw from torch generators, which cannot replay ``jax.random``: they are
held to the host path statistically.

Every function takes the tree's ``device`` (default ``"cuda"``; without a
GPU it raises unless the caller asks for ``"cpu"``) and moves the tree
there first.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import tree
from repro_torch.core import faults

from .backends import get_backend
from .policy import (ProtectionPolicy, _image, _with_image, decode_leaf,
                     decode_tree, inject_tree, inject_tree_device, path_str,
                     space_overhead)
from .schemes import get_scheme
from .tensor import ProtectedTensor, is_protected_tensor

__all__ = ["CampaignResult", "run_campaign", "run_campaign_host",
           "fidelity_campaign", "due_campaign", "compute_campaign",
           "accuracy_eval", "fidelity_eval", "due_eval", "LeafMetric",
           "cell_seed", "cell_generator", "leaf_counts", "RATES"]

RATES = (1e-6, 1e-5, 1e-4, 1e-3, 3e-3)


# ---------------------------------------------------------------------------
# result carrier
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CampaignResult:
    """One campaign = one (model, policy) over a (rate x trial) grid.

    ``grid[r][t]`` is the raw metric value (accuracy or decode fidelity) of
    trial ``t`` at ``rates[r]``; ``clean`` is the same metric with zero
    faults. The fields and their JSON keys are the reference's, so each
    package loads the other's records.
    """

    scheme: str                # scheme id(s) of the policy under test
    metric: str                # "accuracy" | "fidelity" | "due_count" | ...
    rates: tuple               # swept fault rates
    trials: int
    clean: float               # metric at rate 0 (no injection)
    grid: tuple                # (len(rates), trials) nested tuples of float
    space_overhead: float      # (stored - weight) / weight bytes
    compile_s: float           # the clean evaluation: the warm-up (0 host)
    wall_clock_s: float        # grid execution time, warm-up excluded
    batch: str                 # "vmap" | "scan" | "host"
    backend: str               # protection backend ("torch" | "cuda")
    platform: str              # device type ("cuda", "cpu")
    device: str                # device name
    target: str = "weights"    # "weights" | "kv" | "both" | "compute"
    layer_rows: tuple = ()     # (n_layers, 2) per-layer KV (corrected, due)
    #                            at max(rates) — () unless target covers KV
    coverage_rows: tuple = ()  # per-leaf (path, detected, injected) at
    #                            max(rates) — compute campaigns only

    def mean(self) -> tuple:
        """Per-rate mean metric across trials."""
        return tuple(float(np.mean(row)) for row in self.grid)

    def std(self) -> tuple:
        """Per-rate metric std across trials."""
        return tuple(float(np.std(row)) for row in self.grid)

    def drop(self) -> tuple:
        """Per-rate mean metric drop vs clean (the Table-2 cell value)."""
        return tuple(self.clean - m for m in self.mean())

    def row(self) -> list:
        """Table-2 row format: ``[(mean_drop, std), ...]`` per rate."""
        return list(zip(self.drop(), self.std()))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rates"] = list(self.rates)
        d["grid"] = [list(row) for row in self.grid]
        d["layer_rows"] = [list(row) for row in self.layer_rows]
        d["coverage_rows"] = [list(row) for row in self.coverage_rows]
        d["derived"] = {"mean": list(self.mean()), "std": list(self.std()),
                        "drop": list(self.drop())}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignResult":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["rates"] = tuple(kw["rates"])
        kw["grid"] = tuple(tuple(row) for row in kw["grid"])
        kw["layer_rows"] = tuple(tuple(int(v) for v in row)
                                 for row in kw.get("layer_rows", ()))
        kw["coverage_rows"] = tuple(
            (str(p), int(det), int(inj))
            for p, det, inj in kw.get("coverage_rows", ()))
        return cls(**kw)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=kw.pop("indent", 2), **kw)

    @classmethod
    def from_json(cls, s: str) -> "CampaignResult":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "CampaignResult":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# per-cell streams
# ---------------------------------------------------------------------------


def cell_seed(key: int, r: int, t: int) -> int:
    """Seed of cell (rate index ``r``, trial ``t``) of a campaign keyed
    ``key`` (non-negative ints): NumPy's ``SeedSequence([key, r, t])``."""
    return int(np.random.SeedSequence([int(key), int(r), int(t)])
               .generate_state(1, np.uint64)[0])


def cell_generator(key: int, r: int, t: int, device) -> torch.Generator:
    """The cell's generator on ``device``: every leaf's fault positions of
    cell (r, t) come from it, drawn in tree order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cell_seed(key, r, t))
    return gen


# ---------------------------------------------------------------------------
# eval metrics
# ---------------------------------------------------------------------------


class LeafMetric:
    """A metric summed leaf by leaf over the protected leaves:
    ``leaf(clean_pt, dirty_pt, batch_dims)`` gives a count per cell
    (``dirty_pt``'s images carry ``batch_dims`` leading cell dims), and the
    metric is the sum over leaves divided by ``norm``."""

    def __init__(self, leaf: Callable, norm: float = 1.0):
        self.leaf = leaf
        self.norm = norm


def accuracy_eval(fwd, batch, device=None):
    """Metric: top-1 accuracy of ``fwd(decoded_params, images)`` on a fixed
    eval batch (the Table-2 metric). The batch's NumPy arrays move to
    ``device`` (default: the decoded tree's) at the first call."""
    moved: dict = {}

    def ev(dec_params):
        dev = torch.device(device) if device is not None else \
            _tree_device(dec_params)
        if dev not in moved:
            moved[dev] = (torch.as_tensor(batch["images"], device=dev),
                          torch.as_tensor(batch["labels"], device=dev))
        images, labels = moved[dev]
        lg = fwd(dec_params, images)
        return (lg.argmax(-1) == labels).to(torch.float32).mean()

    return ev


def _decoded_q(pt: ProtectedTensor, backend, batch_dims: int = 0):
    """-> (int8 weights, flattened per cell over ``n_weights``, corrected,
    due)."""
    q, corrected, due = get_scheme(pt.scheme_id).decode_with_flags(
        pt.enc, pt.checks, backend, batch_dims=batch_dims)
    lead = tuple(pt.enc.shape[:batch_dims])
    return q.reshape(lead + (-1,))[..., : pt.n_weights], corrected, due


def fidelity_eval(enc_tree, backend="torch") -> LeafMetric:
    """Metric: the fraction of *protected* weight values that decode to the
    fault-free decode's value. Label-free, so it serves any model (the
    serving smoke-check runs it on LM weights). Counted leaf by leaf on the
    int8 decode against the same leaf's clean decode (the dequantization
    ``q * scale`` maps distinct int8 values to distinct floats)."""
    prot = [leaf for _, leaf in tree.leaves_with_path(enc_tree)
            if is_protected_tensor(leaf)]
    if not prot:
        raise ValueError("fidelity_eval: the tree has no protected leaves "
                         "(did the policy's predicate select anything?)")
    be = get_backend(backend)

    def leaf(clean, dirty, batch_dims):
        ref, _, _ = _decoded_q(clean, be)
        got, _, _ = _decoded_q(dirty, be, batch_dims)
        return (got == ref).sum(-1)

    return LeafMetric(leaf, float(sum(pt.n_weights for pt in prot)))


def due_eval(backend="torch", *, what="due") -> LeafMetric:
    """Metric over the encoded tree: the total detected-uncorrectable
    (double) errors across protected leaves, the flags the decode-at-use
    serve step reports (``what="corrected"`` counts repairs instead)."""
    idx = {"corrected": 1, "due": 2}[what]
    be = get_backend(backend)

    def leaf(clean, dirty, batch_dims):
        return _decoded_q(dirty, be, batch_dims)[idx]

    return LeafMetric(leaf)


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def _tree_device(t) -> torch.device:
    for _, leaf in tree.leaves_with_path(t):
        x = leaf.enc if is_protected_tensor(leaf) else leaf
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("the tree holds no tensor")


def _to_device(t, dev):
    """The tree with every tensor (and ProtectedTensor field) on ``dev``."""
    def mv(x):
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    def leaf(_, x):
        if is_protected_tensor(x):
            return dataclasses.replace(x, enc=mv(x.enc), checks=mv(x.checks),
                                       scale=mv(x.scale))
        return mv(x)
    return tree.map_with_path(leaf, t)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_fields(dev) -> dict:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": dev.type, "device": name}


def _scheme_label(enc_tree) -> str:
    sids = sorted({leaf.scheme_id for _, leaf in tree.leaves_with_path(enc_tree)
                   if is_protected_tensor(leaf)})
    return "+".join(sids) if sids else "none"


def _is_encoded(t) -> bool:
    return any(is_protected_tensor(leaf)
               for _, leaf in tree.leaves_with_path(t))


def _dequant_stacked(pt: ProtectedTensor, q, cells: int) -> torch.Tensor:
    """(cells, ...) int8 decode of a stacked image -> (cells, *orig_shape)
    f32."""
    if pt.is_flat:
        q = q.reshape(cells, -1)[:, : pt.n_weights]
    return q.reshape((cells,) + tuple(pt.orig_shape)).to(torch.float32) * \
        pt.scale


def _eval_cells(enc, ev, rates, gens, max_rate, be, batch):
    """Metric values of the cells (``rates[i]`` drawn from ``gens[i]``):
    one cell at a time (``scan``) or all cells' images of each leaf
    stacked and decoded together (``vmap``)."""
    cells = len(gens)
    leafwise = isinstance(ev, LeafMetric)

    def dirty(pt, rate, gen):
        image = faults.inject_torch_rate(_image(pt), rate, gen, max_rate)[0]
        return _with_image(pt, image)

    if batch == "scan":
        out = []
        for rate, gen in zip(rates, gens):
            if leafwise:
                total = 0
                for _, pt in tree.leaves_with_path(enc):
                    if is_protected_tensor(pt):
                        total += ev.leaf(pt, dirty(pt, rate, gen), 0)
                out.append(float(total) / ev.norm)
            else:
                dec = tree.map_with_path(
                    lambda _, pt: decode_leaf(dirty(pt, rate, gen),
                                              torch.float32, backend=be)
                    if is_protected_tensor(pt) else pt, enc)
                out.append(float(ev(dec)))
        return out

    def stacked(pt):
        image = _image(pt)
        imgs = torch.stack([
            faults.inject_torch_rate(image, rate, gen, max_rate)[0]
            for rate, gen in zip(rates, gens)])
        return _with_image(pt, imgs)

    if leafwise:
        totals = torch.zeros(cells, dtype=torch.float64)
        for _, pt in tree.leaves_with_path(enc):
            if is_protected_tensor(pt):
                totals += ev.leaf(pt, stacked(pt), 1).cpu().to(torch.float64)
        return [float(v) / ev.norm for v in totals]
    decoded = {}
    for path, pt in tree.leaves_with_path(enc):
        if is_protected_tensor(pt):
            d = stacked(pt)
            q = get_scheme(pt.scheme_id).decode(d.enc, d.checks, be)
            decoded[path] = _dequant_stacked(pt, q, cells)
    return [float(ev(tree.map_with_path(
        lambda path, x: decoded[path][c] if path in decoded else x, enc)))
        for c in range(cells)]


def _evaluate_clean(enc, ev, be):
    if isinstance(ev, LeafMetric):
        total = 0
        for _, pt in tree.leaves_with_path(enc):
            if is_protected_tensor(pt):
                total += ev.leaf(pt, pt, 0)
        return float(total) / ev.norm
    return float(ev(decode_tree(enc, torch.float32, backend=be)))


@torch.no_grad()
def _run_grid(enc, ev, rates, trials, key, batch, backend, metric):
    """Shared engine: evaluate the clean tree (the warm-up), then every
    (rate x trial) cell, into a :class:`CampaignResult`."""
    if batch not in ("vmap", "scan"):
        raise ValueError(f"batch must be 'vmap' or 'scan', got {batch!r}")
    rates = tuple(float(r) for r in rates)
    max_rate = max(rates) if rates else 0.0
    be = get_backend(backend)
    dev = _tree_device(enc)
    t0 = time.perf_counter()
    clean = _evaluate_clean(enc, ev, be)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    cells = [(ri, t) for ri in range(len(rates)) for t in range(trials)]
    t0 = time.perf_counter()
    out = _eval_cells(enc, ev, [rates[ri] for ri, _ in cells],
                      [cell_generator(key, ri, t, dev) for ri, t in cells],
                      max_rate, be, batch)
    _sync(dev)
    wall = time.perf_counter() - t0
    grid = tuple(tuple(out[ri * trials: (ri + 1) * trials])
                 for ri in range(len(rates)))
    return CampaignResult(
        scheme=_scheme_label(enc), metric=metric, rates=rates, trials=trials,
        clean=clean, grid=grid, space_overhead=float(space_overhead(enc)),
        compile_s=compile_s, wall_clock_s=wall, batch=batch, backend=be.name,
        **_device_fields(dev))


def _as_policy(policy, dev) -> ProtectionPolicy:
    """A policy, or a scheme id under the paper's eval policy (every leaf of
    >= 2 dims protected) on the device's default route."""
    if isinstance(policy, ProtectionPolicy):
        return policy
    return ProtectionPolicy(default_scheme=policy,
                            predicate=lambda p, leaf: getattr(leaf, "ndim",
                                                              0) >= 2,
                            backend=device_mod.default_backend(dev))


def _default_eval(fwd, tmpl, dev, *, n_classes, img, eval_batch, eval_seed):
    from repro_torch.data import synthetic
    b, _ = synthetic.image_batch(n_classes, eval_batch, img, seed=eval_seed,
                                 step=0, templates=tmpl)
    return accuracy_eval(fwd, b, device=dev)


def run_campaign(params, fwd, tmpl, policy, rates=RATES, trials=5, key=None,
                 batch="vmap", *, eval_fn=None, eval_batch=256, n_classes=4,
                 img=32, eval_seed=777, device=None) -> CampaignResult:
    """Encode once, then sweep the full (trial x rate) fault grid on the
    device.

    params:  f32 parameter tree (encoded here under ``policy``).
    fwd:     ``fwd(decoded_params, images) -> logits`` (any input
             normalization inside); ignored when ``eval_fn`` is given.
    tmpl:    synthetic-data class templates for the eval batch (None draws
             fresh ones from ``eval_seed``); ignored when ``eval_fn`` given.
    policy:  a ``ProtectionPolicy`` or a scheme id (which gets the paper's
             eval policy on the device's default route).
    key:     int seed of the cells' streams (default 0).
    batch:   "vmap" (each leaf's cells decoded together) or "scan" (one
             cell at a time, one cell's memory).
    eval_fn: optional ``(decoded_tree) -> scalar`` or :class:`LeafMetric`.
    """
    dev = device_mod.resolve(device)
    params = _to_device(params, dev)
    policy = _as_policy(policy, dev)
    enc = policy.encode_tree(params)
    if eval_fn is None:
        eval_fn = _default_eval(fwd, tmpl, dev, n_classes=n_classes, img=img,
                                eval_batch=eval_batch, eval_seed=eval_seed)
        metric = "accuracy"
    else:
        metric = "custom"
    return _run_grid(enc, eval_fn, rates, trials, 0 if key is None else key,
                     batch, policy.backend, metric)


def fidelity_campaign(tree_, policy=None, rates=(1e-4,), trials=2, key=None,
                      batch="vmap", *, device=None) -> CampaignResult:
    """Label-free campaign: metric = decode fidelity vs the clean decode.

    ``tree_`` may be raw f32 params (encoded here under ``policy``) or an
    already-encoded tree (``policy`` then only supplies the backend). This
    is the serving fault smoke-check: at rate r, what fraction of the
    resident weights still decode correctly?"""
    dev = device_mod.resolve(device)
    tree_ = _to_device(tree_, dev)
    policy = _as_policy(policy if policy is not None else "in-place", dev)
    enc = tree_ if _is_encoded(tree_) else policy.encode_tree(tree_)
    ev = fidelity_eval(enc, backend=policy.backend)
    return _run_grid(enc, ev, rates, trials, 0 if key is None else key, batch,
                     policy.backend, "fidelity")


def due_campaign(tree_, policy=None, rates=(1e-4,), trials=2, key=None,
                 batch="vmap", *, what="due", target="weights",
                 kv_tree=None, device=None) -> CampaignResult:
    """Fault-accounting campaign: metric = total detected-uncorrectable
    (double-error, DUE) count across protected leaves per cell, the same
    per-leaf flags the decode-at-use serve step reports, swept over the
    (rate x trial) grid; ``what="corrected"`` sweeps the repair counts.

    ``target`` picks what the faults hit: "weights" (``tree_``), "kv" (a
    paged KV cache's pools as ``ProtectedTensor`` leaves, from
    :func:`repro_torch.serving.kvcache.as_protected_tree`) or "both" (one
    grid over ``{"kv": ..., "weights": ...}``). When the target covers KV
    the result also carries ``layer_rows``: per-layer (corrected, DUE)
    counts from one injection at ``max(rates)`` drawn from a generator
    seeded ``key``."""
    if target not in ("weights", "kv", "both"):
        raise ValueError(f"target {target!r}; one of "
                         f"('weights', 'kv', 'both')")
    if target != "weights" and kv_tree is None:
        raise ValueError(f"target={target!r} needs kv_tree (see "
                         f"repro_torch.serving.kvcache.as_protected_tree)")
    dev = device_mod.resolve(device)
    policy = _as_policy(policy if policy is not None else "in-place", dev)
    key = 0 if key is None else key
    if target != "weights":
        kv_tree = _to_device(kv_tree, dev)
    if target == "kv":
        enc = kv_tree
    else:
        wtree = _to_device(tree_, dev)
        wtree = wtree if _is_encoded(wtree) else policy.encode_tree(wtree)
        enc = wtree if target == "weights" else {"weights": wtree,
                                                 "kv": kv_tree}
    res = _run_grid(enc, due_eval(backend=policy.backend, what=what), rates,
                    trials, key, batch, policy.backend, f"{what}_count")
    res = dataclasses.replace(res, target=target)
    if target != "weights":
        from repro_torch.serving import kvcache  # serving builds on us
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
        with torch.no_grad():
            dirty, _ = inject_tree_device(kv_tree, max(rates), gen,
                                          max_rate=max(rates))
            rows = kvcache.tree_layer_flags(dirty, backend=policy.backend)
        res = dataclasses.replace(res, layer_rows=tuple(
            tuple(int(v) for v in r) for r in rows.tolist()))
    return res


# ---------------------------------------------------------------------------
# compute faults (ABFT coverage)
# ---------------------------------------------------------------------------


def leaf_counts(x_q, w_q, mask, bit, target="acc"):
    """ABFT detection of one leaf's injected compute faults.

    ``x_q`` (M, K) int8 probe, ``w_q`` (K, N) int8 weights. ``target="acc"``:
    ``mask``/``bit`` are (M, N); each selected int32 accumulator element
    gets bit ``bit`` (0..30) flipped, and a fault is DETECTED when its row
    or column checksum fires. ``target="wdec"``: ``mask``/``bit`` are (K,
    N); each selected decoded-weight byte gets bit ``bit`` (0..7) flipped
    in the main product only (the checksums keep the clean ``w_q``), and a
    fault at (k, j) is detected when column j's check fires or any row it
    perturbs (``x_q[:, k] != 0``) does.

    -> ``(detected, injected, fired)`` int64 scalars, ``fired`` the number
    of checksums that fired."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref as kref
    if target == "acc":
        acc = quant.int8_acc(x_q, w_q)
        faulty = torch.where(mask, acc ^ (torch.ones_like(bit) << bit), acc)
        row_bad, col_bad = kref.abft_counts(x_q, w_q, faulty)
        hit = (row_bad[:, None] > 0) | (col_bad[None, :] > 0)
    else:
        flip = (torch.ones_like(bit) << bit).to(torch.uint8)
        w_f = torch.where(mask, (w_q.contiguous().view(torch.uint8) ^ flip)
                          .view(torch.int8), w_q)
        faulty = quant.int8_acc(x_q, w_f)
        row_bad, col_bad = kref.abft_counts(x_q, w_q, faulty)
        rdet = ((row_bad[:, None] > 0) & (x_q != 0)).any(dim=0)       # (K,)
        hit = rdet[:, None] | (col_bad[None, :] > 0)
    det = (mask & hit).sum()
    return det, mask.sum(), row_bad.sum() + col_bad.sum()


def _draw_compute_faults(shape, rate, target, gen):
    """(mask, bit) of one leaf: Bernoulli(rate) elements, a uniform bit."""
    dev = gen.device
    mask = torch.rand(shape, generator=gen, device=dev) < rate
    hi = 31 if target == "acc" else 8
    bit = torch.randint(0, hi, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    return mask, bit


@torch.no_grad()
def compute_campaign(tree_, policy=None, rates=(1e-3,), trials=2, key=None,
                     batch="vmap", *, target="acc", probe_m=8,
                     probe_seed=777, device=None) -> CampaignResult:
    """COMPUTE-fault campaign: how much silent corruption of the matmuls
    themselves does the ABFT checksum pair catch (:func:`leaf_counts`)?

    For each protected 2-D leaf a fixed int8 probe (``probe_m`` rows drawn
    from a generator seeded ``probe_seed``) drives the leaf's exact int32
    accumulator against the leaf's requantized decode; each (rate, trial)
    cell draws its faults from its own generator (:func:`cell_generator`),
    leaf by leaf. ``grid`` cells are detected / injected coverage
    fractions; ``clean`` is the number of checksums that fire at rate 0
    (false positives: 0, the int8 path compares int32 sums exactly);
    ``coverage_rows`` holds per-leaf (path, detected, injected) at
    ``max(rates)``. The rate-0 cell and the per-leaf rows draw from the
    cells ``(len(rates), 0)`` and ``(len(rates), 1)`` of ``key``. The probe
    operands are small, so ``batch="vmap"`` runs the same cell loop as
    ``"scan"``."""
    if target not in ("acc", "wdec"):
        raise ValueError(f"target {target!r}; one of ('acc', 'wdec')")
    if batch not in ("vmap", "scan"):
        raise ValueError(f"batch must be 'vmap' or 'scan', got {batch!r}")
    from repro_torch.core import quant
    dev = device_mod.resolve(device)
    tree_ = _to_device(tree_, dev)
    policy = _as_policy(policy if policy is not None else "in-place", dev)
    key = 0 if key is None else key
    enc = tree_ if _is_encoded(tree_) else policy.encode_tree(tree_)
    rates = tuple(float(r) for r in rates)
    n_rates = len(rates)

    paths, probes = [], []
    pgen = torch.Generator(device=dev)
    pgen.manual_seed(probe_seed)
    for path, leaf in tree.leaves_with_path(enc):
        if not (is_protected_tensor(leaf) and len(leaf.orig_shape) == 2):
            continue
        w = decode_leaf(leaf, torch.float32, backend=policy.backend)
        w_q, _ = quant.quantize(w)
        x_q = torch.randint(-127, 128, (probe_m, w.shape[0]), generator=pgen,
                            device=dev).to(torch.int8)
        paths.append(path_str(path))
        probes.append((x_q, w_q))
    if not probes:
        raise ValueError("compute_campaign: no protected >=2-D leaves "
                         "(did the policy's predicate select anything?)")

    def per_leaf(rate, gen):
        out = []
        for x_q, w_q in probes:
            shape = (x_q.shape[0], w_q.shape[1]) if target == "acc" \
                else tuple(w_q.shape)
            mask, bit = _draw_compute_faults(shape, rate, target, gen)
            out.append(leaf_counts(x_q, w_q, mask, bit, target))
        return out

    def cell(rate, gen):
        counts = per_leaf(rate, gen)
        return [int(sum(c[i] for c in counts)) for i in range(3)]

    t0 = time.perf_counter()
    clean = float(cell(0.0, cell_generator(key, n_rates, 0, dev))[2])
    _sync(dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = [[cell(rate, cell_generator(key, ri, t, dev))
            for t in range(trials)] for ri, rate in enumerate(rates)]
    _sync(dev)
    wall = time.perf_counter() - t0
    rows = [(p, int(d), int(i)) for p, (d, i, _) in zip(
        paths, per_leaf(max(rates), cell_generator(key, n_rates, 1, dev)))]
    grid = tuple(tuple(det / max(float(inj), 1.0) for det, inj, _ in row)
                 for row in out)
    return CampaignResult(
        scheme=_scheme_label(enc), metric="abft_coverage", rates=rates,
        trials=trials, clean=clean, grid=grid,
        space_overhead=float(space_overhead(enc)), compile_s=compile_s,
        wall_clock_s=wall, batch=batch, backend=policy.backend.name,
        target="compute", coverage_rows=tuple(rows), **_device_fields(dev))


# ---------------------------------------------------------------------------
# the host oracle
# ---------------------------------------------------------------------------


@torch.no_grad()
def run_campaign_host(params, fwd, tmpl, policy, rates=RATES, trials=5,
                      seed=0, *, eval_fn=None, eval_batch=256, n_classes=4,
                      img=32, eval_seed=777, device=None) -> CampaignResult:
    """The cross-check oracle: the identical grid through the host path
    (``policy.inject_tree``, NumPy injection; cell (r, t) uses seed ``seed
    + 1000 * t + r``), one round trip per cell. Its fault draws are the
    reference's, so the grid equals the reference's cell for cell."""
    dev = device_mod.resolve(device)
    params = _to_device(params, dev)
    policy = _as_policy(policy, dev)
    enc = policy.encode_tree(params)
    if eval_fn is None:
        eval_fn = _default_eval(fwd, tmpl, dev, n_classes=n_classes, img=img,
                                eval_batch=eval_batch, eval_seed=eval_seed)
        metric = "accuracy"
    else:
        metric = "custom"
    rates = tuple(float(r) for r in rates)
    be = policy.backend
    clean = float(eval_fn(decode_tree(enc, torch.float32, backend=be)))
    t0 = time.perf_counter()
    grid = []
    for ri, rate in enumerate(rates):
        row = []
        for t in range(trials):
            dirty = inject_tree(enc, rate, seed + 1000 * t + ri) if rate \
                else enc
            row.append(float(eval_fn(decode_tree(dirty, torch.float32,
                                                 backend=be))))
        grid.append(tuple(row))
    wall = time.perf_counter() - t0
    return CampaignResult(
        scheme=_scheme_label(enc), metric=metric, rates=rates, trials=trials,
        clean=clean, grid=tuple(grid),
        space_overhead=float(space_overhead(enc)), compile_s=0.0,
        wall_clock_s=wall, batch="host", backend=be.name,
        **_device_fields(dev))

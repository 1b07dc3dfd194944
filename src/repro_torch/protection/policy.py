"""``ProtectionPolicy`` — which leaves of a parameter tree get protected,
and how.

Counterpart of ``repro.protection.policy``: ``predicate`` (default
``wot.is_protected_weight``: matmul/conv/embedding weights, not norms or
biases) picks the protectable leaves; ordered regex ``rules`` give a leaf
another scheme or none, so one model mixes schemes; tensors whose last dim
is not a block multiple are padded into the flat layout (``pad``) or left
as coverage gaps; ``throttle`` applies the WOT clamp before encoding; and
each leaf's codec route resolves from ``backend_rules``, then the
shape-keyed ``autotune`` table, then ``backend``. Beside it, the
policy-free tree ops the campaigns use: decode (with and without fault
flags), host and device fault injection, the space overhead, and the
sharding specs of an encoded tree (:func:`spec_tree`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.core import faults, quant, wot
from repro_torch.distributed import local

from .backends import AutotuneTable, get_backend
from .schemes import Scheme, get_scheme
from .tensor import ProtectedTensor, is_protected_tensor

__all__ = ["ProtectionPolicy", "CoverageReport", "CoverageEntry",
           "decode_leaf", "decode_leaf_with_flags", "decode_tree",
           "decode_tree_with_flags", "inject_tree", "inject_tree_device",
           "space_overhead", "spec_tree", "path_str"]

BLOCK = 8
path_str = tree.path_str


@dataclasses.dataclass(frozen=True)
class CoverageEntry:
    path: str
    scheme_id: Optional[str]   # None => not protected
    reason: str                # "" | "predicate" | "rule" | "unaligned"
    n_weights: int
    nbytes: int                # stored bytes if protected, raw bytes if not
    pad_bytes: int

    @property
    def protected(self) -> bool:
        return self.scheme_id is not None


@dataclasses.dataclass
class CoverageReport:
    """What a policy does to every leaf of a tree."""

    entries: list

    @property
    def protected(self) -> list:
        return [e for e in self.entries if e.protected]

    @property
    def unprotected(self) -> list:
        return [e for e in self.entries if not e.protected]

    @property
    def n_protected(self) -> int:
        return len(self.protected)

    @property
    def n_unprotected(self) -> int:
        return len(self.unprotected)

    @property
    def protected_bytes(self) -> int:
        return sum(e.nbytes for e in self.protected)

    @property
    def unprotected_bytes(self) -> int:
        return sum(e.nbytes for e in self.unprotected)

    @property
    def unprotected_weight_bytes(self) -> int:
        """Bytes of weight leaves left unprotected as unaligned
        (``pad=False``): the coverage gaps."""
        return sum(e.nbytes for e in self.unprotected
                   if e.reason == "unaligned")

    @property
    def pad_bytes(self) -> int:
        return sum(e.pad_bytes for e in self.protected)

    def by_scheme(self) -> dict:
        out: dict = {}
        for e in self.protected:
            out[e.scheme_id] = out.get(e.scheme_id, 0) + 1
        return out

    def summary(self) -> str:
        lines = [f"protection coverage: {len(self.protected)} tensors "
                 f"protected ({self.protected_bytes / 2**20:.2f} MiB stored), "
                 f"{len(self.unprotected)} unprotected "
                 f"({self.unprotected_bytes / 2**20:.2f} MiB)"]
        for sid, n in sorted(self.by_scheme().items()):
            lines.append(f"  scheme {sid}: {n} tensors")
        if self.pad_bytes:
            lines.append(f"  flat-padded layout added {self.pad_bytes} "
                         f"pad bytes")
        gaps = [e for e in self.unprotected if e.reason == "unaligned"]
        if gaps:
            lines.append(f"  WARNING: {len(gaps)} weight tensors "
                         f"({self.unprotected_weight_bytes} bytes) left "
                         f"unprotected (unaligned, pad=False):")
            lines.extend(f"    {e.path} ({e.n_weights} elems)" for e in gaps)
        return "\n".join(lines)


class ProtectionPolicy:
    """Per-leaf protection strategy.

    default_scheme: scheme id of every leaf the predicate selects.
    rules:          ordered ``(pattern, scheme_id_or_None)`` pairs; the first
                    regex that matches the leaf's path wins; ``None`` (or
                    ``"none"``) leaves that leaf unprotected.
    predicate:      ``(path, leaf) -> bool`` choosing the protectable leaves
                    (default ``wot.is_protected_weight``; the paper's CNN
                    evaluation protects every leaf of >= 2 dims).
    pad:            pad tensors whose last dim is not a multiple of 8 into
                    the flat layout (default), or leave them unprotected
                    (reason "unaligned").
    throttle:       WOT-clamp the quantized weights before encoding
                    (idempotent on WOT-trained weights; the in-place code
                    needs it).
    backend:        "torch" | "cuda" | a Backend: the default codec route.
    backend_rules:  ordered ``(pattern, backend)`` pairs resolved per leaf.
    autotune:       an :class:`AutotuneTable` (or the path of its JSON)
                    consulted by shape when no backend rule matches.
    """

    def __init__(self, default_scheme: str = "in-place",
                 rules: Sequence = (), predicate: Optional[Callable] = None,
                 *, pad: bool = True, throttle: bool = True,
                 backend="torch", backend_rules: Sequence = (),
                 autotune=None):
        get_scheme(default_scheme)  # validate eagerly
        self.default_scheme = default_scheme
        self.rules = [(re.compile(pat), sid) for pat, sid in rules]
        for _, sid in self.rules:
            if sid not in (None, "none"):
                get_scheme(sid)
        self.predicate = predicate or wot.is_protected_weight
        self.pad = pad
        self.throttle = throttle
        self.backend = get_backend(backend)
        self.backend_rules = [(re.compile(pat), get_backend(be))
                              for pat, be in backend_rules]
        if isinstance(autotune, (str, bytes)):
            autotune = AutotuneTable.from_json(autotune)
        self.autotune = autotune

    # -- selection -----------------------------------------------------------

    def scheme_for(self, path, leaf) -> Optional[Scheme]:
        """Scheme for one leaf, or None if it stays unprotected."""
        sid, _ = self._plan(path, leaf)
        return get_scheme(sid) if sid is not None else None

    def _plan(self, path, leaf) -> tuple:
        """-> (scheme_id | None, reason), in the reference's precedence:
        predicate, then the first matching rule, then alignment."""
        if not self.predicate(path, leaf):
            return None, "predicate"
        sid = self.default_scheme
        p = path_str(path)
        for pat, rule_sid in self.rules:
            if pat.search(p):
                if rule_sid in (None, "none"):
                    return None, "rule"
                sid = rule_sid
                break
        aligned = leaf.ndim >= 1 and leaf.shape[-1] % BLOCK == 0
        if not aligned and not self.pad:
            return None, "unaligned"
        return sid, ""

    def resolve_backend(self, path: str, shape) -> tuple:
        """Per-leaf route: the first matching backend rule, then the
        autotune table by shape, then the policy default.
        -> ``(Backend, "rule" | "autotune" | "policy")``."""
        for pat, be in self.backend_rules:
            if pat.search(path):
                return be, "rule"
        if self.autotune is not None:
            best = self.autotune.lookup(shape)
            if best is not None:
                return get_backend(best), "autotune"
        return self.backend, "policy"

    def plan(self, params, *, mesh=None, param_spec_fn=None):
        """Materialize every per-leaf decision once (see ``plan.make_plan``;
        ``mesh`` and ``param_spec_fn`` add each leaf's sharding spec)."""
        from .plan import make_plan
        return make_plan(self, params, mesh=mesh,
                         param_spec_fn=param_spec_fn)

    # -- leaf codec ----------------------------------------------------------

    def encode_leaf(self, w: torch.Tensor, scheme,
                    backend=None) -> ProtectedTensor:
        """float weight -> quantize -> WOT throttle (``throttle``) ->
        scheme-encode, on ``backend`` (default the policy's)."""
        scheme = get_scheme(scheme)
        be = self.backend if backend is None else get_backend(backend)
        # quantize (+ throttle) over whole blocks: a ragged tail is
        # zero-padded in f32, which changes neither the scale nor any real
        # q, and quantizes to the flat layout's zero pad
        blocks = wot.as_blocks(w)
        if self.throttle:
            q, scale = be.quantize_throttle(blocks)
        else:
            q, scale = quant.quantize(blocks.to(torch.float32))
        if w.ndim >= 1 and w.shape[-1] % BLOCK == 0:
            q_img = q.reshape(w.shape)        # same-shape layout
        else:
            q_img = q.reshape(-1)             # flat-padded layout
        enc, checks = scheme.encode(q_img, be)
        return ProtectedTensor(enc=enc, checks=checks,
                               scale=scale.to(torch.float32),
                               scheme_id=scheme.scheme_id,
                               orig_shape=tuple(w.shape))

    def decode_leaf(self, pt: ProtectedTensor, dtype=torch.bfloat16):
        return decode_leaf(pt, dtype, backend=self.backend)

    # -- tree codec (views over the plan) ------------------------------------

    def encode_tree(self, params):
        return self.plan(params).encode_tree(params)

    def decode_tree(self, enc_tree, dtype=torch.bfloat16):
        """Decode with per-leaf backend resolution (rules + autotune)."""
        if not self.backend_rules and self.autotune is None:
            return decode_tree(enc_tree, dtype, backend=self.backend)

        def dec(path, leaf):
            if not is_protected_tensor(leaf):
                return leaf
            be, _ = self.resolve_backend(path_str(path), leaf.orig_shape)
            return decode_leaf(leaf, dtype, backend=be)
        return tree.map_with_path(dec, enc_tree)

    def coverage(self, params) -> CoverageReport:
        return self.plan(params).coverage()


def _dequant(pt: ProtectedTensor, q, dtype):
    if pt.is_flat:
        q = q.reshape(-1)[: pt.n_weights].reshape(pt.orig_shape)
    return (q.to(torch.float32) * pt.scale).to(dtype)


def decode_leaf(pt: ProtectedTensor, dtype=torch.bfloat16, *,
                backend="torch"):
    """ProtectedTensor -> dequantized weight tensor (faults corrected)."""
    if local.is_dtensor(pt.enc):
        return local.decode_leaf_with_flags(pt, dtype, backend)[0]
    q = get_scheme(pt.scheme_id).decode(pt.enc, pt.checks,
                                        get_backend(backend))
    return _dequant(pt, q, dtype)


def decode_leaf_with_flags(pt: ProtectedTensor, dtype=torch.bfloat16, *,
                           backend="torch"):
    """ProtectedTensor -> ``(dequantized weight, corrected, due)`` with int32
    scalar counts of repaired and detected-uncorrectable blocks. A sharded
    image (a DTensor ``enc``) decodes shard by shard, its counts summed
    over the shards (``distributed.local``)."""
    if local.is_dtensor(pt.enc):
        return local.decode_leaf_with_flags(pt, dtype, backend)
    scheme = get_scheme(pt.scheme_id)
    q, corrected, due = scheme.decode_with_flags(pt.enc, pt.checks,
                                                 get_backend(backend))
    return _dequant(pt, q, dtype), corrected, due


def decode_tree(enc_tree, dtype=torch.bfloat16, *, backend="torch"):
    """Decode every ProtectedTensor leaf; other leaves pass through."""
    be = get_backend(backend)
    return tree.map_with_path(
        lambda _, x: decode_leaf(x, dtype, backend=be)
        if is_protected_tensor(x) else x, enc_tree)


def decode_tree_with_flags(enc_tree, dtype=torch.bfloat16, *,
                           backend="torch"):
    """Decode every ProtectedTensor leaf and collect its fault flags ->
    ``(decoded_tree, {path: (corrected, due)})``, paths in tree order."""
    be = get_backend(backend)
    flags: dict = {}

    def dec(path, leaf):
        if not is_protected_tensor(leaf):
            return leaf
        w, corrected, due = decode_leaf_with_flags(leaf, dtype, backend=be)
        flags[path_str(path)] = (corrected, due)
        return w

    return tree.map_with_path(dec, enc_tree), flags


def _image(pt: ProtectedTensor) -> torch.Tensor:
    """A leaf's whole stored image, ``enc ‖ checks`` flattened (the check
    bytes sit in the same fault-prone memory)."""
    enc = pt.enc.reshape(-1)
    return enc if pt.checks is None else torch.cat(
        [enc, pt.checks.reshape(-1)])


def _with_image(pt: ProtectedTensor, image) -> ProtectedTensor:
    """``pt`` over a (flipped) image from :func:`_image`; ``image`` may
    carry leading dims (a stack of cells' images)."""
    lead = tuple(image.shape[:-1])
    if pt.checks is None:
        return dataclasses.replace(
            pt, enc=image.reshape(lead + tuple(pt.enc.shape)))
    n = pt.enc.numel()
    return dataclasses.replace(
        pt, enc=image[..., :n].reshape(lead + tuple(pt.enc.shape)),
        checks=image[..., n:].reshape(lead + tuple(pt.checks.shape)))


def inject_tree(enc_tree, rate: float, seed: int):
    """Host-side memory-fault injection (the reference's ``inject_tree``,
    byte for byte): the i-th protected leaf in tree order (from 1) gets
    NumPy's ``faults.inject`` with seed ``seed + i`` over its whole stored
    image, weight and check bytes. The flipped images go back to each
    leaf's device."""
    i = 0

    def inj(_, pt):
        nonlocal i
        if not is_protected_tensor(pt):
            return pt
        i += 1
        image = _image(pt)
        flipped = faults.inject(image.cpu().numpy(), rate, seed + i)
        return _with_image(pt, torch.from_numpy(flipped).to(image.device))

    return tree.map_with_path(inj, enc_tree)


def inject_tree_device(enc_tree, rate: float, generator: torch.Generator,
                       *, one_per_block: bool = False, hit_blocks=None,
                       max_rate: Optional[float] = None):
    """On-device memory-fault injection into every ProtectedTensor's stored
    image (``faults.inject_torch`` per leaf, in tree order; with
    ``one_per_block`` at most one flip lands in each 64-bit block). A leaf
    with check bytes is injected as ONE image ``enc ‖ checks`` (flattened
    and joined), as the reference injects it: the check bytes sit in the
    same fault-prone memory. ``hit_blocks``, a dict kept across calls,
    holds per leaf path the blocks flipped so far (see
    ``faults.flip_positions_``): with ``one_per_block`` repeated injections
    then never put a second flip into a block.

    ``max_rate`` switches to ``faults.inject_torch_rate``, the campaigns'
    injector: each leaf draws the sample budget of ``max_rate`` and keeps
    the first ``round(bits * rate)`` positions, so the rates of one sweep
    consume the generator alike (``one_per_block``/``hit_blocks`` do not
    apply).

    -> ``(new_tree, {path: flipped global bit positions of that image})``.
    """
    if max_rate is not None and (one_per_block or hit_blocks is not None):
        raise ValueError("max_rate draws the campaigns' sample budget; "
                         "one_per_block and hit_blocks do not apply to it")
    positions: dict = {}

    def inj(path, pt):
        if not is_protected_tensor(pt):
            return pt
        key = path_str(path)
        image = _image(pt)
        if max_rate is not None:
            image, positions[key] = faults.inject_torch_rate(
                image, rate, generator, max_rate)
            return _with_image(pt, image)
        hits = None
        if hit_blocks is not None:
            if key not in hit_blocks:
                hit_blocks[key] = torch.zeros(
                    -(-image.numel() * 8 // faults.BLOCK_BITS),
                    dtype=torch.bool, device=image.device)
            hits = hit_blocks[key]
        image, positions[key] = faults.inject_torch(
            image, rate, generator, one_per_block=one_per_block,
            hit_blocks=hits)
        return _with_image(pt, image)

    return tree.map_with_path(inj, enc_tree), positions


def spec_tree(enc_tree, param_spec_fn, *, mesh=None):
    """Sharding specs for an encoded tree: a same-shape image inherits the
    weight's spec byte for byte; check bytes and scales are replicated.
    Flat-padded images replicate by default; with ``mesh`` they get the 1-D
    block-aligned sharded spec (``plan._flat_spec``). A
    :class:`~repro_torch.protection.plan.ProtectionPlan` materializes
    these specs once per leaf."""
    from repro_torch.distributed.sharding import P, mesh_sizes

    from .plan import _flat_spec

    sizes = mesh_sizes(mesh)

    def spec(path, leaf):
        if is_protected_tensor(leaf):
            enc_spec = (_flat_spec(int(leaf.enc.shape[0]), sizes)
                        if leaf.is_flat else param_spec_fn(path, leaf.enc))
            checks_spec = None if leaf.checks is None else P()
            return ProtectedTensor(enc=enc_spec, checks=checks_spec,
                                   scale=P(), scheme_id=leaf.scheme_id,
                                   orig_shape=tuple(leaf.orig_shape))
        return param_spec_fn(path, leaf)

    return tree.map_with_path(spec, enc_tree)


def space_overhead(enc_tree) -> float:
    """(stored - weight) / weight bytes over all protected leaves."""
    stored = weights = 0
    for _, leaf in tree.leaves_with_path(enc_tree):
        if is_protected_tensor(leaf):
            stored += leaf.stored_bytes
            weights += leaf.n_weights
    return (stored - weights) / max(weights, 1)

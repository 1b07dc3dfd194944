"""``ProtectionPolicy`` — which leaves of a parameter tree get protected.

Counterpart of ``repro.protection.policy`` for a single-scheme policy with
the reference's defaults: ``wot.is_protected_weight`` picks the protectable
leaves (matmul/embedding weights, not norms or biases), every one of them
is quantized, WOT-throttled and encoded under the default scheme, and
tensors whose last dim is not a block multiple are padded into the flat
layout. Per-leaf regex rules, backend rules, the autotune table and the
``predicate``/``pad``/``throttle`` options are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import faults, wot

from .backends import get_backend
from .schemes import get_scheme
from .tensor import ProtectedTensor, is_protected_tensor

__all__ = ["ProtectionPolicy", "CoverageReport", "CoverageEntry",
           "decode_leaf_with_flags", "inject_tree_device", "path_str"]

BLOCK = 8
path_str = tree.path_str


@dataclasses.dataclass(frozen=True)
class CoverageEntry:
    path: str
    scheme_id: Optional[str]   # None => not protected
    reason: str                # "" | "predicate"
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
    def protected_bytes(self) -> int:
        return sum(e.nbytes for e in self.protected)

    @property
    def unprotected_bytes(self) -> int:
        return sum(e.nbytes for e in self.unprotected)

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
        return "\n".join(lines)


class ProtectionPolicy:
    """Single-scheme protection strategy.

    default_scheme: scheme id applied to every protectable leaf.
    backend:        "torch" | "cuda" | a Backend — the block-codec route.
    """

    def __init__(self, default_scheme: str = "in-place", *, backend="torch"):
        get_scheme(default_scheme)  # validate eagerly
        self.default_scheme = default_scheme
        self.backend = get_backend(backend)

    def _plan(self, path, leaf) -> tuple:
        """-> (scheme_id | None, reason)."""
        if not wot.is_protected_weight(path, leaf):
            return None, "predicate"
        return self.default_scheme, ""

    def plan(self, params):
        """Materialize every per-leaf decision once (see ``plan.make_plan``)."""
        from .plan import make_plan
        return make_plan(self, params)

    def encode_leaf(self, w: torch.Tensor, scheme) -> ProtectedTensor:
        """float weight -> quantize -> WOT throttle -> scheme-encode."""
        scheme = get_scheme(scheme)
        # quantize + WOT throttle on the backend's route over whole blocks:
        # a ragged tail is zero-padded in f32, which changes neither the
        # scale nor any real q, and quantizes to the flat layout's zero pad
        q, scale = self.backend.quantize_throttle(wot.as_blocks(w))
        if w.ndim >= 1 and w.shape[-1] % BLOCK == 0:
            q_img = q.reshape(w.shape)        # same-shape layout
        else:
            q_img = q.reshape(-1)             # flat-padded layout
        enc, checks = scheme.encode(q_img, self.backend)
        return ProtectedTensor(enc=enc, checks=checks,
                               scale=scale.to(torch.float32),
                               scheme_id=scheme.scheme_id,
                               orig_shape=tuple(w.shape))

    def encode_tree(self, params):
        return self.plan(params).encode_tree(params)

    def coverage(self, params) -> CoverageReport:
        return self.plan(params).coverage()


def decode_leaf_with_flags(pt: ProtectedTensor, dtype=torch.bfloat16, *,
                           backend="torch"):
    """ProtectedTensor -> ``(dequantized weight, corrected, due)`` with int32
    scalar counts of repaired and detected-uncorrectable blocks."""
    scheme = get_scheme(pt.scheme_id)
    q, corrected, due = scheme.decode_with_flags(pt.enc, pt.checks,
                                                 get_backend(backend))
    if pt.is_flat:
        q = q.reshape(-1)[: pt.n_weights].reshape(pt.orig_shape)
    return (q.to(torch.float32) * pt.scale).to(dtype), corrected, due


def inject_tree_device(enc_tree, rate: float, generator: torch.Generator,
                       *, one_per_block: bool = False, hit_blocks=None):
    """On-device memory-fault injection into every ProtectedTensor's stored
    image (``faults.inject_torch`` per leaf, in tree order; with
    ``one_per_block`` at most one flip lands in each 64-bit block). A leaf
    with check bytes is injected as ONE image ``enc ‖ checks`` (flattened
    and joined), as the reference injects it: the check bytes sit in the
    same fault-prone memory. ``hit_blocks``, a dict kept across calls,
    holds per leaf path the blocks flipped so far (see
    ``faults.flip_positions_``): with ``one_per_block`` repeated injections
    then never put a second flip into a block.

    -> ``(new_tree, {path: flipped global bit positions of that image})``.
    """
    positions: dict = {}

    def inj(path, pt):
        if not is_protected_tensor(pt):
            return pt
        key = path_str(path)
        enc = pt.enc.reshape(-1)
        image = enc if pt.checks is None else torch.cat(
            [enc, pt.checks.reshape(-1)])
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
        if pt.checks is None:
            return dataclasses.replace(pt, enc=image.reshape(pt.enc.shape))
        n = enc.numel()
        return dataclasses.replace(
            pt, enc=image[:n].reshape(pt.enc.shape),
            checks=image[n:].reshape(pt.checks.shape))

    return tree.map_with_path(inj, enc_tree), positions

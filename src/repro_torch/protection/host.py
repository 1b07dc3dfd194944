"""Host-side NumPy trial pipeline — a thin wrapper over the schemes.

Counterpart of ``repro.protection.host``: the per-trial Table-2
experiment surface. Encode a flat int8 weight vector into its stored byte
image, flip bits in the whole image (check bytes included), decode, and
measure. It is also the cross-check oracle of the campaigns
(``repro_torch.protection.campaign``). The fault draws are NumPy's, so a
trial flips the same bits as the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import faults

from .schemes import Scheme, get_scheme

__all__ = ["Stored", "HostScheme", "get_host_scheme", "run_fault_trial"]

BLOCK = 8


@dataclasses.dataclass
class Stored:
    """Byte image of one protected flat weight vector."""
    data: np.ndarray              # (n_padded,) uint8 — weight bytes
    checks: np.ndarray | None     # out-of-place check bytes or None
    n_weights: int                # original length (pre-padding)

    @property
    def total_bytes(self) -> int:
        return self.data.size + (self.checks.size if self.checks is not None
                                 else 0)


class HostScheme:
    """NumPy facade over a ``Scheme`` (one per registry id). The codec runs
    on the plain route on the CPU; ``encode`` and ``decode`` take
    ``device=`` a CUDA device to run it there on the kernel route
    (byte-equal), the bytes coming back to the host."""

    def __init__(self, scheme):
        self._scheme: Scheme = get_scheme(scheme)

    @property
    def scheme_id(self) -> str:
        return self._scheme.scheme_id

    @property
    def name(self) -> str:
        return self._scheme.paper_name

    @property
    def needs_ecc_hw(self) -> bool:
        return self._scheme.needs_ecc_hw

    def encode(self, q_flat: np.ndarray, *, device=None) -> Stored:
        q = np.asarray(q_flat, dtype=np.int8).reshape(-1)
        pad = (-q.size) % BLOCK
        padded = np.concatenate([q, np.zeros(pad, np.int8)]) if pad else q
        dev, be = _route(device)
        enc, checks = self._scheme.encode(
            torch.from_numpy(padded.copy()).to(dev), be)
        return Stored(data=enc.cpu().numpy().copy(),
                      checks=None if checks is None else checks.cpu().numpy(),
                      n_weights=q.size)

    def decode(self, s: Stored, *, device=None) -> np.ndarray:
        dev, be = _route(device)
        checks = None if s.checks is None else \
            torch.from_numpy(s.checks).to(dev)
        dec = self._scheme.decode(torch.from_numpy(s.data).to(dev), checks,
                                  be)
        return dec.cpu().numpy().astype(np.int8)[: s.n_weights].copy()

    def inject(self, s: Stored, rate: float, seed: int) -> Stored:
        """Flip bits across the whole stored image (data + check bytes)."""
        if s.checks is None:
            return Stored(faults.inject(s.data, rate, seed), None, s.n_weights)
        image = np.concatenate([s.data, s.checks.reshape(-1)])
        flipped = faults.inject(image, rate, seed)
        return Stored(flipped[: s.data.size],
                      flipped[s.data.size:].reshape(s.checks.shape),
                      s.n_weights)

    def space_overhead(self, s: Stored) -> float:
        return (s.total_bytes - s.n_weights) / s.n_weights


def _route(device) -> tuple:
    """(device, backend) of a codec call: the CPU's plain route by
    default, the kernels on a CUDA device."""
    dev = torch.device("cpu" if device is None else device)
    return dev, ("cuda" if dev.type == "cuda" else "torch")


def get_host_scheme(name) -> HostScheme:
    return HostScheme(name)


def run_fault_trial(scheme, q_flat: np.ndarray, rate: float,
                    seed: int) -> np.ndarray:
    """encode -> inject faults -> decode: the per-trial pipeline of Table 2."""
    sch = scheme if isinstance(scheme, HostScheme) else get_host_scheme(scheme)
    stored = sch.encode(q_flat)
    return sch.decode(sch.inject(stored, rate, seed))

"""Protection schemes ``faulty`` and ``in-place``.

Counterpart of ``repro.protection.schemes``. A scheme maps int8 weight
arrays (trailing dim a multiple of 8) to the stored byte image and back:

  faulty    raw bytes, no protection                  (paper "faulty")
  in-place  in-place zero-space SEC-DED (64,57,1), 0% (paper "in-place")

``parity-zero`` and ``secded72`` are not ported yet.
"""
from __future__ import annotations

import torch

from .backends import Backend, get_backend

__all__ = ["Scheme", "Faulty", "InPlace", "SCHEMES", "ALIASES", "get_scheme",
           "scheme_ids"]

BLOCK = 8


def _as_bytes(q: torch.Tensor) -> torch.Tensor:
    return q if q.dtype == torch.uint8 else q.to(torch.int8).view(torch.uint8)


def _as_int8(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.int8)


def _blocks(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(*b.shape[:-1], b.shape[-1] // BLOCK, BLOCK)


class Scheme:
    """Base interface. Subclasses are stateless; use ``get_scheme``."""

    scheme_id: str = "faulty"
    check_ratio: float = 0.0
    requires_wot: bool = False

    def encode(self, q, backend: Backend | str = "torch"):
        """int8 (..., n), n % 8 == 0 -> (enc uint8 (..., n), checks | None)."""
        raise NotImplementedError

    def decode_with_flags(self, enc, checks, backend: Backend | str = "torch"):
        """-> ``(decoded int8, corrected, due)``, the counts int32 scalars."""
        raise NotImplementedError


class Faulty(Scheme):
    scheme_id = "faulty"

    def encode(self, q, backend="torch"):
        return _as_bytes(q), None

    def decode_with_flags(self, enc, checks, backend="torch"):
        zero = torch.zeros((), dtype=torch.int32, device=enc.device)
        return _as_int8(enc), zero, zero


class InPlace(Scheme):
    """Check bits in the non-informative bit 6 of bytes 0..6 of every
    8-byte block. Requires WOT-compliant weights."""

    scheme_id = "in-place"
    requires_wot = True

    def encode(self, q, backend="torch"):
        data = _as_bytes(q)
        return get_backend(backend).encode64(_blocks(data)).reshape(
            data.shape), None

    def decode_with_flags(self, enc, checks, backend="torch"):
        dec, single, double = get_backend(backend).decode64(_blocks(enc))
        return (_as_int8(dec.reshape(enc.shape)),
                single.sum(dtype=torch.int32), double.sum(dtype=torch.int32))


SCHEMES: dict = {s.scheme_id: s for s in (Faulty(), InPlace())}
ALIASES = {"none": "faulty", "inplace": "in-place"}


def get_scheme(name) -> Scheme:
    """Resolve a scheme id (or paper alias, or Scheme instance)."""
    if isinstance(name, Scheme):
        return name
    key = ALIASES.get(name, name)
    try:
        return SCHEMES[key]
    except KeyError:
        raise ValueError(f"unknown or unported scheme {name!r}; one of "
                         f"{sorted(SCHEMES) + sorted(ALIASES)}") from None


def scheme_ids() -> tuple:
    return tuple(SCHEMES)

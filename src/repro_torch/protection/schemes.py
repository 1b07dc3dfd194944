"""Protection schemes (the paper's §5.1 baselines and its contribution).

Counterpart of ``repro.protection.schemes``. A scheme maps int8 weight
arrays (trailing dim a multiple of 8) to the stored byte image and back:

  faulty       raw bytes, no protection                      (paper "faulty")
  parity-zero  byte parity, detected-faulty byte -> 0        (paper "zero")
  secded72     standard SEC-DED (72,64,1), 12.5% overhead    (paper "ecc")
  in-place     in-place zero-space SEC-DED (64,57,1), 0%     (paper "in-place")

Only the in-place code routes its block compute through a backend (the
CUDA codec kernels on ``cuda``); ``parity-zero`` and ``secded72`` are plain
PyTorch on every route, as the reference computes them outside any Pallas
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ecc

from .backends import Backend, get_backend

__all__ = ["Scheme", "Faulty", "ParityZero", "Secded72", "InPlace", "SCHEMES",
           "ALIASES", "get_scheme", "scheme_ids"]

BLOCK = 8


def _as_bytes(q: torch.Tensor) -> torch.Tensor:
    return q if q.dtype == torch.uint8 else q.to(torch.int8).view(torch.uint8)


def _as_int8(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.int8)


def _blocks(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(*b.shape[:-1], b.shape[-1] // BLOCK, BLOCK)


def _count(flags: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """int32 count of set flags over all but the first ``batch_dims`` dims
    (a scalar for 0)."""
    return flags.reshape(*flags.shape[:batch_dims], -1).sum(
        -1, dtype=torch.int32)


class Scheme:
    """Base interface. Subclasses are stateless; use ``get_scheme``.

    ``decode_with_flags(..., batch_dims=k)`` counts the flags per index of
    the first ``k`` dims of a stacked image (the campaigns decode many
    cells' images of one leaf in one call); ``k = 0`` gives scalars."""

    scheme_id: str = "faulty"
    paper_name: str = "faulty"      # row label in the paper's Table 2
    needs_ecc_hw: bool = False      # needs the Fig.-2 swizzle + ECC logic
    check_ratio: float = 0.0
    requires_wot: bool = False

    def encode(self, q, backend: Backend | str = "torch"):
        """int8 (..., n), n % 8 == 0 -> (enc uint8 (..., n), checks | None)."""
        raise NotImplementedError

    def decode(self, enc, checks, backend: Backend | str = "torch"):
        """Stored image -> int8 (..., n), corrected/zeroed per the scheme."""
        return self.decode_with_flags(enc, checks, backend)[0]

    def decode_with_flags(self, enc, checks, backend: Backend | str = "torch",
                          *, batch_dims: int = 0):
        """-> ``(decoded int8, corrected, due)``, the counts int32."""
        raise NotImplementedError


class Faulty(Scheme):
    scheme_id = "faulty"

    def encode(self, q, backend="torch"):
        return _as_bytes(q), None

    def decode_with_flags(self, enc, checks, backend="torch", *,
                          batch_dims=0):
        zero = torch.zeros(enc.shape[:batch_dims], dtype=torch.int32,
                           device=enc.device)
        return _as_int8(enc), zero, zero


class ParityZero(Scheme):
    """One parity bit per byte, packed into a check byte per 8 bytes; a
    byte whose parity fails decodes to 0 and counts as corrected."""

    scheme_id = "parity-zero"
    paper_name = "zero"
    check_ratio = 1.0 / BLOCK

    def encode(self, q, backend="torch"):
        data = _as_bytes(q)
        return data, ecc.encode_parity8(data)

    def decode_with_flags(self, enc, checks, backend="torch", *,
                          batch_dims=0):
        data, bad = ecc.decode_parity8(enc, checks)
        # zeroing a detected-faulty byte IS this scheme's repair action
        return (_as_int8(data), _count(bad, batch_dims),
                torch.zeros(enc.shape[:batch_dims], dtype=torch.int32,
                            device=enc.device))


class Secded72(Scheme):
    """Standard (72,64,1) SEC-DED: one out-of-place check byte per 8-byte
    block."""

    scheme_id = "secded72"
    paper_name = "ecc"
    needs_ecc_hw = True
    check_ratio = 1.0 / BLOCK

    def encode(self, q, backend="torch"):
        data = _as_bytes(q)
        return data, ecc.encode72(_blocks(data))

    def decode_with_flags(self, enc, checks, backend="torch", *,
                          batch_dims=0):
        dec, single, double = ecc.decode72(_blocks(enc), checks)
        return (_as_int8(dec.reshape(enc.shape)), _count(single, batch_dims),
                _count(double, batch_dims))


class InPlace(Scheme):
    """Check bits in the non-informative bit 6 of bytes 0..6 of every
    8-byte block. Requires WOT-compliant weights."""

    scheme_id = "in-place"
    paper_name = "in-place"
    needs_ecc_hw = True
    requires_wot = True

    def encode(self, q, backend="torch"):
        data = _as_bytes(q)
        return get_backend(backend).encode64(_blocks(data)).reshape(
            data.shape), None

    def decode_with_flags(self, enc, checks, backend="torch", *,
                          batch_dims=0):
        dec, single, double = get_backend(backend).decode64(_blocks(enc))
        return (_as_int8(dec.reshape(enc.shape)), _count(single, batch_dims),
                _count(double, batch_dims))


SCHEMES: dict = {s.scheme_id: s for s in
                  (Faulty(), ParityZero(), Secded72(), InPlace())}
# the paper's Table-2 row names and the historical ids resolve too
ALIASES = {"none": "faulty", "zero": "parity-zero", "parity8": "parity-zero",
           "ecc": "secded72", "inplace": "in-place"}


def get_scheme(name) -> Scheme:
    """Resolve a scheme id (or paper alias, or Scheme instance)."""
    if isinstance(name, Scheme):
        return name
    key = ALIASES.get(name, name)
    try:
        return SCHEMES[key]
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}; one of "
                         f"{sorted(SCHEMES) + sorted(ALIASES)}") from None


def scheme_ids() -> tuple:
    return tuple(SCHEMES)

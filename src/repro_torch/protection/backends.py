"""Backend dispatch: route the in-place code's block compute and the WOT
quantize / throttle steps.

Counterpart of ``repro.protection.backends``:

* ``"torch"`` — the plain PyTorch versions (``core.ecc``), the
  counterpart of the reference's ``"xla"`` route; runs on any device.
* ``"cuda"`` — the hand-written kernels (``kernels/``), the counterpart of
  ``"pallas"``. For a tensor on the card the wrapper launches its kernel or
  raises; for a tensor on the CPU it runs the plain version.

:class:`AutotuneTable` is the reference's shape-keyed backend and tile
table (``bench_kernels/v1``..``v6`` dicts), read by the policy's per-leaf
backend resolution.
"""
from __future__ import annotations

import json
import math

import torch

from repro_torch.core import ecc

__all__ = ["Backend", "TorchBackend", "CudaBackend", "get_backend", "BACKENDS",
           "AutotuneTable", "BACKEND_ALIASES", "BENCH_KERNELS_SCHEMAS"]


class Backend:
    """Interface: in-place-code block ops."""

    name = "abstract"

    def encode64(self, blocks: torch.Tensor) -> torch.Tensor:
        """(..., 8) uint8 WOT-compliant bytes -> encoded (..., 8)."""
        raise NotImplementedError

    def decode64(self, blocks: torch.Tensor):
        """(..., 8) uint8 encoded -> (decoded (..., 8), single, double)."""
        raise NotImplementedError

    def quantize_throttle(self, w: torch.Tensor, *, write_back=False,
                          with_q=True, amax_reduce=None):
        """(nblk, 8) f32 -> (WOT-compliant q int8 (nblk, 8), scale f32 ());
        with ``write_back`` any f32 ``w``, the moved masters written back
        in place; ``amax_reduce`` joins a shard's absmax across the shards
        (``kernels.quant_throttle.quantize_throttle``)."""
        raise NotImplementedError

    def throttle(self, q_blocks: torch.Tensor) -> torch.Tensor:
        """(nblk, 8) int8 -> WOT-throttled (nblk, 8) int8."""
        raise NotImplementedError


class TorchBackend(Backend):
    name = "torch"

    def encode64(self, blocks):
        return ecc.encode64(blocks)

    def decode64(self, blocks):
        return ecc.decode64(blocks)

    def quantize_throttle(self, w, *, write_back=False, with_q=True,
                          amax_reduce=None):
        from repro_torch.kernels.quant_throttle import quantize_throttle_plain
        return quantize_throttle_plain(w, write_back=write_back,
                                       with_q=with_q, amax_reduce=amax_reduce)

    def throttle(self, q_blocks):
        from repro_torch.kernels.throttle import throttle_plain
        return throttle_plain(q_blocks)


class CudaBackend(Backend):
    name = "cuda"

    def encode64(self, blocks):
        from repro_torch.kernels.ecc_encode import ecc_encode
        return ecc_encode(blocks.reshape(-1, 8)).reshape(blocks.shape)

    def decode64(self, blocks):
        from repro_torch.kernels.ecc_decode import ecc_decode
        dec, flags = ecc_decode(blocks.reshape(-1, 8))
        flags = flags.reshape(blocks.shape[:-1])
        return (dec.reshape(blocks.shape), (flags & 1).bool(),
                (flags & 2).bool())

    def quantize_throttle(self, w, *, write_back=False, with_q=True,
                          amax_reduce=None):
        from repro_torch.kernels.quant_throttle import quantize_throttle
        return quantize_throttle(w, write_back=write_back, with_q=with_q,
                                 amax_reduce=amax_reduce)

    def throttle(self, q_blocks):
        from repro_torch.kernels.throttle import throttle
        return throttle(q_blocks)


BACKENDS = {"torch": TorchBackend, "cuda": CudaBackend}
# the reference's route names, read as their counterparts: one autotune
# dict or backend rule feeds both packages
BACKEND_ALIASES = {"xla": "torch", "pallas": "cuda"}
BENCH_KERNELS_SCHEMAS = tuple(f"bench_kernels/v{i}" for i in range(6, 0, -1))


def _backend_name(name) -> str:
    name = BACKEND_ALIASES.get(name, name)
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; one of "
                         f"{sorted(BACKENDS) + sorted(BACKEND_ALIASES)}")
    return name


def _nblocks(shape) -> int:
    return int(math.prod(shape)) // 8 if shape else 0


class AutotuneTable:
    """Shape-keyed backend and tile choice (the reference's
    ``protection.backends.AutotuneTable``, same entries and lookups).

    Each entry is ``{"shape": [...], "nblocks": int, "best": backend, ...}``
    with optional ``"tiles": [bm, bn, bk]`` (v2+) and ``"int8_tiles": [bm,
    bn, 0]`` (v3+); ``best`` may name either package's route ("xla" reads
    as "torch", "pallas" as "cuda"). v4-v6 artifacts also carry
    ``attention``, ``attention_long`` and ``crossover``, kept for
    reporting and never consulted.

    :meth:`lookup` takes the exact shape first, then the nearest entry by
    64-bit block count within a factor of 4, else None (the policy's
    default then decides). :meth:`lookup_tiles_src` takes the exact shape,
    then the nearest tile-bearing entry with no ratio cap, and says which
    (``"exact"`` | ``"nearest"`` | ``""``). A plan records the tiles and
    their source per leaf as the reference's does; the port's CUDA kernels
    choose their own tiles and ignore them."""

    def __init__(self, entries=(), *, platform: str = "", source: str = "",
                 schema: str = BENCH_KERNELS_SCHEMAS[0], attention=(),
                 attention_long=(), crossover=None):
        self.attention = [dict(a) for a in attention]
        self.attention_long = [dict(a) for a in attention_long]
        self.crossover = dict(crossover) if crossover else None
        self.entries = []
        for e in entries:
            e = dict(e)
            shape = tuple(int(s) for s in e.get("shape", ()))
            if e.get("best") not in BACKENDS and \
                    e.get("best") not in BACKEND_ALIASES:
                raise ValueError(f"autotune entry for shape {shape} has "
                                 f"unknown best backend {e.get('best')!r}")
            e["shape"] = shape
            e.setdefault("nblocks", _nblocks(shape))
            for key in ("tiles", "int8_tiles"):
                if e.get(key) is not None:
                    e[key] = tuple(int(t) for t in e[key])
            self.entries.append(e)
        self.platform = platform
        self.source = source
        self.schema = schema
        self._by_shape = {e["shape"]: e for e in self.entries}

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def _closest(entries, nblk):
        return min(entries,
                   key=lambda e: abs(math.log(max(e["nblocks"], 1) / nblk)))

    def _nearest(self, shape):
        """Exact shape entry, else the nearest by block count within 4x."""
        shape = tuple(int(s) for s in shape)
        hit = self._by_shape.get(shape)
        if hit is not None:
            return hit
        nblk = _nblocks(shape)
        if nblk <= 0 or not self.entries:
            return None
        nearest = self._closest(self.entries, nblk)
        ratio = max(nearest["nblocks"], 1) / nblk
        return None if ratio > 4 or ratio < 0.25 else nearest

    def lookup(self, shape):
        """The port's backend name for a weight shape, or None."""
        e = self._nearest(shape)
        return _backend_name(e["best"]) if e is not None else None

    def lookup_tiles_src(self, shape, *, key: str = "tiles") -> tuple:
        """-> ``(tiles | None, "exact" | "nearest" | "")``."""
        shape = tuple(int(s) for s in shape)
        hit = self._by_shape.get(shape)
        if hit is not None and hit.get(key):
            return tuple(hit[key]), "exact"
        with_tiles = [e for e in self.entries if e.get(key)]
        nblk = _nblocks(shape)
        if nblk <= 0 or not with_tiles:
            return None, ""
        return tuple(self._closest(with_tiles, nblk)[key]), "nearest"

    def lookup_tiles(self, shape):
        """Float-kernel (bm, bn, bk) hint for a weight shape, or None."""
        return self.lookup_tiles_src(shape)[0]

    def lookup_int8_tiles(self, shape):
        """Int8-epilogue (bm, bn, 0) hint for a weight shape, or None."""
        return self.lookup_tiles_src(shape, key="int8_tiles")[0]

    def to_dict(self) -> dict:
        d = {"schema": self.schema, "platform": self.platform,
             "entries": [{**e, "shape": list(e["shape"]),
                          **{k: list(e[k]) for k in
                             ("tiles", "int8_tiles") if e.get(k)}}
                         for e in self.entries]}
        if self.attention:
            d["attention"] = [dict(a) for a in self.attention]
        if self.attention_long:
            d["attention_long"] = [dict(a) for a in self.attention_long]
        if self.crossover:
            d["crossover"] = dict(self.crossover)
        return d

    @classmethod
    def from_dict(cls, d: dict, *, source: str = "") -> "AutotuneTable":
        schema = d.get("schema", "")
        if schema and schema not in BENCH_KERNELS_SCHEMAS:
            raise ValueError(f"unsupported autotune schema {schema!r} "
                             f"(expected one of {BENCH_KERNELS_SCHEMAS})")
        return cls(d.get("entries", ()), platform=d.get("platform", ""),
                   source=source, schema=schema or BENCH_KERNELS_SCHEMAS[-1],
                   attention=d.get("attention", ()),
                   attention_long=d.get("attention_long", ()),
                   crossover=d.get("crossover"))

    @classmethod
    def from_json(cls, path) -> "AutotuneTable":
        with open(path) as f:
            return cls.from_dict(json.load(f), source=str(path))


def get_backend(backend) -> Backend:
    """Resolve a backend name (default ``"torch"``; the reference's "xla"
    and "pallas" read as "torch" and "cuda") or pass an instance."""
    if isinstance(backend, Backend):
        return backend
    return BACKENDS[_backend_name(backend or "torch")]()

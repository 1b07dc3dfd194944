"""Backend dispatch: route the in-place code's block compute.

Counterpart of ``repro.protection.backends``:

* ``"torch"`` — the plain PyTorch versions (``core.ecc``), the
  counterpart of the reference's ``"xla"`` route; runs on any device.
* ``"cuda"`` — the hand-written kernels (``kernels/``), the counterpart of
  ``"pallas"``. For a tensor on the card the wrapper launches its kernel or
  raises; for a tensor on the CPU it runs the plain version.

There is no autotune table yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import ecc

__all__ = ["Backend", "TorchBackend", "CudaBackend", "get_backend", "BACKENDS"]


class Backend:
    """Interface: in-place-code block ops."""

    name = "abstract"

    def encode64(self, blocks: torch.Tensor) -> torch.Tensor:
        """(..., 8) uint8 WOT-compliant bytes -> encoded (..., 8)."""
        raise NotImplementedError

    def decode64(self, blocks: torch.Tensor):
        """(..., 8) uint8 encoded -> (decoded (..., 8), single, double)."""
        raise NotImplementedError


class TorchBackend(Backend):
    name = "torch"

    def encode64(self, blocks):
        return ecc.encode64(blocks)

    def decode64(self, blocks):
        return ecc.decode64(blocks)


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


BACKENDS = {"torch": TorchBackend, "cuda": CudaBackend}


def get_backend(backend) -> Backend:
    """Resolve a backend name (default ``"torch"``) or pass an instance."""
    if isinstance(backend, Backend):
        return backend
    if backend is None:
        backend = "torch"
    try:
        return BACKENDS[backend]()
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; one of {sorted(BACKENDS)}") from None

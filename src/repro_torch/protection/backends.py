"""Backend dispatch: route the in-place code's block compute and the WOT
quantize / throttle steps.

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

    def quantize_throttle(self, w: torch.Tensor, *, write_back=False,
                          with_q=True):
        """(nblk, 8) f32 -> (WOT-compliant q int8 (nblk, 8), scale f32 ());
        with ``write_back`` any f32 ``w``, the moved masters written back
        in place (``kernels.quant_throttle.quantize_throttle``)."""
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

    def quantize_throttle(self, w, *, write_back=False, with_q=True):
        from repro_torch.kernels.quant_throttle import quantize_throttle_plain
        return quantize_throttle_plain(w, write_back=write_back,
                                       with_q=with_q)

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

    def quantize_throttle(self, w, *, write_back=False, with_q=True):
        from repro_torch.kernels.quant_throttle import quantize_throttle
        return quantize_throttle(w, write_back=write_back, with_q=with_q)

    def throttle(self, q_blocks):
        from repro_torch.kernels.throttle import throttle
        return throttle(q_blocks)


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

"""``ProtectedWeight`` — lazy decode-at-use view of one protected leaf.

Counterpart of ``repro.protection.fused`` on the float path. The serve step
wraps each per-layer ``ProtectedTensor`` in a view and defers all codec
work to the weight's point of use:

* ``matmul(x)`` — the projection path: on the ``cuda`` route an in-place
  2-D same-shape image goes through the fused decode+matmul kernel
  (``kernels.ecc_qmatmul``; decoded weights never reach device memory),
  otherwise the leaf decodes inline next to its matmul;
* ``astype(dtype)`` — decode just this leaf, for non-projection uses.

Both report ``(corrected, due)`` counts through the ``record`` callback
(the serve step's per-step :class:`~repro_torch.models.layers.FlagRecorder`).
``models.layers._proj`` recognizes the view by its ``decode_at_use``
attribute. Activation quantization, ABFT and clamps are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .backends import get_backend
from .policy import decode_leaf_with_flags
from .tensor import ProtectedTensor

__all__ = ["ProtectedWeight", "can_fuse", "is_matmul_weight"]


def can_fuse(pt: ProtectedTensor, backend) -> bool:
    """True when this leaf can route through the fused decode+matmul kernel:
    cuda backend, in-place scheme, 2-D same-shape image."""
    name = getattr(backend, "name", backend) or "torch"
    return (name == "cuda" and pt.scheme_id == "in-place"
            and not pt.is_flat and getattr(pt.enc, "ndim", 0) == 2)


def is_matmul_weight(path: str) -> bool:
    """True when the leaf is consumed as the RHS of a matmul (conv kernels,
    indexed elementwise, must decode to real tensors instead)."""
    return not path.rsplit("/", 1)[-1].startswith("conv")


class ProtectedWeight:
    """One leaf's decode-at-use view.

    pt:      the per-layer ProtectedTensor.
    backend: Backend instance or name for this leaf's codec compute.
    record:  ``record(corrected, due)`` flags callback (no-op when None).
    """

    decode_at_use = True  # the marker layers._proj dispatches on

    def __init__(self, pt: ProtectedTensor, backend="torch", *,
                 record: Optional[Callable] = None):
        self.pt = pt
        self.backend = get_backend(backend)
        self.fuse = can_fuse(pt, self.backend)
        self._record = record

    def record(self, corrected, due):
        if self._record is not None:
            self._record(corrected, due)

    def astype(self, dtype):
        """Decode just this leaf (recording flags) -> dequantized tensor."""
        w, corrected, due = decode_leaf_with_flags(self.pt, dtype,
                                                   backend=self.backend)
        self.record(corrected, due)
        return w

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ decode(self)`` with the decode at the point of use (float
        ``x``; int8 activations are not ported yet)."""
        if not x.dtype.is_floating_point:
            raise NotImplementedError("int8 activations (act_quant) are not "
                                      "ported yet")
        if not self.fuse:
            return x @ self.astype(x.dtype)
        from repro_torch.kernels.ecc_qmatmul import ecc_qmatmul
        lead = x.shape[:-1]
        out, flags = ecc_qmatmul(x.reshape(-1, x.shape[-1]), self.pt.enc,
                                 self.pt.scale)
        self.record(flags[0], flags[1])
        return out.to(x.dtype).reshape(*lead, self.pt.enc.shape[1])

    def __repr__(self):
        return (f"ProtectedWeight({self.pt!r}, backend={self.backend.name!r}, "
                f"fuse={self.fuse})")

"""``ProtectedTensor`` — the stored byte image of one protected weight.

Counterpart of ``repro.protection.tensor``. Two storage layouts:

* **same-shape** — ``enc`` has exactly the weight's shape (ECC blocks run
  along the last dim, which must be a multiple of 8);
* **flat-padded** — for tensors whose last dim is not a block multiple:
  ``enc`` is 1-D, the flattened weight padded up to a block multiple, and
  ``orig_shape`` recovers the tensor on decode.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["ProtectedTensor", "is_protected_tensor"]


@dataclasses.dataclass(frozen=True)
class ProtectedTensor:
    """enc: uint8 encoded bytes; checks: out-of-place check bytes or None;
    scale: f32 quantization scale (q = round(w / scale)); scheme_id: codec
    id; orig_shape: logical shape of the weight."""
    enc: Any
    checks: Any
    scale: Any
    scheme_id: str = "in-place"
    orig_shape: tuple = ()

    @property
    def n_weights(self) -> int:
        return int(math.prod(self.orig_shape))

    @property
    def stored_bytes(self) -> int:
        """Total bytes resident in fault-prone memory (enc + check bytes)."""
        total = int(math.prod(self.enc.shape))
        if self.checks is not None:
            total += int(math.prod(self.checks.shape))
        return total

    @property
    def is_flat(self) -> bool:
        """True for the flat-padded layout (enc 1-D, weight possibly not)."""
        return tuple(self.enc.shape) != tuple(self.orig_shape)

    def layer(self, i: int) -> "ProtectedTensor":
        """Layer ``i`` of a stacked same-shape image: the per-layer view the
        reference's ``lax.scan`` slices out (the scale is per stacked leaf)."""
        if self.is_flat:
            raise ValueError("a flat-padded image flattens across layers and "
                             "cannot be sliced per layer")
        return dataclasses.replace(
            self, enc=self.enc[i],
            checks=None if self.checks is None else self.checks[i],
            orig_shape=tuple(self.orig_shape[1:]))

    def __repr__(self) -> str:
        return (f"ProtectedTensor(scheme={self.scheme_id!r}, "
                f"orig_shape={tuple(self.orig_shape)}, "
                f"enc={tuple(getattr(self.enc, 'shape', ()))}, "
                f"checks={self.checks is not None})")


def is_protected_tensor(x) -> bool:
    return isinstance(x, ProtectedTensor)

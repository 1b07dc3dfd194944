"""``ProtectedWeight`` — lazy decode-at-use view of one protected leaf.

Counterpart of ``repro.protection.fused``. The serve step wraps each
per-layer ``ProtectedTensor`` in a view and defers all codec work to the
weight's point of use:

* ``matmul(x)`` — the projection path. Float activations go through the
  fused decode+matmul kernel on the ``cuda`` route for an in-place 2-D
  same-shape image (``kernels.ecc_qmatmul``; decoded weights never reach
  device memory), otherwise the leaf decodes inline next to its matmul.
  With an activation-quant decision (``act_quant`` = "static" calibrated
  scale | "dynamic" per-token absmax) the view quantizes the activations
  to int8 and runs the kernel's requantize epilogue; the inline route is
  the literal quantize -> decode -> ``quant.int8_matmul`` sequence, the
  same value path (one exact int32 accumulator scaled by ``a_scale *
  w_scale`` in f32). With ``abft`` and / or ``clamp`` the kernel checks
  its accumulator and clips its epilogue; the inline route mirrors it with
  ``kernels.ref.abft_counts`` and ``clamp_counts``.
* ``astype(dtype)`` — decode just this leaf, for non-projection uses.

Counts come back through callbacks of the step's
:class:`~repro_torch.models.layers.FlagRecorder`: ``record(corrected,
due)``, ``record_abft(mismatches, clamp_hits)``, and ``observe(absmax)``,
each float activation's absmax as a device tensor (the calibration hook).
``models.layers._proj`` recognizes the view by its ``decode_at_use``
attribute. With ``abft_per_slot`` the view reports the per-row
(mismatches, clamp hits) vectors instead of totals: a decode step's output
rows are its batch slots, so the request front-end attributes compute
faults to requests (the column-check count, which no row owns, is then
not reported, as in the reference).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import ref

from .backends import get_backend
from .policy import decode_leaf_with_flags
from .schemes import get_scheme
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

    pt:          the per-layer ProtectedTensor.
    backend:     Backend instance or name for this leaf's codec compute.
    record:      ``record(corrected, due)`` flags callback (no-op if None).
    act_quant:   None | "dynamic" | "static" (needs ``a_scale``).
    a_scale:     calibrated static activation scale (float).
    observe:     ``observe(absmax)`` callback fed each float activation's
                 absmax (calibration; no-op if None).
    abft:        verify ABFT checksums on every matmul.
    clamp:       activation absmax bound of the epilogue output, or None.
    record_abft: ``record_abft(mismatches, clamp_hits)`` callback.
    abft_per_slot: report per-row (M,) vectors to ``record_abft`` instead
                 of scalar totals.
    """

    decode_at_use = True  # the marker layers._proj dispatches on

    def __init__(self, pt: ProtectedTensor, backend="torch", *,
                 record: Optional[Callable] = None,
                 act_quant: Optional[str] = None,
                 a_scale: Optional[float] = None,
                 observe: Optional[Callable] = None,
                 abft: bool = False, clamp: Optional[float] = None,
                 record_abft: Optional[Callable] = None,
                 abft_per_slot: bool = False):
        if act_quant not in (None, "static", "dynamic"):
            raise ValueError(f"act_quant {act_quant!r}; one of "
                             f"(None, 'static', 'dynamic')")
        if act_quant == "static" and a_scale is None:
            raise ValueError("act_quant='static' needs a calibrated a_scale")
        self.pt = pt
        self.backend = get_backend(backend)
        self.fuse = can_fuse(pt, self.backend)
        self.act_quant = act_quant
        self.a_scale = a_scale
        self.abft = bool(abft)
        self.clamp = None if clamp is None else float(clamp)
        self.abft_per_slot = bool(abft_per_slot)
        self._record = record
        self._record_abft = record_abft
        self._observe = observe

    @property
    def shape(self):
        return tuple(self.pt.orig_shape)

    @property
    def ndim(self):
        return len(self.pt.orig_shape)

    @property
    def _track(self) -> bool:
        """ABFT and / or clamp accounting is on for this leaf."""
        return self.abft or self.clamp is not None

    def record(self, corrected, due):
        if self._record is not None:
            self._record(corrected, due)

    def record_abft(self, row_mm, clamp_hits, col_mm):
        """Report (mismatches, clamp hits): per-row vectors when the serve
        step wants per-slot attribution, else totals, where the mismatch
        total adds the column-check count to the per-row counts."""
        if self._record_abft is None:
            return
        if self.abft_per_slot:
            self._record_abft(row_mm, clamp_hits)
        else:
            self._record_abft(row_mm.sum() + col_mm, clamp_hits.sum())

    def astype(self, dtype):
        """Decode just this leaf (recording flags) -> dequantized tensor."""
        w, corrected, due = decode_leaf_with_flags(self.pt, dtype,
                                                   backend=self.backend)
        self.record(corrected, due)
        return w

    # -- int8 path ------------------------------------------------------------

    def _decode_q(self):
        """Decode to the raw int8 weights (no dequantization), with flags."""
        scheme = get_scheme(self.pt.scheme_id)
        q, corrected, due = scheme.decode_with_flags(self.pt.enc,
                                                     self.pt.checks,
                                                     self.backend)
        if self.pt.is_flat:
            q = q.reshape(-1)[: self.pt.n_weights].reshape(self.pt.orig_shape)
        return q, corrected, due

    def _static_scale(self, device) -> torch.Tensor:
        return torch.full((), self.a_scale, dtype=torch.float32,
                          device=device)

    def _quantize_x(self, x2):
        """(M, K) float -> (int8 q, f32 a_scale: 0-d static or (M, 1)
        dynamic), on the device, inside an ``act_quant`` profiler range."""
        with torch.profiler.record_function("act_quant"):
            xf = x2.to(torch.float32)
            if self.act_quant == "static":
                a_scale = self._static_scale(x2.device)
            else:  # dynamic per-token absmax
                a_scale = quant.compute_scale(xf, dim=1)
            q, _ = quant.quantize(xf, scale=a_scale)
        return q, a_scale

    def _int8_matmul(self, q_x, a_scale, out_dtype):
        """``q_x (M, K) int8 @ decode(enc)`` through the kernel's requantize
        epilogue (fused route) or the inline quantize -> decode -> matmul
        sequence, with the same value path."""
        if self.fuse:
            from repro_torch.kernels.ecc_qmatmul import ecc_qmatmul
            res = ecc_qmatmul(q_x, self.pt.enc, self.pt.scale,
                              a_scale=a_scale, out_dtype=out_dtype,
                              with_flags=True, with_abft=self.abft,
                              clamp=self.clamp)
            if self._track:
                out, flags, (rows, col_mm) = res
                self.record_abft(rows[:, 0], rows[:, 1], col_mm)
            else:
                out, flags = res
            self.record(flags[0], flags[1])
            return out
        q_w, corrected, due = self._decode_q()
        self.record(corrected, due)
        if not self._track:
            return quant.int8_matmul(q_x, q_w, a_scale,
                                     self.pt.scale).to(out_dtype)
        # the guarded epilogue's mirror: the same int32 accumulator checked
        # by the same checksum pair, then the same rescale and clamp
        acc = quant.int8_acc(q_x, q_w)
        row_mm, col_mm = self._abft_counts(q_x, q_w, acc)
        out = acc.to(torch.float32) * (a_scale * self.pt.scale)
        out, hits = self._clamp_counts(out, row_mm)
        self.record_abft(row_mm, hits, col_mm)
        return out.to(out_dtype)

    def _abft_counts(self, a, w, acc):
        if self.abft:
            row_mm, col_bad = ref.abft_counts(a, w, acc)
            return row_mm, col_bad.sum(dtype=torch.int32)
        return (torch.zeros((a.shape[0],), dtype=torch.int32, device=a.device),
                torch.zeros((), dtype=torch.int32, device=a.device))

    def _clamp_counts(self, y, row_mm):
        if self.clamp is None:
            return y, torch.zeros_like(row_mm)
        return ref.clamp_counts(y, self.clamp)

    # -- the projection entry point -------------------------------------------

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ decode(self)`` with the decode at the point of use.

        Float ``x``: the fused float path or an inline decode; with an
        ``act_quant`` decision ``x`` is quantized here and served over the
        int8 path instead. Raw int8 ``x`` is taken only with a static
        ``a_scale``, which says what the integers mean (bf16 output)."""
        lead = x.shape[:-1]
        a2 = x.reshape(-1, x.shape[-1])
        n_out = self.pt.orig_shape[-1]
        if not x.dtype.is_floating_point:
            if self.act_quant != "static":
                raise TypeError(
                    f"ProtectedWeight.matmul got raw {x.dtype} activations "
                    f"without a static a_scale; serve float activations, or "
                    f"plan.with_act_quant('static', scales) so the view "
                    f"knows the quantization scale")
            out = self._int8_matmul(a2, self._static_scale(x.device),
                                    torch.bfloat16)
            return out.reshape(*lead, n_out)
        if self._observe is not None:
            self._observe(a2.to(torch.float32).abs().amax())
        if self.act_quant is not None:
            q_x, a_scale = self._quantize_x(a2)
            out = self._int8_matmul(q_x, a_scale, x.dtype)
            return out.to(x.dtype).reshape(*lead, n_out)
        if not self.fuse:
            if not self._track:
                return x @ self.astype(x.dtype)
            w = self.astype(x.dtype)
            # check the f32 accumulator, as the kernel does; the value path
            # is one f32 accumulation and one final rounding
            acc = a2.to(torch.float32) @ w.to(torch.float32)
            row_mm, col_mm = self._abft_counts(a2, w, acc)
            acc, hits = self._clamp_counts(acc, row_mm)
            self.record_abft(row_mm, hits, col_mm)
            return acc.to(x.dtype).reshape(*lead, n_out)
        from repro_torch.kernels.ecc_qmatmul import ecc_qmatmul
        res = ecc_qmatmul(a2, self.pt.enc, self.pt.scale, with_flags=True,
                          with_abft=self.abft, clamp=self.clamp)
        if self._track:
            out, flags, (rows, col_mm) = res
            self.record_abft(rows[:, 0], rows[:, 1], col_mm)
        else:
            out, flags = res
        self.record(flags[0], flags[1])
        return out.to(x.dtype).reshape(*lead, n_out)

    def __repr__(self):
        return (f"ProtectedWeight({self.pt!r}, backend={self.backend.name!r}, "
                f"fuse={self.fuse}, act_quant={self.act_quant!r})")

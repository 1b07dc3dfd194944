"""Serve-step parity of the port against the reference, in f32.

Same weights (the reference's ``lm.init_params``), the same fault mask and
the same fed tokens go through the reference's decode-at-use serve step
(XLA route) and the port's. Flags (``top``, ``layers``, ``layers_kv``) must
be exactly equal; logits agree to f32 summation-order rounding
(``F32_TOL``), and the greedy tokens are equal. The paged KV cases run the
archs with a paged cache (``PAGED_ARCHS``: not whisper-base, whose dense
cases on both routes are in ``test_torch_encdec.py``).
"""
import numpy as np
import pytest

import torch_parity as P
from torch_parity import ARCHS, PAGED_ARCHS

# f32 on both sides: the only differences are the order of matmul sums and
# last-ulp differences of cos/sin/exp/rsqrt between XLA and PyTorch
F32_TOL = 1e-4


SERVE_CASES = [(a, kv) for a in ARCHS for kv in (None, "in-place")
               if kv is None or a in PAGED_ARCHS]


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("arch,kv", SERVE_CASES, ids=[
    f"{a}-{'dense' if kv is None else 'paged'}-kv" for a, kv in SERVE_CASES])
def test_serve_step_parity_f32(arch, kv, faulted):
    exported, fed, ref_logits, ref_tok, ref_flags = P.reference_run(
        arch, kv, "float32", faulted)
    logits, tok, flags = P.port_run(arch, kv, "float32", exported, fed)
    P.assert_flags_equal(ref_flags, flags)
    np.testing.assert_allclose(logits, ref_logits, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(tok, ref_tok)
    if faulted:
        assert sum(int(f["layers"][:, 0].sum()) for f in flags) > 0


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_kernel_route_parity_f32(arch, faulted):
    """The ``cuda`` route with the fused KV preset — on the CPU every kernel
    wrapper takes its plain version — against the reference's XLA route
    over the unfused in-place KV cache."""
    exported, fed, ref_logits, ref_tok, ref_flags = P.reference_run(
        arch, "in-place", "float32", faulted)
    logits, tok, flags = P.port_run(arch, "in-place-fused", "float32",
                                    exported, fed, backend="cuda")
    P.assert_flags_equal(ref_flags, flags)
    np.testing.assert_allclose(logits, ref_logits, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(tok, ref_tok)

"""The port's host campaign grid equals the reference's, cell for cell,
under all four schemes (the shared helper is ``torch_campaign_ref.py``)."""
import pytest

from torch_campaign_ref import check_host_grid


@pytest.mark.parametrize("scheme", ["faulty", "parity-zero", "secded72",
                                    "in-place"])
def test_host_campaign_grid_equals_the_reference(scheme):
    got = check_host_grid(scheme)
    assert got.space_overhead == (0.0 if scheme in ("faulty", "in-place")
                                  else 0.125)
    if scheme == "faulty":   # the 1e-2 cells move off clean somewhere
        assert any(v != got.clean for row in got.grid for v in row)

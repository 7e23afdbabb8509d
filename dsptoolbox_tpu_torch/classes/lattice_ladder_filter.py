"""The lattice/ladder coefficient designers under the reference's private
names (`dsptoolbox_tpu/classes/lattice_ladder_filter.py`); they live in
`realtime/misc.py`."""

from __future__ import annotations

from ..realtime.misc import (
    lattice_ladder_coefficients_iir,
    lattice_ladder_coefficients_iir_sos,
)


def _get_lattice_ladder_coefficients_iir(b, a):
    """Reference-named alias (`lattice_ladder_filter.py:400-446`)."""
    return lattice_ladder_coefficients_iir(b, a)


def _get_lattice_ladder_coefficients_iir_sos(sos):
    """Reference-named alias (`lattice_ladder_filter.py:449-482`)."""
    return lattice_ladder_coefficients_iir_sos(sos)

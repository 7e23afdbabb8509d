"""Frequency grids of the filter banks (`dsptoolbox_tpu/tools.py:185,219`):
host numpy, copied from the JAX package."""

from __future__ import annotations

import numpy as np

from ..standard.backend import (
    center_frequencies_fractional_octaves_iec,
    exact_center_frequencies_fractional_octaves,
)


def fractional_octave_frequencies(
    num_fractions=1, frequency_range=(20, 20e3), return_cutoff=False
):
    """IEC-compliant fractional-octave center (and cutoff) frequencies:
    ``(nominal, exact)`` or ``(nominal, exact, (lower, upper))``; nominal
    frequencies exist for octaves and third octaves only."""
    nominal = np.array([])
    f_lims = np.asarray(frequency_range)
    if f_lims.size != 2:
        raise ValueError("You need to specify a lower and upper limit frequency.")
    if f_lims[0] > f_lims[1]:
        raise ValueError("The second frequency needs to be higher than the first.")
    if num_fractions in [1, 3]:
        nominal, exact = center_frequencies_fractional_octaves_iec(num_fractions)
        mask = (nominal >= f_lims[0]) & (nominal <= f_lims[1])
        nominal = nominal[mask]
        exact = exact[mask]
    else:
        exact = exact_center_frequencies_fractional_octaves(num_fractions, f_lims)
    if return_cutoff:
        octave_ratio = 10 ** (3 / 10)
        freqs_upper = exact * octave_ratio ** (1 / 2 / num_fractions)
        freqs_lower = exact * octave_ratio ** (-1 / 2 / num_fractions)
        return nominal, exact, (freqs_lower, freqs_upper)
    return nominal, exact


def erb_frequencies(
    freq_range_hz=[20, 20000],
    resolution: float = 1,
    reference_frequency_hz: float = 1000,
) -> np.ndarray:
    """Frequencies spaced linearly on the ERB scale, through the reference
    frequency (Hohmann 2002, Eq. 16)."""
    if (
        not isinstance(freq_range_hz, (list, tuple, np.ndarray))
        or len(freq_range_hz) != 2
    ):
        raise ValueError("freq_range must be an array like of length 2")
    freq_range_hz = list(freq_range_hz)
    if freq_range_hz[0] > freq_range_hz[1]:
        freq_range_hz = [freq_range_hz[1], freq_range_hz[0]]
    if resolution <= 0:
        raise ValueError("Resolution must be larger than zero")
    fr = np.asarray(freq_range_hz, dtype=np.float64)
    erb_range = 9.2645 * np.sign(fr) * np.log(1 + np.abs(fr) * 0.00437)
    erb_ref = (
        9.2645
        * np.sign(reference_frequency_hz)
        * np.log(1 + abs(reference_frequency_hz) * 0.00437)
    )
    erb_ref_range = np.array([erb_ref - erb_range[0], erb_range[1] - erb_ref])
    n_points = np.floor(erb_ref_range / resolution).astype(int)
    erb_points = np.arange(-n_points[0], n_points[1] + 1) * resolution + erb_ref
    return 1 / 0.00437 * np.sign(erb_points) * (np.exp(np.abs(erb_points) / 9.2645) - 1)

"""Filter-bank factories (`dsptoolbox_tpu/filterbanks/filterbanks.py`).

Designs are host numpy/scipy; the banks apply on the signal's device. Not
ported yet: `reconstructing_fractional_octave_bands`, `qmf_crossover`,
`weighting_filter`, `pinking_filter`, `matched_biquad`, `gaussian_kernel`,
`fractional_delay`, `arma` and `complementary_fir_filter`.
"""

from __future__ import annotations

import numpy as np

from ..classes.filter import Filter
from ..classes.filterbank import FilterBank
from .._enums import FilterCoefficientsType, FilterPassType, IirDesignMethod
from ..tools.frequencies import erb_frequencies, fractional_octave_frequencies
from .gammatone import GammaToneFilterBank
from .lr_filterbank import LRFilterBank


def linkwitz_riley_crossovers(
    crossover_frequencies_hz, order, sampling_rate_hz: int
) -> LRFilterBank:
    """Linkwitz-Riley crossover bank (`filterbanks.py:39`)."""
    return LRFilterBank(crossover_frequencies_hz, order, sampling_rate_hz)


def auditory_filters_gammatone(
    frequency_range_hz=[20, 20000],
    resolution: float = 1,
    sampling_rate_hz: int | None = None,
) -> GammaToneFilterBank:
    """Hohmann-2002 gammatone analysis bank, one band per ERB
    (`filterbanks.py:117`): each band a 4th-order complex one-pole
    cascade."""
    assert sampling_rate_hz is not None, (
        "A sampling rate must be passed to create the filter bank"
    )
    assert np.max(frequency_range_hz) <= sampling_rate_hz // 2, (
        "Highest frequency should not be higher than the nyquist frequency"
    )
    frequencies_hz = erb_frequencies(frequency_range_hz, resolution)
    erb_aud = 24.7 + frequencies_hz / 9.265
    a_gamma = np.pi * 720 * 2 ** (-6) / 36
    # b and beta are formed apart, as in the reference: the gain iteration
    # of `GammaToneFilterBank` amplifies a last-bit difference
    b = erb_aud / a_gamma
    lam = np.exp(-2 * np.pi * b / sampling_rate_hz)
    beta = 2 * np.pi * frequencies_hz / sampling_rate_hz
    coefficients = lam * np.exp(1j * beta)
    normalizations = 2 * (1 - np.abs(coefficients)) ** 4
    filters = []
    for bb in range(len(frequencies_hz)):
        sos_section = np.tile(np.atleast_2d([1, 0, 0, 1, -coefficients[bb], 0]), (4, 1))
        sos_section[3, 0] = normalizations[bb]
        f = Filter({FilterCoefficientsType.Sos: sos_section}, sampling_rate_hz)
        f.warning_if_complex = False
        filters.append(f)
    return GammaToneFilterBank(
        filters,
        info={"Type of filter bank": "Gammatone filter bank"},
        frequencies=frequencies_hz,
        coefficients=coefficients,
        normalizations=normalizations,
    )


def fractional_octave_bands(
    frequency_range_hz=[31.5, 16e3],
    octave_fraction: int = 1,
    filter_order: int = 6,
    sampling_rate_hz: int | None = None,
):
    """ANSI S1.11 Butterworth fractional-octave bank
    (`filterbanks.py:165`): ``(bank, center frequencies, (lower,
    upper))``; a band whose upper edge lies above Nyquist is a highpass."""
    assert sampling_rate_hz is not None, "A sampling rate must be passed for the filter bank"
    frequency_range_hz = np.atleast_1d(np.squeeze(frequency_range_hz))
    frequency_range_hz.sort()
    assert len(frequency_range_hz) == 2, "Frequency range must contain exactly two entries"
    assert frequency_range_hz[-1] < sampling_rate_hz // 2, (
        "The highest frequency in the range is higher than the nyquist frequency"
    )
    _, center_freqs_hz, (lower_hz, upper_hz) = fractional_octave_frequencies(
        octave_fraction, frequency_range_hz, return_cutoff=True
    )
    bank = FilterBank()
    for ind in range(len(lower_hz)):
        top = FilterPassType.Bandpass
        freqs = [lower_hz[ind], upper_hz[ind]]
        if upper_hz[ind] > sampling_rate_hz // 2:
            top = FilterPassType.Highpass
            freqs = lower_hz[ind]
        bank.add_filter(Filter.iir_filter(
            order=filter_order, frequency_hz=freqs, type_of_pass=top,
            filter_design_method=IirDesignMethod.Butterworth,
            sampling_rate_hz=sampling_rate_hz,
        ))
    return bank, center_freqs_hz, (lower_hz, upper_hz)

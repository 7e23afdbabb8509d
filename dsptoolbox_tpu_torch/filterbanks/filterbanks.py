"""Filter-bank and filter factories
(`dsptoolbox_tpu/filterbanks/filterbanks.py`).

Designs are host numpy/scipy; the filters and banks apply on the signal's
device. `arma` estimates its AR part with the port's float64
`helpers.ar_estimation` on the IR's device and its MA part by host least
squares.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy.signal import bilinear_zpk, freqz_zpk, tf2sos, windows
from scipy.special import comb

from .._enums import (
    BiquadEqType,
    FilterCoefficientsType,
    FilterPassType,
    IirDesignMethod,
)
from ..classes.filter import Filter
from ..classes.filterbank import FilterBank
from ..classes.impulse_response import ImpulseResponse
from ..helpers.ar_estimation import burg_ar, yule_walker_ar
from ..standard.backend import kaiser_window_fractional
from ..tools.frequencies import erb_frequencies, fractional_octave_frequencies
from .crossovers import QMFCrossover
from .gammatone import GammaToneFilterBank
from .lr_filterbank import LRFilterBank
from .matched_eq import (
    matched_bandpass_eq,
    matched_highpass_eq,
    matched_lowpass_eq,
    matched_peaking_eq,
    matched_shelving_eq,
)


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


def reconstructing_fractional_octave_bands(
    frequency_range_hz=[63, 16000],
    octave_fraction: int = 1,
    overlap: float = 1,
    slope: int = 0,
    n_samples: int = 2**11,
    sampling_rate_hz: int | None = None,
) -> FilterBank:
    """Perfect-reconstruction linear-phase FIR bank (Antoni 2010 / pyfar;
    `filterbanks.py:81-214`)."""
    assert sampling_rate_hz is not None, "Sampling rate should not be None"
    valid_lengths = 2 ** (np.arange(5, 18))
    assert n_samples in valid_lengths, (
        "Only lengths between 2**5 and 2**17 are allowed"
    )
    if overlap < 0 or overlap > 1:
        raise ValueError("overlap must be between 0 and 1")
    if not isinstance(slope, int) or slope < 0:
        raise ValueError("slope must be a positive integer.")

    _, f_m, f_cut_off = fractional_octave_frequencies(
        octave_fraction, frequency_range_hz, return_cutoff=True
    )
    n_bins = int(n_samples // 2 + 1)
    f_id = f_m < sampling_rate_hz / 2
    if not np.all(f_id):
        warnings.warn("Skipping bands above the Nyquist frequency")
    k_1 = np.round(n_samples * f_cut_off[0][f_id] / sampling_rate_hz).astype(
        int
    )
    k_m = np.round(n_samples * f_m[f_id] / sampling_rate_hz).astype(int)
    k_2 = np.round(n_samples * f_cut_off[1][f_id] / sampling_rate_hz).astype(
        int
    )
    P = np.round(overlap / 2 * (k_2 - k_m)).astype(int)
    g = np.ones((len(k_m), n_bins))
    for b_idx in range(1, len(k_m)):
        if P[b_idx] > 0:
            p = np.arange(-P[b_idx], P[b_idx] + 1)
            phi = p / P[b_idx]
            for _ in range(slope):
                phi = np.sin(np.pi / 2 * phi)
            phi = 0.5 * (phi + 1)
            g[
                b_idx - 1, k_1[b_idx] - P[b_idx] : k_1[b_idx] + P[b_idx] + 1
            ] = np.cos(np.pi / 2 * phi)
            g[
                b_idx, k_1[b_idx] - P[b_idx] : k_1[b_idx] + P[b_idx] + 1
            ] = np.sin(np.pi / 2 * phi)
        g[b_idx - 1, k_1[b_idx] + P[b_idx] :] = 0.0
        g[b_idx, : k_1[b_idx] - P[b_idx]] = 0.0
    g = g**2
    frequencies = np.fft.rfftfreq(n_samples, 1 / sampling_rate_hz)
    group_delay = n_samples / 2 / sampling_rate_hz
    g = g.astype(complex) * np.exp(
        -1j * 2 * np.pi * frequencies * group_delay
    )
    time = np.fft.irfft(g)
    time *= windows.hann(time.shape[-1])
    filters = [
        Filter(
            {FilterCoefficientsType.Ba: [time[i, :], [1.0]]},
            sampling_rate_hz=sampling_rate_hz,
        )
        for i in range(time.shape[0])
    ]
    return FilterBank(filters=filters)


def qmf_crossover(lowpass: Filter) -> QMFCrossover:
    """Two-band maximally decimated QMF bank
    (`filterbanks.py:306-333`)."""
    return QMFCrossover(lowpass)


def weighting_filter(
    a_weighting: bool = True, sampling_rate_hz: int | None = None
) -> Filter:
    """IEC 61672 A/C weighting IIR (`filterbanks.py:416-451`)."""
    if a_weighting:
        z = [0, 0, 0, 0]
        k = 7.39705e9
        p = [-129.4, -129.4, -676.7, -4636, -76655, -76655]
    else:
        z = [0, 0]
        k = 5.91797e9
        p = [-129.4, -129.4, -76655, -76655]
    return Filter.from_zpk(
        *bilinear_zpk(z, p, k, sampling_rate_hz), sampling_rate_hz
    )


def complementary_fir_filter(fir: Filter) -> Filter:
    """Linear-phase complementary FIR (`filterbanks.py:453-494`)."""
    assert not fir.is_iir, "Filter prototype must be an FIR filter"
    b = fir.ba[0].copy()
    odd_length = len(b) % 2 == 1
    if odd_length:
        impulse_index = np.argmax(np.abs(b))
        b *= -1
        b[impulse_index] += 1
    else:
        h = np.sinc(np.arange(-len(b) // 2 + 1, len(b) // 2 + 1) - 0.5)
        b = h * kaiser_window_fractional(len(h), 60, 0.5) - b
    return Filter.from_ba(b, [1.0], fir.sampling_rate_hz)


def pinking_filter(frequency_0_db: float, sampling_rate_hz: int) -> Filter:
    """-3 dB/octave (pinking) IIR filter (`filterbanks.py:496-533`)."""
    assert frequency_0_db < sampling_rate_hz / 2, (
        "Frequency should not be above nyquist"
    )
    z = np.array([0.698258, 0.937174, 0.985792, 0.996652])
    p = np.array([0.378332, 0.862595, 0.970548, 0.993022, 0.998655])
    k = 1
    h = freqz_zpk(z, p, k, [frequency_0_db], fs=sampling_rate_hz)[1]
    k /= np.abs(h)
    return Filter.from_zpk(z, p, k, sampling_rate_hz=sampling_rate_hz)


def matched_biquad(
    eq_type: BiquadEqType,
    freq_hz: float,
    gain_db: float,
    q: float,
    sampling_rate_hz: int,
    q_factor: float | None = None,
) -> Filter:
    """Analog-matched biquad EQ (Vicanek; `filterbanks.py:535-634`)."""
    assert 0 < freq_hz < sampling_rate_hz / 2, (
        f"{freq_hz} is not a valid frequency"
    )
    assert q > 0, "Quality factor must be greater than zero"
    if eq_type == BiquadEqType.Peaking:
        ba = matched_peaking_eq(
            freq_hz, gain_db, q, q_factor, sampling_rate_hz
        )
    elif eq_type == BiquadEqType.Lowpass:
        ba = matched_lowpass_eq(freq_hz, gain_db, q, sampling_rate_hz)
    elif eq_type == BiquadEqType.Highpass:
        ba = matched_highpass_eq(freq_hz, gain_db, q, sampling_rate_hz)
    elif eq_type in (BiquadEqType.BandpassPeak, BiquadEqType.BandpassSkirt):
        ba = matched_bandpass_eq(freq_hz, gain_db, q, sampling_rate_hz)
    elif eq_type == BiquadEqType.Lowshelf:
        ba = matched_shelving_eq(freq_hz, gain_db, sampling_rate_hz, True)
    elif eq_type == BiquadEqType.Highshelf:
        ba = matched_shelving_eq(freq_hz, gain_db, sampling_rate_hz, False)
    else:
        raise ValueError("Unsupported Eq type")
    return Filter({FilterCoefficientsType.Ba: ba}, sampling_rate_hz)


def gaussian_kernel(
    kernel_length_seconds: float,
    kernel_boundary_value: float = 1e-2,
    approximation_order: int = 12,
    sampling_rate_hz: int | None = None,
) -> Filter:
    """First-order IIR gaussian-smoothing approximation (Alvarez-Mazorra;
    `filterbanks.py:636-700`). Apply with zero-phase filtering."""
    assert approximation_order % 2 == 0, "Approximation order must be even"
    assert sampling_rate_hz is not None, "Sampling rate should not be None"
    K = approximation_order // 2
    kernel_length_samples = kernel_length_seconds * sampling_rate_hz
    sigma = (
        kernel_length_samples
        / (2.0 * np.log(1 / kernel_boundary_value)) ** 0.5
    )
    lambdaa = sigma**2.0 / (2.0 * K)
    mu = (1.0 + 2.0 * lambdaa - (1.0 + 4.0 * lambdaa) ** 0.5) / (
        2.0 * lambdaa
    )
    b = np.array([1.0]) * (mu / lambdaa) ** 0.5
    a = np.array([1.0, -mu])
    sos = tf2sos(b, a)
    sos = np.repeat(sos, K, axis=0)
    return Filter.from_sos(sos, sampling_rate_hz)


def fractional_delay(
    fractional_delay_samples: float, order: int, sampling_rate_hz: int
) -> Filter:
    """Thiran allpass fractional delay (`filterbanks.py:702-741`)."""
    assert order > 0, "Order must be positive"
    assert 0.0 < fractional_delay_samples < 1.0, (
        "Delay is outside valid range"
    )
    N = order
    D = N + fractional_delay_samples
    a = np.ones(N + 1)
    for ind in range(len(a)):
        a[ind] = comb(N, ind) * (-1.0 if ind % 2 == 1 else 1.0)
        for ind2 in range(len(a)):
            a[ind] *= (D - N + ind2) / (D - N + ind + ind2)
    return Filter.from_ba(a[::-1], a, sampling_rate_hz)


def arma(
    ir: ImpulseResponse,
    order_a: int,
    order_b: int = 0,
    method_ar: str = "yule-walker",
    cutoff_b_percentage: float = 0.0,
) -> Filter:
    """ARMA IIR fit to an IR (`dsptoolbox_tpu/filterbanks/filterbanks.py:
    329`): AR by Yule-Walker or Burg (float64 on the IR's device), MA by
    frequency-domain least squares on the host."""
    assert ir.number_of_channels == 1, (
        "This is only valid for single-channel IR"
    )
    assert order_a >= 1, "Order of a must be at least 1"
    assert order_b >= 0, "Order of b should be at least 0"
    assert len(ir) > order_a, "The order should be lower than the IR length"
    method_ar = method_ar.lower()
    td = ir.time_data[:, 0]
    if method_ar == "yule-walker":
        a = yule_walker_ar(td[:, None], order_a)[0][:, 0].cpu().numpy()
    elif method_ar == "burg":
        a = burg_ar(td, order_a)[0].cpu().numpy()
    else:
        raise ValueError(f"{method_ar}: Method is not supported")
    if order_b > 0:
        b = _ma_parameters(td.cpu().numpy(), order_b, a, cutoff_b_percentage)
    else:
        b = np.array([1.0])
    return Filter.from_ba(b, a, ir.sampling_rate_hz)


def _ma_parameters(
    time_data: np.ndarray,
    order: int,
    ar_coefficients: np.ndarray,
    cutoff_singular_values_percent: float = 0.0,
) -> np.ndarray:
    """Least-squares MA estimation in the frequency domain
    (`_filterbank.py:1507-1560`)."""
    from scipy.linalg import lstsq
    from scipy.signal import freqz

    assert time_data.ndim == 1
    assert 0.0 <= cutoff_singular_values_percent < 1.0
    spec = np.fft.rfft(time_data)
    N = len(time_data)
    num = order + 1
    A = np.zeros((N // 2 + 1, num), dtype=np.complex128)
    target = np.hstack([np.real(spec), np.imag(spec)])
    include_nyquist = N % 2 == 0
    for n in range(num):
        A[:, n] = freqz(
            np.array([0.0] * n + [1.0]),
            ar_coefficients,
            worN=N // 2 + 1,
            include_nyquist=include_nyquist,
        )[1]
    return lstsq(
        np.vstack([np.real(A), np.imag(A)]),
        target,
        cond=(
            None
            if cutoff_singular_values_percent == 0.0
            else cutoff_singular_values_percent
        ),
        overwrite_a=True,
        overwrite_b=True,
    )[0]

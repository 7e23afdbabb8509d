"""Activity detection, detrending, envelopes, dither and filter merging
(`dsptoolbox_tpu/standard/other.py`; reference `dsptoolbox/standard/other.py`).

The data stays on its device: the activity detector's pre-filter (zero
phase: kernel B2 twice on a float32 CUDA signal), its mask and the
selection of the active samples run there, and only the mask is fetched,
packed into bits. Not ported yet: ``spectral_difference`` (it needs the
`Spectrum` class's octave smoothing and energy) and ``load_pkl_object``
(with `io`).
"""

from __future__ import annotations

from functools import lru_cache
from warnings import warn

import numpy as np
import torch

from ..classes import Filter, FilterBank, MultiBandSignal, Signal
from ..helpers.latency import analytic_signal
from ..helpers.smoothing import get_smoothing_factor_ema
from ..ops.fft_conv import fft_convolve
from .backend import indices_above_threshold_dbfs, pack_bits
from .enums import FilterBankMode, FilterCoefficientsType

# IEEE half precision's smallest subnormal, 2^-24: the reference's default
# dither amplitude
_HALF_SMALLEST_SUBNORMAL = 2.0**-24


def activity_detector(
    signal: Signal,
    threshold_dbfs: float = -20,
    channel: int = 0,
    relative_to_peak: bool = True,
    pre_filter: Filter | None = None,
    attack_time_ms: float = 1,
    release_time_ms: float = 25,
):
    """Power-threshold activity detector on one channel (`other.py:32`):
    the (optionally zero-phase pre-filtered) channel's power is smoothed by
    the reference's recursion and compared with ``threshold_dbfs``. Returns
    ``(active samples as a Signal, {"noise": the other samples as a Signal,
    "signal_indices", "noise_indices": host boolean masks})``."""
    assert isinstance(channel, int), (
        "Channel must be type integer. Function is not implemented for "
        "multiple channels."
    )
    assert threshold_dbfs < 0, "Threshold must be below zero"
    assert release_time_ms >= 0, "Release time must be positive"
    assert attack_time_ms >= 0, "Attack time must be positive"
    signal = signal.get_channels(channel)
    if pre_filter is not None:
        assert isinstance(pre_filter, Filter), "pre_filter must be of type Filter"
        signal_filtered = pre_filter.filter_signal(signal, zero_phase=True)
    else:
        signal_filtered = signal
    attack_coeff = get_smoothing_factor_ema(attack_time_ms / 1e3, signal.sampling_rate_hz)
    release_coeff = get_smoothing_factor_ema(release_time_ms / 1e3, signal.sampling_rate_hz)
    T = signal_filtered.length_samples
    mask = indices_above_threshold_dbfs(
        signal_filtered._x[0],
        threshold_dbfs=threshold_dbfs,
        attack_smoothing_coeff=attack_coeff,
        release_smoothing_coeff=release_coeff,
        normalize=relative_to_peak,
    )
    # the host's copy of the mask fetched packed (8× smaller); the device's
    # selects the samples
    signal_indices = np.unpackbits(pack_bits(mask).cpu().numpy())[:T].astype(bool)
    noise_indices = ~signal_indices
    x = signal._x[0]
    detected_sig = signal.copy()
    noise = signal.copy()
    detected_sig.clear_time_window()
    noise.clear_time_window()
    if signal_indices.any():
        detected_sig.time_data = x[mask]
    else:
        warn(
            "No detected activity, threshold might be too high. Detected "
            "signal will be a vector filled with zeroes"
        )
        detected_sig.time_data = np.zeros(500)
    if noise_indices.any():
        noise.time_data = x[~mask]
    else:
        warn(
            "No detected noise, threshold might be too low. Noise will be "
            "a vector filled with zeroes"
        )
        noise.time_data = np.zeros(500)
    others = dict(
        noise=noise,
        signal_indices=signal_indices,
        noise_indices=noise_indices,
    )
    return detected_sig, others


@lru_cache(maxsize=4)
def _trend_projector(T: int, polynomial_order: int, dtype: torch.dtype, device):
    """``(V (T, order+1), pinv(V) (order+1, T))`` of the polynomial basis,
    designed in float64 on the host, on ``device`` in ``dtype``."""
    V = np.vander(np.arange(T), polynomial_order + 1)
    pinv = np.linalg.pinv(V)
    return (torch.as_tensor(V, dtype=dtype, device=device),
            torch.as_tensor(pinv, dtype=dtype, device=device))


def detrend(sig, polynomial_order: int = 0):
    """Remove the least-squares polynomial trend of each channel
    (`other.py:128`): the projector designed on the host, applied on the
    device."""
    if isinstance(sig, Signal):
        assert polynomial_order >= 0, "Polynomial order should be positive"
        x = sig._x
        V, pinv = _trend_projector(x.shape[1], polynomial_order, x.dtype, x.device)
        trend = (x @ pinv.T) @ V.T
        return sig.copy_with_new_time_data((x - trend).T)
    if isinstance(sig, MultiBandSignal):
        out = sig.copy()
        out.bands = [detrend(b, polynomial_order) for b in sig.bands]
        return out
    raise TypeError("Pass either a Signal or a MultiBandSignal")


def envelope(signal, analytic: bool = True, window_length_samples: int | None = None):
    """Hilbert or moving-RMS envelope ``(T, C)`` of the linearly detrended
    signal, on its device (`other.py:152`); a MultiBandSignal's as
    ``(T, bands, C)``."""
    if isinstance(signal, Signal):
        x = detrend(signal, 1)._x
        if analytic:
            return analytic_signal(x, dim=-1).abs().T
        assert window_length_samples is not None, "Some window length must be passed"
        assert window_length_samples > 0, "Window length must be more than 1 sample"
        h = x.new_ones(window_length_samples) / window_length_samples
        sq = fft_convolve(x**2, h)[..., : x.shape[-1]]
        return torch.sqrt(sq.clamp(min=0)).T
    if isinstance(signal, MultiBandSignal):
        assert signal.same_sampling_rate, (
            "This is only available for constant sampling rate bands"
        )
        return torch.stack(
            [envelope(b, analytic=analytic, window_length_samples=window_length_samples)
             for b in signal.bands],
            dim=1,
        )
    raise TypeError("Signal must be type Signal or MultiBandSignal")


def dither(
    s: Signal,
    triangular_distribution: bool = True,
    epsilon: float = _HALF_SMALLEST_SUBNORMAL,
    noise_shaping_filterbank: FilterBank | None = None,
    truncate: bool = False,
) -> Signal:
    """Add rectangular or triangular dither noise, optionally shaped by a
    filter bank and truncated to IEEE half-precision values
    (`other.py:176`). The noise is drawn from the global ``np.random``, as
    in the reference (no seed parameter)."""
    shape = (s.length_samples, s.number_of_channels)
    if not triangular_distribution:
        noise = np.random.uniform(-epsilon / 2, epsilon / 2, size=shape)
    else:
        noise = np.random.uniform(-epsilon / 2, epsilon / 2, size=shape) + np.random.uniform(
            -epsilon / 2, epsilon / 2, size=shape
        )
    noise = torch.as_tensor(noise, device=s.device)
    if noise_shaping_filterbank is not None:
        noise_s = Signal(None, noise, s.sampling_rate_hz)
        noise = noise_shaping_filterbank.filter_signal(
            noise_s, mode=FilterBankMode.Sequential
        ).time_data
    dithered = s.time_data.double() + noise.double()
    if truncate:
        dithered = _round_to_half_precision(dithered)
    return s.copy_with_new_time_data(dithered)


def _round_to_half_precision(x: torch.Tensor) -> torch.Tensor:
    """The nearest IEEE half-precision value of each float64 element, ties to
    even, on ``x``'s device and in float64, as numpy's cast to half precision
    and back gives it: 11 significant bits down to 2**-14, a fixed step of
    2**-24 below (the subnormals), and infinity from 65520 on."""
    _, exponent = torch.frexp(x)  # |x| in [2**(exponent-1), 2**exponent)
    step = torch.ldexp(torch.ones_like(x), (exponent - 11).clamp(min=-24))
    rounded = torch.round(x / step) * step  # a power-of-two step: exact
    return torch.where(rounded.abs() > 65504.0, rounded * torch.inf, rounded)


def merge_filters(filters) -> Filter:
    """One filter from several: FIRs convolved, IIRs' second-order sections
    concatenated (`other.py:203`)."""
    filts = filters.filters if isinstance(filters, FilterBank) else filters
    assert len(filts) > 1, "There must be at least two filters to combine"
    assert all(filts[0].sampling_rate_hz == f.sampling_rate_hz for f in filts), (
        "Sampling rates do not match"
    )
    if filts[0].is_fir:
        assert all(f.is_fir for f in filts), "Some filter is not FIR"
        b = filts[0].ba[0].copy()
        for ind in range(1, len(filts)):
            b = np.convolve(b, filts[ind].ba[0], mode="full")
        return Filter.from_ba(b, [1.0], filts[0].sampling_rate_hz)
    assert all(f.is_iir for f in filts), "Some filter is not IIR"
    sos = np.concatenate(
        [f.get_coefficients(FilterCoefficientsType.Sos) for f in filts], axis=0
    )
    return Filter.from_sos(sos, filts[0].sampling_rate_hz)

"""Latency estimation and (fractional) delays
(`dsptoolbox_tpu/standard/latency_delay.py`; reference
`dsptoolbox/standard/latency_delay.py`), on the signals' device: the FFT
cross-correlation and the delay filters' convolution run there, the
sub-sample peak refinement and the Kaiser-sinc design on the host."""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from ..classes import MultiBandSignal, Signal
from ..helpers.latency import correlation_of_latencies, fractional_latency
from ..ops.fft_conv import fft_convolve
from ..ops.pad_trim import pad_trim_axis
from .backend import fractional_delay_filter, latency_integer


def latency(in1, in2=None, polynomial_points: int = 0):
    """Latency of ``in1`` against ``in2`` (or of ``in1``'s channels 1… against
    its channel 0) by the correlation method, sub-sample with
    ``polynomial_points`` > 0 (`latency_delay.py:20`). Returns ``(lags,
    correlations)``: the latencies in samples and the Pearson correlation
    of each pair after compensating it."""
    assert polynomial_points >= 0, "Polynomial points has to be at least 0"
    latency_func = latency_integer if polynomial_points == 0 else fractional_latency
    if isinstance(in1, Signal):
        td1 = in1.time_data
        if in2 is not None:
            assert in1.sampling_rate_hz == in2.sampling_rate_hz, (
                "Sampling rates must match"
            )
            assert in1.number_of_channels == in2.number_of_channels, (
                "Number of channels between the two signals must match"
            )
            assert isinstance(in2, Signal), "Both signals must be of type Signal"
            td2 = in2.time_data
        else:
            assert in1.number_of_channels > 1, (
                "Signal must have at least 2 channels to compare"
            )
            td2 = None
        latencies = latency_func(td1, td2, polynomial_points)
        try:
            correlations = correlation_of_latencies(
                td2 if td2 is not None else td1[:, :1],
                td1 if td2 is not None else td1[:, 1:],
                np.round(latencies, 0).astype(int),
            )
        except (IndexError, RuntimeError, ValueError) as e:
            warn(
                f"An error occured while computing the correlations ({e}). "
                "They are set to 0."
            )
            correlations = np.zeros(len(latencies))
        return latencies, correlations
    if isinstance(in1, MultiBandSignal):
        if in2 is not None:
            assert isinstance(in2, MultiBandSignal), "Both signals must be of type Signal"
            assert in1.sampling_rate_hz == in2.sampling_rate_hz, (
                "Sampling rates must match"
            )
        n_cols = in1.number_of_channels if in2 is not None else in1.number_of_channels - 1
        dtype = int if polynomial_points == 0 else float
        lags = np.zeros((in1.number_of_bands, n_cols), dtype=dtype)
        correlations = np.zeros((in1.number_of_bands, n_cols))
        for band in range(in1.number_of_bands):
            lags[band, :], correlations[band, :] = latency(
                in1.bands[band],
                in2.bands[band] if in2 is not None else None,
                polynomial_points=polynomial_points,
            )
        return lags, correlations
    raise TypeError("Signals must either be type Signal or MultiBandSignal")


def _channels(sig: Signal, channels) -> tuple[np.ndarray, np.ndarray]:
    """The selected channels and the others, validated."""
    if channels is None:
        channels = np.arange(sig.number_of_channels)
    channels = np.atleast_1d(np.asarray(channels).squeeze())
    assert np.all(channels < sig.number_of_channels) and len(np.unique(channels)) == len(
        channels
    ), "There is at least an invalid channel number"
    return channels, np.setdiff1d(np.arange(sig.number_of_channels), channels)


def _assemble(sig: Signal, total: int, delayed: torch.Tensor, rest: torch.Tensor,
              channels: np.ndarray, channels_not: np.ndarray, keep_length: bool) -> Signal:
    """A copy of ``sig`` of ``total`` samples (``sig``'s length with
    ``keep_length``): the delayed channels padded or trimmed at their start,
    the others at their end."""
    x = sig._x
    out = x.new_zeros((x.shape[0], total))
    dev = x.device
    if len(channels_not):
        out[torch.as_tensor(channels_not, device=dev)] = pad_trim_axis(rest, total, -1, True)
    out[torch.as_tensor(channels, device=dev)] = pad_trim_axis(delayed, total, -1, False)
    if keep_length:
        out = out[:, : x.shape[1]]
    return sig.copy_with_new_time_data(out.T)


def fractional_delay(
    sig,
    delay_seconds: float,
    channels=None,
    keep_length: bool = False,
    order: int = 30,
    side_lobe_suppression_db: float = 60,
):
    """Delay by a Kaiser-windowed-sinc fractional-delay FIR
    (`latency_delay.py:89`): the selected channels convolved with it on the
    device, the others zero-padded at their end to the same length."""
    assert delay_seconds >= 0, "Delay must be positive"
    if isinstance(sig, Signal):
        if delay_seconds == 0:
            return sig.copy()
        if sig.is_complex_signal:
            warn(
                "Imaginary time data will be ignored in this function. "
                "Delay it manually by creating another signal object, if "
                "needed."
            )
        delay_samples = delay_seconds * sig.sampling_rate_hz
        T = sig.length_samples
        if keep_length:
            assert delay_samples < T, "Delay too large for the given signal"
        channels, channels_not = _channels(sig, channels)
        delay_int, frac_filter = fractional_delay_filter(
            delay_samples, order, side_lobe_suppression_db
        )
        x = sig._x
        full_len = T + len(frac_filter) - 1
        delayed = fft_convolve(
            x[torch.as_tensor(channels, device=x.device)],
            torch.as_tensor(frac_filter, dtype=x.dtype, device=x.device),
        )
        rest = pad_trim_axis(x[torch.as_tensor(channels_not, device=x.device)], full_len)
        return _assemble(sig, delay_int + full_len, delayed, rest, channels,
                         channels_not, keep_length)
    if isinstance(sig, MultiBandSignal):
        out_sig = sig.copy()
        out_sig.bands = [
            fractional_delay(b, delay_seconds, channels, keep_length, order,
                             side_lobe_suppression_db)
            for b in sig.bands
        ]
        return out_sig
    raise TypeError("Passed signal should be either type Signal or MultiBandSignal")


def delay(sig, delay_samples: int, channels=None, keep_length: bool = False):
    """Integer delay by zero-padding the selected channels at their start
    and the others at their end (`latency_delay.py:173`)."""
    if isinstance(sig, Signal):
        if delay_samples == 0:
            return sig.copy()
        T = sig.length_samples
        if keep_length:
            assert delay_samples < T, "Delay too large for the given signal"
        channels, channels_not = _channels(sig, channels)
        x = sig._x
        return _assemble(
            sig, delay_samples + T, x[torch.as_tensor(channels, device=x.device)],
            x[torch.as_tensor(channels_not, device=x.device)], channels, channels_not,
            keep_length,
        )
    if isinstance(sig, MultiBandSignal):
        out_sig = sig.copy()
        out_sig.bands = [delay(b, delay_samples, channels, keep_length) for b in sig.bands]
        return out_sig
    raise TypeError("Passed signal should be either type Signal or MultiBandSignal")

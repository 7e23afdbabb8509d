"""Latency estimation (`dsptoolbox_tpu/helpers/latency.py`): the FFT
cross-correlation and the analytic signal run on the data's device; the
sub-sample peak refinement (a polynomial root a channel, on a few samples
around each peak) runs on the host after one fetch of those samples.
"""

from __future__ import annotations

from functools import lru_cache
from warnings import warn

import numpy as np
import torch

from ..ops.fft_conv import fft_correlate


@lru_cache(maxsize=8)
def _hilbert_weights(N: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The analytic signal's spectral weights (1, 2, …, 2, 1, 0, …) on
    ``device``, cached: a copy from host memory would wait for the queued
    device work on every call."""
    h = np.zeros(N)
    if N % 2 == 0:
        h[0] = h[N // 2] = 1
        h[1 : N // 2] = 2
    else:
        h[0] = 1
        h[1 : (N + 1) // 2] = 2
    return torch.as_tensor(h, dtype=dtype, device=device)


def analytic_signal(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Hilbert analytic signal along ``dim`` (``scipy.signal.hilbert``)."""
    N = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = N
    X = torch.fft.fft(x, dim=dim)
    return torch.fft.ifft(X * _hilbert_weights(N, X.real.dtype, x.device).reshape(shape),
                          dim=dim)


def wrap_phase(phase: torch.Tensor) -> torch.Tensor:
    """Phase wrapped into [-π, π) (`helpers/spectrum_utilities.py:25`)."""
    return (phase + np.pi) % (2 * np.pi) - np.pi


def get_fractional_impulse_peak_index(
    time_data: torch.Tensor, polynomial_points: int = 1
) -> np.ndarray:
    """Sub-sample impulse peak per channel of ``time_data (T, C)``
    (`helpers/latency.py:40`; reference `dsptoolbox/helpers/latency.py:10-98`):
    a polynomial root of the imaginary part of the analytic signal around
    the magnitude peak; the integer peak, with a warning, where none lies
    in [0, 1]."""
    n_channels = time_data.shape[1]
    delay_samples = time_data.abs().argmax(dim=0).cpu().numpy().astype(int)
    # restrict to the peak region (±200 safety samples, like the reference)
    start_offset = max(int(np.min(delay_samples)) - 200, 0)
    region = time_data[start_offset : int(np.max(delay_samples)) + 200, :]
    delay_samples = delay_samples - start_offset
    h = analytic_signal(region, dim=0).imag.cpu().numpy()
    x = np.arange(-polynomial_points + 1, polynomial_points + 1)
    latency_samples = np.zeros(n_channels)
    for ch in range(n_channels):
        sel = h[delay_samples[ch] : delay_samples[ch] + 2, ch]
        move_back_one_sample = bool(sel[0] * sel[1] > 0)
        delay_samples[ch] -= int(move_back_one_sample)
        if h[delay_samples[ch], ch] * h[delay_samples[ch] + 1, ch] > 0:
            latency_samples[ch] = delay_samples[ch] + int(move_back_one_sample)
            warn(
                f"Fractional latency detection failed for channel {ch}. "
                "Integer latency is returned"
            )
            continue
        pol = np.polyfit(
            x,
            h[
                delay_samples[ch] - polynomial_points + 1 : delay_samples[ch]
                + polynomial_points
                + 1,
                ch,
            ],
            deg=2 * polynomial_points - 1,
        )
        roots = np.roots(pol)
        roots = roots[(roots == roots.real) & (roots <= 1) & (roots >= 0)].real
        if len(roots) == 0:
            warn(
                f"Fractional latency detection failed for channel {ch}. "
                "Integer latency is returned"
            )
            latency_samples[ch] = delay_samples[ch] + int(move_back_one_sample)
            continue
        latency_samples[ch] = delay_samples[ch] + roots[0]
    return latency_samples + start_offset


def _correlation_inputs(td1: torch.Tensor, td2: torch.Tensor | None):
    """``(a (C', T), b (C', T))`` whose correlation gives the latencies of
    ``td1 (T, C)`` against ``td2`` (or, without one, of td1's channels 1…
    against its channel 0).

    parity: the reference correlates the 2-D arrays with scipy's N-D
    correlate, which flips the channel axis of its second input too, so
    without ``td2`` the latencies of 3+ channels come back in reversed
    channel order (`helpers/latency.py:140-142`)."""
    if td2 is None:
        return td1[:, :1].T, td1[:, 1:].flip(1).T
    return td2.T, td1.T


def fractional_latency(
    td1: torch.Tensor, td2: torch.Tensor | None, polynomial_points: int = 1
) -> np.ndarray:
    """Sub-sample latency between signals ``(T, C)`` through the analytic
    cross-correlation (`helpers/latency.py:104`)."""
    xcor = fft_correlate(*_correlation_inputs(td1, td2))  # (C', L)
    inds = get_fractional_impulse_peak_index(xcor.T, polynomial_points)
    return td1.shape[0] - inds - 1


def remove_ir_latency_from_phase(
    freqs: np.ndarray,
    phase: torch.Tensor,
    latency_samples: np.ndarray,
    sampling_rate_hz: int,
) -> torch.Tensor:
    """Add back the linear phase of the impulse delay and wrap
    (`helpers/latency.py:125`). ``phase (F, C)``."""
    delays_s = np.asarray(latency_samples, dtype=np.float64) / sampling_rate_hz
    lin = 2 * np.pi * np.asarray(freqs, dtype=np.float64)[:, None] * delays_s[None, :]
    return wrap_phase(phase + torch.as_tensor(lin, dtype=phase.dtype, device=phase.device))


def correlation_of_latencies(
    time_data: torch.Tensor, other_time_data: torch.Tensor, latencies: np.ndarray
) -> np.ndarray:
    """Pearson correlation per channel after the latency compensation
    (`helpers/latency.py:139`; reference `helpers/latency.py:217-265`), on
    the data's device; one fetch of the ``(C,)`` result."""
    one_channel = time_data.shape[1] == 1
    correlations = []
    for ch in range(len(latencies)):
        mine = time_data[:, 0] if one_channel else time_data[:, ch]
        other = other_time_data[:, ch]
        undelayed, delayed = (mine, other) if latencies[ch] > 0 else (other, mine)
        delayed = delayed[abs(int(latencies[ch])) :]
        n = min(len(delayed), len(undelayed))
        d = delayed[:n] - delayed[:n].mean()
        u = undelayed[:n] - undelayed[:n].mean()
        denom = torch.sqrt((d**2).sum() * (u**2).sum())
        correlations.append(torch.where(denom > 0, (d * u).sum() / denom, 0.0))
    if not correlations:
        return np.zeros(0)
    return torch.stack(correlations).double().cpu().numpy()

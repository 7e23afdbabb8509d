"""Fractional-octave and exponential time smoothing
(`dsptoolbox_tpu/helpers/smoothing.py`).

The fractional-octave smoothing of the reference (`dsptoolbox/helpers/
smoothing.py:9`, pyfar's method) resamples the data onto a log grid by
PCHIP, convolves it with a normalized window and resamples it back. The
grids and the window depend only on the length, so they are built on the
host; the data runs through gathers and one FFT convolution on its device.
The single-coefficient EMA that the IR trimming and the energy decay curve
run on 1-D host data stays host scipy. `time_smoothing` runs on the data's
device: one coefficient as a first-order `ops.iir.lfilter` (B2 on a float32
CUDA tensor), attack and release as `ops.cuda_ema.ema_attack_release` (the
EMA kernel).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy.signal import windows as _sw

from .._config import device_cache
from ..ops.fft_conv import fft_convolve
from .interpolation import linear_interpolate, pchip_interpolate


@lru_cache(maxsize=64)
def _log_grid(N: int) -> tuple:
    """The reference's log-frequency grid (`helpers/smoothing.py:60-67`):
    ``(l1, k_log, beta)`` with ``k_log = N**(l/(N-1))`` and ``beta =
    log2(k_log[1])``."""
    l1 = np.arange(N, dtype=np.float64)
    k_log = N ** (l1 / (N - 1))
    return l1 + 1.0, k_log, np.log2(k_log[1])


def _smoothing_window(n_window: int, window_type="hann", window_vec=None) -> np.ndarray:
    """The normalized smoothing window (`helpers/smoothing.py:33`); a
    ``("gauss", alpha)`` type takes the reference's alpha
    parametrization."""
    if window_type is not None:
        assert window_vec is None
        if isinstance(window_type, tuple) and "gauss" in window_type[0]:
            sigma = (n_window - 1) / (2 * window_type[1])
            window_type = ("gaussian", sigma)
        w = _sw.get_window(window_type, n_window, fftbins=False)
    else:
        w = np.asarray(window_vec, dtype=np.float64)
    return w / w.sum()


@device_cache(16)
def _device_window(data: bytes, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A float64 host window (as bytes) on ``device``, cached."""
    return torch.as_tensor(np.frombuffer(data, np.float64).copy(), dtype=dtype, device=device)


def fractional_octave_smoothing(
    vector: torch.Tensor,
    bin_spacing_octaves: float | None = None,
    num_fractions: int = 3,
    window_type="hann",
    window_vec: np.ndarray | None = None,
    clip_values: bool = False,
    axis: int = 0,
) -> torch.Tensor:
    """1/``num_fractions``-octave smoothing of a real ``vector`` along
    ``axis`` on its device (`helpers/smoothing.py:46`): PCHIP onto the log
    grid (for a linear grid, ``bin_spacing_octaves`` None), an edge-padded
    windowed moving average through `fft_convolve` (``mode="valid"``),
    linear interpolation back."""
    vector = torch.movedim(vector, axis, 0)
    N = vector.shape[0]
    lin_spaced = bin_spacing_octaves is None
    if lin_spaced:
        l1, k_log, beta = _log_grid(N)
        work = pchip_interpolate(l1, vector, k_log, axis=0)
    else:
        beta = bin_spacing_octaves
        work = vector
    n_window = int(1 / (num_fractions * beta) + 0.5)
    n_window += 1 - n_window % 2  # odd
    window = _smoothing_window(n_window, window_type, window_vec)
    nh = n_window // 2
    pad_lo, pad_hi = nh, nh - (1 - n_window % 2)
    rest = work.shape[1:]
    padded = torch.cat(
        [work[:1].expand((pad_lo,) + rest), work, work[-1:].expand((pad_hi,) + rest)], dim=0
    )
    w = _device_window(np.asarray(window, np.float64).tobytes(), work.dtype, work.device)
    smoothed = torch.movedim(fft_convolve(torch.movedim(padded, 0, -1), w, mode="valid"), -1, 0)
    if lin_spaced:
        smoothed = linear_interpolate(k_log, smoothed, l1, axis=0)
    if clip_values:
        smoothed = smoothed.clamp(min=0)
    return torch.movedim(smoothed, 0, axis)


def get_smoothing_factor_ema(
    relaxation_time_s: float, sampling_rate_hz: int, accuracy: float = 0.95
) -> float:
    """EMA coefficient for a given relaxation time
    (`helpers/smoothing.py:100`)."""
    factor = np.log(1 - accuracy)
    return float(1 - np.exp(factor / relaxation_time_s / sampling_rate_hz))


def time_smoothing_host(
    x: np.ndarray, sampling_rate_hz: int, ascending_time_s: float
) -> np.ndarray:
    """Single-coefficient EMA over the last axis with scipy ``lfilter``,
    its steady-state ``lfilter_zi`` scaled by the first sample
    (`helpers/smoothing.py:109`)."""
    from scipy.signal import lfilter, lfilter_zi

    x = np.asarray(x)
    if ascending_time_s <= 0.0:
        return x.copy()  # alpha = 1: identity
    alpha = get_smoothing_factor_ema(ascending_time_s, sampling_rate_hz)
    b = np.array([alpha])
    a = np.array([1.0, -(1.0 - alpha)])
    zi = lfilter_zi(b, a)
    y, _ = lfilter(b, a, x, zi=zi * x[..., :1], axis=-1)
    return y


def time_smoothing(
    x: torch.Tensor,
    sampling_rate_hz: int,
    ascending_time_s: float,
    descending_time_s: float | None = None,
    axis: int = -1,
) -> torch.Tensor:
    """Exponential moving average over time, with optional separate attack
    and release time constants (`helpers/smoothing.py:130`), on ``x``'s
    device (numpy input goes to the CPU).

    One coefficient: ``lfilter([α], [1, α−1])`` from the steady state
    scaled by the first sample (formed in float64), first order, so B2 on
    a float32 CUDA tensor. With a release time the coefficient follows the
    signal's direction, ``y[0] = x[0]``: `ops.cuda_ema.ema_attack_release`.
    """
    from ..ops.cuda_ema import ema_attack_release
    from ..ops.iir import lfilter, lfilter_zi

    x = torch.as_tensor(x).movedim(axis, -1)
    alpha = (
        get_smoothing_factor_ema(ascending_time_s, sampling_rate_hz)
        if ascending_time_s > 0.0
        else 1.0
    )
    if descending_time_s is None:
        b = np.array([alpha])
        a = np.array([1.0, -(1.0 - alpha)])
        zi = torch.as_tensor(lfilter_zi(b, a), dtype=torch.float64, device=x.device)
        y, _ = lfilter(b, a, x, zi=zi * x[..., :1].to(torch.float64))
    else:
        beta = (
            get_smoothing_factor_ema(descending_time_s, sampling_rate_hz)
            if descending_time_s > 0.0
            else 1.0
        )
        y = ema_attack_release(x, alpha, beta)
    return y.movedim(-1, axis)

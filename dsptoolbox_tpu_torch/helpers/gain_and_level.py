"""dB conversions, normalization and fades
(`dsptoolbox_tpu/helpers/gain_and_level.py`).

Array convention: time on ``axis`` (the last by default); the ramps are
host float64 numpy, applied on the data's device. `to_db` and `from_db`
take numpy (or scalars) or tensors and return the same kind: host decision
logic stays in numpy, device data on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._enums import FadeType


def to_db(
    x,
    amplitude_input: bool = True,
    dynamic_range_db: float | None = None,
    min_value: float | None = float(np.finfo(np.float64).smallest_normal),
):
    """Magnitude (or power) → dB (`helpers/gain_and_level.py:19`).

    ``dynamic_range_db`` floors values at ``max - range`` (in dB);
    ``min_value`` floors absolute values before the log. With both None
    the raw log is taken (may give -inf).
    """
    factor = 20.0 if amplitude_input else 10.0
    if torch.is_tensor(x):
        x_abs = x.abs()
        if min_value is None and dynamic_range_db is None:
            return factor * torch.log10(x_abs)
        if dynamic_range_db is not None:
            min_val = x_abs.max() * 10.0 ** (-abs(dynamic_range_db) / factor)
        else:
            min_val = min_value
        return factor * torch.log10(torch.clamp(x_abs, min=min_val))
    x = np.asarray(x)
    if min_value is None and dynamic_range_db is None:
        with np.errstate(divide="ignore"):
            return factor * np.log10(np.abs(x))
    x_abs = np.abs(x)
    if dynamic_range_db is not None:
        min_val = np.max(x_abs) * 10.0 ** (-abs(dynamic_range_db) / factor)
    else:
        min_val = min_value
    return factor * np.log10(np.maximum(x_abs, min_val))


def from_db(x, amplitude_output: bool = True):
    """dB → linear amplitude (or power) (`helpers/gain_and_level.py:60`)."""
    factor = 20.0 if amplitude_output else 10.0
    if torch.is_tensor(x):
        return 10.0 ** (x / factor)
    return 10.0 ** (np.asarray(x) / factor)


def rms(x, axis: int = -1, remove_mean: bool = True):
    """RMS along ``axis`` (`helpers/gain_and_level.py:69`): the standard
    deviation (the reference's ``_rms`` removes the mean), or with
    ``remove_mean=False`` the plain quadratic mean. A tensor stays on its
    device, numpy stays numpy."""
    if torch.is_tensor(x):
        if remove_mean:
            return x.std(dim=axis, correction=0)
        return x.abs().square().mean(dim=axis).sqrt()
    x = np.asarray(x)
    if remove_mean:
        return np.std(x, axis=axis)
    return np.sqrt(np.mean(np.abs(x) ** 2, axis=axis))


def amplify_db(x, db: float):
    """``x`` amplified by ``db`` decibels (`helpers/gain_and_level.py:81`)."""
    return x * 10.0 ** (db / 20.0)


def normalize(
    x: torch.Tensor,
    dbfs: float,
    peak_normalization: bool = True,
    per_channel: bool = False,
    axis: int = -1,
) -> torch.Tensor:
    """Peak- or RMS-normalize to ``dbfs`` along the time ``axis``.

    parity: RMS mode uses std-RMS (population std); non-per-channel RMS
    uses the flattened array (`helpers/gain_and_level.py:79-82`).
    """
    factor = 10.0 ** (dbfs / 20.0)
    if peak_normalization:
        if per_channel:
            denom = x.abs().amax(dim=axis, keepdim=True)
        else:
            denom = x.abs().max()
    else:
        if per_channel:
            denom = x.std(dim=axis, correction=0, keepdim=True)
        else:
            denom = x.reshape(-1).std(correction=0)
    return x * (factor / denom)


def fade_ramp(length_samples: int, mode: FadeType) -> np.ndarray:
    """Fade-in ramp of the reference's three shapes
    (`helpers/gain_and_level.py:136-144`)."""
    L = int(length_samples)
    if mode == FadeType.Exponential:
        db = np.linspace(-100, 0, L)
        return 10 ** (db / 20)
    if mode == FadeType.Linear:
        return np.linspace(0, 1, L)
    if mode == FadeType.Logarithmic:
        ramp = np.log10(np.linspace(1, 50 * 10**0.5, L))
        return ramp / ramp[-1]
    raise ValueError("No valid fade")


def fade(
    x: torch.Tensor,
    length_seconds: float,
    mode: FadeType,
    sampling_rate_hz: int,
    at_start: bool,
    axis: int = -1,
) -> torch.Tensor:
    """Apply a fade along the time ``axis`` (multiplicative ramp)."""
    if mode == FadeType.NoFade:
        return x
    assert length_seconds > 0, "Only positive lengths"
    L = int(length_seconds * sampling_rate_hz)
    T = x.shape[axis]
    assert T > L, "Signal is shorter than the desired fade"
    ramp = fade_ramp(L, mode)
    gain = np.ones(T)
    if at_start:
        gain[:L] = ramp
    else:
        gain[T - L:] = ramp[::-1]
    shape = [1] * x.ndim
    shape[axis] = T
    return x * torch.as_tensor(gain, dtype=x.dtype, device=x.device).reshape(shape)

"""Normalization and fades (`dsptoolbox_tpu/helpers/gain_and_level.py`):
what the sweep generator needs.

Array convention: time on ``axis`` (the last by default); the ramps are
host float64 numpy, applied on the data's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..standard.enums import FadeType


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

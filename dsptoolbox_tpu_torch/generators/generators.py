"""Sine sweeps (`dsptoolbox_tpu/generators/generators.py:118-210`).

The phase of a sweep reaches ~1e4 rad, where one float32 step is ~1e-3
rad, so it is built in float64 numpy on the host and wrapped mod 2π; the
sine, normalization and fades run on `_config.default_device()`, where the
returned `Signal` lives.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import default_device, default_float
from ..classes.signal import Signal
from ..helpers.gain_and_level import fade as _fade
from ..helpers.gain_and_level import normalize as _normalize
from ..ops.pad_trim import pad_trim_axis
from ..standard.enums import FadeType
from .enums import ChirpType


def _sin(phase: np.ndarray) -> torch.Tensor:
    return torch.sin(
        torch.as_tensor(phase, dtype=default_float(), device=default_device())
    )


def sync_log_chirp(
    chirp_range_hz, length_seconds: float, sampling_rate_hz: int
):
    """Novak synchronized swept sine (`generators/_generators.py:5-45`):
    ``(sweep (T,), T in seconds)``."""
    f1, f2 = chirp_range_hz[0], chirp_range_hz[1]
    f2f1 = np.log(f2 / f1)
    k = int(f1 * length_seconds / f2f1 + 0.5)
    T = k / f1 * f2f1
    L = int(0.5 + T * f1 / f2f1) / f1
    t = np.linspace(0.0, T, int(T * sampling_rate_hz + 0.5))
    phase = 2.0 * np.pi * f1 * L * (np.exp(t / L) - 1.0)
    return _sin(np.mod(phase, 2.0 * np.pi)), T


def chirp(
    sampling_rate_hz: int,
    type_of_chirp: ChirpType = ChirpType.Logarithmic,
    range_hz=None,
    length_seconds: float = 1.0,
    peak_level_dbfs: float = -10.0,
    number_of_channels: int = 1,
    fade: FadeType = FadeType.Logarithmic,
    phase_offset: float = 0.0,
    padding_end_seconds: float = 0.0,
):
    """Sine sweeps (`generators/generators.py:147-270`). Returns
    ``(Signal, T)`` for SyncLog, else ``Signal``."""
    if range_hz is not None:
        assert len(range_hz) == 2, (
            "range_hz has to contain exactly two frequencies"
        )
        range_hz = sorted(range_hz)
        assert range_hz[0] > 0, (
            "Range has to start with positive frequencies excluding 0"
        )
        assert range_hz[1] <= sampling_rate_hz // 2, (
            "Upper limit for frequency range cannot be bigger than the "
            "nyquist frequency"
        )
    else:
        range_hz = [15, sampling_rate_hz // 2]
    p_samples = 0
    if padding_end_seconds != 0:
        assert padding_end_seconds > 0, "Padding has to be a positive time"
        p_samples = int(padding_end_seconds * sampling_rate_hz)
    l_samples = int(sampling_rate_hz * length_seconds + 0.5)

    T = None
    if type_of_chirp == ChirpType.Linear:
        t = np.linspace(0, length_seconds, l_samples)
        k = (range_hz[1] - range_hz[0]) / length_seconds
        freqs = (range_hz[0] + k / 2 * t) * 2 * np.pi
        chirp_td = _sin(np.mod(freqs * t + phase_offset, 2 * np.pi))
    elif type_of_chirp == ChirpType.Logarithmic:
        t = np.linspace(0, length_seconds, l_samples)
        k = np.exp(
            (np.log(range_hz[1]) - np.log(range_hz[0])) / length_seconds
        )
        chirp_td = _sin(np.mod(
            2 * np.pi * range_hz[0] / np.log(k) * (k**t - 1) + phase_offset,
            2 * np.pi,
        ))
    elif type_of_chirp == ChirpType.SyncLog:
        chirp_td, T = sync_log_chirp(
            range_hz, length_seconds, sampling_rate_hz
        )
    else:
        raise ValueError("Unsupported chirp type")

    chirp_td = _normalize(
        chirp_td, peak_level_dbfs, peak_normalization=True, per_channel=True
    )
    if fade is not None:
        fade_length = 0.05 * length_seconds
        chirp_td = _fade(chirp_td, fade_length, fade, sampling_rate_hz, True)
        chirp_td = _fade(chirp_td, fade_length, fade, sampling_rate_hz, False)
    chirp_td = pad_trim_axis(chirp_td, l_samples + p_samples, axis=-1)
    chirp_td = chirp_td[:, None].repeat(1, number_of_channels)
    sig = Signal(None, chirp_td, sampling_rate_hz)
    return (sig, T) if type_of_chirp == ChirpType.SyncLog else sig

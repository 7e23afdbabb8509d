"""Time smoothing on the host (`dsptoolbox_tpu/helpers/smoothing.py`): the
single-coefficient EMA that the IR trimming and the energy decay curve run
on 1-D host data. Not ported yet: the spectral smoothing and the device
``time_smoothing``."""

from __future__ import annotations

import numpy as np


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

"""Custom window construction, host-side float64
(`dsptoolbox_tpu/helpers/windows_extra.py`)."""

from __future__ import annotations

import numpy as np
from scipy.signal import windows as _sw

from .._enums import Window


def calculate_tukey_like_window(
    points,
    window_length: int,
    window_type,
    at_start: bool,
    inverse: bool,
) -> np.ndarray:
    """Custom flat-top window with independent rising/falling flanks placed at
    the four ``points`` (`helpers/windows.py:8-77` of dsptoolbox)."""
    if len(points) != 4:
        raise ValueError("For the custom window 4 points are needed")
    if isinstance(window_type, Window):
        left = right = window_type.to_scipy_format()
    elif isinstance(window_type, list):
        if len(window_type) != 2:
            raise ValueError("There must be exactly two window types")
        left = window_type[0].to_scipy_format()
        right = window_type[1].to_scipy_format()
    else:
        left = right = window_type

    idx = [int(i) for i in points]
    len_low = idx[1] - idx[0]
    if at_start and len_low > 0:
        low_flank = _sw.get_window(left, len_low * 2, fftbins=True)[:len_low]
    else:
        low_flank = np.ones(len_low)
    len_high = idx[3] - idx[2]
    if len_high > 1:
        high_flank = _sw.get_window(right, len_high * 2, fftbins=True)[len_high:]
    else:
        high_flank = np.ones(len_high)
    window_full = np.concatenate(
        (
            np.zeros(idx[0]),
            low_flank,
            np.ones(idx[2] - idx[1]),
            high_flank,
            np.zeros(window_length - idx[3]),
        )
    )
    return 1 - window_full if inverse else window_full


def gaussian_window_sigma(window_length: int, alpha: float = 2.5) -> float:
    """Sigma of a gaussian window from its alpha (`helpers/windows_extra.py:57`)."""
    return (window_length - 1) / (2 * alpha)


def gaussian_window(length: int, alpha: float, symmetric: bool, offset: int = 0) -> np.ndarray:
    """Matlab-convention gaussian window with an optional centre offset
    (`helpers/windows_extra.py:62`)."""
    if not symmetric:
        length += 1
    n = np.arange(length)
    half = (length - 1) / 2
    w = np.exp(-0.5 * (alpha * ((n - offset) - half) / half) ** 2)
    return w[:-1] if not symmetric else w

"""Host-side window generation (`dsptoolbox_tpu/ops/windows.py`).

Windows are static given (type, length, parameters): they are produced in
float64 numpy via scipy and moved to the device by the caller.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.signal import windows as _sw

from .._enums import Window

_WINDOW_CACHE: dict = {}


def get_window(window, length: int, symmetric: bool = False) -> np.ndarray:
    """Window values as float64 numpy.

    ``window`` may be a `Window` enum member, a scipy window name/tuple, or an
    explicit array (validated for length). Generated windows are cached per
    (type, length, symmetric) and returned as copies so callers may mutate
    freely.
    """
    if isinstance(window, (Window, str)) or (
        isinstance(window, tuple)
        and all(isinstance(x, (str, int, float)) for x in window)
    ):
        ck = (window, length, symmetric)
        got = _WINDOW_CACHE.get(ck)
        if got is None:
            if isinstance(window, Window):
                got = window(length, symmetric)
            else:
                got = _sw.get_window(window, length, fftbins=not symmetric)
            _WINDOW_CACHE[ck] = got
        return got.copy()
    if isinstance(window, tuple):
        return _sw.get_window(window, length, fftbins=not symmetric)
    arr = np.asarray(window, dtype=np.float64)
    if arr.ndim != 1 or arr.shape[0] != length:
        raise ValueError(
            f"Explicit window must be 1D of length {length}, got {arr.shape}"
        )
    return arr


def check_cola(window: np.ndarray, step: int) -> bool:
    """Constant-overlap-add check (host-side, scipy), cached per window and
    step: scipy's check costs ~0.1 ms, every STFT/Welch call asks it."""
    return _check_cola(np.asarray(window, dtype=np.float64).tobytes(), step)


@lru_cache(maxsize=64)
def _check_cola(window: bytes, step: int) -> bool:
    from scipy.signal import check_COLA

    w = np.frombuffer(window, dtype=np.float64)
    return bool(check_COLA(w, nperseg=len(w), noverlap=len(w) - step))

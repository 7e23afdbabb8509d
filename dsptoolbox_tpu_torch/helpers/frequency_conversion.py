"""Frequency-scale conversions and the A/C weighting curves, host float64
numpy, copied from `dsptoolbox_tpu/helpers/frequency_conversion.py`
(reference `dsptoolbox/helpers/frequency_conversion.py`)."""

from __future__ import annotations

import numpy as np

from .gain_and_level import to_db


def hz2mel(f):
    """Hz → mel (`helpers/frequency_conversion.py:7`)."""
    return 2595 * np.log10(1 + np.asarray(f) / 700)


def mel2hz(mel):
    """mel → Hz (`helpers/frequency_conversion.py:28`)."""
    return 700 * (10 ** (np.asarray(mel) / 2595) - 1)


def frequency_weighting(
    f: np.ndarray, weighting_mode: str = "a", db_output: bool = True
):
    """IEC 61672 A/C weighting, normalized at 1 kHz
    (`helpers/frequency_conversion.py:49-95`)."""
    f = np.squeeze(np.asarray(f, dtype=np.float64))
    assert f.ndim == 1, "Frequency must be a 1D-array"
    weighting_mode = weighting_mode.lower()
    assert weighting_mode in ("a", "c"), "weighting_mode must be a or c"
    ind1k = np.argmin(np.abs(f - 1e3))
    if weighting_mode == "a":
        weights = (
            12194**2
            * f**4
            / (
                (f**2 + 20.6**2)
                * np.sqrt((f**2 + 107.7**2) * (f**2 + 737.9**2))
                * (f**2 + 12194**2)
            )
        )
    else:
        weights = 12194**2 * f**2 / ((f**2 + 20.6**2) * (f**2 + 12194**2))
    weights = weights / weights[ind1k]
    if db_output:
        return np.asarray(to_db(weights, True))
    return weights

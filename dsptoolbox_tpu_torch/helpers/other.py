"""Host-side array helpers (`dsptoolbox_tpu/helpers/other.py`)."""

from __future__ import annotations

import numpy as np


def find_nearest_points_index_in_vector(points, vector) -> np.ndarray:
    points = np.atleast_1d(np.asarray(points))
    vector = np.asarray(vector)
    return np.argmin(np.abs(points[:, None] - vector[None, :]), axis=1)


def fractional_octave_bandwidth(f_c: float, fraction: int = 1) -> np.ndarray:
    """Lower/upper band edges for a fractional-octave band
    (`helpers/other.py:156-178`)."""
    if fraction == 0:
        return np.array([f_c, f_c])
    return np.array(
        [f_c * 2 ** (-1 / fraction / 2), f_c * 2 ** (1 / fraction / 2)]
    )

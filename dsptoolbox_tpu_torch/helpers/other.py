"""Host-side array helpers (`dsptoolbox_tpu/helpers/other.py`)."""

from __future__ import annotations

import numpy as np


def find_nearest_points_index_in_vector(points, vector) -> np.ndarray:
    points = np.atleast_1d(np.asarray(points))
    vector = np.asarray(vector)
    return np.argmin(np.abs(points[:, None] - vector[None, :]), axis=1)

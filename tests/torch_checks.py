"""Comparisons shared by the port's tests (`tests/test_torch_*.py`) where a
plain scale-relative `conftest.assert_close` cannot say what agrees: values
that went through a float32 unwrapped phase, and outputs with non-finite
bins."""

import numpy as np
import torch

from conftest import assert_close


def as_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def phase_range(data) -> float:
    """The largest unwrapped phase of complex ``data`` along its first axis."""
    return float(np.abs(np.unwrap(np.angle(as_numpy(data)).astype(np.float64), axis=0)).max())


def assert_phase_close(got, want, phase_range: float, name: str, tol: float = 2e-5):
    """Values that went through an unwrapped phase in float32: their
    magnitudes at ``tol`` scale-relative, the complex values at ``tol`` or
    eight float32 ulps of the phase's range, whichever is larger. Both
    packages sum the unwrap corrections in float32, in different orders, so
    their phases differ by a few ulps of the phase itself."""
    got, want = as_numpy(got), as_numpy(want)
    assert_close(np.abs(got), np.abs(want), tol, f"{name} magnitude")
    assert_close(got, want, max(tol, 8 * 2.0**-24 * phase_range), f"{name} complex")


def assert_finite_close(got, want, tol: float, name: str):
    """Non-finite values (a spline's overshoot under a square root, a zero
    in dB, scipy's Hilbert minimum phase) at the same bins on both sides,
    the finite ones at ``tol``."""
    got, want = as_numpy(got), as_numpy(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert_close(got[finite], want[finite], tol, name)

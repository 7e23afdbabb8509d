"""Static designs of the `standard` backend (`dsptoolbox_tpu/standard/backend.py`).

Host float64 numpy, copied as they are: the Kaiser-windowed-sinc fractional
delay filters that the beamforming module's projections are built from.
"""

from __future__ import annotations

import numpy as np
from scipy.special import iv as bessel_first_mod


def kaiser_window_beta(A: float) -> float:
    """Kaiser beta from desired side-lobe suppression
    (`_standard_backend.py:259-287`)."""
    A = abs(A)
    if A > 50:
        return 0.1102 * (A - 8.7)
    if A >= 21:
        return 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21)
    return 0.0


def kaiser_window_fractional(
    length: int, side_lobe_suppression_db: float, fractional_delay: float
) -> np.ndarray:
    """Kaiser window with fractional offset (static design,
    `_standard_backend.py:289-323`)."""
    filter_order = length - 1
    alpha = filter_order / 2
    beta = kaiser_window_beta(abs(side_lobe_suppression_db))
    L = np.arange(length).astype(float) - fractional_delay
    if filter_order % 2:
        L += 0.5
    elif fractional_delay > 0.5:
        L += 1
    Z = beta * np.sqrt(
        np.array(1 - ((L - alpha) / alpha) ** 2, dtype="complex")
    )
    return np.real(bessel_first_mod(0, Z)) / bessel_first_mod(0, beta)


def fractional_delay_filter(
    delay_samples: float,
    filter_order: int,
    side_lobe_suppression_db: float,
) -> tuple[int, np.ndarray]:
    """Kaiser-windowed-sinc fractional delay FIR (static design; pyfar/Laakso
    method, `_standard_backend.py:430-493`). Returns (integer delay, fir)."""
    delay_int = int(delay_samples)
    delay_frac = delay_samples - delay_int
    if filter_order % 2:
        M_opt = int(delay_frac) - (filter_order - 1) / 2
    else:
        M_opt = np.round(delay_frac) - filter_order / 2
    n = np.arange(filter_order + 1) + M_opt - delay_frac
    sinc = np.sinc(n)
    kaiser = kaiser_window_fractional(
        filter_order + 1, side_lobe_suppression_db, delay_frac
    )
    return int(delay_int + M_opt), sinc * kaiser


def fractional_delay_filter_batch(
    delay_samples: np.ndarray,
    filter_order: int,
    side_lobe_suppression_db: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized `fractional_delay_filter` over a vector of D delays:
    returns ``(integer delays (D,) int, firs (D, order+1))`` — the same
    Kaiser-sinc design (`_standard_backend.py:430-493`) built with one
    numpy program instead of D scalar calls. Feeds the batched
    monopole projection in `beamforming`."""
    d = np.asarray(delay_samples, np.float64).reshape(-1)
    delay_int = d.astype(np.int64)
    delay_frac = d - delay_int
    length = filter_order + 1
    if filter_order % 2:
        M_opt = delay_frac.astype(np.int64) - (filter_order - 1) / 2
    else:
        M_opt = np.round(delay_frac) - filter_order / 2
    n = np.arange(length)[None, :] + M_opt[:, None] - delay_frac[:, None]
    sinc = np.sinc(n)
    # fractional Kaiser window (kaiser_window_fractional, vectorized)
    alpha = filter_order / 2
    beta = kaiser_window_beta(abs(side_lobe_suppression_db))
    L = np.arange(length, dtype=np.float64)[None, :] - delay_frac[:, None]
    if filter_order % 2:
        L = L + 0.5
    else:
        L = L + (delay_frac > 0.5)[:, None].astype(np.float64)
    Z = beta * np.sqrt(
        np.asarray(1 - ((L - alpha) / alpha) ** 2, dtype=complex)
    )
    kaiser = np.real(bessel_first_mod(0, Z)) / bessel_first_mod(0, beta)
    return (delay_int + M_opt).astype(np.int64), sinc * kaiser

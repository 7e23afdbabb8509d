"""Regularized spectral deconvolution
(`dsptoolbox_tpu/transfer_functions/_backend.py:35-66`).

Behavioral reference: `dsptoolbox/transfer_functions/_transfer_functions.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..helpers.other import find_nearest_points_index_in_vector
from ..helpers.windows_extra import calculate_tukey_like_window
from ..standard.enums import Window


def spectral_deconvolve_core(
    num_fft: torch.Tensor,
    denum_fft: torch.Tensor,
    time_signal_length: int,
    eps,
) -> torch.Tensor:
    """Batched regularized spectral division → irfft.

    ``num_fft``/``denum_fft`` shaped ``(F, C)``; ``eps`` is the
    regularization profile (already scaled), shaped ``(F, C)`` or ``(F, 1)``
    broadcasting over channels, a float for a flat profile, or None for
    plain division.
    Mirrors `_transfer_functions.py:19-43`.
    """
    if eps is not None:
        if not isinstance(eps, float):
            eps = torch.as_tensor(
                eps, dtype=num_fft.real.dtype, device=num_fft.device
            )
        denum_reg = torch.conj(denum_fft) / (denum_fft.abs() ** 2 + eps)
        product = num_fft * denum_reg
    else:
        product = num_fft / denum_fft
    return torch.fft.irfft(product, n=time_signal_length, dim=0)


def regularization_window(
    start_stop_hz, freqs_hz: np.ndarray, window_type=Window.Hann
) -> np.ndarray:
    """Inverse Tukey-like window scaled by +30 dB — the regularization
    spectrum of the reference (`_transfer_functions.py:30-36`)."""
    ids = find_nearest_points_index_in_vector(start_stop_hz, freqs_hz)
    return calculate_tukey_like_window(
        ids, len(freqs_hz), window_type, True, inverse=True
    ) * 10 ** (30 / 20)

"""Minimum phase through the real cepstrum
(`dsptoolbox_tpu/helpers/minimum_phase.py`; reference
`dsptoolbox/helpers/minimum_phase.py`), on the data's device: FFT → log
magnitude → inverse FFT → the cepstral fold (a host mask, cached on the
device) → FFT → exp, batched over channels.

Channels-first ``(..., T)``, time on the last axis.

A departure from the JAX package (ROADMAP C7): float32 rounds a magnitude
far below its row's peak (a regularized sweep IR's band above the sweep,
~1e-7 of the peak) to exactly 0 at some bins, where the JAX package takes
``log 0 = -inf`` and the inverse FFT spreads it to every sample (NaN). The
port floors those exact zeros at float32's resolution of the row, ``eps ·
max|X|``, the magnitude the float32 FFT can still tell from 0; every other
bin is as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import device_cache
from ..ops.fft_conv import next_fast_len


@device_cache(8)
def _cepstral_mask(N: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The real-cepstrum method's doubling and zeroing mask
    (`helpers/minimum_phase.py:19`)."""
    m = np.ones(N)
    half = N // 2 if N % 2 == 0 else (N + 1) // 2
    m[1:half] = 2.0
    m[half + (N % 2 == 0):] = 0.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def minimum_phase_spectrum_from_real_cepstrum(
    time_data: torch.Tensor, padding_factor: int = 8
) -> torch.Tensor:
    """The full (two-sided) minimum-phase spectrum of ``time_data (...,
    T)``, ``next_fast_len(T · padding_factor)`` bins long
    (`helpers/minimum_phase.py:32`); exact zeros of ``|X|`` floored (see
    the module's docstring)."""
    T = time_data.shape[-1]
    n = next_fast_len(max(T * padding_factor, T), False)
    mag = torch.fft.fft(time_data, n=n, dim=-1).abs()
    floor = mag.amax(dim=-1, keepdim=True) * torch.finfo(mag.dtype).eps
    y = torch.fft.ifft(torch.log(torch.where(mag == 0, floor, mag)), dim=-1).real
    y = y * _cepstral_mask(n, y.dtype, y.device)
    return torch.exp(torch.fft.fft(y, dim=-1))


def min_phase_ir_from_real_cepstrum(
    time_data: torch.Tensor, padding_factor: int = 8
) -> torch.Tensor:
    """The minimum-phase time series, at the spectrum's padded length
    (`helpers/minimum_phase.py:47`)."""
    return torch.fft.ifft(
        minimum_phase_spectrum_from_real_cepstrum(time_data, padding_factor), dim=-1
    ).real

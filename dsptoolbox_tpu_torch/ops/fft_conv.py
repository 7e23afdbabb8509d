"""FFT convolution and polyphase resampling
(`dsptoolbox_tpu/ops/fft_conv.py`) on ``torch.fft``.

The JAX package sends short real kernels on a TPU to a direct convolution;
the port convolves every length through the FFT (exact for any padded
length, and no cuDNN convolution whose TF32 default would need guarding).
The anti-alias filter of `resample_poly` is designed on the host with
``scipy.signal.firwin``, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch
from scipy.fft import next_fast_len as _scipy_next_fast_len


def next_fast_len(n: int, real: bool = True) -> int:
    """Padded FFT length for convolution: scipy's 5-smooth length.

    Any length >= the linear size is exact, only speed differs; cuFFT and
    the CPU FFTs both run 5-smooth sizes at full speed, so one rule serves
    every device.
    """
    return int(_scipy_next_fast_len(int(n), real))


def _crop(y: torch.Tensor, T: int, K: int, mode: str) -> torch.Tensor:
    if mode == "full":
        return y
    if mode == "same":
        start = (K - 1) // 2
        return y[..., start : start + T]
    if mode == "valid":
        n_valid = max(T, K) - min(T, K) + 1
        start = min(T, K) - 1
        return y[..., start : start + n_valid]
    raise ValueError(f"Unknown convolution mode: {mode!r}")


def fft_convolve(x: torch.Tensor, h: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """Linear convolution of ``x (..., T)`` with ``h (..., K)`` on the last
    axis, broadcasting the leading axes; ``mode`` in {"full", "same",
    "valid"} with scipy semantics."""
    T, K = x.shape[-1], h.shape[-1]
    n_full = T + K - 1
    if x.is_complex() or h.is_complex():
        nfft = next_fast_len(n_full, real=False)
        y = torch.fft.ifft(torch.fft.fft(x, n=nfft) * torch.fft.fft(h, n=nfft), n=nfft)
    else:
        nfft = next_fast_len(n_full, real=True)
        y = torch.fft.irfft(torch.fft.rfft(x, n=nfft) * torch.fft.rfft(h, n=nfft), n=nfft)
    return _crop(y[..., :n_full], T, K, mode)


def fft_correlate(x: torch.Tensor, y: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """Cross-correlation along the last axis through the FFT, in
    ``scipy.signal.correlate``'s order: ``convolve(x, flip(conj(y)))``
    (`dsptoolbox_tpu/ops/fft_conv.py:109`)."""
    y = y.flip(-1)
    return fft_convolve(x, y.conj() if y.is_complex() else y, mode=mode)


def upfirdn(h, x: torch.Tensor, up: int = 1, down: int = 1) -> torch.Tensor:
    """Upsample by ``up``, FIR filter with ``h`` (numpy or a tensor),
    downsample by ``down``; the output length of ``scipy.signal.upfirdn``,
    ``ceil(((T-1)*up + K) / down)``, on the last axis of ``x (..., T)``."""
    T, K = x.shape[-1], len(h)
    if up > 1:
        z = x.new_zeros(x.shape + (up,))
        z[..., 0] = x
        x = z.reshape(x.shape[:-1] + (T * up,))
    y = fft_convolve(x, torch.as_tensor(h, dtype=x.dtype, device=x.device))
    n_out = -(-((T - 1) * up + K) // down)
    return y[..., ::down][..., :n_out]


@lru_cache(maxsize=32)
def _poly_filter(up: int, down: int, beta: float, T: int, dtype: torch.dtype, device):
    """``(h on device, n_pre_remove, n_out)`` of `resample_poly` for a
    signal of length T: designed on the host once and kept on the device,
    so a call uploads nothing (an upload of host memory waits for the
    device's queued work)."""
    from scipy.signal import firwin

    n_out = (T * up) // down + (1 if (T * up) % down else 0)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", beta)) * up
    # scipy zero-pads so that the filter's group delay lands on output 0
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while -(-((T - 1) * up + len(h) + n_pre_pad + n_post_pad) // down) < n_out + n_pre_remove:
        n_post_pad += 1
    h_full = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    return torch.as_tensor(h_full, dtype=dtype, device=device), n_pre_remove, n_out


def resample_poly(x: torch.Tensor, up: int, down: int, beta: float = 5.0) -> torch.Tensor:
    """Polyphase resampling of ``x (..., T)`` matching
    ``scipy.signal.resample_poly``'s defaults (a kaiser(5.0) anti-alias
    FIR, zero padding)."""
    g = gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == down == 1:
        return x
    h, n_pre_remove, n_out = _poly_filter(up, down, float(beta), x.shape[-1], x.dtype, x.device)
    return upfirdn(h, x, up, down)[..., n_pre_remove : n_pre_remove + n_out]

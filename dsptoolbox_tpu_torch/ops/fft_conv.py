"""FFT length planning (`dsptoolbox_tpu/ops/fft_conv.py:next_fast_len`)."""

from __future__ import annotations

from scipy.fft import next_fast_len as _scipy_next_fast_len


def next_fast_len(n: int, real: bool = True) -> int:
    """Padded FFT length for convolution: scipy's 5-smooth length.

    Any length >= the linear size is exact, only speed differs; cuFFT and
    the CPU FFTs both run 5-smooth sizes at full speed, so one rule serves
    every device.
    """
    return int(_scipy_next_fast_len(int(n), real))

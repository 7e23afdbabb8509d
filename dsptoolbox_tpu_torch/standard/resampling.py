"""Resampling of signals (`dsptoolbox_tpu/standard/resampling.py`):
polyphase resampling on the signal's device (`ops.fft_conv.resample_poly`).
Not ported yet: ``resample_filter``."""

from __future__ import annotations

from fractions import Fraction

from ..classes.signal import Signal
from ..ops.fft_conv import resample_poly


def resample(sig: Signal, desired_sampling_rate_hz: int, rescaling: bool = False) -> Signal:
    """Polyphase resampling of the real part (`resampling.py:16`);
    ``rescaling`` multiplies by down/up."""
    if sig.sampling_rate_hz == desired_sampling_rate_hz:
        return sig.copy()
    u, d = Fraction(desired_sampling_rate_hz, sig.sampling_rate_hz).as_integer_ratio()
    y = resample_poly(sig._x, up=u, down=d)
    if rescaling:
        y = y * (d / u)
    new_sig = sig.copy_with_new_time_data(y.T)
    new_sig.sampling_rate_hz = desired_sampling_rate_hz
    return new_sig

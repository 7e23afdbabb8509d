"""Resampling of signals and filters (`dsptoolbox_tpu/standard/resampling.py`):
polyphase resampling on the signal's device (`ops.fft_conv.resample_poly`);
a filter's redesign at another rate on the host."""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..classes.filter import Filter
from ..classes.signal import Signal
from ..ops.fft_conv import resample_poly
from .._trace import spanned
from .enums import FilterCoefficientsType


@spanned("dsp.entry.standard.resample")
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


def resample_filter(filter: Filter, new_sampling_rate_hz: int) -> Filter:
    """A filter redesigned for another sampling rate through its analog
    prototype: zpk → inverse bilinear → bilinear at the new rate
    (`resampling.py:42`), host scipy."""
    from scipy.signal import bilinear_zpk

    z, p, k = filter.get_coefficients(FilterCoefficientsType.Zpk)
    add_to_poles = max(0, len(z) - len(p))
    add_to_zeros = max(0, len(p) - len(z))
    f = 2 * filter.sampling_rate_hz
    p = f * (p - 1) / (p + 1)
    z = z[z != -1.0]
    z = f * (z - 1) / (z + 1)
    if add_to_poles:
        p = np.hstack([p, [-f] * (len(z) - len(p))])
    if add_to_zeros:
        z = np.hstack([z, [-f] * (len(p) - len(z))])
    k /= np.real(np.prod(f - z) / np.prod(f - p))
    z, p, k = bilinear_zpk(z, p, k, new_sampling_rate_hz)
    return Filter.from_zpk(z, p, k, new_sampling_rate_hz)

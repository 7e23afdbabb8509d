"""Signal-level filtering glue (`dsptoolbox_tpu/classes/filter_helpers.py`).

Coefficients stay host numpy; the data runs through `ops.iir` (the blocked
IIR, kernel B2 on a CUDA tensor) and `ops.fft_conv`, channels-first, on the
signal's device. Not ported: the float64 host-scipy routing of the JAX
package's ``_oracle_exact_f64`` (float64 mode runs the same torch paths in
float64), and zero-phase ``ba`` filtering. The RBJ biquad coefficients are host
float64 numpy, copied.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from ..ops.fft_conv import fft_convolve
from ..ops.iir import sosfilt, sosfilt_zero_state, sosfiltfilt
from ..ops.iir_block import lfilter_block
from .._enums import BiquadEqType


def biquad_coefficients(
    eq_type: BiquadEqType,
    fs_hz: int,
    frequency_hz: float,
    gain_db: float,
    q: float,
):
    """RBJ audio-EQ-cookbook biquad coefficients.

    parity: like the reference (`classes/filter_helpers.py:30-44`), the
    linear gain ``A`` multiplies the numerator of *every* eq type (not only
    peak/shelf, where the cookbook defines it as 10^(G/40)).
    """
    shelf_like = eq_type in (
        BiquadEqType.Peaking,
        BiquadEqType.Lowshelf,
        BiquadEqType.Highshelf,
    )
    A = 10 ** (gain_db / 40) if shelf_like else 10 ** (gain_db / 20)
    Omega = 2.0 * np.pi * (frequency_hz / fs_hz)
    sn, cs = np.sin(Omega), np.cos(Omega)
    alpha = sn / (2.0 * q)
    sqA = np.sqrt(A)
    b = np.zeros(3)
    a = np.zeros(3)
    if eq_type == BiquadEqType.Peaking:
        b[:] = 1 + alpha * A, -2 * cs, 1 - alpha * A
        a[:] = 1 + alpha / A, -2 * cs, 1 - alpha / A
    elif eq_type == BiquadEqType.Lowpass:
        b[:] = (1 - cs) / 2 * A, (1 - cs) * A, (1 - cs) / 2 * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Highpass:
        b[:] = (1 + cs) / 2 * A, -(1 + cs) * A, (1 + cs) / 2 * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.BandpassSkirt:
        b[:] = sn / 2 * A, 0.0, -sn / 2 * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.BandpassPeak:
        b[:] = alpha * A, 0.0, -alpha * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Notch:
        b[:] = A, -2 * cs * A, A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Allpass:
        b[:] = (1 - alpha) * A, -2 * cs * A, (1 + alpha) * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Lowshelf:
        b[:] = (
            A * ((A + 1) - (A - 1) * cs + 2 * sqA * alpha),
            2 * A * ((A - 1) - (A + 1) * cs),
            A * ((A + 1) - (A - 1) * cs - 2 * sqA * alpha),
        )
        a[:] = (
            (A + 1) + (A - 1) * cs + 2 * sqA * alpha,
            -2 * ((A - 1) + (A + 1) * cs),
            (A + 1) + (A - 1) * cs - 2 * sqA * alpha,
        )
    elif eq_type == BiquadEqType.Highshelf:
        b[:] = (
            A * ((A + 1) + (A - 1) * cs + 2 * sqA * alpha),
            -2 * A * ((A - 1) + (A + 1) * cs),
            A * ((A + 1) + (A - 1) * cs - 2 * sqA * alpha),
        )
        a[:] = (
            (A + 1) - (A - 1) * cs + 2 * sqA * alpha,
            2 * ((A - 1) - (A + 1) * cs),
            (A + 1) - (A - 1) * cs - 2 * sqA * alpha,
        )
    elif eq_type == BiquadEqType.LowpassFirstOrder:
        K = 1.0 / np.tan(Omega / 2.0)
        b[:] = A, A, 0.0
        a[:] = 1.0 + K, 1.0 - K, 0.0
    elif eq_type == BiquadEqType.HighpassFirstOrder:
        K = 1.0 / np.tan(Omega / 2.0)
        b[:] = K * A, -K * A, 0.0
        a[:] = 1.0 + K, 1.0 - K, 0.0
    elif eq_type == BiquadEqType.AllpassFirstOrder:
        K = 1.0 / np.tan(Omega / 2.0)
        b[:] = (1.0 - K) * A, (1.0 + K) * A, 0.0
        a[:] = 1.0 + K, 1.0 - K, 0.0
    elif eq_type == BiquadEqType.Inverter:
        b[:] = A, 0.0, 0.0
        a[:] = 1.0, 0.0, 0.0
    else:
        raise ValueError("eq_type not supported")
    return b, a


def impulse(length_samples: int = 512, delay_samples: int = 0) -> np.ndarray:
    """Unit impulse (`classes/filter_helpers.py:114`)."""
    imp = np.zeros(length_samples)
    imp[delay_samples] = 1
    return imp


def _channels(signal, channels) -> np.ndarray:
    return np.arange(signal.number_of_channels) if channels is None else np.asarray(channels)


def _is_all(signal, channels: np.ndarray) -> bool:
    return np.array_equal(channels, np.arange(signal.number_of_channels))


def _select(signal, channels: np.ndarray) -> torch.Tensor:
    """The selected channels of the real part, ``(C_sel, T)``."""
    if _is_all(signal, channels):
        return signal._x
    return signal._x[torch.as_tensor(channels, device=signal.device)]


def _replace_channels(signal, y, channels, warn_complex: bool):
    """A copy of ``signal`` with the filtered channels ``y (T, C_sel)``
    (`classes/filter_helpers.py:161`); complex output goes to the imaginary
    part with a warning. ``y`` may be a `DeviceTimeData` pair of all
    channels, which the new signal keeps as views."""
    channels = np.asarray(channels)
    full = _is_all(signal, channels)
    if isinstance(y, tuple):
        assert full, "a (real, imag) pair replaces all channels"
        if y[1] is not None and warn_complex:
            warn("Filter output is complex. Imaginary part is saved in Signal as "
                 "time_data_imaginary")
        return signal.copy_with_new_time_data(y)
    if y.is_complex() and warn_complex:
        warn("Filter output is complex. Imaginary part is saved in Signal as "
             "time_data_imaginary")
    if full:
        return signal.copy_with_new_time_data(y)
    # parity: the other channels keep only their real part, as in the JAX
    # package
    new_td = signal.time_data.to(y.dtype).clone()
    new_td[:, torch.as_tensor(channels, device=new_td.device)] = y
    return signal.copy_with_new_time_data(new_td)


def _zi_update(zi, channels: np.ndarray, run):
    """Run ``run(zi_sel)`` → ``(y, zf)`` with the selected channels' states
    stacked from the per-channel list ``zi``; returns ``y`` and the updated
    list (one host fetch for all channels)."""
    zi_all = np.stack([np.asarray(z) for z in zi], axis=0)
    y, zf = run(zi_all[channels])
    zi_all = zi_all.astype(np.result_type(zi_all.dtype, zf.cpu().numpy().dtype))
    zi_all[channels] = zf.cpu().numpy()
    return y, [zi_all[c] for c in range(zi_all.shape[0])]


def filter_on_signal(
    signal,
    sos: np.ndarray,
    channels=None,
    zi=None,
    zero_phase: bool = False,
    warning_on_complex_output: bool = True,
):
    """SOS filtering of (selected channels of) a Signal
    (`classes/filter_helpers.py:225`). Returns ``(new_signal, zi_new)``:
    ``zi_new`` is the per-channel list of final states when ``zi`` (one
    ``(S, 2)`` state per channel of the signal) is given, else None."""
    channels = _channels(signal, channels)
    x = _select(signal, channels)  # (C_sel, T)
    zi_new = None
    if zi is not None:
        y, zi_new = _zi_update(zi, channels, lambda z: sosfilt(sos, x, zi=z))
    elif zero_phase:
        y = sosfiltfilt(sos, x)
    elif np.iscomplexobj(sos):
        y = sosfilt(sos, x)[0]
    else:
        y = sosfilt_zero_state(sos, x)
    return _replace_channels(signal, y.T, channels, warning_on_complex_output), zi_new


def filter_on_signal_ba(
    signal,
    ba,
    channels=None,
    zi=None,
    zero_phase: bool = False,
    is_fir: bool = False,
    warning_on_complex_output: bool = True,
):
    """``ba`` filtering of (selected channels of) a Signal
    (`classes/filter_helpers.py:323`): an FIR without state is one FFT
    convolution cut to the signal's length, the rest the blocked
    ``lfilter`` (a state only up to order 2). Zero-phase ``ba`` filtering is
    not ported yet. Returns ``(new_signal, zi_new)``."""
    if zero_phase:
        raise NotImplementedError("zero-phase ba filtering (filtfilt) is not ported yet")
    b, a = np.atleast_1d(ba[0]), np.atleast_1d(ba[1])
    channels = _channels(signal, channels)
    x = _select(signal, channels)
    zi_new = None
    if zi is not None:
        y, zi_new = _zi_update(zi, channels, lambda z: lfilter_block(b, a, x, zi=z))
    elif is_fir:
        cdt = torch.complex64 if x.dtype == torch.float32 else torch.complex128
        h = torch.as_tensor(b / a[0], dtype=cdt if np.iscomplexobj(b) else x.dtype,
                            device=x.device)
        y = fft_convolve(x, h)[..., : x.shape[-1]]
    else:
        y = lfilter_block(b, a, x)[0]
    return _replace_channels(signal, y.T, channels, warning_on_complex_output), zi_new

"""Signal-level filtering glue (`dsptoolbox_tpu/classes/filter_helpers.py`).

Coefficients stay host numpy; the data runs through `ops.iir` (the blocked
IIR, kernel B2 on a CUDA tensor) and `ops.fft_conv`, channels-first, on the
signal's device. In float64 mode a real filter on a CPU signal
(`_oracle_exact_f64`) runs scipy's ``sosfilt``, ``sosfiltfilt``,
``lfilter``, ``filtfilt`` and ``oaconvolve`` in float64, as the JAX package
does; a signal on a card stays there on the torch float64 paths. The RBJ biquad coefficients are
host float64 numpy, copied.
"""

from __future__ import annotations

import os
from warnings import warn

import numpy as np
import scipy.signal as ssig
import torch

from .._config import default_float
from ..ops.fft_conv import fft_convolve
from ..ops.cuda_iir import MAX_STATES
from ..ops.iir_block import lfilter_handover
from ..ops.iir import _odd_ext, filtfilt_ba, lfilter, lfilter_zi, sosfilt, sosfilt_zero_state, sosfiltfilt
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


def _eval_descending_poly_ratio_on_arc(cr, c, n_points: int):
    """``polyval(cr, z) / polyval(c, z)`` for ``z = exp(1j·linspace(0, π,
    n_points))`` by FFT (`classes/filter_helpers.py:121`): factoring
    ``z^(L-1)`` out of both descending polynomials leaves ``Σ x[j]·z^(-j)``,
    which on the grid ``ω_k = 2πk/N`` (``N = 2(n_points-1)``) is the
    length-N real FFT of ``x`` folded mod N. Two O(N log N) float64 FFTs in
    place of the reference's O(L·F) ``np.polyval``
    (`classes/filter_helpers.py:181-189`); host float64."""
    N = 2 * (n_points - 1)

    def _fold_rfft(x):
        if len(x) > N:
            folded = np.zeros(N, dtype=x.dtype)
            np.add.at(folded, np.arange(len(x)) % N, x)
        else:
            folded = x
        return np.fft.rfft(folded, n=N)[:n_points]

    return _fold_rfft(np.asarray(cr)), _fold_rfft(np.asarray(c))


def group_delay_filter(ba, length_samples: int = 512, fs_hz: int = 48000):
    """``(f, group delay in s)`` of a filter given as ``[b, a]`` on
    ``length_samples`` points from 0 to Nyquist, by the ramped-coefficient
    polynomial ratio (`classes/filter_helpers.py:145-158`); host float64."""
    omega = np.linspace(0, np.pi, length_samples)
    c = np.convolve(ba[0], np.conjugate(ba[1][::-1]))
    cr = c * np.arange(len(c))
    num, denum = _eval_descending_poly_ratio_on_arc(cr, c, length_samples)
    with np.errstate(divide="ignore", invalid="ignore"):
        gd = np.real(num / denum) - len(ba[1]) + 1
    gd[~np.isfinite(gd)] = 0
    return omega / np.pi * (fs_hz / 2), gd / fs_hz


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


def _cascade_update(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi, channels: np.ndarray,
                    kept):
    """A stateful IIR ``(b, a)`` of order 3 to `cuda_iir.MAX_STATES` through
    `iir_block.lfilter_handover` with the per-channel states ``zi``.
    ``kept`` (one entry a channel of ``zi``, or None) holds, for each
    channel filtered before, the TDF2 state it was handed and the cascade
    state that state came from: a channel whose ``zi`` is still the one
    handed out continues from its exact cascade state, any other from its
    ``zi`` mapped into the cascade. Returns ``y``, the updated list and the
    updated ``kept``."""
    zi_all = np.stack([np.asarray(z, np.float64) for z in zi], axis=0)
    kept = list(kept) if kept is not None and len(kept) == len(zi) else [None] * len(zi)
    rows = [kept[c] for c in channels]
    prior = None
    if any(r is not None for r in rows):
        n_c = next(r[1].shape[0] for r in rows if r is not None)
        nan, zero = np.full(zi_all.shape[1], np.nan), np.zeros(n_c)
        prior = (np.stack([nan if r is None else r[0] for r in rows]),
                 np.stack([zero if r is None else r[1] for r in rows]))
    y, _, (zf, zc_end) = lfilter_handover(b, a, x, zi_all[channels], prior)
    states = torch.cat([zf, zc_end], dim=-1).cpu().numpy()  # one host fetch
    zf, zc_end = states[:, : zi_all.shape[1]], states[:, zi_all.shape[1]:]
    zi_all[channels] = zf
    for i, c in enumerate(channels):
        kept[c] = (zf[i].copy(), zc_end[i].copy())
    return y, [zi_all[c] for c in range(zi_all.shape[0])], kept


def _oracle_exact_f64(device) -> bool:
    """True in float64 mode for data on the CPU: a real IIR or zero-phase
    filter then runs the literal scipy recursions on the host, so a float64
    result is scipy's bit for bit (`dsptoolbox_tpu/classes/filter_helpers.py:204-222`;
    the reference's tests hold it at ``rtol=1e-7, atol=0``, which no
    reassociated recursion meets on near-zero samples). Data on a card stays
    there on the torch float64 paths; the float32 paths are unaffected.
    ``DSPTB_F64_DEVICE_IIR=1`` keeps the torch paths in float64 mode on the
    CPU too, as in the JAX package."""
    if os.environ.get("DSPTB_F64_DEVICE_IIR") == "1":
        return False
    return default_float() == torch.float64 and torch.device(device).type == "cpu"


def _host_rows(signal, channels: np.ndarray) -> np.ndarray:
    """The selected channels of the real part as host float64 ``(C_sel,
    T)``."""
    return _select(signal, channels).detach().cpu().numpy().astype(np.float64)


def _to_signal_device(signal, y: np.ndarray) -> torch.Tensor:
    """Host ``y (C_sel, T)`` as a ``(T, C_sel)`` tensor on the signal's
    device."""
    return torch.from_numpy(np.ascontiguousarray(y.T)).to(signal.device)


def _host_zi_update(zi, channels: np.ndarray, run):
    """`_zi_update` on the host: ``run(zi_sel)`` → ``(y, zf)`` in numpy."""
    zi_all = np.stack([np.asarray(z, np.float64) for z in zi], axis=0)
    y, zf = run(zi_all[channels])
    zi_all[channels] = zf
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
    zi_new = None
    if _oracle_exact_f64(signal.device) and not np.iscomplexobj(sos):
        xh = _host_rows(signal, channels)
        if zi is not None:
            def run(z):  # per channel (S, 2); scipy's layout (S, C_sel, 2)
                y, zf = ssig.sosfilt(sos, xh, axis=-1, zi=np.transpose(z, (1, 0, 2)))
                return y, np.transpose(zf, (1, 0, 2))

            y, zi_new = _host_zi_update(zi, channels, run)
        elif zero_phase:
            y = ssig.sosfiltfilt(sos, xh, axis=-1)
        else:
            y = ssig.sosfilt(sos, xh, axis=-1)
        return _replace_channels(signal, _to_signal_device(signal, y), channels,
                                 warning_on_complex_output), zi_new
    x = _select(signal, channels)  # (C_sel, T)
    if zi is not None:
        y, zi_new = _zi_update(zi, channels, lambda z: sosfilt(sos, x, zi=z))
    elif zero_phase:
        y = sosfiltfilt(sos, x)
    elif np.iscomplexobj(sos):
        y = sosfilt(sos, x)[0]
    else:
        y = sosfilt_zero_state(sos, x)
    return _replace_channels(signal, y.T, channels, warning_on_complex_output), zi_new


def _zero_phase_fir(b: np.ndarray, a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.filtfilt`` of an FIR in convolution form
    (`dsptoolbox_tpu/classes/filter_helpers.py:394-424`): without feedback
    the TDF2 start state ``lfilter_zi · u[0]`` adds to the first N output
    samples, so each pass is one FFT convolution and one add."""
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError("Input too short for filtfilt padding")
    zi0 = torch.as_tensor(lfilter_zi(b, a), dtype=x.dtype, device=x.device)
    h = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    n = zi0.shape[0]

    def one_pass(u):
        y = fft_convolve(u, h)[..., : u.shape[-1]]
        y[..., :n] += zi0 * u[..., :1]
        return y

    y = one_pass(_odd_ext(x, padlen))
    y = one_pass(y.flip(-1)).flip(-1)
    return y[..., padlen:-padlen]


def filter_on_signal_ba(
    signal,
    ba,
    channels=None,
    zi=None,
    zero_phase: bool = False,
    is_fir: bool = False,
    warning_on_complex_output: bool = True,
    kept=None,
):
    """``ba`` filtering of (selected channels of) a Signal
    (`classes/filter_helpers.py:323`): an FIR without state is one FFT
    convolution cut to the signal's length (in zero phase, two with the
    start states added); the rest goes through `ops.iir.lfilter` (a state
    of any order) or, in zero phase, `ops.iir.filtfilt_ba`. A state of an
    IIR on the cascade route continues from the exact cascade states in
    ``kept`` (`_cascade_update`). Returns ``(new_signal, zi_new, kept)``."""
    b, a = np.atleast_1d(ba[0]), np.atleast_1d(ba[1])
    channels = _channels(signal, channels)
    zi_new = None
    if _oracle_exact_f64(signal.device) and not np.iscomplexobj(b) and not np.iscomplexobj(a):
        xh = _host_rows(signal, channels)
        if zi is not None:
            y, zi_new = _host_zi_update(
                zi, channels, lambda z: ssig.lfilter(b, a, xh, axis=-1, zi=z))
        elif zero_phase:
            y = ssig.filtfilt(b, a, xh, axis=-1)
        elif is_fir:
            y = ssig.oaconvolve(xh, b[None, :], mode="full", axes=-1)[..., : xh.shape[-1]]
        else:
            y = ssig.lfilter(b, a, xh, axis=-1)
        # the exact cascade states of the torch route do not carry over
        return _replace_channels(signal, _to_signal_device(signal, y), channels,
                                 warning_on_complex_output), zi_new, None
    x = _select(signal, channels)
    order = max(len(a), len(b)) - 1
    if zi is not None and len(np.trim_zeros(a, "b")) > 1 and 2 < order <= MAX_STATES:
        y, zi_new, kept = _cascade_update(b, a, x, zi, channels, kept)
    elif zi is not None:
        y, zi_new = _zi_update(zi, channels, lambda z: lfilter(b, a, x, zi=z))
    elif zero_phase:
        y = _zero_phase_fir(b, a, x) if is_fir else filtfilt_ba(b, a, x)
    elif is_fir:
        cdt = torch.complex64 if x.dtype == torch.float32 else torch.complex128
        h = torch.as_tensor(b / a[0], dtype=cdt if np.iscomplexobj(b) else x.dtype,
                            device=x.device)
        y = fft_convolve(x, h)[..., : x.shape[-1]]
    else:
        y = lfilter(b, a, x)[0]
    return _replace_channels(signal, y.T, channels, warning_on_complex_output), zi_new, kept

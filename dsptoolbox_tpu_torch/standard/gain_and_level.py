"""Gain, level and loudness of signals (`dsptoolbox_tpu/standard/gain_and_level.py`;
reference `dsptoolbox/standard/gain_and_level.py`).

The data stays on its device; each level function fetches only its ``(C,)``
results. `lufs_integrated` K-weights through `Filter.filter_signal` (the
blocked IIR, kernel B2 on a float32 CUDA signal longer than the
frequency-sampling window) and frames the squared output for the 400 ms
gating blocks on the device; the gating runs on the host, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..classes import Filter, FilterBank, MultiBandSignal, Signal
from ..classes.signal import DeviceTimeData
from ..helpers.gain_and_level import fade as _fade
from ..helpers.gain_and_level import from_db, to_db
from ..helpers.gain_and_level import normalize as _normalize
from ..ops.fft_conv import resample_poly
from ..ops.framing import frame_signal
from .enums import BiquadEqType, FadeType


def normalize(sig, norm_dbfs: float, peak_normalization: bool = True,
              each_channel: bool = False):
    """Peak or RMS normalisation (`gain_and_level.py:19`)."""
    if isinstance(sig, Signal):
        out = _normalize(sig._x, norm_dbfs, peak_normalization, each_channel)
        return sig.copy_with_new_time_data(out.T)
    if isinstance(sig, MultiBandSignal):
        new_sig = sig.copy()
        new_sig.bands = [
            normalize(b, norm_dbfs, peak_normalization, each_channel) for b in sig.bands
        ]
        return new_sig
    raise TypeError("Type of signal is not valid. Use either Signal or MultiBandSignal")


def fade(
    sig: Signal,
    fade_type: FadeType,
    length_fade_seconds: float | None = None,
    at_start: bool = True,
    at_end: bool = True,
) -> Signal:
    """Fade in and out (`gain_and_level.py:48`)."""
    assert at_start or at_end, "At least start or end of signal should be faded"
    if length_fade_seconds is None:
        length_fade_seconds = sig.time_vector_s[-1] * 0.025
    assert length_fade_seconds < sig.time_vector_s[-1], (
        "Fade length should not be longer than the signal itself"
    )
    td = sig._x
    if at_start:
        td = _fade(td, length_fade_seconds, fade_type, sig.sampling_rate_hz, True)
    if at_end:
        td = _fade(td, length_fade_seconds, fade_type, sig.sampling_rate_hz, False)
    return sig.copy_with_new_time_data(td.T)


def true_peak_level(signal):
    """ITU-R BS.1770-4 true peak through 4× oversampling
    (`gain_and_level.py:78`): ``(true peak dBTP (C,), peak dBFS (C,))``.
    The signal is scaled down by 12.04 dB, upsampled by
    `ops.fft_conv.resample_poly` on its device, and both peaks are fetched
    together."""
    if isinstance(signal, Signal):
        down_factor = float(from_db(-12.04, True))
        up_factor = 1 / down_factor
        x = signal._x * down_factor
        over = resample_poly(x, up=4, down=1)
        both = torch.stack([
            to_db(over.abs().amax(dim=-1) * up_factor, True),
            to_db(x.abs().amax(dim=-1) * up_factor, True),
        ]).cpu().numpy()
        return both[0], both[1]
    if isinstance(signal, MultiBandSignal):
        tpl = np.empty((signal.number_of_bands, signal.number_of_channels))
        pl = np.empty_like(tpl)
        for ind, b in enumerate(signal.bands):
            tpl[ind, :], pl[ind, :] = true_peak_level(b)
        return tpl, pl
    raise TypeError("Passed signal must be of type Signal or MultiBandSignal")


def _std(sig: Signal) -> np.ndarray:
    """Per-channel population standard deviation, summed in float64 on the
    device, fetched ``(C,)``."""
    return sig._x.double().std(dim=-1, correction=0).cpu().numpy()


def rms(sig, in_dbfs: bool = True) -> np.ndarray:
    """Per-channel (standard-deviation) RMS (`gain_and_level.py:112`)."""
    if isinstance(sig, Signal):
        vals = _std(sig)
    elif isinstance(sig, MultiBandSignal):
        vals = np.zeros((sig.number_of_bands, sig.number_of_channels))
        for ind, b in enumerate(sig):
            vals[ind, :] = _std(b)
    else:
        raise TypeError("Passed signal should be either a Signal or MultiBandSignal type")
    if in_dbfs:
        vals = 20.0 * np.log10(vals)
    return np.atleast_1d(vals)


def _k_weighting(fs_hz: int) -> Filter:
    """The two K-weighting biquads of ITU-R BS.1770 merged into one SOS
    filter (`gain_and_level.py:138-157`)."""
    from .other import merge_filters

    return merge_filters([
        Filter.biquad(eq_type=BiquadEqType.Highshelf, frequency_hz=1500, gain_db=4.0,
                      q=2**0.5 / 2.0, sampling_rate_hz=fs_hz),
        Filter.biquad(eq_type=BiquadEqType.Highpass, frequency_hz=38.1, gain_db=0.0,
                      q=0.5, sampling_rate_hz=fs_hz),
    ])


def lufs_integrated(s: Signal) -> float:
    """Integrated loudness per ITU-R BS.1770-5 (`gain_and_level.py:129`):
    K-weighting, then the mean power of 400 ms blocks with 75 % overlap on
    the device, absolute and relative gating on the host."""
    assert s.number_of_channels <= 5, "Not implemented for more channels than 5"
    fs_hz = s.sampling_rate_hz
    k_filter = _k_weighting(fs_hz)
    Tg = 400e-3
    G = np.array([1.0, 1.0, 1.0, 1.41, 1.41])[: s.number_of_channels]
    Tg_samples = int(Tg * fs_hz + 0.5)
    step = int(0.25 * Tg_samples + 0.5)
    GAMMA_A = -70
    DIFF_GAMMA_R = 10

    constrained = s.constrain_amplitude
    s.constrain_amplitude = False
    s_pre = k_filter.filter_signal(s)
    s.constrain_amplitude = constrained

    frames = frame_signal(s_pre._x**2.0, Tg_samples, step, keep_last_frames=False)
    z_ji = frames.mean(dim=-1).cpu().numpy().T  # (K, C)

    def gated_loudness(x):
        return -0.691 + 10.0 * np.log10(x @ G)

    l_j = gated_loudness(z_ji)
    gamma_r = gated_loudness(np.mean(z_ji[l_j > GAMMA_A, :], axis=0)) - DIFF_GAMMA_R
    return float(gated_loudness(np.mean(z_ji[l_j > max(gamma_r, GAMMA_A), :], axis=0)))


def apply_gain(target, gain_db):
    """A gain in dB on signals, filters and banks (`gain_and_level.py:171`);
    one value, or one a channel (a filter a bank)."""
    if isinstance(target, Signal):
        x, im = target._x, target._x_imag
        g = torch.as_tensor(from_db(np.atleast_1d(gain_db), True), dtype=x.dtype,
                            device=x.device)[:, None]
        return target.copy_with_new_time_data(
            DeviceTimeData((x * g).T, None if im is None else (im * g).T)
        )
    if isinstance(target, MultiBandSignal):
        new_mb = target.copy()
        new_mb.bands = [apply_gain(b, gain_db) for b in new_mb.bands]
        return new_mb
    if isinstance(target, Filter):
        filt = target.copy()
        gain_linear = np.asarray(from_db(np.atleast_1d(gain_db), True))
        if len(gain_linear) == 1:
            gain_linear = gain_linear[0]
        if filt.has_zpk:
            filt.zpk[-1] *= gain_linear
        if filt.has_sos:
            filt.sos[-1, :3] *= gain_linear
        else:
            filt.ba[0] *= gain_linear
        return filt
    if isinstance(target, FilterBank):
        gain = np.atleast_1d(gain_db)
        assert len(gain) == 1 or len(gain) == target.number_of_filters, (
            "Incompatible number of gains"
        )
        if len(gain) == 1:
            gain = np.repeat(gain, target.number_of_filters)
        new_fb = target.copy()
        new_fb.filters = [apply_gain(f, g) for f, g in zip(new_fb.filters, gain)]
        return new_fb
    raise TypeError("No valid type was passed")


def crest_factor(sig, in_db: bool = True, use_true_peak: bool = False) -> np.ndarray:
    """Peak-to-RMS ratio per channel (`gain_and_level.py:235`)."""
    if isinstance(sig, Signal):
        peak = (
            np.asarray(from_db(true_peak_level(sig)[0], True))
            if use_true_peak
            else sig._x.abs().amax(dim=-1).cpu().numpy()
        )
        crest = peak / _std(sig)
        if in_db:
            crest = 20.0 * np.log10(crest)
        return np.atleast_1d(crest)
    if isinstance(sig, MultiBandSignal):
        crest = np.zeros((sig.number_of_bands, sig.number_of_channels))
        for ind, b in enumerate(sig):
            crest[ind, :] = crest_factor(b, in_db, use_true_peak)
        return crest
    raise TypeError("Passed signal should be either a Signal or MultiBandSignal type")

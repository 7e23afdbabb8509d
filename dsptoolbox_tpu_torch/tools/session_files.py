"""A recorded session through the file layer, at real size: config 2's
session (`tools.speech_chain`: 16 channels × 60 s of pink noise at 48 kHz,
from a seed) as a user records, calibrates, filters, smooths and saves it:

- **write and load**: `Signal.save_signal` as a 24-bit WAV (one 16-channel
  file) and as 24-bit FLAC (two 8-channel files: FLAC holds at most 8
  channels), loaded with ``Signal(path)`` and `Signal.add_channel(path)`;
- **calibrate**: a 10 s, 1 kHz calibrator tone at 94 dB SPL written as a
  WAV, `CalibrationData` from it, `calibrate_signal` of the session;
- **stream**: a stateful ``(b, a)`` Butterworth lowpass (order 4 at 1 kHz,
  order 6 at 200 Hz) through `Filter.filter_signal(activate_zi=True)` in
  blocks of 1 s (B2, one launch a block);
- **zero phase**: the order-4 ``(b, a)`` (`ops.iir.filtfilt_ba`, B2 twice)
  and a 1023-tap FIR (two FFT convolutions) on the whole session;
- **smoothing**: `Signal.plot_spl(window_length_s=0.125)` (the
  one-coefficient EMA, B2) and `helpers.smoothing.time_smoothing` with
  attack and release (the EMA kernel);
- **save and load**: the session, a `Filter`, a `FilterBank` and a
  `Spectrum` through their ``save_*`` methods and
  `standard.load_pkl_object`.

Each step is a function of its inputs; `chip_smoke.py`
(`session_files_phase`) drives them and holds each to its oracle.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.signal as sig

from ..classes import CalibrationData, Filter, FilterBank, Signal, Spectrum
from ..helpers.smoothing import time_smoothing
from ..standard import load_pkl_object

FS = 48000
BLOCK_S = 1.0
CALIBRATOR = (10.0, 1000.0, 94.0)  # seconds, Hz, dB SPL
CALIBRATOR_PEAK = 0.5  # the tone's peak in the file (full scale 1)
STREAM_FILTERS = ((4, 1000.0), (6, 200.0))  # Butterworth lowpass (order, Hz)
FIR_TAPS = 1023
FIR_CUTOFF_HZ = 2000.0
SPL_WINDOW_S = 0.125
ATTACK_RELEASE_S = (0.005, 0.2)


def session(channels: int = 16, seconds: float = 60.0) -> Signal:
    """Config 2's session, scaled to a peak of 0.5 so that it fits a
    24-bit file, on the default device."""
    from .speech_chain import signal

    s = signal(channels, seconds)
    s.time_data = s.time_data * (0.5 / float(s.time_data.abs().max()))
    return s


def write_session(s: Signal, directory: str) -> dict:
    """The session as a 24-bit WAV and as two 24-bit 8-channel FLACs;
    returns their paths ``{"wav": path, "flac": [path, path]}``."""
    wav = os.path.join(directory, "session.wav")
    s.save_signal(wav, "wav", 24)
    half = (s.number_of_channels + 1) // 2
    flacs = []
    for i, chans in enumerate((range(half), range(half, s.number_of_channels))):
        path = os.path.join(directory, f"session_{i}.flac")
        s.get_channels(list(chans)).save_signal(path, "flac", 24)
        flacs.append(path)
    return {"wav": wav, "flac": flacs}


def load_wav(path: str) -> Signal:
    return Signal(path)


def load_flac(paths: list) -> Signal:
    s = Signal(paths[0])
    for p in paths[1:]:
        s.add_channel(p)
    return s


def write_calibrator(directory: str) -> str:
    """A 1 kHz calibrator tone at ``CALIBRATOR_PEAK`` of full scale, written
    as a 24-bit WAV; returns its path."""
    seconds, hz, _ = CALIBRATOR
    t = np.arange(int(seconds * FS)) / FS
    path = os.path.join(directory, "calibrator.wav")
    Signal(None, CALIBRATOR_PEAK * np.sin(2 * np.pi * hz * t), FS,
           device="cpu").save_signal(path, "wav", 24)
    return path


def calibrate(s: Signal, calibrator_path: str):
    """``(calibrated session, CalibrationData)`` from the calibrator file."""
    cal = CalibrationData(calibrator_path, calibration_spl_db=CALIBRATOR[2])
    return cal.calibrate_signal(s), cal


def stream_coefficients() -> list:
    return [sig.butter(order, hz, fs=FS) for order, hz in STREAM_FILTERS]


def stream(s: Signal, b, a) -> Signal:
    """The session through a stateful ``(b, a)`` filter in blocks of
    ``BLOCK_S``, as a recording is processed while it comes in; the blocks
    joined again on the device."""
    import torch

    filt = Filter.from_ba(b, a, s.sampling_rate_hz)
    n = int(BLOCK_S * s.sampling_rate_hz)
    parts = [filt.filter_signal(s.copy_with_new_time_data(s.time_data[k:k + n]),
                                activate_zi=True).time_data
             for k in range(0, s.length_samples, n)]
    return s.copy_with_new_time_data(torch.cat(parts))


def whole(s: Signal, b, a) -> Signal:
    """The same filter in one call on the whole session."""
    return Filter.from_ba(b, a, s.sampling_rate_hz).filter_signal(s, activate_zi=True)


def fir_coefficients() -> np.ndarray:
    return sig.firwin(FIR_TAPS, FIR_CUTOFF_HZ, fs=FS)


def zero_phase(s: Signal, b, a) -> Signal:
    return Filter.from_ba(b, a, s.sampling_rate_hz).filter_signal(s, zero_phase=True)


def spl_plot(s: Signal):
    """`Signal.plot_spl` with a 0.125 s window: ``(fig, ax)``."""
    return s.plot_spl(window_length_s=SPL_WINDOW_S)


def attack_release(power):
    """Attack/release smoothing of ``power (C, T)`` (the EMA kernel)."""
    return time_smoothing(power, FS, *ATTACK_RELEASE_S)


def save_and_load(objects: dict, directory: str) -> dict:
    """Each of ``objects`` ({name: Signal, Filter, FilterBank or Spectrum})
    through its ``save_*`` method and `standard.load_pkl_object`."""
    savers = {Signal: "save_signal", Filter: "save_filter", FilterBank: "save_filterbank",
              Spectrum: "save_spectrum"}
    out = {}
    for name, obj in objects.items():
        path = os.path.join(directory, f"{name}.pkl")
        method = next(m for cls, m in savers.items() if isinstance(obj, cls))
        if method == "save_signal":
            obj.save_signal(path, "pkl")
        else:
            getattr(obj, method)(path)
        out[name] = load_pkl_object(path)
        os.remove(path)
    return out

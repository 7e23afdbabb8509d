"""CalibrationData: Pascal calibration from a recorded reference tone
(`dsptoolbox_tpu/classes/calibration_data.py`).

The calibrator's RMS comes from its recording on the device (the standard
deviation of each channel, or with ``high_snr=False`` the amplitude
spectrum's 1 kHz bin), in float64; `calibrate_signal` scales the signal's
channels on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._enums import SpectrumMethod, SpectrumScaling
from .multibandsignal import MultiBandSignal
from .signal import DeviceTimeData, Signal


def _as_signal(data) -> Signal:
    if isinstance(data, str):
        return Signal(data, None, None)
    if isinstance(data, tuple):
        assert len(data) == 2, "Tuple must have length 2"
        return Signal(None, data[0], data[1])
    if isinstance(data, Signal):
        return data
    raise TypeError(f"{type(data)} is not a valid type. Use either str, tuple or Signal")


def _scaled(band: Signal, factors: torch.Tensor) -> Signal:
    """A copy of ``band`` in Pascal: each channel times its factor, in
    float64 on the band's device, no amplitude constraint."""
    f = factors.to(band.device)[:, None]
    im = band._x_imag
    data = DeviceTimeData((band._x.to(f.dtype) * f).T,
                          None if im is None else (im.to(f.dtype) * f).T)
    constrain = band.constrain_amplitude
    band.constrain_amplitude = False  # the copy takes the flag with the data
    try:
        new = band.copy_with_new_time_data(data)
    finally:
        band.constrain_amplitude = constrain
    new.calibrated_signal = True
    return new


class CalibrationData:
    """Per-channel Pascal calibration factors from a recorded 1 kHz tone at
    a known level (94 or 114 dB SPL, IEC 60942)."""

    def __init__(self, calibration_data, calibration_spl_db: float = 94, high_snr: bool = True):
        """``calibration_data``: a path to a WAV or FLAC file, a ``(time
        data, sampling rate)`` tuple or a `Signal`."""
        self.calibration_signal = _as_signal(calibration_data)
        self.calibration_spl_db = calibration_spl_db
        self.high_snr = high_snr
        self.__update = True

    def add_calibration_channel(self, new_channel, allow_padding_trimming: bool = False
                                ) -> "CalibrationData":
        """Append a calibration channel (path, ``(data, fs)`` tuple or
        `Signal`)."""
        new_channel = _as_signal(new_channel)
        self.calibration_signal = self.calibration_signal.copy().add_channel(
            None, new_channel.time_data, new_channel.sampling_rate_hz,
            allow_padding_trimming=allow_padding_trimming,
        )
        self.__update = True
        return self

    def _compute_calibration_factors(self):
        if self.__update:
            if self.high_snr:
                rms_channels = self.calibration_signal._x.to(torch.float64).std(
                    dim=-1, correction=0)
            else:
                rms_channels = self._get_rms_from_spectrum()
            p_analytical = 10 ** (self.calibration_spl_db / 20) * 20e-6
            self.calibration_factors = (p_analytical / rms_channels).cpu().numpy()
            self.__update = False

    def _get_rms_from_spectrum(self) -> torch.Tensor:
        self.calibration_signal.set_spectrum_parameters(
            method=SpectrumMethod.FFT, scaling=SpectrumScaling.AmplitudeSpectrum)
        f, sp = self.calibration_signal.get_spectrum(return_device=True)
        ind1k = int(np.argmin(np.abs(f - 1e3)))
        return sp[ind1k, :].abs().to(torch.float64)

    def calibrate_signal(self, signal, force_update: bool = False):
        """A copy of ``signal`` (`Signal` or `MultiBandSignal`) in Pascal
        (`classes/calibration_data.py:103`)."""
        if force_update:
            self.__update = True
        self._compute_calibration_factors()
        if len(self.calibration_factors) > 1:
            assert signal.number_of_channels == len(self.calibration_factors), (
                "Number of channels does not match"
            )
            factors = self.calibration_factors
        else:
            factors = np.ones(signal.number_of_channels) * self.calibration_factors
        factors = torch.as_tensor(factors, dtype=torch.float64)
        if isinstance(signal, Signal):
            return _scaled(signal, factors)
        if isinstance(signal, MultiBandSignal):
            calibrated = signal.copy()
            calibrated.bands = [_scaled(b, factors) for b in calibrated.bands]
            return calibrated
        raise TypeError("signal has not a valid type. Use Signal or MultiBandSignal")

"""ImpulseResponse: a `Signal` whose spectrum is the FFT and which may
carry the time window that produced it
(`dsptoolbox_tpu/classes/impulse_response.py`). Its plots overlay the
window.
"""

from __future__ import annotations

import numpy as np
import torch

from .._enums import MagnitudeNormalization, SpectrumMethod
from .signal import Signal


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class ImpulseResponse(Signal):
    """IR container: spectrum method forced to FFT
    (`classes/impulse_response.py:22-67`)."""

    def __init__(
        self,
        path: str | None = None,
        time_data=None,
        sampling_rate_hz: int | None = None,
        constrain_amplitude: bool = True,
        activate_cache: bool = False,
        device=None,
    ):
        super().__init__(
            path,
            time_data,
            sampling_rate_hz,
            constrain_amplitude=constrain_amplitude,
            activate_cache=activate_cache,
            device=device,
        )
        self.spectrum_method = SpectrumMethod.FFT

    @staticmethod
    def from_signal(signal: Signal) -> "ImpulseResponse":
        """An IR of ``signal``'s data on its device (the imaginary part
        too, for a complex signal)."""
        td = signal.time_data
        if signal.is_complex_signal:
            td = torch.complex(td, signal.time_data_imaginary)
        return ImpulseResponse(
            None, td, signal.sampling_rate_hz, signal.constrain_amplitude
        )

    @staticmethod
    def from_file(path: str) -> "ImpulseResponse":
        return ImpulseResponse(path)

    @staticmethod
    def from_time_data(
        time_data,
        sampling_rate_hz: int,
        constrain_amplitude: bool = True,
    ) -> "ImpulseResponse":
        return ImpulseResponse.from_signal(
            Signal.from_time_data(
                time_data, sampling_rate_hz, constrain_amplitude
            )
        )

    def set_window(self, window) -> "ImpulseResponse":
        """Attach the time window ``(T, C)`` (numpy or tensor) used to
        produce this IR (`classes/impulse_response.py:139-152`)."""
        assert tuple(window.shape) == tuple(self.time_data.shape), (
            f"{tuple(window.shape)} does not match shape "
            f"{tuple(self.time_data.shape)}"
        )
        self.window = window
        return self

    def plot_time(self):
        """Waveforms, with the window (scaled to each channel's peak) when
        the IR carries one."""
        fig, ax = super().plot_time()
        if hasattr(self, "window"):
            mx = self.time_data.abs().amax(dim=0).cpu().numpy()
            window = _host(self.window)
            for n in range(self.number_of_channels):
                ax[n].plot(self.time_vector_s, window[:, n] * mx[n], alpha=0.75)
        return fig, ax

    def plot_spl(self, normalize_at_peak: bool = False,
                 dynamic_range_db: float | None = 100.0, window_length_s: float = 0.0):
        """`Signal.plot_spl` with the window in dB over each channel."""
        from ..helpers.gain_and_level import to_db

        fig, ax = super().plot_spl(normalize_at_peak, dynamic_range_db, window_length_s)
        peak_values = to_db(self.time_data.abs().amax(dim=0).cpu().numpy(), True)
        max_values = peak_values + 1 if not normalize_at_peak else np.ones(self.number_of_channels)
        if hasattr(self, "window"):
            window = _host(self.window)
            for n in range(self.number_of_channels):
                ax[n].plot(self.time_vector_s,
                           to_db(window[:, n] / 1.1, True, dynamic_range_db=500) + max_values[n],
                           alpha=0.75)
        return fig, ax

    def plot_bode(self, range_hz=[20, 20e3],
                  normalize: MagnitudeNormalization = MagnitudeNormalization.NoNormalization,
                  range_db=None, show_group_delay: bool = False, range_rad_s=None,
                  smoothing: int = 0, remove_ir_latency=None):
        """Magnitude with phase (or group delay) on a second axis
        (`classes/impulse_response.py:122`)."""
        from ..helpers.gain_and_level import to_db
        from ..helpers.spectrum_utilities import get_exact_gain_1khz
        from ..plots import general_plot_two_axes
        from ..standard.backend import group_delay_direct

        prior = self.spectrum_smoothing
        self.spectrum_smoothing = smoothing
        try:
            f, sp = self.get_spectrum(return_device=True)
        finally:
            self.spectrum_smoothing = prior
        sp = sp.cpu().numpy()
        sp_abs = np.abs(sp)
        if normalize == MagnitudeNormalization.OneKhz:
            sp_abs = sp_abs / np.asarray(get_exact_gain_1khz(f, sp_abs))[None]
        elif normalize == MagnitudeNormalization.OneKhzFirstChannel:
            sp_abs = sp_abs / float(get_exact_gain_1khz(f, sp_abs[:, 0]))
        elif normalize == MagnitudeNormalization.Max:
            sp_abs = sp_abs / np.max(sp_abs, axis=0, keepdims=True)
        elif normalize == MagnitudeNormalization.MaxFirstChannel:
            sp_abs = sp_abs / np.max(sp_abs[:, 0], axis=0)
        elif normalize == MagnitudeNormalization.Energy:
            sp_abs = sp_abs / np.mean(sp_abs**2.0, axis=0, keepdims=True) ** 0.5
        elif normalize == MagnitudeNormalization.EnergyFirstChannel:
            sp_abs = sp_abs / np.mean(sp_abs[:, 0] ** 2.0, axis=0) ** 0.5
        elif normalize != MagnitudeNormalization.NoNormalization:
            raise ValueError("No valid normalization value")
        phase = np.angle(sp)
        if remove_ir_latency is not None:
            phase = self._phase_without_latency(f, phase, remove_ir_latency)
        fig, ax = general_plot_two_axes(
            f, to_db(sp_abs, True), f,
            (group_delay_direct(torch.as_tensor(phase), f[1] - f[0]).numpy()
             if show_group_delay else phase),
            range_x=range_hz, range_y1=range_db, range_y2=range_rad_s, log_x=True,
            labels1=[f"Channel {n}" for n in range(self.number_of_channels)],
            y1label="Magnitude / dB",
            y2label="Group Delay / s" if show_group_delay else "Phase / rad",
            y2_linestyle="dashed", y2_alpha=0.6,
        )
        ax[-1].grid(linestyle="dashed")
        return fig, ax

    def copy_with_new_time_data(self, new_time_data) -> "ImpulseResponse":
        """An IR with this one's settings and new time data
        (`classes/impulse_response.py:218-236`); numpy data goes to this
        IR's device. The window is not carried over."""
        new_signal = ImpulseResponse(
            None, new_time_data, self.sampling_rate_hz,
            self.constrain_amplitude, device=self.device,
        )
        new_signal.activate_cache = self.activate_cache
        new_signal.calibrated_signal = self.calibrated_signal
        new_signal._spectrum_parameters = dict(self._spectrum_parameters)
        new_signal.spectrum_method = SpectrumMethod.FFT
        return new_signal

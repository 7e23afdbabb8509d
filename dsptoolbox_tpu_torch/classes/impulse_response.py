"""ImpulseResponse: a `Signal` whose spectrum is the FFT and which may
carry the time window that produced it
(`dsptoolbox_tpu/classes/impulse_response.py`). Plots are not ported.
"""

from __future__ import annotations

import torch

from ..standard.enums import SpectrumMethod
from .signal import Signal


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

    def copy_with_new_time_data(self, new_time_data) -> "ImpulseResponse":
        """An IR with this one's settings and new time data
        (`classes/impulse_response.py:218-236`); numpy data goes to this
        IR's device. The window is not carried over."""
        new_signal = ImpulseResponse(
            None, new_time_data, self.sampling_rate_hz,
            self.constrain_amplitude, device=self.device,
        )
        new_signal.activate_cache = self.activate_cache
        new_signal._spectrum_parameters = dict(self._spectrum_parameters)
        new_signal.spectrum_method = SpectrumMethod.FFT
        return new_signal

"""FIR design from a target group delay, and phase linearization
(`dsptoolbox_tpu/realtime/designers.py`): integrate the target group delay
into a phase and take its inverse FFT. The scipy interpolation and
integration and the float64 inverse FFT stay on the host; the phase
correction and the trim run in torch on the default device, in the default
float dtype, as the JAX package runs them on its device.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch
from scipy.integrate import cumulative_simpson, cumulative_trapezoid
from scipy.interpolate import PchipInterpolator

from .._config import default_device, default_float
from ..helpers.spectrum_utilities import correct_for_real_phase_spectrum
from ..ops.pad_trim import pad_trim_axis


def _on_device(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(x, dtype=default_float(), device=default_device())


class FirDesigner:
    """FIR with desired magnitude and group delay response."""

    def __init__(
        self,
        target_magnitude_response: np.ndarray,
        target_group_delay_s: np.ndarray,
        time_data_length_samples: int,
        sampling_rate_hz: int,
    ):
        self.time_data_length_samples = time_data_length_samples
        self.sampling_rate_hz = sampling_rate_hz
        self._set_targets(target_magnitude_response, target_group_delay_s)
        self.set_parameters()

    def set_parameters(
        self,
        delay_increase_ms: float = 0.0,
        additional_length_samples: int | None = 0,
        trapezoidal_integration: bool = True,
        ensure_integer_delay: bool = False,
    ):
        assert delay_increase_ms >= 0, (
            "Delay increase must be larger than zero"
        )
        if additional_length_samples is not None:
            assert additional_length_samples >= 0, (
                "Additional length must be 0 or greater"
            )
        self.group_delay_increase_ms = delay_increase_ms
        self.trapezoidal_integration = trapezoidal_integration
        self.additional_length_samples = additional_length_samples
        self.ensure_integer_delay = ensure_integer_delay
        return self

    def _set_targets(
        self,
        target_magnitude_response: np.ndarray,
        target_group_delay_s: np.ndarray,
    ):
        assert target_group_delay_s.ndim == 1, (
            "Target group delay can only have 1 dimension"
        )
        assert self.time_data_length_samples // 2 + 1 == len(
            target_group_delay_s
        ), (
            f"Target group delay with length {len(target_group_delay_s)} "
            f"and length {self.time_data_length_samples} do not match."
        )
        assert len(target_group_delay_s) == len(
            target_magnitude_response
        ), "Lengths do not match"
        self.target_magnitude_response = target_magnitude_response
        self.target_group_delay_s = target_group_delay_s

    def _get_unscaled_preprocessed_group_delay(self) -> np.ndarray:
        return (
            self.target_group_delay_s + self.group_delay_increase_ms / 1e3
        ) / self._get_group_delay_factor_in_seconds()

    def _get_group_delay_factor_in_samples(self) -> float:
        return self.time_data_length_samples / 2 / np.pi

    def _get_group_delay_factor_in_seconds(self) -> float:
        return (
            self.time_data_length_samples / 2 / np.pi / self.sampling_rate_hz
        )

    def get_filter(self):
        from ..classes.filter import Filter

        return Filter.from_ba(self._design(), [1], self.sampling_rate_hz)

    def get_filter_as_ir(self):
        from ..classes.impulse_response import ImpulseResponse

        return ImpulseResponse(None, self._design(), self.sampling_rate_hz)

    def _design(self) -> np.ndarray:
        """Integrated-phase synthesis (`dsptoolbox_tpu/realtime/designers.py:
        99`) → the FIR taps as a host array."""
        target_gd = self._get_unscaled_preprocessed_group_delay()
        target_magnitude = self.target_magnitude_response
        max_delay_samples = int(
            np.max(target_gd) * self._get_group_delay_factor_in_samples() + 1
        )
        gd_len = self.time_data_length_samples
        if max_delay_samples * 10 > gd_len:
            warn(
                f"Phase response (length {gd_len}) is not much longer than "
                f"maximum expected group delay {max_delay_samples} (less "
                "than 10 times longer). Spectrum interpolation is "
                "triggered, but it is recommended to pass a phase spectrum "
                "with finer resolution!"
            )
            new_len = int(max_delay_samples * 10) + 1
            new_len += new_len % 2
            new_freqs = np.fft.rfftfreq(new_len, 1 / self.sampling_rate_hz)
            freqs = np.fft.rfftfreq(
                self.time_data_length_samples, 1 / self.sampling_rate_hz
            )
            target_gd = PchipInterpolator(
                freqs, target_gd, extrapolate=True
            )(new_freqs) * (gd_len / new_len)
            target_magnitude = (
                PchipInterpolator(
                    freqs, target_magnitude**2.0, extrapolate=True
                )(new_freqs)
                ** 0.5
            )
            gd_len = new_len

        new_phase = (
            -cumulative_trapezoid(target_gd, initial=0)
            if self.trapezoidal_integration
            else -cumulative_simpson(target_gd, initial=0)
        )
        add_extra_sample = False
        if gd_len % 2 == 0 and self.ensure_integer_delay:
            add_extra_sample = new_phase[-1] % np.pi > np.pi / 2.0
            new_phase = correct_for_real_phase_spectrum(_on_device(new_phase)).cpu().numpy()
        ir = np.fft.irfft(
            target_magnitude * np.exp(1j * new_phase), gd_len
        )
        if self.additional_length_samples is not None:
            trim_length = int(
                max_delay_samples
                + 1
                + add_extra_sample
                + self.additional_length_samples
            )
            ir = pad_trim_axis(_on_device(ir), trim_length, axis=-1).cpu().numpy()
        return ir


class GroupDelayDesigner(FirDesigner):
    """FIR with desired group delay (flat magnitude)."""

    def __init__(
        self,
        target_group_delay_s: np.ndarray,
        time_data_length_samples: int,
        sampling_rate_hz: int,
    ):
        super().__init__(
            np.ones_like(target_group_delay_s),
            target_group_delay_s,
            time_data_length_samples,
            sampling_rate_hz,
        )


class PhaseLinearizer(GroupDelayDesigner):
    """FIR that linearizes a known phase response."""

    def __init__(
        self,
        phase_response: np.ndarray,
        time_data_length_samples: int,
        sampling_rate_hz: int,
    ):
        self.phase_response = phase_response
        self.set_parameters()
        self.time_data_length_samples = time_data_length_samples
        self.sampling_rate_hz = sampling_rate_hz
        target_group_delay_s = (
            self._get_target_group_delay_in_seconds_from_phase()
        )
        self._set_targets(
            np.ones_like(target_group_delay_s), target_group_delay_s
        )

    def set_parameters(
        self,
        delay_increase_percent: float = 100.0,
        additional_length_samples: int | None = 0,
        trapezoidal_integration: bool = True,
        ensure_integer_delay: bool = False,
    ):
        assert delay_increase_percent >= 0, (
            "Delay increase must be larger than zero"
        )
        self.group_delay_increase_factor = 1 + delay_increase_percent / 100
        return super().set_parameters(
            0.0,
            additional_length_samples,
            trapezoidal_integration,
            ensure_integer_delay=ensure_integer_delay,
        )

    def __get_group_delay(self, phase_response) -> np.ndarray:
        return -np.gradient(np.unwrap(phase_response))

    def _get_target_group_delay_in_seconds_from_phase(self) -> np.ndarray:
        gd = self.__get_group_delay(self.phase_response)
        target_gd = np.max(gd) * self.group_delay_increase_factor - gd
        return target_gd * self._get_group_delay_factor_in_seconds()

    def _get_unscaled_preprocessed_group_delay(self) -> np.ndarray:
        return (
            self._get_target_group_delay_in_seconds_from_phase()
            / self._get_group_delay_factor_in_seconds()
        )

"""Kautz filter: orthonormal pole basis with a least-squares fit
(`dsptoolbox_tpu/realtime/kautz.py`).

Whole-signal filtering chains `ops.iir.lfilter` over the order-1 and
order-2 sections on the signal's device (B2 on a float32 CUDA tensor: two
launches a real pole, three a complex pair), the taps weighted and summed
there in float64; the pole search stays on the host in scipy float64, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.linalg import lstsq

from ..ops.iir import lfilter
from .base import RealtimeFilter, host_array
from .iir_fir import IIRFilter


def _lfilter_time(b, a, x: torch.Tensor) -> torch.Tensor:
    """Zero-state `ops.iir.lfilter` of ``x (C, T)`` along time."""
    return lfilter(np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64), x)[0]


class KautzFilter(RealtimeFilter):
    """Kautz orthonormal filter for real-valued signals
    (`dsptoolbox_tpu/realtime/kautz.py:31`)."""

    def __init__(self, poles: np.ndarray, sampling_rate_hz: int):
        poles = np.asarray(poles)
        assert not np.any(poles.imag < 0.0), (
            "No poles with negative imaginary part should be passed"
        )
        assert not np.any(np.abs(poles) >= 1.0), "No poles should lie outside the unit circle"
        self.sampling_rate_hz = sampling_rate_hz
        self.__set_poles(poles)
        self.set_filter_coefficients(np.ones(self.n_real_poles), np.ones(self.n_complex_poles))
        self.set_n_channels(1)

    @staticmethod
    def from_ir(ir, order: int, iterations: int) -> "KautzFilter":
        f = KautzFilter(np.ones(2) * 0.5, ir.sampling_rate_hz)
        f.fit_poles_and_coefficients_to_ir(ir, order, iterations)
        return f

    def __set_poles(self, poles: np.ndarray):
        real_indices = poles.imag == 0.0
        self.poles_real = np.real(poles[real_indices])
        self.poles_complex = poles[~real_indices]
        self.n_complex_poles = len(self.poles_complex) * 2
        self.n_real_poles = len(self.poles_real)
        self.total_n_poles = self.n_complex_poles + self.n_real_poles
        self.__compute_filters()

    def set_filter_coefficients(self, c_real, c_complex):
        assert self.n_complex_poles == len(c_complex)
        assert self.n_real_poles == len(c_real)
        self.coefficients_real_poles = np.asarray(c_real, dtype=np.float64)
        self.coefficients_complex_poles = np.asarray(c_complex, dtype=np.float64)
        return self

    def __compute_filters(self):
        self._filters_real: list[IIRFilter] = []
        self._filters_real_adv: list[IIRFilter] = []
        self._filters_complex: list[IIRFilter] = []
        self._filters_complex_adv: list[IIRFilter] = []
        for preal in self.poles_real:
            self._filters_real.append(IIRFilter(b=np.array([(1.0 - preal**2.0) ** 0.5]),
                                                a=np.array([1.0, -preal])))
            self._filters_real_adv.append(IIRFilter(b=np.array([-preal, 1.0]),
                                                    a=np.array([1.0, -preal])))
        q = -2.0 * np.real(self.poles_complex)
        r = np.abs(self.poles_complex) ** 2.0
        for ii in range(len(self.poles_complex)):
            a = np.array([1.0, q[ii], r[ii]])
            self._filters_complex.append(IIRFilter(
                b=np.array([1.0, -1.0]) * ((1.0 - r[ii]) * (1.0 + r[ii] - q[ii]) / 2.0) ** 0.5,
                a=a))
            self._filters_complex.append(IIRFilter(
                b=np.array([1.0, 1.0]) * ((1.0 - r[ii]) * (1.0 + r[ii] + q[ii]) / 2.0) ** 0.5,
                a=a))
            self._filters_complex_adv.append(IIRFilter(b=np.array([r[ii], q[ii], 1.0]), a=a))

    def _all_filters(self) -> list:
        return (self._filters_real + self._filters_complex + self._filters_real_adv
                + self._filters_complex_adv)

    def set_n_channels(self, n_channels: int):
        for f in self._all_filters():
            f.set_n_channels(n_channels)

    def reset_state(self):
        for f in self._all_filters():
            f.reset_state()

    def process_sample(self, x: float, channel: int):
        y = 0.0
        for ind, f in enumerate(self._filters_real):
            y += f.process_sample(x, channel) * self.coefficients_real_poles[ind]
            x = self._filters_real_adv[ind].process_sample(x, channel)
        for ind in range(0, len(self._filters_complex), 2):
            x1 = self._filters_complex[ind].process_sample(x, channel)
            x2 = self._filters_complex[ind + 1].process_sample(x, channel)
            y += (x1 * self.coefficients_complex_poles[ind]
                  + x2 * self.coefficients_complex_poles[ind + 1])
            x = self._filters_complex_adv[ind // 2].process_sample(x, channel)
        return y

    def _process_time_data_vector(self, x: torch.Tensor,
                                  compute_tap_out_matrix: bool = False) -> torch.Tensor:
        """The chain of zero-state sections over ``x (C, T)`` on its device
        (`dsptoolbox_tpu/realtime/kautz.py:150`): the summed output ``(C,
        T)``, or every weighted tap ``(C, poles, T)``, in float64."""
        C, T = x.shape
        f64 = torch.float64
        taps = [] if compute_tap_out_matrix else None
        output = None if compute_tap_out_matrix else x.new_zeros((C, T), dtype=f64)

        def add(tap, weight):
            nonlocal output
            tap = tap.to(f64) * weight
            if taps is not None:
                taps.append(tap)
            else:
                output += tap

        td = x
        for ii, preal in enumerate(self.poles_real):
            add(_lfilter_time([1], [1, -preal], td),
                (1.0 - preal**2.0) ** 0.5 * self.coefficients_real_poles[ii])
            td = _lfilter_time([-preal, 1], [1, -preal], td)
        q = -2.0 * np.real(self.poles_complex)
        r = np.abs(self.poles_complex) ** 2.0
        ind_tapout = 0
        for ii in range(len(self.poles_complex)):
            add(_lfilter_time([1, -1], [1, q[ii], r[ii]], td),
                ((1 - r[ii]) * (1 + r[ii] - q[ii]) / 2) ** 0.5
                * self.coefficients_complex_poles[ind_tapout])
            ind_tapout += 1
            add(_lfilter_time([1, 1], [1, q[ii], r[ii]], td),
                ((1 - r[ii]) * (1 + r[ii] + q[ii]) / 2) ** 0.5
                * self.coefficients_complex_poles[ind_tapout])
            ind_tapout += 1
            td = _lfilter_time([r[ii], q[ii], 1], [1, q[ii], r[ii]], td)
        return torch.stack(taps, dim=1) if taps is not None else output

    def fit_coefficients_to_ir(self, ir):
        """LS-optimal coefficients from the tap-out matrix of the reversed IR
        (`dsptoolbox_tpu/realtime/kautz.py:199`): its last sample per tap,
        fetched to the host."""
        assert ir.number_of_channels == 1, "Only a single-channel IR is supported"
        self.set_filter_coefficients(np.ones(self.n_real_poles), np.ones(self.n_complex_poles))
        taps = self._process_time_data_vector(ir._x.flip(-1), True)  # (1, poles, T)
        coefficients = taps[0, :, -1].cpu().numpy()
        self.set_filter_coefficients(coefficients[: self.n_real_poles],
                                     coefficients[self.n_real_poles:])
        self.sampling_rate_hz = ir.sampling_rate_hz
        return self

    def filter_signal(self, signal):
        """The signal through the filter on its device."""
        assert signal.sampling_rate_hz == self.sampling_rate_hz, "Sampling rates do not match"
        y = self._process_time_data_vector(signal._x, False)
        return signal.copy_with_new_time_data(y.to(signal._x.dtype).T)

    def get_ir(self, length_samples: int):
        from ..generators import dirac

        d = dirac(length_samples, delay_samples=0, sampling_rate_hz=self.sampling_rate_hz)
        return self.filter_signal(d)

    def fit_poles_and_coefficients_to_ir(self, ir, order: int, iterations: int):
        """Brandenstein-Unbehauen optimal pole search (host scipy float64)
        and coefficient fit (`dsptoolbox_tpu/realtime/kautz.py:225`)."""
        assert ir.number_of_channels == 1, "Only a single-channel IR is supported"
        poles = KautzFilter.__find_optimal_poles_for_ir(
            order, iterations, host_array(ir.time_data).squeeze().copy())
        self.__set_poles(poles)
        self.fit_coefficients_to_ir(ir)
        return self

    @staticmethod
    def __find_optimal_poles_for_ir(order: int, iterations: int,
                                    target_response: np.ndarray) -> np.ndarray:
        from scipy.signal import lfilter as slfilter

        assert target_response.ndim == 1, "This is only valid for 1D time series"
        response_length = len(target_response)
        target_response = target_response[::-1]
        matrix_a = np.zeros((response_length, order))
        poly = np.array([1.0] + [0.0] * order)
        coeff_matrix = np.zeros((iterations, order + 1))
        error_array = np.zeros(iterations)
        for i in range(iterations):
            filtered = slfilter([1.0], poly, target_response)
            vector_b = np.hstack([np.zeros(order), -filtered[:-order]])
            matrix_a.fill(0.0)
            matrix_a[:, 0] = filtered
            for k in range(1, order):
                matrix_a[k:, k] = filtered[:-k]
            ls = lstsq(matrix_a, vector_b)[0]
            poly = np.hstack([[1.0], ls[::-1]])
            inverse_poly = poly[::-1]
            allpass_filtered = slfilter(inverse_poly, poly, target_response)
            coeff_matrix[i, :] = poly
            error_array[i] = np.sum(allpass_filtered**2)
        inds = ~np.isnan(error_array)
        min_err = np.argmin(error_array[inds])
        poles = np.roots(coeff_matrix[inds, :][min_err, :])
        return poles[poles.imag >= 0.0]

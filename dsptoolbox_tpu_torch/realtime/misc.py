"""Misc streaming filters (`dsptoolbox_tpu/realtime/misc.py`): exponential
averager, filter chain, TPT state-variable filter, state-space filter,
lattice/ladder, warped FIR/IIR.

Device forms: `ExponentialAverageFilter.process_block` runs the average
form of `csrc/ema.cu` from the channel's state (`ops.cuda_ema.ema_average`, one
launch a block); `StateVariableFilter.filter_signal` runs its linear
two-state recursion through `ops.iir.linear_recurrence` in float64 on the
signal's device; `WarpedFIR.filter_signal` runs the JAX package's scan as
the cascade of first-order allpasses it is, each stage through
`ops.iir.lfilter` (B2 on a float32 CUDA tensor). The lattice/ladder and the
warped IIR filter sample by sample on the host, as the JAX package does.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from .._enums import FilterCoefficientsType
from ..helpers.smoothing import get_smoothing_factor_ema
from ..ops.cuda_ema import ema_average
from ..ops.iir import lfilter, linear_recurrence
from .base import DeviceState, RealtimeFilter, as_block, host_array


class ExponentialAverageFilter(DeviceState, RealtimeFilter):
    """One-pole attack/release smoother
    (`dsptoolbox_tpu/realtime/misc.py:25`)."""

    def __init__(
        self,
        increase_time_s: float,
        decrease_time_s: float,
        sampling_rate_hz: int,
        accuracy_step_response: float = 0.95,
    ):
        self.sampling_rate_hz = sampling_rate_hz
        self.increase_coefficient = get_smoothing_factor_ema(
            increase_time_s, sampling_rate_hz, accuracy_step_response
        )
        self.decrease_coefficient = get_smoothing_factor_ema(
            decrease_time_s, sampling_rate_hz, accuracy_step_response
        )
        self.set_n_channels(1)

    def set_n_channels(self, n_channels: int):
        self._init_state((1, n_channels))

    def reset_state(self):
        self._zero_state()

    def process_sample(self, x: float, channel: int):
        state = self.state
        prev = state[0, channel]
        coeff = self.increase_coefficient if x > prev else self.decrease_coefficient
        y = x * coeff + (1 - coeff) * prev
        state[0, channel] = y
        return y

    def process_block(self, block, channel: int):
        """One block ``(T,)`` from the channel's state: `csrc/ema.cu`'s
        average form on a CUDA tensor (one launch), its plain loop on a CPU
        one; the state stays on the block's device."""
        x = as_block(block)
        s = self.device_state(x.device)
        y = ema_average(x[None], s[0, channel:channel + 1], self.increase_coefficient,
                        self.decrease_coefficient)[0]
        s[0, channel] = y[-1]
        return y


class FilterChain(RealtimeFilter):
    """Sequential composition of realtime filters
    (`dsptoolbox_tpu/realtime/misc.py:80`)."""

    def __init__(self, filters: list):
        self.filters = filters

    @property
    def n_filters(self):
        return len(self.filters)

    def set_n_channels(self, n_channels: int):
        for f in self.filters:
            f.set_n_channels(n_channels)

    def reset_state(self):
        for f in self.filters:
            f.reset_state()

    def process_sample(self, x: float, channel: int):
        for f in self.filters:
            x = f.process_sample(x, channel)
        return x


class StateVariableFilter(DeviceState, RealtimeFilter):
    """Zavalishin topology-preserving-transform SVF with four outputs (LP,
    HP, BP, AP) (`dsptoolbox_tpu/realtime/misc.py:105`)."""

    def __init__(self, frequency_hz: float, resonance: float, sampling_rate_hz: int):
        self.sampling_rate_hz = sampling_rate_hz
        self.set_parameters(frequency_hz, resonance, 1)

    def set_parameters(self, frequency_hz: float, resonance: float, n_channels: int):
        assert 0 < frequency_hz < self.sampling_rate_hz // 2
        self.g = np.tan(np.pi * frequency_hz / self.sampling_rate_hz)
        self.resonance = resonance
        self.intermediate_value = 1 / (1 + self.resonance * self.g + self.g**2)
        self.set_n_channels(n_channels)
        return self

    def set_n_channels(self, n_channels: int):
        assert n_channels > 0
        self.n_channels = n_channels
        self._init_state((2, n_channels))

    def reset_state(self):
        self._zero_state()

    def process_sample(self, sample: float, channel: int = 0):
        state = self.state
        yh = (
            sample - (self.resonance + self.g) * state[0, channel] - state[1, channel]
        ) * self.intermediate_value
        yb = self.g * yh + state[0, channel]
        state[0, channel] = self.g * yh + yb
        yl = self.g * yb + state[1, channel]
        state[1, channel] = self.g * yb + yl
        return yl, yh, yb, yl - self.resonance * yb + yh

    def _system(self):
        """``(A (2, 2), B (2,))`` of the linear recursion ``s[n] = A s[n-1]
        + B x[n]`` that `process_sample` walks (host float64)."""
        g, r, iv = self.g, self.resonance, self.intermediate_value
        k = 1 - g * iv * (r + g)  # ∂yb/∂s0
        A = np.array([[1 - 2 * g * iv * (r + g), -2 * g * iv],
                      [2 * g * k, 1 - 2 * g * g * iv]])
        return A, np.array([2 * g * iv, 2 * g * g * iv])

    def _process_device(self, x: torch.Tensor) -> torch.Tensor:
        """All channels of ``x (C, T)`` on its device: the states by
        `linear_recurrence` in float64 from ``state``, the four outputs
        formed from ``s[n-1]`` and ``x[n]`` in float64 and cast once →
        ``(4, C, T)``; the final state goes back to ``state``."""
        g, res, iv = self.g, self.resonance, self.intermediate_value
        A, B = self._system()
        s0 = self.device_state(x.device).T  # (C, 2)
        xt = x.T.to(torch.float64)  # (T, C)
        s = linear_recurrence(A, xt[..., None] * torch.as_tensor(B, device=x.device), s0)
        prev = torch.cat([s0[None], s[:-1]], dim=0)  # s[n-1]: (T, C, 2)
        del s0
        self._dev_state = s[-1].T.clone()
        del s
        yh = (xt - (res + g) * prev[..., 0] - prev[..., 1]) * iv
        yb = g * yh + prev[..., 0]
        yl = g * yb + prev[..., 1]
        del prev
        ya = yl - res * yb + yh
        return torch.stack([v.T.to(x.dtype) for v in (yl, yh, yb, ya)])

    def _process_host_f64(self, x: np.ndarray) -> np.ndarray:
        """`process_sample`'s recursion on the host in float64, vectorised
        over the channels of ``x (C, T)`` → ``(4, C, T)``: the float64 mode's
        route, bit for bit `process_sample`
        (`dsptoolbox_tpu/realtime/misc.py:173-196`)."""
        g, res, iv = self.g, self.resonance, self.intermediate_value
        s = self.state
        out = np.empty((4,) + x.shape, np.float64)
        for t in range(x.shape[1]):
            xt = x[:, t]
            yh = (xt - (res + g) * s[0] - s[1]) * iv
            yb = g * yh + s[0]
            s[0] = g * yh + yb
            yl = g * yb + s[1]
            s[1] = g * yb + yl
            out[0, :, t] = yl
            out[1, :, t] = yh
            out[2, :, t] = yb
            out[3, :, t] = yl - res * yb + yh
        return out

    def filter_signal(self, signal):
        """→ MultiBandSignal with LP/HP/BP/AP bands
        (`dsptoolbox_tpu/realtime/misc.py:198`), on the signal's device; in
        float64 mode on the CPU by the host loop `_process_host_f64`
        (`classes.filter_helpers._oracle_exact_f64`)."""
        from ..classes.filter_helpers import _oracle_exact_f64
        from ..classes.multibandsignal import MultiBandSignal

        if self.n_channels != signal.number_of_channels:
            self.set_n_channels(signal.number_of_channels)
        if _oracle_exact_f64(signal.device):
            out = torch.from_numpy(self._process_host_f64(
                signal._x.cpu().numpy().astype(np.float64))).to(signal.device)
        else:
            out = self._process_device(signal._x)
        bands = [signal.copy_with_new_time_data(out[i].T) for i in range(4)]
        return MultiBandSignal(
            bands,
            same_sampling_rate=True,
            info={"bands": ["lowpass", "highpass", "bandpass", "allpass"]},
        )

    def get_ir(self, length_samples: int):
        """Dirac through the filter → MultiBandSignal with the LP/HP/BP/AP
        band IRs (`dsptoolbox_tpu/realtime/misc.py:222`)."""
        from ..generators import dirac

        d = dirac(length_samples, sampling_rate_hz=self.sampling_rate_hz)
        self.reset_state()
        return self.filter_signal(d)

    def _bands_signal(self, length_samples: int):
        from .._enums import SpectrumMethod

        d = self.get_ir(length_samples).get_all_bands()
        d.spectrum_method = SpectrumMethod.FFT
        return d

    def plot_magnitude(self, length_samples: int, range_hz: list | None = [20, 20e3],
                       range_db: list | None = None):
        """Magnitude response of each band output, unnormalized
        (`dsptoolbox_tpu/realtime/misc.py:240`)."""
        from .._enums import MagnitudeNormalization

        d = self._bands_signal(length_samples)
        fig, ax = d.plot_magnitude(range_hz=range_hz,
                                   normalize=MagnitudeNormalization.NoNormalization,
                                   range_db=range_db, smoothing=0)
        ax.legend(["Lowpass", "Highpass", "Bandpass", "Allpass"])
        return fig, ax

    def plot_group_delay(self, length_samples: int, range_hz: list | None = [20.0, 20e3]):
        """Group delay of each band output (`dsptoolbox_tpu/realtime/misc.py:265`)."""
        d = self._bands_signal(length_samples)
        fig, ax = d.plot_group_delay(range_hz=range_hz)
        ax.legend(["Lowpass", "Highpass", "Bandpass", "Allpass"])
        return fig, ax

    def plot_phase(self, length_samples: int, range_hz: list | None = [20, 20e3],
                   unwrap: bool = False):
        """Phase of each band output (`dsptoolbox_tpu/realtime/misc.py:276`)."""
        d = self._bands_signal(length_samples)
        fig, ax = d.plot_phase(range_hz=range_hz, unwrap=unwrap)
        ax.legend(["Lowpass", "Highpass", "Bandpass", "Allpass"])
        return fig, ax


class StateSpaceFilter(RealtimeFilter):
    """A,B,C,D state-space realization on the host
    (`dsptoolbox_tpu/realtime/misc.py:286`)."""

    def __init__(self, A, B, C, D):
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        assert A.ndim == 2, "Matrix A should have exactly 2 dimensions"
        B = np.asarray(B, dtype=np.float64)
        assert len(B) == A.shape[1], "Matrix B dimensions are not valid"
        self.A = A.squeeze()
        self.B = B.squeeze()
        self.C = np.asarray(C, dtype=np.float64).squeeze()
        self.D = np.asarray(D, dtype=np.float64).squeeze()
        self.set_n_channels(1)

    @staticmethod
    def from_filter(filt) -> "StateSpaceFilter":
        from scipy.signal import tf2ss

        b, a = filt.get_coefficients(FilterCoefficientsType.Ba)
        return StateSpaceFilter(*tf2ss(b, a))

    @staticmethod
    def from_filter_as_sos_list(filt) -> list:
        from scipy.signal import tf2ss

        sos = filt.get_coefficients(FilterCoefficientsType.Sos)
        return [StateSpaceFilter(*tf2ss(sos[n, :3], sos[n, 3:])) for n in range(sos.shape[0])]

    def reset_state(self):
        self.x.fill(0.0)

    def set_n_channels(self, n_channels: int):
        self.x = np.zeros((np.atleast_2d(self.A).shape[0], n_channels))

    def process_sample(self, x: float, channel: int):
        y = self.C @ self.x[:, channel] + self.D * x
        self.x[:, channel] = self.A @ self.x[:, channel] + self.B * x
        return y


# ======== Lattice / Ladder ==================================================
def lattice_ladder_coefficients_iir(b: np.ndarray, a: np.ndarray):
    """ba → reflection k and ladder c coefficients (Oppenheim & Schafer;
    `dsptoolbox_tpu/realtime/misc.py:331`). Host design."""
    N = len(a) - 1
    k = np.zeros(N)
    a_s = np.zeros((N, N))
    k[-1] = -a[-1]
    a_s[-1, :] = -a[1:]
    for i in range(N - 2, -1, -1):
        for m in range(i, -1, -1):
            a_s[i, m] = (a_s[i + 1, m] + k[i + 1] * a_s[i + 1, i - m]) / (1 - k[i + 1] ** 2)
        k[i] = a_s[i, i]
    c = np.zeros(len(b))
    for m in range(len(b) - 1, -1, -1):
        summed = 0
        for i in range(m + 1, len(b)):
            summed += c[i] * a_s[i - 1, i - 1 - m]
        c[m] = b[m] + summed
    return k, c


def lattice_ladder_coefficients_iir_sos(sos: np.ndarray):
    """Per-section closed-form lattice/ladder coefficients
    (`dsptoolbox_tpu/realtime/misc.py:353`)."""
    sos = np.array(sos, dtype=np.float64)
    if not np.all(sos[:, 3] == 1.0):
        sos /= sos[:, 3:4]
    n_sections = sos.shape[0]
    k = np.zeros((n_sections, 2))
    k[:, 1] = -sos[:, -1]
    a12 = -sos[:, -2]
    k[:, 0] = (a12 + k[:, 1] * a12) / (1 - k[:, 1] ** 2)
    c = np.zeros((n_sections, 3))
    c[:, 2] = sos[:, 2]
    c[:, 1] = sos[:, 1] + c[:, 2] * a12
    c[:, 0] = sos[:, 0] + c[:, 1] * k[:, 0] + c[:, 2] * k[:, 1]
    return k, c


def lattice_coefficients_fir(b: np.ndarray):
    """FIR reflection coefficients (`dsptoolbox_tpu/realtime/misc.py:372`)."""
    N = len(b) - 1
    k = np.zeros(N)
    a_s = np.zeros((N, N))
    k[-1] = -b[-1]
    a_s[-1, :] = -b[1:]
    for i in range(N - 2, -1, -1):
        for m in range(i, -1, -1):
            a_s[i, m] = (a_s[i + 1, m] + k[i + 1] * a_s[i + 1, i - m]) / (1 - k[i + 1] ** 2)
        k[i] = a_s[i, i]
    return k


def _host_loop(filt, signal) -> np.ndarray:
    """``filt.process_sample`` over every sample of every channel of the
    signal's data, fetched to the host: ``(T, C)`` in its float dtype."""
    td = host_array(signal.time_data).copy()
    out = np.empty_like(td)
    for ch in range(td.shape[1]):
        for n in range(td.shape[0]):
            out[n, ch] = filt.process_sample(td[n, ch], ch)
    return out


class LatticeLadderFilter(RealtimeFilter):
    """Lattice/ladder topology for FIR/IIR/SOS, sample by sample on the host
    (`dsptoolbox_tpu/realtime/misc.py:387`)."""

    def __init__(self, k_coefficients: np.ndarray, c_coefficients: np.ndarray | None = None,
                 sampling_rate_hz: int | None = None):
        assert sampling_rate_hz is not None, "Sampling rate cannot be None"
        k_coefficients = np.asarray(k_coefficients, dtype=np.float64)
        assert k_coefficients.ndim in (2, 1), "k_coefficients should be a vector or a matrix"
        if k_coefficients.ndim == 2:
            assert c_coefficients is not None, (
                "Second-order sections are only valid for IIR filters. "
                "C coefficients cannot be None"
            )
            assert k_coefficients.shape[1] == 2, (
                "When k has two dimensions, it is assumed that the "
                "second one has length 2 (second-order section)"
            )
            assert c_coefficients.shape[1] == 3, (
                "Second-order sections should have 3 c coefficients"
            )
            assert c_coefficients.shape[0] == k_coefficients.shape[0], (
                "Number of second-order sections do not match"
            )
            self.iir_filter = True
            self.sos_filtering = True
        else:
            self.sos_filtering = False
            if c_coefficients is not None:
                assert len(c_coefficients) == len(k_coefficients) + 1, (
                    "c_coefficients must have the length len(k_coefficients) + 1"
                )
                self.iir_filter = True
            else:
                self.iir_filter = False
        self.k = k_coefficients
        self.c = np.asarray(c_coefficients, dtype=np.float64) if c_coefficients is not None \
            else None
        self.sampling_rate_hz = sampling_rate_hz
        self.set_n_channels(1)

    @staticmethod
    def from_filter(filt) -> "LatticeLadderFilter":
        if filt.is_iir:
            if filt.has_sos:
                sos = filt.get_coefficients(FilterCoefficientsType.Sos)
                k, c = lattice_ladder_coefficients_iir_sos(sos)
                return LatticeLadderFilter(k, c, filt.sampling_rate_hz)
            b, a = filt.get_coefficients(FilterCoefficientsType.Ba)
            k, c = lattice_ladder_coefficients_iir(b, a)
            return LatticeLadderFilter(k, c, filt.sampling_rate_hz)
        b, a = filt.get_coefficients(FilterCoefficientsType.Ba)
        b = b / b[0]
        k = lattice_coefficients_fir(b)
        assert np.all(np.abs(k) < 1), (
            "Some reflection coefficient was equal or larger than zero, this is not supported"
        )
        return LatticeLadderFilter(k, None, filt.sampling_rate_hz)

    def set_n_channels(self, n_channels: int):
        assert n_channels > 0, "At least one channel must be initialized"
        if self.iir_filter and self.sos_filtering:
            self.state = np.zeros((self.k.shape[0], 2, n_channels))
        else:
            self.state = np.zeros((len(self.k), n_channels))
        self.n_channels = n_channels

    def reset_state(self):
        self.state.fill(0.0)

    def process_sample(self, x: float, channel: int):
        if self.iir_filter:
            if self.sos_filtering:
                return self.__sos_sample(x, channel)
            return self.__iir_sample(x, channel)
        return self.__fir_sample(x, channel)

    def __sos_sample(self, x: float, channel: int) -> float:
        for section in range(self.k.shape[0]):
            x_low = 0.0
            x += self.state[section, 1, channel] * self.k[section, 1]
            s = x * -self.k[section, 1] + self.state[section, 1, channel]
            x_low += s * self.c[section, 2]
            x += self.state[section, 0, channel] * self.k[section, 0]
            s = x * -self.k[section, 0] + self.state[section, 0, channel]
            self.state[section, 1, channel] = s
            x_low += s * self.c[section, 1]
            self.state[section, 0, channel] = x
            x = x * self.c[section, 0] + x_low
        return x

    def __iir_sample(self, x: float, channel: int) -> float:
        order_iterations = len(self.k) - 1
        x_low = 0.0
        for i in range(order_iterations, -1, -1):
            x += self.state[i, channel] * self.k[i]
            s = x * -self.k[i] + self.state[i, channel]
            if i + 1 < len(self.k):
                self.state[i + 1, channel] = s
            x_low += s * self.c[i + 1]
        self.state[0, channel] = x
        return x * self.c[0] + x_low

    def __fir_sample(self, x: float, channel: int) -> float:
        x_o = x
        s0 = x
        for i_k in range(len(self.k)):
            s1 = -x_o * self.k[i_k] + self.state[i_k, channel]
            x_o -= self.state[i_k, channel] * self.k[i_k]
            self.state[i_k, channel] = s0
            s0 = s1
        return x_o

    def filter_signal(self, signal):
        """Whole-signal lattice filtering, sample by sample on the host
        (`dsptoolbox_tpu/realtime/misc.py:511`); the result goes back to the
        signal's device."""
        assert signal.sampling_rate_hz == self.sampling_rate_hz, "Sampling rates do not match"
        if self.n_channels != signal.number_of_channels:
            warn(
                "Number of channels did not match the filter's state. The "
                "right number of channels are automatically initiated"
            )
            self.set_n_channels(signal.number_of_channels)
        return signal.copy_with_new_time_data(_host_loop(self, signal))


class WarpedFIR(RealtimeFilter):
    """Frequency-warped FIR via cascaded first-order allpasses
    (`dsptoolbox_tpu/realtime/misc.py:531`)."""

    def __init__(self, b: np.ndarray, warping_factor: float, sampling_rate_hz: int):
        assert abs(warping_factor) < 1.0, "Warping factor must be in range ]-1;1["
        self.sampling_rate_hz = sampling_rate_hz
        self.b = np.asarray(b, dtype=np.float64)
        self.warp = warping_factor
        self.N = len(self.b)
        self.order = len(self.b) - 1
        self.set_n_channels(1)

    @staticmethod
    def from_filter(filt, warping_factor: float) -> "WarpedFIR":
        assert filt.is_fir, "This is only valid for a FIR filter"
        b, _ = filt.get_coefficients(FilterCoefficientsType.Ba)
        return WarpedFIR(b, warping_factor, filt.sampling_rate_hz)

    def set_n_channels(self, n_channels: int):
        assert n_channels > 0
        self.buffer = np.zeros((self.N, n_channels))

    def reset_state(self):
        self.buffer.fill(0.0)

    def process_sample(self, x: float, channel: int) -> float:
        output = x * self.b[0]
        residue = x
        for nn in range(self.order):
            new_residue = (self.buffer[nn + 1, channel] - residue) * self.warp \
                + self.buffer[nn, channel]
            self.buffer[nn, channel] = residue
            residue = new_residue
            if nn + 1 < len(self.b):
                output += new_residue * self.b[nn + 1]
        self.buffer[-1, channel] = residue
        return output

    def filter_signal(self, signal):
        """Whole-signal warped filtering from a zero state
        (`dsptoolbox_tpu/realtime/misc.py:574`) on the signal's device, as
        the allpass cascade of `warped_fir_cascade`; ``buffer`` is left as
        it was."""
        assert self.sampling_rate_hz == signal.sampling_rate_hz, "Sampling rates do not match"
        buffer_prior = self.buffer.copy()
        self.set_n_channels(signal.number_of_channels)
        out = warped_fir_cascade(signal._x, self.b, self.warp)
        self.buffer = buffer_prior
        return signal.copy_with_new_time_data(out.T)


def warped_fir_cascade(x: torch.Tensor, b: np.ndarray, warp: float) -> torch.Tensor:
    """The warped FIR ``Σ_k b_k · stage_k`` of ``x (..., T)`` from a zero
    state: stage 0 is ``x``, stage k+1 is ``lfilter([-λ, 1], [1, -λ])`` of
    stage k (the JAX package's per-sample scan, `dsptoolbox_tpu/realtime/
    misc.py:593-622`, is exactly this chain of first-order allpasses), each
    stage through `ops.iir.lfilter` (B2 on a float32 CUDA tensor: one launch
    a stage), the sum accumulated in float64 on the device and cast once."""
    acc = x.to(torch.float64) * float(b[0])
    stage = x
    for k in range(1, len(b)):
        stage = lfilter(np.array([-warp, 1.0]), np.array([1.0, -warp]), stage)[0]
        acc.add_(stage, alpha=float(b[k]))
    return acc.to(x.dtype)


class WarpedIIR(WarpedFIR):
    """Frequency-warped IIR with sigma recomputation, sample by sample on
    the host (`dsptoolbox_tpu/realtime/misc.py:625`)."""

    def __init__(self, b: np.ndarray, a: np.ndarray, warping_factor: float,
                 sampling_rate_hz: int):
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        assert b.ndim == 1, "Coefficients can only have a single dimension"
        assert a.ndim == 1, "Coefficients can only have a single dimension"
        self.N = max(len(a), len(b))
        self.order = self.N - 1
        self.b = b / a[0]
        self.a = a / a[0]
        self.warp = warping_factor
        self.sampling_rate_hz = sampling_rate_hz
        self.set_n_channels(1)
        self.__compute_sigmas()

    @staticmethod
    def from_filter(filt, warping_factor: float) -> "WarpedIIR":
        assert filt.is_iir, "This is only valid for a IIR filter"
        b, a = filt.get_coefficients(FilterCoefficientsType.Ba)
        return WarpedIIR(b, a, warping_factor, filt.sampling_rate_hz)

    def __compute_sigmas(self):
        """Karjalainen et al. 1997 sigma recursion
        (`dsptoolbox_tpu/realtime/misc.py:660`)."""
        N = len(self.a)
        self.sigmas = np.zeros(N + 1)
        self.sigmas[-1] = self.warp * self.a[-1]
        S = self.a[-1]
        for i in range(N - 1, 1, -1):
            S_new = self.a[i - 1] - self.warp * S
            self.sigmas[i] = self.warp * S_new + S
            S = S_new
        self.sigmas[1] = S
        self.sigmas[0] = 1.0 / (1.0 - self.warp * S)
        self.sigmas[1:] *= -1.0

    def process_sample(self, x: float, channel: int) -> float:
        x += self.sigmas[1:] @ self.buffer[: len(self.sigmas) - 1, channel]
        x *= self.sigmas[0]
        return super().process_sample(x, channel)

    def filter_signal(self, signal):
        """Whole-signal warped IIR filtering from a zero state, sample by
        sample on the host (`dsptoolbox_tpu/realtime/misc.py:675`);
        ``buffer`` is left as it was."""
        assert self.sampling_rate_hz == signal.sampling_rate_hz, "Sampling rates do not match"
        buffer_prior = self.buffer.copy()
        self.set_n_channels(signal.number_of_channels)
        out = _host_loop(self, signal)
        self.buffer = buffer_prior
        return signal.copy_with_new_time_data(out)

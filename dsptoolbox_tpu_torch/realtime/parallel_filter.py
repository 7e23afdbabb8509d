"""Fixed-pole parallel filter (Bank 2022): parallel second-order sections
plus an FIR part (`dsptoolbox_tpu/realtime/parallel_filter.py`).

The least-squares fit stays on the host in float64, over the JAX package's
model without its repeated directions (`ParallelFilter.fit_to_ir`), so
its sections do not cancel. `filter_signal` runs the FIR part as one FFT
convolution and each section as one zero-state `ops.iir.sosfilt` on the
signal's device (B2 on a float32 CUDA tensor: one launch a section), and
sums the parts in float64 there, cast once: coefficients set by hand may
still cancel, and a float32 sum adds its own rounding of the sections' size
to the output.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sig
import torch
from scipy.linalg import lstsq

from .._enums import SpectrumMethod
from ..ops.fft_conv import fft_convolve
from ..ops.iir import sosfilt
from .base import RealtimeFilter, host_array
from .iir_fir import FIRFilter, IIRFilter


class ParallelFilter(RealtimeFilter):
    """Parallel SOS battery with an FIR correction
    (`dsptoolbox_tpu/realtime/parallel_filter.py:24`)."""

    def __init__(self, poles: np.ndarray, n_fir: int, sampling_rate_hz: int):
        assert n_fir >= 0, "n_fir must be at least 0"
        poles = np.asarray(poles)
        assert np.all(np.abs(poles) < 1.0), "At least one pole lies outside the unit circle"
        assert np.all(poles.imag >= 0.0), "Only poles with positive imaginary part are accepted"
        assert np.all(np.abs(poles) > 0.0), "No poles at the origin should be used"
        assert all(np.sum(np.isclose(poles, p)) == 1 for p in poles), (
            "Pole multiplicity cannot be more than 1"
        )
        assert sampling_rate_hz > 0, "Sampling rate must be greater than 0"
        self.poles = poles
        self.n_fir = n_fir
        self.sampling_rate_hz = sampling_rate_hz
        self._sos = None
        self._fir_coefficients = np.array([])
        self.set_parameters()

    def set_parameters(self, delay_iir_samples: int = 0, fir_offset_ms: float = 0.0):
        assert delay_iir_samples >= 0, "Delay should not be negative"
        self.fir_offset_samples = max(1, int(self.sampling_rate_hz * fir_offset_ms / 1e3 + 0.5))
        self.delay_iir_samples = (
            self.n_fir + 1 + self.fir_offset_samples * (self.n_fir - 1)
            if delay_iir_samples is None
            else delay_iir_samples
        )
        return self

    def set_coefficients(self, iir_coefficients: np.ndarray, fir=None):
        assert iir_coefficients.ndim == 2
        assert iir_coefficients.shape[0] == self._sos.shape[0]
        for ss in range(self._sos.shape[0]):
            self._sos[ss, :2] = iir_coefficients[ss, :]
        if fir is not None:
            assert fir.ndim == 1
            self._fir_coefficients = fir
        else:
            self._fir_coefficients = np.array([])
        self.n_fir = len(self._fir_coefficients)
        return self

    @staticmethod
    def _host_f64_spectrum(ir):
        """The IR's spectrum for the fit, on the host in float64
        (`dsptoolbox_tpu/realtime/parallel_filter.py:76`): the default FFT
        spectrum from the IR's data, else the signal's own getter."""
        p = getattr(ir, "_spectrum_parameters", {})
        scaling = ir.spectrum_scaling
        if (ir.spectrum_method == SpectrumMethod.FFT and p.get("smoothing", 0) == 0
                and not scaling.has_physical_units()):
            from scipy.fft import next_fast_len

            td = np.asarray(host_array(ir.time_data), np.float64)
            n = (next_fast_len(ir.length_samples, True) if p.get("pad_to_fast_length", True)
                 else ir.length_samples)
            sp = np.fft.rfft(td.real, axis=0, n=n, norm=scaling.fft_norm())
            return np.fft.rfftfreq(n, 1.0 / ir.sampling_rate_hz), sp
        freqs, sp = ir.get_spectrum(return_device=True)
        return host_array(freqs), host_array(sp)

    def fit_to_ir(self, ir):
        """Frequency-domain least-squares fit of the section numerators and
        the FIR part (`dsptoolbox_tpu/realtime/parallel_filter.py:111`), on
        the host in float64.

        The JAX package fits three numerator coefficients a section, and
        that basis is degenerate: ``a2 z⁻² / A = 1 − (1 + a1 z⁻¹) / A``, so
        every second-order section spans the direct term, once more each
        (a first-order section spans the direct term and ``z⁻¹``). With two
        or more sections the least-squares problem is rank-deficient and
        its solution cancels between sections (numerators of ~1e9 on a room
        IR with 32 pole pairs), which float32 filtering cannot carry. Here
        the basis is the same space without the repeats: ``z⁻ᵈ/A`` and
        ``z⁻ᵈ⁻¹/A`` a second-order section (``z⁻ᵈ/A`` a first-order one),
        the FIR taps, and the direct lags ``d`` (and ``d + 1``) where no FIR
        tap covers them, each then folded into one section's numerator. The
        fitted response is the same least-squares optimum; the numerators
        are of the response's own size."""
        assert ir.number_of_channels == 1, "This is only valid for a single-channel IR"
        freqs, spectrum_channels = self._host_f64_spectrum(ir)
        freqs = freqs[1:]
        spectrum = spectrum_channels[1:, 0]
        z1 = np.exp(-2j * np.pi * freqs / ir.sampling_rate_hz)  # z⁻¹ at the fit's bins

        comp_inds = self.poles.imag != 0
        poles = np.hstack([self.poles, self.poles[comp_inds].conjugate()])
        self._sos = sig.zpk2sos([], poles, 1.0)
        d, o = self.delay_iir_samples, self.fir_offset_samples
        second = self._sos[:, 5] != 0.0
        columns, where = [], []  # `where`: (section, numerator index) or (None, lag)
        for n, s in enumerate(self._sos):
            den = s[3] + s[4] * z1 + s[5] * z1**2
            for j in range(2 if second[n] else 1):
                columns.append(z1 ** (d + j) / den)
                where.append((n, j))
        fir_lags = {n * o for n in range(self.n_fir)}
        for lag in [d] + ([d + 1] if not second.all() else []):
            if lag not in fir_lags:
                columns.append(z1**lag)
                where.append((None, lag))
        columns += [z1 ** (n * o) for n in range(self.n_fir)]
        M = np.stack(columns, axis=1)
        M = np.vstack([np.real(M), np.imag(M)])
        solution = lstsq(M, np.hstack([np.real(spectrum), np.imag(spectrum)]),
                         overwrite_a=True, overwrite_b=True)[0]
        self._sos[:, :3] = 0.0
        first = int(np.argmin(second))  # a first-order section, where there is one
        for (n, j), c in zip(where, solution):
            if n is not None:
                self._sos[n, j] += c
            elif j == d:  # c z⁻ᵈ = z⁻ᵈ c A₀ / A₀
                self._sos[0, :3] += c * self._sos[0, 3:]
            else:  # c z⁻ᵈ⁻¹ = z⁻ᵈ c (z⁻¹ + a1 z⁻²) / A for a first-order A
                self._sos[first, 1:3] += c * self._sos[first, 3:5]
        self._fir_coefficients = solution[len(where):]
        if self.n_fir > 1 and self.fir_offset_samples > 1:
            ff = np.zeros(self.fir_offset_samples * (self.n_fir - 1) + 1)
            ff[:: self.fir_offset_samples] = self._fir_coefficients[:-1]
            ff[-1] = self._fir_coefficients[-1]
            self._fir_coefficients = ff
        self._compute_real_time_filters()
        return self

    def _compute_real_time_filters(self):
        self.iir = [IIRFilter(self._sos[n, :3], self._sos[n, 3:])
                    for n in range(self._sos.shape[0])]
        if len(self._fir_coefficients):
            self.fir = FIRFilter(self._fir_coefficients)
        if self.delay_iir_samples > 0:
            self.iir_delay = FIRFilter(np.array(self.delay_iir_samples * [0.0] + [1.0]))

    def _parts(self) -> list:
        return getattr(self, "iir", []) + [getattr(self, n) for n in ("fir", "iir_delay")
                                           if hasattr(self, n)]

    def set_n_channels(self, n_channels: int):
        for f in self._parts():
            f.set_n_channels(n_channels)

    def reset_state(self):
        for f in self._parts():
            f.reset_state()

    def process_sample(self, x: float, channel: int):
        y = 0.0
        if hasattr(self, "fir"):
            y += self.fir.process_sample(x, channel)
        x_iir = x
        if hasattr(self, "iir_delay"):
            x_iir = self.iir_delay.process_sample(x, channel)
        for f in self.iir:
            y += f.process_sample(x_iir, channel)
        return y

    def _sum(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The FIR part and every section over ``x (C, T)``, each section a
        zero-state `ops.iir.sosfilt`, summed in ``dtype`` → ``(C, T)``."""
        T = x.shape[-1]
        if len(self._fir_coefficients):
            h = torch.as_tensor(np.array(self._fir_coefficients), dtype=x.dtype, device=x.device)
            output = fft_convolve(x, h)[..., :T].to(dtype)
        else:
            output = x.new_zeros(x.shape, dtype=dtype)
        if self.delay_iir_samples > 0:
            x = torch.nn.functional.pad(x, (self.delay_iir_samples, 0))[..., :T]
        for n_sos in range(self._sos.shape[0]):
            output += sosfilt(self._sos[n_sos][None, :], x)[0]
        return output

    def filter_signal(self, signal):
        """The parallel battery and the FIR part on the signal's device
        (`dsptoolbox_tpu/realtime/parallel_filter.py:221`), summed in
        float64 and cast once."""
        assert self.sampling_rate_hz == signal.sampling_rate_hz, "Sampling rates do not match"
        x = signal._x
        return signal.copy_with_new_time_data(self._sum(x, torch.float64).to(x.dtype).T)

    def get_ir(self, length_samples: int):
        from ..generators import dirac

        d = dirac(length_samples, sampling_rate_hz=self.sampling_rate_hz)
        return self.filter_signal(d)

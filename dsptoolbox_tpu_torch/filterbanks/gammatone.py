"""Gammatone (Hohmann 2002) auditory filter bank with reconstruction
(`dsptoolbox_tpu/filterbanks/gammatone.py`).

The complex one-pole cascades run as one complex bank (`FilterBank`: the
complex route of the filter-bank kernel B3 on a CUDA tensor). The delays,
phase factors and gains of the synthesis are host float64, computed as the
JAX package computes them; `reconstruct` runs on the bands' device.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import sosfilt as _sosfilt

from ..classes.filterbank import FilterBank
from ..classes.multibandsignal import MultiBandSignal
from ..classes.signal import Signal


class GammaToneFilterBank(FilterBank):
    """FilterBank with Hohmann-2002 synthesis (delay-, phase- and
    gain-corrected reconstruction)."""

    def __init__(
        self,
        filters: list,
        info: dict,
        frequencies: np.ndarray,
        coefficients: np.ndarray,
        normalizations: np.ndarray,
    ):
        super().__init__(filters, same_sampling_rate=True, info=info)
        self._frequencies = frequencies
        self._coefficients = coefficients
        self._normalizations = normalizations
        self._delay = 0.004
        self._compute_delays_and_phase_factors()
        self._compute_gains()

    def _compute_delays_and_phase_factors(self):
        """Hohmann 2002, section 4 (`gammatone.py:38`). The reference reads
        the envelope maximum in a window before the impulse arrives, so the
        delay is the nominal one and the slope is ``-ir[-1]``, the last
        sample of each band's half-second response to a dirac, computed by
        the float64 ``sosfilt`` cascade as the reference does. Parity: where
        that tail underflows (high bands at 44.1 kHz), the phase factor is
        not finite, as in the reference."""
        delay_samples = int(np.round(self._delay * self.sampling_rate_hz))
        n_samples = self.sampling_rate_hz // 2
        dirac = np.zeros(n_samples, dtype=np.complex128)
        dirac[delay_samples + 3] = 1.0
        slopes = np.empty(len(self._coefficients), dtype=np.complex128)
        for bb, filt in enumerate(self.filters):
            ir = _sosfilt(np.asarray(filt.sos), dirac)
            slopes[bb] = ir[1] - ir[-1]
        with np.errstate(over="ignore", invalid="ignore"):
            self._phase_factors = 1j / (slopes / np.abs(slopes))
        self._delays = np.full(len(self._coefficients), delay_samples)

    def _compute_gains(self):
        """Iterative gain fitting (`gammatone.py:83`); the association of
        the products follows the reference, since the iteration oscillates
        rather than converging."""
        z = np.atleast_2d(np.exp(2j * np.pi * self._frequencies / self.sampling_rate_hz)).T
        h_pos = (1 - np.atleast_2d(self._coefficients) / z) ** (-4) * np.atleast_2d(
            self._normalizations)
        h_neg = (1 - np.atleast_2d(self._coefficients) / np.conjugate(z)) ** (-4) * (
            np.atleast_2d(self._normalizations))
        phase_factors = np.atleast_2d(self._phase_factors)
        delays = np.atleast_2d(self._delays)
        h_pos = h_pos * (phase_factors * z ** (-delays))
        h_neg = h_neg * (phase_factors * np.conjugate(z) ** (-delays))
        h = (h_pos + np.conjugate(h_neg)) / 2
        gains = np.ones((self.number_of_filters, 1))
        for _ in range(100):
            gains /= np.abs(np.matmul(h, gains))
        self._gains = gains.flatten()

    def reconstruct(self, signal: MultiBandSignal) -> Signal:
        """Delay-, phase- and gain-corrected synthesis
        (`gammatone.py:110`): the sum over bands of
        ``Re(roll(band, delay) · phase_factor) · gain``, in float64 on the
        bands' device."""
        assert all(b.is_complex_signal for b in signal.bands), (
            "Not all bands have imaginary time data. Reconstruction cannot be done"
        )
        total = None
        for band, pf, delay, gain in zip(signal.bands, self._phase_factors, self._delays,
                                         self._gains):
            re = torch.roll(band._x, int(delay), dims=-1).double()
            im = torch.roll(band._x_imag, int(delay), dims=-1).double()
            y = (re * pf.real - im * pf.imag) * gain
            total = y if total is None else total + y
        return signal.bands[0].copy_with_new_time_data(total.T)

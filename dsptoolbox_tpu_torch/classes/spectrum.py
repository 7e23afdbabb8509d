"""Spectrum: a frequency-domain container (`dsptoolbox_tpu/classes/spectrum.py`).

A thin port: construction, the frequency vector with its spacing check,
the spectral data and its type, `from_signal` and `copy`. The frequency
vector is host float64 numpy (it defines the grid). The spectral data is a
tensor ``(F, C)`` on the device of the data it was given (numpy data goes
to ``device`` or `_config.default_device()`), in the package's default
complex or float dtype; the JAX package holds it as host complex128 or
float64 numpy.

Not ported yet: interpolation, trimming, resampling, octave smoothing,
coherence, saving and plots.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from .._config import default_complex, default_device, default_float
from ..standard.enums import FrequencySpacing, SpectrumType


class Spectrum:
    def __init__(self, frequency_vector_hz, spectral_data, device=None):
        """Complex or magnitude spectrum over a frequency grid
        (`classes/spectrum.py:32-54`). ``device``: where numpy
        ``spectral_data`` goes; a tensor keeps its own device."""
        self._numpy_device = default_device() if device is None else device
        self.frequency_vector_hz = frequency_vector_hz
        self.spectral_data = spectral_data

    @staticmethod
    def from_signal(sig, complex: bool = False) -> "Spectrum":
        """Spectrum of a Signal via its `get_spectrum()`
        (`classes/spectrum.py:58-85`), on the signal's device."""
        if complex:
            assert sig.spectrum_scaling.outputs_complex_spectrum(
                sig.spectrum_method
            ), "Method or scaling do not deliver a complex spectrum"
        f, sp = sig.get_spectrum()
        if complex:
            assert sp.is_complex(), "Spectrum of signal is not complex"
            return Spectrum(f, sp)
        mag = sp.abs()
        return Spectrum(
            f, mag if sig.spectrum_scaling.is_amplitude_scaling() else mag**0.5
        )

    # ======== Properties ====================================================
    @property
    def frequency_vector_hz(self) -> np.ndarray:
        return self._frequency_vector_hz

    @frequency_vector_hz.setter
    def frequency_vector_hz(self, new_freqs):
        new_freqs = np.asarray(new_freqs, dtype=np.float64).reshape(-1)
        assert np.all(np.ediff1d(new_freqs) > 0), (
            "Frequency vector must be strictly increasing"
        )
        self._frequency_vector_hz = new_freqs
        self._freq_type = _frequency_vector_type(new_freqs)

    @property
    def frequency_vector_type(self) -> FrequencySpacing:
        return self._freq_type

    @property
    def number_frequency_bins(self) -> int:
        return len(self.frequency_vector_hz)

    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def spectral_data(self) -> torch.Tensor:
        """Spectral data ``(F, C)`` (`classes/spectrum.py:150-171`): the
        stored tensor, on its device; writing into it writes through."""
        return self._data

    @spectral_data.setter
    def spectral_data(self, new_data):
        if not isinstance(new_data, torch.Tensor):
            new_data = torch.as_tensor(np.asarray(new_data)).to(self._numpy_device)
        data = torch.atleast_2d(new_data)
        assert data.ndim == 2, "Spectral data must have two dimensions"
        if data.shape[0] < data.shape[1]:
            data = data.T
        assert data.shape[0] == len(self.frequency_vector_hz), (
            "Spectral data does not match frequency vector length"
        )
        dt = default_complex() if data.is_complex() else default_float()
        self._data = data.to(dt).contiguous()

    @property
    def is_magnitude(self) -> bool:
        return not self._data.is_complex()

    @property
    def is_complex(self) -> bool:
        return not self.is_magnitude

    @property
    def spectrum_type(self) -> SpectrumType:
        return SpectrumType.Complex if self.is_complex else SpectrumType.Magnitude

    def copy(self) -> "Spectrum":
        """A deep copy: the tensor is copied on its device."""
        return deepcopy(self)


def _frequency_vector_type(f_vec_hz: np.ndarray) -> FrequencySpacing:
    """Linear, logarithmic or other spacing
    (`classes/spectrum.py:193-210`)."""
    # np.isclose(a, b) with its defaults, |a - b| <= 1e-8 + 1e-5 |b|, for
    # one scalar b, without isclose's overhead on long grids
    if len(f_vec_hz) >= 2:
        step = f_vec_hz[-1] - f_vec_hz[-2]
        if np.all(np.abs(np.diff(f_vec_hz) - step) <= 1e-8 + 1e-5 * abs(step)):
            return FrequencySpacing.Linear
    if len(f_vec_hz) >= 3:
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = f_vec_hz[2:] / f_vec_hz[1:-1]
        if np.all(np.isclose(ratios, f_vec_hz[-1] / f_vec_hz[-2])):
            return FrequencySpacing.Logarithmic
    return FrequencySpacing.Other

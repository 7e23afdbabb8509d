"""Spectrum: a frequency-domain container (`dsptoolbox_tpu/classes/spectrum.py`).

A thin port: construction, the frequency vector with its spacing check,
the spectral data and its type, `from_signal` and `copy`. The frequency
vector is host float64 numpy (it defines the grid). The spectral data is a
tensor ``(F, C)`` on the device of the data it was given (numpy data goes
to ``device`` or `_config.default_device()`), in the package's default
complex or float dtype; the JAX package holds it as host complex128 or
float64 numpy.

`get_interpolated_spectrum` interpolates linearly on the data's device
(what `standard.append_spectra` needs). Not ported yet: the cubic and PCHIP
interpolation schemes (they raise `NotImplementedError`), trimming,
resampling, octave smoothing, coherence, saving and plots.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from .._config import default_complex, default_device, default_float
from ..helpers.gain_and_level import to_db
from ..helpers.other import unwrap
from .._enums import (
    FrequencySpacing,
    InterpolationDomain,
    InterpolationEdgeHandling,
    InterpolationScheme,
    SpectrumType,
)


class Spectrum:
    def __init__(self, frequency_vector_hz, spectral_data, device=None):
        """Complex or magnitude spectrum over a frequency grid
        (`classes/spectrum.py:32-54`). ``device``: where numpy
        ``spectral_data`` goes; a tensor keeps its own device."""
        self._numpy_device = default_device() if device is None else device
        self.frequency_vector_hz = frequency_vector_hz
        self.spectral_data = spectral_data
        self.set_interpolator_parameters()

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

    # ======== Interpolation =================================================
    def set_interpolator_parameters(
        self,
        domain: InterpolationDomain = InterpolationDomain.Power,
        scheme: InterpolationScheme = InterpolationScheme.Linear,
        edges_handling: InterpolationEdgeHandling = InterpolationEdgeHandling.ZeroPad,
    ) -> "Spectrum":
        """How `get_interpolated_spectrum` interpolates
        (`classes/spectrum.py:366`)."""
        if domain in (InterpolationDomain.Complex, InterpolationDomain.MagnitudePhase):
            assert not self.is_magnitude, (
                "No complex interpolation is possible with this data"
            )
        self._int_domain = domain
        self._int_scheme = scheme
        self._int_edges = edges_handling
        return self

    def _interp_linear(self, data: torch.Tensor, fq: np.ndarray) -> torch.Tensor:
        """Linear interpolation of ``data (F, C)`` onto ``fq``: bracketing
        indices and weights from the host grid, a gather on the device
        (`helpers/interpolation.py:29 linear_interpolate`)."""
        if self._int_scheme != InterpolationScheme.Linear:
            raise NotImplementedError(
                f"{self._int_scheme} interpolation is not ported yet; use Linear"
            )
        f = self.frequency_vector_hz
        idx = np.clip(np.searchsorted(f, fq, side="right") - 1, 0, len(f) - 2)
        denom = f[idx + 1] - f[idx]
        w = (fq - f[idx]) / np.where(denom == 0, 1.0, denom)
        i = torch.as_tensor(idx, device=data.device)
        wj = torch.as_tensor(w, dtype=data.dtype, device=data.device)[:, None]
        return data[i] * (1 - wj) + data[i + 1] * wj

    def get_interpolated_spectrum(self, requested_frequency, output_type: SpectrumType):
        """The spectrum at the requested frequencies, in the interpolation
        domain set by `set_interpolator_parameters`, edges per its edge
        handling (`classes/spectrum.py:405`)."""
        fq = np.asarray(requested_frequency, dtype=np.float64).reshape(-1)
        f = self.frequency_vector_hz
        if output_type == SpectrumType.Complex:
            assert not self.is_magnitude, "Complex output is not supported"
        outside_left = fq < f[0]
        outside_right = fq > f[-1]
        if self._int_edges == InterpolationEdgeHandling.Error:
            assert 0 == np.sum(outside_left | outside_right), (
                "Frequencies are not in the given range and edge handling "
                "does not support it"
            )
        dom = self._int_domain
        sp = self.spectral_data
        data_imag = None
        if dom == InterpolationDomain.Power:
            data = sp.abs() ** 2.0
        elif dom == InterpolationDomain.Magnitude:
            data = sp.abs()
        elif dom == InterpolationDomain.Complex:
            data, data_imag = sp.real, sp.imag
        else:  # MagnitudePhase
            data, data_imag = sp.abs(), unwrap(torch.angle(sp), dim=0)
        out = self._interp_linear(data, fq)
        if self._int_edges == InterpolationEdgeHandling.ZeroPad:
            left_val = right_val = torch.zeros_like(data[0])
        elif self._int_edges == InterpolationEdgeHandling.OnePad:
            left_val = right_val = torch.ones_like(data[0])
        else:  # Extend / Error (already validated)
            left_val, right_val = data[0], data[-1]
        lmask = torch.as_tensor(outside_left, device=out.device)[:, None]
        rmask = torch.as_tensor(outside_right, device=out.device)[:, None]
        if data_imag is not None:
            out_imag = self._interp_linear(data_imag, fq)
            # parity: the reference overwrites the *combined* output with
            # the edge value after combining
            if dom == InterpolationDomain.Complex:
                out = torch.complex(out, out_imag)
            else:
                out = out * torch.exp(1j * out_imag)
            left_val, right_val = left_val.to(out.dtype), right_val.to(out.dtype)
        out = torch.where(lmask, left_val[None], out)
        out = torch.where(rmask, right_val[None], out)
        if output_type == SpectrumType.Complex:
            return out
        if output_type == SpectrumType.Db:
            if dom.is_complex():
                return to_db(out.abs(), True)
            return to_db(out, dom.is_linear())
        if output_type == SpectrumType.Power:
            if dom.is_complex():
                return out.abs() ** 2.0
            return out**2.0 if dom.is_linear() else out
        if output_type == SpectrumType.Magnitude:
            if dom.is_complex():
                return out.abs()
            return out if dom.is_linear() else out**0.5
        raise ValueError("Some unexpected case happened!")

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

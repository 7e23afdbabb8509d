"""Spectrum: a frequency-domain container (`dsptoolbox_tpu/classes/spectrum.py`).

The frequency vector is host float64 numpy (it defines the grid). The
spectral data is a tensor ``(F, C)`` on the device of the data it was given
(numpy data goes to ``device`` or `_config.default_device()`), in the
package's default complex or float dtype; the JAX package holds it as host
complex128 or float64 numpy. A coherence, when set, is a real tensor of the
data's shape on the same device.

Interpolation (`get_interpolated_spectrum`) runs on the data's device in
the Power, Magnitude, Complex and MagnitudePhase domains: linear and PCHIP
by gathers over host brackets (`helpers/interpolation.py`), cubic by the
dense not-a-knot operator built on the host (scipy) and applied as one
float32 product up to 4096 bins, above that by scipy's ``CubicSpline`` on
the host, as the JAX package does. Octave smoothing runs through
`helpers.smoothing.fractional_octave_smoothing` on the device. The plots
draw on `plots`; `save_spectrum` pickles.
"""

from __future__ import annotations

from copy import deepcopy
from functools import lru_cache
from pickle import HIGHEST_PROTOCOL, dump

import numpy as np
import torch

from .._config import default_complex, default_device, default_float
from ..helpers.gain_and_level import from_db, to_db
from ..helpers.interpolation import linear_interpolate, pchip_interpolate
from ..helpers.other import check_format_in_path, unwrap
from ..helpers.smoothing import fractional_octave_smoothing
from ..helpers.spectrum_utilities import apply_real_operator, warp_frequency_vector
from .lazy_array import LazyHostArray
from .._enums import (
    FilterBankMode,
    FrequencySpacing,
    InterpolationDomain,
    InterpolationEdgeHandling,
    InterpolationScheme,
    MagnitudeNormalization,
    SpectrumType,
    Window,
)

# up to this many bins the cubic interpolation is one dense operator product
_CUBIC_OPERATOR_BINS = 4096


@lru_cache(maxsize=32)
def _cubic_operator(f_key: tuple, fq_key: tuple) -> np.ndarray:
    """The static not-a-knot ``CubicSpline`` operator ``(Fq, F)``
    (`classes/spectrum.py:36`)."""
    from scipy.interpolate import CubicSpline

    return np.asarray(CubicSpline(np.asarray(f_key), np.eye(len(f_key)), axis=0)(
        np.asarray(fq_key)))


class Spectrum:
    def __init__(self, frequency_vector_hz, spectral_data, device=None):
        """Complex or magnitude spectrum over a frequency grid
        (`classes/spectrum.py:46`). ``device``: where numpy
        ``spectral_data`` goes; a tensor keeps its own device."""
        self._numpy_device = default_device() if device is None else device
        self.frequency_vector_hz = frequency_vector_hz
        self.spectral_data = spectral_data
        self.set_interpolator_parameters()

    # ======== Constructors ==================================================
    @staticmethod
    def from_signal(sig, complex: bool = False) -> "Spectrum":
        """Spectrum of a Signal via its `get_spectrum()`
        (`classes/spectrum.py:56`), on the signal's device."""
        if complex:
            assert sig.spectrum_scaling.outputs_complex_spectrum(
                sig.spectrum_method
            ), "Method or scaling do not deliver a complex spectrum"
        f, sp = sig.get_spectrum(return_device=True)
        if complex:
            assert sp.is_complex(), "Spectrum of signal is not complex"
            return Spectrum(f, sp)
        mag = sp.abs()
        return Spectrum(
            f, mag if sig.spectrum_scaling.is_amplitude_scaling() else mag**0.5
        )

    @staticmethod
    def from_filter(frequency_vector_hz, filt, complex: bool = False) -> "Spectrum":
        """The filter's transfer function (host scipy) on the given grid
        (`classes/spectrum.py:84`), on the default device."""
        data = filt.get_transfer_function(np.asarray(frequency_vector_hz))
        return Spectrum(frequency_vector_hz, data if complex else np.abs(data))

    @staticmethod
    def from_filterbank(frequency_vector_hz, filter_bank, mode: FilterBankMode,
                        complex: bool = False) -> "Spectrum":
        """The bank's transfer functions, one channel each, or summed or
        multiplied into one (`classes/spectrum.py:93`), on the default
        device."""
        freqs = np.asarray(frequency_vector_hz)
        tfs = np.stack([f.get_transfer_function(freqs) for f in filter_bank.filters], axis=1)
        if mode == FilterBankMode.Summed:
            tfs = np.sum(tfs, axis=1, keepdims=True)
        elif mode == FilterBankMode.Sequential:
            tfs = np.prod(tfs, axis=1, keepdims=True)
        return Spectrum(freqs, tfs if complex else np.abs(tfs))

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
    def length_frequency_bins(self) -> int:
        return len(self.frequency_vector_hz)

    @property
    def number_of_channels(self) -> int:
        return self._data.shape[1]

    def __len__(self) -> int:
        return self._data.shape[0]

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
        if isinstance(new_data, LazyHostArray):
            # a getter's lazy value: its tensor, without a host copy
            new_data = new_data.device_tensor()
        elif not isinstance(new_data, torch.Tensor):
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

    @property
    def has_coherence(self) -> bool:
        return hasattr(self, "coherence")

    def set_coherence(self, coherence) -> "Spectrum":
        """Attach a coherence of the data's shape (real; numpy or a tensor,
        kept on the data's device) (`classes/spectrum.py:587`)."""
        if not torch.is_tensor(coherence):
            coherence = torch.as_tensor(np.asarray(coherence))
        assert tuple(coherence.shape) == tuple(self._data.shape), (
            "Length of signals and given coherence do not match"
        )
        assert not coherence.is_complex(), "Coherence cannot be complex"
        self.coherence = coherence.to(device=self.device, dtype=default_float())
        return self

    # ======== Channels ======================================================
    def get_channels(self, channels) -> "Spectrum":
        """A copy with the selected channels (`_multichannel.py:87`); an
        index out of range raises IndexError, as numpy indexing does."""
        channels = np.atleast_1d(np.asarray(channels).squeeze())
        n = self.number_of_channels
        bad = channels[(channels < -n) | (channels >= n)]
        if bad.size:
            raise IndexError(f"index {int(bad[0])} is out of bounds for axis 1 with size {n}")
        return self._create_copy_with_new_data(self._data[:, [int(c) for c in channels]])

    def remove_channel(self, channel_number: int = -1) -> "Spectrum":
        """Remove one channel in place (`_multichannel.py:43`)."""
        n = self.number_of_channels
        if channel_number < 0:
            channel_number = n + channel_number
        assert n > 1, "Cannot not erase only channel"
        assert 0 <= channel_number <= n - 1, (
            f"Channel number {channel_number} does not exist. Signal only "
            f"has {n - 1} channels (zero included)."
        )
        self.spectral_data = self._data[:, [c for c in range(n) if c != channel_number]]
        return self

    def swap_channels(self, new_order) -> "Spectrum":
        """Reorder the channels in place (`_multichannel.py:63`)."""
        new_order = np.atleast_1d(np.asarray(new_order).squeeze())
        assert new_order.ndim == 1, (
            "Too many or too few dimensions are given in the new arrangement vector"
        )
        n = self.number_of_channels
        assert n == len(new_order), "The number of channels does not match"
        assert all(new_order < n) and all(new_order >= 0), (
            f"Indexes of new channels have to be in [0, {n - 1}]"
        )
        assert len(np.unique(new_order)) == len(new_order), (
            "There are repeated indexes in the new order vector"
        )
        self.spectral_data = self._data[:, [int(c) for c in new_order]]
        return self

    def sum_channels(self, power_sum: bool = True) -> "Spectrum":
        """A copy with the channels summed into one: power sum (default) or
        linear sum (`classes/spectrum.py:301`)."""
        if power_sum:
            data = (self._data.abs() ** 2.0).sum(dim=1, keepdim=True) ** 0.5
        else:
            data = self._data.sum(dim=1, keepdim=True)
        return self._create_copy_with_new_data(data)

    # ======== Conversion ====================================================
    def to_signal(self, sampling_rate_hz: int, length_seconds: float | None = None):
        """Inverse rFFT back to a Signal, interpolating onto a linear grid
        from 0 Hz to Nyquist if needed (`classes/spectrum.py:199`)."""
        from ..ops.pad_trim import pad_trim_axis
        from .signal import Signal

        assert not self.is_magnitude, "Spectrum must be complex"

        def td_from_spec(spec):
            time_data = torch.fft.irfft(spec, dim=0)
            if length_seconds is not None:
                length_samples = int(length_seconds * sampling_rate_hz + 0.5)
                time_data = pad_trim_axis(time_data, length_samples, axis=0)
            return Signal.from_time_data(time_data, sampling_rate_hz)

        f = self.frequency_vector_hz
        if self.frequency_vector_type == FrequencySpacing.Linear:
            delta_f = f[1] - f[0]
            cond_sr = abs(sampling_rate_hz / 2 - f[-1]) > delta_f
            cond_start = not np.isclose(f[0], 0.0)
            if not (cond_sr or cond_start):
                return td_from_spec(self._data)
            requested = np.arange(0.0, sampling_rate_hz / 2 + delta_f / 2.0, delta_f)
        else:
            assert length_seconds is not None, "A length must be provided"
            requested = np.fft.rfftfreq(
                int(length_seconds * sampling_rate_hz + 0.5), 1 / sampling_rate_hz
            )
        self.set_interpolator_parameters(
            InterpolationDomain.MagnitudePhase,
            InterpolationScheme.Pchip,
            InterpolationEdgeHandling.ZeroPad,
        )
        return td_from_spec(self.get_interpolated_spectrum(requested, SpectrumType.Complex))

    # ======== In-place transforms ===========================================
    def _freqs_to_slice(self, f_lower_hz, f_upper_hz, inclusive: bool) -> slice:
        """The reference's boundaries (`spectrum.py:1030-1057`): inclusive
        extends one bin outward at each given boundary; exclusive always
        advances past the lower boundary bin."""
        f = self.frequency_vector_hz
        n = len(f)
        ind_low = int(np.searchsorted(f, f_lower_hz)) if f_lower_hz is not None else 0
        ind_high = int(np.searchsorted(f, f_upper_hz)) if f_upper_hz is not None else n
        if inclusive:
            if f_upper_hz is not None:
                ind_high = min(ind_high + 1, n)
            if f_lower_hz is not None and f[ind_low] != f_lower_hz:
                ind_low = max(ind_low - 1, 0)
        elif f_lower_hz is not None:
            ind_low += 1
        assert ind_low < ind_high, "Slice is invalid"
        return slice(ind_low, ind_high)

    def trim(self, f_lower_hz: float | None, f_upper_hz: float | None,
             inclusive: bool = True) -> "Spectrum":
        """Keep the bins between the two frequencies, in place
        (`classes/spectrum.py:290`)."""
        s = self._freqs_to_slice(f_lower_hz, f_upper_hz, inclusive)
        data = self._data[s].contiguous()
        self.frequency_vector_hz = self.frequency_vector_hz[s]
        self._data = data
        return self

    def resample(self, new_freqs_hz) -> "Spectrum":
        """Interpolate onto a new frequency vector in place, in the Power
        (magnitude) or MagnitudePhase (complex) domain with the set scheme
        and edge handling (`classes/spectrum.py:313`)."""
        self.set_interpolator_parameters(
            InterpolationDomain.Power if self.is_magnitude
            else InterpolationDomain.MagnitudePhase,
            self._int_scheme,
            self._int_edges,
        )
        new_sp = self.get_interpolated_spectrum(
            np.asarray(new_freqs_hz),
            SpectrumType.Magnitude if self.is_magnitude else SpectrumType.Complex,
        )
        self.frequency_vector_hz = new_freqs_hz
        self.spectral_data = new_sp
        return self

    def normalize(self, reference_frequency_hz: float,
                  reference_channel: int | None = None) -> "Spectrum":
        """Divide by the magnitude at a reference frequency, per channel or
        of one channel, in place (`classes/spectrum.py:343`)."""
        values = self.get_interpolated_spectrum(
            np.array([reference_frequency_hz]), SpectrumType.Magnitude
        )
        norm = values if reference_channel is None else values[0, reference_channel]
        self._data = self._data / norm
        return self

    def apply_gain(self, gain_db) -> "Spectrum":
        """Multiply by one gain, or one per channel, given in dB, in place
        (`classes/spectrum.py:358`)."""
        gains = np.atleast_1d(gain_db)
        assert len(gains) == 1 or len(gains) == self.number_of_channels, (
            "Number of gains is not compatible"
        )
        self._data = self._data * torch.as_tensor(
            from_db(gains, True), dtype=self._data.real.dtype, device=self.device
        )
        return self

    def warp(self, warping_factor: float, sampling_rate_hz: int) -> "Spectrum":
        """Warp the frequency vector (`classes/spectrum.py:508`)."""
        if not np.isclose(sampling_rate_hz / 2, self.frequency_vector_hz[-1]):
            assert sampling_rate_hz / 2 >= self.frequency_vector_hz[-1], (
                "Invalid sampling rate for frequency vector"
            )
        self.frequency_vector_hz = warp_frequency_vector(
            self.frequency_vector_hz, sampling_rate_hz, warping_factor
        )
        return self

    def apply_octave_smoothing(self, octave_fraction: float,
                               window_type: Window = Window.Hann) -> "Spectrum":
        """Fractional-octave smoothing in place, on the data's device
        (`classes/spectrum.py:525`): a magnitude spectrum directly, a complex
        one as its magnitude and unwrapped phase; a grid that is neither
        linear nor logarithmic is first interpolated onto a linear one of
        1 Hz steps."""
        f = self.frequency_vector_hz
        beta = (np.log2(f[-1] / f[-2])
                if self.frequency_vector_type == FrequencySpacing.Logarithmic else None)
        if self.frequency_vector_type in (FrequencySpacing.Linear,
                                          FrequencySpacing.Logarithmic):
            data = self._data
        else:
            new_f = np.linspace(f[0], f[-1], int(f[-1] - f[0]), endpoint=True)
            data = self.get_interpolated_spectrum(
                new_f, SpectrumType.Magnitude if self.is_magnitude else SpectrumType.Complex
            )
            self.frequency_vector_hz = new_f
        wt = window_type.to_scipy_format()
        if self.is_magnitude:
            self._data = fractional_octave_smoothing(data, beta, octave_fraction, wt).contiguous()
            return self
        mag = fractional_octave_smoothing(data.abs(), beta, octave_fraction, wt)
        ph = fractional_octave_smoothing(unwrap(data.angle(), dim=0), beta, octave_fraction, wt)
        self._data = torch.polar(mag, ph).contiguous()
        return self

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

    def _interp_1(self, data: torch.Tensor, fq: np.ndarray) -> torch.Tensor:
        """One real interpolation pass of ``data (F, C)`` onto ``fq`` in the
        set scheme (`classes/spectrum.py:386`); edges are the caller's."""
        f = self.frequency_vector_hz
        if self._int_scheme == InterpolationScheme.Linear:
            return linear_interpolate(f, data, fq, axis=0)
        if self._int_scheme == InterpolationScheme.Pchip:
            return pchip_interpolate(f, data, fq, axis=0)
        if len(f) <= _CUBIC_OPERATOR_BINS:
            return apply_real_operator(_cubic_operator(tuple(f.tolist()), tuple(fq.tolist())),
                                       data)
        # FFT-resolution grids: the dense operator would be O(F²) memory
        from scipy.interpolate import CubicSpline

        out = CubicSpline(f, data.double().cpu().numpy(), axis=0)(fq)
        return torch.as_tensor(out, dtype=data.dtype, device=data.device)

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
        sp = self._data
        data_imag = None
        if dom == InterpolationDomain.Power:
            data = sp**2.0 if self.is_magnitude else sp.abs() ** 2.0
        elif dom == InterpolationDomain.Magnitude:
            data = sp if self.is_magnitude else sp.abs()
        elif dom == InterpolationDomain.Complex:
            data, data_imag = sp.real, sp.imag
        else:  # MagnitudePhase
            data, data_imag = sp.abs(), unwrap(torch.angle(sp), dim=0)
        out = self._interp_1(data, fq)
        if self._int_edges == InterpolationEdgeHandling.ZeroPad:
            left_val = right_val = torch.zeros_like(data[0])
        elif self._int_edges == InterpolationEdgeHandling.OnePad:
            left_val = right_val = torch.ones_like(data[0])
        else:  # Extend / Error (already validated)
            left_val, right_val = data[0], data[-1]
        lmask = torch.as_tensor(outside_left, device=out.device)[:, None]
        rmask = torch.as_tensor(outside_right, device=out.device)[:, None]
        if data_imag is not None:
            out_imag = self._interp_1(data_imag, fq)
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

    # ======== Analysis ======================================================
    def get_energy(self, f_lower_hz: float | None = None,
                   f_upper_hz: float | None = None) -> torch.Tensor:
        """Trapezoidal integral of the power over a frequency region, one
        value a channel, on the data's device (`classes/spectrum.py:492`)."""
        region = self._freqs_to_slice(f_lower_hz, f_upper_hz, True)
        power = self._data[region].abs() ** 2.0
        dx = torch.as_tensor(np.diff(self.frequency_vector_hz[region]),
                             dtype=power.dtype, device=power.device)[:, None]
        return ((power[1:] + power[:-1]) / 2.0 * dx).sum(dim=0)

    # ======== Copies ========================================================
    # ======== Plots and saving ==============================================
    def plot_magnitude(self, in_db: bool = True,
                       normalization: MagnitudeNormalization = MagnitudeNormalization.NoNormalization,
                       dynamic_range_db=None):
        """Magnitude per channel (`classes/spectrum.py:597`)."""
        from ..helpers.spectrum_utilities import get_normalized_spectrum
        from ..plots import general_plot

        f, mag_db = get_normalized_spectrum(self.frequency_vector_hz, self.spectral_data, True,
                                            None, normalization, 0, False, False)
        mat = np.asarray(mag_db)
        if not in_db:
            mat = 10 ** (mat / 20)
        return general_plot(f, np.atleast_2d(mat.T).T, None, range_y=dynamic_range_db,
                            ylabel="Magnitude / " + ("dB" if in_db else "1"),
                            labels=[f"Channel {n}" for n in range(self.number_of_channels)])

    def plot_coherence(self):
        """The coherence of each channel (`classes/spectrum.py:639`)."""
        from ..plots import general_subplots_line

        assert self.has_coherence, "No coherence has been saved"
        return general_subplots_line(
            self.frequency_vector_hz, self.coherence.cpu().numpy(), sharey=True, log_x=True,
            ylabels=[rf"$\gamma^2$ Coherence {n}" for n in range(self.number_of_channels)],
            xlabels="Frequency / Hz", range_y=[-0.1, 1.1],
        )

    def save_spectrum(self, path: str):
        """Pickle the spectrum (`classes/spectrum.py:658`)."""
        path = check_format_in_path(path, "pkl")
        with open(path, "wb") as data_file:
            dump(self, data_file, HIGHEST_PROTOCOL)
        return self

    def copy(self) -> "Spectrum":
        """A deep copy: the tensors are copied on their device."""
        return deepcopy(self)

    def _create_copy_with_new_data(self, data) -> "Spectrum":
        new = self.copy()
        new.spectral_data = data
        return new


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

"""Signal: the multichannel time-series container (`dsptoolbox_tpu/classes/signal.py`).

A thin port: what the beamforming and transfer-function paths need. A
tensor keeps its device; numpy data goes to the ``device`` given or, without
one, to `_config.default_device()` ("cuda" unless changed). The data is
stored channels-first ``(C, T)`` in the package's default float; the public
``time_data`` keeps the JAX package's ``(T, C)`` layout. The Welch CSM runs
through `ops.spectral.csm_welch` (the framing kernel on a float32 CUDA
tensor) and is cached on the spectrum parameters; `get_spectrum` computes
the FFT (backward-normalised ``rfft``) or Welch spectrum on the data's
device. Time data may also come as a `DeviceTimeData` pair of real and
imaginary tensors (a filter bank's band planes), kept as views.

The spectrogram (`get_spectrogram`, through `ops.spectral.stft`) is
cached on the spectrogram parameters, the CSM (Welch, or the FFT method
through `ops.spectral.csm_from_spectrum`) on the spectrum parameters.
Channels are selected, removed, reordered, summed and appended on the
device (`get_channels`, `remove_channel`, `swap_channels`,
`sum_channels`, `add_channel`).

FFT spectra with ``smoothing != 0`` are smoothed in magnitude and
unwrapped phase by `helpers.smoothing.fractional_octave_smoothing`, and the
physical-unit scalings go through `helpers.spectrum_utilities.scale_spectrum`
(with the IR's window where it carries one), on the device.

A ``path`` (WAV or FLAC) is read on the host by `io.read_audio` and its
samples go to the device once, as numpy data does. `save_signal` writes
WAV, FLAC or a pickle; the plots (`plot_*`) draw on `plots` with the data
brought to numpy at the plot.

The getters `get_spectrum`, `get_csm` and `get_spectrogram` hand out what
the JAX package's do: in float32 mode a `LazyHostArray` over the device
tensor (numpy at the first host access), in float64 mode plain numpy, and
with ``return_device=True`` the tensor itself (the CSM as a
`DeviceSpectralData` pair). Inside a `pipeline` they return the tensors.
``get_csm(mesh=)`` runs the Welch CSM channel-parallel over a device mesh
(`parallel.parallel_csm`). Not ported: the deferred device-spectrum caches
of a tunnelled backend.
"""

from __future__ import annotations

from copy import deepcopy
from functools import lru_cache
from pickle import HIGHEST_PROTOCOL, dump
from typing import NamedTuple
from warnings import warn

import numpy as np
import torch

from .._config import (
    default_complex,
    default_device,
    default_float,
    in_pipeline,
    lazy_host_returns,
)
from ..helpers.other import check_format_in_path, unwrap
from ..helpers.smoothing import fractional_octave_smoothing
from ..helpers.spectrum_utilities import scale_spectrum
from ..ops.fft_conv import next_fast_len
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import csm_from_spectrum, csm_welch, stft, welch
from .._enums import MagnitudeNormalization, SpectrumMethod, SpectrumScaling, Window
from .._trace import spanned
from .lazy_array import LazyHostArray


class DeviceTimeData(NamedTuple):
    """Time data given as a ``(real, imag)`` pair of ``(T, C)`` tensors
    (``imag`` None for a real signal), e.g. one band of a filter bank's
    output planes: the signal keeps views of them. ``peak``, when given, is
    ``max(|real|, |imag|)``, computed beforehand (a filter bank reduces the
    peaks of all its bands at once), so the amplitude constraint needs no
    reduction of its own: a float, or in a pipeline a 0-d tensor on the
    data's device (`_config.in_pipeline`)."""

    real: torch.Tensor
    imag: torch.Tensor | None = None
    peak: float | torch.Tensor | None = None


class DeviceSpectralData(NamedTuple):
    """A complex spectral matrix on its device as a ``(real, imag)`` pair of
    tensors: `Signal.get_csm(return_device=True)`."""

    real: torch.Tensor
    imag: torch.Tensor

    @property
    def shape(self) -> tuple:
        return tuple(self.real.shape)

    @property
    def dtype(self) -> torch.dtype:
        return torch.complex128 if self.real.dtype == torch.float64 else torch.complex64

    @property
    def ndim(self) -> int:
        return self.real.ndim

    def complex_device(self) -> torch.Tensor:
        """The matrix as one complex tensor on its device."""
        return torch.complex(self.real, self.imag)

    def to_numpy(self) -> np.ndarray:
        """The matrix as host complex numpy (one packed copy)."""
        return LazyHostArray(self.real, self.imag).numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.to_numpy()
        return out if dtype is None else out.astype(dtype)


def _host_return(value: torch.Tensor, return_device: bool):
    """What a getter hands out for its tensor ``value``: the tensor with
    ``return_device`` or inside a `pipeline` (a lazy wrapper cannot be a
    graph's output), else a `LazyHostArray` in lazy mode
    (`_config.lazy_host_returns`) or a numpy copy."""
    if return_device or in_pipeline():
        return value
    if lazy_host_returns():
        return LazyHostArray(value)
    return value.detach().cpu().numpy().copy()


@lru_cache(maxsize=32)
def rfft_freqs(n: int, sampling_rate_hz: int) -> np.ndarray:
    """``np.fft.rfftfreq(n, 1 / fs)``, cached and read-only (a host build
    of ``n // 2 + 1`` floats per spectrum otherwise)."""
    f = np.fft.rfftfreq(n, 1 / sampling_rate_hz)
    f.flags.writeable = False
    return f


class Signal:
    """General multichannel audio signal backed by a tensor.

    ``time_data`` is ``(time samples, channels)`` as in the reference
    (`classes/signal.py:209-222`); inside, the data is held channels-first
    on its device.
    """

    def __init__(
        self,
        path: str | None = None,
        time_data=None,
        sampling_rate_hz: int | None = None,
        constrain_amplitude: bool = False,
        activate_cache: bool = False,
        device=None,
    ):
        """``path``: a WAV or FLAC file, read on the host (`io.read_audio`).
        ``device``: where numpy ``time_data`` (or the file's samples) goes
        (default: `_config.default_device()`); a tensor keeps its own
        device."""
        if path is not None:
            assert time_data is None, (
                "Constructor cannot take a path and a vector at the same time"
            )
            assert sampling_rate_hz is None, (
                "Constructor cannot take a path and a sampling rate at the same time"
            )
            from ..io import read_audio

            time_data, sampling_rate_hz = read_audio(path)
        else:
            assert time_data is not None, (
                "Either a path to an audio file or a time vector has to be "
                "passed"
            )
            assert sampling_rate_hz is not None, "A sampling rate should be passed!"
        self.constrain_amplitude = constrain_amplitude
        self.calibrated_signal = False
        self.activate_cache = activate_cache
        self._cache: dict = {}
        self._numpy_device = default_device() if device is None else device
        self.sampling_rate_hz = sampling_rate_hz
        self.time_data = time_data
        self.set_spectrum_parameters()
        self.set_spectrogram_parameters()

    @staticmethod
    def from_file(path: str) -> "Signal":
        return Signal(path)

    @staticmethod
    def from_time_data(
        time_data, sampling_rate_hz: int, constrain_amplitude: bool = True
    ) -> "Signal":
        return Signal(None, time_data, sampling_rate_hz, constrain_amplitude)

    # ======== Properties ====================================================
    @property
    def time_data(self) -> torch.Tensor:
        """Time data ``(T, C)``: a transposed view of the channels-first
        tensor. Assign to ``time_data`` to change it (numpy data goes to
        the signal's device); writing into the view changes the signal too,
        and the cached CSM and spectrogram are computed anew (they are kept
        with the data's version counters)."""
        return self._x.T

    @staticmethod
    def _as_columns(td: torch.Tensor) -> torch.Tensor:
        """Time data as ``(T, C)``: the shape checks of the reference
        setter (`classes/signal.py:456-506`)."""
        td = torch.atleast_2d(td).squeeze()
        assert td.ndim <= 2, (
            f"{td.ndim} are too many dimensions for time data. Dimensions "
            "should be [time samples, channels]"
        )
        if td.ndim < 2:
            td = td[..., None]
        if td.shape[1] > td.shape[0]:
            td = td.T
        return td

    @time_data.setter
    @spanned("dsp.entry.Signal.time_data")
    def time_data(self, new_time_data):
        peak = None
        if isinstance(new_time_data, tuple) and torch.is_tensor(new_time_data[0]):
            # a (real, imag[, peak]) pair of tensors, as `DeviceTimeData`
            td, td_imag, peak = DeviceTimeData(*new_time_data)
            td = self._as_columns(td)
            td_imag = None if td_imag is None else self._as_columns(td_imag)
        else:
            if not isinstance(new_time_data, torch.Tensor):
                arr = np.ascontiguousarray(np.asarray(new_time_data))
                dev = self._x.device if hasattr(self, "_x") else self._numpy_device
                dt = default_complex() if np.iscomplexobj(arr) else default_float()
                new_time_data = torch.as_tensor(arr).to(device=dev, dtype=dt)
            td = self._as_columns(new_time_data)
            td, td_imag = (td.real, td.imag) if td.is_complex() else (td, None)
        self._amplitude_scale_factor = 1.0
        if self.constrain_amplitude and in_pipeline():
            # in a pipeline the peak stays on the device: the constraint
            # runs in-program, ``s = min(1, 1/peak)``, with no warning and
            # the scale factor left at 1 (`dsptoolbox_tpu/classes/
            # signal.py:398-410`)
            if peak is None:
                peak = td.abs().amax()
                if td_imag is not None:
                    peak = torch.maximum(peak, td_imag.abs().amax())
            s = peak.reciprocal().clamp(max=1.0) if torch.is_tensor(peak) else 1.0 / max(peak, 1.0)
            td = td * s
            if td_imag is not None:
                td_imag = td_imag * s
        elif self.constrain_amplitude:
            if peak is None:
                peak_t = td.abs().max()
                if td_imag is not None:
                    peak_t = torch.maximum(peak_t, td_imag.abs().max())
                peak = float(peak_t)
            if peak > 1.0:
                td = td / peak
                if td_imag is not None:
                    td_imag = td_imag / peak
                warn(
                    "Signal was over 0 dBFS, normalizing to 0 dBFS "
                    "peak level was triggered"
                )
                self._amplitude_scale_factor = 1.0 / peak
        dt = default_float()
        self._x = td.T.to(dt).contiguous()
        self._x_imag = None if td_imag is None else td_imag.T.to(dt).contiguous()
        self._cache.clear()

    @property
    def time_data_imaginary(self) -> torch.Tensor | None:
        return None if self._x_imag is None else self._x_imag.T

    @property
    def is_complex_signal(self) -> bool:
        return self._x_imag is not None

    @property
    def amplitude_scale_factor(self) -> float:
        return self._amplitude_scale_factor

    @property
    def sampling_rate_hz(self) -> int:
        return self._sampling_rate_hz

    @sampling_rate_hz.setter
    def sampling_rate_hz(self, new_sampling_rate_hz):
        assert isinstance(new_sampling_rate_hz, (int, np.integer)), (
            "Sampling rate can only be an integer"
        )
        self._sampling_rate_hz = int(new_sampling_rate_hz)
        self._cache.clear()

    @property
    def number_of_channels(self) -> int:
        return self._x.shape[0]

    @property
    def length_samples(self) -> int:
        return self._x.shape[1]

    def __len__(self) -> int:
        return self._x.shape[1]

    @property
    def length_seconds(self) -> float:
        return self.length_samples / self.sampling_rate_hz

    @property
    def time_vector_s(self) -> np.ndarray:
        return np.linspace(
            0, self.length_samples / self.sampling_rate_hz, self.length_samples
        )

    @property
    def device(self) -> torch.device:
        return self._x.device

    @property
    def constrain_amplitude(self) -> bool:
        return self._constrain_amplitude

    @constrain_amplitude.setter
    def constrain_amplitude(self, nca):
        assert isinstance(nca, bool)
        self._constrain_amplitude = nca

    @property
    def calibrated_signal(self) -> bool:
        """Whether the data is in Pascal (`CalibrationData.calibrate_signal`)."""
        return self._calibrated_signal

    @calibrated_signal.setter
    def calibrated_signal(self, ncs):
        assert isinstance(ncs, bool)
        self._calibrated_signal = ncs

    @property
    def metadata(self) -> dict:
        return {
            "sampling_rate_hz": self.sampling_rate_hz,
            "number_of_channels": self.number_of_channels,
            "signal_length_samples": self.length_samples,
            "signal_length_seconds": self.length_seconds,
            "constrain_amplitude": self.constrain_amplitude,
            "amplitude_scale_factor": self.amplitude_scale_factor,
            "is_complex_signal": self.is_complex_signal,
        }

    @property
    def metadata_str(self) -> str:
        txt = "\n"
        for k, v in self.metadata.items():
            txt += f"{str(k).replace('_', ' ').capitalize()}: {v}\n"
        return txt

    def __str__(self):
        return self.metadata_str

    def show_info(self):
        print(self.metadata_str)
        return self

    # ======== Spectrum configuration ========================================
    def set_spectrum_parameters(
        self,
        method: SpectrumMethod = SpectrumMethod.WelchPeriodogram,
        smoothing: int = 0,
        pad_to_fast_length: bool = True,
        window_length_samples: int = 1024,
        window_type: Window = Window.Hann,
        overlap_percent: float = 50,
        detrend: bool = True,
        average: str = "mean",
        scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
    ) -> "Signal":
        """Configure the spectral getters (defaults match the reference,
        `classes/signal.py:497-588`)."""
        self._spectrum_parameters = dict(
            method=method,
            smoothing=smoothing,
            pad_to_fast_length=pad_to_fast_length,
            window_length_samples=window_length_samples,
            window_type=window_type,
            overlap_percent=overlap_percent,
            detrend=detrend,
            average=average,
            scaling=scaling,
        )
        return self

    @property
    def spectrum_method(self) -> SpectrumMethod:
        return self._spectrum_parameters["method"]

    @spectrum_method.setter
    def spectrum_method(self, new_method: SpectrumMethod):
        assert isinstance(new_method, SpectrumMethod)
        self._spectrum_parameters["method"] = new_method

    @property
    def spectrum_scaling(self) -> SpectrumScaling:
        return self._spectrum_parameters["scaling"]

    @spectrum_scaling.setter
    def spectrum_scaling(self, new_scaling: SpectrumScaling):
        assert isinstance(new_scaling, SpectrumScaling)
        self._spectrum_parameters["scaling"] = new_scaling

    @property
    def spectrum_smoothing(self) -> int:
        return self._spectrum_parameters["smoothing"]

    @spectrum_smoothing.setter
    def spectrum_smoothing(self, new_smoothing):
        self._spectrum_parameters["smoothing"] = new_smoothing

    def set_spectrogram_parameters(
        self,
        window_length_samples: int = 1024,
        window_type: Window = Window.Hann,
        overlap_percent: float = 50.0,
        fft_length_samples: int | None = None,
        detrend: bool = False,
        padding: bool = True,
        scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
    ) -> "Signal":
        """Configure `get_spectrogram` (defaults as in the reference,
        `classes/signal.py:706-773`); a change drops the cached one."""
        new = dict(
            window_length_samples=window_length_samples,
            window_type=window_type,
            overlap_percent=overlap_percent,
            fft_length_samples=fft_length_samples,
            detrend=detrend,
            padding=padding,
            scaling=scaling,
        )
        if getattr(self, "_spectrogram_parameters", None) != new:
            self._spectrogram_parameters = new
            self._cache.pop("spectrogram", None)
        return self

    # ======== Channels ======================================================
    def _with_planes(self, re: torch.Tensor, im) -> "Signal":
        """A copy with the channels-first planes ``re`` (and ``im``)."""
        return self.copy_with_new_time_data(
            DeviceTimeData(re.T, None if im is None else im.T)
        )

    def _set_planes(self, re: torch.Tensor, im) -> None:
        self.time_data = DeviceTimeData(re.T, None if im is None else im.T)

    def _planes_at(self, idx) -> tuple:
        """Copies of the real and imaginary planes' channels ``idx``, taken
        from slices (an index tensor copied from the host would wait for
        the queued device work)."""
        n = self.number_of_channels
        idx = [int(c) % n for c in np.atleast_1d(idx)]

        def take(p):
            if len(idx) == 1:
                return p[idx[0]:idx[0] + 1].clone()
            return torch.cat([p[c:c + 1] for c in idx])

        im = self._x_imag
        return take(self._x), None if im is None else take(im)

    def get_channels(self, channels) -> "Signal":
        """A copy with the selected channels (`_multichannel.py:87`); an
        index out of range raises IndexError, as numpy indexing does."""
        channels = np.atleast_1d(np.asarray(channels).squeeze())
        n = self.number_of_channels
        bad = channels[(channels < -n) | (channels >= n)]
        if bad.size:
            raise IndexError(
                f"index {int(bad[0])} is out of bounds for axis 1 with size {n}"
            )
        return self._with_planes(*self._planes_at(channels))

    def remove_channel(self, channel_number: int = -1) -> "Signal":
        """Remove one channel in place (`_multichannel.py:43`); negative
        numbers count from the end, as ``np.delete`` does."""
        n = self.number_of_channels
        if channel_number < 0:
            channel_number = n + channel_number
        assert n > 1, "Cannot not erase only channel"
        assert 0 <= channel_number <= n - 1, (
            f"Channel number {channel_number} does not exist. Signal only "
            f"has {n - 1} channels (zero included)."
        )
        self._set_planes(*self._planes_at([c for c in range(n) if c != channel_number]))
        return self

    def swap_channels(self, new_order) -> "Signal":
        """Reorder the channels in place (`_multichannel.py:63`)."""
        new_order = np.atleast_1d(np.asarray(new_order).squeeze())
        assert new_order.ndim == 1, (
            "Too many or too few dimensions are given in the new "
            "arrangement vector"
        )
        n = self.number_of_channels
        assert n == len(new_order), "The number of channels does not match"
        assert all(new_order < n) and all(new_order >= 0), (
            f"Indexes of new channels have to be in [0, {n - 1}]"
        )
        assert len(np.unique(new_order)) == len(new_order), (
            "There are repeated indexes in the new order vector"
        )
        self._set_planes(*self._planes_at(new_order))
        return self

    def sum_channels(self) -> "Signal":
        """A copy with all channels summed into one
        (`_multichannel.py:106`)."""
        im = self._x_imag
        return self._with_planes(
            self._x.sum(0, keepdim=True), None if im is None else im.sum(0, keepdim=True)
        )

    def add_channel(
        self,
        path: str | None = None,
        new_time_data=None,
        sampling_rate_hz: int | None = None,
        allow_padding_trimming: bool = True,
    ) -> "Signal":
        """Append channels from a WAV or FLAC file or from time data
        ``(T, C)`` (numpy or a tensor), padded or trimmed at the end to this
        signal's length, in place (`classes/signal.py:725`)."""
        if path is not None:
            assert new_time_data is None, "Only path or new time data is accepted, not both."
            from ..io import read_audio

            new_time_data, sampling_rate_hz = read_audio(path)
        assert sampling_rate_hz == self.sampling_rate_hz, (
            f"{sampling_rate_hz} does not match {self.sampling_rate_hz} "
            "as the sampling rate"
        )
        if not torch.is_tensor(new_time_data):
            new_time_data = torch.as_tensor(np.asarray(new_time_data))
        td = new_time_data.to(self.device)
        if td.ndim > 2:
            td = td.squeeze()
        assert td.ndim <= 2, "Too many dimensions for time data"
        if td.ndim < 2:
            td = td[..., None]
        if td.shape[1] > td.shape[0]:
            td = td.T
        diff = td.shape[0] - self.length_samples
        if diff != 0:
            if not allow_padding_trimming:
                raise AttributeError(
                    f"{td.shape[0]} does not match {self.length_samples}. "
                    "Activate allow_padding_trimming for allowing this "
                    "channel to be added"
                )
            td = pad_trim_axis(td, self.length_samples, axis=0)
            warn(
                f"{'Padding' if diff < 0 else 'Trimming'} has been performed on "
                "the end of the new signal to match original one."
            )
        new = td.T
        new_re, new_im = (new.real, new.imag) if new.is_complex() else (new, None)
        new_re = new_re.to(self._x.dtype)
        im = self._x_imag
        if im is not None or new_im is not None:
            im = torch.cat([torch.zeros_like(self._x) if im is None else im,
                            torch.zeros_like(new_re) if new_im is None
                            else new_im.to(self._x.dtype)])
        self._set_planes(torch.cat([self._x, new_re]), im)
        return self

    def clear_time_window(self) -> "Signal":
        """Drop the time window an `ImpulseResponse` carries."""
        if hasattr(self, "window"):
            del self.window
        return self

    # ======== Spectrum ======================================================
    def _spectrum_fft(self):
        """``(freqs, spectrum (C, F))``: the backward-normalised rfft of the
        real part (parity: the reference transforms ``self.time_data``, the
        real part only, `classes/signal.py:906-911`), at
        ``next_fast_len(T, True)`` when ``pad_to_fast_length`` is set."""
        p = self._spectrum_parameters
        scaling = self.spectrum_scaling
        n = (
            next_fast_len(self.length_samples, True)
            if p["pad_to_fast_length"]
            else self.length_samples
        )
        sp = torch.fft.rfft(self._x, n=n, dim=-1, norm=scaling.fft_norm())
        if p["smoothing"] != 0 or scaling.has_physical_units():
            # (`classes/signal.py:810-866`): the magnitude and the unwrapped
            # phase smoothed along frequency, then the physical scaling of
            # the backward-normalised spectrum
            sp = sp.T
            if p["smoothing"] != 0:
                mag = fractional_octave_smoothing(sp.abs(), None, p["smoothing"],
                                                  clip_values=True)
                ph = fractional_octave_smoothing(unwrap(sp.angle(), dim=0), None,
                                                 p["smoothing"])
                sp = torch.polar(mag, ph)
            if scaling.has_physical_units():
                window = getattr(self, "window", None)
                if torch.is_tensor(window):
                    window = window.cpu().numpy()
                sp = scale_spectrum(sp, scaling, n, self.sampling_rate_hz,
                                    None if window is None else np.asarray(window))
            sp = sp.T
        return rfft_freqs(n, self.sampling_rate_hz), sp

    @spanned("dsp.entry.Signal.get_spectrum")
    def get_spectrum(self, force_computation: bool = False, return_device: bool = False):
        """``(freqs, spectrum)`` per the spectrum parameters
        (`classes/signal.py:865-947`): the FFT method gives a complex ``(F,
        C)`` spectrum; Welch a real one, ``(F,)`` for a mono signal (parity:
        the reference's ``_welch`` squeezes its input,
        `classes/signal.py:928-932`; here also with ``return_device``).
        Computed on the data's device and handed out as `_host_return` says:
        a `LazyHostArray` in float32 mode, numpy in float64 mode, the tensor
        with ``return_device``. Not cached, so ``force_computation`` (the
        reference's cache switch) changes nothing."""
        if self.spectrum_method == SpectrumMethod.FFT:
            f, sp = self._spectrum_fft()
            return f.copy(), _host_return(sp.T, return_device)
        p = self._spectrum_parameters
        sp = welch(
            self._x,
            sampling_rate_hz=self.sampling_rate_hz,
            window_length_samples=p["window_length_samples"],
            window_type=p["window_type"],
            overlap_percent=p["overlap_percent"],
            detrend=p["detrend"],
            average=p["average"],
            scaling=p["scaling"],
        ).T
        if self.number_of_channels == 1:
            sp = sp[:, 0]
        f = rfft_freqs(p["window_length_samples"], self.sampling_rate_hz).copy()
        return f, _host_return(sp, return_device)

    def _data_versions(self) -> tuple:
        """The version counters of the data's planes: writing into
        `time_data` (a view) changes them."""
        im = self._x_imag
        return (self._x._version, None if im is None else im._version)

    def _spectrum_param_key(self) -> tuple:
        """Cache key of the CSM: the spectrum parameters and the data's
        version counters (the cache is also cleared whenever the time data
        or sampling rate are set)."""
        return (tuple(sorted((k, str(v)) for k, v in self._spectrum_parameters.items())),
                self._data_versions())

    # ======== Cross-spectral matrix =========================================
    @spanned("dsp.entry.Signal.get_csm")
    def get_csm(self, force_computation: bool = False, mesh=None, return_device: bool = False):
        """``(freqs, csm (F, C, C))``: the cross-spectral matrix
        (`classes/signal.py:1030-1126`), computed on the signal's device and
        cached on the spectrum parameters and the data's versions; handed out
        as `_host_return` says (a `LazyHostArray` in float32 mode, numpy in
        float64 mode), with ``return_device`` as a `DeviceSpectralData` pair
        of views of the cached tensor.

        ``mesh``: a `parallel.Mesh` of more than one device runs the Welch CSM
        channel-parallel over its first axis (`parallel.parallel_csm`), the
        channels padded with zero channels to a count the mesh divides; mean
        averaging only; the cache is bypassed."""
        assert self.number_of_channels > 1, (
            "Cross spectral matrix can only be computed when at least two "
            "channels are available"
        )
        if force_computation:
            self._cache.pop("csm", None)
        if return_device:
            f, csm = self._csm()
            return f.copy(), DeviceSpectralData(csm.real, csm.imag)
        if mesh is not None and mesh.devices.size > 1:
            f, csm = self._csm_mesh(mesh)
        else:
            f, csm = self._csm()
        return f.copy(), _host_return(csm, False)

    def _csm_mesh(self, mesh):
        """The Welch CSM over ``mesh`` (`dsptoolbox_tpu/classes/signal.py:
        1128-1160`): the channels padded with zeros to a multiple of the
        mesh's first axis (a zero channel gives zero rows and columns), the
        result cut back, on the mesh's first device."""
        from ..parallel import parallel_csm

        p = self._spectrum_parameters
        assert self.spectrum_method == SpectrumMethod.WelchPeriodogram, (
            "mesh-parallel CSM is only available for the Welch method"
        )
        assert str(p["average"]).lower().endswith("mean"), (
            "mesh-parallel CSM supports mean averaging only (median needs "
            "every frame on every device)"
        )
        n = int(mesh.shape[mesh.axis_names[0]])
        x = self._x
        pad = (-x.shape[0]) % n
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        f, csm = parallel_csm(
            x,
            mesh,
            sampling_rate_hz=self.sampling_rate_hz,
            window_length_samples=p["window_length_samples"],
            window_type=p["window_type"],
            overlap_percent=p["overlap_percent"],
            detrend=p["detrend"],
            scaling=p["scaling"],
        )
        C = self.number_of_channels
        return f, csm[:, :C, :C]

    def _csm(self):
        """``(freqs, csm (F, C, C))``: the cached CSM, a complex tensor on
        the signal's device (what the library's own callers take)."""
        key = self._spectrum_param_key()
        entry = self._cache.get("csm")
        if entry is not None and entry[0] == key:
            return entry[1], entry[2]
        if self.spectrum_method == SpectrumMethod.FFT:
            # as the reference (`classes/signal.py:1100-1125`): the
            # backward-normalised spectrum, then the scaling's factor
            scaling = self.spectrum_scaling
            self._spectrum_parameters["scaling"] = SpectrumScaling.FFTBackward
            try:
                f, sp = self._spectrum_fft()
            finally:
                self._spectrum_parameters["scaling"] = scaling
            window = getattr(self, "window", None)
            if torch.is_tensor(window):
                window = window.cpu().numpy()
            csm = csm_from_spectrum(sp.T, scaling, window, self.sampling_rate_hz)
            self._cache["csm"] = (key, f, csm)
            return f, csm
        p = self._spectrum_parameters
        f, csm = csm_welch(
            self._x,
            sampling_rate_hz=self.sampling_rate_hz,
            window_length_samples=p["window_length_samples"],
            window_type=p["window_type"],
            overlap_percent=p["overlap_percent"],
            detrend=p["detrend"],
            average=p["average"],
            scaling=p["scaling"],
        )
        self._cache["csm"] = (key, f, csm)
        return f, csm

    # ======== Spectrogram ===================================================
    @spanned("dsp.entry.Signal.get_spectrogram")
    def get_spectrogram(self, force_computation: bool = False, return_device: bool = False):
        """``(t, f, S (F, frames, C))``: the complex STFT per the
        spectrogram parameters (`classes/signal.py:1210`), on the signal's
        device through `ops.spectral.stft` (the framing kernel on a float32
        CUDA tensor), handed out as `_host_return` says: a `LazyHostArray`
        in float32 mode (which `transforms.istft` reads on the device), numpy
        in float64 mode. With ``return_device``, ``S`` is the cached tensor, a
        permuted view of the STFT's channels-first ``(C, frames, F)``
        tensor, which `transforms.istft` reads back without a copy; once it
        has been modified in place (a mask, say) the cache is stale: the next
        call computes ``S`` anew (torch's version counter of the tensor
        tells). Cached on the parameters and the data's versions."""
        p = self._spectrogram_parameters
        key = (tuple(sorted((k, str(v)) for k, v in p.items())), self._data_versions())
        entry = None if force_computation else self._cache.get("spectrogram")
        if entry is None or entry[0] != key or entry[3]._version != entry[4]:
            t, f, S = stft(
                self._x,
                sampling_rate_hz=self.sampling_rate_hz,
                window_length_samples=p["window_length_samples"],
                window_type=p["window_type"],
                overlap_percent=p["overlap_percent"],
                fft_length_samples=p["fft_length_samples"],
                detrend=p["detrend"],
                padding=p["padding"],
                scaling=p["scaling"],
            )
            # the JAX package's default (lazy) getter gives the frequencies
            # of the FFT length; its eager one, and `stft`, the window's
            f = rfft_freqs(p["fft_length_samples"] or p["window_length_samples"],
                           self.sampling_rate_hz)
            S = S.permute(2, 1, 0)
            entry = (key, t, f, S, S._version)
            self._cache["spectrogram"] = entry
        return entry[1].copy(), entry[2].copy(), _host_return(entry[3], return_device)

    def _get_power_spectrogram_device(self):
        """``(t, f, P (F, frames, C))``: ``|S|²`` of the cached STFT
        (`classes/signal.py:1361`), the input of the mel, MFCC and chroma
        projections. ``P`` is a permuted view of a channels-first
        ``(C, frames, F)`` tensor on the signal's device, cached as long as
        `get_spectrogram` serves the same ``S``.

        ``f`` is the grid of the FFT length, as `get_spectrogram` gives it;
        the JAX package's power spectrogram gives the window's, which with
        ``fft_length_samples > window_length_samples`` has fewer bins than
        ``P`` (its mel and MFCC projections then fail on the shapes, and
        its `chroma_stft` rebuilds the grid, `transforms.py:453-461`)."""
        t, f, S = self.get_spectrogram(return_device=True)
        entry = self._cache.get("spectrogram_power")
        if entry is None or entry[0] is not S or entry[1] != S._version:
            s_cf = S.permute(2, 1, 0)  # the STFT's (C, frames, F) tensor
            power = (s_cf.real.square() + s_cf.imag.square()).permute(2, 1, 0)
            entry = (S, S._version, power)
            self._cache["spectrogram_power"] = entry
        return t, f, entry[2]

    def _get_csm_device(self):
        """``(freqs, real (F, C, C), imag (F, C, C))``: the cached CSM split
        into real and imaginary views (`classes/signal.py:1166-1208`)."""
        f, csm = self._csm()
        return f.copy(), csm.real, csm.imag

    # ======== Plots =========================================================
    def _latency_delays(self, remove_ir_latency) -> np.ndarray:
        """Per-channel delays in samples for ``remove_ir_latency``: "peak",
        "min_phase" or the delays themselves (`classes/signal.py:1557`)."""
        from ..helpers.latency import fractional_latency, get_fractional_impulse_peak_index

        if not isinstance(remove_ir_latency, str):
            return np.atleast_1d(remove_ir_latency)
        mode = remove_ir_latency.lower()
        if mode == "peak":
            return get_fractional_impulse_peak_index(self.time_data, 1)
        if mode == "min_phase":
            from ..helpers.minimum_phase import min_phase_ir_from_real_cepstrum

            min_ir = min_phase_ir_from_real_cepstrum(self._x, 8).T[: len(self), :]
            return fractional_latency(self.time_data, min_ir, 1)
        raise ValueError("No valid latency removal")

    def _phase_without_latency(self, f, ph: np.ndarray, remove_ir_latency) -> np.ndarray:
        from ..helpers.latency import remove_ir_latency_from_phase

        delays = self._latency_delays(remove_ir_latency)
        return remove_ir_latency_from_phase(
            f, torch.as_tensor(ph), np.asarray(delays), self.sampling_rate_hz).numpy()

    def plot_magnitude(
        self,
        range_hz=[20.0, 20e3],
        normalize: MagnitudeNormalization = MagnitudeNormalization.NoNormalization,
        range_db=None,
        smoothing: int = 0,
        show_info_box: bool = False,
    ):
        """Magnitude spectrum per channel (`classes/signal.py:1412`)."""
        from ..helpers.spectrum_utilities import get_normalized_spectrum
        from ..plots import general_plot

        prior = self._spectrum_parameters["smoothing"]
        self._spectrum_parameters["smoothing"] = 0
        try:
            f, sp = self.get_spectrum(return_device=True)
        finally:
            self._spectrum_parameters["smoothing"] = prior
        f, mag_db = get_normalized_spectrum(
            f=f, spectra=sp, is_amplitude_scaling=self.spectrum_scaling.is_amplitude_scaling(),
            f_range_hz=range_hz, normalize=normalize, smoothing=smoothing, phase=False,
            calibrated_data=self.calibrated_signal,
        )
        txt = None
        if show_info_box:
            txt = (f"Info\nMode: {self._spectrum_parameters['method']}"
                   f"\nRange: {range_hz}\nNormalized: {normalize}\nSmoothing: {smoothing}")
        suffix = {
            MagnitudeNormalization.NoNormalization: "" if self.calibrated_signal else "FS",
            MagnitudeNormalization.OneKhz: " (normalized @ 1 kHz)",
            MagnitudeNormalization.OneKhzFirstChannel: " (normalized @ 1 kHz for first channel)",
            MagnitudeNormalization.Max: " (normalized @ peak)",
            MagnitudeNormalization.MaxFirstChannel: " (normalized @ peak for first channel)",
            MagnitudeNormalization.Energy: " (normalized with average energy)",
            MagnitudeNormalization.EnergyFirstChannel: (
                " (normalized with average energy of first channel)"),
        }[normalize]
        return general_plot(f, np.asarray(mag_db), range_hz, range_y=range_db,
                            ylabel="Magnitude / dB" + suffix, info_box=txt,
                            labels=[f"Channel {n}" for n in range(self.number_of_channels)])

    def plot_time(self):
        """The waveform of each channel (`classes/signal.py:1471`)."""
        from ..plots import general_subplots_line

        td = self.time_data.cpu().numpy()
        fig, ax = general_subplots_line(
            self.time_vector_s, td, sharex=True,
            ylabels=[f"Channel {n}" for n in range(self.number_of_channels)],
            xlabels="Time / s",
        )
        td_im = self.time_data_imaginary
        td_im = None if td_im is None else td_im.cpu().numpy()
        for n in range(self.number_of_channels):
            mx = np.max(np.abs(td[:, n])) * 1.1 if td.size else 1.0
            if td_im is not None:
                ax[n].plot(self.time_vector_s, td_im[:, n], alpha=0.9, linestyle="dotted")
            if mx > 0:
                ax[n].set_ylim([-mx, mx])
        return fig, ax

    def plot_spl(self, normalize_at_peak: bool = False,
                 dynamic_range_db: float | None = 100.0, window_length_s: float = 0.0):
        """Momentary level per channel in dBFS, or dB SPL for a calibrated
        signal (`classes/signal.py:1494`). The power and its smoothing
        (`helpers.smoothing.time_smoothing`, B2 on a float32 CUDA tensor)
        run on the device; the levels come to numpy at the plot."""
        from ..helpers.gain_and_level import to_db
        from ..helpers.smoothing import time_smoothing
        from ..plots import general_subplots_line

        p0 = 20e-6 if self.calibrated_signal and not normalize_at_peak else 1.0
        x = self._x / p0
        if normalize_at_peak:
            x = x / x.abs().max()
        power = x**2
        if window_length_s > 0:
            power = time_smoothing(power, self.sampling_rate_hz, window_length_s)
        spl = to_db(power.T, False).cpu().numpy()
        if dynamic_range_db is not None:
            spl = np.clip(spl, np.max(spl) - abs(dynamic_range_db), None)
        unit = "dBFS" if not self.calibrated_signal or normalize_at_peak else "dB SPL"
        return general_subplots_line(
            self.time_vector_s, spl, sharex=True,
            ylabels=[f"Channel {n} / {unit}" for n in range(self.number_of_channels)],
            xlabels="Time / s",
        )

    def plot_group_delay(self, range_hz=[20.0, 20e3], smoothing: int = 0,
                         remove_ir_latency=None):
        """Group delay −dφ/dω of the unpadded FFT spectrum
        (`classes/signal.py:1536`); ``remove_ir_latency``: None, "peak",
        "min_phase" or per-channel delays in samples."""
        from ..plots import general_plot
        from ..standard.backend import group_delay_direct

        prior = self._spectrum_parameters.copy()
        self.set_spectrum_parameters(method=SpectrumMethod.FFT,
                                     scaling=SpectrumScaling.FFTBackward,
                                     pad_to_fast_length=False)
        try:
            f, sp = self.get_spectrum(return_device=True)
        finally:
            self._spectrum_parameters = prior
        ph = sp.angle().cpu().numpy()
        if ph.ndim == 1:
            ph = ph[:, None]
        if remove_ir_latency is not None:
            ph = self._phase_without_latency(f, ph, remove_ir_latency)
        gd = group_delay_direct(torch.as_tensor(ph), f[1] - f[0], axis=0)
        if smoothing != 0:
            gd = fractional_octave_smoothing(gd, None, smoothing)
        return general_plot(f, gd.numpy() * 1e3, range_hz, ylabel="Group delay / ms",
                            labels=[f"Channel {n}" for n in range(self.number_of_channels)])

    def plot_spectrogram(self, channel_number: int = 0, log_freqs: bool = True,
                         dynamic_range_db=50):
        """Spectrogram of one channel (`classes/signal.py:1610`)."""
        from ..plots import general_matrix_plot

        t, f, S = self.get_spectrogram(return_device=True)
        mag = S[..., channel_number].abs().cpu().numpy()
        mag_db = 20 * np.log10(mag + np.finfo(np.float64).eps)
        return general_matrix_plot(
            mag_db, range_x=(t[0], t[-1]), range_y=(max(f[0], 1.0), f[-1]),
            range_z=dynamic_range_db, xlabel="Time / s", ylabel="Frequency / Hz",
            zlabel="Magnitude / dB", ylog=log_freqs,
        )

    def plot_phase(self, range_hz=[20.0, 20e3], unwrap: bool = False, smoothing: int = 0,
                   remove_ir_latency=None):
        """Phase of the FFT spectrum (`classes/signal.py:1633`);
        ``remove_ir_latency`` as in `plot_group_delay`."""
        from ..plots import general_plot

        assert self.spectrum_method == SpectrumMethod.FFT, (
            "Phase cannot be plotted since the spectrum is not complex. Set "
            "the spectrum method to FFT"
        )
        prior = self._spectrum_parameters["smoothing"]
        self._spectrum_parameters["smoothing"] = 0
        try:
            f, sp = self.get_spectrum(return_device=True)
        finally:
            self._spectrum_parameters["smoothing"] = prior
        ph = sp.angle().cpu().numpy()
        if remove_ir_latency is not None:
            ph = self._phase_without_latency(f, ph, remove_ir_latency)
        if smoothing != 0:
            ph = fractional_octave_smoothing(
                torch.as_tensor(np.unwrap(ph, axis=0)), None, smoothing).numpy()
            ph = (ph + np.pi) % (2 * np.pi) - np.pi
        if unwrap:
            ph = np.unwrap(ph, axis=0)
        return general_plot(f, np.asarray(ph), range_hz, ylabel="Phase / rad",
                            labels=[f"Channel {n}" for n in range(self.number_of_channels)])

    def plot_csm(self, range_hz=[20.0, 20e3], with_phase=True):
        """The CSM's lower triangle (`classes/signal.py:1714`)."""
        from ._plots import csm_plot

        f, csm = self._csm()
        return csm_plot(f, csm, range_hz, True, with_phase)

    # ======== Saving / copying ==============================================
    def save_signal(self, path: str, mode: str = "wav", bit_depth: int = 32):
        """Save as WAV (16, 24, 32 float or 64 float bits), FLAC (8, 16 or
        24 bits; other depths take 24) or a pickle
        (`classes/signal.py:1723`). The samples are read back from the
        device once."""
        mode = mode.lower()
        path = check_format_in_path(path, mode)
        if mode == "wav":
            from ..io import write_wav

            subtype = {16: "PCM_16", 24: "PCM_24", 32: "FLOAT", 64: "DOUBLE"}.get(bit_depth)
            if subtype is None:
                raise ValueError(
                    "Selected bit depth is not valid. Use either 16, 24, 32 or 64"
                )
            write_wav(path, self.time_data.cpu().numpy(), self.sampling_rate_hz, subtype)
        elif mode == "flac":
            from ..io.flac import write_flac

            bits = bit_depth if bit_depth in (8, 16, 24) else 24
            write_flac(path, self.time_data.cpu().numpy(), self.sampling_rate_hz, bits)
        elif mode == "pkl":
            with open(path, "wb") as data_file:
                dump(self, data_file, HIGHEST_PROTOCOL)
        else:
            raise ValueError(f"{mode} is not a supported saving mode. Use wav, flac or pkl")
        return self

    def __getstate__(self):
        """Pickle without the caches (they are rebuilt on demand)."""
        d = dict(self.__dict__)
        d["_cache"] = {}
        return d

    def copy(self) -> "Signal":
        """A deep copy: the tensors are copied on their device."""
        return deepcopy(self)

    def copy_with_new_time_data(self, new_time_data) -> "Signal":
        """A signal with this one's settings and new time data
        (`classes/signal.py:1805`): numpy data (to this signal's device), a
        real or complex tensor, or a `DeviceTimeData` / ``(real, imag)``
        pair of tensors, which the signal keeps as they are (views stay
        views)."""
        new_signal = Signal(
            None, new_time_data, self.sampling_rate_hz,
            self.constrain_amplitude, device=self.device,
        )
        new_signal.activate_cache = self.activate_cache
        new_signal.calibrated_signal = self.calibrated_signal
        new_signal._spectrum_parameters = dict(self._spectrum_parameters)
        new_signal._spectrogram_parameters = dict(self._spectrogram_parameters)
        return new_signal

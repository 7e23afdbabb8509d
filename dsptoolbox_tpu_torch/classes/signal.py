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

Not ported yet: reading audio files (``path``), the lazy/deferred host
returns and the device-spectrum caches of a tunnelled backend, plots, the
mesh-parallel CSM, and FFT spectra with ``smoothing != 0`` or a
physical-unit scaling (they raise `NotImplementedError`).
"""

from __future__ import annotations

from copy import deepcopy
from functools import lru_cache
from typing import NamedTuple
from warnings import warn

import numpy as np
import torch

from .._config import default_complex, default_device, default_float
from ..ops.fft_conv import next_fast_len
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import csm_from_spectrum, csm_welch, stft, welch
from .._enums import SpectrumMethod, SpectrumScaling, Window


class DeviceTimeData(NamedTuple):
    """Time data given as a ``(real, imag)`` pair of ``(T, C)`` tensors
    (``imag`` None for a real signal), e.g. one band of a filter bank's
    output planes: the signal keeps views of them. ``peak``, when given, is
    ``max(|real|, |imag|)``, computed beforehand (a filter bank reduces the
    peaks of all its bands at once), so the amplitude constraint needs no
    reduction of its own."""

    real: torch.Tensor
    imag: torch.Tensor | None = None
    peak: float | None = None


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
        """``device``: where numpy ``time_data`` goes (default:
        `_config.default_device()`); a tensor keeps its own device."""
        if path is not None:
            raise NotImplementedError(
                "reading audio files is not ported yet; pass time_data"
            )
        assert time_data is not None, (
            "Either a path to an audio file or a time vector has to be "
            "passed"
        )
        assert sampling_rate_hz is not None, "A sampling rate should be passed!"
        self.constrain_amplitude = constrain_amplitude
        self.activate_cache = activate_cache
        self._cache: dict = {}
        self._numpy_device = default_device() if device is None else device
        self.sampling_rate_hz = sampling_rate_hz
        self.time_data = time_data
        self.set_spectrum_parameters()
        self.set_spectrogram_parameters()

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
        the signal's device); writing into the view bypasses the CSM
        cache."""
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
        if self.constrain_amplitude:
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
        """Append channels from time data ``(T, C)`` (numpy or a tensor),
        padded or trimmed at the end to this signal's length, in place
        (`classes/signal.py:725`). Reading a file is not ported yet."""
        if path is not None:
            raise NotImplementedError(
                "reading audio files is not ported yet; pass new_time_data"
            )
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
        if p["smoothing"] != 0:
            raise NotImplementedError(
                "spectrum smoothing (helpers/smoothing.py) is not ported yet"
            )
        if self.spectrum_scaling.has_physical_units():
            raise NotImplementedError(
                "physical-unit FFT scalings (spectrum_utilities.scale_spectrum) "
                "are not ported yet"
            )
        n = (
            next_fast_len(self.length_samples, True)
            if p["pad_to_fast_length"]
            else self.length_samples
        )
        sp = torch.fft.rfft(self._x, n=n, dim=-1,
                            norm=self.spectrum_scaling.fft_norm())
        return rfft_freqs(n, self.sampling_rate_hz), sp

    def get_spectrum(self, force_computation: bool = False):
        """``(freqs, spectrum)`` per the spectrum parameters
        (`classes/signal.py:865-947`), on the data's device: the FFT method
        gives a complex ``(F, C)`` spectrum; Welch a real one, ``(F,)`` for
        a mono signal (parity: the reference's ``_welch`` squeezes its
        input, `classes/signal.py:928-932`). Not cached, so
        ``force_computation`` (the reference's cache switch) changes
        nothing."""
        if self.spectrum_method == SpectrumMethod.FFT:
            f, sp = self._spectrum_fft()
            return f.copy(), sp.T
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
        return rfft_freqs(p["window_length_samples"], self.sampling_rate_hz).copy(), sp

    def _spectrum_param_key(self) -> tuple:
        """Cache key of the CSM: the spectrum parameters (the cache is
        cleared whenever the time data or sampling rate change)."""
        return tuple(sorted((k, str(v)) for k, v in self._spectrum_parameters.items()))

    # ======== Cross-spectral matrix =========================================
    def get_csm(self, force_computation: bool = False):
        """``(freqs, csm (F, C, C))``: the Welch cross-spectral matrix as a
        complex tensor on the signal's device (`classes/signal.py:1030-1126`).
        Cached on the spectrum parameters; the returned tensor is the cached
        one."""
        assert self.number_of_channels > 1, (
            "Cross spectral matrix can only be computed when at least two "
            "channels are available"
        )
        if force_computation:
            self._cache.pop("csm", None)
        f, csm = self._csm()
        return f.copy(), csm

    def _csm(self):
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
    def get_spectrogram(self, force_computation: bool = False):
        """``(t, f, S (F, frames, C))``: the complex STFT per the
        spectrogram parameters (`classes/signal.py:1210`), on the signal's
        device through `ops.spectral.stft` (the framing kernel on a float32
        CUDA tensor). ``S`` is a permuted view of the STFT's channels-first
        ``(C, frames, F)`` tensor, which `transforms.istft` reads back
        without a copy. Cached on the parameters; the returned tensor is the
        cached one, and once it has been modified in place (a mask, say) the
        cache is stale: the next call computes ``S`` anew (torch's version
        counter of the tensor tells)."""
        p = self._spectrogram_parameters
        key = tuple(sorted((k, str(v)) for k, v in p.items()))
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
        return entry[1].copy(), entry[2].copy(), entry[3]

    def _get_csm_device(self):
        """``(freqs, real (F, C, C), imag (F, C, C))``: the cached CSM split
        into real and imaginary views (`classes/signal.py:1166-1208`)."""
        f, csm = self._csm()
        return f.copy(), csm.real, csm.imag

    # ======== Copies ========================================================
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
        new_signal._spectrum_parameters = dict(self._spectrum_parameters)
        new_signal._spectrogram_parameters = dict(self._spectrogram_parameters)
        return new_signal

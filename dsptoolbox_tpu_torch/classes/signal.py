"""Signal: the multichannel time-series container (`dsptoolbox_tpu/classes/signal.py`).

A thin port: what the beamforming and transfer-function paths need. A
tensor keeps its device; numpy data goes to the ``device`` given or, without
one, to `_config.default_device()` ("cuda" unless changed). The data is
stored channels-first ``(C, T)`` in the package's default float; the public
``time_data`` keeps the JAX package's ``(T, C)`` layout. The Welch CSM runs
through `ops.spectral.csm_welch` (the framing kernel on a float32 CUDA
tensor) and is cached on the spectrum parameters; `get_spectrum` computes
the FFT (backward-normalised ``rfft``) or Welch spectrum on the data's
device.

Not ported yet: reading audio files (``path``), the lazy/deferred host
returns and the device-spectrum caches of a tunnelled backend, plots, the
mesh-parallel CSM, the FFT-method CSM, spectrogram getters, and FFT spectra
with ``smoothing != 0`` or a physical-unit scaling (they raise
`NotImplementedError`).
"""

from __future__ import annotations

from copy import deepcopy
from functools import lru_cache
from warnings import warn

import numpy as np
import torch

from .._config import default_complex, default_device, default_float
from ..ops.fft_conv import next_fast_len
from ..ops.spectral import csm_welch, welch
from ..standard.enums import SpectrumMethod, SpectrumScaling, Window


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

    @time_data.setter
    def time_data(self, new_time_data):
        # the checks of the reference setter (`classes/signal.py:456-506`)
        if not isinstance(new_time_data, torch.Tensor):
            arr = np.ascontiguousarray(np.asarray(new_time_data))
            dev = self._x.device if hasattr(self, "_x") else self._numpy_device
            dt = default_complex() if np.iscomplexobj(arr) else default_float()
            new_time_data = torch.as_tensor(arr).to(device=dev, dtype=dt)
        td = torch.atleast_2d(new_time_data).squeeze()
        assert td.ndim <= 2, (
            f"{td.ndim} are too many dimensions for time data. Dimensions "
            "should be [time samples, channels]"
        )
        if td.ndim < 2:
            td = td[..., None]
        if td.shape[1] > td.shape[0]:
            td = td.T
        if td.is_complex():
            td, td_imag = td.real, td.imag
        else:
            td_imag = None
        self._amplitude_scale_factor = 1.0
        if self.constrain_amplitude:
            td_max = float(td.abs().max())
            if td_imag is not None:
                td_max = max(td_max, float(td_imag.abs().max()))
            if td_max > 1.0:
                td = td / td_max
                if td_imag is not None:
                    td_imag = td_imag / td_max
                warn(
                    "Signal was over 0 dBFS, normalizing to 0 dBFS "
                    "peak level was triggered"
                )
                self._amplitude_scale_factor = 1.0 / td_max
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

    def get_spectrum(self):
        """``(freqs, spectrum)`` per the spectrum parameters
        (`classes/signal.py:865-947`), on the data's device: the FFT method
        gives a complex ``(F, C)`` spectrum; Welch a real one, ``(F,)`` for
        a mono signal (parity: the reference's ``_welch`` squeezes its
        input, `classes/signal.py:928-932`). Not cached."""
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
        if self.spectrum_method != SpectrumMethod.WelchPeriodogram:
            raise NotImplementedError(
                "only the Welch CSM is ported; the FFT-method CSM comes "
                "with the Spectrum class"
            )
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
        (`classes/signal.py:1805`); numpy data goes to this signal's
        device."""
        new_signal = Signal(
            None, new_time_data, self.sampling_rate_hz,
            self.constrain_amplitude, device=self.device,
        )
        new_signal.activate_cache = self.activate_cache
        new_signal._spectrum_parameters = dict(self._spectrum_parameters)
        return new_signal

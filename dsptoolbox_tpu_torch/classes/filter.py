"""Filter: an LTI digital filter in zpk / SOS / ba representation
(`dsptoolbox_tpu/classes/filter.py`).

Designs and conversions are host numpy/scipy; `filter_signal` and
`filter_and_resample_signal` run on the signal's device through
`filter_helpers`, `ops.iir` and `ops.fft_conv`. The plots draw on `plots`;
`save_filter` pickles.
"""

from __future__ import annotations

from copy import deepcopy
from fractions import Fraction
from pickle import HIGHEST_PROTOCOL, dump
from warnings import warn

import numpy as np
import scipy.signal as sig
import torch

from .._enums import (
    BiquadEqType,
    FilterCoefficientsType,
    FilterPassType,
    IirDesignMethod,
    Window,
)
from ..helpers.other import check_format_in_path
from .filter_helpers import (
    biquad_coefficients,
    filter_on_signal,
    filter_on_signal_ba,
    group_delay_filter,
    impulse,
)
from .impulse_response import ImpulseResponse
from .signal import Signal


class Filter:
    """Digital filter with static coefficients."""

    def __init__(self, filter_coefficients: dict, sampling_rate_hz: int):
        """Build from a dict with exactly one of the `FilterCoefficientsType`
        keys (`classes/filter.py:40`)."""
        self.warning_if_complex = True
        self.sampling_rate_hz = sampling_rate_hz
        keys = [k for k in FilterCoefficientsType if k in filter_coefficients]
        assert len(keys) == 1, (
            "Only (and at least) one type of filter coefficients should be "
            "passed to create a filter"
        )
        if keys[0] == FilterCoefficientsType.Zpk:
            self.zpk = list(filter_coefficients[FilterCoefficientsType.Zpk])
            self.sos = sig.zpk2sos(*self.zpk, analog=False)
        elif keys[0] == FilterCoefficientsType.Sos:
            self.sos = np.atleast_2d(np.asarray(filter_coefficients[FilterCoefficientsType.Sos]))
        else:
            b, a = filter_coefficients[FilterCoefficientsType.Ba]
            self.ba = [np.atleast_1d(b), np.atleast_1d(a)]

    # ======== Designers =====================================================
    @staticmethod
    def iir_filter(
        order: int,
        frequency_hz,
        type_of_pass: FilterPassType,
        sampling_rate_hz: int,
        filter_design_method: IirDesignMethod = IirDesignMethod.Butterworth,
        passband_ripple_db: float | None = None,
        stopband_attenuation_db: float | None = None,
    ) -> "Filter":
        """IIR design with ``scipy.signal.iirfilter`` (`classes/filter.py:62`)."""
        zpk = sig.iirfilter(
            N=order,
            Wn=frequency_hz,
            btype=type_of_pass.to_str(),
            analog=False,
            fs=sampling_rate_hz,
            ftype=filter_design_method.to_scipy_str(),
            rp=passband_ripple_db,
            rs=stopband_attenuation_db,
            output="zpk",
        )
        return Filter({FilterCoefficientsType.Zpk: zpk}, sampling_rate_hz)

    @staticmethod
    def biquad(
        eq_type: BiquadEqType,
        frequency_hz: float,
        gain_db: float,
        q: float,
        sampling_rate_hz: int,
    ) -> "Filter":
        """RBJ-cookbook biquad as ``ba`` (`classes/filter.py:88`)."""
        return Filter(
            {
                FilterCoefficientsType.Ba: biquad_coefficients(
                    eq_type=eq_type,
                    frequency_hz=frequency_hz,
                    gain_db=gain_db,
                    q=q,
                    fs_hz=sampling_rate_hz,
                )
            },
            sampling_rate_hz,
        )

    @staticmethod
    def fir_filter(
        order: int,
        frequency_hz,
        type_of_pass: FilterPassType,
        sampling_rate_hz: int,
        window: Window = Window.Hamming,
    ) -> "Filter":
        """Windowed FIR design with ``scipy.signal.firwin``
        (`classes/filter.py:107`)."""
        return Filter(
            {
                FilterCoefficientsType.Ba: [
                    sig.firwin(
                        numtaps=order + 1,
                        cutoff=frequency_hz,
                        window=(window if window is not None else Window.Hamming).to_scipy_format(),
                        pass_zero=type_of_pass.to_str(),
                        fs=sampling_rate_hz,
                    ),
                    np.asarray([1.0]),
                ]
            },
            sampling_rate_hz,
        )

    @staticmethod
    def fir_from_file(path: str, channel: int = 0) -> "Filter":
        """An FIR whose taps are one channel of a WAV or FLAC file."""
        from .impulse_response import ImpulseResponse

        ir = ImpulseResponse.from_file(path)
        return Filter.from_ba(ir.time_data[:, channel].cpu().numpy(), [1.0], ir.sampling_rate_hz)

    @staticmethod
    def from_ba(b, a, sampling_rate_hz: int) -> "Filter":
        return Filter({FilterCoefficientsType.Ba: [b, a]}, sampling_rate_hz)

    @staticmethod
    def from_sos(sos, sampling_rate_hz: int) -> "Filter":
        return Filter({FilterCoefficientsType.Sos: sos}, sampling_rate_hz)

    @staticmethod
    def from_zpk(z, p, k, sampling_rate_hz: int) -> "Filter":
        return Filter({FilterCoefficientsType.Zpk: [z, p, k]}, sampling_rate_hz)

    # ======== State =========================================================
    def initialize_zi(self, number_of_channels: int = 1) -> "Filter":
        """Per-channel steady-state initial states (``sosfilt_zi`` /
        ``lfilter_zi``), as the reference seeds them."""
        assert number_of_channels > 0, "Zi's have to be initialized for at least one channel"
        zi0 = (sig.sosfilt_zi(self.sos) if self.has_sos
               else sig.lfilter_zi(self.ba[0], self.ba[1]))
        self.zi = [zi0.copy() for _ in range(number_of_channels)]
        self._zi_cascade = None
        return self

    # ======== Properties ====================================================
    @property
    def sampling_rate_hz(self) -> int:
        return self.__sampling_rate_hz

    @sampling_rate_hz.setter
    def sampling_rate_hz(self, new_sampling_rate_hz):
        assert new_sampling_rate_hz is not None
        self.__sampling_rate_hz = int(new_sampling_rate_hz)

    @property
    def warning_if_complex(self) -> bool:
        return self.__warning_if_complex

    @warning_if_complex.setter
    def warning_if_complex(self, new_warning):
        assert isinstance(new_warning, bool)
        self.__warning_if_complex = new_warning

    @property
    def sos(self) -> np.ndarray:
        """Second-order sections ``(n_sections, 6)``; AttributeError when
        the filter has no SOS representation."""
        return self.__sos

    @sos.setter
    def sos(self, sos):
        sos = np.atleast_2d(np.asarray(sos))
        assert sos.ndim == 2 and sos.shape[1] == 6
        self.__sos = sos

    @property
    def zpk(self) -> list:
        """``[zeros, poles, gain]``."""
        return self.__zpk

    @zpk.setter
    def zpk(self, new_zpk):
        self.__zpk = list(new_zpk)

    @property
    def ba(self) -> list:
        return self.__ba

    @ba.setter
    def ba(self, new_ba):
        ba = list(new_ba)
        assert len(ba) == 2, "ba coefficients must be a list of length two"
        for ind in range(2):
            coeff = np.atleast_1d(ba[ind])
            assert coeff.ndim == 1
            dtype = (np.complex128 if np.issubdtype(coeff.dtype, np.complexfloating)
                     else np.float64)
            ba[ind] = coeff.astype(dtype)
        b, a = ba
        a = np.atleast_1d(np.trim_zeros(a.copy(), "b"))
        self.__ba = [b / a[0], a / a[0]] if len(a) == 1 else ba

    @property
    def has_sos(self) -> bool:
        return hasattr(self, "sos")

    @property
    def has_zpk(self) -> bool:
        return hasattr(self, "zpk")

    @property
    def is_iir(self) -> bool:
        if self.has_sos:
            return True
        a = self.ba[1]
        return not (len(a) == 1 and a[0] == 1.0)

    @property
    def is_fir(self) -> bool:
        return not self.is_iir

    @property
    def order(self) -> int:
        if self.has_zpk:
            return max(len(self.zpk[0]), len(self.zpk[1]))
        if self.has_sos:
            n_first_order = int(np.sum((self.sos[:, 2] == 0.0) & (self.sos[:, 5] == 0.0)))
            return self.sos.shape[0] * 2 - n_first_order
        return max(len(self.ba[0]), len(self.ba[1])) - 1

    def __len__(self):
        return self.order + 1

    def __str__(self):
        return self.metadata_str

    @property
    def metadata(self) -> dict:
        return {
            "filter_type": "iir" if self.is_iir else "fir",
            "sampling_rate_hz": self.sampling_rate_hz,
            "order": self.order,
        }

    @property
    def metadata_str(self) -> str:
        txt = "\n"
        for k, v in self.metadata.items():
            txt += f"{str(k).replace('_', ' ').capitalize()}: {v}\n"
        return txt

    def show_info(self):
        print(self.metadata_str)

    # ======== Filtering =====================================================
    def filter_signal(
        self,
        signal: Signal,
        channels=None,
        activate_zi: bool = False,
        zero_phase: bool = False,
    ) -> Signal:
        """Filter (selected channels of) a Signal on its device
        (`classes/filter.py:296`)."""
        assert self.sampling_rate_hz == signal.sampling_rate_hz, "Sampling rates do not match"
        assert not (activate_zi and zero_phase), (
            "Filter initial and final values cannot be updated when filtering "
            "with zero-phase"
        )
        if channels is None:
            channels = np.arange(signal.number_of_channels)
        else:
            channels = np.atleast_1d(np.squeeze(channels))
            assert channels.ndim == 1, "channels can be only a 1D-array or an int"
            assert all(channels < signal.number_of_channels), (
                f"Selected channels ({channels}) are not valid for the signal with "
                f"{signal.number_of_channels} channels"
            )
        zi_old = None
        if activate_zi:
            if not hasattr(self, "zi") or len(self.zi) != signal.number_of_channels:
                if hasattr(self, "zi"):
                    warn("zi values of the filter have not been correctly intialized "
                         "for the number of channels. They have now been corrected")
                self.initialize_zi(signal.number_of_channels)
            zi_old = self.zi
        if self.order > signal.length_samples:
            warn("Filter is longer than signal, results might be meaningless!")
        if self.has_sos:
            new_signal, zi_new = filter_on_signal(
                signal, self.sos, channels=channels, zi=zi_old, zero_phase=zero_phase,
                warning_on_complex_output=self.warning_if_complex,
            )
        else:
            new_signal, zi_new, kept = filter_on_signal_ba(
                signal, self.ba, channels=channels, zi=zi_old, zero_phase=zero_phase,
                is_fir=self.is_fir, warning_on_complex_output=self.warning_if_complex,
                kept=getattr(self, "_zi_cascade", None),
            )
            if activate_zi:
                # the exact cascade states behind ``zi`` (`_cascade_update`)
                self._zi_cascade = kept
        if activate_zi:
            self.zi = zi_new
        return new_signal

    def filter_and_resample_signal(self, signal: Signal, new_sampling_rate_hz: int) -> Signal:
        """The filter as a decimator or interpolator
        (`classes/filter.py:745`), on the signal's device: an FIR through
        its polyphase branches (one batched FFT convolution), an IIR by
        `ops.iir.lfilter` and then subsampling, or after zero stuffing."""
        from ..helpers.polyphase import polyphase_decomposition
        from ..ops.fft_conv import fft_convolve
        from ..ops.iir import lfilter

        frac = Fraction(new_sampling_rate_hz, signal.sampling_rate_hz).as_integer_ratio()
        assert frac[0] == 1 or frac[1] == 1, (
            f"{new_sampling_rate_hz} is not valid because it needs down- "
            f"AND upsampling (Up/Down: {frac[0]}/{frac[1]})"
        )
        x = signal._x  # (C, T)
        if self.is_iir and not hasattr(self, "ba"):
            self.ba = list(sig.sos2tf(self.sos))
        if frac[0] == 1:  # downsampling
            assert signal.sampling_rate_hz == self.sampling_rate_hz, "Sampling rates do not match"
            down = frac[1]
            if self.is_fir:
                # polyphase decimator (`classes/filter_helpers.py:505-567`):
                # front-padded components, flipped filter branches, one
                # batched convolution, the group delay trimmed
                b = self.ba[0]
                half_length = (len(b) - 1) // 2
                poly, _ = polyphase_decomposition(x.T, down, flip=False)  # (Tp, n, C)
                b_poly, _ = polyphase_decomposition(
                    torch.as_tensor(b, dtype=x.dtype, device=x.device), down, flip=True)
                conv = fft_convolve(poly.permute(2, 1, 0), b_poly[:, :, 0].T)  # (C, n, ·)
                y_full = conv.sum(dim=1)
                # parity: the reference's end index is (-hl) // down
                # (`classes/filter_helpers.py:559-561`)
                end = (-half_length) // down
                y = y_full[:, half_length // down: end or None]
            else:
                y = lfilter(self.ba[0], self.ba[1], x)[0][..., ::down]
        else:  # upsampling
            up = frac[0]
            assert signal.sampling_rate_hz * up == self.sampling_rate_hz, (
                "Sampling rates do not match. For the upsampler, the "
                "sampling rate of the filter should match the output's"
            )
            if self.is_fir:
                # polyphase interpolator (`classes/filter_helpers.py:570-652`)
                b = self.ba[0]
                half_length = (len(b) - 1) // 2
                b_poly, padding = polyphase_decomposition(
                    torch.as_tensor(b, dtype=x.dtype, device=x.device), up)
                conv = fft_convolve(x[:, None, :], (b_poly * up)[:, :, 0].T)  # (C, up, ·)
                y_full = conv.transpose(1, 2).reshape(x.shape[0], -1)
                if padding == up:
                    y = y_full[:, half_length:-half_length]
                else:
                    y = y_full[:, half_length + padding: -half_length + padding]
            else:
                T = x.shape[-1]
                z = x.new_zeros(x.shape + (up,))
                # zero stuffing loses 1/up of the energy; the reference
                # multiplies by up (`classes/filter_helpers.py:641-642`)
                z[..., 0] = x * up
                y = lfilter(self.ba[0], self.ba[1], z.reshape(x.shape[0], T * up))[0]
        new_sig = signal.copy_with_new_time_data(y.T)
        new_sig.sampling_rate_hz = new_sampling_rate_hz
        return new_sig

    # ======== Getters =======================================================
    def get_coefficients(self, coefficients_mode: FilterCoefficientsType):
        """Coefficients in the requested representation, host scipy
        (`classes/filter.py:522`)."""
        if coefficients_mode == FilterCoefficientsType.Sos:
            if self.has_sos:
                return self.sos.copy()
            if self.order > 500:
                warn("Order is above 500. Computing SOS might take a long time")
            return sig.tf2sos(self.ba[0], self.ba[1])
        if coefficients_mode == FilterCoefficientsType.Ba:
            if self.has_sos:
                return list(sig.sos2tf(self.sos))
            return deepcopy(self.ba)
        if coefficients_mode == FilterCoefficientsType.Zpk:
            if self.has_zpk:
                return tuple(deepcopy(self.zpk))
            if self.has_sos:
                return sig.sos2zpk(self.sos)
            if self.order > 500:
                warn("Order is above 500. Computing zpk might take a long time")
            return sig.tf2zpk(self.ba[0], self.ba[1])
        raise ValueError(f"{coefficients_mode} is not valid. Use sos, ba or zpk")

    def copy(self) -> "Filter":
        return deepcopy(self)

    # ======== Plots and saving ==============================================
    def _info_text(self, ax):
        target = ax[0] if np.ndim(ax) else ax
        target.text(0.1, 0.5, self.metadata_str, transform=target.transAxes,
                    verticalalignment="top",
                    bbox=dict(boxstyle="round", facecolor="grey", alpha=0.75))

    def plot_magnitude(self, length_samples: int = 512, range_hz=[20, 20e3], normalize=None,
                       zero_phase: bool = False, show_info_box: bool = True):
        """Magnitude response through the filter's IR
        (`classes/filter.py:973`)."""
        from .._enums import MagnitudeNormalization

        ir = self.get_ir(length_samples, zero_phase=zero_phase)
        if normalize is None:
            normalize = MagnitudeNormalization.NoNormalization
        fig, ax = ir.plot_magnitude(range_hz=range_hz, normalize=normalize, show_info_box=False)
        if show_info_box:
            self._info_text(ax)
        return fig, ax

    def plot_taps(self, show_info_box: bool = False, in_db: bool = False):
        """The taps of an FIR; an IIR raises (`classes/filter.py:1207`)."""
        from ..helpers.gain_and_level import to_db
        from ..plots import general_plot

        assert self.is_fir, "Plotting taps is only valid for FIR filters"
        taps = np.asarray(self.ba[0])
        t = np.arange(0, len(taps)) / self.sampling_rate_hz
        y = to_db(taps, True) if in_db else taps
        return general_plot(t, y[:, None], log_x=False, xlabel="Time / s",
                            ylabel="Taps / dBFS" if in_db else "Taps",
                            info_box=self.metadata_str if show_info_box else None)

    def plot_group_delay(self, length_samples: int = 512, range_hz=[20, 20e3],
                         show_info_box: bool = False):
        """Group delay from the coefficients, host float64
        (`classes/filter.py:1034`)."""
        from ..plots import general_plot

        ba = self.get_coefficients(FilterCoefficientsType.Ba)
        f, gd = group_delay_filter(ba, length_samples, self.sampling_rate_hz)
        return general_plot(f[1:], (gd[1:] * 1e3)[:, None], range_hz,
                            ylabel="Group delay / ms",
                            info_box=self.metadata_str if show_info_box else None)

    def plot_phase(self, length_samples: int = 512, range_hz=[20, 20e3], unwrap: bool = False,
                   show_info_box: bool = False):
        """Phase response through the filter's IR (`classes/filter.py:1104`)."""
        ir = self.get_ir(length_samples)
        fig, ax = ir.plot_phase(range_hz=range_hz, unwrap=unwrap)
        if show_info_box:
            self._info_text(ax)
        return fig, ax

    def plot_zp(self, show_info_box: bool = False):
        """Zeros and poles on the unit circle (`classes/filter.py:1161`)."""
        from ._plots import zp_plot

        z, p, k = self.get_coefficients(FilterCoefficientsType.Zpk)
        return zp_plot(z, p, self.metadata_str if show_info_box else None)

    def save_filter(self, path: str):
        """Pickle the filter (`classes/filter.py:1242`)."""
        path = check_format_in_path(path, "pkl")
        with open(path, "wb") as data_file:
            dump(self, data_file, HIGHEST_PROTOCOL)
        return self

    def get_ir(self, length_samples: int, zero_phase: bool = False, device=None):
        """Impulse response of the filter (`classes/filter.py:461`), on
        ``device`` (default: `_config.default_device()`)."""
        if self.is_fir and not zero_phase:
            b = self.ba[0].copy()
            if length_samples < len(b):
                warn(f"{length_samples} is not enough for filter with length {len(b)}. "
                     "IR will have the latter length.")
                length_samples = len(b)
            b = np.pad(b, (0, length_samples - len(b)))
            return ImpulseResponse(None, b, self.sampling_rate_hz,
                                   constrain_amplitude=False, device=device)
        ir_filt = ImpulseResponse(None, impulse(length_samples), self.sampling_rate_hz,
                                  constrain_amplitude=False, device=device)
        return self.filter_signal(ir_filt, zero_phase=zero_phase)

    def get_group_delay(
        self, frequency_vector_hz: np.ndarray, in_seconds: bool = True
    ) -> np.ndarray:
        """Group delay at the given frequencies, host scipy
        (`classes/filter.py:512`)."""
        ba = self.get_coefficients(FilterCoefficientsType.Ba)
        gd = sig.group_delay(ba, w=frequency_vector_hz, fs=self.sampling_rate_hz)[1]
        return gd / self.sampling_rate_hz if in_seconds else gd

    def get_transfer_function(self, frequency_vector_hz: np.ndarray) -> np.ndarray:
        """Complex transfer function at the given frequencies, host scipy
        (`classes/filter.py:491`)."""
        assert frequency_vector_hz.ndim == 1, "Frequency vector can only have one dimension"
        assert frequency_vector_hz.max() <= self.sampling_rate_hz / 2, (
            "Queried frequency vector has values larger than nyquist"
        )
        if self.is_iir and self.has_sos:
            return sig.sosfreqz(self.sos, frequency_vector_hz, fs=self.sampling_rate_hz)[1]
        return sig.freqz(self.ba[0], self.ba[1], frequency_vector_hz,
                         fs=self.sampling_rate_hz)[1]

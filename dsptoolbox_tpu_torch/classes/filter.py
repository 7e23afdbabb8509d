"""Filter: an LTI digital filter in zpk / SOS / ba representation
(`dsptoolbox_tpu/classes/filter.py`).

Designs and conversions are host numpy/scipy; `filter_signal` runs on the
signal's device through `filter_helpers`. Not ported yet: the FIR
designer, ``filter_and_resample_signal``, metadata, plots and saving.
"""

from __future__ import annotations

from copy import deepcopy
from warnings import warn

import numpy as np
import scipy.signal as sig

from .._enums import (
    BiquadEqType,
    FilterCoefficientsType,
    FilterPassType,
    IirDesignMethod,
)
from .filter_helpers import biquad_coefficients, filter_on_signal, filter_on_signal_ba, impulse
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
            new_signal, zi_new = filter_on_signal_ba(
                signal, self.ba, channels=channels, zi=zi_old, zero_phase=zero_phase,
                is_fir=self.is_fir, warning_on_complex_output=self.warning_if_complex,
            )
        if activate_zi:
            self.zi = zi_new
        return new_signal

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

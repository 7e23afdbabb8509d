"""Typed option vocabulary of the ported paths, copied from
`dsptoolbox_tpu/standard/enums.py` (pure numpy/scipy, host-side).

Members select code paths and host-side precomputation (window tables,
scaling factors); every scaling factor is a Python scalar.
"""

from __future__ import annotations

from enum import Enum, auto

import numpy as np


class SpectrumMethod(Enum):
    """How to compute a spectrum: time-averaged Welch periodogram or a direct
    DFT of the whole (deterministic) signal."""

    WelchPeriodogram = auto()
    FFT = auto()


class SpectrumScaling(Enum):
    """Spectrum scaling vocabulary (Heinzel et al. 2002).

    Amplitude scalings: AmplitudeSpectrum, AmplitudeSpectralDensity and the
    three bare-FFT normalizations. Power scalings: PowerSpectrum,
    PowerSpectralDensity.
    """

    AmplitudeSpectrum = auto()
    AmplitudeSpectralDensity = auto()
    PowerSpectrum = auto()
    PowerSpectralDensity = auto()
    FFTBackward = auto()
    FFTForward = auto()
    FFTOrthogonal = auto()

    def fft_norm(self) -> str:
        """FFT normalization string understood by numpy/jax rfft."""
        if self is SpectrumScaling.FFTForward:
            return "forward"
        if self is SpectrumScaling.FFTOrthogonal:
            return "ortho"
        return "backward"

    def is_amplitude_scaling(self) -> bool:
        """True for linear (amplitude) scalings, False for squared (power)."""
        return self not in (
            SpectrumScaling.PowerSpectrum,
            SpectrumScaling.PowerSpectralDensity,
        )

    def outputs_complex_spectrum(self, method: SpectrumMethod) -> bool:
        """Whether the produced spectrum is complex-valued."""
        if method is SpectrumMethod.WelchPeriodogram:
            return False
        return self.is_amplitude_scaling()

    def has_physical_units(self) -> bool:
        """True for the four physically-scaled variants (not bare FFT norms)."""
        return self in (
            SpectrumScaling.AmplitudeSpectrum,
            SpectrumScaling.AmplitudeSpectralDensity,
            SpectrumScaling.PowerSpectrum,
            SpectrumScaling.PowerSpectralDensity,
        )

    def is_spectral_density(self) -> bool:
        """True when the (power representation of the) scaling integrates over
        frequency to the signal energy (Parseval)."""
        return self in (
            SpectrumScaling.AmplitudeSpectralDensity,
            SpectrumScaling.PowerSpectralDensity,
        )

    def get_scaling_factor(
        self,
        length_time_data_samples: int,
        sampling_rate_hz: int | None = None,
        window: np.ndarray | None = None,
    ) -> float:
        """Host-side scalar factor applied to the one-sided forward spectrum
        (linear or squared data, matching `is_amplitude_scaling`). DC/Nyquist
        correction is the caller's job. Reference: `standard/enums.py:181-231`.
        """
        if self is SpectrumScaling.FFTBackward:
            return 1.0
        if self is SpectrumScaling.FFTForward:
            return 1.0 / length_time_data_samples
        if self is SpectrumScaling.FFTOrthogonal:
            return (1.0 / length_time_data_samples) ** 0.5

        if self.is_spectral_density():
            denom = (
                float(np.sum(np.asarray(window, dtype=np.float64) ** 2))
                if window is not None
                else float(length_time_data_samples)
            )
            factor = (2.0 / denom / sampling_rate_hz) ** 0.5
        else:  # spectrum (not density)
            denom = (
                float(np.sum(np.asarray(window, dtype=np.float64)))
                if window is not None
                else float(length_time_data_samples)
            )
            factor = 2.0**0.5 / denom

        return factor if self.is_amplitude_scaling() else factor**2.0

    def conversion_factor(
        self,
        output: "SpectrumScaling",
        length_time_data_samples: int,
        sampling_rate_hz: int | None = None,
        window: np.ndarray | None = None,
    ) -> float:
        """Scalar factor converting data in this scaling into `output` scaling.
        If linear/squared representations differ, the factor is valid for the
        squared data (reference `standard/enums.py:139-179`)."""
        fin = self.get_scaling_factor(
            length_time_data_samples, sampling_rate_hz, window
        )
        fout = output.get_scaling_factor(
            length_time_data_samples, sampling_rate_hz, window
        )
        if not (self.is_amplitude_scaling() ^ output.is_amplitude_scaling()):
            return fout / fin
        if self.is_amplitude_scaling():
            fin = fin**2.0
        else:
            fout = fout**2.0
        return fout / fin


class Window(Enum):
    """Window types (25). Values are generated host-side in float64 through
    `scipy.signal.windows.get_window`."""

    Boxcar = auto()
    Triang = auto()
    Blackman = auto()
    Hamming = auto()
    Hann = auto()
    Bartlett = auto()
    Flattop = auto()
    Parzen = auto()
    Bohman = auto()
    Blackmanharris = auto()
    Nuttall = auto()
    Barthann = auto()
    Cosine = auto()
    Exponential = auto()
    Tukey = auto()
    Taylor = auto()
    Lanczos = auto()
    Kaiser = auto()
    KaiserBesselDerived = auto()
    Gaussian = auto()
    GeneralCosine = auto()
    GeneralGaussian = auto()
    GeneralHamming = auto()
    Dpss = auto()
    Chebwin = auto()

    # NOTE: like the reference (`standard/enums.py:374-394`), the extra
    # parameter is stored on the enum *member* (global, last-set-wins). Kept
    # for API parity; prefer passing `(Window.Kaiser.with_extra_parameter(b))`
    # right before use.
    @property
    def extra_parameter(self):
        return getattr(self, "_extra_parameter", None)

    def with_extra_parameter(self, extra_parameter):
        self._extra_parameter = extra_parameter
        return self

    def needs_extra_parameter(self) -> bool:
        return self in (
            Window.Kaiser,
            Window.KaiserBesselDerived,
            Window.Gaussian,
            Window.GeneralCosine,
            Window.GeneralGaussian,
            Window.GeneralHamming,
            Window.Dpss,
            Window.Chebwin,
        )

    def _scipy_name(self) -> str:
        special = {
            Window.KaiserBesselDerived: "kaiser_bessel_derived",
            Window.GeneralCosine: "general_cosine",
            Window.GeneralGaussian: "general_gaussian",
            Window.GeneralHamming: "general_hamming",
        }
        return special.get(self, self.name.lower())

    def to_scipy_format(self):
        if self.needs_extra_parameter():
            p = self.extra_parameter
            if p is None:
                raise ValueError(
                    f"Window {self.name} needs an extra parameter; call "
                    "with_extra_parameter() first"
                )
            if self is Window.GeneralGaussian:
                return (self._scipy_name(), p[0], p[1])
            return (self._scipy_name(), p)
        return self._scipy_name()

    def __call__(self, n_values: int, symmetric: bool) -> np.ndarray:
        """Host-side window values (float64 numpy)."""
        from scipy.signal.windows import get_window

        return get_window(self.to_scipy_format(), n_values, fftbins=not symmetric)


class SpectrumType(Enum):
    Power = auto()
    Magnitude = auto()
    Complex = auto()
    Db = auto()


class FrequencySpacing(Enum):
    Logarithmic = auto()
    Linear = auto()
    Other = auto()


class FadeType(Enum):
    Linear = auto()
    Exponential = auto()
    Logarithmic = auto()
    NoFade = auto()

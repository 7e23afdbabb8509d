"""Typed option vocabulary (`dsptoolbox_tpu/standard/enums.py`), defined
in the leaf module `dsptoolbox_tpu_torch._enums`."""

from .._enums import (
    SpectrumMethod,
    SpectrumScaling,
    Window,
    SpectrumType,
    FrequencySpacing,
    FadeType,
    FilterCoefficientsType,
    FilterBankMode,
    FilterPassType,
    IirDesignMethod,
    BiquadEqType,
    MagnitudeNormalization,
    InterpolationDomain,
    InterpolationScheme,
    InterpolationEdgeHandling,
)

__all__ = [
    "SpectrumMethod",
    "SpectrumScaling",
    "Window",
    "SpectrumType",
    "FrequencySpacing",
    "FadeType",
    "FilterCoefficientsType",
    "FilterBankMode",
    "FilterPassType",
    "IirDesignMethod",
    "BiquadEqType",
    "MagnitudeNormalization",
    "InterpolationDomain",
    "InterpolationScheme",
    "InterpolationEdgeHandling",
]

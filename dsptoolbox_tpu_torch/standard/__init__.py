"""Standard functions acting on the container classes
(`dsptoolbox_tpu/standard`). Not ported yet: ``spectral_difference``
(with the `Spectrum` class's octave smoothing) and ``load_pkl_object``
(with `io`)."""

from .appending import append_filterbanks, append_signals, append_spectra
from .enums import (
    BiquadEqType,
    FadeType,
    FilterBankMode,
    FilterCoefficientsType,
    FilterPassType,
    FrequencySpacing,
    IirDesignMethod,
    InterpolationDomain,
    InterpolationEdgeHandling,
    InterpolationScheme,
    MagnitudeNormalization,
    SpectrumMethod,
    SpectrumScaling,
    SpectrumType,
    Window,
)
from .gain_and_level import (
    apply_gain,
    crest_factor,
    fade,
    lufs_integrated,
    normalize,
    rms,
    true_peak_level,
)
from .latency_delay import delay, fractional_delay, latency
from .other import activity_detector, detrend, dither, envelope, merge_filters
from .pad_trim_methods import (
    modify_signal_length,
    pad_trim,
    trim_with_level_threshold,
    trim_with_time_selection,
)
from .resampling import resample, resample_filter

__all__ = [
    "append_filterbanks",
    "append_signals",
    "append_spectra",
    "latency",
    "delay",
    "fractional_delay",
    "pad_trim",
    "modify_signal_length",
    "trim_with_level_threshold",
    "trim_with_time_selection",
    "resample",
    "resample_filter",
    "apply_gain",
    "normalize",
    "fade",
    "true_peak_level",
    "rms",
    "lufs_integrated",
    "crest_factor",
    "activity_detector",
    "detrend",
    "envelope",
    "dither",
    "merge_filters",
    "SpectrumMethod",
    "SpectrumScaling",
    "FilterCoefficientsType",
    "BiquadEqType",
    "FilterBankMode",
    "FilterPassType",
    "IirDesignMethod",
    "MagnitudeNormalization",
    "SpectrumType",
    "InterpolationDomain",
    "InterpolationScheme",
    "InterpolationEdgeHandling",
    "FrequencySpacing",
    "Window",
    "FadeType",
]

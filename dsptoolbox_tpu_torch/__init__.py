"""PyTorch/CUDA port of ``dsptoolbox_tpu``.

The layout mirrors the JAX package module for module (``_config``,
``standard.enums``, ``ops.*``, ``transfer_functions._backend``), so each
function's counterpart is found by path. Public functions keep the JAX
package's channels-first layout ``(..., T)``; the device is the device of
the input tensor. The classes put numpy data on ``device`` or, without
one, on `default_device()` ("cuda" unless `set_default_device` changed it).

Hand-written CUDA kernels replace the JAX package's Pallas kernels
(`ops.cuda_framing`, `ops.cuda_iir`, `ops.cuda_iir_bank`, `ops.cuda_das`,
`ops.cuda_banded`); `ops.cuda_ema` runs the attack/release smoothing
that the JAX package runs as a device loop. They are compiled
from ``csrc/`` at first use on a CUDA tensor; a CPU tensor always takes the
plain PyTorch version, so importing this package needs neither ``nvcc`` nor
a GPU.

The root mirrors the JAX package's (`dsptoolbox_tpu/__init__.py:16-83`):
the standard functions and enums, the classes, the ported namespaces,
`pipeline` (a chain of calls as one CUDA graph) and `compute_all`. The
`tools` namespace is the JAX package's public tools; its submodules hold the
port's run and measurement scripts and are imported only by name.
"""

from ._config import (
    default_complex,
    default_device,
    default_float,
    set_default_device,
    set_default_float,
)
from .standard import (
    activity_detector,
    append_filterbanks,
    append_signals,
    append_spectra,
    apply_gain,
    crest_factor,
    delay,
    detrend,
    dither,
    envelope,
    fade,
    fractional_delay,
    latency,
    load_pkl_object,
    lufs_integrated,
    merge_filters,
    modify_signal_length,
    normalize,
    pad_trim,
    resample,
    resample_filter,
    rms,
    spectral_difference,
    trim_with_level_threshold,
    trim_with_time_selection,
    true_peak_level,
    # Enums
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
from .classes import (
    CalibrationData,
    Filter,
    FilterBank,
    ImpulseResponse,
    MultiBandSignal,
    Signal,
    Spectrum,
)

from . import audio_io
from . import beamforming
from . import distances
from . import effects
from . import filterbanks
from . import generators
from . import plots
from . import room_acoustics
from . import tools
from . import transfer_functions
from . import transforms
from .pipeline import pipeline
from ._defer import compute_all

__all__ = [
    "Signal",
    "CalibrationData",
    "load_pkl_object",
    "ImpulseResponse",
    "MultiBandSignal",
    "Filter",
    "FilterBank",
    "Spectrum",
    "latency",
    "pad_trim",
    "trim_with_level_threshold",
    "trim_with_time_selection",
    "fade",
    "modify_signal_length",
    "append_signals",
    "pipeline",
    "compute_all",
    "append_filterbanks",
    "append_spectra",
    "fractional_delay",
    "delay",
    "activity_detector",
    "normalize",
    "true_peak_level",
    "lufs_integrated",
    "crest_factor",
    "resample",
    "resample_filter",
    "detrend",
    "rms",
    "spectral_difference",
    "envelope",
    "dither",
    "apply_gain",
    "merge_filters",
    "SpectrumScaling",
    "SpectrumMethod",
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
    "transfer_functions",
    "room_acoustics",
    "generators",
    "filterbanks",
    "transforms",
    "beamforming",
    "plots",
    "distances",
    "effects",
    "audio_io",
    "tools",
    "default_complex",
    "default_device",
    "default_float",
    "set_default_device",
    "set_default_float",
]

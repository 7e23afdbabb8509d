"""The public tools (`dsptoolbox_tpu/tools.py`): framing in the reference
layout, frequency vectors, grids and crossovers, sample formats, and the
re-exported dB, spectrum and smoothing helpers.

The submodules (not imported here, not exported) are the port's run and
measurement scripts: the configurations it is driven at (`camera`,
`measurement`, `filterbank_chain`, `room_measurement`, `speech_chain`,
`tf_analysis`, `feature_chain`, `session_files`, `realtime_chain`,
`effects_chain`), the chains run through `pipeline` (`pipeline_chains`),
`profile_chain`, which profiles them on a CUDA device, and the measurement
tools `das_phases` and `mma_rates`."""

from ..helpers.gain_and_level import from_db, to_db
from ..helpers.other import next_power_2
from ..helpers.smoothing import (
    fractional_octave_smoothing,
    get_smoothing_factor_ema,
    time_smoothing,
)
from ..helpers.spectrum_utilities import (
    interpolate_fr,
    scale_spectrum,
    warp_frequency_vector as warp_frequency,
    wrap_phase,
)
from .frequencies import erb_frequencies, fractional_octave_frequencies
from .public import (
    convert_sample_representation,
    framed_signal,
    frequency_crossover,
    get_exact_value_at_frequency,
    log_frequency_vector,
    log_mean,
    reconstruct_from_framed_signal,
)

__all__ = [
    "log_frequency_vector",
    "get_exact_value_at_frequency",
    "log_mean",
    "frequency_crossover",
    "fractional_octave_frequencies",
    "erb_frequencies",
    "convert_sample_representation",
    "to_db",
    "from_db",
    "interpolate_fr",
    "scale_spectrum",
    "wrap_phase",
    "warp_frequency",
    "fractional_octave_smoothing",
    "get_smoothing_factor_ema",
    "time_smoothing",
    "next_power_2",
    "framed_signal",
    "reconstruct_from_framed_signal",
]

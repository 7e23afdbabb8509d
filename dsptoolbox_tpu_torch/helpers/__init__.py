"""Array-level helpers (`dsptoolbox_tpu/helpers/`): grids, windows and
coefficients on the host, batch math in torch on the data's device."""

from .ar_estimation import burg_ar, levinson_durbin_recursion, yule_walker_ar
from .frequency_conversion import frequency_weighting, hz2mel, mel2hz
from .gain_and_level import amplify_db, fade, fade_ramp, from_db, normalize, rms, to_db
from .interpolation import linear_interpolate, pchip_interpolate
from .latency import (
    analytic_signal,
    correlation_of_latencies,
    fractional_latency,
    get_fractional_impulse_peak_index,
    remove_ir_latency_from_phase,
)
from .minimum_phase import (
    min_phase_ir_from_real_cepstrum,
    minimum_phase_spectrum_from_real_cepstrum,
)
from .other import (
    check_format_in_path,
    euclidean_distance_matrix,
    find_frequencies_above_threshold,
    find_nearest_points_index_in_vector,
    fractional_octave_bandwidth,
    next_power_2,
    toeplitz_convolution_matrix,
)
from .polyphase import polyphase_decomposition, polyphase_reconstruction
from .smoothing import fractional_octave_smoothing, get_smoothing_factor_ema, time_smoothing
from .spectrum_utilities import (
    correct_for_real_phase_spectrum,
    get_exact_gain_1khz,
    get_normalized_spectrum,
    interpolate_fr,
    scale_spectrum,
    warp_frequency_vector,
    wrap_phase,
)
from .windows_extra import calculate_tukey_like_window, gaussian_window, gaussian_window_sigma

__all__ = [
    "burg_ar", "levinson_durbin_recursion", "yule_walker_ar",
    "frequency_weighting", "hz2mel", "mel2hz",
    "amplify_db", "fade", "fade_ramp", "from_db", "normalize", "rms", "to_db",
    "linear_interpolate", "pchip_interpolate",
    "analytic_signal", "correlation_of_latencies", "fractional_latency",
    "get_fractional_impulse_peak_index", "remove_ir_latency_from_phase",
    "min_phase_ir_from_real_cepstrum", "minimum_phase_spectrum_from_real_cepstrum",
    "check_format_in_path", "euclidean_distance_matrix", "find_frequencies_above_threshold",
    "find_nearest_points_index_in_vector", "fractional_octave_bandwidth", "next_power_2",
    "toeplitz_convolution_matrix",
    "polyphase_decomposition", "polyphase_reconstruction",
    "fractional_octave_smoothing", "get_smoothing_factor_ema", "time_smoothing",
    "correct_for_real_phase_spectrum", "get_exact_gain_1khz", "get_normalized_spectrum",
    "interpolate_fr", "scale_spectrum", "warp_frequency_vector", "wrap_phase",
    "calculate_tukey_like_window", "gaussian_window", "gaussian_window_sigma",
]

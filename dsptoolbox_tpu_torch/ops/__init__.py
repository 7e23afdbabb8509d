"""Array-level ops on channels-first tensors ``(..., T)``
(`dsptoolbox_tpu/ops/__init__.py`): framing, padding, prefix sums, the
spectral estimators, windows and the differentiable filter ops; the CUDA
kernels' wrappers are the ``cuda_*`` submodules."""

from .framing import (
    compute_number_frames,
    frame_signal,
    overlap_add,
    reconstruct_framed_signal,
    window_envelope,
)
from .differentiable import (
    biquad_coefficients_diff,
    fit_sos_to_magnitude,
    sosfilt_diff,
    sosfreqz_diff,
    sosfreqz_host,
)
from .pad_trim import pad_trim_axis
from .prefix import cumsum_mxu
from .spectral import csm_from_spectrum, csm_welch, stft, welch
from .windows import check_cola, get_window

__all__ = [
    "biquad_coefficients_diff",
    "fit_sos_to_magnitude",
    "sosfilt_diff",
    "sosfreqz_diff",
    "sosfreqz_host",
    "compute_number_frames",
    "frame_signal",
    "overlap_add",
    "reconstruct_framed_signal",
    "window_envelope",
    "pad_trim_axis",
    "cumsum_mxu",
    "welch",
    "stft",
    "csm_welch",
    "csm_from_spectrum",
    "get_window",
    "check_cola",
]

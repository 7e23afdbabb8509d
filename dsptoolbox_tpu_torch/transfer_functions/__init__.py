"""Transfer-function measurement (`dsptoolbox_tpu/transfer_functions`):
so far the measurement path, deconvolution → IR windowing → complex
smoothing."""

from .enums import SmoothingDomain, TransferFunctionType
from .transfer_functions import complex_smoothing, spectral_deconvolve, window_ir

__all__ = [
    "spectral_deconvolve",
    "window_ir",
    "complex_smoothing",
    "TransferFunctionType",
    "SmoothingDomain",
]

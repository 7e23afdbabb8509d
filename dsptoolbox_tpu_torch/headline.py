"""The measurement chain on a batch of signals ``(B, T)``: STFT energy, a
4-band Butterworth crossover, and regularized spectral deconvolution.

The chain of `__graft_entry__._make_fn` and `bench.py:build_pipeline` in the
JAX package, as one function. ``bank="per_band"`` filters each band with
`ops.iir.sosfilt` (the blocked-IIR lead kernel on a CUDA tensor);
``bank="banked"`` applies all four bands at once with
`ops.iir_block.sosfilt_bank_apply` (the filter-bank kernel on a CUDA
tensor). The STFT runs through the framing kernel on a CUDA tensor either
way.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy.signal import butter

from .ops.iir import sosfilt
from .ops.iir_block import bank_device_operators, sosfilt_bank_apply, stack_sos_bank
from .ops.spectral import stft
from .transfer_functions._backend import spectral_deconvolve_core

CROSSOVERS_HZ = (250.0, 1000.0, 4000.0)
STFT_WINDOW = 1024


@lru_cache(maxsize=8)
def crossover_bank(fs: int = 48000) -> tuple:
    """The four 4th-order Butterworth bands (lowpass, two bandpasses,
    highpass) as SOS arrays, as in `bench.py` of the JAX package."""
    c0, c1, c2 = CROSSOVERS_HZ
    return (
        butter(4, c0, btype="lowpass", fs=fs, output="sos"),
        butter(4, [c0, c1], btype="bandpass", fs=fs, output="sos"),
        butter(4, [c1, c2], btype="bandpass", fs=fs, output="sos"),
        butter(4, c2, btype="highpass", fs=fs, output="sos"),
    )


@lru_cache(maxsize=8)
def _stacked_bank(fs: int) -> np.ndarray:
    """The crossover bands stacked ``(4, S, 6)``."""
    return stack_sos_bank(crossover_bank(fs))


def run(
    x: torch.Tensor,
    excitation_spectrum: torch.Tensor,
    *,
    bank: str = "per_band",
    fs: int = 48000,
    reg=1e-3,
):
    """Run the chain on ``x (B, T)``.

    ``excitation_spectrum`` is the rfft of the excitation at length T,
    ``(T//2 + 1,)`` complex; ``reg`` is the regularization (a float or a
    ``(T//2 + 1,)`` profile). Returns ``(energy (B,), bands (B, 4, T),
    ir (B, T))``: the STFT energy of each signal, its four crossover bands,
    and its impulse response deconvolved against the excitation.
    """
    if x.ndim != 2:
        raise ValueError(f"x must be (B, T), got {tuple(x.shape)}")
    T = x.shape[-1]
    _, _, S = stft(
        x,
        sampling_rate_hz=fs,
        window_length_samples=STFT_WINDOW,
        overlap_percent=50.0,
    )
    energy = (S.abs() ** 2).sum(dim=(-1, -2))

    if bank == "per_band":
        bands = torch.stack([sosfilt(s, x)[0] for s in crossover_bank(fs)], dim=1)
    elif bank == "banked":
        ops = bank_device_operators(_stacked_bank(fs), T, x.dtype, x.device)
        bands = sosfilt_bank_apply(ops, x).movedim(0, 1)
    else:
        raise ValueError(f"bank must be 'per_band' or 'banked', got {bank!r}")

    X = torch.fft.rfft(x, dim=-1)  # (B, F)
    E = torch.as_tensor(excitation_spectrum, device=x.device)
    if not isinstance(reg, float):
        reg = torch.as_tensor(reg, dtype=x.dtype, device=x.device)[:, None]
    # the deconvolution core works on (F, C); .mT views keep x's layout
    ir = spectral_deconvolve_core(X.mT, E[:, None], T, reg).mT
    return energy, bands, ir

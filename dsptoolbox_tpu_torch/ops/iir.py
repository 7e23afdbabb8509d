"""SOS filtering entry points (`dsptoolbox_tpu/ops/iir.py`).

``sosfilt`` runs the blocked state-space formulation (`ops.iir_block`);
``sosfilt_zero_state`` routes long zero-state signals to exact frequency
sampling (`ops.iir_freq`); ``sosfiltfilt`` is the zero-phase
forward-backward pass. Coefficient handling stays host-side.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import device_cache
from .cuda_iir import state_dtype
from .iir_block import sosfilt_block
from .iir_freq import plan_nfft, sosfilt_freq

# Frequency-sampling window of `sosfilt_zero_state`: the JAX package's TPU
# crossovers, kept for parity until they are measured on the H100.
_FREQ_MIN_T = 4096
_FREQ_MAX_T = 131072


def sosfilt(sos: np.ndarray, x: torch.Tensor, zi=None):
    """Second-order-sections filtering of ``x (..., T)``.

    Mirrors ``scipy.signal.sosfilt``: ``sos (S, 6)`` host-side
    coefficients; ``zi (..., S, 2)`` optional initial state. Returns
    ``(y, zf)``: ``y`` in the input's dtype, ``zf`` in the state path's
    (float64, or complex128 for complex data), so a streamed filter keeps
    its state unrounded between calls.
    """
    return sosfilt_block(sos, x, zi=zi)


def sosfilt_zero_state(sos: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-state ``sosfilt`` returning ``y`` only, auto-dispatched.

    Signals of 4096 to 131072 samples go to exact frequency sampling (two
    FFTs) when the cascade's decay margin allows it; the rest, and
    near-unstable cascades, take the blocked formulation.
    """
    T = x.shape[-1]
    if _FREQ_MIN_T <= T <= _FREQ_MAX_T:
        nfft = plan_nfft(np.asarray(sos), T)
        if nfft is not None and nfft <= 4 * T:
            return sosfilt_freq(sos, x, nfft=nfft)
    return sosfilt_block(sos, x)[0]


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state sosfilt initial conditions (host-side, scipy-equivalent).

    Returns ``(S, 2)``: the state such that a unit-step input produces a
    constant output from the first sample.
    """
    from scipy.signal import sosfilt_zi as _zi

    return np.asarray(_zi(np.asarray(sos, dtype=np.float64)))


@device_cache(64)
def _device_zi(sos_key: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """`sosfilt_zi` of the cascade ``(S, 2)`` on ``device``, cached."""
    return torch.as_tensor(sosfilt_zi(np.reshape(sos_key, (-1, 6))), dtype=dtype, device=device)


def _odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension by ``n`` samples at both ends of the last axis
    (``scipy.signal._arraytools.odd_ext``)."""
    if n < 1:
        return x
    left = 2 * x[..., :1] - x[..., 1 : n + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -(n + 1) : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def sosfiltfilt(sos: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase forward-backward SOS filtering of ``x (..., T)``, matching
    ``scipy.signal.sosfiltfilt`` (odd padding of 3·ntaps, steady-state
    initial states scaled by the edge samples)."""
    if np.iscomplexobj(sos):
        raise TypeError("sosfiltfilt takes real second-order sections")
    sos = np.asarray(sos, dtype=np.float64)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * int(ntaps)
    if x.shape[-1] <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen={padlen}."
        )
    # the start state zi0 · y[0] is formed in the state path's float64:
    # rounded to float32, it moves low bands by up to 1.6e-5 of scipy's
    # float64 result (the error peaks ~100 samples in)
    zi0 = _device_zi(tuple(sos.reshape(-1).tolist()), state_dtype(x.dtype), x.device)
    sdt = zi0.dtype
    y = _odd_ext(x, padlen)
    for _ in range(2):
        y, _ = sosfilt(sos, y, zi=zi0 * y[..., :1, None].to(sdt))
        y = y.flip(-1)
    return y[..., padlen:-padlen]

"""Autoregressive estimation: Levinson-Durbin, Yule-Walker, Burg
(`dsptoolbox_tpu/helpers/ar_estimation.py`).

The estimates are ill-conditioned: near-sinusoidal frames push the
reflection coefficients towards ±1, where a float32 perturbation of the
input moves the AR coefficients by ~1e-1. So they run in float64, as the
JAX package's host numpy does, with the same operations in the same order
(it agrees with the numpy form to ~1e-12), but on the frames' own device:
a tensor stays where it is (60,000 frames of an LPC analysis are not copied
to the host), numpy input runs on the CPU and comes back as numpy.

Array convention: time and coefficients on the FIRST axis, as in the
reference, channels (and frames) after.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_float64(x) -> tuple:
    """``(float64 tensor, was numpy)``."""
    if torch.is_tensor(x):
        return x.to(torch.float64), False
    return torch.as_tensor(np.asarray(x, dtype=np.float64)), True


def _out(was_numpy: bool, *tensors):
    return tuple(t.numpy() for t in tensors) if was_numpy else tensors


def _levinson(r: torch.Tensor) -> tuple:
    """`levinson_durbin_recursion` on a float64 tensor ``(order+1, ...)``."""
    prediction_error = r[0].clone()
    r = r[1:]
    num = r.shape[0]
    ar = [torch.zeros_like(r[0]) for _ in range(num)]
    for order in range(num):
        reflection_value = r[order].clone()
        for lag in range(order):
            reflection_value = reflection_value + ar[lag] * r[order - lag - 1]
        k = -reflection_value / prediction_error
        prediction_error = prediction_error * (1.0 - k**2)
        ar[order] = k
        if order == 0:
            continue
        for lag in range((order + 1) // 2):
            reverse_lag = order - lag - 1
            save = ar[lag]
            ar[lag] = save + k * ar[reverse_lag]
            if lag != reverse_lag:
                ar[reverse_lag] = ar[reverse_lag] + k * save
    coeffs = torch.stack([torch.ones_like(prediction_error)] + ar, dim=0)
    return coeffs, prediction_error


def levinson_durbin_recursion(autocorrelation):
    """Levinson-Durbin over the first axis: ``autocorrelation (order+1,
    ...)`` → (AR coefficients ``(order+1, ...)`` with a0 = 1, prediction
    error) (reference `helpers/ar_estimation.py:6-69`). A non-positive
    prediction error gives NaN or inf downstream instead of raising, as in
    the JAX package."""
    r, was_numpy = _as_float64(autocorrelation)
    return _out(was_numpy, *_levinson(r))


def yule_walker_ar(time_data, order: int):
    """Yule-Walker AR estimation along the first axis
    (`helpers/ar_estimation.py:71-126`): the biased autocorrelation through
    a float64 FFT of length ``2^ceil(log2(2T - 1))``, then Levinson-Durbin.
    Returns (AR coefficients ``(order+1, ...)``, prediction error)."""
    td, was_numpy = _as_float64(time_data)
    T = td.shape[0]
    nfft = 1 << int(np.ceil(np.log2(2 * T - 1)))
    spec = torch.fft.rfft(td, n=nfft, dim=0)
    ac = torch.fft.irfft(spec * spec.conj(), n=nfft, dim=0)[: order + 1] / T
    return _out(was_numpy, *_levinson(ac))


def burg_ar(time_data, order: int):
    """Burg's method along the first axis (`helpers/ar_estimation.py:129-205`,
    the librosa-style update). Returns (AR coefficients ``(order+1, ...)``,
    prediction error variance)."""
    td, was_numpy = _as_float64(time_data)
    onedim = td.ndim == 1
    if onedim:
        td = td[:, None]
    eps = float(np.finfo(np.float64).eps)
    ar_coeffs = [torch.full(td.shape[1:], 1.0 if i == 0 else 0.0, dtype=td.dtype,
                            device=td.device) for i in range(order + 1)]
    fwd = td[1:]
    bwd = td[:-1]
    den = torch.sum(fwd**2 + bwd**2, dim=0)
    for i in range(order):
        k = (-2.0 * torch.sum(bwd * fwd, dim=0)) / (den + eps)
        prev = list(ar_coeffs)
        for j in range(1, i + 2):
            ar_coeffs[j] = prev[j] + k * prev[i - j + 1]
        fwd_tmp = fwd
        fwd = fwd + k * bwd
        bwd = bwd + k * fwd_tmp
        q = 1.0 - k**2
        den = q * den - bwd[-1] ** 2 - fwd[0] ** 2
        fwd = fwd[1:]
        bwd = bwd[:-1]
    coeffs = torch.stack(ar_coeffs, dim=0)
    if onedim:
        coeffs, den = coeffs[:, 0], den[0]
    return _out(was_numpy, coeffs, den)

"""Differentiable DSP: filter design and filtering with autograd, for
gradient-based fitting (`dsptoolbox_tpu/ops/differentiable.py`).

Every function keeps the filter coefficients as tensors in the autograd
graph, so a loss on the filtered signal (or on a frequency response)
differentiates back to the design parameters.

- `biquad_coefficients_diff`: RBJ cookbook biquads from (frequency, gain,
  Q) tensors, the conventions of `classes.filter_helpers.
  biquad_coefficients`.
- `sosfreqz_diff`: the complex response of an SOS cascade;
  `sosfreqz_host` the same as numpy.
- `sosfilt_diff`: time-domain SOS filtering, each section's TDF2 state
  through `ops.iir.linear_recurrence` (log-depth doubling over time),
  differentiable through its products.
- `fit_sos_to_magnitude`: Adam on the mean squared dB error, a Python loop
  of `torch.autograd.grad` steps with no host sync.

float32 by default; float64 parameters stay float64 (for gradient checks).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._enums import BiquadEqType
from .iir import linear_recurrence


def _real(x, like=None) -> torch.Tensor:
    """``x`` as a real tensor: float64 tensors stay float64, anything else
    is float32 (on ``like``'s device when given)."""
    device = like.device if like is not None else None
    t = torch.as_tensor(x, device=device)
    return t if t.dtype == torch.float64 else t.to(torch.float32)


def biquad_coefficients_diff(
    eq_type: BiquadEqType,
    fs_hz: int,
    frequency_hz,
    gain_db,
    q,
) -> torch.Tensor:
    """RBJ biquad coefficients from parameter tensors.

    Returns an ``sos (..., 6)`` row (normalized so ``a0 == 1``) over the
    common shape of the three parameters. Matches
    `classes.filter_helpers.biquad_coefficients` (including the
    reference's convention that the linear gain multiplies the numerator of
    every type, `dsptoolbox/classes/filter_helpers.py:30-44`), and is
    differentiable w.r.t. ``frequency_hz``, ``gain_db`` and ``q``. Only the
    second-order types.
    """
    frequency_hz = _real(frequency_hz)
    frequency_hz, gain_db, q = torch.broadcast_tensors(
        frequency_hz, _real(gain_db, frequency_hz), _real(q, frequency_hz))
    shelf_like = eq_type in (
        BiquadEqType.Peaking,
        BiquadEqType.Lowshelf,
        BiquadEqType.Highshelf,
    )
    A = 10.0 ** (gain_db / (40.0 if shelf_like else 20.0))
    Omega = 2.0 * np.pi * frequency_hz / fs_hz
    sn, cs = torch.sin(Omega), torch.cos(Omega)
    alpha = sn / (2.0 * q)
    sqA = torch.sqrt(A)
    zero = torch.zeros_like(A)
    if eq_type == BiquadEqType.Peaking:
        b = [1 + alpha * A, -2 * cs, 1 - alpha * A]
        a = [1 + alpha / A, -2 * cs, 1 - alpha / A]
    elif eq_type == BiquadEqType.Lowpass:
        b = [(1 - cs) / 2 * A, (1 - cs) * A, (1 - cs) / 2 * A]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif eq_type == BiquadEqType.Highpass:
        b = [(1 + cs) / 2 * A, -(1 + cs) * A, (1 + cs) / 2 * A]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif eq_type == BiquadEqType.BandpassSkirt:
        b = [sn / 2 * A, zero, -sn / 2 * A]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif eq_type == BiquadEqType.BandpassPeak:
        b = [alpha * A, zero, -alpha * A]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif eq_type == BiquadEqType.Notch:
        b = [A, -2 * cs * A, A]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif eq_type == BiquadEqType.Allpass:
        b = [(1 - alpha) * A, -2 * cs * A, (1 + alpha) * A]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif eq_type == BiquadEqType.Lowshelf:
        b = [
            A * ((A + 1) - (A - 1) * cs + 2 * sqA * alpha),
            2 * A * ((A - 1) - (A + 1) * cs),
            A * ((A + 1) - (A - 1) * cs - 2 * sqA * alpha),
        ]
        a = [
            (A + 1) + (A - 1) * cs + 2 * sqA * alpha,
            -2 * ((A - 1) + (A + 1) * cs),
            (A + 1) + (A - 1) * cs - 2 * sqA * alpha,
        ]
    elif eq_type == BiquadEqType.Highshelf:
        b = [
            A * ((A + 1) + (A - 1) * cs + 2 * sqA * alpha),
            -2 * A * ((A - 1) + (A + 1) * cs),
            A * ((A + 1) + (A - 1) * cs - 2 * sqA * alpha),
        ]
        a = [
            (A + 1) - (A - 1) * cs + 2 * sqA * alpha,
            2 * ((A - 1) - (A + 1) * cs),
            (A + 1) - (A - 1) * cs - 2 * sqA * alpha,
        ]
    else:
        raise ValueError(
            f"{eq_type} is not supported by the differentiable designer"
        )
    b, a = torch.stack(b, dim=-1), torch.stack(a, dim=-1)
    a0 = a[..., :1]
    return torch.cat([b / a0, a / a0], dim=-1)


def sosfreqz_diff(sos, freqs_hz, fs_hz: int) -> torch.Tensor:
    """Complex response of an SOS cascade at arbitrary frequencies.

    ``sos (..., S, 6)``, ``freqs_hz (F,)`` → ``H (..., F)`` (complex64, or
    complex128 for float64 ``sos``). Differentiable w.r.t. ``sos``.
    """
    sos = _real(sos)
    cdt = torch.complex128 if sos.dtype == torch.float64 else torch.complex64
    w = 2.0 * np.pi * _real(freqs_hz, sos).to(sos.dtype) / fs_hz
    z1 = torch.exp(-1j * w.to(cdt))  # (F,)
    z = torch.stack([torch.ones_like(z1), z1, z1 * z1], dim=-1)  # (F, 3)
    b = sos[..., :3].to(cdt)
    a = sos[..., 3:].to(cdt)
    num = torch.einsum("...sc,fc->...sf", b, z)
    den = torch.einsum("...sc,fc->...sf", a, z)
    return torch.prod(num / den, dim=-2)


def sosfreqz_host(sos, freqs_hz, fs_hz: int) -> np.ndarray:
    """`sosfreqz_diff` of float32 ``sos`` as a complex numpy array."""
    f = np.asarray(freqs_hz, np.float32)
    s = torch.as_tensor(np.asarray(sos, np.float32))
    with torch.no_grad():
        return sosfreqz_diff(s, torch.as_tensor(f), fs_hz).cpu().numpy()


def _tdf2_system_diff(b: torch.Tensor, a: torch.Tensor):
    """The TDF2 companion form of one normalized biquad (a0 == 1),
    `ops.iir._tdf2_system` for N == 2 with the coefficients kept in the
    graph."""
    A = torch.stack(
        [
            torch.stack([-a[..., 1], torch.ones_like(a[..., 1])], dim=-1),
            torch.stack([-a[..., 2], torch.zeros_like(a[..., 2])], dim=-1),
        ],
        dim=-2,
    )  # (..., 2, 2)
    Bvec = torch.stack(
        [
            b[..., 1] - a[..., 1] * b[..., 0],
            b[..., 2] - a[..., 2] * b[..., 0],
        ],
        dim=-1,
    )  # (..., 2)
    return A, Bvec, b[..., 0]


def sosfilt_diff(sos, x: torch.Tensor) -> torch.Tensor:
    """SOS filtering of ``x (..., T)`` with coefficient tensors ``sos (S,
    6)``: ``scipy.signal.sosfilt`` with a zero start state, and autograd
    through the coefficients. Each section's state runs through
    `ops.iir.linear_recurrence` (log-depth doubling over time), slower
    than the blocked kernel path of `ops.iir.sosfilt`: for fitting loops.
    The coefficients take ``x``'s dtype (float32 unless ``x`` is float64).
    """
    x = _real(x)
    sos = torch.as_tensor(sos, device=x.device).to(x.dtype)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6), got {tuple(sos.shape)}")
    sos = sos / sos[:, 3:4]
    y = x
    for s_idx in range(sos.shape[0]):
        b, a = sos[s_idx, :3], sos[s_idx, 3:]
        A, Bvec, b0 = _tdf2_system_diff(b, a)
        xt = torch.movedim(y, -1, 0)  # (T, ...)
        s = linear_recurrence(A, xt[..., None] * Bvec)  # (T, ..., 2)
        s0_shifted = torch.cat([torch.zeros_like(s[:1, ..., 0]), s[:-1, ..., 0]], dim=0)
        y = torch.movedim(b0 * xt + s0_shifted, 0, -1)
    return y


def fit_sos_to_magnitude(
    make_sos: Callable[[torch.Tensor], torch.Tensor],
    params0,
    target_mag_db,
    freqs_hz,
    fs_hz: int,
    steps: int = 200,
    lr: float = 0.05,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit design parameters so the SOS magnitude matches a dB target.

    ``make_sos(params) -> (S, 6)`` builds the cascade from the parameters
    (e.g. stacked `biquad_coefficients_diff` rows). Adam (the JAX
    package's b1, b2, eps and bias correction in the parameters' dtype) on
    the parameters' device, with no host sync; returns ``(params,
    loss_history)``, detached.
    """
    p = _real(params0).detach().clone()
    target = _real(target_mag_db, p).to(p.dtype)
    freqs = _real(freqs_hz, p).to(p.dtype)

    def loss_fn(params):
        H = sosfreqz_diff(make_sos(params), freqs, fs_hz)
        # |H|^2 + eps inside the log keeps the gradient finite when the
        # response grid hits a true zero (that of abs() is NaN at 0)
        mag_db = 10.0 * torch.log10(H.real**2 + H.imag**2 + 1e-24)
        return torch.mean((mag_db - target) ** 2)

    b1, b2, eps = 0.9, 0.999, 1e-8
    b1_t = torch.tensor(b1, dtype=p.dtype, device=p.device)
    b2_t = torch.tensor(b2, dtype=p.dtype, device=p.device)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    losses = []
    for i in range(steps):
        p.requires_grad_(True)
        loss = loss_fn(p)
        (g,) = torch.autograd.grad(loss, p)
        p = p.detach()
        losses.append(loss.detach())
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = torch.tensor(i + 1.0, dtype=p.dtype, device=p.device)
        mh = m / (1 - b1_t**step)
        vh = v / (1 - b2_t**step)
        p = p - lr * mh / (torch.sqrt(vh) + eps)
    return p, torch.stack(losses)

"""Exact zero-state IIR filtering by frequency sampling
(`dsptoolbox_tpu/ops/iir_freq.py`).

For a stable LTI filter and zero initial state, the first T output samples
depend only on the first T samples of the impulse response. Sampling the
analytic transfer function on an FFT grid of length ``nfft ≥ T + margin``
(margin chosen from the slowest pole's decay) therefore reproduces
``scipy.signal.sosfilt`` on ``x[..., :T]`` to floating-point accuracy, with
two FFTs and one elementwise multiply instead of a sequential recursion.

Numerical core: each biquad factors into poles/zeros ``ρ·e^{jφ}`` (host-side
float64). A unit-circle sample of the factor ``1 - ρ e^{jφ} e^{-jω}`` is
evaluated as

    (1-ρ) + 2ρ·sin²(Δ/2)  +  j·ρ·sin(Δ),     Δ = ω − φ

whose real part is a SUM of non-negatives, so float32 device evaluation
stays ~1e-7 accurate even for poles with 1-ρ ≈ 1e-4.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._config import device_cache
from .._trace import spanned
from .fft_conv import next_fast_len

_DECAY_EPS = 1e-9  # relative tail level the margin must reach
_MAX_POLE_RADIUS = 1.0 - 1e-6  # beyond this the margin explodes: refuse


@lru_cache(maxsize=512)
def _sos_factors(sos_key: tuple, shape: tuple):
    """Host-side float64 pole/zero factorization of an SOS cascade.

    Returns (gain complex, zeros (Z,) complex, poles (P,) complex) with
    exact conjugate pairing from np.roots per section.
    """
    sos = np.asarray(sos_key, dtype=np.complex128).reshape(shape)
    if np.allclose(sos.imag, 0.0):
        sos = sos.real.astype(np.float64)
    gain = 1.0 + 0.0j
    zeros, poles = [], []
    for sec in sos:
        b, a = sec[:3], sec[3:]
        if a[0] != 1.0:
            b = b / a[0]
            a = a / a[0]
        gain *= b[0] if b[0] != 0 else 1.0
        # roots of b0 + b1 z^-1 + b2 z^-2 = b0 (1 - q1 z^-1)(1 - q2 z^-1)
        if b[0] != 0:
            zeros.extend(np.roots(b))
        elif np.any(b != 0):
            # pure z^-1 factor(s): b1 z^-1 + b2 z^-2
            nz = np.trim_zeros(b, "f")
            gain *= nz[0]
            zeros.extend(np.roots(nz))
            # each leading zero coefficient contributes a delay z^-1 =
            # a zero at infinity; represent as extra pole at 0
            poles.extend([0.0] * (len(b) - len(nz)))
        poles.extend(np.roots(a))
    return (
        complex(gain),
        np.asarray(zeros, np.complex128),
        np.asarray(poles, np.complex128),
    )


def _key(sos: np.ndarray) -> tuple:
    return tuple(np.asarray(sos, np.complex128).reshape(-1).tolist())


def decay_margin(sos: np.ndarray, eps: float = _DECAY_EPS) -> int | None:
    """Samples until the slowest pole decays to ``eps``; None if the
    cascade is (numerically) marginally stable or unstable."""
    sos = np.asarray(sos)
    _, _, poles = _sos_factors(_key(sos), sos.shape)
    if poles.size == 0:
        return 0
    r = float(np.max(np.abs(poles)))
    if r >= _MAX_POLE_RADIUS:
        return None
    if r <= 1e-12:
        return 0
    n = int(np.ceil(np.log(eps) / np.log(r)))
    # repeated poles grow as n^(m-1) ρ^n before decaying; a 2x safety
    # factor covers every multiplicity that occurs in practice
    return 2 * n + 64


def _factor_eval(omega: torch.Tensor, roots: np.ndarray) -> torch.Tensor:
    """prod_r (1 - r e^{-jω}) over the roots ``(R,)``, evaluated
    cancellation-free in float32. ``omega (F,)`` float32."""
    rho = np.abs(roots)
    dev = omega.device
    one_minus_rho = torch.as_tensor((1.0 - rho).astype(np.float32), device=dev)
    rho32 = torch.as_tensor(rho.astype(np.float32), device=dev)
    phi32 = torch.as_tensor(np.angle(roots).astype(np.float32), device=dev)
    d = omega[None, :] - phi32[:, None]  # (R, F)
    s2 = torch.sin(0.5 * d)
    re = one_minus_rho[:, None] + 2.0 * rho32[:, None] * s2 * s2
    im = rho32[:, None] * torch.sin(d)
    return torch.prod(torch.complex(re, im), dim=0)


def sos_freq_response(
    sos: np.ndarray, nfft: int, full_spectrum: bool, device=None
) -> torch.Tensor:
    """Transfer function of the cascade on the length-``nfft`` DFT grid
    (``(nfft//2+1,)`` for real half-spectrum, ``(nfft,)`` for full),
    complex64 on ``device``, from host-side pole/zero data; built once per
    (cascade, grid, device) and cached (its roots are copied from the host)."""
    sos = np.asarray(sos)
    return _sos_freq_response(_key(sos), sos.shape, int(nfft), bool(full_spectrum), device)


@device_cache(64)
def _sos_freq_response(key: tuple, shape: tuple, nfft: int, full_spectrum: bool, device):
    gain, zeros, poles = _sos_factors(key, shape)
    F = nfft if full_spectrum else nfft // 2 + 1
    omega = (2.0 * np.pi / nfft) * torch.arange(
        F, dtype=torch.float32, device=device
    )
    num = _factor_eval(omega, zeros) if zeros.size else 1.0
    den = _factor_eval(omega, poles) if poles.size else 1.0
    return torch.tensor(gain, dtype=torch.complex64, device=device) * num / den


def sos_freq_response_host(
    sos: np.ndarray, nfft: int, full_spectrum: bool
) -> np.ndarray:
    """Host-f64 twin of :func:`sos_freq_response` (same cancellation-free
    factor formulation, numpy float64) → complex128 ``(F,)``."""
    sos = np.asarray(sos)
    return np.asarray(
        _freq_response_host_cached(
            _key(sos), sos.shape, int(nfft), bool(full_spectrum)
        )
    )


@lru_cache(maxsize=64)
def _freq_response_host_cached(
    sos_key: tuple, shape: tuple, nfft: int, full_spectrum: bool
):
    gain, zeros, poles = _sos_factors(sos_key, shape)
    F = nfft if full_spectrum else nfft // 2 + 1
    omega = (2.0 * np.pi / nfft) * np.arange(F, dtype=np.float64)

    def feval(roots):
        rho = np.abs(roots)
        phi = np.angle(roots)
        d = omega[None, :] - phi[:, None]
        s2 = np.sin(0.5 * d)
        fac = (
            (1.0 - rho)[:, None]
            + 2.0 * rho[:, None] * s2 * s2
            + 1j * (rho[:, None] * np.sin(d))
        )
        return np.prod(fac, axis=0)

    num = feval(zeros) if zeros.size else 1.0
    den = feval(poles) if poles.size else 1.0
    return gain * num / den


def plan_nfft(sos, T: int) -> int | None:
    """FFT length for exact zero-state filtering of length-T signals, or
    None when the margin is unusable (near-unstable poles or margin far
    beyond the signal length)."""
    m = decay_margin(sos)
    if m is None or m > 8 * T + 4096:
        return None
    return next_fast_len(T + m, real=True)


@spanned("dsp.ops.iir_freq.sosfilt_freq")
def sosfilt_freq(
    sos: np.ndarray,
    x: torch.Tensor,
    nfft: int | None = None,
) -> torch.Tensor:
    """Zero-state ``sosfilt`` over the last axis via frequency sampling.

    Matches ``scipy.signal.sosfilt(sos, x)`` (zero zi) to ~1e-6 relative.
    Complex cascades produce complex output, like scipy. Returns ``y`` only
    (use `ops.iir_block.sosfilt_block` for zi/zf).
    """
    sos = np.asarray(sos)
    T = x.shape[-1]
    if nfft is None:
        nfft = plan_nfft(sos, T)
        if nfft is None:
            raise ValueError(
                "sosfilt_freq: cascade too close to instability for "
                "frequency sampling; use sosfilt_block"
            )
    if np.iscomplexobj(sos) or x.is_complex():
        H = sos_freq_response(sos, nfft, full_spectrum=True, device=x.device)
        X = torch.fft.fft(x, n=nfft, dim=-1)
        return torch.fft.ifft(X * H, dim=-1)[..., :T]
    H = sos_freq_response(sos, nfft, full_spectrum=False, device=x.device)
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    return torch.fft.irfft(X * H, n=nfft, dim=-1)[..., :T]


def sos_bank_freq_response(sos_bank: np.ndarray, nfft: int, full_spectrum: bool,
                           device=None) -> torch.Tensor:
    """Stacked `sos_freq_response` of a bank ``(B, S, 6)`` → ``(B, F)``
    complex64 on ``device``."""
    return torch.stack([sos_freq_response(sos_bank[b], nfft, full_spectrum, device)
                        for b in range(sos_bank.shape[0])])


def sosfilt_bank_freq(sos_bank: np.ndarray, x: torch.Tensor, nfft: int | None = None
                      ) -> torch.Tensor:
    """Zero-state bank ``(B, S, 6)`` on ``x (..., T)`` → ``(B, ..., T)`` by
    frequency sampling (`dsptoolbox_tpu/ops/iir_freq.py:240`): one forward
    FFT shared by the bands, one band-batched product and inverse FFT."""
    sos_bank = np.asarray(sos_bank)
    B = sos_bank.shape[0]
    T = x.shape[-1]
    if nfft is None:
        ms = [decay_margin(sos_bank[b]) for b in range(B)]
        if any(m is None for m in ms):
            raise ValueError("sosfilt_bank_freq: near-unstable band")
        m = max(ms)
        if m > 8 * T + 4096:
            raise ValueError("sosfilt_bank_freq: margin too large")
        nfft = next_fast_len(T + m, real=True)
    shape = (B,) + (1,) * (x.ndim - 1) + (-1,)
    if np.iscomplexobj(sos_bank) or x.is_complex():
        H = sos_bank_freq_response(sos_bank, nfft, True, x.device).reshape(shape)
        X = torch.fft.fft(x, n=nfft, dim=-1)
        return torch.fft.ifft(X[None] * H, dim=-1)[..., :T]
    H = sos_bank_freq_response(sos_bank, nfft, False, x.device).reshape(shape)
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    return torch.fft.irfft(X[None] * H, n=nfft, dim=-1)[..., :T]

"""IIR filtering entry points (`dsptoolbox_tpu/ops/iir.py`).

``sosfilt`` runs the blocked state-space formulation (`ops.iir_block`);
``sosfilt_zero_state`` routes long zero-state signals to exact frequency
sampling (`ops.iir_freq`); ``sosfiltfilt`` is the zero-phase
forward-backward pass. ``lfilter`` filters a direct form ``(b, a)``:
an FIR above order 2 by one FFT convolution (its state added to the first
outputs), order <= 2 or no state through `iir_block.lfilter_block`, an
IIR's state above order 2 as the SOS cascade of its zeros and poles
(`iir_block.lfilter_statespace`, B2 on a float32 CUDA tensor) or, above
`cuda_iir.MAX_STATES` states, by the float64 doubling of
`linear_recurrence`; ``filtfilt_ba`` is its zero-phase pass. Coefficient handling stays host-side.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import device_cache
from .cuda_iir import MAX_STATES, state_dtype
from .fft_conv import fft_convolve
from .iir_block import lfilter_block, lfilter_statespace, sosfilt_block
from .iir_freq import plan_nfft, sosfilt_freq

# Frequency-sampling window of `sosfilt_zero_state`: the JAX package's TPU
# crossovers, kept for parity until they are measured on the H100.
_FREQ_MIN_T = 4096
_FREQ_MAX_T = 131072


def linear_recurrence(A, Bx: torch.Tensor, zi=None) -> torch.Tensor:
    """Evaluate ``s[n] = A @ s[n-1] + Bx[n]`` for all n by a log-depth
    doubling prefix (`dsptoolbox_tpu/ops/iir.py:47`).

    ``A (N, N)`` the constant transition matrix, ``Bx (T, ..., N)`` the
    per-step injections, ``zi (..., N)`` the state ``s[-1]`` (zeros by
    default) → the states ``s[0..T-1]`` ``(T, ..., N)`` in ``Bx``'s dtype.
    With A constant, ``X_k += A^(2^t) X_(k-2^t)`` replaces the JAX
    package's associative scan over per-step (M, v) pairs: the same sums,
    without materialising T copies of A. The start state rides in as part
    of the first injection, ``v_0 += A zi``.
    """
    A = torch.as_tensor(A, dtype=Bx.dtype, device=Bx.device)
    T = Bx.shape[0]
    X = Bx.clone()
    if zi is not None:
        X[0] += torch.as_tensor(zi, dtype=Bx.dtype, device=Bx.device) @ A.T
    A_pow = A
    shift = 1
    while shift < T:
        X = torch.cat([X[:shift], X[shift:] + X[:-shift] @ A_pow.T], dim=0)
        A_pow = A_pow @ A_pow
        shift *= 2
    return X


def _tdf2_system(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form II state space ``(A, Bvec, b0)`` of the
    normalized ``(b, a)``, host float64 (`dsptoolbox_tpu/ops/iir.py:72`):
    ``s[n] = A s[n-1] + Bvec x[n]``, ``y[n] = b0 x[n] + s_0[n-1]``, the
    state convention of scipy's ``lfilter``/``sosfilt`` zi."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    N = max(len(a), len(b)) - 1
    bp = np.zeros(N + 1)
    ap = np.zeros(N + 1)
    bp[: len(b)] = b
    ap[: len(a)] = a
    A = np.zeros((N, N))
    A[:, 0] = -ap[1:]
    A[: N - 1, 1:] = np.eye(N - 1)
    Bvec = bp[1:] - ap[1:] * bp[0]
    return A, Bvec, bp[0]


def _apply_tdf2(x: torch.Tensor, A: np.ndarray, Bvec: np.ndarray, b0: float, zi):
    """One TDF2 stage over real ``x (..., T)`` by `linear_recurrence`, in
    the state path's dtype (float64 for float32 data). Returns ``(y, zf)``:
    ``y`` in ``x``'s dtype, ``zf (..., N)`` in the state dtype."""
    sdt = state_dtype(x.dtype)
    N = A.shape[0]
    xt = x.movedim(-1, 0).to(sdt)  # (T, ...)
    Bx = xt[..., None] * torch.as_tensor(Bvec, dtype=sdt, device=x.device)
    if zi is not None:
        zi = torch.as_tensor(zi, dtype=sdt, device=x.device).expand(x.shape[:-1] + (N,))
    s = linear_recurrence(A, Bx, zi)  # (T, ..., N)
    first = zi[..., 0] if zi is not None else xt.new_zeros(x.shape[:-1])
    y = b0 * xt + torch.cat([first[None], s[:-1, ..., 0]], dim=0)
    return y.movedim(0, -1).to(x.dtype), s[-1]


def _fir_state(b: np.ndarray, x: torch.Tensor, zi):
    """``lfilter(b, [1], x, zi)`` of an FIR in convolution form: one FFT
    convolution, the TDF2 start state added to the first N outputs, and
    the final state from the last N inputs (plus what is left of ``zi``
    when T < N), in the state path's dtype. Returns ``(y, zf)``."""
    sdt = state_dtype(x.dtype)
    N, T = len(b) - 1, x.shape[-1]
    h = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    y = fft_convolve(x, h)[..., :T]
    zi = torch.as_tensor(zi, dtype=sdt, device=x.device).expand(x.shape[:-1] + (N,))
    n = min(N, T)
    y[..., :n] += zi[..., :n].to(x.dtype)
    # zf[k] = sum_{j>k} b[j] x[T-1-(j-k-1)]: the tail of the convolution
    # of the last N inputs (zeros before the start)
    tail = torch.nn.functional.pad(x[..., -n:].to(sdt), (N - n, 0))
    zf = fft_convolve(tail, torch.as_tensor(b, dtype=sdt, device=x.device))[..., N:2 * N]
    zf[..., : N - n] += zi[..., n:]
    return y, zf


def lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi=None):
    """Direct-form filtering of ``x (..., T)`` along the last axis, matching
    ``scipy.signal.lfilter(b, a, x, zi=zi)`` (TDF2 state convention).
    Returns ``(y, zf)``: ``y`` in ``x``'s dtype, ``zf (..., N)`` in the
    state path's (float64 for float32 data).

    Routes as the JAX package does (`dsptoolbox_tpu/ops/iir.py:128`): an
    FIR above order 2 without state is one FFT convolution; order <= 2, or
    no state, goes to `iir_block.lfilter_block` (B2 on a float32 CUDA
    tensor; above order 2 as a ``tf2sos`` cascade). A state above order 2
    departs from the JAX package, whose float32 associative scan on the
    companion form runs to inf/NaN on low cutoffs (ROADMAP C9): an FIR
    stays one FFT convolution, its state added (`_fir_state`); an IIR of
    up to `cuda_iir.MAX_STATES` states runs as the SOS cascade of its
    zeros and poles, its state mapped to and from the TDF2 layout
    (`iir_block.lfilter_statespace`: float64 state, B2 on a float32 CUDA
    tensor); above that the states run through `linear_recurrence` in
    float64 on the data's device, the route of such orders (B2's chain
    holds 32 states).
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    order = max(len(a), len(b)) - 1
    if len(a) == 1 and order > 2:
        b = b / a[0]
        if zi is None:
            y = fft_convolve(x, torch.as_tensor(b, dtype=x.dtype, device=x.device))
            return y[..., : x.shape[-1]], torch.zeros(
                x.shape[:-1] + (order,), dtype=state_dtype(x.dtype), device=x.device)
        return _fir_state(b, x, zi)
    if order <= 2 or zi is None:
        return lfilter_block(b, a, x, zi=zi)
    if order <= MAX_STATES:
        return lfilter_statespace(b, a, x, zi)[:2]
    A, Bvec, b0 = _tdf2_system(b, a)
    return _apply_tdf2(x, A, Bvec, b0, zi)


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


def sosfilt_assoc(sos: np.ndarray, x: torch.Tensor, zi=None):
    """``sosfilt`` section by section through `linear_recurrence`
    (`dsptoolbox_tpu/ops/iir.py:219`), each section's state in float64.
    ``zi (..., S, 2)``; returns ``(y, zf (..., S, 2))``."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6), got {sos.shape}")
    y = x
    zfs = []
    for s_idx in range(sos.shape[0]):
        A, Bvec, b0 = _tdf2_system(sos[s_idx, :3], sos[s_idx, 3:])
        sec_zi = None if zi is None else torch.as_tensor(zi, device=x.device)[..., s_idx, :]
        y, zf = _apply_tdf2(y, A, Bvec, b0, sec_zi)
        zfs.append(zf)
    return y, torch.stack(zfs, dim=-2)


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state sosfilt initial conditions (host-side, scipy-equivalent).

    Returns ``(S, 2)``: the state such that a unit-step input produces a
    constant output from the first sample.
    """
    from scipy.signal import sosfilt_zi as _zi

    return np.array(_zi(np.asarray(sos, dtype=np.float64)), dtype=np.float64)


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state ``lfilter`` initial state ``(N,)`` (host scipy)."""
    from scipy.signal import lfilter_zi as _zi

    # a copy: some scipy versions return a reversed view (negative strides,
    # which torch refuses, even where numpy calls one element contiguous)
    return np.array(_zi(b, a), dtype=np.float64)


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


def filtfilt_ba(b: np.ndarray, a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase ``(b, a)`` filtering of ``x (..., T)`` matching
    ``scipy.signal.filtfilt``'s defaults: odd padding of
    ``3·max(len(a), len(b))``, each pass started from the steady state
    `lfilter_zi` scaled by its first sample (formed in float64), through
    `lfilter` (B2 twice on a float32 CUDA tensor)."""
    b = np.atleast_1d(b)
    a = np.atleast_1d(a)
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError("Input too short for filtfilt padding")
    zi0 = torch.as_tensor(lfilter_zi(b, a), dtype=state_dtype(x.dtype), device=x.device)
    y = _odd_ext(x, padlen)
    for _ in range(2):
        y, _ = lfilter(b, a, y, zi=zi0 * y[..., :1].to(zi0.dtype))
        y = y.flip(-1)
    return y[..., padlen:-padlen]

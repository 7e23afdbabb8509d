"""Spectral estimation: Welch auto/cross spectra, STFT, cross-spectral matrix
(`dsptoolbox_tpu/ops/spectral.py`).

Inputs are channels-first ``(..., T)``; the FFT runs on the last axis with
(channels × frames) as its batch. The windowed frames come from
`cuda_framing.windowed_frames` (the CUDA kernel on float32 CUDA tensors).
All scaling factors are host-side scalars (see `standard/enums.py`).

Behavioral reference: `dsptoolbox/standard/_spectral_methods.py`. Quirks of
the reference are reproduced intentionally and marked with "parity:" comments.
"""

from __future__ import annotations

from functools import lru_cache
from warnings import warn

import numpy as np
import torch

from .._config import default_float
from .._enums import SpectrumScaling, Window
from .cuda_framing import windowed_frames
from .windows import check_cola, get_window

_VALID_WELCH_SIZES = {2**k for k in range(3, 19)}
_VALID_STFT_SIZES = {2**k for k in range(4, 17)}


@lru_cache(maxsize=32)
def _device_window(data: bytes, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A float64 host window (as bytes) on ``device``, cached: a copy from
    pageable host memory would wait for all queued device work on every
    call."""
    return torch.as_tensor(
        np.frombuffer(data, dtype=np.float64).copy(), dtype=dtype, device=device
    )


def _windowed_frames(
    x: torch.Tensor,
    window: np.ndarray,
    step: int,
    detrend: bool,
    pad: int = 0,
) -> torch.Tensor:
    """Frame ``x (..., T)`` padded with ``pad`` zeros at both ends, apply
    window, optionally remove per-frame mean.

    parity: the reference detrends *after* windowing
    (`_spectral_methods.py:137-148`).
    """
    dt = default_float()
    win = _device_window(
        np.asarray(window, dtype=np.float64).tobytes(), dt, x.device
    )
    return windowed_frames(x.to(dt), win, step, detrend, pad)


def _median_bias_reference(n_frames: int) -> float:
    """parity: the reference (`_spectral_methods.py:154-162`) computes the
    FINDCHIRP median bias with a scalar instead of the harmonic-like series,
    yielding 1/n for odd n. Reproduced verbatim for output parity."""
    n = n_frames if n_frames % 2 == 1 else n_frames - 1
    return float(np.sum((-1.0) ** (n + 1) / n))


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's median: the mean of the two middle values for an even count
    (`torch.median` returns the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = s.shape[dim]
    hi = s.select(dim, n // 2)
    if n % 2:
        return hi
    return 0.5 * (s.select(dim, n // 2 - 1) + hi)


def _average_frames(sp_frames: torch.Tensor, average: str) -> torch.Tensor:
    """Average per-frame (cross-)spectra over the frame axis (-2)."""
    if average == "mean":
        return sp_frames.mean(dim=-2)
    if average == "median":
        if sp_frames.is_complex():
            med = torch.complex(
                _median(sp_frames.real, -2), _median(sp_frames.imag, -2)
            )
        else:
            med = _median(sp_frames, -2)
        return med / _median_bias_reference(sp_frames.shape[-2])
    raise ValueError(f"average must be 'mean' or 'median', got {average!r}")


def _edge(n: int, values, like: torch.Tensor) -> torch.Tensor:
    """One-sided DC/Nyquist correction vector of length ``n`` in the real
    dtype of ``like``: ones with ``values`` at index 0 and -1 (built on the
    device: no host copy)."""
    edge = torch.ones(n, dtype=like.real.dtype, device=like.device)
    edge[0], edge[-1] = values
    return edge


def welch(
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    average: str = "mean",
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
) -> torch.Tensor:
    """Welch auto-/cross-spectral estimation.

    Parameters: ``x`` (and optional ``y``) channels-first ``(..., T)``.
    Returns ``(..., F)`` with ``F = window_length // 2 + 1`` — real for
    autospectra, complex for cross-spectra (before amplitude sqrt).

    Matches `dsptoolbox/standard/_spectral_methods.py:10-173` numerically.
    """
    if window_length_samples not in _VALID_WELCH_SIZES:
        raise ValueError(
            "Window length should be a power of 2 in [2**3, 2**18], got "
            f"{window_length_samples}"
        )
    if not (0 <= overlap_percent < 100):
        raise ValueError("overlap_percent must be in [0, 100)")

    window = get_window(window_type, window_length_samples, symmetric=False)
    overlap = int(overlap_percent / 100 * window_length_samples)
    step = window_length_samples - overlap
    if not check_cola(window, step):
        warn(
            "Selected window type and overlap do not meet the constant "
            "overlap and add constraint! Results might be distorted"
        )

    norm = scaling.fft_norm()
    x_frames = _windowed_frames(x, window, step, detrend)
    if y is None:
        sp_frames = torch.fft.rfft(x_frames, dim=-1, norm=norm).abs() ** 2.0
    else:
        if x.shape != y.shape:
            raise ValueError("Shapes of x and y do not match")
        y_frames = _windowed_frames(y, window, step, detrend)
        sp_frames = torch.conj(
            torch.fft.rfft(x_frames, dim=-1, norm=norm)
        ) * torch.fft.rfft(y_frames, dim=-1, norm=norm)

    csd = _average_frames(sp_frames, average)

    if scaling.has_physical_units():
        # parity: the reference multiplies the *squared* data by the factor
        # returned for the scaling's own representation (linear for amplitude
        # scalings) and only then takes the sqrt (`_spectral_methods.py:164-173`)
        factor = scaling.get_scaling_factor(
            window_length_samples, sampling_rate_hz, window
        )
        csd = csd * factor
        # one-sided correction: halve DC and Nyquist
        csd = csd * _edge(csd.shape[-1], (0.5, 0.5), csd)
    # parity: sqrt applies for every amplitude scaling, incl. bare FFT norms
    if scaling.is_amplitude_scaling():
        csd = torch.sqrt(csd)
    return csd


def stft(
    x: torch.Tensor,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    fft_length_samples: int | None = None,
    detrend: bool = False,
    padding: bool = True,
    scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
):
    """Short-time Fourier transform of ``x (..., T)``.

    Returns ``(time_s, freqs_hz, S)`` with ``S`` shaped ``(..., n_frames, F)``
    (channels-first). Matches `dsptoolbox/standard/_spectral_methods.py:176-282`.
    """
    if window_length_samples not in _VALID_STFT_SIZES:
        raise ValueError(
            "Window length should be a power of 2 in [2**4, 2**16], got "
            f"{window_length_samples}"
        )
    if not (0 <= overlap_percent < 100):
        raise ValueError("overlap_percent must be in [0, 100)")
    if fft_length_samples is None:
        fft_length_samples = window_length_samples

    window = get_window(window_type, window_length_samples, symmetric=False)
    # parity: STFT rounds the overlap, welch truncates (reference :246 vs :107)
    overlap = int(overlap_percent / 100 * window_length_samples + 0.5)
    step = window_length_samples - overlap
    if step <= 0:
        raise ValueError(
            f"overlap_percent={overlap_percent} rounds to a full window "
            f"({overlap}/{window_length_samples} samples): the hop size "
            "would be zero. Reduce the overlap."
        )
    if not check_cola(window, step):
        warn(
            "Selected window type and overlap do not meet the constant "
            "overlap and add constraint! Results might be distorted"
        )

    # the framing reads x in place with ``overlap`` zeros at both ends
    pad = overlap if padding else 0
    length_padded = x.shape[-1] + 2 * pad

    frames = _windowed_frames(x, window, step, detrend, pad)
    S = torch.fft.rfft(
        frames, dim=-1, n=fft_length_samples, norm=scaling.fft_norm()
    )

    if scaling.has_physical_units():
        nyq = 1 / 2**0.5 if fft_length_samples % 2 == 0 else 1.0
        S = S * _edge(S.shape[-1], (1 / 2**0.5, nyq), S)
        factor = scaling.get_scaling_factor(
            fft_length_samples, sampling_rate_hz, window
        )
        if not scaling.is_amplitude_scaling():
            S = S.abs() ** 2.0
        S = S * factor

    n_frames = S.shape[-2]
    time_s = np.linspace(0, length_padded / sampling_rate_hz, n_frames)
    # parity: frequency vector always from the *window* length (:281)
    freqs_hz = np.fft.rfftfreq(len(window), 1 / sampling_rate_hz)
    return time_s, freqs_hz, S


def _complex_sqrt(z: torch.Tensor) -> torch.Tensor:
    """The JAX package's complex square root: a zero imaginary part counts
    as +0, so a negative real takes the root +i·sqrt|z| whatever the sign
    of its zero (C's csqrt, and torch's, give -i·sqrt|z| for -0)."""
    if not z.is_complex():
        return torch.sqrt(z)
    return torch.sqrt(torch.complex(z.real, z.imag + 0.0))


def _assemble_csm_reference_order(Q: torch.Tensor) -> torch.Tensor:
    """Build the Hermitian CSM exactly as the reference does
    (`_spectral_methods.py:351-370`): keep the lower triangle
    ``csm[:, i2, i1] = Q[:, i1, i2]`` (i2 ≥ i1) with halved diagonal, then add
    its conjugate transpose."""
    n_ch = Q.shape[-1]
    lower = Q.transpose(-1, -2)
    mask = torch.ones((n_ch, n_ch), dtype=Q.real.dtype, device=Q.device).tril()
    mask.diagonal().fill_(0.5)
    lower = lower * mask
    return lower + torch.conj(lower.transpose(-1, -2))


def csm_welch(
    time_data: torch.Tensor,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    average: str = "mean",
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
):
    """Cross-spectral matrix of ``time_data (C, T)`` via Welch.

    Returns ``(f, csm)`` with ``csm (F, C, C)``. One batched outer product
    replaces the reference's O(C²) per-pair `_welch` loop
    (`_spectral_methods.py:351-369`).
    """
    if window_length_samples not in _VALID_WELCH_SIZES:
        raise ValueError("Window length should be a power of 2 in [2**3, 2**18]")
    window = get_window(window_type, window_length_samples, symmetric=False)
    overlap = int(overlap_percent / 100 * window_length_samples)
    step = window_length_samples - overlap
    if not check_cola(window, step):
        warn(
            "Selected window type and overlap do not meet the constant "
            "overlap and add constraint! Results might be distorted"
        )

    norm = scaling.fft_norm()
    frames = _windowed_frames(time_data, window, step, detrend)  # (C, K, L)
    X = torch.fft.rfft(frames, dim=-1, norm=norm)  # (C, K, F)

    if average == "mean":
        K = X.shape[-2]
        # Q[f, a, b] = mean_k conj(X[a,k,f]) X[b,k,f] = (Y Yᴴ)[f, b, a] with
        # Y = X as (F, C, K): one layout copy, and the batched product reads
        # Yᴴ as a conjugate-transposed view
        Y = X.permute(2, 0, 1).contiguous()
        Q = torch.matmul(Y, Y.mH).transpose(-1, -2) / K
        # exact-real diagonal like the reference's |X|² autospectrum branch:
        # the product's diagonal is Σ|y|² in its real part
        diag_real = Q.diagonal(dim1=-2, dim2=-1).real
        eye = torch.eye(Q.shape[-1], dtype=Q.real.dtype, device=Q.device)
        Q = Q * (1 - eye) + diag_real[..., None] * eye
    else:
        # median over frames needs the per-pair series; chunk over the first
        # channel axis so the peak buffer is (C, K, F), not (C, C, K, F)
        bias = _median_bias_reference(X.shape[-2])
        rows = []
        for a in range(X.shape[0]):
            pair = torch.conj(X[a])[None, ...] * X  # (C, K, F)
            rows.append(
                torch.complex(_median(pair.real, -2), _median(pair.imag, -2))
            )  # (C, F)
        med = torch.stack(rows, dim=0)  # (A, B, F)
        Q = med.permute(2, 0, 1) / bias

    if scaling.has_physical_units():
        factor = scaling.get_scaling_factor(
            window_length_samples, sampling_rate_hz, window
        )
        Q = Q * factor
        Q = Q * _edge(Q.shape[0], (0.5, 0.5), Q)[:, None, None]
    # parity: per-pair sqrt applies for every amplitude scaling (see welch)
    if scaling.is_amplitude_scaling():
        Q = _complex_sqrt(Q)

    csm = _assemble_csm_reference_order(Q)
    f = np.fft.rfftfreq(window_length_samples, 1 / sampling_rate_hz)
    return f, csm


def csm_from_spectrum(
    spectrum: torch.Tensor,
    scaling: SpectrumScaling,
    window: np.ndarray | None,
    sampling_rate_hz: int,
) -> torch.Tensor:
    """CSM ``(F, C, C)`` from a backward-normalised multichannel spectrum
    ``(F, C)`` (`dsptoolbox_tpu/ops/spectral.py:337`).

    Matches `dsptoolbox/standard/_spectral_methods.py:374-443` (`_csm_fft`),
    including its use of ``F // 2 + 1`` as the length parameter for the
    conversion factor (parity quirk).
    """
    Q = torch.conj(spectrum)[:, :, None] * spectrum[:, None, :]  # (F, a, b)
    csm = _assemble_csm_reference_order(Q)
    if scaling == SpectrumScaling.FFTBackward:
        return csm
    csm = csm * _edge(csm.shape[0], (0.5, 0.5), csm)[:, None, None]
    w = None if window is None else np.asarray(window, dtype=np.float64).reshape(-1)
    factor = SpectrumScaling.FFTBackward.conversion_factor(
        scaling, spectrum.shape[0] // 2 + 1, sampling_rate_hz, w
    )
    csm = csm * factor
    if scaling.is_amplitude_scaling():
        csm = _complex_sqrt(csm)
    return csm

"""Transforms backend: wavelets, synchrosqueezing, VQT kernels, frequency
warping and the arbitrary-frequency DFT (`dsptoolbox_tpu/transforms/_backend.py`).

Behavioral reference: `dsptoolbox/transforms/_transforms.py`.

- The wavelets, the VQT kernels and the warping factors are host numpy,
  copied.
- Synchrosqueezing (`_squeeze_core`) gives every (frequency, time, channel)
  cell its nearest query bin with ``torch.searchsorted`` and adds the cells
  onto their bins with one ``index_put_(..., accumulate=True)`` scatter.
- Warping and the Laguerre transform run through the allpass operator D:
  column n of the T × T matrix D is the first T samples of the impulse
  response of A(z)ⁿ, A(z) = (−λ + z⁻¹)/(1 − λz⁻¹). The JAX package walks
  T serial allpass filterings (`lax.scan`); here, since Aᵐ⁺ⁿ = Aᵐ·Aⁿ, the
  columns are built by doubling (batched float64 FFT convolutions), and D
  is never formed whole: with a tile of M columns, D[:, tM + j] =
  (D[:, tM] ∗ D[:, j])[:T], so D·x = Σ_t D[:, tM] ∗ (D[:, :M]·x_t) — one
  float64 matrix product and one batched FFT convolution
  (`allpass_apply`), and the transpose likewise (`allpass_apply_t`). No
  launch per output sample: O(log T) doublings and a few batched calls.
  float64 throughout (the card has native fp64 and cuFFT double), the
  result in the input's dtype.
- The DFT at arbitrary frequencies forms each phase n·f/T mod 1 in float64
  on the device (the JAX package splits it into a coarse host table and a
  fine float32 term, a TPU precision workaround), exponentiates it in the
  data's dtype and multiplies, in chunks of frequencies × samples whose
  partial sums add in complex128.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.signal import get_window

from ..ops.fft_conv import next_fast_len

# bytes of the largest temporary tile of `allpass_apply`, `allpass_apply_t`
# and `dft_core`
TILE_BYTES = 1 << 29


def pitch2frequency(tuning_a_hz: float = 440) -> np.ndarray:
    """MIDI pitches 0..127 → Hz (`_transforms.py:10-26`)."""
    N = 128
    return tuning_a_hz * 2 ** ((np.arange(N) - 69) / 12)


class Wavelet:
    """Base wavelet (API parity with `_transforms.py:29-83`)."""

    def get_base_wavelet(self):
        raise NotImplementedError("Wavelet function has not been implemented")

    def get_wavelet(self, f, fs):
        raise NotImplementedError("Wavelet function has not been implemented")

    def get_center_frequency(self):
        x, func = self.get_base_wavelet()
        ind = np.argmax(np.abs(np.fft.fft(func)))
        domain = x[-1] - x[0]
        return ind / domain

    def get_scale_lengths(self, frequencies, fs: int):
        scales = np.atleast_1d(self.get_center_frequency() / frequencies * fs)
        x, _ = self.get_base_wavelet()
        return (scales * (x[-1] - x[0]) + 1).astype(int)


class MorletWavelet(Wavelet):
    """Complex Morlet wavelet (`_transforms.py:86-225`)."""

    def __init__(
        self,
        b: float | None = None,
        h: float | None = None,
        scale: float = 1.0,
        precision_bounds: float = 1e-5,
        step: float = 5e-3,
        interpolation: bool = True,
    ):
        assert b is not None or h is not None, "Either b or h must be passed"
        self.b = h**2 / np.log(2) / 4 if h is not None else b
        self.scale = scale
        t = np.sqrt(self.b * np.log(1 / precision_bounds))
        self.bounds = [-t, t]
        self.step = step
        self.interpolation = interpolation

    def _get_x(self) -> np.ndarray:
        return np.arange(self.bounds[0], self.bounds[1] + self.step, self.step)

    def get_base_wavelet(self):
        x = self._get_x()
        return x, 1 / np.sqrt(np.pi * self.b) * np.exp(
            2j * np.pi / self.scale * x
        ) * np.exp(-(x**2) / self.b)

    def get_center_frequency(self) -> float:
        return 1 / self.scale

    def get_wavelet(self, f, fs: int):
        scales = np.atleast_1d(self.get_center_frequency() / f * fs)
        x, base = self.get_base_wavelet()
        wave = []
        for scale in scales:
            inds = np.arange(scale * (x[-1] - x[0]) + 1) / (scale * self.step)
            trunc = inds.astype(int)
            trunc = trunc[trunc < len(base)]
            if self.interpolation:
                # vectorized linear interpolation (the reference loops,
                # `_transforms.py:205-225`)
                frac = inds[: len(trunc)] - trunc
                nxt = np.minimum(trunc + 1, len(base) - 1)
                wavef = base[trunc] + (base[nxt] - base[trunc]) * frac
                wavef[-1] = base[trunc[-1]]
            else:
                wavef = base[trunc]
            if len(scales) == 1:
                return wavef
            wave.append(wavef)
        return wave


def squeeze_scalogram(
    scalogram,
    freqs: np.ndarray,
    fs: int,
    delta_w: float = 0.05,
    apply_frequency_normalization: bool = False,
):
    """Synchrosqueezing by phase-transform reassignment
    (`_transforms.py:227-301`) of a complex scalogram ``(F, T, C)``: numpy
    in, numpy out (on the CPU), or a tensor on its device."""
    if torch.is_tensor(scalogram):
        return _squeeze_core(scalogram, freqs, fs, delta_w, apply_frequency_normalization)
    sc = torch.as_tensor(np.asarray(scalogram))
    return _squeeze_core(sc, freqs, fs, delta_w, apply_frequency_normalization).numpy()


def _squeeze_core(
    sc: torch.Tensor,
    freqs: np.ndarray,
    fs: int,
    delta_w: float = 0.05,
    apply_frequency_normalization: bool = False,
) -> torch.Tensor:
    """Complex scalogram ``(F, T, C)`` → complex synchrosqueezed matrix of
    the same shape (`dsptoolbox_tpu/transforms/_backend.py:132`)."""
    freqs = np.asarray(freqs)
    n_f = len(freqs)
    rdt = sc.real.dtype
    dev = sc.device
    scalpow = sc.abs().square()
    valid = scalpow > 1e-40
    # the phase transform: d/dt of the scalogram (np.gradient's edges)
    ph = torch.cat([sc[:, 1:2] - sc[:, 0:1], (sc[:, 2:] - sc[:, :-2]) / 2.0,
                    sc[:, -1:] - sc[:, -2:-1]], dim=1)
    ph = torch.where(valid, (ph / torch.where(valid, sc, 1.0)).imag / 2 / np.pi, 0.0)
    ph = ph.abs() * fs
    # the nearest query bin by a search of the sorted grid
    order = np.argsort(freqs)
    grid = torch.as_tensor(freqs[order], dtype=rdt, device=dev)
    pos = torch.searchsorted(grid, ph.contiguous())
    lo = (pos - 1).clamp(0, n_f - 1)
    hi = pos.clamp(0, n_f - 1)
    pick_hi = (grid[hi] - ph).abs() < (grid[lo] - ph).abs()
    ind_sorted = torch.where(pick_hi, hi, lo)
    min_diff = (grid[ind_sorted] - ph).abs()
    ind = torch.as_tensor(order, device=dev)[ind_sorted]
    limit = torch.as_tensor(delta_w * freqs, dtype=rdt, device=dev)[:, None, None]
    keep = (min_diff <= limit) & valid
    contrib = sc
    if apply_frequency_normalization:
        norm = torch.as_tensor((freqs / fs) ** (3 / 2), dtype=rdt, device=dev)
        contrib = sc * norm[:, None, None]
    contrib = torch.where(keep, contrib, 0.0)
    # each cell's value onto its query bin: one scatter-add over the real
    # and imaginary planes
    T, C = sc.shape[1], sc.shape[2]
    tt = torch.arange(T, device=dev)[None, :, None]
    cc = torch.arange(C, device=dev)[None, None, :]
    sync = torch.zeros((n_f, T, C, 2), dtype=rdt, device=dev)
    sync.index_put_((ind, tt, cc), torch.view_as_real(contrib), accumulate=True)
    return torch.view_as_complex(sync)


def get_kernels_vqt(
    q: float,
    highest_f: float,
    bins_per_octave: int,
    sampling_rate_hz: int,
    window_type,
    gamma: float,
):
    """Complex VQT kernels, high → low frequency (`_transforms.py:327-384`)."""
    freqs = highest_f * 2 ** (-1 / bins_per_octave * np.arange(bins_per_octave))
    factor = 2 ** (1 / bins_per_octave) - 1
    lengths = np.round(q * sampling_rate_hz / ((freqs * factor) + gamma)).astype(int)
    kernels = []
    for ind in range(len(lengths)):
        w = get_window(window_type, lengths[ind], fftbins=False)
        w = w / w.sum()
        kernels.append(
            w * np.exp(1j * freqs[ind] * 2 * np.pi / sampling_rate_hz
                       * np.arange(-lengths[ind] // 2, lengths[ind] // 2))
        )
    return kernels


def same_mode_bank(x: torch.Tensor, kernels: list) -> torch.Tensor:
    """``fft_convolve(x, k, "same")`` for every kernel of ``kernels`` (host
    arrays of any lengths) in one batched complex FFT convolution:
    ``x (..., T)`` → ``(len(kernels), ..., T)``. Each kernel is shifted by
    the difference of its "same" crop from the longest one's, so that one
    crop serves them all."""
    T = x.shape[-1]
    starts = [(len(k) - 1) // 2 for k in kernels]
    s_max = max(starts)
    width = max(s_max - s + len(k) for s, k in zip(starts, kernels))
    bank = np.zeros((len(kernels), width), np.complex128)
    for i, (s, k) in enumerate(zip(starts, kernels)):
        bank[i, s_max - s : s_max - s + len(k)] = k
    cdt = torch.complex128 if x.dtype in (torch.float64, torch.complex128) else torch.complex64
    n = next_fast_len(T + width - 1, real=False)
    h = torch.fft.fft(torch.as_tensor(bank, dtype=cdt, device=x.device), n=n)
    h = h.reshape((len(kernels),) + (1,) * (x.ndim - 1) + (n,))
    y = torch.fft.ifft(torch.fft.fft(x.to(cdt), n=n) * h, n=n)
    return y[..., s_max : s_max + T]


# ======== the allpass operator ==============================================
def conv_head(a: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """The first ``n_out`` samples of ``a ∗ b`` along the last axes (real,
    broadcast over the others), through an FFT of the full length."""
    n = next_fast_len(a.shape[-1] + b.shape[-1] - 1)
    return torch.fft.irfft(torch.fft.rfft(a, n=n) * torch.fft.rfft(b, n=n), n=n)[..., :n_out]


def allpass_ir(warping_factor: float, T: int, device) -> torch.Tensor:
    """The first T samples of A(z) = (−λ + z⁻¹)/(1 − λz⁻¹)'s impulse
    response, float64: −λ, then (1 − λ²)·λⁿ⁻¹."""
    lam = float(warping_factor)
    n = torch.arange(T, dtype=torch.float64, device=device)
    h = (1.0 - lam**2) * torch.pow(torch.tensor(lam, dtype=torch.float64, device=device),
                                   (n - 1).clamp(min=0))
    h[0] = -lam
    return h


def power_columns(base: torch.Tensor, n_cols: int) -> tuple:
    """``(P (n_cols, T), base^{∗m})``: row k of P is the first T samples of
    ``base`` convolved with itself k times (row 0 a dirac), built by
    doubling; m is the power of two at or above ``n_cols``."""
    T = base.shape[-1]
    rows = torch.zeros((1, T), dtype=base.dtype, device=base.device)
    rows[0, 0] = 1.0
    p = base
    while rows.shape[0] < n_cols:
        rows = torch.cat([rows, conv_head(p, rows, T)])
        p = conv_head(p, p, T)
    return rows[:n_cols], p


def _tile(T: int, C: int) -> int:
    """Columns M of the allpass tile: the power of two nearest √(T·C) (M
    direct columns and ⌈T/M⌉·C convolutions of length 2T), at most T's."""
    cap = 1 << max(0, (T - 1).bit_length())
    return min(cap, 1 << max(0, round(math.log2(max(1.0, math.sqrt(T * C))))))


def _operators(warping_factor: float, T: int, M: int, device) -> tuple:
    """``(D[:, :M] as (M, T), D[:, ::M] as (⌈T/M⌉, T))``."""
    d, a_m = power_columns(allpass_ir(warping_factor, T, device), M)
    e, _ = power_columns(a_m, -(-T // M))
    return d, e


def allpass_apply(x: torch.Tensor, warping_factor: float, tile: int | None = None) -> torch.Tensor:
    """D·x for ``x (T, C)``: Σₙ x[n]·Aⁿδ truncated to T samples (the JAX
    package's `warp_time_series` scan). Float64 inside; returns x's dtype."""
    T, C = x.shape
    M = tile or _tile(T, C)
    d, e = _operators(warping_factor, T, M, x.device)
    nt = e.shape[0]
    x64 = torch.nn.functional.pad(x.to(torch.float64), (0, 0, 0, nt * M - T))
    n = next_fast_len(2 * T - 1)
    e_f = torch.fft.rfft(e, n=n)  # (nt, F)
    out = torch.empty((C, T), dtype=torch.float64, device=x.device)
    per = max(1, TILE_BYTES // (nt * (n // 2 + 1) * 16))
    for c0 in range(0, C, per):
        xc = x64[:, c0 : c0 + per].reshape(nt, M, -1)  # (nt, M, c)
        # z[t, c, :] = D[:, :M]·x_t: one float64 product for every tile
        z = torch.einsum("mi,tmc->tci", d, xc)
        y = torch.einsum("tf,tcf->cf", e_f, torch.fft.rfft(z, n=n))
        out[c0 : c0 + per] = torch.fft.irfft(y, n=n)[:, :T]
    return out.T.to(x.dtype)


def allpass_apply_t(v: torch.Tensor, warping_factor: float,
                    tile: int | None = None) -> torch.Tensor:
    """Dᵀ·v for ``v (T, C)``: output k is Σᵢ D[i, k]·v[i], the last sample
    of Aᵏ applied to the reversed v. Float64 inside; returns v's dtype."""
    T, C = v.shape
    M = tile or _tile(T, C)
    d, e = _operators(warping_factor, T, M, v.device)
    nt = e.shape[0]
    n = next_fast_len(2 * T - 1)
    d_f = torch.fft.rfft(d, n=n).conj()  # (M, F)
    v_f = torch.fft.rfft(v.to(torch.float64).T, n=n)  # (C, F)
    out = torch.empty((C, nt * M), dtype=torch.float64, device=v.device)
    per = max(1, TILE_BYTES // (M * (n // 2 + 1) * 16))
    for c0 in range(0, C, per):
        # cor[c, j, m] = Σᵢ v[i]·D[i − m, j], then output tM + j is
        # Σₘ D[m, tM]·cor[c, j, m]
        cor = torch.fft.irfft(v_f[c0 : c0 + per, None, :] * d_f, n=n)[..., :T]
        out[c0 : c0 + per] = torch.einsum("tm,cjm->ctj", e, cor).reshape(-1, nt * M)
    return out[:, :T].T.to(v.dtype)


def warp_time_series(td, warping_factor: float) -> torch.Tensor:
    """Warp (or unwarp) a time series ``(T, C)`` through the cascaded
    allpass expansion (`_transforms.py:386-430`): `allpass_apply`, on the
    tensor's device (numpy goes to the CPU)."""
    x = td if torch.is_tensor(td) else torch.as_tensor(np.asarray(td))
    return allpass_apply(x, warping_factor)


def get_warping_factor(warping_factor, fs_hz: int) -> float:
    """Bark/ERB bilinear warping factors (Smith & Abel 1999;
    `_transforms.py:433-464`)."""
    if isinstance(warping_factor, float):
        assert np.abs(warping_factor) < 1.0, "Warping factor has to be in ]-1; 1["
        return warping_factor
    if isinstance(warping_factor, str):
        wf = warping_factor.lower()
        invert = wf[-1] not in ("k", "b")
        if "bark" in wf:
            value = -1.0 * (1.0674 * (2.0 / np.pi * np.arctan(0.06583 * fs_hz)) ** 0.5 - 0.1916)
        elif "erb" in wf:
            value = -1.0 * (0.7446 * (2.0 / np.pi * np.arctan(0.1418 * fs_hz)) ** 0.5
                            + 0.03237)
        else:
            raise ValueError("Warping factor approximation is not supported")
        return -value if invert else value
    raise TypeError("Invalid type for warping factor")


def dft_core(time_data: torch.Tensor, freqs_normalized: np.ndarray,
             chunk: int = 256) -> torch.Tensor:
    """``spec[f, c] = Σₙ exp(−2πi·f·n/T)·x[n, c]`` for ``time_data (T, C)``
    (the numba kernel of `_transforms.py:466-500`): the phase (f/T mod 1)·n
    mod 1 in float64 on the device, its exponential in the data's complex
    dtype, a product per chunk of ``chunk`` frequencies and the samples
    that fit `TILE_BYTES`, the chunks' sums added in complex128."""
    T, C = time_data.shape
    dev = time_data.device
    rdt = torch.float64 if time_data.dtype == torch.float64 else torch.float32
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    x = time_data.to(cdt)
    fr = np.asarray(freqs_normalized, np.float64).reshape(-1)
    omega = torch.as_tensor(np.mod(fr / T, 1.0), dtype=torch.float64, device=dev)
    F = len(fr)
    out = torch.zeros((F, C), dtype=torch.complex128, device=dev)
    step = max(1, TILE_BYTES // (min(chunk, F) * 16))
    for t0 in range(0, T, step):
        n = torch.arange(t0, min(T, t0 + step), dtype=torch.float64, device=dev)
        for f0 in range(0, F, chunk):
            ph = omega[f0 : f0 + chunk, None] * n
            ph = (ph - torch.floor(ph)).to(rdt)
            m = torch.polar(torch.ones_like(ph), (-2 * np.pi) * ph)
            out[f0 : f0 + chunk] += (m @ x[t0 : t0 + len(n)]).to(torch.complex128)
    return out.to(cdt)

"""Backend of the `standard` module (`dsptoolbox_tpu/standard/backend.py`).

Host float64 numpy, copied as they are: the Kaiser-windowed-sinc fractional
delay filters (the beamforming module's projections and
`standard.fractional_delay`), and the IEC fractional-octave center
frequencies of the filter banks. On the data's device: the integer latency
from the FFT cross-correlation's peak, and the activity detector's mask.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import iv as bessel_first_mod

from ..ops.fft_conv import fft_correlate


def latency_integer(in1: torch.Tensor, in2: torch.Tensor | None, *_) -> np.ndarray:
    """Integer-sample latency from the cross-correlation's peak
    (`_standard_backend.py:14-35`); ``in1``/``in2`` ``(T, C)`` on one
    device, one fetch of the ``(C,)`` peak indices.

    parity: without ``in2`` the reference's 2-D scipy correlate flips the
    channel axis of its second input, so the latencies of 3+ channels come
    back in reversed channel order (as `helpers.latency.fractional_latency`).
    """
    if in2 is None:
        xcorr = fft_correlate(in1[:, :1].T, in1[:, 1:].flip(1).T)
    else:
        xcorr = fft_correlate(in2.T, in1.T)
    peak_inds = xcorr.abs().argmax(dim=-1).cpu().numpy()
    return in1.shape[0] - peak_inds - 1


def kaiser_window_beta(A: float) -> float:
    """Kaiser beta from desired side-lobe suppression
    (`_standard_backend.py:259-287`)."""
    A = abs(A)
    if A > 50:
        return 0.1102 * (A - 8.7)
    if A >= 21:
        return 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21)
    return 0.0


def kaiser_window_fractional(
    length: int, side_lobe_suppression_db: float, fractional_delay: float
) -> np.ndarray:
    """Kaiser window with fractional offset (static design,
    `_standard_backend.py:289-323`)."""
    filter_order = length - 1
    alpha = filter_order / 2
    beta = kaiser_window_beta(abs(side_lobe_suppression_db))
    L = np.arange(length).astype(float) - fractional_delay
    if filter_order % 2:
        L += 0.5
    elif fractional_delay > 0.5:
        L += 1
    Z = beta * np.sqrt(
        np.array(1 - ((L - alpha) / alpha) ** 2, dtype="complex")
    )
    return np.real(bessel_first_mod(0, Z)) / bessel_first_mod(0, beta)


def fractional_delay_filter(
    delay_samples: float,
    filter_order: int,
    side_lobe_suppression_db: float,
) -> tuple[int, np.ndarray]:
    """Kaiser-windowed-sinc fractional delay FIR (static design; pyfar/Laakso
    method, `_standard_backend.py:430-493`). Returns (integer delay, fir)."""
    delay_int = int(delay_samples)
    delay_frac = delay_samples - delay_int
    if filter_order % 2:
        M_opt = int(delay_frac) - (filter_order - 1) / 2
    else:
        M_opt = np.round(delay_frac) - filter_order / 2
    n = np.arange(filter_order + 1) + M_opt - delay_frac
    sinc = np.sinc(n)
    kaiser = kaiser_window_fractional(
        filter_order + 1, side_lobe_suppression_db, delay_frac
    )
    return int(delay_int + M_opt), sinc * kaiser


def fractional_delay_filter_batch(
    delay_samples: np.ndarray,
    filter_order: int,
    side_lobe_suppression_db: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized `fractional_delay_filter` over a vector of D delays:
    returns ``(integer delays (D,) int, firs (D, order+1))`` — the same
    Kaiser-sinc design (`_standard_backend.py:430-493`) built with one
    numpy program instead of D scalar calls. Feeds the batched
    monopole projection in `beamforming`."""
    d = np.asarray(delay_samples, np.float64).reshape(-1)
    delay_int = d.astype(np.int64)
    delay_frac = d - delay_int
    length = filter_order + 1
    if filter_order % 2:
        M_opt = delay_frac.astype(np.int64) - (filter_order - 1) / 2
    else:
        M_opt = np.round(delay_frac) - filter_order / 2
    n = np.arange(length)[None, :] + M_opt[:, None] - delay_frac[:, None]
    sinc = np.sinc(n)
    # fractional Kaiser window (kaiser_window_fractional, vectorized)
    alpha = filter_order / 2
    beta = kaiser_window_beta(abs(side_lobe_suppression_db))
    L = np.arange(length, dtype=np.float64)[None, :] - delay_frac[:, None]
    if filter_order % 2:
        L = L + 0.5
    else:
        L = L + (delay_frac > 0.5)[:, None].astype(np.float64)
    Z = beta * np.sqrt(
        np.asarray(1 - ((L - alpha) / alpha) ** 2, dtype=complex)
    )
    kaiser = np.real(bessel_first_mod(0, Z)) / bessel_first_mod(0, beta)
    return (delay_int + M_opt).astype(np.int64), sinc * kaiser


def center_frequencies_fractional_octaves_iec(num_fractions: int):
    """IEC 61260-1:2014 nominal and exact center frequencies of octave and
    third-octave bands (`dsptoolbox_tpu/standard/backend.py:91`)."""
    if num_fractions == 1:
        nominal = np.array(
            [31.5, 63, 125, 250, 500, 1e3, 2e3, 4e3, 8e3, 16e3], dtype=float
        )
    elif num_fractions == 3:
        nominal = np.array(
            [25, 31.5, 40, 50, 63, 80, 100, 125, 160, 200, 250, 315, 400,
             500, 630, 800, 1000, 1250, 1600, 2000, 2500, 3150, 4000, 5000,
             6300, 8000, 10000, 12500, 16000, 20000],
            dtype=float,
        )
    else:
        raise ValueError("Nominal frequencies only for fractions 1 and 3")
    reference_freq = 1e3
    octave_ratio = 10 ** (3 / 10)
    if num_fractions % 2 != 0:
        indices = np.around(
            num_fractions * np.log(nominal / reference_freq) / np.log(octave_ratio)
        )
        exponent = indices / num_fractions
    else:
        indices = (
            np.around(
                2.0 * num_fractions * np.log(nominal / reference_freq)
                / np.log(octave_ratio) - 1
            )
            / 2
        )
        exponent = (2 * indices + 1) / num_fractions / 2
    return nominal, reference_freq * octave_ratio**exponent


def exact_center_frequencies_fractional_octaves(
    num_fractions: int, frequency_range
) -> np.ndarray:
    """Center frequencies of arbitrary fractional-octave bands
    (`dsptoolbox_tpu/standard/backend.py:132`)."""
    ref_freq = 1e3
    Nmax = np.around(num_fractions * np.log2(frequency_range[1] / ref_freq))
    Nmin = np.around(num_fractions * np.log2(ref_freq / frequency_range[0]))
    indices = np.arange(-Nmin, Nmax + 1)
    return ref_freq * 2 ** (indices / num_fractions)


def first_order_scan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``g[i] = A[i]·g[i-1] + B[i]`` from ``g[-1] = 0`` along ``A (T,)``,
    ``B (T,)``: composed affine maps (A, B) ∘ (A', B') = (A·A', A·B' + B)
    doubled over strides 1, 2, 4, …, log₂ T elementwise passes in the data's
    dtype (the shape of the JAX package's ``associative_scan``)."""
    s = 1
    T = A.shape[0]
    while s < T:
        B = torch.cat([B[:s], A[s:] * B[:-s] + B[s:]])
        A = torch.cat([A[:s], A[s:] * A[:-s]])
        s *= 2
    return B


def indices_above_threshold_dbfs(
    time_vec: torch.Tensor,
    threshold_dbfs: float,
    attack_smoothing_coeff: float,
    release_smoothing_coeff: float,
    normalize: bool = True,
) -> torch.Tensor:
    """Boolean activity mask ``(T,)`` on the data's device from a smoothed
    power envelope, the reference's recursion
    (`dsptoolbox_tpu/standard/backend.py:230`)."""
    x = time_vec.reshape(-1)
    if normalize:
        x = x / x.abs().max()
    power = x**2
    # parity: the reference compares momentary_gain[i] (still zero when
    # read) with time_power[i-1], so the attack branch never fires and the
    # coefficient is the release one unless the previous power is exactly
    # 0 (`_standard_backend.py:324-380`). The coefficient depends only on
    # the previous input power, not on the carry, so
    #   g[i] = c[i]·p[i] + (1-c[i])·g[i-1]
    # is a first-order recurrence with known coefficients
    p_prev, p_cur = power[:-1], power[1:]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    coeff = torch.where(
        p_prev < 0,
        zero + attack_smoothing_coeff,
        torch.where(p_prev > 0, zero + release_smoothing_coeff, zero),
    )
    gains = first_order_scan(1.0 - coeff, coeff * p_cur)
    momentary_gain = torch.cat([x.new_zeros(1), gains])
    return 10.0 * torch.log10(momentary_gain) > threshold_dbfs


def indices_above_threshold_dbfs_packed(
    time_vec: torch.Tensor,
    threshold_dbfs: float,
    attack_smoothing_coeff: float,
    release_smoothing_coeff: float,
    normalize: bool = True,
) -> torch.Tensor:
    """The mask of `indices_above_threshold_dbfs` packed on the device into
    uint8 in ``np.unpackbits``' layout (big-endian bit order): an 8× smaller
    fetch. Unpack with ``np.unpackbits(out.cpu().numpy())[:T].astype(bool)``
    (`dsptoolbox_tpu/standard/backend.py:257`)."""
    return pack_bits(indices_above_threshold_dbfs(
        time_vec, threshold_dbfs, attack_smoothing_coeff, release_smoothing_coeff, normalize))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """A boolean ``(T,)`` mask as uint8 in ``np.unpackbits``' layout, on its
    device."""
    T = mask.shape[0]
    bits = torch.cat([mask.to(torch.uint8), mask.new_zeros((-T) % 8, dtype=torch.uint8)])
    weights = (2 ** torch.arange(7, -1, -1, device=mask.device)).to(torch.uint8)
    return (bits.reshape(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)

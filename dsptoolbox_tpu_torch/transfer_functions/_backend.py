"""Transfer-function measurement backend
(`dsptoolbox_tpu/transfer_functions/_backend.py`): regularized spectral
deconvolution, peak-aligned and peak-centered IR windowing,
fractional-octave complex smoothing, frequency-dependent windowing
(`fdw_core`), the exponential chirp's harmonic times, and the IR trimming
indices that the room-acoustics fits and `trim_ir` use.

Behavioral reference: `dsptoolbox/transfer_functions/_transfer_functions.py`.
Host float64 numpy constructions (the regularization window, the windowing's
index arithmetic, the smoothing operators) are copied as they are; the
bulk data stays on its device. Complex smoothing applies the banded
operator through `ops.banded.banded_apply` (the CUDA kernel
`csrc/banded.cu` on a float32 CUDA tensor) at every grid size: the JAX
package's dense (F×F) operator at ≤ 4096 bins is not ported.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from .._config import default_float, device_cache
from ..helpers.gain_and_level import to_db
from ..helpers.other import find_nearest_points_index_in_vector, pearson_correlation
from ..helpers.smoothing import time_smoothing_host
from ..helpers.windows_extra import calculate_tukey_like_window
from ..ops.banded import banded_apply, plan_to_torch
from .._enums import Window


def spectral_deconvolve_core(
    num_fft: torch.Tensor,
    denum_fft: torch.Tensor,
    time_signal_length: int,
    eps,
) -> torch.Tensor:
    """Batched regularized spectral division → irfft.

    ``num_fft``/``denum_fft`` shaped ``(F, C)``; ``eps`` is the
    regularization profile (already scaled), shaped ``(F, C)`` or ``(F, 1)``
    broadcasting over channels, a float for a flat profile, or None for
    plain division.
    Mirrors `_transfer_functions.py:19-43`.
    """
    if eps is not None:
        if not isinstance(eps, float):
            eps = torch.as_tensor(
                eps, dtype=num_fft.real.dtype, device=num_fft.device
            )
        denum_reg = torch.conj(denum_fft) / (denum_fft.abs() ** 2 + eps)
        product = num_fft * denum_reg
    else:
        product = num_fft / denum_fft
    return torch.fft.irfft(product, n=time_signal_length, dim=0)


def regularization_window(
    start_stop_hz, freqs_hz: np.ndarray, window_type=Window.Hann
) -> np.ndarray:
    """Inverse Tukey-like window scaled by +30 dB — the regularization
    spectrum of the reference (`_transfer_functions.py:30-36`)."""
    ids = find_nearest_points_index_in_vector(start_stop_hz, freqs_hz)
    return calculate_tukey_like_window(
        ids, len(freqs_hz), window_type, True, inverse=True
    ) * 10 ** (30 / 20)


def regularization_window_traced(
    first: torch.Tensor, last: torch.Tensor, n_freqs: int, f0: float, df: float,
    nyquist_hz: float,
) -> torch.Tensor:
    """In-program twin of :func:`regularization_window` for the automatic
    range (Hann flanks), from the first and last bins above the threshold
    (0-d tensors on the device) to the scaled inverse window ``(F, 1)``, with
    no host read (`dsptoolbox_tpu/transfer_functions/_backend.py:69-121`).
    The Hann half-flanks are written analytically (``sin²``/``cos²`` of the
    periodic window the host builds with scipy); the frequency grid's
    arithmetic in the package's float can place a flank ±1 bin off the
    float64 host build."""
    dt = default_float()
    dev = first.device
    n = torch.arange(n_freqs, device=dev)
    freqs = f0 + n.to(dt) * df
    fl = f0 + first.to(dt) * df
    fh = f0 + last.to(dt) * df
    targets = torch.stack(
        [fl / np.sqrt(2.0), fl, fh, torch.clamp(fh * np.sqrt(2.0), max=nyquist_hz)]
    )
    i0, i1, i2, i3 = torch.argmin((freqs[None, :] - targets[:, None]).abs(), dim=1)
    len_low = torch.clamp(i1 - i0, min=1).to(dt)
    len_high = torch.clamp(i3 - i2, min=1).to(dt)
    one = torch.ones((), dtype=dt, device=dev)
    low = torch.sin(torch.pi * (n - i0).to(dt) / (2.0 * len_low)) ** 2
    low = torch.where(i1 - i0 > 0, low, one)
    high = torch.cos(torch.pi * (n - i2).to(dt) / (2.0 * len_high)) ** 2
    high = torch.where(i3 - i2 > 1, high, one)
    w = torch.where(
        n < i0, 0.0,
        torch.where(n < i1, low, torch.where(n < i2, one, torch.where(n < i3, high, 0.0))),
    )
    return ((1.0 - w) * 10.0 ** (30.0 / 20.0))[:, None]


@device_cache(32)
def regularization_window_device(
    ssz_t: tuple, n_freqs: int, f0: float, df: float, dtype, device
) -> torch.Tensor:
    """Cached regularization column ``(F, 1)`` on ``device``: the host build
    (scipy window, nearest-index search over the rfft grid) is fully
    determined by ``(ssz, F, f0, df)`` (`_backend.py:124-140` of the JAX
    package)."""
    freqs = f0 + np.arange(n_freqs) * df
    eps_col = regularization_window(np.asarray(ssz_t), freqs)
    return torch.as_tensor(eps_col[:, None], dtype=dtype, device=device)


def window_this_ir_tukey_meta(
    signal_length: int,
    impulse_index: int,
    total_length: int,
    window_type,
    constant_percentage: float,
    at_start: bool,
    offset_samples: int,
    left_to_right_flank_ratio: float,
    adaptive_window: bool,
):
    """Index-space form of the peak-aligned adaptive Tukey windowing
    (`_transfer_functions.py:45-148`): everything the reference's
    data-dependent trimming decides is a function of only the channel
    length and its peak position, so the bulk data can stay on device.

    Returns ``(slice_start, window, start_sample)`` such that the windowed
    channel equals ``window * zext(vec)[slice_start : slice_start +
    total_length]`` where ``zext`` reads out-of-range samples as zeros
    (``slice_start`` may be negative).
    """
    start_sample = 0
    flank_length_total = int((1 - constant_percentage) * total_length)
    left_flank_length = int(
        flank_length_total * 0.5 * left_to_right_flank_ratio
    )
    right_flank_length = max(flank_length_total - left_flank_length, 0)
    impulse_index = int(impulse_index)
    T = int(signal_length)
    # `front` = zeros the reference prepends to the working vector;
    # `drop` = samples it slices off the front of that padded vector
    front = 0
    drop = 0

    if not adaptive_window:
        padding_left = 0
        if impulse_index - offset_samples < 0:
            pad_length = -int(impulse_index - offset_samples)
            front += pad_length
            impulse_index += pad_length
            start_sample += pad_length
            padding_left += pad_length
        else:
            impulse_index -= offset_samples
        if impulse_index - left_flank_length < 0:
            pad_length = int(-(impulse_index - left_flank_length))
            front += pad_length
            start_sample += pad_length
            padding_left += pad_length
        else:
            drop = impulse_index - left_flank_length
            start_sample = impulse_index - left_flank_length
            impulse_index = left_flank_length
        current_length = front + T - drop
        padding_right = max(0, total_length - current_length)
        points = [
            0,
            left_flank_length,
            total_length - right_flank_length,
            total_length,
        ]
        assert not np.any(np.ediff1d(points) < 0), (
            "A valid window could not be constructed with given parameters."
        )
        window = calculate_tukey_like_window(
            points, total_length, window_type, at_start=at_start,
            inverse=False,
        )
        window[:padding_left] = 0
        if padding_right != 0:
            window[-padding_right:] = 0
        return drop - front, window, start_sample

    # adaptive path
    if impulse_index - offset_samples - left_flank_length < 0:
        left_flank_length = max(0, impulse_index - offset_samples)
    else:
        start_sample = impulse_index - offset_samples - left_flank_length
        drop = start_sample
    current_length = min(T - drop, total_length)
    padding_after_adaptation = 0
    effective_length = total_length
    if current_length < total_length:
        padding_after_adaptation = total_length - current_length
        effective_length = current_length
    if (
        left_flank_length + offset_samples
        > effective_length - right_flank_length
    ):
        right_flank_length = (
            effective_length - left_flank_length - offset_samples - 1
        )
    points = [
        0,
        left_flank_length,
        effective_length - right_flank_length,
        effective_length,
    ]
    assert not np.any(np.ediff1d(points) < 0), (
        "A valid window could not be constructed with given parameters."
    )
    window = calculate_tukey_like_window(
        points, effective_length, window_type, at_start=at_start,
        inverse=False,
    )
    window = np.pad(window, ((0, padding_after_adaptation)))
    return drop, window, start_sample


def gather_windowed(
    x: torch.Tensor, slice_starts: torch.Tensor, window: torch.Tensor
) -> torch.Tensor:
    """``out[c, i] = window[c, i] · zext(x[c])[slice_starts[c] + i]`` for
    ``x (C, T)``, ``slice_starts (C,)`` and ``window (C, TL)``: one batched
    gather over ``x`` padded with ``2·TL`` zeros at both ends (slice starts
    lie in ``[-2·TL, T]`` for every valid flank and offset configuration,
    so the clamp into the padded row never acts on them)."""
    C, TL = window.shape
    padded = torch.nn.functional.pad(x, (2 * TL, 2 * TL))
    idx = (slice_starts[:, None].long() + 2 * TL) + torch.arange(
        TL, device=x.device
    )
    idx = idx.clamp(0, padded.shape[1] - 1)
    return torch.gather(padded, 1, idx) * window


def window_ir_fused(
    x: torch.Tensor,
    total_length: int,
    adaptive_window: bool,
    constant_percentage: float,
    at_start: bool,
    offset_samples: int,
    left_to_right_flank_ratio: float,
):
    """`window_ir` for closed-form (Hann) flanks on ``x (C, T)``'s device,
    with no host sync (``window_ir_fused_program``, `_backend.py:252-350` of
    the JAX package): the peak search, the trimming decisions of
    `window_this_ir_tukey_meta` as elementwise integer ops over channels,
    the periodic Hann flanks in closed form and one batched gather.

    Returns ``(out (C, TL), window (C, TL), start_positions (C,))``.
    Degenerate flank configurations that the host path rejects with an
    assertion are clamped to the nearest valid window instead, as in the
    JAX package.
    """
    TL = int(total_length)
    o = int(offset_samples)
    flank_total = int((1 - constant_percentage) * TL)
    Lf0 = int(flank_total * 0.5 * left_to_right_flank_ratio)
    Rf0 = max(flank_total - Lf0, 0)
    C, T = x.shape
    p = torch.argmax(x.abs(), dim=1)  # (C,)
    zero = torch.zeros_like(p)
    if adaptive_window:
        cond = (p - o - Lf0) < 0
        Lf = torch.where(cond, torch.clamp(p - o, min=0), Lf0)
        drop = torch.where(cond, zero, p - o - Lf0)
        eff = torch.clamp(T - drop, max=TL)
        overlap = (Lf + o) > (eff - Rf0)
        Rf = torch.where(overlap, eff - Lf - o - 1, Rf0).clamp(min=0)
        Lf = torch.minimum(Lf, eff - Rf)
        slice_start, start_sample, z_to, z_from = drop, drop, zero, eff
    else:
        points = [0, Lf0, TL - Rf0, TL]
        assert not np.any(np.ediff1d(points) < 0), (
            "A valid window could not be constructed with given parameters."
        )
        c1 = (p - o) < 0
        pad1 = torch.where(c1, o - p, zero)
        p1 = torch.where(c1, p + pad1, p - o)
        c2 = (p1 - Lf0) < 0
        pad2 = torch.where(c2, Lf0 - p1, zero)
        drop = torch.where(c2, zero, p1 - Lf0)
        start_sample = torch.where(c2, pad1 + pad2, p1 - Lf0)
        front = pad1 + pad2
        slice_start, z_to = drop - front, front
        z_from = TL - torch.clamp(TL - (front + T - drop), min=0)
        Lf, Rf, eff = (torch.full_like(p, v) for v in (Lf0, Rf0, TL))
    Lf, Rf, eff, z_to, z_from = (v[:, None] for v in (Lf, Rf, eff, z_to, z_from))
    i = torch.arange(TL, device=x.device)[None, :]
    xi = i.to(x.dtype)
    # periodic Hann flanks: scipy get_window('hann', 2L, fftbins=True)
    # split at L
    low = 0.5 - 0.5 * torch.cos(torch.pi * xi / torch.clamp(Lf, min=1).to(x.dtype))
    high = 0.5 + 0.5 * torch.cos(
        torch.pi * (xi - (eff - Rf).to(x.dtype)) / torch.clamp(Rf, min=1).to(x.dtype)
    )
    one = torch.ones((), dtype=x.dtype, device=x.device)
    w = torch.where(i < Lf, low if at_start else one, one)
    w = torch.where(i >= eff - Rf, torch.where(i < eff, high, 0.0), w)
    w = torch.where(i < z_to, 0.0, w)
    w = torch.where(i >= z_from, 0.0, w)
    return gather_windowed(x, slice_start, w), w, start_sample


def window_this_ir_tukey(
    vec: np.ndarray,
    total_length: int,
    window_type,
    constant_percentage: float,
    at_start: bool,
    offset_samples: int,
    left_to_right_flank_ratio: float,
    adaptive_window: bool,
):
    """Peak-aligned adaptive Tukey windowing of one host channel
    (`_transfer_functions.py:45-148`): `window_this_ir_tukey_meta`'s index
    arithmetic applied to ``vec`` in numpy. Returns ``(windowed, window,
    start_sample)``."""
    T = len(vec)
    slice_start, window, start_sample = window_this_ir_tukey_meta(
        T, int(np.argmax(np.abs(vec))), total_length, window_type,
        constant_percentage, at_start, offset_samples,
        left_to_right_flank_ratio, adaptive_window,
    )
    idx = np.arange(total_length) + slice_start
    valid = (idx >= 0) & (idx < T)
    seg = np.where(valid, vec[np.clip(idx, 0, T - 1)], 0.0)
    return seg * window, window, start_sample


def window_this_ir_centered_meta(T: int, peak_ind: int, total_length: int, window_type):
    """Index arithmetic of the peak-centered windowing of one length-``T``
    channel (`_transfer_functions.py:150-215`): ``(flip, start, win_col)``
    such that the windowed channel is ``(vec[::-1] if flip else
    vec)[start : start + total_length] · win_col`` (zeros out of range),
    flipped back afterwards. ``win_col`` is zero wherever the reference's
    pad/trim writes zeros, so no sample outside the slice leaks through."""
    from scipy.signal import get_window

    half_length = total_length // 2
    centered_even = peak_ind + half_length == T and T % 2 == 0
    flipping = peak_ind > half_length
    if flipping:
        peak_ind = T - peak_ind - 1
    w = get_window(window_type.to_scipy_format(), half_length * 2 + 1, False)
    if peak_ind - half_length < 0:
        ind_low_td = 0
        ind_low_w = half_length - peak_ind
    else:
        ind_low_td = peak_ind - half_length
        ind_low_w = 0
    # the reference zero-pads the channel to total_length + ind_low_td
    # when the window would run past its end
    T_eff = total_length + ind_low_td if total_length - ind_low_td > T else T
    if peak_ind + half_length + 1 > T_eff and not centered_even:
        ind_up_td = T_eff
        ind_up_w = peak_ind + half_length + 1 - T_eff
    else:
        ind_up_td = peak_ind + half_length + 1
        ind_up_w = len(w) - (1 if centered_even else 0)
    w = w[ind_low_w:ind_up_w]
    # the length of the reference's clamped slice before its final
    # pad/trim to total_length
    L0 = max(0, min(ind_up_td, T_eff) - ind_low_td)
    win_col = np.zeros(total_length)
    L = min(len(w), L0, total_length)
    win_col[:L] = w[:L]
    return flipping, ind_low_td, win_col


def gather_centered(x: torch.Tensor, flips: torch.Tensor, starts: torch.Tensor,
                    window: torch.Tensor) -> torch.Tensor:
    """`window_centered_ir`'s batched gather on ``x (C, T)``: each row
    flipped where ``flips (C,)`` says, sliced from ``starts (C,)`` over
    ``window (C, L)``'s length (zeros past the end), windowed, and flipped
    back."""
    C, L = window.shape
    xf = torch.where(flips[:, None], x.flip(1), x)
    padded = torch.nn.functional.pad(xf, (0, 2 * L))
    idx = starts[:, None].long() + torch.arange(L, device=x.device)
    segs = torch.gather(padded, 1, idx) * window
    return torch.where(flips[:, None], segs.flip(1), segs)


def get_chirp_rate(range_hz, length_seconds: float) -> float:
    """Chirp rate in octaves per second (`_transfer_functions.py:216-237`)."""
    r = np.sort(np.atleast_1d(range_hz))
    assert r.shape == (2,), "Range must contain exactly two elements."
    return np.log2(r[1] / r[0]) / length_seconds


def get_harmonic_times(
    chirp_range_hz,
    chirp_length_s: float,
    n_harmonics: int,
    time_offset_seconds: float = 0.0,
) -> np.ndarray:
    """Relative (negative) times of the harmonic IRs of an exponential-chirp
    measurement (`_transfer_functions.py:239-275`)."""
    rate = get_chirp_rate(chirp_range_hz, chirp_length_s)
    return time_offset_seconds - np.log2(np.arange(n_harmonics) + 2) / rate


def _smoothing_row_window(
    i: int,
    frequency_vector: np.ndarray,
    delta_f: float,
    factor: float,
    window_x: np.ndarray,
    window_y: np.ndarray,
):
    """Per-bin log-spaced smoothing window of the reference's numba kernel
    (`_transfer_functions.py:414-476`): returns
    ``(w, ind_low_clipped, ind_high_clipped)`` or ``None`` when the row is
    too narrow (< 3 bins → identity). The float64 host oracle's row."""
    n_bins = len(frequency_vector)
    f0 = frequency_vector[i]
    ind_low = i - int((f0 - f0 / factor) / delta_f + 0.5)
    ind_high = i + int((f0 * factor - f0) / delta_f + 0.5) + 1
    window_length = ind_high - ind_low
    ind_low_c = max(ind_low, 0)
    ind_high_c = min(ind_high, n_bins)
    effective = ind_high_c - ind_low_c
    if ind_low_c + 2 >= ind_high_c:
        return None
    w = np.interp(
        np.logspace(np.log10(3.0), np.log10(1.0), window_length)[
            :effective
        ]
        - 2.0,
        window_x,
        window_y,
    )
    return w / w.sum(), ind_low_c, ind_high_c


_BANDED_TR = 128  # rows per banded-kernel tile


def _banded_smoothing_plan(
    n_bins: int,
    f_first: float,
    delta_f: float,
    octave_fraction: float,
    window_key: tuple,
):
    """Segmented banded form of the smoothing operator: O(F·W) memory.

    Same math as `_smoothing_row_window`, built fully vectorized. Rows
    are tiled in blocks of ``_BANDED_TR``; each block stores a dense
    ``(TR, SPAN)`` weight slab plus the global column offset of its band
    start. Blocks are grouped into segments
    with geometrically growing SPAN (band width grows ∝ frequency), so
    total memory ≈ 1.3× the true band area instead of SPAN_max·F.

    Returns a list of ``{rows, offsets (NB,), slab (NB, TR, SPAN)}``.
    Not cached: `device_banded_plan` keeps the plan on its device (on the
    CPU its tensors share these arrays' memory), so no host copy outlives
    an upload.
    """
    F = int(n_bins)
    freqs = f_first + np.arange(F, dtype=np.float64) * delta_f
    window_y = np.asarray(window_key, dtype=np.float64)
    n_lut = len(window_y)
    factor = 2.0 ** (1.0 / octave_fraction / 2.0)
    i = np.arange(F, dtype=np.int64)
    ind_low = i - np.trunc(
        (freqs - freqs / factor) / delta_f + 0.5
    ).astype(np.int64)
    ind_high = (
        i
        + np.trunc((freqs * factor - freqs) / delta_f + 0.5).astype(
            np.int64
        )
        + 1
    )
    eff_high = np.minimum(ind_high, F)
    width = ind_high - ind_low
    identity = (ind_low + 2) >= eff_high

    # segment row ranges: geometric so per-segment SPAN tracks the local
    # band width (a single global SPAN would cost SPAN_max·F memory)
    bounds = [0]
    nxt = 2048
    while nxt < F:
        bounds.append(nxt)
        nxt *= 2
    bounds.append(F)

    a_log = np.log10(3.0)
    lut_dx = 2.0 / (n_lut - 1)
    segments = []
    TR = _BANDED_TR
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        rows = s1 - s0
        nb = -(-rows // TR)
        rows_padded = nb * TR
        r_idx = s0 + np.arange(rows_padded)
        valid_row = r_idx < F
        r_clip = np.minimum(r_idx, F - 1)
        il = ind_low[r_clip]
        eh = eff_high[r_clip]
        wd = width[r_clip]
        ident = identity[r_clip] | (~valid_row)
        base = il.reshape(nb, TR).min(axis=1)  # (NB,)
        span_raw = int(
            (eh.reshape(nb, TR).max(axis=1) - base).max()
        )
        span = max(128, -(-span_raw // 128) * 128)
        k = np.arange(span, dtype=np.int64)
        base_r = np.repeat(base, TR)  # (rows_padded,)
        col = base_r[:, None] + k[None, :]  # global column index
        krel = col - il[:, None]
        in_band = (krel >= 0) & (col < eh[:, None]) & (
            krel < wd[:, None]
        )
        wm1 = np.where(wd > 1, wd - 1, 1).astype(np.float64)
        # np.logspace(log10 3, 0, width)[krel] − 2, vectorized with the
        # same start + k·step evaluation order as np.linspace
        step = -a_log / wm1
        val = a_log + krel * step[:, None]
        pos = np.clip(10.0**val - 2.0, -1.0, 1.0)
        u = (pos + 1.0) / lut_dx
        iu = np.clip(np.floor(u).astype(np.int64), 0, n_lut - 2)
        frac = u - iu
        w = window_y[iu] * (1.0 - frac) + window_y[iu + 1] * frac
        w = np.where(in_band, w, 0.0)
        norm = w.sum(axis=1, keepdims=True)
        w = w / np.where(norm == 0.0, 1.0, norm)
        # identity rows (too-narrow bands): one-hot at the row's own bin
        ident_col = r_clip - base_r
        w[ident] = 0.0
        w[ident, ident_col[ident]] = 1.0
        segments.append(
            {
                "rows": rows,
                "offsets": base.astype(np.int32),
                "slab": w.reshape(nb, TR, span).astype(np.float32),
            }
        )
    return segments


def _window_key(window_y) -> tuple:
    """The smoothing window's values as the caches' key (a tuple is taken
    as it is)."""
    if isinstance(window_y, tuple):
        return window_y
    return tuple(np.asarray(window_y).tolist())


def _plan_key(frequency_vector, octave_fraction, window_y) -> tuple:
    fv = np.asarray(frequency_vector, dtype=np.float64)
    return (
        len(fv),
        float(fv[0]),
        float(fv[1] - fv[0]),
        float(octave_fraction),
        _window_key(window_y),
    )


@device_cache(4)
def device_banded_plan(key: tuple, dtype, device) -> list[dict]:
    """`_banded_smoothing_plan(*key)` on ``device``, cached on the plan's
    key: a second smoothing on the same grid uploads nothing."""
    return plan_to_torch(_banded_smoothing_plan(*key), device, dtype)


def complex_smoothing_banded(
    spectrum: torch.Tensor,
    frequency_vector: np.ndarray,
    octave_fraction: float,
    window_y: np.ndarray,
) -> torch.Tensor:
    """O(F·W) banded smoothing of ``spectrum (F,)`` or ``(F, C)``, complex
    or real, on its device: the real and imaginary planes side by side,
    padded by the largest band span, through `ops.banded.banded_apply` over
    the plan's segments (one kernel launch on a CUDA device). In the
    package's default float: float32 runs the CUDA kernel on a CUDA tensor; float64 mode takes the plain version
    (with the plan's float32 weights). Every grid size takes this path."""
    one_d = spectrum.ndim == 1
    x = spectrum[:, None] if one_d else spectrum
    is_c = x.is_complex()
    planes = torch.cat([x.real, x.imag], dim=1) if is_c else x
    plan = device_banded_plan(
        _plan_key(frequency_vector, octave_fraction, window_y),
        planes.dtype, planes.device,
    )
    max_span = max(seg["span"] for seg in plan)
    C = planes.shape[1]
    out = banded_apply(plan, torch.nn.functional.pad(planes, (0, 0, 0, max_span)))
    if is_c:
        out = torch.complex(out[:, : C // 2], out[:, C // 2:])
    return out[:, 0] if one_d else out


def complex_smoothing_host(
    spectrum: np.ndarray,
    frequency_vector: np.ndarray,
    octave_fraction: float,
    window_y: np.ndarray,
) -> np.ndarray:
    """Host float64 complex smoothing, row by row with the reference's
    per-bin window (`_smoothing_row_window`): the oracle of the operator
    paths, O(F·W) in time and memory."""
    x = np.atleast_2d(np.asarray(spectrum))
    transposed = False
    if x.shape[0] == 1 and np.asarray(spectrum).ndim == 1:
        x = x.T
        transposed = True
    frequency_vector = np.asarray(frequency_vector, dtype=np.float64)
    n_bins = len(frequency_vector)
    delta_f = frequency_vector[1] - frequency_vector[0]
    window_y = np.asarray(window_y, dtype=np.float64)
    window_x = np.linspace(-1.0, 1.0, len(window_y))
    factor = 2.0 ** (1.0 / octave_fraction / 2.0)
    out = np.array(x, dtype=np.result_type(x.dtype, np.float64))
    for i in range(n_bins):
        row = _smoothing_row_window(
            i, frequency_vector, delta_f, factor, window_x, window_y
        )
        if row is None:
            continue
        w, ind_low_c, ind_high_c = row
        out[i] = w @ x[ind_low_c:ind_high_c]
    return out[:, 0] if transposed else out


# the memory of one (bins, T, C) tile of `fdw_core`'s window products
_FDW_CHUNK_BYTES = 64 << 20
# the coarse/fine split of the rotation phase: n = n1·B + n0
_FDW_SPLIT = 1024


def fdw_core(
    time_data: torch.Tensor,
    freqs_normalized: np.ndarray,
    alpha: np.ndarray,
    peak_indices: np.ndarray,
) -> torch.Tensor:
    """Frequency-dependent Gaussian windowing as direct DFT sums on
    ``time_data (T, C)``'s device (`_backend.py:682-756` of the JAX
    package): ``spec[f, c] = Σ_n exp(-0.5·((n - peak_c)/half)²·alpha_f) ·
    exp(-2πi·f·n/T) · x[n, c]`` → ``(F, C)`` complex.

    The rotation phase ``f·n/T`` reaches ~1e4 cycles at measurement
    lengths, beyond float32's mantissa, so it is split as in the JAX
    package: ``n = n1·B + n0``, ``phase = [(ω·B·n1) mod 1] + ω·n0``, the
    coarse table reduced mod 1 in float64 on the host. The bins run in
    chunks whose ``(bins, T, C)`` window tile takes `_FDW_CHUNK_BYTES`;
    each tile is an elementwise product summed over T in the data's float
    (no matrix product, so no TF32)."""
    T, C = time_data.shape
    dev, rdt = time_data.device, time_data.dtype
    half = (T - 1) / 2
    n_idx = np.arange(T)[:, None] - np.asarray(peak_indices)[None, :]
    n2 = torch.as_tensor(-0.5 * (n_idx / half) ** 2, dtype=rdt, device=dev)  # (T, C)
    B = _FDW_SPLIT
    n1_max = -(-T // B)
    omega = np.mod(np.asarray(freqs_normalized, np.float64) / T, 1.0)
    coarse = np.mod(np.mod(omega * B, 1.0)[:, None] * np.arange(n1_max)[None, :], 1.0)
    n = np.arange(T)
    n1 = torch.as_tensor(n // B, device=dev)
    n0 = torch.as_tensor(n % B, dtype=rdt, device=dev)
    coarse_t = torch.as_tensor(coarse, dtype=rdt, device=dev)
    omega_t = torch.as_tensor(omega, dtype=rdt, device=dev)
    alpha_t = torch.as_tensor(np.asarray(alpha, np.float64), dtype=rdt, device=dev)
    F = len(omega)
    chunk = max(1, _FDW_CHUNK_BYTES // (T * C * time_data.element_size()))
    out = []
    for s in range(0, F, chunk):
        e = min(F, s + chunk)
        arg = (2 * np.pi) * (coarse_t[s:e][:, n1] + omega_t[s:e, None] * n0[None])
        w = torch.exp(alpha_t[s:e, None, None] * n2[None]).mul_(time_data[None])
        re = (w * torch.cos(arg)[..., None]).sum(1)
        im = (w * torch.sin(arg)[..., None]).sum(1)
        out.append(torch.complex(re, -im))
    return torch.cat(out)


def frequency_vector_with_frequency_resolution(delta_f_hz: float, sampling_rate_hz: int):
    """``(f_vec, delta_f, time_length)`` for a requested frequency
    resolution (`_transfer_functions.py:574-606`): an odd-length linspace
    whose last point is exactly Nyquist (an rfftfreq vector can overshoot
    Nyquist by one ulp, which an interpolation with zero-padded edges turns
    into a zeroed Nyquist bin)."""
    nyquist_hz = sampling_rate_hz / 2.0
    length_f_vec = int(nyquist_hz / delta_f_hz + 0.5)
    if length_f_vec % 2 == 0:
        length_f_vec += 1
    f_vec = np.linspace(0.0, nyquist_hz, length_f_vec, endpoint=True)
    return f_vec, f_vec[1], (length_f_vec - 1) * 2


def trim_ir_indices(
    time_data: np.ndarray,
    fs_hz: int,
    offset_start_s: float,
    safety_distance_to_noise_floor_db: float = 10.0,
) -> tuple[int, int, int]:
    """Start, stop and impulse indices for smart IR trimming
    (`_transfer_functions.py:276-411`): 1-D decision logic on host numpy
    data (scipy Hilbert envelope, EMA, a decay scan over five window
    lengths).

    parity: the Hilbert transform runs at the padded ``next_fast_len``
    length and the decay scan and the fallback averaging use that full
    padded envelope, as the reference does (`_transfer_functions.py:307-315`).
    """
    from scipy.fft import next_fast_len
    from scipy.signal import hilbert

    time_data = np.asarray(time_data).reshape(-1)
    impulse_index = int(np.argmax(np.abs(time_data)))
    offset_start_samples = int(offset_start_s * fs_hz + 0.5)
    start_index = int(np.max([0, impulse_index - 1 - offset_start_samples]))
    impulse_index -= start_index

    tail = time_data[start_index + impulse_index:]
    env_c = hilbert(tail, N=next_fast_len(len(tail), False))
    etc = np.asarray(to_db(np.abs(env_c), True))
    envelope = time_smoothing_host(etc, fs_hz, 20e-3)

    window_lengths = (np.array([10, 30, 50, 70, 90]) * 1e-3 * fs_hz + 0.5).astype(int)
    end = np.zeros(len(window_lengths))
    x = np.arange(len(envelope))
    corr_coeff = np.zeros(len(window_lengths))
    for ind, wl in enumerate(window_lengths):
        pos = 0
        current_mean = 0.0
        for _ in range(len(envelope) // wl):
            new_mean = np.mean(envelope[pos:pos + wl])
            if current_mean <= new_mean:
                break
            current_mean = new_mean
            pos += wl
        end_cur = min((pos * 2 + wl) // 2, len(envelope))
        corr_coeff[ind] = pearson_correlation(x[:end_cur], envelope[:end_cur])
        end[ind] = end_cur

    select = int(np.argmin(corr_coeff))
    if corr_coeff[select] <= -0.95:
        end_point = int(end[select])
    elif np.any(corr_coeff <= -0.9):
        end_point = int(np.mean(end[corr_coeff <= -0.9]))
    elif np.any(corr_coeff <= -0.7):
        inds = corr_coeff <= -0.7
        end_point = int(np.mean(np.hstack([np.ones(9) * end[select], end[inds]])))
    else:
        warn("No satisfactory estimation for trimming the rir could be made")
        end_point = int(np.mean(np.hstack([np.ones(5) * len(envelope), end])))

    stop = end_point + start_index + impulse_index
    if safety_distance_to_noise_floor_db != 0.0:
        end_point = _find_index_above_noise_floor(
            envelope[:end_point],
            float(to_db(np.var(time_data[stop:]), False))
            if stop < len(time_data)
            else -np.inf,
            abs(safety_distance_to_noise_floor_db),
        )
        stop = end_point + start_index + impulse_index
    return start_index, stop, impulse_index


def _find_index_above_noise_floor(
    envelope: np.ndarray,
    noise_floor_db: float,
    distance_to_noise_floor_db: float,
) -> int:
    """Where the envelope's fitted line meets the noise floor plus a
    distance, within [0.75, 1] of its length
    (`_transfer_functions.py:841`)."""
    if not np.isfinite(noise_floor_db):
        return len(envelope)
    poly = (
        np.polynomial.Polynomial.fit(np.arange(len(envelope)), envelope, 1)
        .convert()
        .coef
    )
    if poly[1] > 0.0:
        return len(envelope)
    new_stop = int(
        ((noise_floor_db + distance_to_noise_floor_db) - poly[0]) / poly[1] + 0.5
    )
    return int(np.clip(new_stop, int(len(envelope) * 0.75 + 0.5), len(envelope)))

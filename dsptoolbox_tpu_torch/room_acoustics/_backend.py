"""Array-level room acoustics backend
(`dsptoolbox_tpu/room_acoustics/_backend.py`).

Behavioral reference: `dsptoolbox/room_acoustics/_room_acoustics.py`.

- The reverberation fits, the energy decay curve and the ISO 3382
  descriptors are 1-D decision logic (searches, `np.polyfit`, the IR
  trimming's Hilbert envelope) and run in host numpy on one channel, as in
  the JAX package; the callers fetch a signal's data once.
- The complex mode indicator function is one batched SVD on the device.
- The image-source model enumerates the whole (2L+1)³ × 8 image lattice in
  float64 on the device, chunked (`ism_images`), and scatter-adds the
  images into the RIR (`ism_lattice`). Every sample index is decided in
  float64 in the host oracle's order of operations, so the placement is
  the oracle's
  (`generate_rir_host`: numpy float64 image math, then a torch scatter).
  The JAX package's double-single index arithmetic is a workaround for the
  TPU's missing float64 and is not ported.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from .._config import default_device
from ..helpers.gain_and_level import from_db, to_db
from ..helpers.other import pearson_correlation as _pearson
from ..helpers.smoothing import time_smoothing_host
from ..transfer_functions._backend import trim_ir_indices
from .enums import ReverbTime


def find_ir_start(ir: np.ndarray, threshold_dbfs: float = -20) -> int:
    """Last sample below threshold before the peak (ISO 3382;
    `_room_acoustics.py:88-115`). Host scalar search."""
    ir_abs = np.abs(np.asarray(ir))
    start_ir = int(np.argmax(ir_abs))
    threshold = ir_abs[start_ir] * float(from_db(-np.abs(threshold_dbfs), True))
    for start_ir in range(start_ir, -1, -1):
        if ir_abs[start_ir] < threshold:
            break
    return start_ir


def complex_mode_identification(
    spectra, maximum_singular_value: bool = True
) -> np.ndarray:
    """CMIF over frequency (`_room_acoustics.py:118-159`): the singular
    values of each bin's (n, n) matrix, whose first row and column are the
    bin's spectra, from one batched complex64 SVD on the spectra's device
    (numpy spectra go to `_config.default_device()`). Returns host numpy,
    which the peak search reads."""
    if not torch.is_tensor(spectra):
        spectra = torch.as_tensor(np.asarray(spectra), device=default_device())
    sp = spectra.to(torch.complex64)
    n_rir = sp.shape[1]
    if n_rir == 1:
        return (sp.squeeze().abs() ** 2).cpu().numpy()
    H = sp.new_zeros((sp.shape[0], n_rir, n_rir))
    H[:, 0, :] = sp
    H[:, :, 0] = sp
    s = torch.linalg.svdvals(H)
    s = s.amax(dim=-1) if maximum_singular_value else s[:, 0]
    return s.cpu().numpy()


def _fit_indices(edc, start_value, end_value) -> tuple[int, int]:
    """First and past-last sample of the EDC between two levels, searched
    on the inverted curve (`_room_acoustics.py:1097-1138`)."""
    L = len(edc)
    edc_inverted = edc[::-1]
    return (L - int(np.searchsorted(edc_inverted, start_value)),
            L - int(np.searchsorted(edc_inverted, end_value)))


def _polyfit_edc(time_vector, edc, start_value, end_value):
    """Linear fit between EDC levels (`_room_acoustics.py:1097-1138`)."""
    i1, i2 = _fit_indices(edc, start_value, end_value)
    coeff = np.polyfit(time_vector[i1:i2], edc[i1:i2], 1)
    r = _pearson(time_vector[i1:i2], edc[i1:i2])
    return coeff, r


def _best_linear_fit_for_edc(time_vector, edc, start_value, steps):
    """Best ending level by Pearson correlation
    (`_room_acoustics.py:1056-1095`)."""
    rs = np.zeros(len(steps))
    for ind, step in enumerate(steps):
        i1, i2 = _fit_indices(edc, start_value, step)
        rs[ind] = _pearson(time_vector[i1:i2], edc[i1:i2])
    ind_min = int(np.argmin(rs))
    return steps[ind_min], rs[ind_min]


def adaptive_fit_range(time_vector, edc) -> tuple[float, float, float]:
    """``(start level, end level, correlation)`` of the adaptive fit
    (REW Topt style; `_room_acoustics.py:999-1054`): the start where the EDT
    line meets the T30 line when the early decay is very short (else −5
    dB), the end the level from 20 to 59 dB below it whose fit correlates
    best."""
    coeff_edt = _polyfit_edc(time_vector, edc, 0, -10)[0]
    coeff_t30 = _polyfit_edc(time_vector, edc, -5, -35)[0]
    very_short_edt = (-6 * 10 / coeff_edt[0]) * 10 < -60 / coeff_t30[0]
    if very_short_edt:
        x_int = (coeff_edt[1] - coeff_t30[1]) / (coeff_t30[0] - coeff_edt[0])
        start = float(np.polyval(coeff_edt, [x_int]).squeeze())
    else:
        start = -5.0
    steps = np.arange(start - 20, start - 60, -1)
    end, r = _best_linear_fit_for_edc(time_vector, edc, start, steps)
    return start, end, r


def compute_energy_decay_curve(
    time_data: np.ndarray, trim_automatically: bool, fs_hz: int
) -> np.ndarray:
    """EDC in dB with Chu's noise correction and Lundeby's compensation
    energy (`_room_acoustics.py:1140-1222`), on one host channel."""
    return _edc_and_bounds(time_data, trim_automatically, fs_hz)[0]


def _edc_and_bounds(time_data, trim_automatically: bool, fs_hz: int) -> tuple:
    """``(EDC, IR start, trimming stop)``: `compute_energy_decay_curve`
    with the two indices it chose."""
    time_data = np.asarray(time_data).reshape(-1)
    if trim_automatically:
        _, stopping_index, _ = trim_ir_indices(time_data, fs_hz, offset_start_s=1e-3)
    else:
        stopping_index = len(time_data)
    start_index = find_ir_start(time_data)
    if stopping_index != len(time_data):
        noise_power = np.var(time_data[stopping_index:])
    else:
        noise_power = np.var(time_data[:start_index])

    signal_power = time_data[start_index:stopping_index] ** 2.0
    dynamic_range_db = float(to_db(np.max(signal_power) / noise_power, False)) / 2.0
    signal_db = np.asarray(to_db(time_smoothing_host(signal_power, fs_hz, 20e-3), False))
    start_index_int = np.where(dynamic_range_db + np.min(signal_db) > signal_db)[0][0]
    time_vector = np.linspace(0, len(signal_power) / fs_hz, len(signal_power))
    p = np.polyfit(time_vector[start_index_int:], signal_db[start_index_int:], 1)
    avoid_corrections = p[1] >= 0.0
    B = float(from_db(p[0], False))
    t_1 = (float(to_db(noise_power, False)) - p[0]) / p[1]
    avoid_corrections |= t_1 <= 0.0
    with np.errstate(all="ignore"):
        A = np.log(noise_power / B) / t_1
        e_comp = -B / A * np.exp(A * t_1)

    signal_power = signal_power - noise_power
    e_comp *= fs_hz
    cums = np.cumsum(signal_power)
    edc = np.sum(signal_power) + e_comp - cums
    indices = np.where(edc <= 0)[0]
    if len(indices) > 0:
        avoid_corrections |= indices[0] <= int(30e-3 * fs_hz + 0.5)
        if not avoid_corrections:
            edc = edc[: indices[0]]
    if avoid_corrections or not np.isfinite(edc).all():
        signal_power = signal_power + noise_power
        length = int(len(signal_power) * 0.95)
        edc = np.sum(signal_power) - np.cumsum(signal_power)[:length]
    edc = np.asarray(to_db(edc, False))
    return edc - edc[0], start_index, stopping_index


RT_BOUNDS = {
    ReverbTime.T20: (-5, -25),
    ReverbTime.T30: (-5, -35),
    ReverbTime.T60: (-5, -65),
    ReverbTime.EDT: (0, -10),
}


def reverb(
    h: np.ndarray,
    fs_hz: int,
    mode: ReverbTime,
    ir_start: int | None,
    return_ir_start: bool,
    automatic_trimming: bool,
):
    """Reverberation time of one host channel (`_room_acoustics.py:17-85`):
    ``(time, correlation)``, and ``ir_start`` when asked."""
    time, corr, _ = reverb_fit(h, fs_hz, mode, automatic_trimming)
    if return_ir_start:
        return time, corr, ir_start
    return time, corr


def reverb_fit(h: np.ndarray, fs_hz: int, mode: ReverbTime,
               automatic_trimming: bool = True) -> tuple:
    """``(time, correlation, decisions)`` of one host channel's
    reverberation time. ``decisions`` are the discrete choices behind it:
    the trimming's stop, the IR start, the EDC's length and the fit's first
    and past-last samples (at the levels the adaptive mode chose). Two
    inputs whose times differ with the same decisions differ by arithmetic;
    with other decisions, by a flip."""
    edc, start, stop = _edc_and_bounds(h, automatic_trimming, fs_hz)
    time_vector = np.linspace(0, len(edc) / fs_hz, len(edc))
    if mode == ReverbTime.Adaptive:
        hi, lo, r = adaptive_fit_range(time_vector, edc)
        if r > -0.95:
            warn(
                f"Correlation coefficient for reverb computation is {r} "
                "(larger than -0.95). Computation might be invalid. "
                "-1 is the ideal value."
            )
    elif mode in RT_BOUNDS:
        hi, lo = RT_BOUNDS[mode]
    else:
        raise ValueError("Supported modes are only T20, T30, T60 and EDT")
    p, corr = _polyfit_edc(time_vector, edc, hi, lo)
    time = (10 if mode == ReverbTime.EDT else 60) / np.abs(p[0])
    if mode == ReverbTime.Adaptive:
        corr = r
    return time, corr, (stop, start, len(edc), *_fit_indices(edc, hi, lo))


def add_reverberant_tail_noise(
    rir, mixing_time_s, t60: float, sr: int
) -> np.ndarray:
    """Decaying-noise late tail (`_room_acoustics.py:840-887`) on a host
    copy of ``rir`` (numpy or a tensor): draws from numpy's global RNG
    (``np.random.normal``), as the JAX package does."""
    rir = np.array(rir.cpu() if torch.is_tensor(rir) else rir).reshape(-1)
    ind_direct = np.squeeze(np.where(rir != 0))[0]
    mixing_time_samples = int(mixing_time_s * sr)
    noise_length = len(rir) - ind_direct - mixing_time_samples
    noise = np.abs(np.random.normal(0, 1, noise_length))
    delta = 0.02 * 343 / t60
    noise *= np.exp(-delta * np.arange(noise_length) / sr)
    noise /= np.max(noise)
    window_length = 100
    window = rir[-noise_length - window_length // 2 : -noise_length + window_length // 2]
    gain = np.median(window[window != 0]) * 0.5
    noise *= gain
    indexes = rir[-noise_length:] == 0
    rir[-noise_length:][indexes] += noise[indexes]
    return rir


def descriptor_window(td: np.ndarray, fs: int, automatic_trimming: bool) -> tuple:
    """``(IR start, trimming stop after it)``: the two decisions behind a
    channel's D50, C80 and centre time (the stop is the length after the
    start without trimming)."""
    start = find_ir_start(td)
    if automatic_trimming:
        return start, trim_ir_indices(td[start:], fs, 0)[1]
    return start, len(td) - start


def d50_from_rir(td: np.ndarray, fs: int, automatic_trimming: bool) -> float:
    """Definition D50 (`_room_acoustics.py:889-921`)."""
    td = np.asarray(td).reshape(-1)
    start, stop = descriptor_window(td, fs, automatic_trimming)
    window = int(50e-3 * fs)
    if automatic_trimming:
        stop = int(np.max([window, stop]))
    td = td[start:] ** 2
    return float(np.sum(td[:window]) / np.sum(td[:stop]))


def c80_from_rir(td: np.ndarray, fs: int, automatic_trimming: bool) -> float:
    """Clarity C80 in dB (`_room_acoustics.py:924-956`)."""
    td = np.asarray(td).reshape(-1)
    start, stop = descriptor_window(td, fs, automatic_trimming)
    window = int(80e-3 * fs)
    if automatic_trimming:
        stop = int(np.max([window, stop]))
    td = td[start:] ** 2
    return float(to_db(np.sum(td[:window]) / np.sum(td[window:stop]), False))


def ts_from_rir(td: np.ndarray, fs: int, automatic_trimming: bool) -> float:
    """Center time in seconds (`_room_acoustics.py:959-996`)."""
    td = np.asarray(td).reshape(-1)
    start, stop = descriptor_window(td, fs, automatic_trimming)
    td = td[start:][:stop] ** 2
    time_vec = np.linspace(0, len(td) / fs, len(td))
    return float(np.sum(td * time_vec) / np.sum(td))


# ---- image-source model ------------------------------------------------

SPEED_OF_SOUND = 343

_U_VECTORS = np.array(
    [
        [0, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
        [1, 0, 0],
        [0, 1, 1],
        [1, 0, 1],
        [1, 1, 0],
        [1, 1, 1],
    ],
    dtype=np.float64,
)  # (8, 3)

# within one cell's 8 images, an image is dropped when a LATER one has the
# same sample index (numpy fancy assignment: the last duplicate wins,
# `_room_acoustics.py:259-268`)
_LATER = np.triu(np.ones((8, 8), dtype=bool), 1)

# lattice cells × source/receiver pairs per chunk of `ism_lattice`: about
# 0.7 KB of float64 and boolean temporaries each, ~0.7 GB a chunk
_ISM_CHUNK = 1 << 20


def wall_reflection_factors(alpha) -> tuple[np.ndarray, np.ndarray]:
    """``(beta_1, beta_2)`` per axis from one absorption coefficient or six
    (one per wall), as `generate_rir` and the fleet take them."""
    beta = np.atleast_1d(np.sqrt(1 - np.asarray(alpha, dtype=np.float64)))
    if len(beta) == 1:
        return np.ones(3) * beta, np.ones(3) * beta
    if len(beta) == 6:
        return np.array([beta[1], beta[3], beta[4]]), np.array([beta[0], beta[2], beta[5]])
    raise ValueError("Wrong length for absorption coefficients")


def ism_limits(room_dim, rt: float, max_order: int | None, sr: int) -> tuple[int, int]:
    """``(LIMIT, total_length)``: the lattice's order limit for a
    reverberation time, capped by ``max_order``, and the generated length
    in samples (5 × 1.1 × rt)."""
    t_max = rt * 1.1
    l_max = SPEED_OF_SOUND * t_max / 2 / np.asarray(room_dim, dtype=np.float64)
    limit = int(np.ceil(np.sqrt(l_max @ l_max)))
    if max_order is not None:
        limit = limit if max_order > limit else max_order
    return limit, int(t_max * 5 * sr)


def _host_group_images(lv, room_dim, beta_1, beta_2, s_pos, r_pos, sr, c):
    """float64 image math for lattice rows ``lv (m, 3)``: flat ``(idx,
    vals)`` with the duplicate drop applied (`_LATER`)."""
    pos = (
        (1 - 2 * _U_VECTORS)[None, :, :] * s_pos
        + (2 * lv * room_dim)[:, None, :]
        - r_pos
    )
    dist = np.sqrt(np.sum(pos**2, axis=-1))  # (m, 8)
    diff = np.abs(lv[:, None, :] - _U_VECTORS[None, :, :])
    damp = np.prod(beta_1**diff, axis=-1) * np.prod(beta_2 ** np.abs(lv), axis=-1)[:, None]
    vals = damp / (4 * np.pi * dist)
    idx = (dist / c * sr + 0.5).astype(np.int64)  # truncation, like the reference
    eq = idx[:, :, None] == idx[:, None, :]  # (m, 8, 8)
    dropped = (eq & _LATER).any(axis=2)
    vals = np.where(dropped, 0.0, vals)
    return idx.reshape(-1), np.nan_to_num(vals.reshape(-1))


def generate_rir_host(
    room_dim, beta_1, beta_2, s_pos, r_pos, sr, c, limit, total_length, device
) -> torch.Tensor:
    """The oracle: numpy float64 image math in chunks of 2^17 cells, each
    chunk's images scatter-added into a float32 RIR ``(total_length,)`` on
    ``device``; indices at or past ``total_length`` are dropped."""
    grid = np.arange(-limit, limit + 1, dtype=np.float64)
    ll, mm, nn = np.meshgrid(grid, grid, grid, indexing="ij")
    lvecs = np.stack([ll.reshape(-1), mm.reshape(-1), nn.reshape(-1)], axis=1)
    rir = torch.zeros(total_length, dtype=torch.float32, device=device)
    chunk = 1 << 17
    for i0 in range(0, lvecs.shape[0], chunk):
        idx, vals = _host_group_images(
            lvecs[i0 : i0 + chunk], room_dim, beta_1, beta_2, s_pos, r_pos, sr, c
        )
        keep = idx < total_length
        rir.index_add_(
            0,
            torch.as_tensor(idx[keep], device=device),
            torch.as_tensor(vals[keep], dtype=torch.float32, device=device),
        )
    return rir


def ism_images(room_dim, beta_1, beta_2, s_pos, r_pos, sr: int, limit: int, device):
    """The (2·limit+1)³ lattice of cells × 8 images of ``P`` source/receiver
    pairs ``s_pos, r_pos (P, 3)``, enumerated on ``device`` in float64 in
    chunks of `_ISM_CHUNK` cells × pairs: yields ``(lv (m, 3), idx (P, m,
    8) int64, vals (P, m, 8) float64)`` a chunk, each image's sample index
    and value, the value zeroed where a later image of its cell has the
    same index (`_LATER`), as `_host_group_images` gives them.

    The sample index ``int(dist / c · sr + 0.5)`` truncates, so one ulp can
    move an image by a bin: it is formed as `_host_group_images` forms it,
    one rounding per operation, ``pos = ((1 − 2u)·s + (2·lv)·room_dim) − r``
    and ``|pos|² = (x0·x0 + x1·x1) + x2·x2``, each a separate elementwise
    op (no fused multiply-add), and ``dist`` divided by ``c`` held in a
    float64 tensor on the device (CUDA divides by a host scalar as a
    product with its reciprocal), so every index is the oracle's.
    """
    dt = torch.float64
    n = 2 * limit + 1
    M = n**3
    s = torch.as_tensor(np.atleast_2d(s_pos), dtype=dt, device=device)
    r = torch.as_tensor(np.atleast_2d(r_pos), dtype=dt, device=device)
    P = s.shape[0]
    u = torch.as_tensor(_U_VECTORS, dtype=dt, device=device)
    a = (1 - 2 * u)[None] * s[:, None, :]  # (P, 8, 3), exact
    r = r[:, None, None, :]  # (P, 1, 1, 3)
    dim = torch.as_tensor(room_dim, dtype=dt, device=device)
    b1 = torch.as_tensor(beta_1, dtype=dt, device=device)
    b2 = torch.as_tensor(beta_2, dtype=dt, device=device)
    c = torch.full((), SPEED_OF_SOUND, dtype=dt, device=device)
    later = torch.as_tensor(_LATER, device=device)
    chunk = max(1, _ISM_CHUNK // P)
    for i0 in range(0, M, chunk):
        ids = torch.arange(i0, min(M, i0 + chunk), device=device)
        lv = torch.stack([ids // (n * n), (ids // n) % n, ids % n], dim=1).to(dt) - limit
        pos = (a[:, None] + ((2 * lv) * dim)[None, :, None, :]) - r  # (P, m, 8, 3)
        x0, x1, x2 = pos.unbind(-1)
        dist = torch.sqrt((x0 * x0 + x1 * x1) + x2 * x2)  # (P, m, 8)
        idx = ((dist / c) * sr + 0.5).to(torch.int64)
        diff = (lv[:, None, :] - u[None]).abs()  # (m, 8, 3)
        damp = torch.prod(b1**diff, dim=-1) * torch.prod(b2 ** lv.abs(), dim=-1)[:, None]
        vals = damp / (4 * np.pi * dist)
        dropped = ((idx[..., :, None] == idx[..., None, :]) & later).any(dim=-1)
        yield lv, idx, torch.nan_to_num(torch.where(dropped, 0.0, vals))


def ism_lattice(
    room_dim, beta_1, beta_2, s_pos, r_pos, sr: int, limit: int, length: int, device
) -> torch.Tensor:
    """Image-source RIRs ``(P, length)`` float32 of ``P`` source/receiver
    pairs: `ism_images`' images scatter-added in float64, cast once.
    Images at or past ``length`` are dropped (a caller that trims the RIR
    passes the trimmed length): their values are zeroed and added at their
    index modulo ``length``, which spreads their atomic adds."""
    P = np.atleast_2d(s_pos).shape[0]
    out = torch.zeros((P, length), dtype=torch.float64, device=device)
    row0 = (torch.arange(P, device=device) * length)[:, None, None]
    for _, idx, vals in ism_images(room_dim, beta_1, beta_2, s_pos, r_pos, sr, limit,
                                   device):
        vals = torch.where(idx < length, vals, 0.0)
        out.view(-1).index_add_(0, (idx % length + row0).reshape(-1), vals.reshape(-1))
    return out.to(torch.float32)


_ISM_DEVICE: bool | None = None


def set_ism_device(enabled: bool | None) -> None:
    """Route of the image-source model: ``True`` or ``None`` (default) the
    float64 lattice on `_config.default_device()` (`ism_lattice`),
    ``False`` the host oracle (numpy float64 image math, then a torch
    scatter on the default device)."""
    global _ISM_DEVICE
    _ISM_DEVICE = enabled


def generate_rir(room_dim, alpha, s_pos, r_pos, rt, mo, sr) -> torch.Tensor:
    """Image-source RIR (Brinkmann et al.; `_room_acoustics.py:161-268`):
    a float32 tensor of 5 × 1.1 × ``rt`` seconds on
    `_config.default_device()`, through the lattice or the host oracle
    (`set_ism_device`); their sample indices agree bit for bit."""
    room_dim = np.asarray(room_dim, dtype=np.float64)
    s_pos = np.asarray(s_pos, dtype=np.float64)
    r_pos = np.asarray(r_pos, dtype=np.float64)
    beta_1, beta_2 = wall_reflection_factors(alpha)
    limit, total_length = ism_limits(room_dim, rt, mo, sr)
    if _ISM_DEVICE is False:
        return generate_rir_host(room_dim, beta_1, beta_2, s_pos, r_pos, sr,
                                 SPEED_OF_SOUND, limit, total_length, default_device())
    return ism_lattice(room_dim, beta_1, beta_2, s_pos, r_pos, sr, limit,
                       total_length, default_device())[0]

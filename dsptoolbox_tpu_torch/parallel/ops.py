"""Sharded pipelines over a `Mesh` (`dsptoolbox_tpu/parallel/ops.py`).

Each function splits its input along one axis over the mesh's first axis
and runs the port's single-device op on each shard, on the shard's device,
so the kernels run once a shard (B1 framing, B3 filter bank, B5 DAS map).
The JAX package's collectives become explicit tensor moves made by the one
process: an ``all_gather`` is a `torch.cat` of the shards moved to each
device, a ``ppermute`` halo a slice moved to the neighbour, a ``psum`` a sum
on the mesh's first device. Each function returns one tensor (or a dict of
them): the shards concatenated on the mesh's first device. A mesh whose
first axis holds more than one device for the same device runs those
shards in turn.

- `parallel_welch`, `parallel_csm`: channel shards; the CSM gathers every
  shard's frame spectra and forms each shard's block of rows.
- `parallel_filterbank`: band shards of a SOS bank.
- `sharded_map_reduce`: a vmapped function over batch shards, reduced.
- `parallel_fir_filter`: time shards with a left halo of ``K - 1``.
- `parallel_das_map`: grid shards, the CSM on every device.
- `parallel_batch_descriptors`: batch shards of an RIR fleet.
- `parallel_stft`, `parallel_welch_time`: time shards with a right halo of
  ``window - step``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import default_float
from .._enums import SpectrumScaling, Window
from ..ops.cuda_csm import real_diagonal
from ..ops.spectral import (
    _windowed_frames, csm_finish, stft_plan, stft_scale, welch_plan, welch_scale,
)
from ..ops.spectral import welch as _welch
from .mesh import Mesh


def _shards(mesh: Mesh) -> tuple:
    """``(shards along the first axis, each shard's device)``."""
    devices = mesh.shard_devices()
    return len(devices), devices


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; numpy floating data as the package's float, on
    the CPU (each shard moves its own part)."""
    if torch.is_tensor(x):
        return x
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.floating):
        return torch.as_tensor(arr).to(default_float())
    return torch.as_tensor(arr)


def _split(x: torch.Tensor, n: int, dim: int, devices: list) -> list:
    """``x`` cut into ``n`` equal parts along ``dim``, each on its device."""
    return [p.to(d) for p, d in zip(torch.chunk(x, n, dim=dim), devices)]


def _gather(parts: list, dim: int, device) -> torch.Tensor:
    """The parts concatenated along ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def parallel_welch(
    x,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
) -> torch.Tensor:
    """Welch autospectra of ``x (C, T)`` with the channels split over the
    mesh's first axis: each shard runs `ops.spectral.welch` alone.
    ``(C, F)`` on the mesh's first device."""
    n, devices = _shards(mesh)
    x = _as_tensor(x)
    assert x.shape[0] % n == 0, f"Channel count {x.shape[0]} must divide across {n} devices"
    parts = [
        _welch(xl, sampling_rate_hz=sampling_rate_hz, window_length_samples=window_length_samples,
               window_type=window_type, overlap_percent=overlap_percent)
        for xl in _split(x, n, 0, devices)
    ]
    return _gather(parts, 0, devices[0])


def parallel_csm(
    x,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
) -> tuple[np.ndarray, torch.Tensor]:
    """Cross-spectral matrix of ``x (C, T)``, rows split over the mesh.

    Each shard frames its channels (B1) and transforms them, the frame
    spectra of all shards are gathered on every device (the all-gather),
    each shard forms its ``(F, C/n, C)`` block of rows ``mean_k conj(X_a)
    X_b``; the rows are gathered on the mesh's first device and finished by
    the single-device `ops.spectral.csm_welch`'s own steps (`real_diagonal`,
    `csm_finish`). Returns ``(f, csm (F, C, C))``.
    """
    n, devices = _shards(mesh)
    x = _as_tensor(x)
    C = x.shape[0]
    assert C % n == 0, f"{C} channels do not divide over {n} devices"
    window, step = welch_plan(window_length_samples, window_type, overlap_percent)
    norm = scaling.fft_norm()
    # local spectra, laid out (F, C/n, K) for the batched products
    spectra = [
        torch.fft.rfft(_windowed_frames(xl, window, step, detrend), dim=-1,
                       norm=norm).permute(2, 0, 1).contiguous()
        for xl in _split(x, n, 0, devices)
    ]
    rows = []
    for Y, dev in zip(spectra, devices):
        Y_all = _gather(spectra, 1, dev)  # (F, C, K): the all-gather
        K = Y.shape[-1]
        # rows[f, a, b] = mean_k conj(Y[f, a, k]) Y_all[f, b, k]
        rows.append(torch.matmul(Y_all, Y.mH).transpose(-1, -2) / K)
    Q = _gather(rows, 1, devices[0])  # (F, C, C)
    return csm_finish(real_diagonal(Q), window, sampling_rate_hz, scaling)


def parallel_filterbank(sos_bank: np.ndarray, x, mesh: Mesh) -> torch.Tensor:
    """A bank of SOS cascades ``sos_bank (B, S, 6)`` applied to ``x (...,
    T)`` with the bands split over the mesh: each shard builds its bands'
    block operators on the host in float64 and runs them through
    `ops.iir_block.sosfilt_bank_apply_planes` (the bank kernel B3 on a
    float32 CUDA tensor). ``(B, ..., T)`` on the mesh's first device,
    complex for a complex bank (its imaginary parts kept)."""
    from ..ops.iir_block import sosfilt_bank_apply_planes, sosfilt_bank_operators

    n, devices = _shards(mesh)
    sos_bank = np.asarray(sos_bank)
    B = sos_bank.shape[0]
    assert B % n == 0, f"{B} bands do not divide over {n} devices"
    x = _as_tensor(x)
    m = B // n
    parts = []
    for i, dev in enumerate(devices):
        ops = sosfilt_bank_operators(sos_bank[i * m:(i + 1) * m], x.shape[-1])
        re, im = sosfilt_bank_apply_planes(ops, x.to(dev))
        parts.append(re if im is None else torch.complex(re, im))
    return _gather(parts, 0, devices[0])


def sharded_map_reduce(map_fn, x, mesh: Mesh, reduce: str | None = None):
    """``map_fn`` on each leading-axis element of ``x``, the leading axis
    split over the mesh (`torch.func.vmap` on each shard), then ``reduce``:
    None (the mapped values, concatenated), "sum" or "mean" (each shard's
    sum, summed on the mesh's first device). ``map_fn`` must be vmappable."""
    n, devices = _shards(mesh)
    x = _as_tensor(x)
    assert x.shape[0] % n == 0, f"Leading axis {x.shape[0]} must divide across {n} devices"
    parts = [torch.func.vmap(map_fn)(xl) for xl in _split(x, n, 0, devices)]
    if reduce is None:
        return _gather(parts, 0, devices[0])
    total = sum(p.sum(dim=0).to(devices[0]) for p in parts)
    if reduce == "sum":
        return total
    if reduce == "mean":
        return total / x.shape[0]
    raise ValueError(f"reduce must be None, 'sum' or 'mean', got {reduce!r}")


def parallel_fir_filter(h, x, mesh: Mesh) -> torch.Tensor:
    """Causal FIR filtering ``lfilter(h, 1, x)`` of ``x (..., T)`` with the
    TIME axis split over the mesh: each shard takes the last ``K - 1``
    samples of its left neighbour (the halo; zeros for the first shard) and
    convolves (`ops.fft_conv.fft_convolve`). ``(..., T)`` on the mesh's
    first device."""
    from ..ops.fft_conv import fft_convolve

    n, devices = _shards(mesh)
    x = _as_tensor(x)
    T = x.shape[-1]
    assert T % n == 0, f"time length {T} must divide across {n} devices"
    h = np.asarray(h)
    K = len(h)
    assert K - 1 <= T // n, "kernel longer than a time shard"
    if K == 1:
        # a 1-tap filter is a scaling: no history needed
        return x.to(devices[0]) * float(h[0])
    shards = _split(x, n, -1, devices)
    parts = []
    for i, (xl, dev) in enumerate(zip(shards, devices)):
        if i == 0:
            halo = xl.new_zeros(xl.shape[:-1] + (K - 1,))
        else:
            halo = shards[i - 1][..., -(K - 1):].to(dev)
        hd = torch.as_tensor(h, dtype=xl.dtype, device=dev)
        y = fft_convolve(torch.cat([halo, xl], dim=-1), hd, "full")
        parts.append(y[..., K - 1:K - 1 + xl.shape[-1]])
    return _gather(parts, -1, devices[0])


def parallel_das_map(amp, diff, wave_numbers, csm, mesh: Mesh) -> torch.Tensor:
    """The frequency-domain DAS map ``(G, F)`` with the grid points split
    over the mesh: each shard builds its points' steering from ``amp,
    diff (M, G)`` and ``wave_numbers (F,)`` and evaluates ``Re(hᴴ C_f h)``
    through `ops.cuda_das.das_map` (the DAS map kernel B5 on float32 CUDA
    tensors); the CSM ``(F, M, M)`` goes to every device. G must divide
    over the mesh's first axis. On the mesh's first device."""
    from ..ops.cuda_das import das_map

    n, devices = _shards(mesh)

    def f32(v):
        v = v if torch.is_tensor(v) else torch.as_tensor(np.ascontiguousarray(v))
        return v.to(torch.float32)

    amp, diff, k = f32(amp), f32(diff), f32(wave_numbers)
    G = amp.shape[1]
    assert G % n == 0, f"{G} grid points do not divide over {n} devices"
    csm = csm if torch.is_tensor(csm) else torch.as_tensor(np.asarray(csm))
    cre, cim = f32(csm.real), f32(csm.imag)
    parts = [
        das_map(a, d, k.to(dev), cre.to(dev).contiguous(), cim.to(dev).contiguous())
        for a, d, dev in zip(_split(amp, n, 1, devices), _split(diff, n, 1, devices), devices)
    ]
    return _gather(parts, 0, devices[0])


def parallel_batch_descriptors(rirs, sampling_rate_hz: int, mesh: Mesh) -> dict:
    """`room_acoustics.batch_descriptors` (D50, C80, centre time) of an RIR
    fleet ``(B, T)`` with the batch split over the mesh: a dict of ``(B,)``
    tensors on the mesh's first device."""
    from ..room_acoustics.batch import batch_descriptors

    n, devices = _shards(mesh)
    rirs = _as_tensor(rirs)
    B = rirs.shape[0]
    assert B % n == 0, f"{B} RIRs do not divide over {n} devices"
    parts = [batch_descriptors(r, sampling_rate_hz) for r in _split(rirs, n, 0, devices)]
    return {key: _gather([p[key] for p in parts], 0, devices[0]) for key in parts[0]}


def _framed_halo_setup(window_length: int, step: int, T: int, n: int) -> tuple:
    """Checks of the time-sharded framed ops: each shard owns the frames
    starting in it (``L/step`` of them) and needs the right neighbour's
    first ``window - step`` samples (`dsptoolbox_tpu/parallel/ops.py:
    424-440`). Returns ``(L, halo)``."""
    assert T % n == 0, f"time length {T} must divide across {n} devices"
    L = T // n
    assert L % step == 0, (
        f"local shard ({L}) must be a multiple of the hop size ({step}) so "
        "every device owns a whole number of frames"
    )
    halo = window_length - step
    assert halo <= L, "window overhang longer than a time shard"
    return L, halo


def _framed_spectra_halo(x: torch.Tensor, mesh: Mesh, window: np.ndarray, step: int,
                         detrend: bool, fft_length: int, norm: str) -> list:
    """Each time shard's windowed frame spectra ``(..., L/step, F)``, on the
    shard's device: the shard extended by the first ``window - step``
    samples of its right neighbour (zeros after the last shard, the
    zero-padding convention of the framing) and framed by B1."""
    n, devices = _shards(mesh)
    shards = _split(x, n, -1, devices)
    W = len(window)
    halo_len = W - step
    out = []
    for i, (xl, dev) in enumerate(zip(shards, devices)):
        if halo_len > 0:
            if i == n - 1:
                halo = xl.new_zeros(xl.shape[:-1] + (halo_len,))
            else:
                halo = shards[i + 1][..., :halo_len].to(dev)
            xl = torch.cat([xl, halo], dim=-1)
        k_local = (xl.shape[-1] - halo_len) // step
        frames = _windowed_frames(xl, window, step, detrend)[..., :k_local, :]
        out.append(torch.fft.rfft(frames, n=fft_length, dim=-1, norm=norm))
    return out


def parallel_stft(
    x,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    fft_length_samples: int | None = None,
    detrend: bool = False,
    scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
):
    """STFT of ``x (..., T)`` with the TIME axis split over the mesh: each
    shard frames its own samples and the ``window - step`` samples its last
    frames reach into its right neighbour. Returns ``(time_s, freqs_hz, S
    (..., frames, F))``, ``S`` on the mesh's first device, equal to the
    single-device ``ops.spectral.stft(..., padding=False)``."""
    n, devices = _shards(mesh)
    x = _as_tensor(x)
    if fft_length_samples is None:
        fft_length_samples = window_length_samples
    window, _, step = stft_plan(window_length_samples, window_type, overlap_percent)
    _framed_halo_setup(window_length_samples, step, x.shape[-1], n)
    S = _gather(
        _framed_spectra_halo(x, mesh, window, step, detrend, fft_length_samples,
                             scaling.fft_norm()), -2, devices[0])
    S = stft_scale(S, window, fft_length_samples, sampling_rate_hz, scaling)
    n_frames = S.shape[-2]
    time_s = np.linspace(0, x.shape[-1] / sampling_rate_hz, n_frames)
    freqs_hz = np.fft.rfftfreq(len(window), 1 / sampling_rate_hz)
    return time_s, freqs_hz, S


def parallel_welch_time(
    x,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
) -> torch.Tensor:
    """Welch autospectra of ``x (..., T)`` with the TIME axis split over the
    mesh: each shard sums the periodograms of its frames (halo as in
    `parallel_stft`), the sums are added on the mesh's first device (the
    psum) and divided by the frame count. Mean averaging only. ``(..., F)``,
    the single-device ``ops.spectral.welch`` up to summation order."""
    n, devices = _shards(mesh)
    x = _as_tensor(x)
    window, step = welch_plan(window_length_samples, window_type, overlap_percent)
    _framed_halo_setup(window_length_samples, step, x.shape[-1], n)
    K_total = x.shape[-1] // step
    spectra = _framed_spectra_halo(x, mesh, window, step, detrend, window_length_samples,
                                   scaling.fft_norm())
    csd = sum((X.abs() ** 2.0).sum(dim=-2).to(devices[0]) for X in spectra) / K_total
    return welch_scale(csd, window, sampling_rate_hz=sampling_rate_hz, scaling=scaling)

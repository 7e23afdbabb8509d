"""Framing (strided segmentation) and overlap-add reconstruction
(`dsptoolbox_tpu/ops/framing.py`).

Signals are channels-first ``(..., T)``. Framing is a strided view
(`Tensor.unfold`) of the zero-padded signal; overlap-add accumulates the
``ceil(L / step)`` step-chunks of every frame with shifted dense adds.

`reconstruct_framed_signal` divides the overlap-added frames by the
window² envelope (host float64, cached on the device per shape).

Behavioral reference: `dsptoolbox/standard/_framed_signal_representation.py`
and `dsptoolbox/helpers/other.py:181-213` (frame-count convention).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .pad_trim import pad_trim_axis


def compute_number_frames(
    window_length: int, step: int, signal_length: int, zero_padding: bool = True
) -> tuple[int, int]:
    """Number of frames and end-padding for segmenting a signal.

    Matches the reference convention (`helpers/other.py:181`): with
    ``zero_padding`` the signal is padded with ``window_length - (L % step)``
    samples (note: a full extra window when L is a multiple of the step) and
    produces ``ceil(L / step)`` frames; without it, trailing partial frames
    are dropped.
    """
    if zero_padding:
        n_frames = math.ceil(signal_length / step)
        padding = window_length - int(signal_length % step)
    else:
        n_frames = math.ceil((signal_length - window_length) / step)
        padding = 0
    return n_frames, padding


def frame_signal(
    x: torch.Tensor,
    window_length: int,
    step: int,
    keep_last_frames: bool = True,
) -> torch.Tensor:
    """Segment ``x (..., T)`` into overlapping frames ``(..., n_frames, L)``.

    ``n_frames`` follows `compute_number_frames`; when ``keep_last_frames`` the
    tail is zero-padded. The result is a strided view (of ``x`` itself when
    no padding is needed): copy it before writing into it.
    """
    length = x.shape[-1]
    n_frames, _ = compute_number_frames(
        window_length, step, length, zero_padding=keep_last_frames
    )
    # signal shorter than one window with keep_last_frames=False: zero
    # frames (the reference's ceil() goes negative there and it crashes)
    n_frames = max(0, n_frames)
    span = max(window_length, (n_frames - 1) * step + window_length)
    if span > length:
        x = F.pad(x, (0, span - length))
    return x.unfold(-1, window_length, step)[..., :n_frames, :]


def overlap_add(
    frames: torch.Tensor,
    step: int,
    total_length: int | None = None,
) -> torch.Tensor:
    """Overlap-add frames ``(..., n_frames, L)`` back into ``(..., T)``.

    ``total_length`` defaults to the reference's reconstruction length
    ``step * n_frames + L - step``.
    """
    n_frames, window_length = frames.shape[-2], frames.shape[-1]
    if total_length is None:
        total_length = step * n_frames + window_length - step
    # pad the window axis to k·step, view each frame as k contiguous
    # step-chunks, and add the j-th chunk of every frame at chunk row
    # (frame + j): k shifted dense adds instead of a scatter
    k = -(-window_length // step)
    pad = k * step - window_length
    if pad:
        frames = F.pad(frames, (0, pad))
    chunks = frames.reshape(frames.shape[:-1] + (k, step))
    rows = n_frames + k - 1
    acc = frames.new_zeros(frames.shape[:-2] + (rows, step))
    for j in range(k):
        acc[..., j : j + n_frames, :] += chunks[..., :, j, :]
    out = acc.reshape(frames.shape[:-2] + (rows * step,))
    if rows * step >= total_length:
        return out[..., :total_length]
    return F.pad(out, (0, total_length - rows * step))


def window_envelope(
    window: np.ndarray,
    total_length: int,
    step: int,
    n_frames: int,
    squared: bool = True,
) -> np.ndarray:
    """Summed (optionally squared) window envelope across overlapped frames
    (`dsptoolbox_tpu/ops/framing.py:126`), host float64
    (reference `standard/_standard_backend.py:408`)."""
    w = np.asarray(window, dtype=np.float64)
    if squared:
        w = w**2
    env = np.zeros(total_length, dtype=np.float64)
    for k in range(n_frames):
        start = k * step
        stop = min(start + len(w), total_length)
        if start >= total_length:
            break
        env[start:stop] += w[: stop - start]
    return env


@lru_cache(maxsize=16)
def _device_window_envelope(window: bytes, total_length: int, step: int, n_frames: int,
                            safety_threshold, dtype: torch.dtype, device: torch.device):
    """The window and its window² envelope's divisor on ``device``, cached
    (a copy from host memory would wait for the queued device work):
    ``(window, divisor, mask)``, the divisor the envelope clipped at
    ``safety_threshold`` where it is not zero and 1 elsewhere, the mask
    where it is not zero (None when everywhere)."""
    w = np.frombuffer(window, np.float64).copy()
    env = window_envelope(w, total_length, step, n_frames, squared=True)
    if safety_threshold is not None:
        env = np.clip(env, a_min=safety_threshold, a_max=None)
    nonzero = env > np.finfo(np.float64).tiny
    return (torch.as_tensor(w, dtype=dtype, device=device),
            torch.as_tensor(np.where(nonzero, env, 1.0), dtype=dtype, device=device),
            None if nonzero.all() else torch.as_tensor(nonzero, device=device))


def reconstruct_framed_signal(
    frames: torch.Tensor,
    step: int,
    window: np.ndarray | None = None,
    original_signal_length: int | None = None,
    safety_threshold: float = 1e-4,
) -> torch.Tensor:
    """Inverse of `frame_signal` with window² COLA normalisation
    (`dsptoolbox_tpu/ops/framing.py:151`): ``frames (..., n_frames, L)`` →
    ``(..., T)``. The frames are multiplied by the window (if given),
    overlap-added and divided by the squared-window envelope clipped at
    ``safety_threshold`` (reference `_framed_signal_representation.py:70`).
    """
    n_frames, wl = frames.shape[-2], frames.shape[-1]
    # parity: the reference computes this length with the same float
    # expression (`_framed_signal_representation.py:115-118`); for some
    # (wl, step) pairs (e.g. wl=12, step=5) the truncation lands one sample
    # short of the exact `step*n + wl - step`
    total_length = int(step * n_frames + wl * (1 - step / wl))
    if window is None:
        out = overlap_add(frames, step, total_length)
    else:
        w, divisor, nonzero = _device_window_envelope(
            np.asarray(window, dtype=np.float64).tobytes(), total_length, step, n_frames,
            safety_threshold, frames.dtype, frames.device)
        out = overlap_add(frames * w, step, total_length)
        scaled = out / divisor
        out = scaled if nonzero is None else torch.where(nonzero, scaled, out)
    if original_signal_length is not None:
        out = pad_trim_axis(out, original_signal_length, axis=-1)
    return out

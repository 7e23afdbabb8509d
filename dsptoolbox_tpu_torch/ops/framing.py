"""Framing (strided segmentation) and overlap-add reconstruction
(`dsptoolbox_tpu/ops/framing.py`).

Signals are channels-first ``(..., T)``. Framing is a strided view
(`Tensor.unfold`) of the zero-padded signal; overlap-add accumulates the
``ceil(L / step)`` step-chunks of every frame with shifted dense adds.

Behavioral reference: `dsptoolbox/standard/_framed_signal_representation.py`
and `dsptoolbox/helpers/other.py:181-213` (frame-count convention).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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

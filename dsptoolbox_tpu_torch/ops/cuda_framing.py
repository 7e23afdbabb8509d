"""Fused framing + windowing + per-frame detrend (the spectral front end).

Replaces the Pallas kernel ``windowed_frames_pallas``
(`dsptoolbox_tpu/ops/pallas_framing.py`), which wrote the finished frames in
one pass over TPU memory under (8, 128) tiling limits.

On the H100 this is bound by device-memory bytes: it reads ~T floats and
writes K·L floats per row, with no arithmetic to speak of. The CUDA kernel
(`csrc/framing.cu`) reads the unpadded input in place, treating samples
outside it (the STFT's symmetric ``pad`` and the framing tail) as zero, and
writes each frame once; no padded or framed copy is materialised. The plain
version pads, takes a strided view, multiplies by the window and subtracts
the mean, which materialises the padded signal and the windowed frames
before the demeaned ones.

`windowed_frames` dispatches: a float32 CUDA tensor goes to the kernel unless
the switch (`_config.set_framing_kernel`) is "off"; CPU tensors and other
dtypes take the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _config, _cuda
from .framing import compute_number_frames, frame_signal

# kernel launches since the last reset (read by run reports)
launches = 0

_c = ctypes.c_void_p
_ARGTYPES = [_c, _c, _c, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, _c]


def windowed_frames_plain(
    x: torch.Tensor, window: torch.Tensor, step: int, detrend: bool, pad: int = 0
) -> torch.Tensor:
    """Plain PyTorch version: ``frame_signal(x) * window`` of ``x`` padded
    with ``pad`` zeros at both ends, minus each frame's mean when
    ``detrend``. ``(..., T)`` → ``(..., K, L)``."""
    if pad:
        x = F.pad(x, (pad, pad))  # last axis only
    frames = frame_signal(x, window.shape[-1], step, keep_last_frames=True)
    frames = frames * window
    if detrend:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    return frames


def windowed_frames_cuda(
    x: torch.Tensor, window: torch.Tensor, step: int, detrend: bool, pad: int = 0
) -> torch.Tensor:
    """CUDA kernel: the same frames as `windowed_frames_plain`, from one
    pass over ``x``. float32 CUDA tensors only."""
    global launches
    if not (x.is_cuda and window.device == x.device):
        raise ValueError("windowed_frames_cuda needs x and window on one CUDA device")
    if x.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("windowed_frames_cuda takes float32 tensors")
    if window.ndim != 1 or step <= 0 or pad < 0:
        raise ValueError("window must be 1-D, step positive and pad non-negative")
    L = window.shape[0]
    T = x.shape[-1]
    batch = x.shape[:-1]
    K, _ = compute_number_frames(L, step, T + 2 * pad, True)
    out = torch.empty(batch + (K, L), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    B = math.prod(batch)
    x2 = x.reshape(B, T).contiguous()
    win = window.contiguous()
    fn = _cuda.function("framing", "dsptb_windowed_frames_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), win.data_ptr(), out.data_ptr(), B, T, pad,
                 step, L, K, int(bool(detrend)), _cuda.stream_of(x))
    _cuda.check(err, "windowed_frames kernel")
    launches += 1
    return out


def windowed_frames(
    x: torch.Tensor, window: torch.Tensor, step: int, detrend: bool, pad: int = 0
) -> torch.Tensor:
    """Windowed (optionally demeaned) frames of ``x (..., T)``, padded with
    ``pad`` zeros at both ends → ``(..., K, L)`` with the zero-padded tail
    of `frame_signal`."""
    if x.dtype == torch.float32 and _config.use_kernel(
        _config.framing_kernel(), x
    ):
        return windowed_frames_cuda(x, window, step, detrend, pad)
    return windowed_frames_plain(x, window, step, detrend, pad)

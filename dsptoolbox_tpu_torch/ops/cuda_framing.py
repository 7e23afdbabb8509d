"""Fused framing + windowing + per-frame detrend (the spectral front end).

Replaces the Pallas kernel ``windowed_frames_pallas``
(`dsptoolbox_tpu/ops/pallas_framing.py:45`), which wrote the finished frames
in one pass over TPU memory, one frame per grid step, under (8, 128) tiling
limits.

What bounds it on the H100: device-memory bytes. A row reads ~T floats and
writes K·L, with one multiply per output: 22 µs at the chain's STFT shape
(24.6 MB read, 49.2 MB written at 3.35 TB/s), 110 µs at the 10 s × 48 kHz
Welch CSM (64 × 480,000 samples, detrend). The kernel (`csrc/framing.cu`)
reads the unpadded input in place, treating samples outside it (the STFT's
symmetric ``pad`` and the framing tail) as zero, and writes each frame once.
For frames of up to `WARP_MAX_L` samples a block stages the input span of
`frames_per_block` consecutive frames of one row in shared memory with
16-byte copies and gives each frame to one warp, which windows, sums,
demeans and stores it from registers; longer frames take one block per
frame. The plain version pads, takes a strided view, multiplies by the
window and subtracts the mean, which materialises the padded signal and the
windowed frames before the demeaned ones.

A call's host time before the launch stood beside its device time on the
chain (the chain is host-bound), so the wrapper does the checks, the
output's allocation and the launch (`_cuda.Kernel`), and no other tensor
work: a contiguous x is passed as it is.

`windowed_frames` dispatches by `_config.use_kernel` ("framing"): a float32
CUDA tensor goes to the kernel outside `_config.kernels_off()`; CPU tensors
and other dtypes take the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _config, _cuda
from .framing import compute_number_frames, frame_signal

# kernel launches since the last reset (read by run reports)
launches = 0

# csrc/framing.cu: the warp kernel's longest frame, its shared memory for a
# block's input span and window (floats), and its warps (one frame each)
WARP_MAX_L = 2048
SMEM_FLOATS = 48 * 1024 // 4
WARPS = 8

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_KERNEL = _cuda.Kernel(
    "framing", "dsptb_windowed_frames_f32",
    [_c, _c, _c, _ll, _ll, _ll, _ll, _i, _ll, _i, _i, _c],
    "windowed_frames kernel",
)


@functools.lru_cache(maxsize=256)
def frames_per_block(L: int, step: int, K: int) -> int:
    """Consecutive frames of one row that a block of the warp kernel takes:
    one per warp, fewer where the input span ``(n - 1)·step + L`` (plus 16
    bytes of alignment each side) and the window would not fit the block's
    shared memory, at least 1; 0 for frames longer than `WARP_MAX_L`, which
    take one block each."""
    if L > WARP_MAX_L:
        return 0
    for n in range(min(WARPS, K), 1, -1):
        if span_floats(L, step, n) <= SMEM_FLOATS:
            return n
    return 1


def span_floats(L: int, step: int, n: int) -> int:
    """Shared-memory floats of a warp-kernel block of ``n`` frames: the
    window (to a multiple of 4) and the input span, its start rounded down
    to 16 bytes of x and its end up."""
    return ((L + 3) & ~3) + 4 * (((n - 1) * step + L + 6) // 4)


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
    index = x.get_device()
    if index < 0 or window.get_device() != index:
        raise ValueError("windowed_frames_cuda needs x and window on one CUDA device")
    if x.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("windowed_frames_cuda takes float32 tensors")
    if window.ndim != 1 or step <= 0 or pad < 0:
        raise ValueError("window must be 1-D, step positive and pad non-negative")
    L = window.shape[0]
    T = x.shape[-1]
    K, _ = compute_number_frames(L, step, T + 2 * pad, True)
    out = x.new_empty(x.shape[:-1] + (K, L))
    if out.numel() == 0:
        return out
    if not x.is_contiguous():
        x = x.contiguous()
    if not window.is_contiguous():
        window = window.contiguous()
    _KERNEL.launch(index, x.data_ptr(), window.data_ptr(), out.data_ptr(),
                   out.numel() // (K * L), T, pad, step, L, K, 1 if detrend else 0,
                   frames_per_block(L, step, K))
    launches += 1
    return out


def windowed_frames(
    x: torch.Tensor, window: torch.Tensor, step: int, detrend: bool, pad: int = 0
) -> torch.Tensor:
    """Windowed (optionally demeaned) frames of ``x (..., T)``, padded with
    ``pad`` zeros at both ends → ``(..., K, L)`` with the zero-padded tail
    of `frame_signal`."""
    if _config.use_kernel("framing", x):
        return windowed_frames_cuda(x, window, step, detrend, pad)
    return windowed_frames_plain(x, window, step, detrend, pad)

"""CUDA kernel of the banded smoothing operator (`csrc/banded.cu`).

For every segment of a plan (`ops.banded`), in one launch:

    out[row0_s + b·TR + r, c] = Σ_k slab_s[b, r, k] · x[offsets_s[b] + k, c]

Replaces the Pallas kernel ``banded_matmul`` / ``_banded_kernel``
(`dsptoolbox_tpu/ops/pallas_banded.py:43`). There each segment was one
launch, whose grid steps DMA'd their ``x`` window into VMEM by hand, at an
element offset brought ahead of the grid by scalar prefetch, and ran one
(128, SPAN) × (SPAN, C) MXU dot, with C padded to 128 lanes.

What bounds it on the H100: at the measurement path's width (F = 32,769
bins, 1/3 octave, C = 32 real planes of 16 complex channels) the slabs hold
158 M weights (633 MB fp32), each used for 32 multiply-adds: 633 MB at 3.35
TB/s is 0.19 ms, and 1.0e10 FLOP at the 67 TFLOP/s of fp32 FFMA 0.15 ms. So
it is bound by the slab's bytes, with the FMA pipe close behind: an FFMA
kernel would have to issue FMAs near their peak while streaming near its
own, and the first one reached neither (0.30 ms device). The kernel runs the
product on the tensor cores as three TF32 ``mma.sync`` products of a hi/lo
split of both operands (lo·hi, hi·lo, hi·hi; fp32 accuracy, never a single
TF32 product), ~0.10 ms of tensor-core time at the rate ``mma.sync``
reaches on the card, each chunk's sums moved from the tensor cores'
accumulators into fp32 running sums rounded to nearest (kept in the
accumulators, whose adds round toward zero, a long band's sum drifted),
and streams the slab through a ring of four
shared-memory stages filled by ``cp.async``, three chunks in flight while
the fourth is computed. Every slab element comes from device memory once
and serves all 32 columns. The plan's segments (band spans 640 to 6912 at
full width) go in one launch, longest bands first, so the short segments
fill the card beside the long one instead of running alone. A block reads
its own offset; rows of x outside ``[0, F)`` read as zero, so no offset can
read out of bounds.

`banded_matmul_cuda` is the wrapper: it checks devices, types, shapes and
contiguity, launches on PyTorch's current stream (`_cuda.Kernel`) and counts
its launches. A plan's checks and ``ctypes`` arrays are built once and kept
on the plan (`ops.banded.DevicePlan`), so a call costs the host the output's
allocation and the launch. The plain version and the dispatcher are in
`ops.banded`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

# kernel launches since the last reset (read by run reports)
launches = 0

_c = ctypes.c_void_p
_i = ctypes.c_int
_KERNEL = _cuda.Kernel("banded", "dsptb_banded_matmul_f32",
                       [_c] * 6 + [_i, _i, _c, _i, _i, _c, _c], "banded matmul kernel")
_INT_MAX = 2**31 - 1
MAX_SEGMENTS = 8


def _segment_args(plan: list[dict]) -> tuple:
    """``(device index, row count, ctypes arguments)`` of a plan's segments,
    checked. Built once for a plan from `ops.banded.plan_to_torch` (a
    `DevicePlan`) and kept on it; built anew for a plain list."""
    args = getattr(plan, "launch_args", None)
    if args is not None:
        return args
    if not 0 < len(plan) <= MAX_SEGMENTS:
        raise ValueError(f"banded_matmul_cuda takes 1 to {MAX_SEGMENTS} segments")
    dev = plan[0]["slab"].device
    TR = plan[0]["slab"].shape[1]
    for seg in plan:
        slab, offs = seg["slab"], seg["offsets"]
        if not (slab.is_cuda and slab.device == dev and offs.device == dev):
            raise ValueError("banded_matmul_cuda needs all tensors on one CUDA device")
        if slab.dtype != torch.float32 or offs.dtype != torch.int32:
            raise TypeError("banded_matmul_cuda takes float32 slabs and int32 offsets")
        if (slab.ndim != 3 or slab.shape[1] != TR or offs.shape != slab.shape[:1]
                or not 0 <= seg["rows"] <= slab.shape[0] * TR):
            raise ValueError("segments must hold slab (NB, TR, SPAN), offsets (NB,) "
                             "and rows <= NB·TR, with one TR")
        if not (slab.is_contiguous() and offs.is_contiguous()):
            raise ValueError("banded_matmul_cuda takes contiguous slabs and offsets")
    rows = [int(seg["rows"]) for seg in plan]
    if max(sum(rows), *(seg["slab"].shape[2] for seg in plan)) > _INT_MAX:
        raise ValueError("banded_matmul_cuda: a dimension exceeds 2**31 - 1")
    n = len(plan)
    arrays = ((_c * n)(*(seg["slab"].data_ptr() for seg in plan)),
              (_c * n)(*(seg["offsets"].data_ptr() for seg in plan)),
              (_i * n)(*(seg["slab"].shape[0] for seg in plan)),
              (_i * n)(*(seg["slab"].shape[2] for seg in plan)),
              (_i * n)(*(sum(rows[:i]) for i in range(n))), (_i * n)(*rows), n, TR)
    args = (dev.index, sum(rows), arrays)
    if hasattr(plan, "launch_args"):
        plan.launch_args = args
    return args


def banded_matmul_cuda(plan: list[dict], x_padded: torch.Tensor) -> torch.Tensor:
    """CUDA kernel, one launch: ``out (Σ rows, C)``, the segments' rows in
    plan order, for a plan (``rows``, ``span``, ``offsets (NB,)`` int32 and
    ``slab (NB, TR, SPAN)`` float32, contiguous, one TR) and ``x_padded
    (F, C)`` float32, all on one CUDA device. Rows of ``x_padded`` past its
    end read as zero."""
    global launches
    index, n_rows, arrays = _segment_args(plan)
    if x_padded.get_device() != index:
        raise ValueError("banded_matmul_cuda needs all tensors on one CUDA device")
    if x_padded.dtype != torch.float32 or x_padded.ndim != 2:
        raise TypeError("banded_matmul_cuda takes a float32 x_padded (F, C)")
    F, C = x_padded.shape
    if max(F, C) > _INT_MAX:
        raise ValueError("banded_matmul_cuda: a dimension exceeds 2**31 - 1")
    out = x_padded.new_empty((n_rows, C))
    if out.numel() == 0:
        return out
    if not x_padded.is_contiguous():
        x_padded = x_padded.contiguous()
    _KERNEL.launch(index, *arrays, x_padded.data_ptr(), F, C, out.data_ptr())
    launches += 1
    return out

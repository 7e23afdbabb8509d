"""Banded-operator matmul: ``out[r] = W[r] @ x[off_r : off_r + SPAN]``
(`dsptoolbox_tpu/ops/pallas_banded.py`).

The operator behind O(F·W) fractional-octave complex smoothing
(`transfer_functions.complex_smoothing`, at every grid size): a row-banded
matrix whose band start grows with the row index, stored as a plan of
segments (`transfer_functions._backend._banded_smoothing_plan`, host
float64 numpy): row tiles, each a dense ``(TR, SPAN)`` weight slab plus the
column offset of its band, grouped by band span.

- `banded_matmul_plain`: the plain PyTorch version of one segment, a
  gather of each tile's x window and one batched matmul (the JAX package's
  ``banded_matmul_xla``); `banded_plan_plain` runs it over a plan;
- `banded_apply`: the dispatcher over a plan, by `_config.use_kernel`
  ("banded"). A float32 CUDA tensor goes to the CUDA kernel
  (`ops.cuda_banded`, every segment in one launch) outside
  `_config.kernels_off()`; CPU tensors and float64 take the plain version;
- `plan_to_torch`: a host plan on a device, as a `DevicePlan`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _config
from . import cuda_banded


def banded_matmul_plain(
    slab: torch.Tensor, offsets: torch.Tensor, x_padded: torch.Tensor
) -> torch.Tensor:
    """``out[b·TR + r, c] = Σ_k slab[b, r, k] · x_padded[offsets[b] + k, c]``
    for ``slab (NB, TR, SPAN)``, ``offsets (NB,)`` and ``x_padded (F, C)``
    with ``F ≥ max(offsets) + SPAN``. Returns ``(NB·TR, C)``."""
    nb, tr, span = slab.shape
    idx = offsets.long()[:, None] + torch.arange(span, device=offsets.device)
    xg = x_padded[idx]  # (NB, SPAN, C)
    return torch.bmm(slab, xg).reshape(nb * tr, x_padded.shape[1])


def banded_plan_plain(plan: list[dict], x_padded: torch.Tensor) -> torch.Tensor:
    """`banded_matmul_plain` over every segment of a device plan, each
    segment's first ``rows`` rows, concatenated: ``(Σ rows, C)``."""
    return torch.cat(
        [banded_matmul_plain(seg["slab"], seg["offsets"], x_padded)[: seg["rows"]]
         for seg in plan],
        dim=0,
    )


def banded_apply(plan: list[dict], x_padded: torch.Tensor) -> torch.Tensor:
    """The banded operator of a device plan (`plan_to_torch`) applied to
    ``x_padded (F, C)`` → ``(Σ rows, C)``, on the CUDA kernel or the plain
    version (see the module docstring). Where the JAX package dispatched
    each segment, padding C to 128 lanes on the TPU, the kernel takes the
    whole plan in one launch at any C."""
    if _config.use_kernel("banded", x_padded):
        return cuda_banded.banded_matmul_cuda(plan, x_padded)
    return banded_plan_plain(plan, x_padded)


class DevicePlan(list):
    """A banded plan on a device (`plan_to_torch`), not to be changed once
    built: the CUDA wrapper keeps its checked launch arguments for the plan
    in ``launch_args``."""

    launch_args = None


def plan_to_torch(plan, device, dtype=torch.float32) -> DevicePlan:
    """A banded plan (the JAX package's and the port's
    `_banded_smoothing_plan`: a list of ``{rows, offsets (NB,) int32, slab
    (NB, TR, SPAN) float32}`` numpy dicts) on ``device``: slabs in
    ``dtype``, offsets int32, ``rows`` and ``span`` as ints."""
    return DevicePlan(
        {
            "rows": int(seg["rows"]),
            "span": int(seg["slab"].shape[2]),
            "offsets": torch.as_tensor(
                np.asarray(seg["offsets"], np.int32), device=device
            ),
            "slab": torch.as_tensor(seg["slab"], dtype=dtype, device=device),
        }
        for seg in plan
    )

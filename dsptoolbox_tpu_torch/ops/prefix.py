"""Prefix sums (`dsptoolbox_tpu/ops/prefix.py`).

The JAX package computes the Schroeder backward integral's prefix sums as
blocked triangular matmuls on the TPU's matrix unit; on the GPU the prefix
is ``torch.cumsum`` (the room-acoustics batch already uses it).
"""

from __future__ import annotations

import torch

__all__ = ["cumsum_mxu"]


def cumsum_mxu(x, reverse: bool = False, block: int = 128) -> torch.Tensor:
    """Inclusive prefix (or suffix, ``reverse=True``) sum along the last
    axis. ``block`` (the JAX package's matmul block) is accepted and not
    used."""
    x = torch.as_tensor(x)
    if reverse:
        return torch.cumsum(x.flip(-1), dim=-1).flip(-1)
    return torch.cumsum(x, dim=-1)

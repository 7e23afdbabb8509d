"""Pad/trim primitives (`dsptoolbox_tpu/ops/pad_trim.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_trim_axis(
    x: torch.Tensor,
    desired_length: int,
    axis: int = -1,
    in_the_end: bool = True,
) -> torch.Tensor:
    """Zero-pad or trim ``x`` along ``axis`` to ``desired_length``.

    Mirrors `dsptoolbox/helpers/other.py:216` (`_pad_trim`). A trim returns
    a view of ``x``.
    """
    axis = axis % x.ndim
    current = x.shape[axis]
    if current == desired_length:
        return x
    if current < desired_length:
        extra = desired_length - current
        # F.pad lists widths from the LAST dimension backwards
        widths = [0, 0] * (x.ndim - axis)
        widths[-2:] = [0, extra] if in_the_end else [extra, 0]
        return F.pad(x, widths)
    start = 0 if in_the_end else current - desired_length
    return x.narrow(axis, start, desired_length)

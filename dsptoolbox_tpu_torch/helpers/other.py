"""Array helpers (`dsptoolbox_tpu/helpers/other.py`): host numpy index,
band and correlation helpers, and a phase `unwrap` on tensors."""

from __future__ import annotations

import numpy as np
import torch


def find_nearest_points_index_in_vector(points, vector) -> np.ndarray:
    points = np.atleast_1d(np.asarray(points))
    vector = np.asarray(vector)
    return np.argmin(np.abs(points[:, None] - vector[None, :]), axis=1)


def fractional_octave_bandwidth(f_c: float, fraction: int = 1) -> np.ndarray:
    """Lower/upper band edges for a fractional-octave band
    (`helpers/other.py:156-178`)."""
    if fraction == 0:
        return np.array([f_c, f_c])
    return np.array(
        [f_c * 2 ** (-1 / fraction / 2), f_c * 2 ** (1 / fraction / 2)]
    )


def pearson_correlation(x, y) -> float:
    """Pearson correlation coefficient of two 1-D arrays, 0.0 when either
    is constant (`helpers/other.py:105`). Host numpy."""
    x = np.asarray(x)
    y = np.asarray(y)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.sqrt((xc**2).sum() * (yc**2).sum())
    return float((xc * yc).sum() / denom) if denom > 0 else 0.0


def unwrap(p: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Phase unwrapping along ``dim`` with numpy's (and ``jnp.unwrap``'s)
    semantics: period 2π, discontinuity π; the corrections are summed with
    ``torch.cumsum`` in ``p``'s dtype."""
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + torch.pi, 2 * torch.pi) - torch.pi
    ddmod = torch.where((ddmod == -torch.pi) & (dd > 0), torch.pi, ddmod)
    ph_correct = torch.where(dd.abs() < torch.pi, 0.0, ddmod - dd)
    # the sum runs along the contiguous last axis: on a CUDA device torch's
    # scan along an outer axis walks it serially (62.9 ms for 262,145 bins
    # × 16 channels on an H100)
    correction = torch.cumsum(ph_correct.movedim(dim, -1).contiguous(), dim=-1)
    head = p.narrow(dim, 0, 1)
    tail = p.narrow(dim, 1, p.shape[dim] - 1)
    return torch.cat([head, tail + correction.movedim(-1, dim)], dim=dim)

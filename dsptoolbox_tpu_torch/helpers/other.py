"""Array helpers (`dsptoolbox_tpu/helpers/other.py`): host numpy index,
band, threshold, path and correlation helpers; the Toeplitz operator, the
distance matrix and a phase `unwrap` on tensors."""

from __future__ import annotations

import numpy as np
import torch


def find_nearest_points_index_in_vector(points, vector) -> np.ndarray:
    points = np.atleast_1d(np.asarray(points))
    vector = np.asarray(vector)
    return np.argmin(np.abs(points[:, None] - vector[None, :]), axis=1)


def find_frequencies_above_threshold(spec, f, threshold_db, normalize=True) -> list:
    """First and last frequency whose (normalized) magnitude exceeds the
    threshold (`helpers/other.py:21`); host float64."""
    mag = np.abs(spec.cpu().numpy() if torch.is_tensor(spec) else np.asarray(spec))
    floor = float(np.finfo(np.float64).smallest_normal)
    denum_db = 20.0 * np.log10(np.clip(mag, floor, None))
    if normalize:
        denum_db = denum_db - np.max(denum_db)
    freqs = np.asarray(f)[denum_db > threshold_db]
    return [freqs[0], freqs[-1]]


def toeplitz_convolution_matrix(h, length_of_input: int) -> torch.Tensor:
    """The convolution with ``h`` as a Toeplitz matrix ``(len(h)+L-1, L)``
    (`helpers/other.py:39`), gathered on ``h``'s device (numpy ``h`` stays
    on the CPU)."""
    h = torch.as_tensor(h).reshape(-1)
    K, L = h.shape[0], int(length_of_input)
    padded = torch.cat([h.new_zeros(L - 1), h, h.new_zeros(L - 1)])
    idx = (torch.arange(K + L - 1, device=h.device)[:, None]
           - torch.arange(L, device=h.device)[None, :] + (L - 1))
    return padded[idx]


def next_power_2(number, mode: str = "closest") -> int:
    """Closest, floor or ceil power of two (`helpers/other.py:53`)."""
    assert number > 0, "Only positive numbers are valid"
    mode = mode.lower()
    assert mode in ("closest", "floor", "ceil")
    p = np.log2(number)
    if mode == "closest":
        mode = "floor" if (p - int(p)) < 0.5 else "ceil"
    p = int(np.floor(p)) if mode == "floor" else int(np.ceil(p))
    return int(2**p)


def euclidean_distance_matrix(x, y) -> torch.Tensor:
    """Pairwise distances ``(Px, Py)`` of the points ``x (Px, D)`` and
    ``y (Py, D)`` (`helpers/other.py:66`): norms and one product, on the
    points' device (numpy points stay on the CPU)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    assert x.ndim == 2 and y.ndim == 2, "Inputs must have exactly two dimensions"
    assert x.shape[1] == y.shape[1], "Dimensions do not match"
    sq = (x.square().sum(1, keepdim=True) + y.square().sum(1)[None, :]
          - 2 * (x @ y.T))
    return sq.clamp(min=0.0).sqrt()


def check_format_in_path(path: str, desired_format: str) -> str:
    """Check a file path's extension, appending it when the path has none
    (`helpers/other.py:91`)."""
    import os

    parts = path.split(os.sep)[-1].split(".")
    if len(parts) != 1:
        assert parts[-1] == desired_format, f"{parts[-1]} is not the desired format"
    else:
        path += f".{desired_format}"
    return path


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

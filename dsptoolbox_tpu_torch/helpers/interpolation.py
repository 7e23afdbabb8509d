"""Interpolation onto static grids (`dsptoolbox_tpu/helpers/interpolation.py`).

The sample grids (frequency or log-frequency vectors) are host float64
numpy: they depend only on lengths and sampling rates. The bracketing
indices, the offsets and the interval widths are computed on the host; the
data is gathered and combined on its device. `pchip_interpolate` follows
scipy's ``PchipInterpolator`` (Fritsch–Carlson monotone cubic Hermite), as
the reference's fractional-octave smoothing needs
(`dsptoolbox/helpers/smoothing.py:66`).
"""

from __future__ import annotations

import numpy as np
import torch


def _brackets(x: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Interval index ``i`` with ``x[i] <= xq < x[i+1]``, clipped to the
    first and last interval."""
    idx = np.searchsorted(x, xq, side="right") - 1
    return np.clip(idx, 0, len(x) - 2)


def _column(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host ``values (n,)`` on ``like``'s device in its real dtype, shaped
    to broadcast over ``like``'s trailing axes."""
    t = torch.as_tensor(values, dtype=like.real.dtype, device=like.device)
    return t.reshape((-1,) + (1,) * (like.ndim - 1))


def linear_interpolate(
    x: np.ndarray, y: torch.Tensor, xq: np.ndarray, axis: int = 0
) -> torch.Tensor:
    """Linear interpolation of ``y`` sampled at static ``x`` onto static
    ``xq`` along ``axis`` (`helpers/interpolation.py:29`); queries outside
    ``[x[0], x[-1]]`` extend the edge intervals' lines."""
    x = np.asarray(x, dtype=np.float64)
    xq = np.asarray(xq, dtype=np.float64)
    idx = _brackets(x, xq)
    denom = x[idx + 1] - x[idx]
    w = (xq - x[idx]) / np.where(denom == 0, 1.0, denom)
    y = torch.movedim(y, axis, 0)
    i = torch.as_tensor(idx, device=y.device)
    wj = _column(w, y)
    out = y[i] * (1 - wj) + y[i + 1] * wj
    return torch.movedim(out, 0, axis)


def _pchip_slopes(hj: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """scipy's PCHIP slopes ``d (N, ...)`` from the interval widths ``hj
    (N-1, 1, ...)`` and the secants ``delta (N-1, ...)``
    (`helpers/interpolation.py:54`)."""
    h0, h1 = hj[:-1], hj[1:]
    d0, d1 = delta[:-1], delta[1:]
    w1 = 2 * h1 + h0
    w2 = h1 + 2 * h0
    # the weighted harmonic mean where the secants agree in sign
    denom = w1 / torch.where(d0 == 0, 1.0, d0) + w2 / torch.where(d1 == 0, 1.0, d1)
    interior = torch.where(torch.sign(d0) * torch.sign(d1) > 0, (w1 + w2) / denom, 0.0)

    def edge(h_a, h_b, del_a, del_b):
        d = ((2 * h_a + h_b) * del_a - h_a * del_b) / (h_a + h_b)
        d = torch.where(torch.sign(d) != torch.sign(del_a), 0.0, d)
        cond = (torch.sign(del_a) != torch.sign(del_b)) & (d.abs() > 3 * del_a.abs())
        return torch.where(cond, 3 * del_a, d)

    first = edge(hj[0], hj[1], delta[0], delta[1])
    last = edge(hj[-1], hj[-2], delta[-1], delta[-2])
    return torch.cat([first[None], interior, last[None]], dim=0)


def pchip_interpolate(
    x: np.ndarray, y: torch.Tensor, xq: np.ndarray, axis: int = 0
) -> torch.Tensor:
    """PCHIP interpolation of ``y`` (sampled at static ``x``) onto static
    ``xq`` along ``axis``: ``scipy.interpolate.PchipInterpolator(x, y,
    axis)(xq)`` (`helpers/interpolation.py:87`); linear below three
    samples."""
    x = np.asarray(x, dtype=np.float64)
    if len(x) < 3:
        return linear_interpolate(x, y, xq, axis=axis)
    y = torch.movedim(y, axis, 0)
    h = np.diff(x)
    hj = _column(h, y)
    delta = (y[1:] - y[:-1]) / hj
    d = _pchip_slopes(hj, delta)

    idx = _brackets(x, np.asarray(xq, dtype=np.float64))
    t = (np.asarray(xq, dtype=np.float64) - x[idx]) / h[idx]
    tj = _column(t, y)
    hq = _column(h[idx], y)
    i = torch.as_tensor(idx, device=y.device)
    t2 = tj * tj
    t3 = t2 * tj
    # the cubic Hermite basis
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + tj
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    out = h00 * y[i] + h10 * hq * d[i] + h01 * y[i + 1] + h11 * hq * d[i + 1]
    return torch.movedim(out, 0, axis)

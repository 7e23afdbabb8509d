"""Plot helpers of the classes: zeros and poles, the CSM grid
(`dsptoolbox_tpu/classes/_plots.py`). Host numpy and matplotlib, imported
at the first plot."""

from __future__ import annotations

import numpy as np

from ..plots.plots import _np, _plt


def zp_plot(z, p, info_box: str | None = None):
    """Zeros and poles around the unit circle."""
    plt = _plt()
    z, p = _np(z), _np(p)
    fig, ax = plt.subplots(1, 1, figsize=(5, 5))
    theta = np.linspace(0, 2 * np.pi, 361)
    ax.plot(np.cos(theta), np.sin(theta), linestyle="dashed", alpha=0.6)
    ax.scatter(np.real(z), np.imag(z), marker="o", facecolors="none", edgecolors="C0",
               label="Zeros")
    ax.scatter(np.real(p), np.imag(p), marker="x", color="C3", label="Poles")
    ax.set_xlabel("Real")
    ax.set_ylabel("Imaginary")
    ax.set_aspect("equal")
    ax.legend()
    if info_box is not None:
        ax.text(0.1, 0.5, info_box, transform=ax.transAxes, verticalalignment="top",
                bbox=dict(boxstyle="round", facecolor="grey", alpha=0.75))
    fig.tight_layout()
    return fig, ax


def csm_plot(f, csm, range_hz=None, logx: bool = True, with_phase: bool = True):
    """Lower-triangular grid of the CSM's magnitudes in dB, the phase on a
    twin axis. ``csm (F, C, C)``, numpy or a tensor."""
    plt = _plt()
    f, csm = _np(f), _np(csm)
    n_ch = csm.shape[-1]
    fig, axes = plt.subplots(n_ch, n_ch, figsize=(2.5 * n_ch, 2.5 * n_ch), sharex=True)
    axes = np.atleast_2d(axes)
    eps = np.finfo(np.float64).eps
    for i in range(n_ch):
        for j in range(n_ch):
            ax = axes[i][j]
            if j > i:
                ax.axis("off")
                continue
            ax.plot(f, 20 * np.log10(np.abs(csm[:, i, j]) + eps))
            if with_phase and i != j:
                ax.twinx().plot(f, np.angle(csm[:, i, j]), linestyle="dashed", alpha=0.5,
                                color="C3")
            if logx:
                ax.set_xscale("log")
            if range_hz is not None:
                ax.set_xlim(range_hz)
    fig.tight_layout()
    return fig, axes

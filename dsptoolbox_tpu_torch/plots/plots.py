"""Generic matplotlib plot templates, a host-side presentation layer
(`dsptoolbox_tpu/plots/plots.py`).

The API mirrors `dsptoolbox/plots/plots.py:31,121,267,361`
(`general_plot`, `general_plot_two_axes`, `general_subplots_line`,
`general_matrix_plot`) and `show`. Tensors, on any device, are copied to
host numpy at the boundary (`_np`); matplotlib is imported at the first
plot, never when the module is imported.
"""

from __future__ import annotations

import numpy as np

FREQUENCY_TICKS = np.array(
    [2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000, 20000]
)


_THEME_SET = False


def _plt():
    import sys

    import matplotlib

    # only pick a backend when none has been loaded yet AND no display is
    # available — never clobber an interactive/notebook backend the user
    # already has (the reference does not touch the backend at all)
    if "matplotlib.pyplot" not in sys.modules:
        import os

        if not os.environ.get("DISPLAY") and not os.environ.get(
            "MPLBACKEND"
        ):
            matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    global _THEME_SET
    if _THEME_SET:
        return plt
    try:
        import seaborn as sns

        sns.set_theme(
            context="notebook",
            style="whitegrid",
            palette="deep",
            font="sans-serif",
        )
    except ImportError:
        pass
    _THEME_SET = True
    return plt


def show():
    """Wrapper around ``matplotlib.pyplot.show``."""
    _plt().show()


def _np(x):
    """Host numpy of ``x``: a tensor on any device, or anything numpy
    takes."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_2d(matrix: np.ndarray) -> np.ndarray:
    matrix = _np(matrix)
    if matrix.ndim == 1:
        return matrix[:, None]
    if matrix.ndim != 2:
        raise ValueError("Only 1D and 2D-arrays are supported")
    return matrix


def _style_log_x(ax, range_x):
    ax.set_xscale("log")
    from matplotlib.ticker import ScalarFormatter

    ticks = FREQUENCY_TICKS
    if range_x is not None:
        ticks = ticks[(ticks > range_x[0]) & (ticks < range_x[-1])]
    ax.set_xticks(ticks)
    ax.get_xaxis().set_major_formatter(ScalarFormatter())


def _add_info_box(ax, info_box: str):
    ax.text(
        0.1,
        0.5,
        info_box,
        transform=ax.transAxes,
        verticalalignment="top",
        bbox=dict(boxstyle="round", facecolor="grey", alpha=0.75),
    )


def general_plot(
    x,
    matrix,
    range_x=None,
    range_y=None,
    log_x: bool = True,
    labels=None,
    xlabel: str | None = "Frequency / Hz",
    ylabel: str | None = None,
    info_box: str | None = None,
    tight_layout: bool = True,
):
    """Single-axes line plot of ``matrix (n, channels)`` against ``x``."""
    plt = _plt()
    matrix = _as_2d(matrix)
    if x is None:
        x = np.arange(matrix.shape[0])
    fig, ax = plt.subplots(1, 1, figsize=(8, 5))
    if labels is not None and not isinstance(labels, (list, tuple)):
        labels = [labels]
    lines = ax.plot(_np(x), matrix)
    if labels is not None:
        for line, lab in zip(lines, labels):
            line.set_label(lab)
        ax.legend()
    if log_x:
        _style_log_x(ax, range_x)
    ax.xaxis.grid(True, which="minor")
    if range_x is not None:
        ax.set_xlim(range_x)
    if range_y is not None:
        ax.set_ylim(range_y)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    if info_box is not None:
        _add_info_box(ax, info_box)
    if tight_layout:
        fig.tight_layout()
    return fig, ax


def general_plot_two_axes(
    x1,
    matrix1,
    x2,
    matrix2,
    range_x=None,
    range_y1=None,
    range_y2=None,
    log_x: bool = True,
    labels1=None,
    labels2=None,
    xlabel: str | None = "Frequency / Hz",
    y1label: str | None = None,
    y2label: str | None = None,
    y1_linestyle: str | None = None,
    y2_linestyle: str | None = None,
    y1_alpha: float = 1.0,
    y2_alpha: float = 1.0,
    info_box: str | None = None,
    tight_layout: bool = True,
):
    """Two shared-x axes line plot (e.g. magnitude + phase)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(8, 5))
    ax2 = ax.twinx()
    for axis, x, matrix, labels, ls, alpha in (
        (ax, x1, matrix1, labels1, y1_linestyle, y1_alpha),
        (ax2, x2, matrix2, labels2, y2_linestyle, y2_alpha),
    ):
        matrix = _as_2d(matrix)
        if x is None:
            x = np.arange(matrix.shape[0])
        if labels is not None and not isinstance(labels, (list, tuple)):
            labels = [labels]
        lines = axis.plot(_np(x), matrix, linestyle=ls, alpha=alpha)
        if labels is not None:
            for line, lab in zip(lines, labels):
                line.set_label(lab)
            axis.legend()
    if log_x:
        _style_log_x(ax, range_x)
    ax.xaxis.grid(True, which="minor")
    if range_x is not None:
        ax.set_xlim(range_x)
    if range_y1 is not None:
        ax.set_ylim(range_y1)
    if range_y2 is not None:
        ax2.set_ylim(range_y2)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if y1label is not None:
        ax.set_ylabel(y1label)
    if y2label is not None:
        ax2.set_ylabel(y2label)
    if info_box is not None:
        _add_info_box(ax, info_box)
    if tight_layout:
        fig.tight_layout()
    return fig, [ax, ax2]


def general_subplots_line(
    x,
    matrix,
    column: bool = True,
    sharex: bool = True,
    sharey: bool = False,
    log_x: bool = False,
    xlabels=None,
    ylabels=None,
    range_x=None,
    range_y=None,
):
    """Per-channel line subplots in one column (or row)."""
    plt = _plt()
    matrix = _as_2d(matrix)
    n_ch = matrix.shape[1]
    if column:
        fig, ax = plt.subplots(
            n_ch, 1, sharex=sharex, sharey=sharey, figsize=(8, 2 * n_ch)
        )
    else:
        fig, ax = plt.subplots(
            1, n_ch, sharex=sharex, sharey=sharey, figsize=(2 * n_ch, 8)
        )
    if n_ch == 1:
        ax = [ax]
    if x is None:
        x = np.arange(matrix.shape[0])
    for n in range(n_ch):
        ax[n].plot(_np(x), matrix[:, n])
        if log_x:
            _style_log_x(ax[n], range_x)
        if ylabels is not None:
            ax[n].set_ylabel(ylabels[n])
        if xlabels is not None and not isinstance(xlabels, str) and len(xlabels) > 1:
            ax[n].set_xlabel(xlabels[n])
        if range_x is not None:
            ax[n].set_xlim(range_x)
        if range_y is not None:
            ax[n].set_ylim(range_y)
    if isinstance(xlabels, str) or (xlabels is not None and len(xlabels) == 1):
        ax[-1].set_xlabel(xlabels)
    fig.tight_layout()
    return fig, ax


def general_matrix_plot(
    matrix,
    range_x=None,
    range_y=None,
    range_z: float | None = None,
    xlabel: str | None = None,
    ylabel: str | None = None,
    zlabel: str | None = None,
    xlog: bool = False,
    ylog: bool = False,
    colorbar: bool = True,
    cmap: str = "magma",
    lower_origin: bool = True,
):
    """Heatmap of a 2D matrix (spectrogram / CSM / beamformer maps)."""
    plt = _plt()
    matrix = _np(matrix)
    assert matrix.ndim == 2, "Only 2D-arrays are supported for this plot type"
    extent = None
    if range_x is not None:
        assert range_y is not None, (
            "When x range is given, y range is also necessary"
        )
        extent = (range_x[0], range_x[1], range_y[0], range_y[1])
    fig, ax = plt.subplots(1, 1, figsize=(7, 5))
    max_val = np.max(matrix)
    min_val = max_val - range_z if range_z is not None else np.min(matrix)
    col = ax.imshow(
        matrix,
        extent=extent,
        alpha=0.95,
        cmap=cmap,
        vmin=min_val,
        vmax=max_val,
        origin="lower" if lower_origin else "upper",
        aspect="auto",
    )
    if colorbar:
        fig.colorbar(col, ax=ax, label=zlabel)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    if xlog:
        ax.set_xscale("log")
    if ylog:
        ax.set_yscale("log")
        from matplotlib.ticker import ScalarFormatter

        ticks = FREQUENCY_TICKS
        if range_y is not None:
            ticks = ticks[(ticks > range_y[0]) & (ticks < range_y[-1])]
        ax.set_yticks(ticks)
        ax.get_yaxis().set_major_formatter(ScalarFormatter())
    fig.tight_layout()
    return fig, ax

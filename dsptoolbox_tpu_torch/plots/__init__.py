"""Presentation layer: matplotlib templates (`dsptoolbox_tpu/plots`)."""

from .plots import (
    general_matrix_plot,
    general_plot,
    general_plot_two_axes,
    general_subplots_line,
    show,
)

__all__ = [
    "general_plot",
    "general_plot_two_axes",
    "general_subplots_line",
    "general_matrix_plot",
    "show",
]

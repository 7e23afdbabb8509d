"""Container classes (`dsptoolbox_tpu/classes`); so far the thin `Signal`."""

from .signal import Signal

__all__ = ["Signal"]

"""Pad/trim operations on Signals (`dsptoolbox_tpu/standard/pad_trim_methods.py`),
on the signal's device. Not ported yet: ``modify_signal_length``."""

from __future__ import annotations

from ..classes import MultiBandSignal, Signal
from ..ops.pad_trim import pad_trim_axis


def pad_trim(signal, desired_length_samples: int, in_the_end: bool = True):
    """Zero-pad or trim to an exact length (`pad_trim_methods.py:13`); a
    MultiBandSignal band by band."""
    if isinstance(signal, Signal):
        new_td = pad_trim_axis(signal._x, desired_length_samples, axis=-1,
                               in_the_end=in_the_end)
        return signal.copy_with_new_time_data(new_td.T)
    if isinstance(signal, MultiBandSignal):
        assert signal.same_sampling_rate, (
            "Padding or trimming is not supported for multirate signals"
        )
        return MultiBandSignal(
            [pad_trim(b, desired_length_samples, in_the_end) for b in signal.bands],
            same_sampling_rate=True, info=dict(signal.info),
        )
    raise TypeError("Signal must be of type Signal or MultiBandSignal")

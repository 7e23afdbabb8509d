"""Pad/trim operations on Signals (`dsptoolbox_tpu/standard/pad_trim_methods.py`;
reference `dsptoolbox/standard/pad_trim_methods.py`), on the signal's
device."""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from ..classes import MultiBandSignal, Signal
from ..helpers.gain_and_level import from_db
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


def modify_signal_length(signal, start_seconds: float | None, end_seconds: float | None):
    """Add silence at, or remove samples from, the start and the end
    (`pad_trim_methods.py:42`): positive times pad, negative ones trim."""
    if isinstance(signal, Signal):
        assert start_seconds is not None or end_seconds is not None, (
            "At least the start or the end should be modified"
        )
        fs = signal.sampling_rate_hz
        start_samples = (
            0 if start_seconds is None
            else int(start_seconds * fs + 0.5 * np.sign(start_seconds))
        )
        end_samples = (
            0 if end_seconds is None
            else int(end_seconds * fs + 0.5 * np.sign(end_seconds))
        )
        if start_samples < 0:
            assert len(signal) > -start_samples, "Trimming is too much"
        if end_samples < 0:
            assert len(signal) > -end_samples, "Trimming is too much"
        if start_samples < 0 and end_samples < 0:
            assert len(signal) > -(start_samples + end_samples), "Trimming is too much"
        x = signal._x
        x = F.pad(x, (start_samples, 0)) if start_samples >= 0 else x[:, -start_samples:]
        x = F.pad(x, (0, end_samples)) if end_samples >= 0 else x[:, :end_samples]
        new_sig = signal.copy()
        new_sig.time_data = x.T
        return new_sig
    if isinstance(signal, MultiBandSignal):
        new_mb = signal.copy()
        new_mb.bands = [modify_signal_length(b, start_seconds, end_seconds) for b in signal]
        return new_mb
    raise TypeError("Unsupported type")


def trim_with_level_threshold(
    signal: Signal, threshold_db: float, at_start: bool = True, at_end: bool = True
):
    """Trim the edges that lie below a level threshold
    (`pad_trim_methods.py:94`): ``(trimmed signal, start, stop)``.

    parity: the reference takes the start from the first ``C`` and the stop
    from the last ``C`` of the row-major (sample, channel) hits, not each
    channel's own."""
    assert at_start or at_end, "Either start or end should be trimmed"
    threshold_linear = float(from_db(threshold_db, True))
    # row-major hits of |x| >= threshold in (T, C), as np.where gives them
    hits = (signal.time_data.abs() >= threshold_linear).nonzero()[:, 0].cpu().numpy()
    C = signal.number_of_channels
    start = int(np.min(hits[:C])) if at_start else 0
    stop = (min(signal.length_samples, int(np.max(hits[-C:])) + 1) if at_end
            else signal.length_samples)
    return signal.copy_with_new_time_data(signal.time_data[start:stop]), start, stop


def trim_with_time_selection(
    signal, start_time_s: float | None, end_time_s: float | None, inclusive: bool = True
):
    """Trim to a time window (`pad_trim_methods.py:123`)."""
    if isinstance(signal, Signal):
        assert start_time_s is not None or end_time_s is not None, (
            "At least one bound must be other than None"
        )
        if start_time_s:
            assert start_time_s >= 0.0, "Start time must be at least zero"
            assert start_time_s < signal.length_seconds, (
                "Start time must be less than signal's length"
            )
            start_sample = int(start_time_s * signal.sampling_rate_hz)
            if not inclusive:
                start_sample += 1
        else:
            start_sample = 0
        if end_time_s:
            assert end_time_s > 0.0, "End time must be greater than 0"
            assert end_time_s <= signal.length_seconds, (
                "End time must be less than signal length"
            )
            end_sample = int(end_time_s * signal.sampling_rate_hz)
            if inclusive:
                end_sample += 1
        else:
            end_sample = signal.length_samples
        assert end_sample > start_sample, "Invalid time window"
        return signal.copy_with_new_time_data(signal.time_data[start_sample:end_sample, ...])
    if isinstance(signal, MultiBandSignal):
        output = signal.copy()
        output.bands = [
            trim_with_time_selection(b, start_time_s, end_time_s, inclusive)
            for b in signal.bands
        ]
        return output
    raise TypeError("No valid type was passed")

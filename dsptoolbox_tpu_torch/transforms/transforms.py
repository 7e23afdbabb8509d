"""Inverse STFT (`dsptoolbox_tpu/transforms/transforms.py:292`).

The spectrogram ``(F, frames, C)`` is read channels-first: a
`Signal.get_spectrogram` result is a permuted view of the STFT's
``(C, frames, F)`` tensor, so the inverse FFT reads it in place. The frames
are overlap-added with the window² normalisation of
`ops.framing.reconstruct_framed_signal` on the spectrogram's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..classes.signal import Signal
from ..ops.framing import reconstruct_framed_signal
from ..ops.pad_trim import pad_trim_axis
from ..ops.windows import get_window


def istft(
    stft,
    original_signal: Signal | None = None,
    parameters: dict | None = None,
    sampling_rate_hz: int | None = None,
    window_length_samples: int | None = None,
    window_type=None,
    overlap_percent: int | None = None,
    fft_length_samples: int | None = None,
    padding: bool | None = None,
    scaling=None,
) -> Signal:
    """Inverse STFT with window² overlap-add (Griffin-Lim least squares;
    reference `transforms.py:444-588`). ``stft (F, frames, C)`` complex, a
    tensor (or numpy, which goes to the default device). The parameters
    come from ``original_signal`` (whose length the output is cut or padded
    to), from a ``parameters`` dict, or one by one.

    parity: the hop is ``int((1 - overlap/100)·L)`` while the STFT rounds
    its overlap; with padding the output drops ``int(overlap/100·L)``
    samples at both ends, without it a zero frame is added at both ends
    and ``hop`` samples dropped; physical-unit scalings are divided out.
    """
    assert stft.ndim == 3, (
        f"{stft.ndim} is not a valid number of dimensions. It must be 3"
    )
    if original_signal is not None:
        assert parameters is None, (
            "A signal was passed. No parameters dictionary should be passed"
        )
        parameters = dict(original_signal._spectrogram_parameters)
        sampling_rate_hz = original_signal.sampling_rate_hz
    elif parameters is None:
        assert (
            (window_length_samples is not None)
            and (window_type is not None)
            and (overlap_percent is not None)
            and (padding is not None)
            and (scaling is not None)
        ), "At least one of the needed parameters needed was passed as None"
        parameters = {
            "window_length_samples": window_length_samples,
            "window_type": window_type,
            "overlap_percent": overlap_percent,
            "fft_length_samples": fft_length_samples,
            "padding": padding,
            "scaling": scaling,
        }
    window = get_window(
        parameters["window_type"], parameters["window_length_samples"], symmetric=False
    )
    scaling = parameters["scaling"]
    if not torch.is_tensor(stft):
        from .._config import default_complex, default_device

        stft = torch.as_tensor(np.asarray(stft)).to(default_device(), default_complex())

    # (F, K, C) -> (C, K, F): a view; contiguous for a `get_spectrogram` result
    frames = torch.fft.irfft(
        stft.permute(2, 1, 0), n=parameters["fft_length_samples"], dim=-1,
        norm=scaling.fft_norm(),
    )[..., : parameters["window_length_samples"]]
    if scaling.has_physical_units():
        frames = frames / scaling.get_scaling_factor(
            parameters["fft_length_samples"] or parameters["window_length_samples"],
            sampling_rate_hz,
            window,
        )
    step = int((1 - parameters["overlap_percent"] / 100) * len(window))
    if parameters["padding"]:
        td = reconstruct_framed_signal(frames, step, window)
        overlap = int(parameters["overlap_percent"] / 100 * len(window))
        td = td[..., overlap:-overlap]
    else:
        extra = frames.new_zeros(frames[:, :1, :].shape)
        td = reconstruct_framed_signal(torch.cat([extra, frames, extra], dim=1), step, window)
        td = td[..., step:-step]
    if original_signal is not None:
        td = pad_trim_axis(td, original_signal.length_samples, axis=-1)
        return original_signal.copy_with_new_time_data(td.T)
    return Signal(None, td.T, sampling_rate_hz)

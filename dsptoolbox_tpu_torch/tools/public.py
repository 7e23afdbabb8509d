"""The public tools of the JAX package's `dsptoolbox_tpu/tools.py`:
framing in the reference layout, frequency vectors and crossovers, the log
mean and sample-format conversion.

`framed_signal` and `reconstruct_from_framed_signal` take numpy arrays or
tensors and return the same kind (a tensor stays on its device); the rest
is host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..helpers.bytes_conversion import array_to_bytes_24bits, bytes_to_array_24bits
from ..ops.framing import frame_signal, reconstruct_framed_signal


def framed_signal(
    time_data,
    window_length_samples: int,
    step_size: int,
    keep_last_frames: bool = True,
):
    """Overlapping frames of ``time_data (T, C)`` (or ``(T,)``) in the
    reference layout ``(window_length, n_frames, channels)``
    (`helpers/_framed_signal_representation.py:6-68`): a strided view of
    the channels-first frames for a tensor, numpy for numpy input."""
    is_tensor = torch.is_tensor(time_data)
    td = time_data if is_tensor else torch.as_tensor(np.asarray(time_data))
    if td.ndim == 1:
        td = td[:, None]
    frames = frame_signal(td.T, window_length_samples, step_size, keep_last_frames)  # (C, K, L)
    out = frames.permute(2, 1, 0)
    return out if is_tensor else out.numpy().copy()


def reconstruct_from_framed_signal(
    td_framed,
    step_size: int,
    window=None,
    original_signal_length: int | None = None,
    safety_threshold: float = 1e-4,
):
    """Overlap-add reconstruction of reference-layout frames
    ``(window_length, n_frames, channels)`` → ``(T, C)``
    (`helpers/_framed_signal_representation.py:70-132`)."""
    is_tensor = torch.is_tensor(td_framed)
    frames = td_framed if is_tensor else torch.as_tensor(np.asarray(td_framed))
    out = reconstruct_framed_signal(
        frames.permute(2, 1, 0), step_size, window, original_signal_length, safety_threshold,
    ).T
    return out if is_tensor else out.numpy()


def log_frequency_vector(frequency_range_hz, n_bins_per_octave: int) -> np.ndarray:
    """Logarithmically spaced frequency vector (`tools.py:42-66`)."""
    assert frequency_range_hz[0] > 0, "The first frequency bin should not be 0"
    n_octave = np.log2(frequency_range_hz[1] / frequency_range_hz[0])
    return frequency_range_hz[0] * 2 ** (np.arange(0, n_octave, 1 / n_bins_per_octave))


def get_exact_value_at_frequency(freqs_hz: np.ndarray, y: np.ndarray, f: float = 1e3):
    """Linear interpolation at a single frequency (`tools.py:68-104`)."""
    assert freqs_hz[0] <= f and freqs_hz[-1] >= f, (
        "Frequency vector does not contain 1 kHz"
    )
    assert freqs_hz.ndim == 1, "Frequency vector can only have one dimension"
    assert len(freqs_hz) == len(y), "Lengths do not match"
    if freqs_hz[-1] == f:
        return y[-1]
    ind = int(np.searchsorted(freqs_hz, f))
    if freqs_hz[ind] > f:
        ind -= 1
    return (f - freqs_hz[ind]) * (y[ind + 1] - y[ind]) / (
        freqs_hz[ind + 1] - freqs_hz[ind]
    ) + y[ind]


def log_mean(x: np.ndarray, axis: int = 0):
    """Mean over a log-resampled axis (`tools.py:106-131`)."""
    from scipy.interpolate import interp1d

    x = np.asarray(x)
    N = x.shape[axis]
    l1 = np.arange(N)
    k_log = N ** (l1 / (N - 1))
    vec_log = interp1d(
        l1 + 1, x, kind="linear", copy=False, assume_sorted=True, axis=axis
    )(k_log)
    return np.mean(vec_log, axis=axis)


def frequency_crossover(crossover_region_hz, logarithmic: bool = True):
    """A callable sigmoid-like crossover weighting function
    (`tools.py:134-184`)."""
    from scipy.interpolate import interp1d

    f = (
        log_frequency_vector(crossover_region_hz, 250)
        if logarithmic
        else np.linspace(
            crossover_region_hz[0],
            crossover_region_hz[1],
            int(crossover_region_hz[1] - crossover_region_hz[0]),
        )
    )
    length = len(f)
    w = np.hanning(length * 2)[:length]
    i = interp1d(
        f,
        w,
        kind="cubic",
        copy=False,
        bounds_error=False,
        fill_value=(0.0, 1.0),
        assume_sorted=True,
    )

    def func(x):
        return i(x)

    return func


def convert_sample_representation(
    values,
    input_format: str,
    output_format: str,
    cast_output: bool = True,
    output_in_bytes: bool = False,
):
    """PCM sample format conversion incl. 24-bit packing
    (`tools.py:339-503`). Returns ``(output, equilibrium, span)``."""
    if input_format == output_format:
        raise AssertionError("No conversion is necessary")
    valid = ["f32", "f64", "i8", "i16", "i24", "i32", "u8", "u16", "u24", "u32"]
    input_format = input_format.lower()
    output_format = output_format.lower()
    assert output_format in valid and input_format in valid, (
        f"Format {input_format} or {output_format} is not supported"
    )
    if isinstance(values, bytes):
        signed_input = input_format[0] == "i"
        if input_format in ("i24", "u24"):
            values = bytes_to_array_24bits(values, signed_input)
        elif input_format in ("f32", "f64"):
            values = np.frombuffer(
                values, dtype=np.float32 if input_format == "f32" else np.float64
            )
        else:
            bits = int(input_format[1:])
            dtype = np.dtype(f"{'int' if signed_input else 'uint'}{bits}")
            values = np.frombuffer(values, dtype=dtype)
    values = np.asarray(values)

    if input_format not in ("f32", "f64"):
        signed_input = input_format[0] == "i"
        bits_input = int(input_format[1:])
        max_value_input = 2.0 ** (bits_input - 1) - 1
        values = values.astype(np.float64) / max_value_input
        if not signed_input:
            values = values - 1.0
    values = np.clip(values, -1.0, 1.0)

    # reference semantics (`tools.py:439-503`): float outputs ignore
    # `output_in_bytes`; fixed-point casting truncates toward zero; casting
    # to 24 bits requires bytes output and widens to 32 bits before packing
    if output_format == "f32":
        return values.astype(np.float32), 0.0, 1.0
    if output_format == "f64":
        return values.astype(np.float64), 0.0, 1.0

    signed_output = output_format[0] == "i"
    bits_output = int(output_format[1:])
    max_value_output = 2.0 ** (bits_output - 1) - 1
    output = values * max_value_output
    equilibrium = 0.0
    if not signed_output:
        output = output + max_value_output
        equilibrium += max_value_output
    if cast_output:
        if output_format in ("i24", "u24"):
            assert output_in_bytes, (
                "This format is only valid for casting when "
                "the output is in bytes"
            )
            bits_output = 32
        dtype = np.dtype(f"{'int' if signed_output else 'uint'}{bits_output}")
        output = output.astype(dtype)
    else:
        output = np.trunc(output)

    if not output_in_bytes:
        return output, equilibrium, max_value_output
    if output_format in ("i24", "u24") and cast_output:
        return array_to_bytes_24bits(output), equilibrium, max_value_output
    return output.tobytes(), equilibrium, max_value_output

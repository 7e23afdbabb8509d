"""Transfer-function measurement (public API,
`dsptoolbox_tpu/transfer_functions/transfer_functions.py`): the path of a
sweep measurement, from the recording to a smoothed transfer function.

- `spectral_deconvolve`: recording / excitation by regularized spectral
  division → `ImpulseResponse`;
- `window_ir`: peak-aligned adaptive Tukey-like windowing;
- `complex_smoothing`: fractional-octave smoothing in one of six domains
  → `Spectrum` (through the banded CUDA kernel on a float32 CUDA
  tensor, at every grid size).

Behavioral reference: `dsptoolbox/transfer_functions/transfer_functions.py`.
The data stays on its device; the host sees the regularization range (two
ints fetched from the device) and, by default, `window_ir`'s start
positions. Not ported yet: the traced deconvolution of ``dsp.pipeline``
and the rest of the module.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..classes import ImpulseResponse, Signal, Spectrum
from ..helpers.other import unwrap
from ..ops.pad_trim import pad_trim_axis
from .._enums import Window
from . import _backend as bk
from .enums import SmoothingDomain


def spectral_deconvolve(
    output: Signal,
    input: Signal,
    apply_regularization: bool = True,
    start_stop_hz=None,
    threshold_db: float = -30.0,
    padding: bool = False,
    keep_original_length: bool = False,
) -> ImpulseResponse:
    """Deconvolution by (regularized) spectral division
    (`transfer_functions.py:61-184`): the FFT spectra of both signals at
    their configured length (``next_fast_len`` padding by default), divided
    on their device, back through ``irfft``. A mono ``input`` is used for
    every channel of ``output``. The callers' signals are not changed."""
    assert output.length_samples == input.length_samples, (
        "Lengths do not match for spectral deconvolution"
    )
    multichannel = input.number_of_channels == 1
    if not multichannel:
        assert output.number_of_channels == input.number_of_channels, (
            "The number of channels do not match."
        )
    assert output.sampling_rate_hz == input.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    if not apply_regularization:
        assert start_stop_hz is None, (
            "No start_stop_hz vector can be passed when using standard mode"
        )

    original_length = output.length_samples
    length = original_length * 2 if padding else original_length
    if padding:
        output = output.copy_with_new_time_data(
            pad_trim_axis(output.time_data, length, axis=0)
        )
        input = input.copy_with_new_time_data(
            pad_trim_axis(input.time_data, length, axis=0)
        )
    # parity: the FFT method at the signals' configured length, whatever
    # their spectrum method (`transfer_functions.py:143-145`)
    _, den = input._spectrum_fft()  # (C, F)
    freqs_hz, num = output._spectrum_fft()
    fs_hz = output.sampling_rate_hz

    eps = None
    if apply_regularization:
        ssz = start_stop_hz
        if ssz is None:
            # parity: the reference reassigns start_stop_hz inside its
            # channel loop (`transfer_functions.py:151-168`), so the range
            # comes from channel 0 and serves every channel
            ssz = regularization_range(den[0], freqs_hz, threshold_db)
        if len(ssz) == 2:
            ssz = np.array([
                ssz[0] / np.sqrt(2),
                ssz[0],
                ssz[1],
                np.min([ssz[1] * np.sqrt(2), fs_hz / 2]),
            ])
        elif len(ssz) != 4:
            raise ValueError("start_stop_hz vector should have 2 or 4 values")
        eps = bk.regularization_window_device(
            tuple(float(v) for v in ssz),
            len(freqs_hz),
            float(freqs_hz[0]),
            float(freqs_hz[1] - freqs_hz[0]),
            num.real.dtype,
            num.device,
        )  # (F, 1), broadcast over channels

    if multichannel:
        den = den[:1].expand_as(num)
    ir = bk.spectral_deconvolve_core(num.T, den.T, length, eps)  # (length, C)
    new_sig = ImpulseResponse(None, ir, fs_hz, constrain_amplitude=False)
    if padding and keep_original_length:
        new_sig.time_data = pad_trim_axis(
            new_sig.time_data, original_length, axis=0
        )
    return new_sig


def regularization_range(
    spectrum: torch.Tensor, freqs_hz: np.ndarray, threshold_db: float
) -> list:
    """``[first, last]`` frequency whose magnitude in ``spectrum (F,)`` lies
    above ``threshold_db`` relative to its peak: the automatic range of
    `spectral_deconvolve`, a reduction on the spectrum's device that brings
    two ints to the host."""
    mag = spectrum.abs()
    db = 20.0 * torch.log10(mag.clamp(min=torch.finfo(mag.dtype).tiny))
    mask = ((db - db.max()) > threshold_db).to(torch.uint8)
    first = torch.argmax(mask)
    last = mask.shape[0] - 1 - torch.argmax(mask.flip(0))
    i0, i1 = torch.stack([first, last]).tolist()
    return [freqs_hz[i0], freqs_hz[i1]]


def window_ir(
    signal: ImpulseResponse,
    total_length_samples: int,
    adaptive: bool = True,
    constant_percentage: float = 0.75,
    window_type: Window | list = Window.Hann,
    at_start: bool = True,
    offset_samples: int = 0,
    left_to_right_flank_length_ratio: float = 1.0,
    return_device: bool = False,
):
    """Adaptive peak-aligned Tukey-like windowing
    (`transfer_functions.py:187-293`). Returns ``(windowed IR, start
    positions)``; the IR carries its window (`ImpulseResponse.window`).

    Hann flanks run on the device with no host sync
    (`_backend.window_ir_fused`); the start positions come back as
    numpy unless ``return_device=True`` leaves them on the device. Other
    windows fetch the channels' peak positions, build each channel's
    window with the host index arithmetic (`window_this_ir_tukey_meta`)
    and gather on the device; their start positions are numpy."""
    assert isinstance(signal, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    assert 0 <= constant_percentage < 1, (
        "Constant percentage can not be larger than 1 or smaller than 0"
    )
    assert offset_samples >= 0, "Offset must be positive"
    assert offset_samples <= constant_percentage * total_length_samples, (
        "Offset is too large for the constant part of the window and its "
        "total length"
    )
    assert left_to_right_flank_length_ratio >= 0, (
        "Ratio between window flanks must be a positive number"
    )
    x = signal._x  # (C, T)
    if window_type is Window.Hann:
        out, window, starts = bk.window_ir_fused(
            x,
            total_length_samples,
            adaptive,
            constant_percentage,
            at_start,
            offset_samples,
            left_to_right_flank_length_ratio,
        )
        new_sig = signal.copy_with_new_time_data(out.T)
        new_sig.set_window(window.T)
        return new_sig, (starts if return_device else starts.cpu().numpy())

    C, T = x.shape
    start_positions = np.zeros(C, dtype=int)
    window = np.zeros((total_length_samples, C))
    slice_starts = np.zeros(C, dtype=np.int64)
    peaks = torch.argmax(x.abs(), dim=1).tolist()
    for n in range(C):
        slice_starts[n], window[:, n], start_positions[n] = (
            bk.window_this_ir_tukey_meta(
                T,
                peaks[n],
                total_length_samples,
                window_type,
                constant_percentage,
                at_start,
                offset_samples,
                left_to_right_flank_length_ratio,
                adaptive,
            )
        )
    out = bk.gather_windowed(
        x,
        torch.as_tensor(slice_starts, device=x.device),
        torch.as_tensor(window.T, dtype=x.dtype, device=x.device),
    )
    new_sig = signal.copy_with_new_time_data(out.T)
    new_sig.set_window(window)
    return new_sig, start_positions


@lru_cache(maxsize=8)
def _smoothing_window(window: Window, extra_parameter: str) -> tuple:
    """``window(3000, True)`` as a tuple, cached on the window and its
    extra parameter."""
    return tuple(window(3000, True).tolist())


def complex_smoothing(
    ir: ImpulseResponse,
    octave_fraction: float,
    smoothing_domain: SmoothingDomain,
    window: Window = Window.Hann,
) -> Spectrum:
    """Fractional-octave complex smoothing of the IR's spectrum in the
    selected domain (`transfer_functions.py:1788-1876`), on its device. The
    operator is `_backend.complex_smoothing_banded` at every grid size (the
    banded kernel on a float32 CUDA tensor); the JAX package's dense
    operator up to 4096 bins is not ported.

    The phase domains unwrap the phase along frequency with `unwrap`
    (numpy's semantics, cumulative sum in the default float, as
    ``jnp.unwrap``) and smooth it: where the unwrapped phase is large
    (a late IR peak, many bins), float32 rounding of it is too."""
    assert octave_fraction > 0.0, "Octave fraction must be greater than 0"
    f, sp = ir.get_spectrum()
    window_values = _smoothing_window(window, repr(window.extra_parameter))

    def smooth(x):
        return bk.complex_smoothing_banded(x, f, octave_fraction, window_values)

    if smoothing_domain == SmoothingDomain.RealImaginary:
        out = smooth(sp)
    elif smoothing_domain == SmoothingDomain.MagnitudePhase:
        s = smooth(torch.complex(sp.abs(), unwrap(sp.angle(), dim=0)))
        out = torch.polar(s.real, s.imag)
    elif smoothing_domain == SmoothingDomain.PowerPhase:
        s = smooth(torch.complex(sp.abs() ** 2.0, unwrap(sp.angle(), dim=0)))
        out = torch.polar(s.real**0.5, s.imag)
    elif smoothing_domain == SmoothingDomain.Power:
        out = torch.polar(smooth(sp.abs() ** 2.0) ** 0.5, sp.angle())
    elif smoothing_domain == SmoothingDomain.Magnitude:
        out = torch.polar(smooth(sp.abs()), sp.angle())
    elif smoothing_domain == SmoothingDomain.EquivalentComplex:
        s1 = smooth(sp)
        s2 = smooth(sp.abs() ** 2.0)
        out = torch.polar(s2**0.5, s1.angle())
    else:
        raise ValueError("Invalid smoothing domain")
    return Spectrum(f, out)

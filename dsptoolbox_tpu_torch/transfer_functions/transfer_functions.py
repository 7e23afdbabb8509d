"""Transfer-function measurement and IR manipulation (public API,
`dsptoolbox_tpu/transfer_functions/transfer_functions.py`).

- the sweep measurement: `spectral_deconvolve` → `window_ir` →
  `complex_smoothing` (through the banded CUDA kernel on a float32 CUDA
  tensor, at every grid size);
- the dual-channel estimators `compute_transfer_function` (H1, H2, H3 with
  the coherence): one framing of each signal (the framing kernel, two
  launches a call) and the four Welch estimates from those frames;
- the IR tools: peak-centered and Tukey windowing, trimming, averaging,
  latency, minimum and linear phase, group delay, excess group delay,
  frequency-dependent windowing (`_backend.fdw_core`), the crossover merge
  with a dirac, IR ↔ FIR filter, and Farina's harmonic analysis.

Behavioral reference: `dsptoolbox/transfer_functions/transfer_functions.py`.
The data stays on its device. The host sees what the JAX package's host
sees: the regularization range (two ints fetched from the device; in a
`pipeline` it is computed in-program,
`_backend.regularization_window_traced`), peak positions and latencies
(numpy), the IRs that `trim_ir` and the harmonic analysis trim with host
float64 decision logic (`_backend.trim_ir_indices`), the analytic group
delay's polynomial ratio, the linear phase's group delays and the harmonic
power spectra that ``np.interp`` sums. Spectra and time data come back as
tensors or the package's classes; indices and latencies as numpy.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._config import in_pipeline
from ..classes import Filter, FilterBank, ImpulseResponse, Signal, Spectrum
from ..classes.filter_helpers import group_delay_filter, impulse
from ..helpers.gain_and_level import from_db, to_db
from ..helpers.latency import fractional_latency, get_fractional_impulse_peak_index
from ..helpers.latency import remove_ir_latency_from_phase
from ..helpers.minimum_phase import (
    min_phase_ir_from_real_cepstrum,
    minimum_phase_spectrum_from_real_cepstrum,
)
from ..helpers.other import unwrap
from ..helpers.smoothing import fractional_octave_smoothing
from ..helpers.spectrum_utilities import correct_for_real_phase_spectrum, interpolate_fr
from ..ops.fft_conv import next_fast_len
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import welch_average, welch_plan, welch_spectra
from ..standard.backend import group_delay_direct, minimum_phase_from_magnitude
from .._enums import MagnitudeNormalization, SpectrumType, Window
from . import _backend as bk
from .enums import SmoothingDomain, TransferFunctionType


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
    if apply_regularization and start_stop_hz is None and in_pipeline():
        # in a pipeline the range stays on the device: the first and last
        # bins above the threshold and their Hann window are computed
        # in-program (`dsptoolbox_tpu/transfer_functions/
        # transfer_functions.py:147-175`), channel 0 setting the range
        first, last = _bins_above_threshold(den[0], threshold_db)
        eps = bk.regularization_window_traced(
            first, last, len(freqs_hz), float(freqs_hz[0]),
            float(freqs_hz[1] - freqs_hz[0]), fs_hz / 2,
        )
    elif apply_regularization:
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


def _bins_above_threshold(spectrum: torch.Tensor, threshold_db: float) -> tuple:
    """``(first, last)``: the first and last bin of ``spectrum (F,)`` whose
    magnitude lies above ``threshold_db`` relative to its peak, as 0-d
    tensors on the spectrum's device."""
    mag = spectrum.abs()
    db = 20.0 * torch.log10(mag.clamp(min=torch.finfo(mag.dtype).tiny))
    mask = ((db - db.max()) > threshold_db).to(torch.uint8)
    return torch.argmax(mask), mask.shape[0] - 1 - torch.argmax(mask.flip(0))


def regularization_range(
    spectrum: torch.Tensor, freqs_hz: np.ndarray, threshold_db: float
) -> list:
    """``[first, last]`` frequency whose magnitude in ``spectrum (F,)`` lies
    above ``threshold_db`` relative to its peak: the automatic range of
    `spectral_deconvolve`, a reduction on the spectrum's device that brings
    two ints to the host."""
    i0, i1 = torch.stack(_bins_above_threshold(spectrum, threshold_db)).tolist()
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


def window_ir_tukey(
    ir: ImpulseResponse,
    left_flank_s: float | None,
    right_flank_s: float | None,
    window_flank_type: Window = Window.Hann,
) -> ImpulseResponse:
    """A Tukey-like window over all channels that keeps their timing
    (`transfer_functions.py:415`): the flanks from scipy on the host, the
    product on the IR's device. The IR carries the window."""
    from scipy.signal import get_window

    assert isinstance(ir, ImpulseResponse), "This is only valid for an impulse response"
    assert left_flank_s is not None or right_flank_s is not None, (
        "At least one flank length should be passed"
    )
    assert window_flank_type != Window.Tukey, (
        "Tukey window type is not supported here. For computing a standard "
        "Tukey window, pass `Hann` as window type"
    )
    fs = ir.sampling_rate_hz
    left = int(left_flank_s * fs + 0.5) if left_flank_s is not None else 0
    right = int(right_flank_s * fs + 0.5) if right_flank_s is not None else 0
    assert left + right <= ir.length_samples, "Flanks overlap given the current IR length"
    window = np.ones((ir.length_samples, 1))
    if left > 0:
        window[:left, 0] = get_window(window_flank_type.to_scipy_format(), left * 2)[:left]
    if right > 0:
        window[-right:, 0] = get_window(window_flank_type.to_scipy_format(), right * 2)[right:]
    new_ir = ir.copy_with_new_time_data(
        ir.time_data * torch.as_tensor(window, dtype=ir.time_data.dtype, device=ir.device)
    )
    new_ir.set_window(np.repeat(window, ir.number_of_channels, 1))
    return new_ir


def window_centered_ir(
    signal: ImpulseResponse,
    total_length_samples: int,
    window_type: Window = Window.Hann,
):
    """Peak-centered windowing (`transfer_functions.py:462`): ``(windowed
    IR, start positions (numpy))``. The channels' peak positions come to
    the host (C ints); the slice and flip decisions are host index
    arithmetic (`_backend.window_this_ir_centered_meta`); the slices are
    gathered and windowed in one batched device gather. A peak past the
    window's half length flips the channel, so the window keeps the samples
    before the peak."""
    assert isinstance(signal, ImpulseResponse), "This is only valid for an impulse response"
    x = signal._x  # (C, T)
    C, T = x.shape
    L = int(total_length_samples)
    peaks = torch.argmax(x.abs(), dim=1).tolist()
    start_positions = np.zeros(C, dtype=int)
    window = np.zeros((L, C))
    win_pre = np.zeros((C, L))
    flips = np.zeros(C, dtype=bool)
    for n in range(C):
        flips[n], start_positions[n], win_pre[n] = bk.window_this_ir_centered_meta(
            T, peaks[n], L, window_type
        )
        window[:, n] = win_pre[n][::-1] if flips[n] else win_pre[n]
    out = bk.gather_centered(
        x,
        torch.as_tensor(flips, device=x.device),
        torch.as_tensor(start_positions, device=x.device),
        torch.as_tensor(win_pre, dtype=x.dtype, device=x.device),
    )
    new_sig = signal.copy_with_new_time_data(out.T)
    new_sig.set_window(window)
    return new_sig, start_positions


def compute_transfer_function(
    output: Signal,
    input: Signal,
    window_length_samples: int,
    mode: TransferFunctionType = TransferFunctionType.H2,
) -> Spectrum:
    """H1, H2 or H3 estimate of ``output`` over ``input`` with its
    coherence, batched over channels (`transfer_functions.py:525`), with the
    input's spectrum parameters (window, overlap, detrend, average,
    scaling). A mono ``input`` serves every output channel.

    Each signal is framed and transformed once (one framing kernel launch
    each on a float32 CUDA tensor): G_xx, G_yy, G_xy and G_yx are formed
    from those frames through the Welch estimate's averaging and scaling
    (`ops.spectral.welch_average`), the same numbers as four `welch` calls
    (the JAX package's program, whose compiler shares their framing); a
    mono input's G_xx is broadcast over the channels, not copied. The
    Spectrum and its coherence lie on the signals' device."""
    assert input.sampling_rate_hz == output.sampling_rate_hz, "Sampling rates do not match"
    assert input.length_samples == output.length_samples, "Signal lengths do not match"
    if input.number_of_channels != 1:
        assert input.number_of_channels == output.number_of_channels, (
            "Channel number does not match between signals"
        )
    p = input._spectrum_parameters
    fs = input.sampling_rate_hz
    window, step = welch_plan(window_length_samples, p["window_type"], p["overlap_percent"])
    X = welch_spectra(input._x, window, step, p["detrend"], p["scaling"])  # (Cin, K, F)
    Y = welch_spectra(output._x, window, step, p["detrend"], p["scaling"])  # (C, K, F)

    def estimate(frames):
        return welch_average(frames, window, sampling_rate_hz=fs, average=p["average"],
                             scaling=p["scaling"])

    G_xx = estimate(X.abs() ** 2.0)
    G_yy = estimate(Y.abs() ** 2.0)
    G_xy = estimate(torch.conj(X) * Y)
    if mode == TransferFunctionType.H1:
        tf = G_xy / G_xx
    elif mode == TransferFunctionType.H2:
        tf = G_yy / estimate(torch.conj(Y) * X)
    elif mode == TransferFunctionType.H3:
        tf = G_xy / G_xy.abs() * (G_yy / G_xx) ** 0.5
    else:
        raise ValueError("Unsupported transfer function type")
    coherence = G_xy.abs() ** 2 / G_xx / G_yy
    spec = Spectrum(np.fft.rfftfreq(window_length_samples, 1 / fs), tf.T)
    spec.set_coherence(coherence.T)
    return spec


def average_irs(
    signal: ImpulseResponse,
    time_average: bool = True,
    normalize_energy: bool = True,
) -> ImpulseResponse:
    """The channels' average, in time (latency-aligned by fractional
    delays to the latest channel) or as the mean magnitude and mean
    unwrapped phase (`transfer_functions.py:586`), on the IR's device.

    parity: ``normalize_energy`` multiplies each channel by its energy
    relative to channel 0 (a factor, not its square root), and the
    frequency branch averages the spectra of the unnormalized channels
    (`transfer_functions.py:601-612`)."""
    from ..standard.latency_delay import fractional_delay

    assert isinstance(signal, ImpulseResponse), "This is only valid for an impulse response"
    assert signal.number_of_channels > 1, (
        "Signal has only one channel so no meaningful averaging can be done"
    )
    avg_sig = signal.copy()
    if normalize_energy:
        td = signal.time_data
        energies = (td**2).sum(dim=0)
        avg_sig.time_data = td * (energies / energies[0])
    if not time_average:
        _, sp = signal.get_spectrum(return_device=True)
        mean_mag = sp.abs().mean(dim=1)
        mean_phase = unwrap(sp.angle(), dim=0).mean(dim=1)
        new_time_data = torch.fft.irfft(torch.polar(mean_mag, mean_phase),
                                        n=signal.length_samples, dim=0)
    else:
        latencies = find_ir_latency(signal)
        channel_to_follow = int(np.argmax(latencies))
        td = avg_sig.time_data
        columns = []
        for i in range(signal.number_of_channels):
            if i == channel_to_follow:
                columns.append(td[:, i])
                continue
            latency_s = (latencies[channel_to_follow] - latencies[i]) / signal.sampling_rate_hz
            columns.append(fractional_delay(signal.get_channels(i), latency_s,
                                            keep_length=True).time_data[:, 0])
        new_time_data = torch.stack(columns, dim=1).mean(dim=1)
    avg_sig.time_data = new_time_data
    return avg_sig


def min_phase_from_mag(
    spectrum: Spectrum,
    sampling_rate_hz: int,
    ir_length_samples: int | None = None,
) -> ImpulseResponse:
    """The minimum-phase IR of a magnitude spectrum
    (`transfer_functions.py:639`): the magnitude interpolated onto a grid of
    ``fs / ir_length_samples`` (default 0.5 Hz) up to exactly Nyquist, its
    minimum phase from the Hilbert transform of its log, and ``irfft``, on
    the spectrum's device."""
    delta_f_hz = 0.5 if ir_length_samples is None else sampling_rate_hz / ir_length_samples
    f_vec, delta_f_hz, original_length = bk.frequency_vector_with_frequency_resolution(
        delta_f_hz, sampling_rate_hz
    )
    mag = spectrum.get_interpolated_spectrum(f_vec, SpectrumType.Magnitude)
    phase = minimum_phase_from_magnitude(mag, False, True, original_length % 2 == 1)
    time_data = torch.fft.irfft(torch.polar(mag, phase), n=original_length, dim=0)
    return ImpulseResponse.from_time_data(time_data, sampling_rate_hz)


def lin_phase_from_mag(
    spectrum: Spectrum,
    sampling_rate_hz: int,
    group_delay_ms: float | None = None,
    check_causality: bool = True,
    minimum_group_delay_factor: float = 1.0,
) -> ImpulseResponse:
    """The linear-phase IR of a magnitude spectrum with the given group
    delay, or without one with the largest minimum-phase group delay (times
    ``minimum_group_delay_factor``, plus 1 ms) of each channel
    (`transfer_functions.py:673`). With a given delay and
    ``check_causality`` it asserts that no channel's minimum group delay
    exceeds it; a delay longer than the grid's period re-grids the
    magnitude finer. The group delays are read on the host (one fetch of C
    values), as in the JAX package."""
    minimum_group_delay = group_delay_ms is None
    check_causality = not minimum_group_delay and check_causality
    if not minimum_group_delay:
        group_delay_s = group_delay_ms / 1000.0
        delta_f_hz = 1.0 / (group_delay_s * 2.0) * 0.9
    else:
        delta_f_hz = 0.5
    f_vec, delta_f_hz, original_length = bk.frequency_vector_with_frequency_resolution(
        delta_f_hz, sampling_rate_hz
    )
    mag = spectrum.get_interpolated_spectrum(f_vec, SpectrumType.Magnitude)
    if check_causality or minimum_group_delay:
        assert minimum_group_delay_factor >= 1.0, (
            "Minimum group delay factor should at least be 1"
        )
        min_phase = minimum_phase_from_magnitude(mag, odd_length=original_length % 2 == 1)
        min_gd = group_delay_direct(min_phase, delta_f_hz)
        group_delay_to_use_s = (
            minimum_group_delay_factor * (min_gd.amax(dim=0) + 1e-3)
        ).double().cpu().numpy()
        if check_causality:
            for n in range(len(group_delay_to_use_s)):
                assert group_delay_to_use_s[n] <= group_delay_s, (
                    f"Given group delay {group_delay_s * 1000} ms is lower "
                    "than minimal group delay "
                    f"{group_delay_to_use_s * 1000} ms for channel {n}"
                )
            group_delay_to_use_s = np.ones(spectrum.number_of_channels) * group_delay_s
        if np.any(group_delay_to_use_s * 2 > original_length / sampling_rate_hz):
            delta_f_hz = 1.0 / (max(group_delay_to_use_s) * 2) * 0.9
            f_vec, delta_f_hz, original_length = (
                bk.frequency_vector_with_frequency_resolution(delta_f_hz, sampling_rate_hz)
            )
            mag = spectrum.get_interpolated_spectrum(f_vec, SpectrumType.Magnitude)
    else:
        group_delay_to_use_s = np.ones(spectrum.number_of_channels) * group_delay_s
    raw_phase = -2 * np.pi * f_vec[:, None] * group_delay_to_use_s[None, :]
    target_length = int(2 * max(group_delay_to_use_s) * sampling_rate_hz + 0.5)
    phase = correct_for_real_phase_spectrum(
        torch.as_tensor(raw_phase, dtype=mag.dtype, device=mag.device)
    )
    td = torch.fft.irfft(torch.polar(mag, phase), n=original_length, dim=0)
    return ImpulseResponse.from_time_data(pad_trim_axis(td, target_length, axis=0),
                                          sampling_rate_hz)


def min_phase_ir(
    sig: ImpulseResponse,
    use_real_cepstrum: bool = True,
    padding_factor: int = 8,
    alpha: float = 1.0,
) -> ImpulseResponse:
    """The minimum-phase version of an IR (`transfer_functions.py:756`):
    by the real cepstrum on the IR's device (batched over channels, FFTs
    of ``next_fast_len(T · padding_factor)``), or by scipy's Hilbert method
    on the host. ``alpha < 1`` weights the IR by ``alpha**n`` before and
    undoes it after.

    parity: scipy's branch takes the unweighted IR (and still divides by
    the weights), and raises ValueError when it writes scipy's half-length
    result into the IR's columns, as the JAX package does
    (`transfer_functions.py:778-790`)."""
    assert isinstance(sig, ImpulseResponse), "This is only valid for an impulse response"
    assert padding_factor >= 1, "Padding factor should be at least 1"
    assert 0.0 < alpha <= 1.0, "Alpha must be in the range ]0, 1]"
    x = sig._x  # (C, T)
    T = x.shape[1]
    if alpha != 1.0:
        x = x * torch.as_tensor(alpha ** np.arange(T), dtype=x.dtype, device=x.device)
    if use_real_cepstrum:
        out = min_phase_ir_from_real_cepstrum(x, padding_factor)[:, :T]
    else:
        from scipy.signal import minimum_phase as min_phase_scipy

        length_fft = next_fast_len(max(T * padding_factor, T), False)
        td = sig.time_data.cpu().numpy()
        out_np = td.copy()
        for ch in range(td.shape[1]):
            # parity: scipy's result is half as long as the IR, so this
            # assignment raises ValueError, as in the JAX package
            out_np[:, ch] = min_phase_scipy(td[:, ch], method="hilbert",
                                            n_fft=length_fft)[:T]
        out = torch.as_tensor(out_np.T, dtype=x.dtype, device=x.device)
    if alpha != 1.0:
        out = out * torch.as_tensor(alpha ** (-np.arange(T)), dtype=x.dtype, device=x.device)
    return sig.copy_with_new_time_data(out.T)


def group_delay(
    signal: Signal,
    analytic_computation: bool = True,
    smoothing: int = 0,
    remove_ir_latency: bool = False,
):
    """``(f, group delays (F, C))`` of each channel
    (`transfer_functions.py:794`). Analytic: the ramped-coefficient
    polynomial ratio of each channel as an FIR filter, host float64
    (`classes.filter_helpers.group_delay_filter`; its IR from one sample
    before the peak with ``remove_ir_latency``). Otherwise ``-dφ/dω`` of
    the float64 FFT's phase on the device, with the IR's latency (against
    its minimum-phase version) taken out of the phase if asked. With
    ``remove_ir_latency`` the FFT is zero-padded to ``next_fast_len(8 T)``.
    ``smoothing``: fractional-octave smoothing of the result. The group
    delays are a tensor on the signal's device."""
    T = signal.length_samples
    length = next_fast_len(T * 8, True) if remove_ir_latency else T
    td = pad_trim_axis(signal.time_data, length, axis=0)
    f = np.fft.rfftfreq(length, 1 / signal.sampling_rate_hz)
    if not analytic_computation:
        # the phase of a float64 FFT (the JAX package's host FFT runs in
        # the data's float): near the spectrum's zeros a float32 phase
        # would pick other unwrap branches than a float64 reference
        ph = torch.fft.rfft(td.double(), dim=0).angle().to(td.dtype)
        if remove_ir_latency:
            assert isinstance(signal, ImpulseResponse), (
                "This is only valid for an impulse response"
            )
            min_ir = min_phase_ir_from_real_cepstrum(signal._x, 1).T
            lat = fractional_latency(signal.time_data, min_ir, 1)
            ph = remove_ir_latency_from_phase(f, ph, lat, signal.sampling_rate_hz)
        group_delays = group_delay_direct(ph, f[1] - f[0])
    else:
        host = td.cpu().numpy()
        group_delays = np.zeros((length // 2 + 1, host.shape[1]))
        for n in range(host.shape[1]):
            b = host[:, n]
            if remove_ir_latency:
                b = b[max(int(np.argmax(np.abs(b))) - 1, 0):]
            _, group_delays[:, n] = group_delay_filter([b, [1]], len(f),
                                                        signal.sampling_rate_hz)
        group_delays = torch.as_tensor(group_delays, dtype=td.dtype, device=td.device)
    if smoothing != 0:
        group_delays = fractional_octave_smoothing(group_delays, None, smoothing)
    return f, group_delays


def minimum_phase(
    signal: ImpulseResponse,
    use_real_cepstrum: bool = True,
    padding_factor: int = 8,
):
    """``(f, minimum phase (F, C))`` of each channel
    (`transfer_functions.py:858`): the angle of the real cepstrum's
    minimum-phase spectrum at its non-negative frequencies, on the IR's
    device (``next_fast_len(T · padding_factor)`` bins, the first half and
    an even length's Nyquist), or scipy's Hilbert method on the host."""
    assert isinstance(signal, ImpulseResponse), "This is only valid for an impulse response"
    if not use_real_cepstrum:
        from scipy.signal import minimum_phase as min_phase_scipy

        T = signal.length_samples
        f = np.fft.rfftfreq(T, d=1 / signal.sampling_rate_hz)
        td = signal.time_data.cpu().numpy()
        min_phases = np.zeros((len(f), signal.number_of_channels))
        for n in range(signal.number_of_channels):
            temp = min_phase_scipy(td[:, n], method="hilbert",
                                   n_fft=padding_factor * len(signal))
            min_phases[:, n] = np.angle(np.fft.rfft(np.pad(temp, (0, max(0, T - len(temp))))[:T]))
        return f, torch.as_tensor(min_phases, dtype=signal.time_data.dtype,
                                  device=signal.device)
    sp = minimum_phase_spectrum_from_real_cepstrum(signal._x, padding_factor)  # (C, N)
    N = sp.shape[1]
    f = np.fft.fftfreq(N, 1 / signal.sampling_rate_hz)
    if N % 2 == 0:
        f[N // 2] *= -1
    # the non-negative frequencies are the first N // 2 + 1 bins
    return f[: N // 2 + 1], sp[:, : N // 2 + 1].angle().T


def minimum_group_delay(
    signal: ImpulseResponse, smoothing: int = 0, padding_factor: int = 8
):
    """``(f, minimum group delay (F, C))`` from `minimum_phase`
    (`transfer_functions.py:903`), on the IR's device."""
    f, min_phases = minimum_phase(signal, padding_factor=padding_factor)
    min_gd = group_delay_direct(min_phases, f[1] - f[0])
    if smoothing != 0:
        min_gd = fractional_octave_smoothing(min_gd, None, smoothing)
    return f, min_gd


def excess_group_delay(
    signal: ImpulseResponse,
    smoothing: int = 0,
    remove_ir_latency: bool = False,
    analytic_computation: bool = False,
):
    """``(f, excess group delay (F, C))``: `group_delay` minus the minimum
    group delay (unpadded), interpolated linearly onto the minimum's grid
    where they differ (`transfer_functions.py:918`)."""
    f_min, min_gd = minimum_group_delay(signal, smoothing=0, padding_factor=1)
    f, gd = group_delay(signal, smoothing=0, analytic_computation=analytic_computation,
                        remove_ir_latency=remove_ir_latency)
    if len(f) != len(f_min):
        gd = interpolate_fr(f, gd, f_min, None, "linear")
    ex_gd = gd - min_gd
    if smoothing != 0:
        ex_gd = fractional_octave_smoothing(ex_gd, None, smoothing)
    return f_min, ex_gd


def combine_ir_with_dirac(
    ir: ImpulseResponse,
    crossover_frequency: float,
    take_lower_band: bool,
    order: int = 8,
    normalization: str | float | None = None,
) -> ImpulseResponse:
    """The IR below (or above) a Linkwitz-Riley crossover merged with a
    dirac at each channel's fractional peak above (or below) it, with the
    channel's polarity, both peak-normalized to 0 dB
    (`transfer_functions.py:944`). ``normalization``: the dirac's band
    scaled to the IR band's energy ("energy"), peak ("peak") or by a gain
    in dB. The bands are zero phase; the data stays on the IR's device."""
    from ..filterbanks import linkwitz_riley_crossovers
    from ..standard.gain_and_level import normalize
    from ..standard.latency_delay import fractional_delay

    assert isinstance(ir, ImpulseResponse), "This is only valid for an impulse response"
    if normalization is not None and isinstance(normalization, str):
        normalization = normalization.lower()
        assert normalization in ("energy", "peak"), "Invalid normalization parameter"
    ir = normalize(ir, 0.0)
    fs = ir.sampling_rate_hz
    latencies_samples = get_fractional_impulse_peak_index(ir.time_data)
    imp = ImpulseResponse(None, torch.as_tensor(impulse(ir.length_samples)[:, None],
                                                dtype=ir.time_data.dtype, device=ir.device), fs)
    imp_channels = [
        fractional_delay(imp, latencies_samples[ch] / fs, keep_length=True).time_data[:, 0]
        for ch in range(ir.number_of_channels)
    ]
    peak_rows = torch.as_tensor((latencies_samples + 0.5).astype(int), device=ir.device)
    polarity = torch.sign(ir.time_data.gather(0, peak_rows[None, :])[0])
    imp = ImpulseResponse.from_time_data(torch.stack(imp_channels, dim=1), fs)

    fb = linkwitz_riley_crossovers([crossover_frequency], order, fs)
    ir_multi = fb.filter_signal(ir, zero_phase=True)
    imp_multi = fb.filter_signal(imp, zero_phase=True)
    band_ir, band_imp = (0, 1) if take_lower_band else (1, 0)
    td_ir = ir_multi.bands[band_ir].time_data
    td_imp = imp_multi.bands[band_imp].time_data
    if normalization == "energy":
        td_imp = td_imp * ((td_ir**2).mean(dim=0).sqrt() / (td_imp**2).mean(dim=0).sqrt())
    elif normalization == "peak":
        td_imp = td_imp * (td_ir.abs().amax(dim=0) / td_imp.abs().amax(dim=0))
    elif isinstance(normalization, (float, int, np.floating, np.integer)):
        td_imp = td_imp * float(from_db(normalization, True))
    combined = ir.copy_with_new_time_data(td_ir + td_imp * polarity[None, :])
    return normalize(combined, 0.0)


def ir_to_filter(
    signal: ImpulseResponse,
    channel: int | None = 0,
    phase_mode: str = "direct",
):
    """An IR as FIR filters (`transfer_functions.py:1015`): one channel →
    a `Filter`, every channel (``channel=None``) → a `FilterBank`; its own
    phase ("direct"), or the minimum ("min") or linear ("lin") phase of its
    magnitude. The coefficients are host numpy, as a Filter holds them."""
    assert isinstance(signal, ImpulseResponse), "This is only valid for an impulse response"
    phase_mode = phase_mode.lower()
    assert phase_mode in ("direct", "min", "lin"), (
        f"{phase_mode} is not valid. Choose from ('direct', 'min', 'lin')"
    )
    signal = signal.get_channels(channel) if channel is not None else signal
    if phase_mode == "min":
        signal = min_phase_from_mag(Spectrum.from_signal(signal), signal.sampling_rate_hz,
                                    len(signal))
    elif phase_mode == "lin":
        signal = lin_phase_from_mag(Spectrum.from_signal(signal), signal.sampling_rate_hz)
    td = signal.time_data.double().cpu().numpy()
    filters = [Filter.from_ba(td[:, ch], [1.0], signal.sampling_rate_hz)
               for ch in range(signal.number_of_channels)]
    return filters[0] if channel is not None else FilterBank(filters)


def filter_to_ir(fir) -> ImpulseResponse:
    """FIR `Filter` or `FilterBank` → IR, zero-padded to the longest
    filter (`transfer_functions.py:1048`); on the default device."""
    if isinstance(fir, Filter):
        assert not fir.is_iir, "This is only valid for FIR filters"
        return ImpulseResponse.from_time_data(fir.ba[0].copy(),
                                              sampling_rate_hz=fir.sampling_rate_hz)
    if isinstance(fir, FilterBank):
        assert all(not f.is_iir for f in fir), "Filter types must be fir"
        assert fir.same_sampling_rate, (
            "Only valid for filter banks with consistent sampling rate"
        )
        length = max(len(f) for f in fir)
        td = np.zeros((length, len(fir)))
        for ind, f in enumerate(fir):
            td[: len(f), ind] = f.ba[0].copy()
        return ImpulseResponse.from_time_data(td, fir.sampling_rate_hz)
    raise TypeError("Unsupported type")


def window_frequency_dependent(
    ir: ImpulseResponse,
    cycles: int,
    end_window_value_db: float = -50.0,
) -> Spectrum:
    """Frequency-dependent Gaussian windowing
    (`transfer_functions.py:1068`): at each rfft bin above DC a window
    centred on each channel's peak, ``cycles`` periods long down to
    ``end_window_value_db``, applied in a direct DFT sum
    (`_backend.fdw_core`) on the IR's device; DC is 0. The peak positions
    come to the host (C ints)."""
    assert isinstance(ir, ImpulseResponse), "This is only valid for an impulse response"
    assert end_window_value_db < 0.0, "Window ends must be less than 0 dB"
    end_window_value = float(from_db(end_window_value_db, True))
    fs = ir.sampling_rate_hz
    T = ir.length_samples
    f = np.fft.rfftfreq(T, 1 / fs)[1:]
    cycles_per_freq = np.round(fs / f * cycles).astype(int)
    half = (T - 1) / 2
    alpha_factor = np.log(1 / end_window_value**2) ** 0.5 * half
    alpha = (alpha_factor / cycles_per_freq) ** 2.0
    ind_max = ir.time_data.abs().argmax(dim=0).cpu().numpy()
    spec = bk.fdw_core(ir.time_data, f * (T / fs), alpha, ind_max)
    return Spectrum(np.hstack([0.0, f]), torch.nn.functional.pad(spec, (0, 0, 1, 0)))


def find_ir_latency(ir: ImpulseResponse, compare_to_min_phase_ir: bool = True) -> np.ndarray:
    """Sub-sample latency of each channel (numpy): against its
    minimum-phase version (analytic cross-correlation), or the fractional
    peak index (`transfer_functions.py:1100`)."""
    assert isinstance(ir, ImpulseResponse), "This is only valid for an impulse response"
    if compare_to_min_phase_ir:
        return fractional_latency(ir.time_data, min_phase_ir(ir).time_data, 1)
    return get_fractional_impulse_peak_index(ir.time_data, 1)


def harmonics_from_chirp_ir(
    ir: ImpulseResponse,
    chirp_range_hz,
    chirp_length_s: float,
    n_harmonics: int = 5,
    offset_percentage: float = 0.05,
) -> list:
    """The harmonic IRs of an exponential-chirp measurement, Farina's
    method (`transfer_functions.py:1115`): the IR rolled so that its peak
    sits at sample 1, and the slices before it at the harmonics' times
    (`_backend.get_harmonic_times`), each trimmed by ``offset_percentage``
    of the gap to its neighbours. The peak position comes to the host; the
    slices stay on the IR's device."""
    assert isinstance(ir, ImpulseResponse), "This is only valid for an impulse response"
    assert 0 <= offset_percentage < 1, "Offset must be smaller than one"
    assert ir.number_of_channels == 1, "Only an IR with a single channel is supported"
    td = ir.time_data
    td = torch.roll(td, 1 - int(td.abs().argmax(dim=0)[0]), dims=0)
    ts = bk.get_harmonic_times(chirp_range_hz, chirp_length_s, n_harmonics + 1)
    time_harm = len(td) + (ts * ir.sampling_rate_hz + 0.5).astype(int)
    time_harm = np.insert(time_harm, 0, len(td))
    ir_dummy = ir.copy_with_new_time_data(ir.time_data[:10])
    harmonics = []
    for nh in range(n_harmonics):
        max_ind = int(time_harm[nh] - (time_harm[nh] - time_harm[nh + 1]) * offset_percentage)
        min_ind = int(time_harm[nh + 1]
                      - (time_harm[nh + 1] - time_harm[nh + 2]) * offset_percentage)
        harmonics.append(ir_dummy.copy_with_new_time_data(td[min_ind:max_ind, 0]))
    return harmonics


def harmonic_distortion_analysis(
    ir,
    chirp_range_hz=None,
    chirp_length_s: float | None = None,
    n_harmonics: int | None = 8,
    smoothing: int = 12,
    generate_plot: bool = True,
) -> dict:
    """THD and THD+N from an exponential-chirp IR, or from a list of the
    fundamental's and the harmonics' IRs (`transfer_functions.py:1155`):
    ``{"1", "2", …, "thd", "thd_n", "thd_percent"}`` as Spectra. The
    spectra come from the IRs' devices; the harmonics' power spectra are
    summed on the fundamental's grid with host ``np.interp`` (one fetch
    each), as in the JAX package. ``generate_plot`` adds ``"plot"``: the
    fundamental's `plot_magnitude` ``[fig, ax]`` with the harmonics, THD and
    THD+N drawn over it."""
    if isinstance(ir, list):
        for each_ir in ir:
            assert isinstance(each_ir, ImpulseResponse), "Unsupported type"
            assert each_ir.number_of_channels == 1, "Only single-channel IRs are supported"
        ir2 = ir.pop(0)
        ir2._spectrum_parameters["smoothing"] = smoothing
        harm = ir
        if chirp_range_hz is None:
            chirp_range_hz = [0, ir2.sampling_rate_hz // 2]
        passed_harmonics = True
    elif isinstance(ir, ImpulseResponse):
        assert (
            chirp_length_s is not None and chirp_range_hz is not None
            and n_harmonics is not None
        ), "Chirp parameters and number of harmonics cannot be None"
        harm = harmonics_from_chirp_ir(ir, chirp_range_hz, chirp_length_s, n_harmonics, 0.01)
        ir2 = ir.copy()
        start, stop, _ = bk.trim_ir_indices(ir2.time_data[:, 0].cpu().numpy(),
                                            ir.sampling_rate_hz, 10e-3)
        ir2.time_data = ir2.time_data[start:stop]
        ir2 = window_ir(ir2, len(ir2), constant_percentage=0.9)[0]
        ir2._spectrum_parameters["smoothing"] = smoothing
        passed_harmonics = False
    else:
        raise TypeError("Type for ir is not supported")

    pad_length = max(ir2.sampling_rate_hz // 5, len(ir2)) - len(ir2)
    ir2.time_data = torch.nn.functional.pad(ir2.time_data, (0, 0, 0, pad_length))
    dev = ir2.device
    thd = torch.zeros(int(sum(len(h) for h in harm)), dtype=ir2.time_data.dtype, device=dev)
    pos_thd = len(thd)
    d: dict = {}
    quadratic = not ir2.spectrum_scaling.is_amplitude_scaling()
    freqs, base_spectrum = ir2.get_spectrum(return_device=True)
    d["1"] = Spectrum(freqs, base_spectrum**0.5 if quadratic else base_spectrum)
    sp_thd = np.zeros(len(freqs))
    if generate_plot:
        fig, ax = ir2.plot_magnitude(smoothing=smoothing,
                                     normalize=MagnitudeNormalization.NoNormalization)
    for i in range(len(harm)):
        if not passed_harmonics:
            harm[i] = window_ir(harm[i], len(harm[i]), constant_percentage=0.9)[0]
        harm[i].set_spectrum_parameters(**ir2._spectrum_parameters)
        f, sp = harm[i].get_spectrum(return_device=True)
        inds = f < chirp_range_hz[-1]
        f = f[inds] / (i + 2)
        sp = sp[: int(inds.sum())]  # f ascends: the bins below the range's end
        sp_power = sp.squeeze().real if quadratic else sp.squeeze().abs() ** 2
        d[f"{i + 2}"] = Spectrum(f, sp**0.5 if quadratic else sp)
        if generate_plot:
            ax.plot(f, to_db(sp_power.cpu().numpy(), False))
        thd[pos_thd - len(harm[i]):pos_thd] = harm[i].time_data.squeeze()
        pos_thd -= len(harm[i])
        sp_thd += np.interp(freqs, f, sp_power.double().cpu().numpy(), left=0.0, right=0.0)

    ind_end = int(np.argmin(np.abs(freqs - chirp_range_hz[-1] / 2)))
    sp_thd = sp_thd[:ind_end]
    freqs_thd = freqs[:ind_end]
    thd_n = Signal(None, thd, ir2.sampling_rate_hz)
    thd_n.set_spectrum_parameters(**ir2._spectrum_parameters)
    f_thd_n, sp_thd_n = thd_n.get_spectrum(return_device=True)
    if not quadratic:
        sp_thd_n = sp_thd_n.abs() ** 2.0
    if generate_plot:
        plot_thd = sp_thd.copy()
        plot_thd[plot_thd == 0] = np.nan
        ax.plot(freqs_thd, to_db(plot_thd, False))
        ax.plot(f_thd_n, to_db(sp_thd_n.real.cpu().numpy(), False))
        ax.legend(["Fundamental"] + [f"{i + 2} Harmonic" for i in range(n_harmonics)]
                  + ["THD", "THD+N"])
        d["plot"] = [fig, ax]
    d["thd_n"] = Spectrum(f_thd_n, sp_thd_n.real**0.5)
    d["thd"] = Spectrum(freqs_thd, sp_thd**0.5, device=dev)
    d["thd_percent"] = Spectrum(
        freqs_thd,
        d["thd"].spectral_data
        / d["1"].get_interpolated_spectrum(freqs_thd, SpectrumType.Magnitude) * 100.0,
    )
    return d


def trim_ir(
    ir: ImpulseResponse,
    channel: int | None = None,
    start_offset_s: float | None = 20e-3,
):
    """Smart start and stop of an IR (`transfer_functions.py:1274`):
    ``(trimmed IR, start, stop)``. The indices come from the host float64
    decision logic (`_backend.trim_ir_indices`: Hilbert envelope, EMA,
    decay scan) on one fetch of the IR; over every channel the earliest
    start and the latest stop; the slice stays on the IR's device."""
    fs = ir.sampling_rate_hz
    start_offset_s = len(ir) / fs if start_offset_s is None else start_offset_s
    assert start_offset_s >= 0, "Offset must be at least 0"
    if channel is not None:
        trimmed = ir.get_channels(channel)
        td = trimmed.time_data.squeeze()
        start, stop, _ = bk.trim_ir_indices(td.cpu().numpy(), fs, start_offset_s)
        trimmed.time_data = td[start:stop]
        return trimmed, start, stop
    host = ir.time_data.cpu().numpy()
    starts = np.zeros(ir.number_of_channels, dtype=int)
    stops = starts.copy()
    for ch in range(ir.number_of_channels):
        starts[ch], stops[ch], _ = bk.trim_ir_indices(host[:, ch], fs, start_offset_s)
    start = int(np.min(starts))
    stop = int(np.max(stops))
    return ir.copy_with_new_time_data(ir.time_data[start:stop]), start, stop


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
    f, sp = ir.get_spectrum(return_device=True)
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

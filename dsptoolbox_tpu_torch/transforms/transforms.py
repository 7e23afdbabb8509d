"""Special transforms: cepstrum, mel/MFCC, ISTFT, chroma, CWT/VQT, Hilbert,
warping, Laguerre, LPC, the arbitrary-frequency DFT and the filter-bank
spectrum (`dsptoolbox_tpu/transforms/transforms.py`).

Behavioral reference: `dsptoolbox/transforms/transforms.py`. Everything
runs on the signal's device:

- the STFT features (`log_mel_spectrogram`, `mfcc`, `chroma_stft`) project
  `Signal._get_power_spectrogram_device`'s ``|S|²`` (the STFT through the
  framing kernel B1 on a float32 CUDA signal) with float32 matrix products
  on the channels-first ``(C, frames, F)`` tensor; the mel, DCT, pitch and
  chroma matrices are host float64 numpy, uploaded once per device;
- `cwt` and `vqt` convolve with all their kernels in one batched complex
  FFT convolution per call (`_backend.same_mode_bank`), per octave for the
  VQT;
- `warp` and `laguerre` apply the allpass operator by doubling
  (`_backend.allpass_apply`, `allpass_apply_t`): no launch per output
  sample;
- `lpc` frames and windows through B1 (`ops.cuda_framing.windowed_frames`,
  the same frames as the reference's zero-padded framing times the
  window), estimates in float64 on the device (`helpers.ar_estimation`)
  and synthesizes every frame at once: the all-pole impulse responses by
  Newton's doubling of the power series 1/a, then one batched FFT
  convolution with the noise (`allpole_frames`), from a `torch.Generator`
  seeded by ``seed``;
- `spectrum_via_filterbank` runs its parallel bandpass bank through the
  filter-bank kernel B3 (zero phase: each band through B2, forward and
  backward).

Return types follow the JAX package: host numpy where it returns numpy
(`cepstrum`, `mel_filterbank`, `log_mel_spectrogram`, `mfcc` — its lazy
host array waits for the port's lazy returns —, `chroma_stft`, `dft`, the
`lpc` coefficients, `cwt` and `vqt` by default), a tensor on the signal's
device with ``return_device=True`` (`cwt`, `vqt`), and `Signal`s and a
`Spectrum` on the signal's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import default_complex, default_device
from ..classes import Filter, FilterBank, MultiBandSignal, Signal, Spectrum
from ..classes.lazy_array import LazyHostArray
from ..classes.signal import DeviceTimeData
from ..helpers.ar_estimation import burg_ar, yule_walker_ar
from ..helpers.frequency_conversion import hz2mel, mel2hz
from ..helpers.gain_and_level import to_db
from ..helpers.latency import analytic_signal
from ..ops.fft_conv import resample_poly
from ..ops.framing import reconstruct_framed_signal
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import _device_window, _windowed_frames
from ..ops.windows import get_window
from ..plots.plots import _plt, general_matrix_plot
from .._trace import spanned
from .._enums import FilterBankMode, FilterCoefficientsType, FilterPassType, Window
from ._backend import (
    MorletWavelet,
    Wavelet,
    _squeeze_core,
    allpass_apply_t,
    conv_head,
    dft_core,
    get_kernels_vqt,
    get_warping_factor,
    pitch2frequency,
    same_mode_bank,
    warp_time_series,
)

__all__ = [
    "cepstrum",
    "from_complex_cepstrum",
    "log_mel_spectrogram",
    "mel_filterbank",
    "plot_waterfall",
    "mfcc",
    "istft",
    "chroma_stft",
    "cwt",
    "hilbert",
    "vqt",
    "stereo_mid_side",
    "laguerre",
    "warp",
    "warp_filter",
    "lpc",
    "dft",
    "spectrum_via_filterbank",
    "Wavelet",
    "MorletWavelet",
]

_TINY32 = float(np.finfo(np.float32).tiny)


def _project(m: np.ndarray, x_cf: torch.Tensor) -> torch.Tensor:
    """``x_cf (C, frames, F) @ mᵀ`` → ``(C, frames, B)`` for a host matrix
    ``m (B, F)`` (uploaded once per device, `ops.spectral._device_window`):
    the reference's ``tensordot(m, x, axes=(-1, 0))`` on the channels-first
    layout, a float32 product (never TF32: torch's default)."""
    m = np.asarray(m, dtype=np.float64)
    return x_cf @ _device_window(m.tobytes(), x_cf.dtype, x_cf.device).reshape(m.shape).T


def _to_host(x_cf: torch.Tensor) -> np.ndarray:
    """A channels-first ``(C, frames, B)`` tensor as the reference's host
    ``(B, frames, C)`` array."""
    return x_cf.cpu().numpy().transpose(2, 1, 0)


def _channels(signal: Signal, channel) -> torch.Tensor:
    """The real planes ``(C', T)`` of the selected channels (all for None)."""
    if channel is None:
        return signal._x
    return signal._planes_at(np.atleast_1d(channel))[0]


def cepstrum(signal: Signal, complex: bool = True) -> np.ndarray:
    """Complex (principal-branch log) or real cepstrum ``(T, C)``, host
    complex numpy (`transforms.py:59-87`)."""
    sp = torch.fft.fft(signal._x, dim=-1)
    logsp = torch.log(sp) if complex else torch.log(sp.abs()).to(sp.dtype)
    return torch.fft.ifft(logsp, dim=-1).T.cpu().numpy()


def from_complex_cepstrum(cepstrum, sampling_rate_hz: int) -> Signal:
    """Inverse of the complex cepstrum (`transforms.py:89-111`): numpy goes
    to the default device, a tensor stays on its own."""
    if not torch.is_tensor(cepstrum):
        cepstrum = torch.as_tensor(np.asarray(cepstrum)).to(default_device(), default_complex())
    td = torch.fft.ifft(torch.exp(torch.fft.fft(cepstrum, dim=0)), dim=0).real
    return Signal.from_time_data(td, sampling_rate_hz)


def mel_filterbank(
    f_hz: np.ndarray,
    range_hz=None,
    n_bands: int = 40,
    normalize: bool = True,
):
    """Triangular Hz → mel projection matrix ``(n_bands, F)`` and the bands'
    centres in mel, host float64 (`transforms.py:198-279`)."""
    f_hz = np.squeeze(f_hz)
    assert f_hz.ndim == 1, "f_hz should be a 1D-array"
    n_bands = int(n_bands)
    if range_hz is None:
        range_hz = f_hz[[0, -1]]
    else:
        range_hz = np.atleast_1d(np.asarray(range_hz).squeeze())
        assert len(range_hz) == 2, "range_hz should be an array with exactly two values!"
        range_hz = np.sort(range_hz)
        assert range_hz[-1] <= f_hz[-1], (
            f"Upper frequency in range {range_hz[-1]} is bigger than "
            f"nyquist frequency {f_hz[-1]}"
        )
        assert range_hz[0] >= 0, "Lower frequency in range must be positive"
    range_mel = hz2mel(range_hz)
    mel_center_freqs = np.linspace(range_mel[0], range_mel[1], n_bands + 2, endpoint=True)
    bands_hz = mel2hz(mel_center_freqs)
    inds = np.array([np.argmin(np.abs(b - f_hz)) for b in bands_hz], dtype=int)
    mel_filters = np.zeros((n_bands, len(f_hz)))
    for n in range(n_bands):
        ni = n + 1
        mel_filters[n, inds[ni - 1] : inds[ni]] = np.linspace(
            0, 1, inds[ni] - inds[ni - 1], endpoint=False
        )
        mel_filters[n, inds[ni] : inds[ni + 1]] = np.linspace(
            1, 0, inds[ni + 1] - inds[ni], endpoint=False
        )
        if normalize and mel_filters[n].sum() > 0:
            mel_filters[n, :] /= np.sum(mel_filters[n, :])
    return mel_filters, mel_center_freqs[1:-1]


def log_mel_spectrogram(
    s: Signal,
    channel: int = 0,
    range_hz=None,
    n_bands: int = 40,
    generate_plot: bool = True,
    stft_parameters: dict | None = None,
):
    """Log-mel spectrogram ``(n_bands, frames, C)`` in dB, host numpy: the
    power STFT projected on the mel bank (`transforms.py:113-196`). The
    float32 power underflows to 0 where a float64 one keeps a denormal, so
    the mel power is floored at float32's tiny before the log."""
    if stft_parameters is not None:
        s.set_spectrogram_parameters(**stft_parameters)
    time_s, f_hz, power = s._get_power_spectrogram_device()
    mfilt, f_mel = mel_filterbank(f_hz, range_hz, n_bands, normalize=True)
    mel = _project(mfilt, power.permute(2, 1, 0)).clamp(min=_TINY32)
    log_mel_sp = _to_host(to_db(mel, False))
    if generate_plot:
        fig, ax = general_matrix_plot(
            log_mel_sp[..., channel],
            range_x=[time_s[0], time_s[-1]],
            range_y=[f_mel[0], f_mel[-1]],
            range_z=50,
            ylabel="Frequency / Mel",
            xlabel="Time / s",
            ylog=False,
        )
        return time_s, f_mel, log_mel_sp, fig, ax
    return time_s, f_mel, log_mel_sp


def plot_waterfall(
    sig: Signal,
    channel: int = 0,
    dynamic_range_db: float = 40,
    stft_parameters: dict | None = None,
):
    """3D waterfall plot of one channel's STFT in dB (`transforms.py:281-333`)."""
    assert dynamic_range_db > 0, "Dynamic range has to be more than 0"
    plt = _plt()
    sig = sig.get_channels(channel)
    if stft_parameters is not None:
        sig.set_spectrogram_parameters(**stft_parameters)
    t, f, S = sig.get_spectrogram(return_device=True)
    amplitude_scaling = sig.spectrum_scaling.is_amplitude_scaling()
    fig, ax = plt.subplots(figsize=(10, 8), subplot_kw=dict(projection="3d"))
    tt, ff = np.meshgrid(t, f)
    ax.plot_surface(
        tt, ff, to_db(S[..., 0].cpu().numpy(), amplitude_scaling, dynamic_range_db),
        cmap="magma",
    )
    ax.set_xlabel("Time / s")
    ax.set_ylabel("Frequency / Hz")
    ax.set_zlabel("dB")
    fig.tight_layout()
    return fig, ax


def _dct_matrix(n: int) -> np.ndarray:
    """The DCT-II as a matrix on the band axis."""
    k = np.arange(n)
    return 2.0 * np.cos(np.pi * k[:, None] * (2 * k[None, :] + 1) / (2 * n))


def mfcc(
    signal: Signal,
    channel: int = 0,
    mel_filters: np.ndarray | None = None,
    generate_plot: bool = True,
    stft_parameters: dict | None = None,
):
    """Mel-frequency cepstral coefficients ``(n_bands, frames, C)``, host
    numpy: the mel projection, dB, and the DCT-II as two products on the
    device, NaN to 0 (`transforms.py:335-441`)."""
    if stft_parameters is not None:
        signal.set_spectrogram_parameters(**stft_parameters)
    time_s, f, power = signal._get_power_spectrogram_device()
    if mel_filters is None:
        mel_filters, f_mel = mel_filterbank(f, None, n_bands=40)
    else:
        assert mel_filters.shape[1] == power.shape[0], (
            f"Shape of the mel filter matrix {mel_filters.shape} does "
            f"not match the STFT {tuple(power.shape)}"
        )
        f_mel = np.array([0, mel_filters.shape[0]])
    # the reference's float32 matrix (`transforms.py:270`)
    mel_mat = np.asarray(mel_filters, np.float32).astype(np.float64)
    mel_power = _project(mel_mat, power.permute(2, 1, 0)).clamp(min=_TINY32)
    log_sp = to_db(mel_power, False)
    coeffs = _project(_dct_matrix(log_sp.shape[-1]), log_sp).abs()
    coeffs = _to_host(torch.nan_to_num(coeffs, nan=0.0))
    if generate_plot:
        fig, ax = general_matrix_plot(
            coeffs[..., channel],
            range_x=[time_s[0], time_s[-1]],
            range_y=[f_mel[0], f_mel[-1]],
            xlabel="Time / s",
            ylabel="Cepstral coefficients",
        )
        return time_s, f_mel, coeffs, fig, ax
    return time_s, f_mel, coeffs


@spanned("dsp.entry.transforms.istft")
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
    tensor, a getter's `LazyHostArray` (its tensor, no host copy; the host
    buffer once it was read there) or numpy (to the default device). The parameters
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
    if isinstance(stft, LazyHostArray):
        # a getter's lazy value: its tensor, or the host buffer once read
        stft = stft.device_tensor()
    elif not torch.is_tensor(stft):
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


def chroma_stft(
    signal: Signal,
    tuning_a_hz: float = 440,
    compression: float = 0.5,
    plot_channel: int = -1,
):
    """Chroma ``(12, frames, C)`` and pitch ``(128, frames, C)`` features,
    log-compressed, host numpy: the power STFT folded by static pitch and
    chroma matrices (`transforms.py:589-686`)."""
    assert tuning_a_hz > 0, "Tuning A4 must be greater than zero"
    assert compression > 0, "Compression factor must be greater than zero"
    t, f, power = signal._get_power_spectrogram_device()
    pitch_frequencies = pitch2frequency(tuning_a_hz)
    pitch_transformation = np.zeros((len(pitch_frequencies), len(f)))
    for ind, fn in enumerate(pitch_frequencies):
        inds = (f >= fn * 2 ** (-1 / 24)) & (f < fn * 2 ** (1 / 24))
        pitch_transformation[ind, inds] = 1
    n_notes = 12
    chroma_transformation = np.zeros((n_notes, len(pitch_frequencies)))
    for i in range(n_notes):
        chroma_transformation[i, i::n_notes] = 1
    pitch_stft = _project(pitch_transformation, power.permute(2, 1, 0))
    chroma = _project(chroma_transformation, pitch_stft)
    pitch_stft = _to_host(torch.log(1 + compression * pitch_stft))
    chroma = _to_host(torch.log(1 + compression * chroma))
    if plot_channel != -1:
        plt = _plt()
        fig, ax = plt.subplots(1, 1)
        image = ax.imshow(chroma[..., plot_channel], aspect="auto", origin="lower")
        ax.set_yticks(
            np.arange(12), ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
        )
        time_step = int(1 / t[1]) if t[1] > 0 else 1
        ax.set_xticks(np.arange(0, chroma.shape[1], time_step), np.round(t[::time_step]))
        ax.set_xlabel("Time / s")
        ax.set_ylabel("Note")
        fig.colorbar(image)
        return t, chroma, pitch_stft, fig, ax
    return t, chroma, pitch_stft


def cwt(
    signal: Signal,
    frequencies: np.ndarray,
    wavelet,
    channel=None,
    synchrosqueezed: bool = False,
    apply_synchrosqueezed_normalization: bool = False,
    return_device: bool = False,
):
    """Continuous wavelet transform ``(F, T, C)``: every scale's normalised
    wavelet in one batched complex FFT convolution ("same" mode), then, when
    asked, synchrosqueezing (`transforms.py:687-761`). Host complex numpy,
    or with ``return_device=True`` a complex tensor on the signal's
    device."""
    fs_hz = signal.sampling_rate_hz
    if isinstance(wavelet, MorletWavelet) and len(frequencies) > 1:
        # every scale from one base wavelet: a call per frequency builds
        # the base anew for each scale on the host
        waves = wavelet.get_wavelet(np.asarray(frequencies), fs_hz)
    else:
        waves = [wavelet.get_wavelet(f, fs_hz) for f in frequencies]
    wavelets = [np.asarray(wv) / np.abs(wv).sum() for wv in waves]
    scal = same_mode_bank(_channels(signal, channel), wavelets).permute(0, 2, 1)
    if synchrosqueezed:
        scal = _squeeze_core(scal, np.asarray(frequencies), fs_hz,
                             apply_frequency_normalization=apply_synchrosqueezed_normalization)
    return scal if return_device else scal.cpu().numpy()


def hilbert(signal):
    """Analytic signal of a `Signal`, or of each band of a
    `MultiBandSignal` (`transforms.py:763-810`), on the signal's device."""
    if isinstance(signal, Signal):
        z = analytic_signal(signal._x, dim=-1)
        return signal.copy_with_new_time_data(DeviceTimeData(z.real.T, z.imag.T))
    if isinstance(signal, MultiBandSignal):
        new_mb = signal.copy()
        new_mb.bands = [hilbert(b) for b in new_mb.bands]
        return new_mb
    raise TypeError("Signal does not have a valid type")


def vqt(
    signal: Signal,
    channel=None,
    q: float = 1,
    gamma: float = 50,
    octaves: list = [1, 5],
    bins_per_octave: int = 24,
    a4_tuning: int = 440,
    window="hann",
    return_device: bool = False,
):
    """Variable-Q transform ``(frequencies, (F, T, C))`` (`transforms.py:812-924`):
    decimation, then per octave one batched complex FFT convolution with
    all kernels, upsampled back. Host complex numpy, or with
    ``return_device=True`` a complex tensor on the signal's device."""
    td = _channels(signal, channel)
    fs = signal.sampling_rate_hz
    highest_f = a4_tuning * 2 ** (octaves[1] - 4 + 2 / 12)
    decimation = int((fs // 2) / (highest_f * 1.1))
    mid_fs = fs // decimation
    td = resample_poly(td, up=1, down=decimation)
    gamma = gamma / fs * mid_fs
    kernels = get_kernels_vqt(q, highest_f, bins_per_octave, mid_fs, window, gamma)
    T_out = signal.length_samples
    pieces = []
    for oc in range(octaves[1] - octaves[0] + 1):
        acc = same_mode_bank(td, kernels)  # (bins, C, T_oct)
        if oc != 0:
            acc = resample_poly(acc, up=2**oc, down=1)
        acc = resample_poly(acc, up=decimation, down=1)
        diff = acc.shape[-1] - T_out
        if diff > 0:
            acc = acc[..., :T_out]
        elif diff < 0:
            acc = torch.nn.functional.pad(acc, (0, -diff))
        pieces.append(acc)
        td = resample_poly(td, up=1, down=2)
    cqt = torch.cat(pieces).flip(0).permute(0, 2, 1)
    f = a4_tuning * 2 ** (np.arange(octaves[0] - 4 - 9 / 12, octaves[1] - 4 + 2 / 12, 1 / 12))
    return f, (cqt if return_device else cqt.cpu().numpy())


def stereo_mid_side(signal: Signal, forward: bool) -> Signal:
    """Left/right ↔ mid/side (`transforms.py:926-953`)."""
    assert signal.number_of_channels == 2, "Signal must have exactly two channels"
    a, b = signal._x[0], signal._x[1]
    td = torch.stack([a + b, a - b])
    if forward:
        td = td / 2
    return signal.copy_with_new_time_data(td.T)


def laguerre(signal: Signal, warping_factor: float) -> Signal:
    """Discrete Laguerre transform (`transforms.py:955-1017`). The JAX
    package scans T − 1 allpass filterings of the prefiltered, reversed
    signal u = p(rev x), p = √(1−λ²)/(1 + λz⁻¹), taking the last sample of
    each; that is Dᵀ·rev(u) for the allpass operator at −λ (the section
    (λ + z⁻¹)/(1 + λz⁻¹) is A(z) at −λ): `_backend.allpass_apply_t`, float64.
    The prefilter is a float64 FFT convolution with its impulse response
    b·(−λ)ⁿ, exact over the T samples kept."""
    assert np.abs(warping_factor) < 1.0, "Warping factor cannot be larger than 1."
    lam = float(warping_factor)
    x = signal._x
    T = x.shape[-1]
    n = torch.arange(T, dtype=torch.float64, device=x.device)
    h = (1.0 - lam**2) ** 0.5 * torch.pow(
        torch.tensor(-lam, dtype=torch.float64, device=x.device), n)
    u = conv_head(x.flip(-1).to(torch.float64), h, T)
    out = allpass_apply_t(u.flip(-1).T, -lam)
    return signal.copy_with_new_time_data(out.to(x.dtype))


def warp(
    ir: Signal,
    warping_factor,
    shift_ir: bool,
    total_length: int | None = None,
):
    """Warp or dewarp an IR (WFIR; `transforms.py:1019-1131`) through
    `_backend.allpass_apply`. With ``shift_ir`` each channel is first rolled
    to its start (ISO 3382 at −20 dB, a host search on the fetched data);
    with ``total_length`` only its first samples are warped. A string
    factor ("bark", "erb", inverted with a trailing "-") also returns the
    factor."""
    from ..room_acoustics._backend import find_ir_start

    approximation = isinstance(warping_factor, str)
    warping_factor = get_warping_factor(warping_factor, ir.sampling_rate_hz)
    td = ir._x
    if shift_ir:
        host = td.cpu().numpy()
        td = torch.stack([torch.roll(td[ch], -find_ir_start(host[ch], -20))
                          for ch in range(ir.number_of_channels)])
    if total_length is not None:
        td = td[:, :total_length]
    warped_ir = ir.copy_with_new_time_data(warp_time_series(td.T, warping_factor))
    if approximation:
        return warped_ir, warping_factor
    return warped_ir


def warp_filter(filter: Filter, warping_factor: float) -> Filter:
    """Warp a filter's poles and zeros (`transforms.py:1133-1197`)."""
    assert abs(warping_factor) < 1.0, "Warping factor must be less than 1."
    z, p, k = filter.get_coefficients(FilterCoefficientsType.Zpk)
    p = (warping_factor + p) / (1 + warping_factor * p)
    z = (warping_factor + z) / (1 + warping_factor * z)
    if len(p) > len(z):
        z = np.hstack([z, [warping_factor] * (len(p) - len(z))])
    elif len(z) > len(p):
        p = np.hstack([p, [warping_factor] * (len(z) - len(p))])
    return Filter.from_zpk(z, p, k, filter.sampling_rate_hz)


def allpole_frames(a: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``lfilter([1], a, source)`` from a zero state for every frame at
    once: ``a (..., order+1)``, ``source (..., L)`` → ``(..., L)``, float64.
    The impulse responses h = 1/a to L samples come from Newton's doubling
    of the power series (h ← h − z^m·h·r, r the residual of a·h beyond its
    first m samples), then one batched FFT convolution: O(log L) batched
    calls, none per sample or frame."""
    a = a.to(torch.float64)
    source = source.to(torch.float64)
    L = source.shape[-1]
    h = 1.0 / a[..., :1]
    while h.shape[-1] < L:
        m = h.shape[-1]
        m2 = min(2 * m, L)
        r = conv_head(a[..., :m2], h, m2)[..., m:]
        h = torch.cat([h, -conv_head(h[..., : m2 - m], r, m2 - m)], dim=-1)
    return conv_head(h, source, L)


def lpc(
    signal: Signal,
    order: int,
    window_length_samples: int,
    synthesize_encoded_signal: bool = False,
    use_burg_method: bool = False,
    hop_size_samples: int | None = None,
    window_type: Window = Window.Hann,
    seed: int | None = None,
):
    """Linear-predictive coding over windowed frames (`transforms.py:1199-1283`):
    ``(a (order+1, frames, C), variance (frames, C))`` as host numpy, or
    with ``synthesize_encoded_signal`` the frames resynthesized from white
    noise of each frame's variance (a `torch.Generator` seeded by ``seed``,
    where the JAX package draws from numpy's global state) and
    overlap-added as a `Signal`."""
    from ..generators.generators import _generator

    if hop_size_samples is None:
        hop_size_samples = window_length_samples // 2
    x = signal._x
    window = get_window(window_type, window_length_samples, symmetric=False)
    frames = _windowed_frames(x, window, hop_size_samples, False)
    td = frames.permute(2, 1, 0)  # the reference's (L, frames, C)
    a, var = burg_ar(td, order) if use_burg_method else yule_walker_ar(td, order)
    if not synthesize_encoded_signal:
        return a.cpu().numpy(), var.cpu().numpy()
    C, K, L = frames.shape
    noise = torch.randn((C, K, L), generator=_generator(seed, x.device), dtype=torch.float64,
                        device=x.device)
    source = noise * var.clamp(min=0).sqrt().T[..., None]
    synth = allpole_frames(a.permute(2, 1, 0), source)
    rec = reconstruct_framed_signal(synth.to(x.dtype), hop_size_samples, window,
                                    signal.length_samples)
    return Signal.from_time_data(rec.T, signal.sampling_rate_hz)


def dft(signal: Signal, frequency_vector_hz: np.ndarray) -> np.ndarray:
    """DFT ``(F, C)`` at arbitrary frequencies, host complex numpy
    (`transforms.py:1286-1328`): `_backend.dft_core` on the device."""
    f_normalized = np.asarray(frequency_vector_hz) * (
        signal.length_samples / signal.sampling_rate_hz
    )
    return dft_core(signal._x.T, f_normalized).cpu().numpy()


def spectrum_via_filterbank(
    signal: Signal,
    frequency_vector_hz: np.ndarray,
    bandwidth_octaves: float | None = None,
    bandwidth_hz: float | None = None,
    order: int = 8,
    zero_phase: bool = False,
) -> Spectrum:
    """RMS magnitude spectrum ``(F, C)`` from a parallel bank of Butterworth
    bandpasses, one per frequency (`transforms.py:1330-1393`): the bank
    through kernel B3 on a float32 CUDA signal, each band through B2 in
    zero phase; the spectrum on the signal's device."""
    from ..standard.gain_and_level import rms

    assert bandwidth_octaves is not None or bandwidth_hz is not None, (
        "At least one bandwidth parameter must be provided"
    )
    bands = []
    if bandwidth_hz is not None:
        assert bandwidth_hz > 0, "Bandwidth must be positive"
        assert bandwidth_octaves is None, "Both bandwidths cannot be given"
        hb = bandwidth_hz / 2.0
        for freq in frequency_vector_hz:
            bands.append([freq - hb, freq + hb])
    if bandwidth_octaves is not None:
        assert bandwidth_octaves > 0, "Bandwidth must be positive"
        assert bandwidth_hz is None, "Both bandwidths cannot be given"
        factor = 2 ** (bandwidth_octaves / 2.0)
        for freq in frequency_vector_hz:
            bands.append([freq / factor, freq * factor])
    fb = FilterBank([
        Filter.iir_filter(order, band, FilterPassType.Bandpass, signal.sampling_rate_hz)
        for band in bands
    ])
    mir = fb.filter_signal(signal, FilterBankMode.Parallel, zero_phase=zero_phase)
    return Spectrum(frequency_vector_hz, rms(mir, False), device=signal.device)

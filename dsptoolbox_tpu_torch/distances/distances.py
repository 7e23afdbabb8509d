"""Distance and quality measures between signals
(`dsptoolbox_tpu/distances/distances.py`).

Spectra, framing and reductions run on the signals' device; each measure
returns host numpy values per channel, fetched once. The spectral
distances form their integrands in float64 from the float32 spectra (the
Itakura-Saito terms take both signs and cancel) and integrate them with host
float64 Simpson weights on the device. SNR and SI-SDR reduce in float64. `fw_snr_seg` filters both signals through the
gammatone bank (`FilterBankMode.Parallel`: kernel B3 on a float32 CUDA
signal) and frames the bands through `ops.spectral._windowed_frames`
(kernel B1), a few channels at a time (`FW_CHUNK_BYTES` of frames).
"""

from __future__ import annotations

import numpy as np
import torch

from .._enums import FilterBankMode, SpectrumMethod
from ..classes import Signal
from ..helpers.other import find_nearest_points_index_in_vector
from ..ops.spectral import _windowed_frames

# bytes of one signal's frames that `fw_snr_seg` holds at once
FW_CHUNK_BYTES = 2 << 30

_SIMPSON_W_CACHE: dict = {}


def _simpson_weights(x: np.ndarray) -> np.ndarray:
    """Composite-Simpson quadrature weights for sample points ``x``
    (scipy-compatible, including its uneven-interval handling), host
    float64, cached per grid: integration is linear in y, so ∫y = w·y
    (`dsptoolbox_tpu/distances/distances.py:22`)."""
    from scipy.integrate import simpson

    key = (x.shape[0], hash(x.tobytes()))
    w = _SIMPSON_W_CACHE.get(key)
    if w is None:
        n = len(x)
        w = np.empty(n)
        CH = 512
        for i0 in range(0, n, CH):
            m = min(CH, n - i0)
            basis = np.zeros((m, n))
            basis[np.arange(m), i0 + np.arange(m)] = 1.0
            w[i0: i0 + m] = simpson(basis, x=x, axis=-1)
        if len(_SIMPSON_W_CACHE) > 16:
            _SIMPSON_W_CACHE.clear()
        _SIMPSON_W_CACHE[key] = w
    return w


def _simpson(y: torch.Tensor, x: np.ndarray) -> torch.Tensor:
    """scipy.integrate.simpson-compatible composite Simpson along axis 0."""
    w = torch.as_tensor(_simpson_weights(np.asarray(x)), dtype=y.dtype, device=y.device)
    return torch.tensordot(w, y, dims=([0], [0]))


def _log_spectral_distance(x, y, f) -> torch.Tensor:
    return torch.sqrt(_simpson((10 * torch.log10(x / y)) ** 2, f))


def _itakura_saito_measure(x, y, f) -> torch.Tensor:
    return _simpson(x / y - torch.log10(x / y) - 1, f)


def _prepare_psd(insig1, insig2, method, f_range_hz, spectrum_parameters):
    assert insig1.sampling_rate_hz == insig2.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    assert insig1.number_of_channels == insig2.number_of_channels, (
        "Signals have different channel numbers"
    )
    if spectrum_parameters is None:
        spectrum_parameters = {}
    fs_hz = insig1.sampling_rate_hz
    if f_range_hz is None:
        f_range_hz = [0, fs_hz // 2]
    else:
        assert len(f_range_hz) == 2, (
            "f_range_hz must only have a lower and an upper limit"
        )
        f_range_hz = np.sort(np.asarray(f_range_hz))
        assert f_range_hz[1] <= fs_hz // 2, (
            "Upper bound for frequency must be smaller than the nyquist "
            "frequency"
        )
        assert not any(f_range_hz < 0), (
            "Frequencies in range must be positive"
        )
    insig1.set_spectrum_parameters(method=method, **spectrum_parameters)
    insig2.set_spectrum_parameters(method=method, **spectrum_parameters)
    f, spec1 = insig1.get_spectrum(return_device=True)
    f, spec2 = insig2.get_spectrum(return_device=True)
    psd1, psd2 = spec1.abs().double(), spec2.abs().double()
    if insig1.spectrum_scaling.is_amplitude_scaling():
        psd1 = psd1**2
        psd2 = psd2**2
    ids = find_nearest_points_index_in_vector(f_range_hz, f)
    sl = slice(int(ids[0]), int(ids[1]))
    return f[sl], psd1[sl], psd2[sl]


def log_spectral(
    insig1: Signal,
    insig2: Signal,
    method: SpectrumMethod = SpectrumMethod.WelchPeriodogram,
    f_range_hz=[20, 20000],
    energy_normalization: bool = True,
    spectrum_parameters: dict | None = None,
) -> np.ndarray:
    """Log-spectral distance per channel (`distances.py:23-105`)."""
    f, psd1, psd2 = _prepare_psd(
        insig1, insig2, method, f_range_hz, spectrum_parameters
    )
    if energy_normalization:
        psd1 = psd1 / psd1.sum(dim=0)
        psd2 = psd2 / psd2.sum(dim=0)
    return _log_spectral_distance(psd1, psd2, f).cpu().numpy()


def itakura_saito(
    insig1: Signal,
    insig2: Signal,
    method: SpectrumMethod = SpectrumMethod.WelchPeriodogram,
    f_range_hz=[20, 20000],
    energy_normalization: bool = True,
    spectrum_parameters: dict | None = None,
) -> np.ndarray:
    """Itakura-Saito measure per channel (`distances.py:108-191`)."""
    f, psd1, psd2 = _prepare_psd(
        insig1, insig2, method, f_range_hz, spectrum_parameters
    )
    if energy_normalization:
        psd1 = psd1 / psd1.sum(dim=0)
        psd2 = psd2 / psd2.sum(dim=0)
    return _itakura_saito_measure(psd1, psd2, f).cpu().numpy()


def snr(signal: Signal, noise: Signal) -> np.ndarray:
    """SNR in dB per channel (`distances.py:194-222`): the population
    standard deviations (as ``np.std``), reduced in float64."""
    assert signal.sampling_rate_hz == noise.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    assert (
        noise.number_of_channels == 1
        or noise.number_of_channels == signal.number_of_channels
    ), "Number of channels does not match"
    rms_s = signal._x.double().std(dim=-1, correction=0)
    rms_n = noise._x.double().std(dim=-1, correction=0)
    return np.atleast_1d((20 * torch.log10(rms_s / rms_n)).cpu().numpy())


def si_sdr(target_signal: Signal, modified_signal: Signal) -> np.ndarray:
    """Scale-invariant SDR per channel (`distances.py:225-272`), reduced in
    float64."""
    assert (
        target_signal.sampling_rate_hz == modified_signal.sampling_rate_hz
    ), "Sampling rates do not match"
    assert (
        target_signal.length_samples == modified_signal.length_samples
    ), "Lengths do not match"
    multichannel = target_signal.number_of_channels == 1
    if not multichannel:
        assert (
            target_signal.number_of_channels
            == modified_signal.number_of_channels
        ), "Number of channels does not match"
    s = target_signal._x.double()  # (C or 1, T): broadcasts over channels
    shat = modified_signal._x.double()
    alpha = ((s * shat).sum(dim=-1) / (s * s).sum(dim=-1))[:, None]
    sisdr = 10 * torch.log10(
        (alpha * s).square().sum(dim=-1) / (alpha * s - shat).square().sum(dim=-1)
    )
    return np.atleast_1d(sisdr.cpu().numpy())


def _fwsnrseg_channels(xb, xhb, window, step, gamma, lo, hi):
    """fwSNRseg of the bands ``(channels, bands, T)`` of the reference and
    the processed signal → ``(channels,)``."""
    eps = 1e-30
    X = torch.fft.rfft(_windowed_frames(xb, window, step, False), dim=-1).abs()
    Xh = torch.fft.rfft(_windowed_frames(xhb, window, step, False), dim=-1).abs()
    W = X**gamma  # (channels, bands, K, F)
    Xn = X / X.sum(dim=-1, keepdim=True)
    del X
    Xhn = Xh / Xh.sum(dim=-1, keepdim=True)
    del Xh
    # log-domain form of the reference's log10(Xn^2/(Xn-Xhn+eps)^2)
    # (`distances/_distances.py:177`): squaring the near-cancelling
    # difference first underflows to exactly 0 in float32 (the reference
    # runs in float64), turning single bins into +inf
    d = torch.log10(Xn + eps) - torch.log10((Xn - Xhn).abs() + eps)
    del Xn, Xhn
    snr_jm = (2.0 * d * W).sum(dim=1)  # (channels, K, F)
    del d
    snr_frame = (10 * snr_jm / W.sum(dim=1)).mean(dim=-1)  # (channels, K)
    return snr_frame.clamp(min=lo, max=hi).mean(dim=-1)


def fw_snr_seg(
    x: Signal,
    xhat: Signal,
    f_range_hz=[20, 10e3],
    snr_range_db=[-10, 35],
    gamma: float = 0.2,
) -> np.ndarray:
    """Frequency-weighted segmental SNR (Hu & Loizou;
    `distances.py:275-369`): the band/frame double loop as one batched
    (channel, band, frame, bin) computation per chunk of channels; all
    channels fetched at once."""
    from scipy.signal import windows

    from ..filterbanks import auditory_filters_gammatone

    assert x.sampling_rate_hz == xhat.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    fs_hz = x.sampling_rate_hz
    assert x.length_samples == xhat.length_samples, (
        "Signal lengths do not match"
    )
    multichannel = False
    if x.number_of_channels != xhat.number_of_channels:
        assert x.number_of_channels == 1, (
            "Invalid number of channels for this measurement"
        )
        multichannel = True
    assert len(f_range_hz) == 2, (
        "Frequency range must have lower and upper bounds"
    )
    f_range = np.sort(np.asarray(f_range_hz))
    assert f_range[1] < fs_hz // 2, (
        f"Upper frequency range {f_range[1]} must be smaller than nyquist "
        f"frequency {fs_hz // 2}"
    )
    assert f_range[0] > 0, "Frequency range must be positive"
    assert len(snr_range_db) == 2, (
        "SNR range must have lower and upper bounds"
    )
    snr_range_db = np.sort(np.asarray(snr_range_db))
    length_samp = int(75e-3 * fs_hz)
    if length_samp % 2 == 1:
        length_samp += 1
    window = windows.hamming(length_samp, sym=False)
    step = len(window) // 2
    assert 0.1 <= gamma <= 2, (
        f"{gamma} is not in the valid range for gamma [0.1, 5]"
    )
    aud_fb = auditory_filters_gammatone(
        frequency_range_hz=f_range, resolution=1, sampling_rate_hz=fs_hz
    )
    x_bands = aud_fb.filter_signal(x, mode=FilterBankMode.Parallel).bands
    xhat_bands = aud_fb.filter_signal(xhat, mode=FilterBankMode.Parallel).bands
    lo, hi = float(snr_range_db[0]), float(snr_range_db[1])

    n_channels = xhat.number_of_channels
    K = -(-x.length_samples // step)
    frame_bytes = len(x_bands) * K * len(window) * x_bands[0]._x.element_size()
    chunk = max(1, FW_CHUNK_BYTES // frame_bytes)
    out = []
    for c0 in range(0, n_channels, chunk):
        c1 = min(c0 + chunk, n_channels)
        xb = torch.stack([b._x[[0] * (c1 - c0)] if multichannel else b._x[c0:c1]
                          for b in x_bands], dim=1)  # (channels, bands, T)
        xhb = torch.stack([b._x[c0:c1] for b in xhat_bands], dim=1)
        out.append(_fwsnrseg_channels(xb, xhb, window, step, gamma, lo, hi))
        del xb, xhb
    return torch.cat(out).double().cpu().numpy()

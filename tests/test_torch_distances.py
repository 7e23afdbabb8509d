"""The port's distance measures (`dsptoolbox_tpu_torch.distances`) against
the JAX package's on the CPU, on the same seeded inputs: the effects
chain's clean bursts and a processed version (denoised, then compressed),
2 channels × 1 s at 16 kHz.

Tolerances, relative: SNR 1e-5; SI-SDR, the log-spectral distance and the
Itakura-Saito measure 1e-4 (the spectral distances also against a float64
numpy Welch and integral, 1e-4); fwSNRseg 1e-3 (100 Hz-4 kHz: its upper
bound must stay below Nyquist)."""

import numpy as np
import pytest
import torch

import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu_torch import _config, distances
from dsptoolbox_tpu_torch.classes import Signal
from dsptoolbox_tpu_torch.tools import effects_chain

torch.set_num_threads(1)

FS = 16000


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


@pytest.fixture(scope="module")
def signals():
    """``(clean, processed)`` as ``(T, C)`` float32 numpy."""
    clean, noisy = effects_chain.inputs(2, 1.0, fs=FS)
    processed = effects_chain.compress(effects_chain.denoise(noisy))
    return clean.time_data.numpy().copy(), processed.time_data.numpy().copy()


def _pair(td):
    return Signal(None, td, FS), jdsp.Signal(None, td, FS)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.mark.parametrize("mono_noise", [False, True])
def test_snr(signals, mono_noise):
    clean, processed = signals
    noise = processed - clean
    if mono_noise:
        noise = noise[:, :1]
    (s, js), (n, jn) = _pair(clean), _pair(noise)
    got, want = distances.snr(s, n), jdsp.distances.snr(js, jn)
    assert got.shape == (2,)
    assert _rel(got, want) <= 1e-5
    f64 = 20 * np.log10(clean.astype(np.float64).std(0) / noise.astype(np.float64).std(0))
    assert _rel(got, f64) <= 1e-9


@pytest.mark.parametrize("mono_target", [False, True])
def test_si_sdr(signals, mono_target):
    clean, processed = signals
    if mono_target:
        clean = clean[:, :1]
    (s, js), (p, jp) = _pair(clean), _pair(processed)
    got, want = distances.si_sdr(s, p), jdsp.distances.si_sdr(js, jp)
    assert got.shape == (2,)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("measure", ["log_spectral", "itakura_saito"])
@pytest.mark.parametrize("case", ["welch", "welch_no_normalization", "fft_amplitude"])
def test_spectral_distances(signals, measure, case):
    clean, processed = signals
    (s, js), (p, jp) = _pair(clean), _pair(processed)
    kw = dict(f_range_hz=[50, 7000])
    if case == "welch_no_normalization":
        kw["energy_normalization"] = False
        kw["spectrum_parameters"] = dict(window_length_samples=512, overlap_percent=75)
    if case == "fft_amplitude":
        from dsptoolbox_tpu_torch._enums import SpectrumMethod, SpectrumScaling

        kw_p = dict(kw, method=SpectrumMethod.FFT,
                    spectrum_parameters=dict(scaling=SpectrumScaling.AmplitudeSpectrum))
        kw_j = dict(kw, method=jdsp.SpectrumMethod.FFT,
                    spectrum_parameters=dict(scaling=jdsp.SpectrumScaling.AmplitudeSpectrum))
    else:
        kw_p = kw_j = kw
    got = getattr(distances, measure)(s, p, **kw_p)
    want = getattr(jdsp.distances, measure)(js, jp, **kw_j)
    assert got.shape == (2,)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("case", ["stereo", "mono_reference"])
def test_fw_snr_seg(signals, case):
    clean, processed = signals
    if case == "mono_reference":
        clean = clean[:, :1]
    (s, js), (p, jp) = _pair(clean), _pair(processed)
    got = distances.fw_snr_seg(s, p, f_range_hz=[100, 4000])
    want = jdsp.distances.fw_snr_seg(js, jp, f_range_hz=[100, 4000])
    assert got.shape == (2,) and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-3


def test_fw_snr_seg_chunks_channels_alike(signals, monkeypatch):
    """One channel a chunk gives the bits of all channels at once."""
    from dsptoolbox_tpu_torch.distances import distances as mod

    clean, processed = signals
    s, p = Signal(None, clean, FS), Signal(None, processed, FS)
    whole = distances.fw_snr_seg(s, p, f_range_hz=[100, 4000])
    monkeypatch.setattr(mod, "FW_CHUNK_BYTES", 1)
    np.testing.assert_allclose(distances.fw_snr_seg(s, p, f_range_hz=[100, 4000]), whole,
                               rtol=1e-6)


def test_checks(signals):
    clean, processed = signals
    s, p = Signal(None, clean, FS), Signal(None, processed, FS)
    with pytest.raises(AssertionError, match="nyquist"):
        distances.fw_snr_seg(s, p, f_range_hz=[100, 8000])
    with pytest.raises(AssertionError, match="Lengths"):
        distances.si_sdr(s, Signal(None, processed[:-5], FS))
    with pytest.raises(AssertionError, match="nyquist"):
        distances.log_spectral(s, p, f_range_hz=[20, 9000])


def _welch64(x, L=1024):
    """The port's Welch (Hann, 50 %, detrended after the window, mean) in
    float64 numpy."""
    from scipy.signal import get_window

    w, step = get_window("hann", L, fftbins=True), L // 2
    K = -(-len(x) // step)
    xp = np.concatenate([x, np.zeros(L - len(x) % step)])
    frames = np.stack([xp[k * step:k * step + L] for k in range(K)]) * w
    frames -= frames.mean(-1, keepdims=True)
    return (np.abs(np.fft.rfft(frames, axis=-1)) ** 2).mean(0)


@pytest.mark.parametrize("f_range", [[20, 8000], [50, 7000]])
def test_spectral_distances_against_float64(signals, f_range):
    from dsptoolbox_tpu_torch.distances.distances import _simpson_weights

    clean, processed = signals
    s, p = Signal(None, clean, FS), Signal(None, processed, FS)
    f = np.fft.rfftfreq(1024, 1 / FS)
    i0, i1 = np.argmin(np.abs(np.asarray(f_range)[:, None] - f[None]), axis=1)
    w = _simpson_weights(f[i0:i1])
    lsd, isd = [], []
    for ch in range(2):
        x = _welch64(clean[:, ch].astype(np.float64))[i0:i1]
        y = _welch64(processed[:, ch].astype(np.float64))[i0:i1]
        x, y = x / x.sum(), y / y.sum()
        lsd.append(np.sqrt(w @ (10 * np.log10(x / y)) ** 2))
        isd.append(w @ (x / y - np.log10(x / y) - 1))
    assert _rel(distances.log_spectral(s, p, f_range_hz=f_range), lsd) <= 1e-4
    assert _rel(distances.itakura_saito(s, p, f_range_hz=f_range), isd) <= 1e-4

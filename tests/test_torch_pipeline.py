"""The port's `pipeline` and `compute_all` against the JAX package's
``dsp.pipeline`` on the CPU (where the port runs the chain eagerly under
`_config.pipeline_context`, through the same in-pipeline branches it
captures on the card), on the same seeded numpy inputs, at the JAX tests'
own tolerances (`tests/test_pipeline.py`): config 2's chain, the
deconvolution with `window_ir`, an LR crossover with `resample`, the
in-pipeline amplitude constraint; the return structures, the signature
keys, the errors, and `regularization_window_traced` on the same bins.
Sizes are small: up to 3 channels × 1.25 s."""

import warnings

import numpy as np
import pytest
import torch

import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu.standard.enums import FilterBankMode as JFilterBankMode
from dsptoolbox_tpu.transfer_functions import _backend as jtf_backend
import dsptoolbox_tpu_torch as dsp
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch._defer import deferral_enabled
from dsptoolbox_tpu_torch.pipeline import (
    _flatten_result,
    _sanitize_spec,
    _signal_signature,
    _window_fingerprint,
)
from dsptoolbox_tpu_torch.transfer_functions import _backend as tf_backend

torch.set_num_threads(1)

FS = 48000
RNG = np.random.default_rng(21)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's classes put numpy data on the default device, "cuda" out
    of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _pink(channels: int, n: int, seed: int = 4, peak: float = 0.5) -> np.ndarray:
    """Pink noise ``(n, channels)`` at ``peak``: white noise shaped by 1/√f
    in the frequency domain."""
    rng = np.random.default_rng(seed)
    W = np.fft.rfft(rng.standard_normal((channels, n)), axis=-1)
    f = np.arange(W.shape[-1], dtype=np.float64)
    f[0] = 1.0
    x = np.fft.irfft(W / np.sqrt(f), n=n, axis=-1).T
    return (peak * x / np.abs(x).max()).astype(np.float32)


def _sweep_and_recording(channels: int = 3):
    """An exponential sweep 20 Hz-20 kHz over 1 s plus 0.25 s of silence,
    and its recording through ``channels`` synthetic room IRs (a direct
    sound at 2-10 ms over decaying noise), in float64 numpy."""
    from scipy.signal import fftconvolve

    rng = np.random.default_rng(8)
    t = np.arange(FS) / FS
    k = np.log(20000 / 20)
    sweep = np.concatenate([np.sin(2 * np.pi * 20 / k * (np.exp(k * t) - 1)), np.zeros(FS // 4)])
    n = 6000
    irs = 1e-3 * rng.standard_normal((n, channels))
    decay = np.exp(-np.log(1e3) * np.arange(n) / (0.1 * FS))
    for c, d in enumerate(rng.integers(96, 480, channels)):
        irs[d, c] += 1.0
        irs[d + 1:, c] += 0.1 * decay[: n - d - 1] * rng.standard_normal(n - d - 1)
    rec = np.stack([fftconvolve(sweep, irs[:, c])[: len(sweep)] for c in range(channels)], 1)
    return sweep.astype(np.float32), rec.astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_config2_chain_matches_jax_pipeline():
    """At a quiet recording's level (peak −40 dBFS), where the JAX test's
    absolute tolerances sit above float32 rounding: the detrended Welch
    DC bins of the spectrum and the CSM round to ~1e-7 of their peaks, and
    the two packages' eager results differ there by that much too."""
    x = _pink(2, FS, peak=0.01)

    def jchain(sig):
        t, f, S = sig.get_spectrogram(force_computation=True)
        y = jdsp.transforms.istft(S, original_signal=sig)
        f2, sp = sig.get_spectrum(force_computation=True)
        f3, C = jdsp.append_signals([sig, y]).get_csm(force_computation=True)
        return y, sp, C

    def chain(sig):
        t, f, S = sig.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=sig)
        f2, sp = sig.get_spectrum(force_computation=True)
        f3, C = dsp.append_signals([sig, y]).get_csm(force_computation=True)
        return y, sp, C

    y0, sp0, C0 = jdsp.pipeline(jchain)(jdsp.Signal(None, x, FS))
    y, sp, C = dsp.pipeline(chain)(dsp.Signal(None, x, FS))
    assert isinstance(y, dsp.Signal)
    assert y.sampling_rate_hz == FS and y.length_samples == FS
    np.testing.assert_allclose(_np(y.time_data), np.asarray(y0.time_data), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(_np(sp), np.asarray(sp0), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(_np(C), np.asarray(C0), rtol=2e-4, atol=1e-7)


def test_deconvolution_and_window_ir_match_jax_pipeline():
    sweep, rec = _sweep_and_recording()

    def jchain(r, c):
        ir = jdsp.transfer_functions.spectral_deconvolve(r, c)
        return jdsp.transfer_functions.window_ir(ir, 2**13, return_device=True)[0]

    def chain(r, c):
        ir = dsp.transfer_functions.spectral_deconvolve(r, c)
        return dsp.transfer_functions.window_ir(ir, 2**13, return_device=True)[0]

    ir0 = jdsp.pipeline(jchain)(jdsp.Signal(None, rec, FS), jdsp.Signal(None, sweep, FS))
    r, c = dsp.Signal(None, rec, FS), dsp.Signal(None, sweep, FS)
    ir = dsp.pipeline(chain)(r, c)
    assert isinstance(ir, dsp.ImpulseResponse)
    np.testing.assert_allclose(_np(ir.time_data), np.asarray(ir0.time_data), rtol=5e-4,
                               atol=2e-5)
    # the window built in the chain travels with the rebuilt IR
    assert torch.is_tensor(ir.window) and tuple(ir.window.shape) == (2**13, 3)
    np.testing.assert_allclose(_np(ir.window), np.asarray(ir0.window), atol=1e-6)
    # the in-program regularization range against the eager one (the host's
    # float64 window): a flank may move by one bin
    eager = chain(r, c)
    scale = float(eager._x.abs().max())
    assert float((ir._x - eager._x).abs().max()) <= 1e-4 * scale


def test_lr_crossover_and_resample_match_jax_pipeline():
    t = np.arange(FS) / FS
    x = np.stack([0.3 * np.sin(2 * np.pi * f * t + p) for f, p in ((90, 0), (700, 1), (3100, 2))],
                 axis=1).sum(axis=1, keepdims=True)
    x = np.concatenate([x, x[::-1]], axis=1).astype(np.float32)
    jfb = jdsp.filterbanks.linkwitz_riley_crossovers([250.0, 1000.0], [4, 4],
                                                     sampling_rate_hz=FS)
    fb = dsp.filterbanks.linkwitz_riley_crossovers([250.0, 1000.0], [4, 4], sampling_rate_hz=FS)

    def jchain(sig):
        return jfb.filter_signal(sig, JFilterBankMode.Parallel), jdsp.resample(sig, FS // 3)

    def chain(sig):
        return fb.filter_signal(sig, dsp.FilterBankMode.Parallel), dsp.resample(sig, FS // 3)

    mb0, r0 = jdsp.pipeline(jchain)(jdsp.Signal(None, x, FS, constrain_amplitude=True))
    mb, r = dsp.pipeline(chain)(dsp.Signal(None, x, FS, constrain_amplitude=True))
    assert isinstance(mb, dsp.MultiBandSignal) and len(mb.bands) == len(mb0.bands) == 3
    assert mb.info["readme"] == mb0.info["readme"]
    np.testing.assert_array_equal(mb.info["filterbank_freqs"], mb0.info["filterbank_freqs"])
    for b, b0 in zip(mb.bands, mb0.bands):
        np.testing.assert_allclose(_np(b.time_data), np.asarray(b0.time_data), rtol=1e-4,
                                   atol=1e-5)
    assert r.sampling_rate_hz == FS // 3
    np.testing.assert_allclose(_np(r.time_data), np.asarray(r0.time_data), rtol=1e-4, atol=1e-5)


def test_amplitude_constraint_runs_in_program():
    """A signal over 0 dBFS is constrained inside the chain with ``min(1,
    1/peak)``: no warning, and the scale factor stays 1, as the JAX
    package's in-trace branch; the 1/3-octave bank's peaks (a bank call on a
    constrained signal) stay on the device."""
    loud = (np.sin(np.linspace(0, 50, 16000)) * 3.0).astype(np.float32)
    j = jdsp.Signal(None, loud, 16000)
    j.constrain_amplitude = True
    p = dsp.Signal(None, loud, 16000)
    p.constrain_amplitude = True

    out0 = jdsp.pipeline(lambda s: jdsp.append_signals([s, s]))(j)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = dsp.pipeline(lambda s: dsp.append_signals([s, s]))(p)
    assert out.amplitude_scale_factor == 1.0
    np.testing.assert_allclose(_np(out.time_data), np.asarray(out0.time_data), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(_np(out.time_data)[:, 0], loud / 3.0, rtol=1e-6, atol=1e-7)

    bank = dsp.filterbanks.fractional_octave_bands([125.0, 4000.0], 3, 4, 16000)[0]
    p2 = dsp.Signal(None, np.stack([loud, loud[::-1]], 1), 16000, constrain_amplitude=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mb = dsp.pipeline(lambda s: bank.filter_signal(s, dsp.FilterBankMode.Parallel))(p2)
    eager = bank.filter_signal(p2, dsp.FilterBankMode.Parallel)
    for b, b0 in zip(mb.bands, eager.bands):
        assert b.amplitude_scale_factor == 1.0
        np.testing.assert_allclose(_np(b.time_data), _np(b0.time_data), rtol=1e-6, atol=1e-7)


def test_structured_returns_and_metadata():
    x = _pink(1, 2**14)
    sig = dsp.Signal(None, x, 24000)

    def chain(s):
        f, sp = s.get_spectrum(force_computation=True)
        return {"sp": sp, "pair": (s.time_data * 2, 3.5), "f": f, "w": dsp.Window.Hann,
                "bands": [dsp.append_signals([s, s])]}

    out = dsp.pipeline(chain)(sig)
    assert torch.is_tensor(out["sp"]) and out["pair"][1] == 3.5 and out["w"] is dsp.Window.Hann
    assert isinstance(out["f"], np.ndarray) and out["f"][-1] == pytest.approx(12000.0)
    np.testing.assert_allclose(_np(out["pair"][0]), x * 2, rtol=1e-6)
    two = out["bands"][0]
    assert isinstance(two, dsp.Signal) and two.number_of_channels == 2
    assert two.sampling_rate_hz == 24000 and two.length_samples == 2**14


def test_signature_keys_on_rate_spectrum_parameters_and_window():
    x = _pink(2, 2**12)
    s48, s16 = dsp.Signal(None, x, 48000), dsp.Signal(None, x, 16000)
    assert _signal_signature(s48) != _signal_signature(s16)
    assert _signal_signature(s48) == _signal_signature(dsp.Signal(None, x * 0.5, 48000))
    before = _signal_signature(s48)
    s48.set_spectrum_parameters(window_length_samples=512)
    assert _signal_signature(s48) != before
    before = _signal_signature(s48)
    s48.set_spectrogram_parameters(overlap_percent=75)
    assert _signal_signature(s48) != before
    ir = dsp.ImpulseResponse(None, x, 48000)
    ir.set_window(torch.ones(2**12, 2))
    fp = _window_fingerprint(ir)
    assert fp == _window_fingerprint(ir)
    ir.window[0, 0] = 0.5  # an in-place change is seen through the version
    assert _window_fingerprint(ir) != fp
    # the JAX package keys the same metadata
    f48, _ = dsp.pipeline(lambda s: s.get_spectrum())(dsp.Signal(None, x, 48000))
    f16, _ = dsp.pipeline(lambda s: s.get_spectrum())(s16)
    assert np.max(f48) == pytest.approx(24000.0) and np.max(f16) == pytest.approx(8000.0)


def test_sanitized_templates_keep_metadata_only():
    sweep, rec = _sweep_and_recording(2)
    ir = dsp.transfer_functions.spectral_deconvolve(dsp.Signal(None, rec, FS),
                                                    dsp.Signal(None, sweep, FS))
    w, _ = dsp.transfer_functions.window_ir(ir, 2**12, return_device=True)
    leaves: list = []
    spec = _flatten_result((w, dsp.append_signals([w, w])), leaves)
    assert len(leaves) == 3  # w's data and window, the appended signal's data
    _sanitize_spec(spec)
    template = spec[1][0][1]
    assert template._x.numel() == 1 and not template._cache and "window" not in template.__dict__


def test_errors():
    sig = dsp.Signal(None, _pink(1, 2**12), FS)
    with pytest.raises(TypeError):
        dsp.pipeline(lambda s: s)(np.zeros(16))
    with pytest.raises(AssertionError):  # the JAX package asserts instead
        jdsp.pipeline(lambda s: s)(np.zeros(16))
    with pytest.raises(TypeError):
        dsp.pipeline(lambda s: s, mesh=object())
    with pytest.raises(TypeError, match="Spectrum"):
        dsp.pipeline(lambda s: dsp.Spectrum.from_signal(s))(sig)


def test_compute_all_returns_its_inputs():
    sig = dsp.Signal(None, _pink(1, 2**12), FS)
    t = torch.ones(3)
    assert dsp.compute_all(sig) is sig
    both = dsp.compute_all(sig, t)
    assert both[0] is sig and both[1] is t
    assert jdsp.compute_all(t) is t  # the JAX package returns its inputs too
    assert deferral_enabled() is False


@pytest.mark.parametrize("first,last", [(120, 120000), (3, 143990), (0, 144000), (500, 501),
                                        (7, 7)])
def test_regularization_window_traced_matches_jax(first, last):
    import jax.numpy as jnp

    F, df = 144001, FS / 288000
    got = tf_backend.regularization_window_traced(
        torch.tensor(first), torch.tensor(last), F, 0.0, df, FS / 2).numpy()
    want = np.asarray(jtf_backend.regularization_window_traced(
        jnp.int32(first), jnp.int32(last), F, 0.0, df, FS / 2))
    assert got.shape == want.shape == (F, 1) and got.dtype == want.dtype
    # a flank one bin off would differ by ~eps/flank length ≫ 1e-5; sin² of
    # the flank's ends rounds to 1 ulp either way
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)

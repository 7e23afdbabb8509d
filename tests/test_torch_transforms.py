"""The port's config-2 path (`Signal.get_spectrogram`, `transforms.istft`,
`ops.framing.reconstruct_framed_signal`, the FFT-method CSM through
`ops.spectral.csm_from_spectrum`, and `tools.speech_chain`: STFT → ISTFT,
Welch spectrum, append, CSM) against the JAX package on the CPU, on the
same seeded numpy inputs, at the JAX package's tolerances (`istft` 1e-5,
`tests/test_transforms.py:108`). Sizes are small: up to 2 channels × 1 s."""

import warnings

import numpy as np
import pytest
import torch

from conftest import assert_close
import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu.ops import framing as jframing
from dsptoolbox_tpu.ops import spectral as jspectral
from dsptoolbox_tpu_torch import _config, standard
from dsptoolbox_tpu_torch.classes import ImpulseResponse, Signal
from dsptoolbox_tpu_torch.ops import cuda_framing, framing, spectral
from dsptoolbox_tpu_torch.standard.enums import SpectrumMethod, SpectrumScaling, Window
from dsptoolbox_tpu_torch.tools import speech_chain
from dsptoolbox_tpu_torch.transforms import istft

torch.set_num_threads(1)
warnings.filterwarnings("ignore", message="Selected window type and overlap")

FS = 48000
RNG = np.random.default_rng(13)
X2 = (0.3 * RNG.standard_normal((FS, 2))).astype(np.float32)

# spectrogram parameters: (kwargs, whether the ISTFT reconstructs the input)
SPECTROGRAMS = [
    (dict(), True),
    (dict(padding=False), False),
    (dict(window_length_samples=512, overlap_percent=75), True),
    (dict(window_length_samples=256, overlap_percent=50, detrend=True), False),
    (dict(overlap_percent=33, fft_length_samples=2048), False),
    (dict(window_type=Window.Hamming, overlap_percent=50), True),
    (dict(scaling=SpectrumScaling.AmplitudeSpectrum), False),  # |S|: the phase is gone
    (dict(scaling=SpectrumScaling.FFTOrthogonal), True),
]


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's classes put numpy data on the default device, "cuda" out
    of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _jax_kwargs(kw):
    """The same spectrogram parameters with the JAX package's enums."""
    out = dict(kw)
    for k, enum in (("window_type", jdsp.Window), ("scaling", jdsp.SpectrumScaling)):
        if k in out:
            out[k] = getattr(enum, out[k].name)
    return out


@pytest.mark.parametrize("case", range(len(SPECTROGRAMS)))
def test_spectrogram_and_istft_match_jax(case):
    kw, reconstructs = SPECTROGRAMS[case]
    s = Signal(None, X2, FS).set_spectrogram_parameters(**kw)
    js = jdsp.Signal(None, X2, FS).set_spectrogram_parameters(**_jax_kwargs(kw))
    t, f, S = s.get_spectrogram()
    jt, jf, jS = js.get_spectrogram()
    jS = np.asarray(jS)
    assert S.shape == jS.shape and S.is_complex()
    np.testing.assert_allclose(t, jt)
    np.testing.assert_allclose(f, jf)
    assert_close(S.numpy(), jS, 2e-5, "stft")
    y = istft(S, original_signal=s)
    jy = jdsp.transforms.istft(jS, original_signal=js)
    assert y.time_data.shape == (FS, 2) and y.sampling_rate_hz == FS
    np.testing.assert_allclose(y.time_data.numpy(), np.asarray(jy.time_data), atol=1e-5)
    if reconstructs:
        np.testing.assert_allclose(y.time_data.numpy(), X2, atol=1e-5)


def test_istft_takes_parameters_or_numpy_and_returns_untrimmed_length():
    s = Signal(None, X2, FS)
    t, f, S = s.get_spectrogram()
    params = dict(s._spectrogram_parameters)
    a = istft(S.numpy(), parameters=params, sampling_rate_hz=FS)
    b = istft(S, sampling_rate_hz=FS, window_length_samples=1024, window_type=Window.Hann,
              overlap_percent=50, padding=True, scaling=SpectrumScaling.FFTBackward)
    ja = jdsp.transforms.istft(
        np.asarray(S), sampling_rate_hz=FS, window_length_samples=1024,
        window_type=jdsp.Window.Hann, overlap_percent=50, padding=True,
        scaling=jdsp.SpectrumScaling.FFTBackward)
    torch.testing.assert_close(a.time_data, b.time_data)
    assert a.time_data.shape == np.asarray(ja.time_data).shape
    np.testing.assert_allclose(a.time_data.numpy(), np.asarray(ja.time_data), atol=1e-5)
    with pytest.raises(AssertionError):
        istft(S, sampling_rate_hz=FS)
    with pytest.raises(AssertionError):
        istft(S[..., 0])


def test_spectrogram_is_cached_on_its_parameters():
    s = Signal(None, X2, FS)
    S1 = s.get_spectrogram()[2]
    assert s.get_spectrogram()[2] is S1
    assert s.get_spectrogram(force_computation=True)[2] is not S1
    S2 = s.get_spectrogram()[2]
    s.set_spectrogram_parameters()  # unchanged: the cache stays
    assert s.get_spectrogram()[2] is S2
    s.set_spectrogram_parameters(window_length_samples=512)
    assert s.get_spectrogram()[2].shape[0] == 257
    s.time_data = X2[:1000]
    assert s.get_spectrogram()[2].shape == (257, 6, 2)
    # the STFT's channels-first tensor, read back without a copy
    assert S2.permute(2, 1, 0).is_contiguous()


def test_spectrogram_masked_in_place_is_not_served_from_the_cache():
    s = Signal(None, X2, FS)
    S = s.get_spectrogram()[2]
    clean = S.clone()
    istft(S, original_signal=s)  # reads S, modifies nothing: the cache stays
    assert s.get_spectrogram()[2] is S
    S[:10] = 0  # the usual reason to take a spectrogram: a mask
    S2 = s.get_spectrogram()[2]
    assert S2 is not S
    torch.testing.assert_close(S2, clean, rtol=0, atol=0)
    assert torch.count_nonzero(S[:10]) == 0  # the caller's tensor is theirs


@pytest.mark.parametrize("wl,step,n", [(1024, 512, 20), (12, 5, 9), (64, 16, 3)])
def test_reconstruct_framed_signal_matches_jax(wl, step, n):
    frames = RNG.standard_normal((2, n, wl)).astype(np.float32)
    win = np.hanning(wl + 1)[:-1]
    T = step * n + wl - step
    np.testing.assert_allclose(framing.window_envelope(win, T, step, n),
                               jframing.window_envelope(win, T, step, n))
    for w, length in ((win, None), (None, None), (win, T - 7), (win, T + 9)):
        got = framing.reconstruct_framed_signal(torch.from_numpy(frames), step, w, length)
        want = jframing.reconstruct_framed_signal(frames, step, w, length)
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize(
    "scaling",
    ["FFTBackward", "FFTForward", "FFTOrthogonal", "AmplitudeSpectrum", "PowerSpectrum",
     "PowerSpectralDensity", "AmplitudeSpectralDensity"],
)
def test_fft_method_csm_matches_jax(scaling):
    x = X2[:4000]
    s = Signal(None, x, FS)
    js = jdsp.Signal(None, x, FS)
    s.set_spectrum_parameters(method=SpectrumMethod.FFT,
                              scaling=getattr(SpectrumScaling, scaling))
    js.set_spectrum_parameters(method=jdsp.SpectrumMethod.FFT,
                               scaling=getattr(jdsp.SpectrumScaling, scaling))
    f, C = s.get_csm()
    # the JAX package's FFT-method CSM fails in its default lazy mode (a
    # lazy spectrum reaches `csm_from_spectrum`): its eager mode
    jdsp._config.set_lazy_host_returns(False)
    try:
        jf, jC = js.get_csm()
    finally:
        jdsp._config.set_lazy_host_returns(None)
    np.testing.assert_allclose(f, jf)
    assert_close(C.numpy(), np.asarray(jC), 2e-5, scaling)
    assert s.spectrum_scaling == getattr(SpectrumScaling, scaling)  # restored
    sp = torch.from_numpy(
        (RNG.standard_normal((65, 3)) + 1j * RNG.standard_normal((65, 3))).astype(np.complex64))
    win = np.hanning(128)
    got = spectral.csm_from_spectrum(sp, getattr(SpectrumScaling, scaling), win, FS)
    want = jspectral.csm_from_spectrum(sp.numpy(), getattr(jdsp.SpectrumScaling, scaling),
                                       win, FS)
    assert_close(got.numpy(), np.asarray(want), 1e-6, f"csm_from_spectrum {scaling}")


def test_fft_csm_of_a_windowed_ir_matches_jax():
    x = (RNG.standard_normal((2048, 3)) * np.exp(-np.arange(2048) / 300)[:, None]).astype(np.float32)
    w = np.tile(np.hanning(2048)[:, None], (1, 3))
    ir = ImpulseResponse(None, x, FS).set_window(w)
    jir = jdsp.ImpulseResponse(None, x, FS)
    jir.set_window(w)
    for obj, sc in ((ir, SpectrumScaling.PowerSpectralDensity),
                    (jir, jdsp.SpectrumScaling.PowerSpectralDensity)):
        obj.set_spectrum_parameters(method=type(obj.spectrum_method).FFT, scaling=sc)
    jdsp._config.set_lazy_host_returns(False)
    try:
        want = np.asarray(jir.get_csm()[1])
    finally:
        jdsp._config.set_lazy_host_returns(None)
    assert_close(ir.get_csm()[1].numpy(), want, 2e-5, "ir csm")


def test_config2_chain_matches_jax():
    """Config 2's call sequence (`tools/bench_suite.py:137-143`) at 2
    channels × 1 s against the JAX package's chain on the same samples."""
    cuda_framing.launches = 0
    sig = speech_chain.signal(2, 1.0)
    assert sig.time_data.shape == (FS, 2)
    y, sp, C = speech_chain.run(sig)
    x = sig.time_data.numpy()
    js = jdsp.Signal(None, x, FS)
    js.set_spectrogram_parameters(window_length_samples=1024)
    _, _, jS = js.get_spectrogram(force_computation=True)
    jy = jdsp.transforms.istft(jS, original_signal=js)
    _, jsp = js.get_spectrum(force_computation=True)
    _, jC = jdsp.append_signals([js, jy]).get_csm(force_computation=True)
    np.testing.assert_allclose(y.time_data.numpy(), np.asarray(jy.time_data), atol=1e-5)
    np.testing.assert_allclose(y.time_data.numpy(), x, atol=1e-5)
    assert sp.shape == (513, 2) and C.shape == (513, 4, 4)
    assert_close(sp.numpy(), np.asarray(jsp), 1e-4, "welch")
    assert_close(C.numpy(), np.asarray(jC), 1e-4, "csm")
    mono = speech_chain.signal(1, 0.25)
    y1, sp1, C1 = speech_chain.run(mono)
    assert sp1.shape == (513,) and C1.shape == (513, 2, 2)
    assert cuda_framing.launches == 0  # CPU tensors take the plain path
    two = standard.append_signals([sig, y])
    assert two.number_of_channels == 4

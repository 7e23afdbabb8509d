"""The port's config-2 path (`Signal.get_spectrogram`, `transforms.istft`,
`ops.framing.reconstruct_framed_signal`, the FFT-method CSM through
`ops.spectral.csm_from_spectrum`, and `tools.speech_chain`: STFT → ISTFT,
Welch spectrum, append, CSM) and the rest of `transforms` (cepstrum, mel,
MFCC, chroma, CWT and synchrosqueezing, VQT, Hilbert, mid/side, Laguerre,
warping through the allpass operator, LPC with its synthesis, the DFT, the
filter-bank spectrum; `tools.feature_chain`) against the JAX package on
the CPU, on the same seeded numpy inputs, at the tolerances of the JAX
package's own tests (`tests/test_transforms.py`), and against float64
scipy/numpy recursions where the JAX package computes in float32. Sizes
are small: up to 2 channels × 1 s."""

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
    t, f, S = s.get_spectrogram(return_device=True)
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
    S1 = s.get_spectrogram(return_device=True)[2]
    assert s.get_spectrogram(return_device=True)[2] is S1
    assert s.get_spectrogram(force_computation=True, return_device=True)[2] is not S1
    S2 = s.get_spectrogram(return_device=True)[2]
    s.set_spectrogram_parameters()  # unchanged: the cache stays
    assert s.get_spectrogram(return_device=True)[2] is S2
    s.set_spectrogram_parameters(window_length_samples=512)
    assert s.get_spectrogram(return_device=True)[2].shape[0] == 257
    s.time_data = X2[:1000]
    assert s.get_spectrogram(return_device=True)[2].shape == (257, 6, 2)
    # the STFT's channels-first tensor, read back without a copy
    assert S2.permute(2, 1, 0).is_contiguous()


def test_spectrogram_masked_in_place_is_not_served_from_the_cache():
    s = Signal(None, X2, FS)
    S = s.get_spectrogram(return_device=True)[2]
    clean = S.clone()
    istft(S, original_signal=s)  # reads S, modifies nothing: the cache stays
    assert s.get_spectrogram(return_device=True)[2] is S
    S[:10] = 0  # the usual reason to take a spectrogram: a mask
    S2 = s.get_spectrogram(return_device=True)[2]
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


# ======== the rest of `transforms` (cepstrum … filter-bank spectrum) =======
from scipy.signal import hilbert as scipy_hilbert  # noqa: E402
from scipy.signal import lfilter, sosfilt, sosfiltfilt  # noqa: E402

from dsptoolbox_tpu import transforms as jtf  # noqa: E402
from dsptoolbox_tpu.transforms import _backend as jtb  # noqa: E402
from dsptoolbox_tpu_torch import transforms as tf  # noqa: E402
from dsptoolbox_tpu_torch.classes import Filter, MultiBandSignal  # noqa: E402
from dsptoolbox_tpu_torch.helpers.ar_estimation import burg_ar  # noqa: E402
from dsptoolbox_tpu_torch.standard.enums import FilterPassType  # noqa: E402
from dsptoolbox_tpu_torch.tools import feature_chain  # noqa: E402
from dsptoolbox_tpu_torch.transforms import _backend as tb  # noqa: E402

FS16 = 16000
_t = np.arange(2**14) / FS16
# a chirp with noise: the JAX package's tests run `chirp_mono.wav`
CHIRP = (0.3 * np.sin(2 * np.pi * (200 + 2000 * _t) * _t)[:, None]
         + 0.05 * RNG.standard_normal((2**14, 2))).astype(np.float32)
CHIRP[:, 1] *= 0.5
IR = np.zeros((2048, 2), np.float32)
IR[30] = 1.0
IR += (0.3 * RNG.standard_normal((2048, 2)) * np.exp(-np.arange(2048) / 200)[:, None]
       ).astype(np.float32)


def _pair(x=CHIRP, fs=FS16, cls="Signal"):
    return getattr(jdsp, cls)(None, x, fs), (Signal if cls == "Signal" else ImpulseResponse)(
        None, x, fs)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("complex_", [True, False])
def test_cepstrum_matches_jax_and_round_trips(complex_):
    js, s = _pair()
    c = tf.cepstrum(s, complex_)
    assert isinstance(c, np.ndarray) and c.shape == CHIRP.shape
    assert_close(c, np.asarray(jtf.cepstrum(js, complex_)), 1e-3, "cepstrum")
    if complex_:
        rec = tf.from_complex_cepstrum(c, FS16)
        np.testing.assert_allclose(rec.time_data.numpy(), CHIRP, atol=1e-4)
        rec_t = tf.from_complex_cepstrum(torch.from_numpy(c), FS16)
        torch.testing.assert_close(rec_t.time_data, rec.time_data)


@pytest.mark.parametrize("rng_hz,n_bands,norm",
                         [(None, 30, False), ([1e3, 5e3], 10, False), (None, 30, True)])
def test_mel_filterbank_matches_jax(rng_hz, n_bands, norm):
    f = np.linspace(0, 24000, 2048)
    w, c = tf.mel_filterbank(f, rng_hz, n_bands=n_bands, normalize=norm)
    jw, jc = jtf.mel_filterbank(f, rng_hz, n_bands=n_bands, normalize=norm)
    np.testing.assert_allclose(w, np.asarray(jw), atol=1e-10)
    np.testing.assert_allclose(c, jc, atol=1e-8)


@pytest.mark.parametrize("stft", [None, dict(window_length_samples=512, overlap_percent=75)])
def test_log_mel_spectrogram_matches_jax(stft):
    js, s = _pair()
    t, f, sp = tf.log_mel_spectrogram(s, n_bands=40, generate_plot=False, stft_parameters=stft)
    jt, jf, jsp = jtf.log_mel_spectrogram(js, n_bands=40, generate_plot=False,
                                          stft_parameters=stft)
    jsp = np.asarray(jsp)
    np.testing.assert_allclose(t, jt)
    np.testing.assert_allclose(f, jf, atol=1e-8)
    assert sp.shape == jsp.shape and isinstance(sp, np.ndarray)
    valid = jsp > -300  # bins under float32's range (tests/test_transforms.py:74)
    assert np.abs(sp[valid] - jsp[valid]).max() < 0.1
    with pytest.raises(AssertionError):
        tf.log_mel_spectrogram(s, range_hz=[20, 30e3], n_bands=10, generate_plot=False)


def test_mfcc_and_chroma_match_jax():
    js, s = _pair()
    t, mel, mf = tf.mfcc(s, generate_plot=False)
    jt, jmel, jmf = jtf.mfcc(js, generate_plot=False)
    jmf = np.asarray(jmf)
    np.testing.assert_allclose(t, jt)
    np.testing.assert_allclose(mel, jmel)
    logmel = np.asarray(jtf.log_mel_spectrogram(js, n_bands=40, generate_plot=False)[2])
    valid = np.all(logmel > -300, axis=0)[..., 0]  # tests/test_transforms.py:91
    assert valid.sum() > 10
    assert _rel(mf[:, valid], jmf[:, valid]) < 1e-3
    own = tf.mel_filterbank(np.fft.rfftfreq(1024, 1 / FS16), None, 40)[0]
    t2, mel2, mf2 = tf.mfcc(s, mel_filters=own, generate_plot=False)
    np.testing.assert_allclose(mel2, [0, 40])
    np.testing.assert_allclose(mf2, mf, rtol=1e-6, atol=1e-6)
    t, chroma, pitch = tf.chroma_stft(s)
    jt, jchroma, jpitch = jtf.chroma_stft(js)
    assert chroma.shape == (12, len(t), 2) and pitch.shape == (128, len(t), 2)
    assert _rel(chroma, np.asarray(jchroma)) < 1e-3
    assert _rel(pitch, np.asarray(jpitch)) < 1e-3


def test_power_spectrogram_takes_the_fft_lengths_frequencies():
    """With ``fft_length_samples`` above the window the power spectrogram's
    grid is the FFT length's: the port's mel, MFCC and chroma features run
    (the JAX package's grid is the window's, and its mel projection fails
    on the shapes), and agree with the same projections of a float64 numpy
    power STFT."""
    js, s = _pair()
    params = dict(window_length_samples=512, fft_length_samples=1024)
    s.set_spectrogram_parameters(**params)
    js.set_spectrogram_parameters(**params)
    t, f, P = s._get_power_spectrogram_device()
    assert P.shape[0] == len(f) == 513
    np.testing.assert_allclose(f, np.fft.rfftfreq(1024, 1 / FS16))
    assert s._get_power_spectrogram_device()[2] is P  # cached with the STFT
    S = s.get_spectrogram(return_device=True)[2]
    torch.testing.assert_close(P, S.abs() ** 2, rtol=1e-5, atol=1e-9)
    with pytest.raises(Exception):
        jtf.log_mel_spectrogram(js, generate_plot=False)
    _, f_mel, sp = tf.log_mel_spectrogram(s, generate_plot=False)
    mfilt = tf.mel_filterbank(f, None, 40)[0]
    want = 10 * np.log10(np.maximum(np.einsum("bf,fkc->bkc", mfilt,
                                              np.abs(S.numpy().astype(np.complex128)) ** 2),
                                    np.finfo(np.float32).tiny))
    valid = want > -300
    assert np.abs(sp[valid] - want[valid]).max() < 0.1
    # the JAX package's chroma rebuilds the grid itself (transforms.py:453-461)
    assert _rel(tf.chroma_stft(s)[1], np.asarray(jtf.chroma_stft(js)[1])) < 1e-3
    # a spectrogram masked in place is not served from the cache
    S[:10] = 0
    assert s._get_power_spectrogram_device()[2] is not P


@pytest.mark.parametrize("channel", [None, 1])
def test_cwt_matches_jax(channel):
    js, s = _pair(CHIRP[:8192])
    qf = np.linspace(100, 200, 10)
    got = tf.cwt(s, qf, tf.MorletWavelet(b=None, h=3, step=1e-3), channel)
    want = jtf.cwt(js, qf, jtf.MorletWavelet(b=None, h=3, step=1e-3), channel)
    assert isinstance(got, np.ndarray) and got.shape == np.asarray(want).shape
    assert_close(np.abs(got), np.abs(np.asarray(want)), 2e-4, "cwt")
    dev = tf.cwt(s, qf, tf.MorletWavelet(b=None, h=3, step=1e-3), channel, return_device=True)
    assert torch.is_tensor(dev)
    np.testing.assert_allclose(dev.numpy(), got, atol=1e-7)


@pytest.mark.parametrize("normalize", [False, True])
def test_synchrosqueezing_matches_jax_on_one_scalogram(normalize):
    """The reassignment's nearest bins and its ±5 % window are decisions:
    on the same scalogram the port and the JAX package take the same ones.
    (From their own float32 CWTs, 4e-7 apart, cells near a decision's edge
    may go to another bin.) The fused form equals the two-stage one."""
    js, s = _pair(CHIRP[:4096])
    qf = np.linspace(100, 2000, 10)
    scal = np.asarray(jtf.cwt(js, qf, jtf.MorletWavelet(b=None, h=3, step=1e-3), None))
    got = tb.squeeze_scalogram(scal, qf, FS16, apply_frequency_normalization=normalize)
    want = np.asarray(jtb.squeeze_scalogram(scal, qf, FS16,
                                            apply_frequency_normalization=normalize))
    assert isinstance(got, np.ndarray)
    assert_close(got, want, 1e-6, "squeeze")
    mor = tf.MorletWavelet(b=None, h=3, step=1e-3)
    fused = tf.cwt(s, qf, mor, None, synchrosqueezed=True,
                   apply_synchrosqueezed_normalization=normalize)
    two_stage = tb.squeeze_scalogram(tf.cwt(s, qf, mor, None), qf, FS16,
                                     apply_frequency_normalization=normalize)
    np.testing.assert_allclose(fused, two_stage, atol=1e-6)


def test_vqt_matches_jax():
    js, s = _pair(CHIRP[:8192])
    f, v = tf.vqt(s, octaves=[2, 4])
    jf, jv = jtf.vqt(js, octaves=[2, 4])
    np.testing.assert_allclose(f, jf)
    assert v.shape == np.asarray(jv).shape
    assert _rel(np.abs(v), np.abs(np.asarray(jv))) < 2e-3
    f1, v1 = tf.vqt(s, channel=0, octaves=[2, 4], return_device=True)
    np.testing.assert_allclose(v1.numpy(), v[..., :1], atol=1e-7)


@pytest.mark.parametrize("trim", [0, 1])
def test_hilbert_matches_scipy(trim):
    s = Signal(None, CHIRP[: len(CHIRP) - trim], FS16)
    out = tf.hilbert(s)
    got = out.time_data.numpy() + 1j * out.time_data_imaginary.numpy()
    np.testing.assert_allclose(got, scipy_hilbert(CHIRP[: len(CHIRP) - trim], axis=0),
                               atol=1e-4)
    mb = MultiBandSignal([s, s.copy()])
    bands = tf.hilbert(mb).bands
    assert len(bands) == 2 and all(b.is_complex_signal for b in bands)
    torch.testing.assert_close(bands[1].time_data_imaginary, out.time_data_imaginary)
    with pytest.raises(TypeError):
        tf.hilbert(CHIRP)


def test_stereo_mid_side_matches_jax_and_round_trips():
    js, s = _pair()
    ms = tf.stereo_mid_side(s, True)
    np.testing.assert_allclose(ms.time_data.numpy(),
                               np.asarray(jtf.stereo_mid_side(js, True).time_data), atol=1e-7)
    np.testing.assert_allclose(tf.stereo_mid_side(ms, False).time_data.numpy(), CHIRP,
                               atol=1e-6)
    with pytest.raises(AssertionError):
        tf.stereo_mid_side(s.get_channels(0), True)


def test_laguerre_matches_jax():
    js, s = _pair(CHIRP[:128])
    out = tf.laguerre(s, -0.7)
    assert out.time_data.shape == (128, 2)
    assert_close(out.time_data.numpy(), np.asarray(jtf.laguerre(js, -0.7).time_data), 1e-4,
                 "laguerre")
    with pytest.raises(AssertionError):
        tf.laguerre(s, 1.0)


@pytest.mark.parametrize("factor,shift", [(-0.6, True), (0.6, False)])
def test_warp_matches_jax(factor, shift):
    jir, ir = _pair(IR, cls="ImpulseResponse")
    out = tf.warp(ir, factor, shift, 2**8)
    assert isinstance(out, ImpulseResponse) and out.time_data.shape == (256, 2)
    assert_close(out.time_data.numpy(),
                 np.asarray(jtf.warp(jir, factor, shift, 2**8).time_data), 5e-4, "warp")


@pytest.mark.parametrize("scale", ["bark", "bark-", "erb", "erb-"])
def test_warp_scales_match_jax(scale):
    jir, ir = _pair(IR, cls="ImpulseResponse")
    out, lam = tf.warp(ir, scale, False, 2**7)
    jout, jlam = jtf.warp(jir, scale, False, 2**7)
    np.testing.assert_allclose(lam, jlam)
    assert_close(out.time_data.numpy(), np.asarray(jout.time_data), 5e-4, f"warp {scale}")


def _allpass_recursions(x, lam):
    """The JAX package's two scans in float64 with scipy's lfilter: warping
    Σₙ x[n]·Aⁿδ, and the transpose, output k the last sample of Aᵏ applied
    to the reversed x."""
    T = len(x)
    d = np.zeros(T)
    d[0] = 1.0
    warped = d[:, None] * x[0][None]
    for n in range(1, T):
        d = lfilter([-lam, 1.0], [1.0, -lam], d)
        warped = warped + d[:, None] * x[n][None]
    cur = x[::-1].T.copy()
    rows = [cur[:, -1]]
    for _ in range(1, T):
        cur = lfilter([-lam, 1.0], [1.0, -lam], cur, axis=-1)
        rows.append(cur[:, -1])
    return warped, np.array(rows)


@pytest.mark.parametrize("lam", [0.7, -0.76])
def test_allpass_operator_matches_float64_recursion(lam):
    """The doubling allpass operator (D·x for `warp`, Dᵀ·v for `laguerre`)
    against the float64 recursions of the JAX package's scans at T = 1024,
    for both signs of λ and several tile widths, and in float32 at float32's
    rounding of the result."""
    x = RNG.standard_normal((1024, 2))
    warped, transposed = _allpass_recursions(x, lam)
    xt = torch.from_numpy(x)
    for tile in (None, 1, 16, 1024):
        assert_close(tb.allpass_apply(xt, lam, tile).numpy(), warped, 1e-12, "D·x")
        assert_close(tb.allpass_apply_t(xt, lam, tile).numpy(), transposed, 1e-12, "Dᵀ·v")
    got32 = tb.allpass_apply(xt.float(), lam)
    assert got32.dtype == torch.float32
    assert_close(got32.numpy(), warped, 1e-6, "D·x float32")


@pytest.mark.parametrize("factor", [-0.6, 0.6])
def test_warp_filter_matches_jax(factor):
    f = Filter.iir_filter(3, 100.0, FilterPassType.Highpass, 24000)
    jf = jdsp.Filter.iir_filter(3, 100.0, type_of_pass=jdsp.FilterPassType.Highpass,
                                filter_design_method=jdsp.IirDesignMethod.Butterworth,
                                sampling_rate_hz=24000)
    got = tf.warp_filter(f, factor).get_ir(256, device="cpu").time_data.numpy()
    want = np.asarray(jtf.warp_filter(jf, factor).get_ir(256).time_data)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("burg", [False, True])
def test_lpc_matches_jax(burg):
    js, s = _pair()
    a, var = tf.lpc(s, 10, 1024, False, burg, 512)
    ja, jvar = jtf.lpc(js, 10, 1024, False, burg, 512)
    assert isinstance(a, np.ndarray) and a.shape == (11, 32, 2) and var.shape == (32, 2)
    ja = np.asarray(ja)[: a.shape[0]]  # the reference's Burg over-allocates its rows
    assert _rel(a, ja) < 5e-3
    assert _rel(var, np.asarray(jvar)) < 5e-3


def test_lpc_synthesis_matches_scipy_lfilter():
    """Every frame's all-pole filter (Newton's doubling of 1/a, one batched
    FFT convolution) against scipy's float64 lfilter on the same source,
    on AR fits of noise and of resonant frames; and `lpc`'s synthesis: the
    same noise from the same seed, filtered by scipy and overlap-added as
    the reference does."""
    frames = RNG.standard_normal((512, 40, 2))
    frames[:, :20] = lfilter([1.0], [1.0, -1.8, 0.95], frames[:, :20], axis=0)
    a, _ = burg_ar(frames, 16)
    src = RNG.standard_normal((2, 40, 512))
    got = tf.transforms.allpole_frames(torch.from_numpy(a).permute(2, 1, 0),
                                       torch.from_numpy(src)).numpy()
    want = np.stack([[lfilter([1.0], a[:, k, c], src[c, k]) for k in range(40)]
                     for c in range(2)])
    assert_close(got, want, 1e-10, "all-pole frames")
    s = Signal(None, CHIRP, FS16)
    out = tf.lpc(s, 10, 512, True, True, 256, seed=7)
    out2 = tf.lpc(s, 10, 512, True, True, 256, seed=7)
    torch.testing.assert_close(out.time_data, out2.time_data)
    assert out.time_data.shape == CHIRP.shape and out.sampling_rate_hz == FS16
    a, var = tf.lpc(s, 10, 512, False, True, 256)
    gen = torch.Generator().manual_seed(7)
    noise = torch.randn((2, a.shape[1], 512), generator=gen, dtype=torch.float64).numpy()
    src = noise * np.sqrt(np.maximum(var, 0)).T[..., None]
    synth = np.stack([[lfilter([1.0], a[:, k, c], src[c, k]) for k in range(a.shape[1])]
                      for c in range(2)])
    win = np.hanning(513)[:-1]
    rec = jframing.reconstruct_framed_signal(synth.astype(np.float32), 256, win, len(CHIRP))
    rec = np.asarray(rec).T
    if np.abs(rec).max() > 1:  # `Signal.from_time_data` constrains the amplitude
        rec = rec / np.abs(rec).max()
    assert_close(out.time_data.numpy(), rec, 1e-5, "lpc synthesis")


def test_dft_matches_fft_bins_and_keeps_its_precision_with_length():
    s = Signal(None, CHIRP[:20000, :1], FS16)
    s.spectrum_method = SpectrumMethod.FFT
    f, sp = s.get_spectrum()
    got = tf.dft(s, np.asarray(f[20:40]))
    assert isinstance(got, np.ndarray) and got.shape == (20, 1)
    np.testing.assert_allclose(got, np.asarray(sp)[20:40], atol=1e-3)
    rng = np.random.default_rng(44)  # tests/test_transforms.py:349-368
    for T in (4800, 480000):
        x = rng.standard_normal((T, 1))
        f_norm = np.array([100.0, 999.5, 9999.25]) * T / 48000
        got = tb.dft_core(torch.as_tensor(x, dtype=torch.float32), f_norm).numpy()
        n = np.arange(T)
        want = np.stack([np.sum(np.exp(-2j * np.pi * f * n / T) * x[:, 0])
                         for f in f_norm])[:, None]
        assert _rel(got, want) < 2e-4, T
        jgot = np.asarray(jtb.dft_core(x.astype(np.float32), f_norm))
        assert _rel(got, jgot) < 2e-4, T


@pytest.mark.parametrize("zero_phase", [False, True])
def test_spectrum_via_filterbank_matches_jax_and_scipy(zero_phase):
    js, s = _pair(CHIRP[:12000])
    freqs = np.asarray([500, 550, 1000])
    sp = tf.spectrum_via_filterbank(s, freqs, None, 20.0, 8, zero_phase)
    jsp = jtf.spectrum_via_filterbank(js, freqs, None, 20.0, 8, zero_phase)
    np.testing.assert_allclose(sp.frequency_vector_hz, jsp.frequency_vector_hz)
    assert sp.spectral_data.shape == (3, 2)
    assert_close(sp.spectral_data.numpy(), np.asarray(jsp.spectral_data), 1e-3, "spectrum")
    # float64 scipy on the same bands (the JAX package's float32 IIR is no
    # oracle on narrow bands, ROADMAP C3)
    x64 = CHIRP[:12000].astype(np.float64)
    run = sosfiltfilt if zero_phase else sosfilt
    want = np.stack([run(Filter.iir_filter(8, [f - 10, f + 10], FilterPassType.Bandpass,
                                           FS16).sos, x64, axis=0).std(axis=0)
                     for f in freqs])
    assert_close(sp.spectral_data.numpy(), want, 1e-4, "spectrum vs scipy")
    with pytest.raises(AssertionError):
        tf.spectrum_via_filterbank(s, freqs)


def test_feature_chain_matches_jax_at_a_small_size():
    """`tools.feature_chain`'s steps at 2 channels × 1 s (the session),
    0.5 s of the music signal and 8192-sample IRs: each output against the
    JAX package's call on the same samples, at its test's tolerance."""
    cuda_framing.launches = 0
    session = speech_chain.signal(2, 1.0)
    music = feature_chain.music(seconds=0.5)
    lpc_sig = feature_chain.lpc_signal(session)
    rng = np.random.default_rng(0)
    irx = (0.3 * rng.standard_normal((8192, 2)) * np.exp(-np.arange(8192) / 800)[:, None]
           ).astype(np.float32)
    irs = ImpulseResponse(None, irx, FS)
    out = feature_chain.run(session, music, lpc_sig, irs)
    assert cuda_framing.launches == 0  # CPU tensors take the plain path
    js = jdsp.Signal(None, session.time_data.numpy(), FS)
    js.set_spectrogram_parameters(window_length_samples=1024)
    jm = jdsp.Signal(None, music.time_data.numpy(), feature_chain.MUSIC_FS)
    jl = jdsp.Signal(None, lpc_sig.time_data.numpy(), feature_chain.LPC_FS)
    jir = jdsp.ImpulseResponse(None, irx, FS)
    want = out["(a) log_mel_spectrogram"][2]
    jwant = np.asarray(jtf.log_mel_spectrogram(js, n_bands=40, generate_plot=False)[2])
    assert np.abs(want - jwant)[jwant > -300].max() < 0.1
    assert _rel(out["(a) chroma_stft"][1], np.asarray(jtf.chroma_stft(js)[1])) < 1e-3
    assert_close(out["(a) dft at 31 third-octave centres"],
                 np.asarray(jtf.dft(js, feature_chain.THIRD_OCTAVES)), 1e-3, "dft")
    # the filter-bank spectra against float64 scipy from 100 Hz (the JAX
    # package's float32 bank is no oracle on low bands, ROADMAP C3)
    x64 = session.time_data.numpy().astype(np.float64)
    factor = 2 ** (1 / 6)
    for name, run in (("", sosfilt), (", zero phase", sosfiltfilt)):
        got = out["(b) spectrum_via_filterbank" + name].spectral_data.numpy()
        assert got.shape == (31, 2)
        for b, fc in enumerate(feature_chain.THIRD_OCTAVES):
            if fc >= 100:
                sos = Filter.iir_filter(8, [fc / factor, fc * factor],
                                        FilterPassType.Bandpass, FS).sos
                assert_close(got[b], run(sos, x64, axis=0).std(axis=0), 1e-4,
                             f"band {fc:.0f} Hz{name}")
    mor = jtf.MorletWavelet(b=None, h=feature_chain.CWT_H, step=feature_chain.CWT_STEP)
    cw = out["(c) cwt"].numpy()
    assert_close(np.abs(cw), np.abs(np.asarray(jtf.cwt(jm, feature_chain.CWT_FREQUENCIES,
                                                       mor, None))), 2e-4, "cwt")
    f, v = out["(c) vqt"]
    assert _rel(np.abs(v.numpy()), np.abs(np.asarray(jtf.vqt(jm)[1]))) < 2e-3
    a = out["(d) lpc, Burg"][0]
    ja = np.asarray(jtf.lpc(jl, 16, 512, False, True, 256)[0])[: a.shape[0]]
    assert _rel(a, ja) < 5e-3
    w, lam = out["(e) warp bark, 4096 samples"]
    jw, jlam = jtf.warp(jir, "bark", False, 4096)
    assert lam == jlam
    assert_close(w.time_data.numpy(), np.asarray(jw.time_data), 5e-4, "warp")
    assert out["(e) warp bark, whole IR"][0].time_data.shape == (8192, 2)
    assert out["(e) laguerre -0.7, 4096 samples"].time_data.shape == (4096, 2)

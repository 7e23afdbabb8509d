"""The port's `standard` module (`dsptoolbox_tpu_torch.standard`: gain and
level, latency and delays, the activity detector, detrending, envelopes,
dither, filter merging, pad/trim, filter resampling, appending) and the
class surface it needs (`Filter.biquad`, `Signal`'s channel methods,
`Spectrum` interpolation) against the JAX package on the CPU, on the same
seeded numpy inputs, at the tolerances of the JAX package's own tests
(`tests/test_standard.py`). Sizes are small: up to a few seconds, 1-5
channels."""

import warnings

import numpy as np
import pytest
import torch
from scipy.signal import butter, sosfiltfilt

from conftest import assert_close
import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu_torch import _config, generators, standard
from dsptoolbox_tpu_torch.classes import Filter, FilterBank, MultiBandSignal, Signal, Spectrum
from dsptoolbox_tpu_torch.classes.filter_helpers import biquad_coefficients
from dsptoolbox_tpu_torch.helpers.smoothing import get_smoothing_factor_ema
from dsptoolbox_tpu_torch.ops import cuda_framing, cuda_iir
from dsptoolbox_tpu_torch.standard import backend
from dsptoolbox_tpu_torch.standard.enums import (
    BiquadEqType,
    FadeType,
    FilterCoefficientsType,
    FilterPassType,
    IirDesignMethod,
    InterpolationDomain,
    InterpolationEdgeHandling,
    SpectrumType,
)

torch.set_num_threads(1)
warnings.filterwarnings("ignore", message="Padding has been performed")
warnings.filterwarnings("ignore", message="Trimming has been performed")

FS = 44100
RNG = np.random.default_rng(21)
X3 = (0.2 * RNG.standard_normal((FS, 3))).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's classes put numpy data on the default device, "cuda" out
    of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _pair(x, fs=FS):
    """The same numpy data as a port Signal and a JAX Signal."""
    return Signal(None, x, fs), jdsp.Signal(None, x, fs)


def _np(td):
    return td.numpy() if torch.is_tensor(td) else np.asarray(td)


# ======== enums and designs =================================================
@pytest.mark.parametrize(
    "name",
    ["BiquadEqType", "MagnitudeNormalization", "InterpolationDomain",
     "InterpolationScheme", "InterpolationEdgeHandling"],
)
def test_new_enums_match_jax(name):
    assert [m.name for m in getattr(standard, name)] == [
        m.name for m in getattr(jdsp.standard, name)
    ]


@pytest.mark.parametrize("eq", [m.name for m in BiquadEqType])
def test_biquad_matches_jax(eq):
    got = Filter.biquad(getattr(BiquadEqType, eq), 1200.0, -4.5, 0.8, FS)
    want = jdsp.Filter.biquad(getattr(jdsp.BiquadEqType, eq), 1200.0, -4.5, 0.8, FS)
    np.testing.assert_array_equal(got.ba[0], want.ba[0])
    np.testing.assert_array_equal(got.ba[1], want.ba[1])
    b, a = biquad_coefficients(getattr(BiquadEqType, eq), FS, 1200.0, -4.5, 0.8)
    np.testing.assert_array_equal(b, got.ba[0])
    for mode in ("Sos", "Ba", "Zpk"):
        g = got.get_coefficients(getattr(FilterCoefficientsType, mode))
        w = want.get_coefficients(getattr(jdsp.FilterCoefficientsType, mode))
        for gi, wi in zip(g, w):
            np.testing.assert_allclose(np.asarray(gi), np.asarray(wi), atol=1e-12)


def test_merge_filters_and_resample_filter_match_jax():
    f1 = Filter.biquad(BiquadEqType.Allpass, 500.0, 5.0, 0.7, FS)
    j1 = jdsp.Filter.biquad(jdsp.BiquadEqType.Allpass, 500.0, 5.0, 0.7, FS)
    iir = standard.merge_filters([f1, f1.copy(), Filter.iir_filter(4, 800.0, FilterPassType.Lowpass, FS)])
    jiir = jdsp.merge_filters([j1, j1.copy(), jdsp.Filter.iir_filter(4, 800.0, jdsp.FilterPassType.Lowpass, FS)])
    np.testing.assert_allclose(iir.sos, jiir.sos, atol=1e-12)
    taps = RNG.standard_normal((2, 17))
    fir = standard.merge_filters([Filter.from_ba(t, [1.0], FS) for t in taps])
    jfir = jdsp.merge_filters([jdsp.Filter.from_ba(t, [1.0], FS) for t in taps])
    np.testing.assert_allclose(fir.ba[0], jfir.ba[0], atol=1e-12)
    assert fir.is_fir and iir.sos.shape == (4, 6)
    with pytest.raises(AssertionError):
        standard.merge_filters([f1])
    f = Filter.iir_filter(5, 500, FilterPassType.Lowpass, 48000, IirDesignMethod.Bessel)
    jf = jdsp.Filter.iir_filter(5, 500, jdsp.FilterPassType.Lowpass, 48000,
                                jdsp.IirDesignMethod.Bessel)
    got, want = standard.resample_filter(f, 24000), jdsp.resample_filter(jf, 24000)
    assert got.sampling_rate_hz == want.sampling_rate_hz == 24000
    np.testing.assert_allclose(got.sos, want.sos, atol=1e-10)


# ======== Signal's channel surface ==========================================
def test_signal_channel_methods_match_jax():
    s, js = _pair(X3[:2000])
    for got, want in (
        (s.get_channels([2, 0]), js.get_channels([2, 0])),
        (s.get_channels(1), js.get_channels(1)),
        (s.sum_channels(), js.sum_channels()),
        (s.copy().swap_channels([1, 2, 0]), js.copy().swap_channels([1, 2, 0])),
        (s.copy().remove_channel(-1), js.copy().remove_channel(-1)),
        (s.copy().remove_channel(0), js.copy().remove_channel(0)),
    ):
        assert_close(_np(got.time_data), np.asarray(want.time_data), 1e-6, "channels")
    with pytest.raises(IndexError):
        s.get_channels(3)
    with pytest.raises(AssertionError):
        s.copy().swap_channels([0, 0, 1])
    extra = X3[:1500, :2]
    got = s.copy().add_channel(None, extra, FS)
    want = js.copy().add_channel(None, extra, FS)
    np.testing.assert_array_equal(_np(got.time_data), np.asarray(want.time_data))
    with pytest.raises(AttributeError):
        s.copy().add_channel(None, extra, FS, allow_padding_trimming=False)
    assert len(s) == 2000 and s.length_samples == 2000
    cplx = Signal(None, X3[:500, :2] + 1j * X3[500:1000, :2], FS)
    both = cplx.copy().add_channel(None, X3[:500, 2], FS)
    assert both.is_complex_signal and both.number_of_channels == 3
    np.testing.assert_array_equal(both.time_data_imaginary[:, 2].numpy(), 0.0)
    torch.testing.assert_close(cplx.sum_channels().time_data_imaginary[:, 0],
                               cplx.time_data_imaginary.sum(1))


# ======== gain and level ====================================================
@pytest.mark.parametrize("peak", [True, False])
@pytest.mark.parametrize("each_channel", [True, False])
def test_normalize_matches_jax(peak, each_channel):
    s, js = _pair(X3)
    got = standard.normalize(s, -12.0, peak, each_channel)
    want = jdsp.normalize(js, -12.0, peak, each_channel)
    np.testing.assert_allclose(_np(got.time_data), np.asarray(want.time_data), atol=1e-6)


@pytest.mark.parametrize("kind", ["Linear", "Exponential", "Logarithmic"])
@pytest.mark.parametrize("where", [(True, False), (False, True), (True, True)])
def test_fade_matches_jax(kind, where):
    s, js = _pair(X3)
    got = standard.fade(s, getattr(FadeType, kind), None, *where)
    want = jdsp.fade(js, getattr(jdsp.FadeType, kind), None, *where)
    np.testing.assert_allclose(_np(got.time_data), np.asarray(want.time_data), atol=1e-6)
    got = standard.fade(s, getattr(FadeType, kind), 0.1, *where)
    want = jdsp.fade(js, getattr(jdsp.FadeType, kind), 0.1, *where)
    np.testing.assert_allclose(_np(got.time_data), np.asarray(want.time_data), atol=1e-6)


def test_levels_match_jax():
    s, js = _pair(X3)
    np.testing.assert_allclose(standard.rms(s, False), jdsp.rms(js, False), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(standard.rms(s), jdsp.rms(js), atol=1e-4)
    np.testing.assert_allclose(standard.rms(s, False)[0],
                               np.sqrt(np.mean(X3[:, 0].astype(np.float64) ** 2)), atol=1e-6)
    tp, pk = standard.true_peak_level(s)
    jtp, jpk = jdsp.true_peak_level(js)
    np.testing.assert_allclose(tp, jtp, atol=1e-4)
    np.testing.assert_allclose(pk, jpk, atol=1e-5)
    assert np.all(tp >= pk - 1e-4)
    for tpk in (False, True):
        np.testing.assert_allclose(standard.crest_factor(s, True, tpk),
                                   jdsp.crest_factor(js, True, tpk), atol=1e-4)
    mb = MultiBandSignal([s.get_channels([0, 1]), s.get_channels([1, 2])])
    jmb = jdsp.MultiBandSignal([js.get_channels([0, 1]), js.get_channels([1, 2])])
    np.testing.assert_allclose(standard.rms(mb), jdsp.rms(jmb), atol=1e-4)
    np.testing.assert_allclose(standard.crest_factor(mb), jdsp.crest_factor(jmb), atol=1e-4)
    np.testing.assert_allclose(standard.true_peak_level(mb)[0], jdsp.true_peak_level(jmb)[0],
                               atol=1e-4)


@pytest.mark.parametrize("seconds", [2.0, 3.2], ids=["frequency-sampling", "blocked"])
def test_lufs_of_a_full_scale_sine(seconds):
    """-3.01 LUFS at 0.07 (`tests/test_standard.py:146-152`); at 3.2 s the
    K-weighting leaves the frequency-sampling window for the blocked IIR,
    the route of B2 on the card."""
    s = generators.oscillator(997, 48000, length_seconds=seconds, peak_level_dbfs=0.0)
    np.testing.assert_allclose(standard.lufs_integrated(s), -3.01, atol=0.07)


@pytest.mark.parametrize("channels", [1, 3, 5])
def test_lufs_matches_jax(channels):
    x = (0.3 * RNG.standard_normal((3 * 48000, channels))).astype(np.float32)
    x[48000:72000] *= 0.01  # a quiet stretch for the gates to drop
    s, js = _pair(x, 48000)
    np.testing.assert_allclose(standard.lufs_integrated(s), jdsp.lufs_integrated(js), atol=1e-3)
    assert not s.constrain_amplitude
    with pytest.raises(AssertionError):
        standard.lufs_integrated(Signal(None, np.zeros((4800, 6)), 48000))


def test_apply_gain_matches_jax():
    s, js = _pair(X3)
    for g in (5.0, np.linspace(1, 5, 3)):
        got = standard.apply_gain(s, g)
        want = jdsp.apply_gain(js, g)
        np.testing.assert_allclose(_np(got.time_data), np.asarray(want.time_data), atol=1e-6)
    for f, jf in ((Filter.iir_filter(4, 500.0, FilterPassType.Highpass, FS),
                   jdsp.Filter.iir_filter(4, 500.0, jdsp.FilterPassType.Highpass, FS)),
                  (Filter.biquad(BiquadEqType.Peaking, 500.0, 0.0, 0.7, FS),
                   jdsp.Filter.biquad(jdsp.BiquadEqType.Peaking, 500.0, 0.0, 0.7, FS))):
        got, want = standard.apply_gain(f, -5.0), jdsp.apply_gain(jf, -5.0)
        for mode in ("Ba", "Sos"):
            for gi, wi in zip(got.get_coefficients(getattr(FilterCoefficientsType, mode)),
                              want.get_coefficients(getattr(jdsp.FilterCoefficientsType, mode))):
                np.testing.assert_allclose(gi, wi, atol=1e-12)
        lvl1 = standard.rms(f.filter_signal(s))
        lvl2 = standard.rms(got.filter_signal(s))
        np.testing.assert_allclose(lvl1 - 5.0, lvl2, atol=1e-3)
    fb = FilterBank([Filter.biquad(BiquadEqType.Peaking, 500.0, 3.0, 0.7, FS)] * 2)
    gained = standard.apply_gain(fb, [1.0, -2.0])
    assert gained.number_of_filters == 2 and gained.filters[0] is not fb.filters[0]


# ======== latency and delays ================================================
def _delayed(x, d):
    out = np.zeros((x.shape[0] + d, x.shape[1]), x.dtype)
    out[d:] = x
    return out


@pytest.mark.parametrize("d", [1, 37, 1323])
def test_integer_latency_exact(d):
    s, js = _pair(X3)
    late, jlate = _pair(_delayed(X3, d))
    lat, corr = standard.latency(s, late)
    jlat, jcorr = jdsp.latency(js, jlate)
    np.testing.assert_array_equal(lat, jlat)
    assert np.all(lat == -d)
    np.testing.assert_allclose(corr, 1.0, atol=1e-6)
    np.testing.assert_allclose(corr, jcorr, atol=1e-5)
    lat, _ = standard.latency(late, s)
    assert np.all(lat == d)
    with pytest.raises(AssertionError):
        standard.latency(late.get_channels(0), s)


def test_latency_within_one_signal_keeps_the_reversed_order():
    """parity: 3+ channels against channel 0 come back in reversed order."""
    x = np.stack([X3[:-40, 0], X3[10:-30, 0], X3[25:-15, 0], X3[40:, 0]], axis=1)
    s, js = _pair(x)
    lat, corr = standard.latency(s)
    jlat, jcorr = jdsp.latency(js)
    np.testing.assert_array_equal(lat, jlat)
    np.testing.assert_allclose(corr, jcorr, atol=1e-5)


def test_fractional_latency_matches_jax():
    noi = Signal(None, (0.3 * RNG.standard_normal(10_000)).astype(np.float32), 10_000)
    jnoi = jdsp.Signal(None, noi.time_data.numpy(), 10_000)
    delay_s = 0.003301
    late = standard.fractional_delay(noi, delay_s)
    jlate = jdsp.fractional_delay(jnoi, delay_s)
    np.testing.assert_allclose(_np(late.time_data), np.asarray(jlate.time_data), atol=1e-5)
    lat, corr = standard.latency(late, noi, 2)
    jlat, jcorr = jdsp.latency(jlate, jnoi, 2)
    np.testing.assert_allclose(corr, 1.0, atol=1e-2)
    assert abs(lat[0] - delay_s * 10_000) < 0.9
    np.testing.assert_allclose(lat, jlat, atol=1e-2)
    np.testing.assert_allclose(corr, jcorr, atol=1e-2)


@pytest.mark.parametrize("channels", [None, 0, [0, 2]])
@pytest.mark.parametrize("keep_length", [False, True])
def test_delays_match_jax(channels, keep_length):
    s, js = _pair(X3[:5000])
    got = standard.delay(s, 150, channels, keep_length)
    want = jdsp.delay(js, 150, channels, keep_length)
    np.testing.assert_array_equal(_np(got.time_data), np.asarray(want.time_data))
    for delay_s in (150 / FS, 20.4 / FS, 0.3 / FS):
        got = standard.fractional_delay(s, delay_s, channels, keep_length)
        want = jdsp.fractional_delay(js, delay_s, channels, keep_length)
        np.testing.assert_allclose(_np(got.time_data), np.asarray(want.time_data), atol=1e-6)
    lat = standard.latency(standard.delay(s, 150, channels), s)[0]
    expect = np.zeros(3)
    expect[np.arange(3) if channels is None else channels] = 150
    np.testing.assert_array_equal(np.abs(lat), expect)


# ======== activity detector ================================================
def _activity_mask_f64(x, threshold_dbfs, release, normalize=True):
    """The reference's recursion, sequential in float64 numpy: the
    coefficient is the release one where the previous power is > 0."""
    x = np.asarray(x, np.float64)
    if normalize:
        x = x / np.max(np.abs(x))
    p = x**2
    g = np.zeros_like(p)
    for i in range(1, len(p)):
        c = release if p[i - 1] > 0 else 0.0
        g[i] = c * p[i] + (1 - c) * g[i - 1]
    with np.errstate(divide="ignore"):
        return 10 * np.log10(g) > threshold_dbfs


def _bursts(n, fs, seed):
    """Noise bursts over a quiet floor with exact silences."""
    rng = np.random.default_rng(seed)
    x = 0.002 * rng.standard_normal(n)
    for start in range(0, n, n // 6):
        x[start : start + n // 12] += 0.5 * rng.standard_normal(len(x[start : start + n // 12]))
    x[n // 2 : n // 2 + 300] = 0.0
    return np.stack([x, 0.5 * x], axis=1).astype(np.float32)


@pytest.mark.parametrize("pre_filter", [False, True])
@pytest.mark.parametrize("threshold", [-20.0, -35.0])
def test_activity_detector_matches_float64_and_jax_up_to_threshold_flips(pre_filter, threshold):
    """The port's mask against the float64 sequential recursion and the JAX
    package's float32 scan: samples right at the threshold may flip between
    float32 sum orders (as ROADMAP C5); each comparison flips at most 0.1 %
    of the samples, and every flipped sample lies within 1e-3 dB of the
    threshold in float64."""
    fs = 16000
    x = _bursts(2 * fs, fs, 3)
    s, js = _pair(x, fs)
    sos = butter(4, 100.0, btype="highpass", fs=fs, output="sos")
    filt = Filter.from_sos(sos, fs) if pre_filter else None
    jfilt = jdsp.Filter.from_sos(sos, fs) if pre_filter else None
    got, other = standard.activity_detector(s, threshold, channel=1, pre_filter=filt)
    want, jother = jdsp.activity_detector(js, threshold, channel=1, pre_filter=jfilt)
    mask = other["signal_indices"]
    xin = sosfiltfilt(sos, x[:, 1].astype(np.float64)) if pre_filter else x[:, 1]
    release = get_smoothing_factor_ema(25e-3, fs)
    ref = _activity_mask_f64(xin, threshold, release)
    x64 = np.asarray(xin, np.float64) / np.max(np.abs(xin))
    g = np.zeros_like(x64)
    for i in range(1, len(x64)):
        c = release if x64[i - 1] ** 2 > 0 else 0.0
        g[i] = c * x64[i] ** 2 + (1 - c) * g[i - 1]
    for name, other_mask in (("float64", ref), ("jax", jother["signal_indices"])):
        flips = np.flatnonzero(mask != other_mask)
        print(f"activity mask vs {name}: {len(flips)} flips of {len(mask)}")
        assert len(flips) <= 1e-3 * len(mask), (name, len(flips))
        with np.errstate(divide="ignore"):
            assert np.all(np.abs(10 * np.log10(g[flips]) - threshold) < 1e-3), name
    assert 0.1 < mask.mean() < 0.9
    np.testing.assert_array_equal(other["noise_indices"], ~mask)
    np.testing.assert_array_equal(got.time_data[:, 0].numpy(), x[mask, 1])
    np.testing.assert_array_equal(other["noise"].time_data[:, 0].numpy(), x[~mask, 1])
    np.testing.assert_array_equal(np.asarray(want.time_data)[:, 0], x[jother["signal_indices"], 1])


def test_activity_mask_packing_and_scan():
    x = torch.from_numpy(_bursts(3001, 16000, 5)[:, 0])
    args = (-25.0, 0.3, 0.01)
    mask = backend.indices_above_threshold_dbfs(x, *args)
    packed = backend.indices_above_threshold_dbfs_packed(x, *args)
    assert packed.dtype == torch.uint8 and packed.shape == (376,)
    np.testing.assert_array_equal(np.unpackbits(packed.numpy())[:3001].astype(bool), mask.numpy())
    A = torch.from_numpy(RNG.uniform(0.5, 1.0, 1000))
    B = torch.from_numpy(RNG.standard_normal(1000))
    g, want = 0.0, np.zeros(1000)
    for i in range(1000):
        g = float(A[i]) * g + float(B[i])
        want[i] = g
    np.testing.assert_allclose(backend.first_order_scan(A, B).numpy(), want, rtol=1e-12,
                               atol=1e-12)


# ======== detrend, envelope, dither ========================================
@pytest.mark.parametrize("order", [0, 1, 2])
def test_detrend_matches_jax(order):
    t = np.arange(4000)[:, None] / 4000
    x = (X3[:4000] + 0.3 + 0.2 * t - 0.1 * t**2).astype(np.float32)
    s, js = _pair(x)
    got, want = standard.detrend(s, order), jdsp.detrend(js, order)
    np.testing.assert_allclose(_np(got.time_data), np.asarray(want.time_data), atol=1e-5)
    assert abs(float(got.time_data.mean())) < 1e-4
    with pytest.raises(AssertionError):
        standard.detrend(s, -1)


@pytest.mark.parametrize("analytic,window", [(True, None), (False, 512)])
def test_envelope_matches_jax(analytic, window):
    s, js = _pair(X3[:5000])
    got = standard.envelope(s, analytic, window)
    want = jdsp.envelope(js, analytic, window)
    assert got.shape == (5000, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mb = MultiBandSignal([s, s.copy()])
    assert standard.envelope(mb, analytic, window).shape == (5000, 2, 3)


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("truncate", [False, True])
def test_dither_matches_jax_on_the_same_draws(triangular, truncate):
    s, js = _pair(X3[:3000])
    np.random.seed(4)
    got = standard.dither(s, triangular, truncate=truncate)
    np.random.seed(4)
    want = jdsp.dither(js, triangular, truncate=truncate)
    np.testing.assert_array_equal(_np(got.time_data), np.asarray(want.time_data))
    assert got.time_data.shape == (3000, 3)


def test_half_precision_rounding_matches_numpys_cast():
    """`dither(truncate=True)` rounds on the signal's device, in float64:
    every magnitude, the ties at each exponent, the subnormals and the
    overflow edge agree with numpy's cast to half precision and back."""
    from dsptoolbox_tpu_torch.standard.other import _round_to_half_precision

    rng = np.random.default_rng(21)
    e = np.arange(-30, 17.0)
    x = np.concatenate([
        rng.standard_normal(20000) * 10.0 ** rng.uniform(-10, 6, 20000),
        (1 + 2.0**-11) * 2.0**e, -(1 + 3 * 2.0**-11) * 2.0**e, 1.5 * 2.0 ** (e - 24),
        [0.0, -0.0, 65504.0, 65519.99, 65520.0, -65520.0, 1e9, 2.0**-25,
         3 * 2.0**-25, 2.0**-14 - 2.0**-25, np.inf, -np.inf, np.nan],
    ])
    with np.errstate(over="ignore"):
        want = x.astype(np.float16).astype(np.float64)
    got = _round_to_half_precision(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def test_dither_noise_shaping_matches_jax():
    s, js = _pair(X3[:3000])
    fb = FilterBank([Filter.iir_filter(2, 1000.0, FilterPassType.Highpass, FS)])
    jfb = jdsp.FilterBank([jdsp.Filter.iir_filter(2, 1000.0, jdsp.FilterPassType.Highpass, FS)])
    np.random.seed(6)
    got = standard.dither(s, epsilon=1e-3, noise_shaping_filterbank=fb)
    np.random.seed(6)
    want = jdsp.dither(js, epsilon=1e-3, noise_shaping_filterbank=jfb)
    np.testing.assert_allclose(_np(got.time_data), np.asarray(want.time_data), atol=1e-7)


# ======== pad and trim ======================================================
@pytest.mark.parametrize("start,end", [(0.01, 0.02), (None, 0.01), (-0.01, -0.005),
                                       (0.002, -0.01), (-0.003, None)])
def test_modify_signal_length_matches_jax(start, end):
    s, js = _pair(X3[:4410])
    got = standard.modify_signal_length(s, start, end)
    want = jdsp.modify_signal_length(js, start, end)
    np.testing.assert_array_equal(_np(got.time_data), np.asarray(want.time_data))


@pytest.mark.parametrize("at", [(True, True), (False, True), (True, False)])
def test_trims_match_jax(at):
    x = np.zeros((1000, 2), np.float32)
    x[300:520, 0] = 0.01
    x[350:700, 1] = -0.02
    s, js = _pair(x)
    got = standard.trim_with_level_threshold(s, -45.0, *at)
    want = jdsp.trim_with_level_threshold(js, -45.0, *at)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(_np(got[0].time_data), np.asarray(want[0].time_data))
    s, js = _pair(X3)
    for args in ((0.1, 0.3, True), (0.1, 0.3, False), (None, 0.2, True), (0.5, None, False)):
        got = standard.trim_with_time_selection(s, *args)
        want = jdsp.trim_with_time_selection(js, *args)
        np.testing.assert_array_equal(_np(got.time_data), np.asarray(want.time_data))


# ======== appending =========================================================
@pytest.mark.parametrize("at_end", [True, False])
def test_append_signals_matches_jax(at_end):
    a, ja = _pair(X3[:3000, :2])
    b, jb = _pair(X3[500:2800, 2])
    c, jc = _pair(X3[:3500, :1])
    got = standard.append_signals([a, b, c], at_end=at_end)
    want = jdsp.append_signals([ja, jb, jc], at_end=at_end)
    assert got.number_of_channels == 4
    np.testing.assert_array_equal(_np(got.time_data), np.asarray(want.time_data))
    with pytest.raises(AssertionError):
        standard.append_signals([a, b], allow_padding_trimming=False)
    cplx = Signal(None, X3[:3000, :1] + 1j * X3[:3000, 1:2], FS)
    mixed = standard.append_signals([cplx, a], at_end=at_end)
    assert mixed.is_complex_signal and mixed.number_of_channels == 3
    np.testing.assert_array_equal(mixed.time_data_imaginary[:, 1:].numpy(), 0.0)
    mb = standard.append_signals([MultiBandSignal([a, a.copy()]), MultiBandSignal([b, b.copy()])])
    assert mb.number_of_bands == 2 and mb.number_of_channels == 3


def test_append_filterbanks_and_spectra_match_jax():
    fbs = [FilterBank([Filter.iir_filter(2, f, FilterPassType.Lowpass, FS)]) for f in (500.0, 900.0)]
    merged = standard.append_filterbanks(fbs)
    assert merged.number_of_filters == 2 and merged.filters[0] is not fbs[0].filters[0]
    f1 = np.linspace(0, 1000, 101)
    f2 = np.linspace(5, 1200, 57)
    d1 = RNG.standard_normal((101, 2)) + 1j * RNG.standard_normal((101, 2))
    d2 = RNG.standard_normal((57, 1)) + 1j * RNG.standard_normal((57, 1))
    for kw in (dict(), dict(complex_if_available=False)):
        got = standard.append_spectra([Spectrum(f1, d1), Spectrum(f2, d2)], **kw)
        want = jdsp.append_spectra([jdsp.Spectrum(f1, d1), jdsp.Spectrum(f2, d2)], **kw)
        assert got.number_frequency_bins == 101 and got.spectral_data.shape == (101, 3)
        assert got.is_complex == (not kw)
        assert_close(got.spectral_data.numpy(), np.asarray(want.spectral_data), 1e-5, "append")


@pytest.mark.parametrize("domain", ["Power", "Magnitude", "Complex", "MagnitudePhase"])
@pytest.mark.parametrize("edges", ["ZeroPad", "OnePad", "Extend"])
def test_spectrum_linear_interpolation_matches_jax(domain, edges):
    f = np.linspace(10, 1000, 64)
    d = RNG.standard_normal((64, 2)) + 1j * RNG.standard_normal((64, 2))
    fq = np.linspace(0, 1100, 90)
    sp = Spectrum(f, d).set_interpolator_parameters(
        getattr(InterpolationDomain, domain), edges_handling=getattr(InterpolationEdgeHandling, edges))
    jsp = jdsp.Spectrum(f, d).set_interpolator_parameters(
        getattr(jdsp.InterpolationDomain, domain),
        edges_handling=getattr(jdsp.InterpolationEdgeHandling, edges))
    for out in ("Magnitude", "Power", "Db") + (("Complex",) if domain in ("Complex", "MagnitudePhase") else ()):
        got = sp.get_interpolated_spectrum(fq, getattr(SpectrumType, out)).numpy()
        want = np.asarray(jsp.get_interpolated_spectrum(fq, getattr(jdsp.SpectrumType, out)))
        if out == "Db":  # -inf at zero-padded edges on both sides
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f"{domain} {edges}")
        else:
            assert_close(got, want, 2e-5, f"{domain} {edges} {out}")


def test_standard_functions_launch_no_kernel_on_the_cpu():
    cuda_framing.launches = 0
    cuda_iir.launches = 0
    s = Signal(None, _bursts(3 * 48000, 48000, 7), 48000)
    standard.lufs_integrated(s)
    standard.activity_detector(s, pre_filter=Filter.iir_filter(4, 80.0, FilterPassType.Highpass,
                                                               48000))
    assert cuda_framing.launches == 0 and cuda_iir.launches == 0


@pytest.mark.parametrize("points", [1, 2])
def test_latency_helpers_match_jax(points):
    """`helpers.latency`: the analytic signal against scipy, the fractional
    peak index, the phase's latency removal and the correlations against
    the JAX package."""
    from scipy.signal import hilbert

    from dsptoolbox_tpu.helpers import latency as jlat
    from dsptoolbox_tpu_torch.helpers import latency as tlat

    for n in (1000, 1001):
        x = RNG.standard_normal((n, 2))
        np.testing.assert_allclose(tlat.analytic_signal(torch.from_numpy(x), dim=0).numpy(),
                                   hilbert(x, axis=0), atol=1e-12)
    t = np.arange(600)[:, None]
    pulses = np.sinc(t - np.array([[200.3, 350.75]])).astype(np.float32)
    got = tlat.get_fractional_impulse_peak_index(torch.from_numpy(pulses), points)
    want = jlat.get_fractional_impulse_peak_index(pulses, points)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.all(np.abs(got - [200.3, 350.75]) < 0.1)
    f = np.linspace(0, 24000, 65)
    ph = RNG.uniform(-np.pi, np.pi, (65, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tlat.remove_ir_latency_from_phase(f, torch.from_numpy(ph), np.array([3.0, 7.5]),
                                          48000).numpy(),
        np.asarray(jlat.remove_ir_latency_from_phase(f, ph, np.array([3.0, 7.5]), 48000)),
        atol=1e-5)
    a = X3[:3000, :2]
    b = np.concatenate([np.zeros((40, 2), np.float32), a[:-40]])
    np.testing.assert_allclose(
        tlat.correlation_of_latencies(torch.from_numpy(a), torch.from_numpy(b),
                                      np.array([40, -40])),
        jlat.correlation_of_latencies(a, b, np.array([40, -40])), atol=1e-6)

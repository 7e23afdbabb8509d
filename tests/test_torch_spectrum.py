"""The port's spectrum layer (`dsptoolbox_tpu_torch.classes.Spectrum`:
interpolation in every scheme and domain, octave smoothing, energy,
coherence, trimming, resampling, normalization, gains, channel sums,
warping, `to_signal`, `from_filter`/`from_filterbank`; `Signal`'s smoothed
and physically scaled FFT spectra; `standard.spectral_difference`) against
the JAX package on the CPU, on the same seeded numpy inputs, at
`assert_close`'s 2e-5 scale-relative unless stated. Sizes are small: up to
8193 bins, 3 channels."""

import numpy as np
import pytest
import torch
from scipy.signal import butter

from conftest import assert_close
from torch_checks import assert_finite_close, assert_phase_close
from torch_checks import phase_range as _phase_range
import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu import standard as jstandard
from dsptoolbox_tpu.standard import enums as jenums
from dsptoolbox_tpu_torch import _config, standard
from dsptoolbox_tpu_torch.classes import Filter, FilterBank, ImpulseResponse, Signal, Spectrum
from dsptoolbox_tpu_torch.standard.enums import (
    FilterBankMode,
    FrequencySpacing,
    InterpolationDomain,
    InterpolationEdgeHandling,
    InterpolationScheme,
    SpectrumMethod,
    SpectrumScaling,
    SpectrumType,
    Window,
)

torch.set_num_threads(1)

FS = 48000
RNG = np.random.default_rng(11)
F = 1025
FREQS = np.linspace(0, FS / 2, F)
MAG = (np.abs(RNG.standard_normal((F, 3))) + 0.1).astype(np.float32)
PHASE = np.cumsum(RNG.uniform(-0.4, 0.1, (F, 3)), axis=0).astype(np.float32)
CPLX = (MAG * np.exp(1j * PHASE)).astype(np.complex64)
IRS = (RNG.standard_normal((4096, 3)) * np.exp(-np.arange(4096) / 400)[:, None]
       ).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's classes put numpy data on the default device, "cuda" out
    of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _j(enum):
    """The JAX package's member of the same name."""
    return getattr(getattr(jenums, type(enum).__name__), enum.name)


def _pair(f, data):
    return Spectrum(f, data.copy()), jdsp.Spectrum(f, data.copy())


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------- interpolation


@pytest.mark.parametrize("scheme", list(InterpolationScheme), ids=lambda s: s.name)
@pytest.mark.parametrize("domain", list(InterpolationDomain), ids=lambda d: d.name)
@pytest.mark.parametrize("edges", [InterpolationEdgeHandling.ZeroPad,
                                   InterpolationEdgeHandling.OnePad,
                                   InterpolationEdgeHandling.Extend],
                         ids=lambda e: e.name)
def test_interpolated_spectrum_matches_jax(scheme, domain, edges):
    # the grid of a 1024-point rfft; the requested one runs past both ends
    data = CPLX if domain in (InterpolationDomain.Complex,
                              InterpolationDomain.MagnitudePhase) else MAG
    p, j = _pair(FREQS[1:], data[1:])
    p.set_interpolator_parameters(domain, scheme, edges)
    j.set_interpolator_parameters(_j(domain), _j(scheme), _j(edges))
    fq = np.linspace(-50, 24200, 777)
    types = [SpectrumType.Magnitude, SpectrumType.Power, SpectrumType.Db]
    if data is CPLX:
        types.append(SpectrumType.Complex)
    for kind in types:
        got = p.get_interpolated_spectrum(fq, kind)
        want = np.asarray(j.get_interpolated_spectrum(fq, _j(kind)))
        name = f"{scheme} {domain} {kind}"
        if kind == SpectrumType.Complex and domain == InterpolationDomain.MagnitudePhase:
            assert_phase_close(got, want, _phase_range(data), name)
        else:
            assert_finite_close(got, want, 2e-5, name)


def test_cubic_above_4096_bins_uses_the_host_spline_as_jax():
    f = np.linspace(0, FS / 2, 8193)
    data = (np.abs(RNG.standard_normal((8193, 2))) + 0.1).astype(np.float32)
    p, j = _pair(f, data)
    p.set_interpolator_parameters(scheme=InterpolationScheme.Cubic)
    j.set_interpolator_parameters(scheme=jenums.InterpolationScheme.Cubic)
    fq = np.linspace(3, 23990, 1000)
    assert_finite_close(p.get_interpolated_spectrum(fq, SpectrumType.Magnitude),
                        np.asarray(j.get_interpolated_spectrum(fq, jenums.SpectrumType.Magnitude)),
                        2e-5, "cubic, host spline")


def test_error_edges_and_complex_domain_on_magnitude_raise():
    p, _ = _pair(FREQS[1:], MAG[1:])
    p.set_interpolator_parameters(edges_handling=InterpolationEdgeHandling.Error)
    with pytest.raises(AssertionError):
        p.get_interpolated_spectrum(np.array([0.0, 100.0]), SpectrumType.Magnitude)
    with pytest.raises(AssertionError):
        p.set_interpolator_parameters(InterpolationDomain.Complex)
    with pytest.raises(AssertionError):
        p.get_interpolated_spectrum(np.array([100.0]), SpectrumType.Complex)


# ----------------------------------------------------- smoothing and energy


@pytest.mark.parametrize("spacing", ["linear", "log", "other"])
@pytest.mark.parametrize("complex_data", [False, True])
@pytest.mark.parametrize("window", [Window.Hann, Window.Hamming])
def test_octave_smoothing_matches_jax(spacing, complex_data, window):
    f = {"linear": FREQS[1:], "log": np.geomspace(20, 20000, 500),
         "other": np.sort(RNG.uniform(20, 3000, 300))}[spacing]
    data = (CPLX if complex_data else MAG)[1: len(f) + 1]
    p, j = _pair(f, data)
    assert p.frequency_vector_type == getattr(
        FrequencySpacing, {"linear": "Linear", "log": "Logarithmic", "other": "Other"}[spacing])
    p.apply_octave_smoothing(6, window)
    j.apply_octave_smoothing(6, _j(window))
    np.testing.assert_array_equal(p.frequency_vector_hz, j.frequency_vector_hz)
    assert p.is_complex == complex_data
    if complex_data:
        assert_phase_close(p.spectral_data, j.spectral_data, _phase_range(data), spacing)
    else:
        assert_close(p.spectral_data, j.spectral_data, 2e-5, spacing)


@pytest.mark.parametrize("band", [(None, None), (100.0, 5000.0), (120.5, None)])
def test_energy_matches_jax(band):
    for data in (MAG, CPLX):
        p, j = _pair(FREQS, data)
        assert_close(p.get_energy(*band), np.asarray(j.get_energy(*band)), 2e-5, str(band))


def test_coherence():
    p, _ = _pair(FREQS, MAG)
    assert not p.has_coherence
    coh = RNG.uniform(0, 1, MAG.shape)
    p.set_coherence(coh)
    assert p.has_coherence and p.coherence.device == p.device
    assert p.coherence.dtype == torch.float32
    with pytest.raises(AssertionError):
        p.set_coherence(coh[:-1])
    with pytest.raises(AssertionError):
        p.set_coherence(coh + 0j)


# ------------------------------------------------------ in-place transforms


@pytest.mark.parametrize("bounds", [(100.0, 5000.0), (None, 5000.0), (187.5, None),
                                    (100.0, 5000.0, False)])
def test_trim_matches_jax(bounds):
    p, j = _pair(FREQS, CPLX)
    p.trim(*bounds)
    j.trim(*bounds)
    np.testing.assert_array_equal(p.frequency_vector_hz, j.frequency_vector_hz)
    assert_close(p.spectral_data, j.spectral_data, 1e-7, "trim")
    with pytest.raises(AssertionError):
        Spectrum(FREQS, MAG).trim(5000.0, 100.0)


@pytest.mark.parametrize("scheme", list(InterpolationScheme), ids=lambda s: s.name)
def test_resample_normalize_gain_sum_warp_match_jax(scheme):
    new_f = np.geomspace(30, 20000, 300)
    for data in (MAG, CPLX):
        p, j = _pair(FREQS[1:], data[1:])
        p.set_interpolator_parameters(scheme=scheme)
        j.set_interpolator_parameters(scheme=_j(scheme))
        p.resample(new_f)
        j.resample(new_f)
        if data is CPLX:
            assert_phase_close(p.spectral_data, j.spectral_data, _phase_range(data), "resample")
        else:
            assert_finite_close(p.spectral_data, j.spectral_data, 2e-5, "resample")
        if not bool(torch.isfinite(p.spectral_data).all()):
            continue  # a cubic overshoot under the Power domain's root
        for ref_ch in (None, 1):
            pn, jn = p.copy(), j.copy()
            pn.normalize(1000.0, ref_ch)
            jn.normalize(1000.0, ref_ch)
            assert_close(pn.spectral_data, jn.spectral_data, 2e-5, f"normalize {ref_ch}")
        for gain in (-6.0, [1.0, -2.0, 3.0]):
            pg, jg = p.copy(), j.copy()
            pg.apply_gain(gain)
            jg.apply_gain(gain)
            assert_close(pg.spectral_data, jg.spectral_data, 2e-5, "gain")
        for power in (True, False):
            assert_close(p.sum_channels(power).spectral_data,
                         j.sum_channels(power).spectral_data, 2e-5, f"sum {power}")
    with pytest.raises(AssertionError):
        p.apply_gain([1.0, 2.0])
    pw, jw = _pair(FREQS, MAG)
    pw.warp(0.4, FS)
    jw.warp(0.4, FS)
    np.testing.assert_array_equal(pw.frequency_vector_hz, jw.frequency_vector_hz)


def test_channel_methods_match_jax():
    p, j = _pair(FREQS, CPLX)
    assert p.number_of_channels == 3 and len(p) == F
    assert_close(p.get_channels([2, 0]).spectral_data, j.get_channels([2, 0]).spectral_data,
                 0, "get")
    p.swap_channels([1, 2, 0])
    j.swap_channels([1, 2, 0])
    p.remove_channel(-1)
    j.remove_channel(-1)
    assert_close(p.spectral_data, j.spectral_data, 0, "swap, remove")
    with pytest.raises(IndexError):
        p.get_channels(5)


@pytest.mark.parametrize("length_seconds", [None, 0.05])
def test_to_signal_matches_jax(length_seconds):
    sp = np.fft.rfft(IRS, axis=0).astype(np.complex64)
    f = np.fft.rfftfreq(len(IRS), 1 / FS)
    p, j = _pair(f, sp)
    got = p.to_signal(FS, length_seconds)
    assert isinstance(got, Signal)
    assert_close(got.time_data, np.asarray(j.to_signal(FS, length_seconds).time_data), 2e-5,
                 "linear grid")
    # a grid that stops short of Nyquist: PCHIP in MagnitudePhase onto 0..fs/2
    p, j = _pair(f[:1500], sp[:1500])
    assert_close(p.to_signal(FS, length_seconds).time_data,
                 np.asarray(j.to_signal(FS, length_seconds).time_data), 2e-5, "regridded")
    p, j = _pair(np.geomspace(20, 20000, 300), CPLX[:300])
    assert_close(p.to_signal(FS, 0.02).time_data, np.asarray(j.to_signal(FS, 0.02).time_data),
                 2e-5, "log grid")
    with pytest.raises(AssertionError):
        Spectrum(FREQS, MAG).to_signal(FS)


@pytest.mark.parametrize("mode", list(FilterBankMode), ids=lambda m: m.name)
def test_from_filter_and_filterbank_match_jax(mode):
    sos = [butter(4, fc, fs=FS, output="sos") for fc in (500, 2000, 8000)]
    bank = FilterBank([Filter.from_sos(s, FS) for s in sos])
    jbank = jdsp.FilterBank([jdsp.Filter.from_sos(s, FS) for s in sos])
    for complex_out in (False, True):
        got = Spectrum.from_filterbank(FREQS, bank, mode, complex_out)
        want = jdsp.Spectrum.from_filterbank(FREQS, jbank, _j(mode), complex_out)
        assert got.device.type == "cpu" and got.is_complex == complex_out
        assert_close(got.spectral_data, want.spectral_data, 2e-5, f"{mode} {complex_out}")
        assert_close(Spectrum.from_filter(FREQS, bank.filters[0], complex_out).spectral_data,
                     jdsp.Spectrum.from_filter(FREQS, jbank.filters[0], complex_out)
                     .spectral_data, 2e-5, "filter")


# ----------------------------------------------------------- Signal spectra


@pytest.mark.parametrize("smoothing", [0, 3, 12])
@pytest.mark.parametrize("scaling", list(SpectrumScaling), ids=lambda s: s.name)
@pytest.mark.parametrize("with_window", [False, True])
def test_signal_fft_spectrum_smoothing_and_scalings_match_jax(smoothing, scaling, with_window):
    p = ImpulseResponse(None, IRS.copy(), FS)
    j = jdsp.ImpulseResponse(None, IRS.copy(), FS)
    win = np.hanning(len(IRS))[:, None].repeat(3, 1)
    if with_window:
        p.set_window(win)
        j.set_window(win)
    for sig, sc in ((p, scaling), (j, _j(scaling))):
        sig.set_spectrum_parameters(method=type(sig.spectrum_method).FFT, smoothing=smoothing,
                                    scaling=sc)
    f, got = p.get_spectrum(return_device=True)
    jf, want = j.get_spectrum()
    np.testing.assert_array_equal(f, jf)
    name = f"{smoothing} {scaling.name}"
    if smoothing and got.is_complex():
        assert_phase_close(got, want, _phase_range(np.fft.rfft(IRS, axis=0)), name)
    else:
        assert_close(got, np.asarray(want), 2e-5, name)


# ------------------------------------------------------- spectral difference


@pytest.mark.parametrize("smoothing", [0, 3])
@pytest.mark.parametrize("complex_out", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dyn", [100.0, 20.0, None])
def test_spectral_difference_matches_jax(smoothing, complex_out, normalize, dyn):
    a = IRS[:, :2].copy()
    b = np.roll(IRS[:, 1:], 3, axis=0).copy()
    kw = dict(octave_fraction_smoothing=smoothing, energy_normalization=normalize,
              complex=complex_out, dynamic_range_db=dyn)
    got = standard.spectral_difference(ImpulseResponse(None, a, FS),
                                       ImpulseResponse(None, b, FS), **kw)
    want = jstandard.spectral_difference(jdsp.ImpulseResponse(None, a, FS),
                                         jdsp.ImpulseResponse(None, b, FS), **kw)
    assert got.is_complex == complex_out
    if complex_out:
        assert_phase_close(got.spectral_data, want.spectral_data,
                           _phase_range(np.fft.rfft(b, axis=0)), str(kw))
    else:
        assert_close(got.spectral_data, want.spectral_data, 2e-5, str(kw))


def test_spectral_difference_of_spectra_and_welch_signals():
    # Spectrum inputs on their own grids, and Welch (real) signal spectra
    p1, j1 = _pair(FREQS, CPLX[:, :2])
    p2, j2 = _pair(np.linspace(0, FS / 2, 700), CPLX[:700, 1:])
    assert_close(standard.spectral_difference(p1, p2, complex=True).spectral_data,
                 jstandard.spectral_difference(j1, j2, complex=True).spectral_data, 2e-5,
                 "spectra")
    x = (RNG.standard_normal((16384, 2)) * 0.3).astype(np.float32)
    s_p, s_j = Signal(None, x, FS), jdsp.Signal(None, x, FS)
    y = np.roll(x, 5, axis=0) * 0.5
    assert s_p.spectrum_method == SpectrumMethod.WelchPeriodogram
    assert_close(standard.spectral_difference(s_p, Signal(None, y, FS), 6).spectral_data,
                 jstandard.spectral_difference(s_j, jdsp.Signal(None, y, FS), 6).spectral_data,
                 2e-5, "welch signals")
    with pytest.raises(AssertionError):
        standard.spectral_difference(Spectrum(FREQS, MAG), p1, complex=True)

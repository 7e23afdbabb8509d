"""The port's helper layer under the spectrum classes
(`dsptoolbox_tpu_torch.helpers`: `interpolation`, `smoothing`'s
fractional-octave smoothing, `minimum_phase`, `spectrum_utilities`), the
standard backend's group delay and minimum phase, and the filter group
delay (`classes.filter_helpers.group_delay_filter`, `Filter.get_group_delay`)
against the JAX package on the CPU, on the same seeded numpy inputs, at
`assert_close`'s 2e-5 scale-relative unless stated; and `ar_estimation`
(Levinson-Durbin, Yule-Walker, Burg in float64 on the data's device)
against the JAX package's host numpy at 1e-10. Sizes are small: up to 4097
bins, 3 channels."""

import numpy as np
import pytest
import torch
from scipy.interpolate import PchipInterpolator
from scipy.signal import butter, group_delay as scipy_group_delay

from conftest import assert_close
import jax.numpy as jnp
from dsptoolbox_tpu.classes import Filter as JFilter
from dsptoolbox_tpu.classes import filter_helpers as jfh
from dsptoolbox_tpu.helpers import interpolation as jinterp
from dsptoolbox_tpu.helpers import minimum_phase as jminph
from dsptoolbox_tpu.helpers import smoothing as jsmooth
from dsptoolbox_tpu.helpers import spectrum_utilities as jsu
from dsptoolbox_tpu.standard import backend as jbackend
from dsptoolbox_tpu.standard import enums as jenums
from dsptoolbox_tpu_torch.classes import Filter
from dsptoolbox_tpu_torch.classes.filter_helpers import group_delay_filter
from dsptoolbox_tpu_torch.helpers import interpolation, minimum_phase, smoothing
from dsptoolbox_tpu_torch.helpers import spectrum_utilities as su
from dsptoolbox_tpu_torch.standard import backend
from dsptoolbox_tpu_torch.standard.enums import (
    FilterCoefficientsType,
    MagnitudeNormalization,
    SpectrumScaling,
)

torch.set_num_threads(1)

RNG = np.random.default_rng(5)
F = 513
FREQS = np.linspace(0, 24000, F)
# a positive magnitude response, 3 channels, with a few deep notches
MAG = (np.abs(RNG.standard_normal((F, 3))) + 0.05).astype(np.float32)
PHASE = np.cumsum(RNG.uniform(-0.5, 0.1, (F, 3)), axis=0).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------ interpolation


@pytest.mark.parametrize("grid", ["inside", "outside", "log"])
@pytest.mark.parametrize("scheme", ["linear", "pchip"])
def test_interpolation_matches_jax(grid, scheme):
    xq = {"inside": np.linspace(10, 23990, 700),
          "outside": np.linspace(-500, 25000, 301),
          "log": np.geomspace(20, 24000, 400)}[grid]
    fn = {"linear": "linear_interpolate", "pchip": "pchip_interpolate"}[scheme]
    got = getattr(interpolation, fn)(FREQS, _t(MAG), xq, axis=0)
    want = getattr(jinterp, fn)(FREQS, jnp.asarray(MAG), xq, axis=0)
    assert got.dtype == torch.float32
    assert_close(got, want, 2e-5, f"{scheme} {grid}")
    # along another axis too
    got_t = getattr(interpolation, fn)(FREQS, _t(MAG.T.copy()), xq, axis=1)
    assert_close(got_t.T, want, 2e-5, f"{scheme} {grid} axis 1")


def test_pchip_matches_scipy_float64():
    xq = np.linspace(0, 24000, 1111)
    got = interpolation.pchip_interpolate(FREQS, _t(MAG.astype(np.float64)), xq)
    want = PchipInterpolator(FREQS, MAG.astype(np.float64), axis=0)(xq)
    assert_close(got, want, 1e-12, "pchip vs scipy float64")


# ---------------------------------------------------------------- smoothing


@pytest.mark.parametrize(
    "kw",
    [dict(num_fractions=3), dict(num_fractions=12, clip_values=True),
     dict(num_fractions=6, window_type=("gauss", 2.5)),
     dict(num_fractions=3, bin_spacing_octaves=0.01),
     dict(num_fractions=1, window_type=None, window_vec=np.hanning(13)[1:-1],
          bin_spacing_octaves=0.1)],
    ids=["third", "twelfth_clip", "gauss", "log_spaced", "window_vec"],
)
def test_fractional_octave_smoothing_matches_jax(kw):
    data = np.log(MAG) if "clip_values" in kw else MAG
    got = smoothing.fractional_octave_smoothing(_t(data), **kw)
    want = jsmooth.fractional_octave_smoothing(jnp.asarray(data), **kw)
    assert got.shape == data.shape
    assert_close(got, want, 2e-5, str(kw))
    got1 = smoothing.fractional_octave_smoothing(_t(data.T.copy()), axis=1, **kw)
    assert_close(got1.T, want, 2e-5, f"{kw} axis 1")


# ------------------------------------------------------------ minimum phase


@pytest.mark.parametrize("T,pf", [(1000, 8), (777, 1), (256, 3)])
def test_minimum_phase_cepstrum_matches_jax(T, pf):
    x = (RNG.standard_normal((2, T)) * np.exp(-np.arange(T) / 80)).astype(np.float32)
    sp = minimum_phase.minimum_phase_spectrum_from_real_cepstrum(_t(x), pf)
    want = jminph.minimum_phase_spectrum_from_real_cepstrum(jnp.asarray(x), pf)
    assert sp.shape == want.shape
    assert_close(sp, np.asarray(want), 2e-5, "spectrum")
    ir = minimum_phase.min_phase_ir_from_real_cepstrum(_t(x), pf)
    assert_close(ir, np.asarray(jminph.min_phase_ir_from_real_cepstrum(jnp.asarray(x), pf)),
                 2e-5, "ir")


def test_minimum_phase_floors_exact_spectral_zeros_where_jax_gives_nan():
    # x = [1, 1] has |X| = 0 at Nyquist for an even FFT length: the JAX
    # package takes log 0 = -inf and every sample turns NaN; the port
    # floors the zero at float32's resolution of the row (ROADMAP C7) and
    # equals the float64 cepstrum with that floor
    x = np.array([[1.0, 1.0], [1.0, -0.5]], np.float32)
    got = minimum_phase.min_phase_ir_from_real_cepstrum(_t(x), 2)
    want = np.asarray(jminph.min_phase_ir_from_real_cepstrum(jnp.asarray(x), 2))
    assert np.isnan(want[0]).all() and np.isfinite(want[1]).all()
    assert torch.isfinite(got).all()
    assert_close(got[1], want[1], 2e-5, "no zero: as the JAX package")
    mag = np.abs(np.fft.fft(x[0].astype(np.float64), n=4))
    mag[mag == 0] = mag.max() * np.finfo(np.float32).eps
    y = np.real(np.fft.ifft(np.log(mag)))
    y[1:2] *= 2.0
    y[3:] = 0.0
    oracle = np.real(np.fft.ifft(np.exp(np.fft.fft(y))))
    assert_close(got[0], oracle, 1e-6, "floored zero vs float64")


# ------------------------------------------------------- spectrum utilities


def test_wrap_phase_exact_gain_and_real_phase_correction_match_jax():
    assert_close(su.wrap_phase(_t(PHASE)), np.asarray(jsu.wrap_phase(jnp.asarray(PHASE))),
                 1e-6, "wrap")
    db = 20 * np.log10(MAG)
    assert_close(su.get_exact_gain_1khz(FREQS, _t(db)),
                 np.asarray(jsu.get_exact_gain_1khz(FREQS, jnp.asarray(db))), 2e-5, "1 kHz")
    assert_close(su.correct_for_real_phase_spectrum(_t(PHASE)),
                 jsu.correct_for_real_phase_spectrum(jnp.asarray(PHASE)), 2e-5, "real phase")
    assert_close(su.correct_for_real_phase_spectrum(_t(PHASE[:, 0])),
                 jsu.correct_for_real_phase_spectrum(jnp.asarray(PHASE[:, 0])), 2e-5, "1-D")
    with pytest.raises(AssertionError):
        su.get_exact_gain_1khz(FREQS[:10], _t(db[:10]))


@pytest.mark.parametrize("scaling", ["AmplitudeSpectrum", "AmplitudeSpectralDensity",
                                     "PowerSpectrum", "PowerSpectralDensity"])
@pytest.mark.parametrize("n", [1024, 1023])
@pytest.mark.parametrize("window", [False, True])
def test_scale_spectrum_matches_jax(scaling, n, window):
    x = RNG.standard_normal((n, 2)).astype(np.float32)
    sp = np.fft.rfft(x, axis=0).astype(np.complex64)
    win = np.hanning(n) if window else None
    got = su.scale_spectrum(_t(sp), getattr(SpectrumScaling, scaling), n, 48000, win)
    want = jsu.scale_spectrum(jnp.asarray(sp), getattr(jenums.SpectrumScaling, scaling), n,
                              48000, win)
    assert_close(got, np.asarray(want), 2e-5, scaling)
    with pytest.raises(AssertionError):
        su.scale_spectrum(_t(sp), getattr(SpectrumScaling, scaling), n + 7, 48000)


@pytest.mark.parametrize("normalize", list(MagnitudeNormalization), ids=lambda m: m.name)
@pytest.mark.parametrize("amplitude", [True, False])
def test_get_normalized_spectrum_matches_jax(normalize, amplitude):
    sp = (MAG * np.exp(1j * PHASE)).astype(np.complex64)
    jnorm = getattr(jenums.MagnitudeNormalization, normalize.name)
    for f_range, smooth, phase in (([100, 20000], 0, True), (None, 6, True), (None, 3, False)):
        got = su.get_normalized_spectrum(FREQS, _t(sp), amplitude, f_range, normalize, smooth,
                                         phase, True)
        want = jsu.get_normalized_spectrum(FREQS, sp, amplitude, f_range, jnorm, smooth,
                                           phase, True)
        for g, w in zip(got, want):
            assert_close(g, w, 2e-5, f"{normalize.name} {f_range} {smooth}")


@pytest.mark.parametrize("scheme", ["linear", "quadratic", "cubic"])
@pytest.mark.parametrize("mode", [None, "power2amplitude", "amplitude2power",
                                  "db2amplitude", "amplitude2db", "power2db"])
def test_interpolate_fr_matches_jax(scheme, mode):
    f_target = np.linspace(-100, 26000, 333)
    data = MAG if mode is None or "db2" not in mode else 20 * np.log10(MAG)
    got = su.interpolate_fr(FREQS, _t(data), f_target, mode, scheme).numpy()
    want = np.asarray(jsu.interpolate_fr(FREQS, jnp.asarray(data), f_target, mode, scheme))
    # a spline's overshoot below 0 gives NaN under a root, the zero fill
    # -inf in dB: at the same bins on both sides
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    assert_close(got[finite], want[finite], 2e-5, f"{scheme} {mode}")


def test_interpolate_fr_complex_and_errors():
    sp = (MAG * np.exp(1j * PHASE)).astype(np.complex64)
    f_target = np.linspace(0, 24000, 200)
    got = su.interpolate_fr(FREQS, _t(sp), f_target, None, "cubic")
    want = (su.interpolate_fr(FREQS, _t(sp.real), f_target, None, "cubic")
            + 1j * su.interpolate_fr(FREQS, _t(sp.imag), f_target, None, "cubic"))
    assert_close(got, want, 1e-7, "complex = real + i imag")
    with pytest.raises(ValueError):
        su.interpolate_fr(FREQS, _t(MAG), f_target, "bogus")
    with pytest.raises(ValueError):
        su.interpolate_fr(FREQS, _t(MAG), f_target, None, "nearest")


def test_warp_frequency_vector_matches_jax():
    for w in (-0.6, 0.3, 0.9):
        np.testing.assert_array_equal(su.warp_frequency_vector(FREQS, 48000, w),
                                      jsu.warp_frequency_vector(FREQS, 48000, w))
    with pytest.raises(AssertionError):
        su.warp_frequency_vector(FREQS, 48000, 1.0)


# -------------------------------------------- group delay and minimum phase


@pytest.mark.parametrize("delta_f", [1, 46.875])
@pytest.mark.parametrize("complex_input", [False, True])
def test_group_delay_direct_matches_jax(delta_f, complex_input):
    data = (MAG * np.exp(1j * PHASE)).astype(np.complex64) if complex_input else PHASE
    got = backend.group_delay_direct(_t(data), delta_f)
    want = jbackend.group_delay_direct(jnp.asarray(data), delta_f)
    assert_close(got, np.asarray(want), 2e-5, "group delay")
    got1 = backend.group_delay_direct(_t(data.T.copy()), delta_f, axis=1)
    assert_close(got1.T, np.asarray(want), 2e-5, "group delay axis 1")


@pytest.mark.parametrize("whole,unwrapped,odd", [(False, True, False), (False, False, True),
                                                 (True, True, False)])
def test_minimum_phase_from_magnitude_matches_jax(whole, unwrapped, odd):
    got = backend.minimum_phase_from_magnitude(_t(MAG), whole, unwrapped, odd)
    want = jbackend.minimum_phase_from_magnitude(jnp.asarray(MAG), whole, unwrapped, odd)
    assert_close(got, np.asarray(want), 2e-5, "minimum phase")


def test_group_delay_filter_matches_jax_and_scipy():
    b = (RNG.standard_normal(700) * np.exp(-np.arange(700) / 60)).astype(np.float32)
    for n in (257, 4097):
        f, gd = group_delay_filter([b, [1]], n, 48000)
        jf, jgd = jfh.group_delay_filter([b, [1]], n, 48000)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(gd, jgd)
    # against scipy's float64 polynomial evaluation (Horner) on the same
    # grid, for the FIR and for an IIR filter below its stopband (where its
    # response vanishes both divide 0 by 0)
    _, want = scipy_group_delay([b.astype(np.float64), [1.0]], w=np.linspace(0, np.pi, 4097))
    assert_close(group_delay_filter([b, [1]], 4097, 48000)[1] * 48000, want, 1e-9, "FIR")
    ba = Filter.from_sos(butter(4, 1000, fs=48000, output="sos"), 48000).get_coefficients(
        FilterCoefficientsType.Ba)
    f, gd = group_delay_filter(ba, 513, 48000)
    _, want = scipy_group_delay(ba, w=np.linspace(0, np.pi, 513))
    keep = f < 4000
    assert_close(gd[keep] * 48000, want[keep], 1e-6, "IIR")


def test_filter_get_group_delay_matches_jax():
    sos = butter(6, [300, 3000], btype="bandpass", fs=48000, output="sos")
    freqs = np.linspace(20, 20000, 300)
    got = Filter.from_sos(sos, 48000).get_group_delay(freqs)
    want = JFilter.from_sos(sos, 48000).get_group_delay(freqs)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    got_s = Filter.from_sos(sos, 48000).get_group_delay(freqs, in_seconds=False)
    np.testing.assert_allclose(got_s, want * 48000, rtol=1e-12)
    assert len(Filter.from_ba(np.ones(7), [1.0], 48000)) == 7


# ======== ar_estimation ======================================================
from scipy.signal import lfilter  # noqa: E402

from dsptoolbox_tpu.helpers import ar_estimation as jar  # noqa: E402
from dsptoolbox_tpu_torch.helpers import ar_estimation  # noqa: E402

# 512-sample frames (time first): white noise, and resonant AR(2) frames
# whose reflection coefficients approach 1
AR_FRAMES = RNG.standard_normal((512, 24, 2))
AR_FRAMES[:, :12] = lfilter([1.0], [1.0, -1.8, 0.95], AR_FRAMES[:, :12], axis=0)


@pytest.mark.parametrize("name", ["yule_walker_ar", "burg_ar"])
@pytest.mark.parametrize("order", [1, 4, 16])
def test_ar_estimation_matches_jax(name, order):
    """numpy in, numpy out; a tensor stays a tensor on its device, in
    float64; both within 1e-10 of the JAX package's float64 numpy."""
    want_a, want_e = getattr(jar, name)(AR_FRAMES, order)
    a, e = getattr(ar_estimation, name)(AR_FRAMES, order)
    assert isinstance(a, np.ndarray) and a.shape == (order + 1, 24, 2)
    assert_close(a, want_a, 1e-10, f"{name} coefficients")
    assert_close(e, want_e, 1e-10, f"{name} error")
    ta, te = getattr(ar_estimation, name)(torch.from_numpy(AR_FRAMES).float(), order)
    assert ta.dtype == torch.float64 and ta.device.type == "cpu"
    wa, we = getattr(jar, name)(AR_FRAMES.astype(np.float32), order)
    assert_close(ta.numpy(), wa, 1e-10, f"{name} from float32")
    assert_close(te.numpy(), we, 1e-10, f"{name} error from float32")


def test_burg_ar_of_one_channel_and_levinson_durbin_match_jax():
    x = AR_FRAMES[:, 0, 0]
    a, e = ar_estimation.burg_ar(x, 8)
    ja, je = jar.burg_ar(x, 8)
    assert a.shape == (9,) and np.ndim(e) == 0
    assert_close(a, ja, 1e-10, "burg 1-D")
    np.testing.assert_allclose(e, je, rtol=1e-10)
    r = np.stack([np.correlate(AR_FRAMES[:, k, 0], AR_FRAMES[:, k, 0], "full")[511:520]
                  for k in range(24)], axis=1) / 512
    a, e = ar_estimation.levinson_durbin_recursion(r)
    ja, je = jar.levinson_durbin_recursion(r)
    assert_close(a, ja, 1e-10, "levinson")
    assert_close(e, je, 1e-10, "levinson error")
    # a singular autocorrelation gives NaN or inf downstream, no exception
    a, _ = ar_estimation.levinson_durbin_recursion(np.zeros((3, 2)))
    assert not np.isfinite(a[1:]).any()

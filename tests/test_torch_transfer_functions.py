"""The port's transfer-function measurement path (`dsptoolbox_tpu_torch`:
`generators.chirp` → `transfer_functions.spectral_deconvolve` → `window_ir`
→ `complex_smoothing`, the `ImpulseResponse` and `Spectrum` classes, the
banded operator of kernel B4) against the JAX package on the CPU: the same
seeded numpy inputs through both. The JAX package's Pallas banded kernel
runs in interpret mode. Sizes are small: ~2 s at 48 kHz, 3 channels, IR
windows of 4096 samples (2049 bins: the JAX package's dense smoothing
operator, the port's banded one) and 8192 samples (4097 bins: banded on
both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import assert_close
from torch_checks import assert_finite_close, assert_phase_close, phase_range
from dsptoolbox_tpu import classes as jclasses
from dsptoolbox_tpu import generators as jgen
from dsptoolbox_tpu import transfer_functions as jtf
from dsptoolbox_tpu.ops.pallas_banded import banded_matmul as jax_banded_matmul
from dsptoolbox_tpu.standard import enums as jenums
from dsptoolbox_tpu.transfer_functions import _backend as jbk
from dsptoolbox_tpu_torch import _config, generators
from dsptoolbox_tpu_torch import transfer_functions as tf
from dsptoolbox_tpu_torch.classes import ImpulseResponse, Signal, Spectrum
from dsptoolbox_tpu_torch.helpers.other import unwrap
from dsptoolbox_tpu_torch.ops import banded
from dsptoolbox_tpu_torch.standard.enums import (
    FrequencySpacing,
    SpectrumMethod,
    SpectrumScaling,
    SpectrumType,
    Window,
)
from dsptoolbox_tpu_torch.transfer_functions import _backend as bk

torch.set_num_threads(1)

FS = 48000
SECONDS = 1.5
PAD_S = 0.5
CHANNELS = 3
DELAYS = (96, 211, 430)  # samples, one per channel


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's classes put numpy data on the default device, "cuda"
    out of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _rooms(n_samples, seed=0):
    """Synthetic room IRs ``(n_samples, CHANNELS)``, float64: a delay,
    exponentially decaying noise (RT60 ≈ 0.3 s) and −60 dB noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / FS
    irs = np.zeros((n_samples, CHANNELS))
    for c, d in enumerate(DELAYS):
        tail = rng.standard_normal(n_samples - d) * np.exp(-6.9 * t[: n_samples - d] / 0.3)
        irs[d:, c] = 0.2 * tail
        irs[d, c] = 1.0
    return irs + 1e-3 * rng.standard_normal(irs.shape)


@pytest.fixture(scope="module")
def measurement():
    """The JAX package's SyncLog sweep, the recording (sweep convolved
    with `_rooms` in float64, float32) and the JAX package's IRs."""
    jsweep, _ = jgen.chirp(
        FS, jgen.ChirpType.SyncLog, [20, 20000], SECONDS, padding_end_seconds=PAD_S
    )
    sweep = np.asarray(jsweep.time_data)[:, 0].astype(np.float64)
    rooms = _rooms(4000)
    rec = np.stack(
        [np.convolve(sweep, rooms[:, c])[: len(sweep)] for c in range(CHANNELS)], 1
    ).astype(np.float32)
    exc = sweep.astype(np.float32)[:, None]
    j_ir = jtf.spectral_deconvolve(
        jclasses.Signal(None, rec, FS), jclasses.Signal(None, exc, FS)
    )
    return dict(exc=exc, rec=rec, j_ir_td=np.asarray(j_ir.time_data))


# ------------------------------------------------------------------ sweep


@pytest.mark.parametrize("kind", ["SyncLog", "Logarithmic", "Linear"])
def test_chirp_matches_jax(kind):
    # sin of the same float32 phase on both sides, then the same float32
    # normalization and fade ramps: ~1 ulp apart
    kw = dict(range_hz=[20, 20000], length_seconds=0.5, padding_end_seconds=0.1,
              number_of_channels=2)
    want = jgen.chirp(FS, getattr(jgen.ChirpType, kind), **kw)
    got = generators.chirp(FS, getattr(generators.ChirpType, kind), **kw)
    if kind == "SyncLog":
        (want, want_T), (got, got_T) = want, got
        assert got_T == want_T
    assert got.device.type == "cpu"
    assert got.time_data.shape == (int(0.5 * FS) + int(0.1 * FS), 2)
    np.testing.assert_allclose(got.time_data.numpy(), np.asarray(want.time_data),
                               atol=1e-6, rtol=0)


# ------------------------------------------------------- deconvolution


@pytest.mark.parametrize(
    "case",
    ["auto", "explicit2", "explicit4", "mono_broadcast", "padding",
     "padding_keep_length"],
)
def test_spectral_deconvolve_matches_jax(measurement, case):
    # the JAX package's own tolerance against the reference
    # (tests/test_transfer_functions.py:505-508)
    rec, exc = measurement["rec"], measurement["exc"]
    kw = {}
    if case == "explicit2":
        kw["start_stop_hz"] = [50.0, 15000.0]
    elif case == "explicit4":
        kw["start_stop_hz"] = [30.0, 60.0, 14000.0, 18000.0]
    elif case == "padding":
        kw["padding"] = True
    elif case == "padding_keep_length":
        kw.update(padding=True, keep_original_length=True)
    if case == "mono_broadcast":
        j_in, t_in = exc, exc
    else:  # one excitation column per channel, channel 0 sets the range
        j_in = t_in = np.repeat(exc, CHANNELS, axis=1) * np.array([1.0, 0.5, 2.0],
                                                                   np.float32)
    want = np.asarray(jtf.spectral_deconvolve(
        jclasses.Signal(None, rec, FS), jclasses.Signal(None, j_in, FS), **kw
    ).time_data)
    rec_sig, in_sig = Signal(None, rec, FS), Signal(None, t_in, FS)
    params = (dict(rec_sig._spectrum_parameters), dict(in_sig._spectrum_parameters))
    got = tf.spectral_deconvolve(rec_sig, in_sig, **kw)
    assert isinstance(got, ImpulseResponse)
    assert got.spectrum_method == SpectrumMethod.FFT
    assert (rec_sig._spectrum_parameters, in_sig._spectrum_parameters) == params
    assert rec_sig.spectrum_method == SpectrumMethod.WelchPeriodogram
    np.testing.assert_allclose(got.time_data.numpy(), want, rtol=1e-3,
                               atol=2e-5 * np.max(np.abs(want)))


def test_deconvolve_finds_the_delays(measurement):
    ir = tf.spectral_deconvolve(Signal(None, measurement["rec"], FS),
                                Signal(None, measurement["exc"], FS))
    peaks = ir.time_data.abs().argmax(dim=0).tolist()
    assert peaks == list(DELAYS)


def test_spectral_deconvolve_rejects_bad_ranges(measurement):
    rec = Signal(None, measurement["rec"], FS)
    exc = Signal(None, measurement["exc"], FS)
    with pytest.raises(ValueError, match="2 or 4"):
        tf.spectral_deconvolve(rec, exc, start_stop_hz=[10.0, 20.0, 30.0])
    with pytest.raises(AssertionError):
        tf.spectral_deconvolve(rec, exc, apply_regularization=False,
                               start_stop_hz=[10.0, 20.0])


# ------------------------------------------------------------ window_ir


@pytest.mark.parametrize("window", ["Hann", "Blackman"])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("total_length", [4096, 8192])
def test_window_ir_matches_jax(measurement, window, adaptive, total_length):
    # the JAX package's fused-vs-host windowing tolerance
    # (tests/test_transfer_functions.py:570-578): 2e-6 of the scale, and
    # identical start positions
    td = measurement["j_ir_td"]
    kw = dict(adaptive=adaptive, offset_samples=40,
              left_to_right_flank_length_ratio=0.8)
    j_sig, j_starts = jtf.window_ir(
        jclasses.ImpulseResponse(None, td, FS), total_length,
        window_type=getattr(jenums.Window, window), **kw,
    )
    sig, starts = tf.window_ir(
        ImpulseResponse(None, td, FS), total_length,
        window_type=getattr(Window, window), **kw,
    )
    assert isinstance(starts, np.ndarray)
    np.testing.assert_array_equal(starts, np.asarray(j_starts))
    want = np.asarray(j_sig.time_data)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(sig.time_data.numpy(), want, atol=2e-6 * scale,
                               rtol=2e-6)
    np.testing.assert_allclose(np.asarray(sig.window), np.asarray(j_sig.window),
                               atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("offset", [0, 40])
def test_window_ir_matches_the_host_tukey_window_per_channel(measurement, adaptive, offset):
    # the fused device path against the host index arithmetic applied to
    # each channel in numpy (`_backend.window_this_ir_tukey`), as the JAX
    # package's tests/test_transfer_functions.py:537 holds its fused path
    td = measurement["j_ir_td"][:6000]
    got, window_dev, starts = (lambda r: (r[0].time_data.numpy(), r[0].window, r[1]))(
        tf.window_ir(ImpulseResponse(None, td, FS), 2048, adaptive, 0.75,
                     offset_samples=offset))
    for c in range(CHANNELS):
        want, win, start = bk.window_this_ir_tukey(td[:, c].astype(np.float64), 2048,
                                                   Window.Hann, 0.75, True, offset, 1.0,
                                                   adaptive)
        assert starts[c] == start
        np.testing.assert_allclose(np.asarray(window_dev)[:, c], win, atol=2e-6)
        assert_close(got[:, c], want, 2e-6, f"channel {c}")


def test_window_ir_return_device_keeps_starts_on_device(measurement):
    ir = ImpulseResponse(None, measurement["j_ir_td"], FS)
    _, starts = tf.window_ir(ir, 4096, return_device=True)
    assert isinstance(starts, torch.Tensor)
    _, host = tf.window_ir(ir, 4096)
    np.testing.assert_array_equal(starts.numpy(), host)


# ------------------------------------------------------ complex smoothing


def _ir_for_smoothing(total_length, seed=1):
    """A short decaying IR whose peak sits 20 samples in: a small phase
    slope, so the unwrapped phase stays below ~100 rad (see
    `test_complex_smoothing_matches_jax`)."""
    rng = np.random.default_rng(seed)
    t = np.arange(total_length)
    td = 0.1 * rng.standard_normal((total_length, CHANNELS))
    td *= np.exp(-t / 100.0)[:, None]
    td[20] += 0.9
    return td.astype(np.float32)


@pytest.fixture(scope="module")
def smoothing_inputs():
    return {n: _ir_for_smoothing(n) for n in (4096, 8192)}


@pytest.mark.parametrize("octave", [3, 6])
@pytest.mark.parametrize("total_length", [4096, 8192])
@pytest.mark.parametrize("domain", ["RealImaginary", "PowerPhase", "MagnitudePhase",
                                    "Power", "Magnitude", "EquivalentComplex"])
def test_complex_smoothing_matches_jax(smoothing_inputs, domain, total_length, octave):
    # 1e-4 scale-relative, the JAX package's tolerance against the
    # reference (tests/test_transfer_functions.py:293-297). Both sides
    # smooth in float32 with different summation orders, and the phase
    # domains unwrap with a float32 cumulative sum and smooth the unwrapped
    # phase, so their error grows with its range: measured ~4.5e-7 of the
    # scale per rad (6e-5 at 139 rad, 1.1e-4 at 267 rad). With the peak 20
    # samples in, the phase stays below ~100 rad; a range of ~5·10³ rad is
    # held against float64 in `test_phase_domains_at_a_large_phase_range`
    td = smoothing_inputs[total_length]
    want = jtf.complex_smoothing(jclasses.ImpulseResponse(None, td, FS), octave,
                                 getattr(jtf.SmoothingDomain, domain))
    got = tf.complex_smoothing(ImpulseResponse(None, td, FS), octave,
                               getattr(tf.SmoothingDomain, domain))
    assert isinstance(got, Spectrum) and got.is_complex
    np.testing.assert_array_equal(got.frequency_vector_hz, want.frequency_vector_hz)
    assert_close(got.spectral_data.numpy(), np.asarray(want.spectral_data), 1e-4,
                 f"{domain} 1/{octave} over {total_length // 2 + 1} bins")


def _late_peak_ir(total_length=8192, seed=3):
    """IRs whose peaks sit 1500-1700 samples in, over a −60 dB floor:
    an unwrapped phase of ~5·10³ rad over 4097 bins, as on the
    measurement path's 32,769 bins, and no bin near zero, so the float32
    and float64 spectra unwrap to the same branch."""
    rng = np.random.default_rng(seed)
    t = np.arange(total_length)
    td = 1e-3 * rng.standard_normal((total_length, CHANNELS))
    for c, d in enumerate((1500, 1600, 1700)):
        td[d:, c] += 0.1 * rng.standard_normal(total_length - d) * np.exp(
            -t[: total_length - d] / 100.0)
        td[d, c] += 0.9
    return td.astype(np.float32)


@pytest.mark.parametrize("domain", ["MagnitudePhase", "EquivalentComplex"])
def test_phase_domains_at_a_large_phase_range(domain):
    # The port and the JAX package against the float64 host smoothing of
    # the float64 spectrum, where the phase spans ~5·10³ rad. Magnitudes:
    # 1e-4 scale-relative. MagnitudePhase smooths the unwrapped phase
    # itself: a float32 weighted sum of up to S terms of size ≤ R drifts by
    # ~2^-24·R·sqrt(S) in a random walk (0.010 rad here, S = 1024), so each
    # side's phase is held at twice that, and the two sides at four times.
    # EquivalentComplex takes the angle of the real/imaginary smoothing s1,
    # which cancels where the phase turns within the band: its phase is
    # held where |s1| ≥ 0.1·sqrt(smoothed power), at 2·2^-24·sqrt(S) / 0.1
    # (the sum's relative error over that floor), 2e-5 rad here
    td = _late_peak_ir()
    f = np.fft.rfftfreq(len(td), 1 / FS)
    wy = Window.Hann(3000, True)
    sp64 = np.fft.rfft(td.astype(np.float64), axis=0)
    phi64 = np.unwrap(np.angle(sp64), axis=0)
    R = float(np.abs(phi64).max())
    assert R > 4000
    s1 = bk.complex_smoothing_host(sp64, f, 3, wy)
    power = bk.complex_smoothing_host(np.abs(sp64) ** 2, f, 3, wy)
    S = max(seg["span"] for seg in bk.device_banded_plan(
        bk._plan_key(f, 3, wy), torch.float32, torch.device("cpu")))
    drift = 2.0**-24 * R * np.sqrt(S)
    if domain == "MagnitudePhase":
        want = bk.complex_smoothing_host(np.abs(sp64), f, 3, wy) * np.exp(
            1j * bk.complex_smoothing_host(phi64, f, 3, wy))
        held = np.ones(want.shape, bool)
        tol = 2 * drift
    else:
        want = np.sqrt(power) * np.exp(1j * np.angle(s1))
        held = np.abs(s1) >= 0.1 * np.sqrt(power)
        tol = 2 * 2.0**-24 * np.sqrt(S) / 0.1
    assert held.any()
    got = {
        "port": tf.complex_smoothing(ImpulseResponse(None, td, FS), 3,
                                     getattr(tf.SmoothingDomain, domain)
                                     ).spectral_data.numpy(),
        "jax": np.asarray(jtf.complex_smoothing(
            jclasses.ImpulseResponse(None, td, FS), 3,
            getattr(jtf.SmoothingDomain, domain)).spectral_data),
    }
    for side, g in got.items():
        assert_close(np.abs(g), np.abs(want), 1e-4, f"{side} {domain} magnitude")
        dphi = np.abs(np.angle(g * np.conj(want)))[held].max()
        assert dphi <= tol, f"{side} {domain} phase off by {dphi:.3e} > {tol:.3e} rad"
    apart = np.abs(np.angle(got["port"] * np.conj(got["jax"])))[held].max()
    assert apart <= 2 * tol, f"{domain}: port and JAX phases {apart:.3e} rad apart"


def test_complex_smoothing_rejects_bad_octave(smoothing_inputs):
    with pytest.raises(AssertionError):
        tf.complex_smoothing(ImpulseResponse(None, smoothing_inputs[4096], FS), 0,
                             tf.SmoothingDomain.Power)


@pytest.mark.parametrize("octave", [3, 5, 6])
def test_banded_plan_equals_jax_and_crosses_to_torch(octave):
    F = 6000
    freqs = np.fft.rfftfreq(2 * (F - 1), 1 / FS)
    key = (F, float(freqs[0]), float(freqs[1] - freqs[0]), float(octave),
           tuple(Window.Hann(3000, True).tolist()))
    want = jbk._banded_smoothing_plan(*key)
    got = bk._banded_smoothing_plan(*key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["rows"] == w["rows"]
        np.testing.assert_array_equal(g["offsets"], w["offsets"])
        np.testing.assert_array_equal(g["slab"], w["slab"])
    for seg, w in zip(banded.plan_to_torch(want, "cpu"), want):
        assert seg["rows"] == w["rows"] and seg["span"] == w["slab"].shape[2]
        assert seg["offsets"].dtype == torch.int32
        np.testing.assert_array_equal(seg["offsets"].numpy(), w["offsets"])
        np.testing.assert_array_equal(seg["slab"].numpy(), w["slab"])


def test_device_plan_is_cached():
    key = bk._plan_key(np.fft.rfftfreq(8190, 1 / FS), 3, Window.Hann(3000, True))
    a = bk.device_banded_plan(key, torch.float32, torch.device("cpu"))
    b = bk.device_banded_plan(key, torch.float32, torch.device("cpu"))
    assert a is b


def test_complex_smoothing_banded_matches_host_oracle():
    # the JAX package's banded-vs-host tolerance
    # (tests/test_transfer_functions.py:321-341), against its float64
    # host oracle
    rng = np.random.default_rng(4)
    F = 6000
    freqs = np.fft.rfftfreq(2 * (F - 1), 1 / FS)
    x = (rng.standard_normal((F, 2)) + 1j * rng.standard_normal((F, 2))).astype(
        np.complex64)
    wy = Window.Hann(3000, True)
    want = jbk.complex_smoothing_host(x, freqs, 5, wy)
    np.testing.assert_array_equal(bk.complex_smoothing_host(x, freqs, 5, wy), want)
    got = bk.complex_smoothing_banded(torch.from_numpy(x), freqs, 5, wy).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
    real = bk.complex_smoothing_banded(torch.from_numpy(x.real.copy()), freqs, 5, wy)
    assert np.abs(real.numpy() - want.real).max() / np.abs(want).max() < 2e-6


@pytest.mark.parametrize("C", [1, 2, 5])
def test_banded_matmul_plain_matches_pallas_interpret(C):
    # the JAX package's Pallas-vs-XLA tolerance
    # (tests/test_transfer_functions.py:343-369), on ragged shapes
    rng = np.random.default_rng(7 + C)
    nb, tr, span = 3, 128, 256
    slab = rng.standard_normal((nb, tr, span)).astype(np.float32)
    offsets = np.array([0, 101, 333], np.int32)
    x = rng.standard_normal((1000, C)).astype(np.float32)
    want = np.asarray(jax_banded_matmul(jnp.asarray(slab), jnp.asarray(offsets),
                                        jnp.asarray(x), interpret=True))
    got = banded.banded_matmul_plain(torch.from_numpy(slab),
                                     torch.from_numpy(offsets), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the dispatcher on a one-segment plan whose last tile is cut short
    seg = {"rows": nb * tr - 5, "span": span, "offsets": torch.from_numpy(offsets),
           "slab": torch.from_numpy(slab)}
    torch.testing.assert_close(banded.banded_apply([seg], torch.from_numpy(x)),
                               got[: nb * tr - 5], rtol=0, atol=0)


def _tf32(v):
    """``cvt.rna.tf32.f32``: a float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)  # v - hi is exact in float32


def banded_3xtf32(slab, offsets, x_padded):
    """numpy emulation of the CUDA kernel's product (`csrc/banded.cu`) for
    one segment: both operands split into TF32 hi + lo parts, the three
    products lo·hi, hi·lo, hi·hi of every k8 step (exact in float64, as
    on the tensor cores) added to float32 sums; rows of x outside [0, F)
    read as zero. Returns ``(NB·TR, C)`` float32."""
    nb, tr, span = slab.shape
    F, C = x_padded.shape
    idx = np.asarray(offsets, np.int64)[:, None] + np.arange(span)
    xg = np.where(((idx >= 0) & (idx < F))[..., None],
                  x_padded[np.clip(idx, 0, F - 1)], np.float32(0))
    ahi, alo = _split_tf32(slab)
    bhi, blo = _split_tf32(xg)
    acc = np.zeros((nb, tr, C), np.float32)
    for k in range(0, span, 8):
        ks = slice(k, k + 8)
        for a, b in ((alo, bhi), (ahi, blo), (ahi, bhi)):
            step = np.matmul(a[:, :, ks].astype(np.float64), b[:, ks].astype(np.float64))
            acc = acc + step.astype(np.float32)
    return acc.reshape(nb * tr, C)


def _terms(slab, offsets, x_padded):
    """Σ_k |slab·x| of each output: the scale of a float32 dot product's
    rounding."""
    return banded.banded_matmul_plain(torch.from_numpy(np.abs(slab)),
                                      torch.from_numpy(offsets),
                                      torch.from_numpy(np.abs(x_padded))).numpy()


def test_banded_3xtf32_emulation_on_the_pallas_inputs():
    """The three-TF32-product split of the CUDA kernel on the JAX package's
    Pallas banded kernel's test inputs (N(0, 1) weights and x): within 1e-5
    of the sum of the terms' magnitudes of the plain version, and within
    the Pallas-vs-XLA 1e-4 of the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(8)
    slab = rng.standard_normal((3, 128, 256)).astype(np.float32)
    offsets = np.array([0, 101, 333], np.int32)
    x = rng.standard_normal((1000, 5)).astype(np.float32)
    got = banded_3xtf32(slab, offsets, x)
    plain = banded.banded_matmul_plain(torch.from_numpy(slab), torch.from_numpy(offsets),
                                       torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - plain) <= 1e-5 * _terms(slab, offsets, x))
    want = np.asarray(jax_banded_matmul(jnp.asarray(slab), jnp.asarray(offsets),
                                        jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # one TF32 product alone misses the same bound: the split is what
    # carries float32's accuracy
    one = np.einsum("bts,bsc->btc", _tf32(slab).astype(np.float64),
                    _tf32(x[offsets[:, None] + np.arange(256)]).astype(np.float64))
    assert np.abs(one.reshape(-1, 5) - plain).max() > 1e-3


def test_banded_3xtf32_emulation_on_a_smoothing_plan(monkeypatch):
    """The split at a 4097-bin grid's 1/3-octave plan: every segment within
    1e-5 of the terms' magnitudes of the plain version, and the smoothing
    through it within 1e-4 of the float64 host smoothing."""
    rng = np.random.default_rng(5)
    freqs = np.fft.rfftfreq(8192, 1 / FS)
    wy = Window.Hann(3000, True)
    plan = bk._banded_smoothing_plan(*bk._plan_key(freqs, 3, wy))
    x = rng.standard_normal((4097 + max(seg["slab"].shape[2] for seg in plan), 4)).astype(
        np.float32)
    for seg in plan:
        got = banded_3xtf32(seg["slab"], seg["offsets"], x)
        plain = banded.banded_matmul_plain(torch.from_numpy(seg["slab"]),
                                           torch.from_numpy(seg["offsets"]),
                                           torch.from_numpy(x)).numpy()
        assert np.all(np.abs(got - plain) <= 1e-5 * _terms(seg["slab"], seg["offsets"], x))

    def emulated(plan, x_padded):
        xp = x_padded.numpy()
        return torch.from_numpy(np.concatenate(
            [banded_3xtf32(seg["slab"].numpy(), seg["offsets"].numpy(), xp)[: seg["rows"]]
             for seg in plan]))

    monkeypatch.setattr(bk, "banded_apply", emulated)
    sp = (rng.standard_normal((4097, 2)) + 1j * rng.standard_normal((4097, 2))).astype(
        np.complex64)
    got = bk.complex_smoothing_banded(torch.from_numpy(sp), freqs, 3, wy).numpy()
    want = bk.complex_smoothing_host(sp, freqs, 3, wy)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_unwrap_matches_numpy_and_jax():
    rng = np.random.default_rng(9)
    p = np.cumsum(rng.uniform(-3.5, 3.5, (2000, 3)), axis=0)
    p = np.angle(np.exp(1j * p)).astype(np.float32)
    got = unwrap(torch.from_numpy(p), dim=0).numpy()
    np.testing.assert_allclose(got, np.unwrap(p, axis=0), atol=2e-3, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jnp.unwrap(jnp.asarray(p), axis=0)),
                               atol=2e-3, rtol=0)
    edge = torch.tensor([0.0, np.pi, 0.0, -np.pi], dtype=torch.float64)
    np.testing.assert_array_equal(unwrap(edge).numpy(), np.unwrap(edge.numpy()))


# ---------------------------------------------------------------- classes


def test_impulse_response_and_spectrum_match_jax(smoothing_inputs):
    td = smoothing_inputs[4096][:4001]  # not 5-smooth: next_fast_len pads
    j_ir = jclasses.ImpulseResponse(None, td, FS)
    ir = ImpulseResponse(None, td, FS)
    assert ir.spectrum_method == SpectrumMethod.FFT
    assert ir.device.type == "cpu" and ir.number_of_channels == CHANNELS
    assert ir.length_seconds == pytest.approx(j_ir.length_seconds)
    np.testing.assert_allclose(ir.time_vector_s, j_ir.time_vector_s)
    f, sp = ir.get_spectrum()
    jf, jsp = j_ir.get_spectrum()
    np.testing.assert_allclose(f, jf)
    assert_close(sp.numpy(), np.asarray(jsp), 2e-6, "IR FFT spectrum")

    spec = Spectrum.from_signal(ir, complex=True)
    j_spec = jclasses.Spectrum.from_signal(j_ir, complex=True)
    assert spec.spectrum_type == SpectrumType.Complex and spec.is_complex
    assert spec.number_frequency_bins == j_spec.number_frequency_bins
    assert spec.frequency_vector_type == FrequencySpacing.Linear
    assert spec.spectral_data.dtype == torch.complex64
    mag = Spectrum.from_signal(ir)
    assert mag.is_magnitude and mag.spectrum_type == SpectrumType.Magnitude
    assert_close(mag.spectral_data.numpy(),
                 np.asarray(jclasses.Spectrum.from_signal(j_ir).spectral_data), 2e-6,
                 "magnitude spectrum")

    copy = spec.copy()
    copy.spectral_data[0, 0] = 7.0
    assert spec.spectral_data[0, 0] != 7.0
    with pytest.raises(AssertionError, match="increasing"):
        Spectrum(f[::-1], sp)
    log = Spectrum(np.geomspace(20, 20000, 31), np.ones(31))
    assert log.frequency_vector_type == FrequencySpacing.Logarithmic
    assert log.spectral_data.shape == (31, 1) and log.spectral_data.dtype == torch.float32


def test_signal_welch_spectrum_matches_jax():
    x = np.random.default_rng(2).standard_normal((9000, 1)).astype(np.float32)
    j_sig, sig = jclasses.Signal(None, x, FS), Signal(None, x, FS)
    jf, jsp = j_sig.get_spectrum()
    f, sp = sig.get_spectrum()
    assert sp.shape == (513,)  # parity: mono Welch spectra are 1-D
    np.testing.assert_allclose(f, jf)
    assert_close(sp.numpy(), np.asarray(jsp), 2e-5, "Welch spectrum")


def test_class_edges_and_unported_options():
    td = np.zeros((512, 2), np.float32)
    td[10] = 1.0
    ir = ImpulseResponse(None, td, FS)
    with pytest.raises(AssertionError):
        ir.set_window(np.ones((10, 2)))
    ir.set_window(np.ones((512, 2)))
    new = ir.copy_with_new_time_data(np.ones((256, 2), np.float32) * 0.5)
    assert isinstance(new, ImpulseResponse) and not hasattr(new, "window")
    assert new.spectrum_method == SpectrumMethod.FFT and new.device == ir.device
    assert not hasattr(ir.copy().clear_time_window(), "window")
    assert hasattr(ir, "window")
    from_sig = ImpulseResponse.from_signal(Signal(None, td + 1j * td, FS))
    assert from_sig.is_complex_signal
    # smoothed and physically scaled FFT spectra are ported: as the JAX
    # package's (tests/test_torch_spectrum.py holds every scaling)
    j_ir = jclasses.ImpulseResponse(None, td, FS)
    ir.clear_time_window()
    ir.spectrum_smoothing = 3
    j_ir.set_spectrum_parameters(method=jenums.SpectrumMethod.FFT, smoothing=3)
    assert_close(ir.get_spectrum()[1].numpy(), np.asarray(j_ir.get_spectrum()[1]), 2e-5,
                 "smoothed")
    ir.spectrum_smoothing = 0
    ir.spectrum_scaling = SpectrumScaling.AmplitudeSpectrum
    j_ir.set_spectrum_parameters(method=jenums.SpectrumMethod.FFT,
                                 scaling=jenums.SpectrumScaling.AmplitudeSpectrum)
    assert_close(ir.get_spectrum()[1].numpy(), np.asarray(j_ir.get_spectrum()[1]), 2e-5,
                 "amplitude spectrum")


# ------------------------------------------------- the rest of the module
# (window_ir_tukey … trim_ir): each against the JAX package on the same
# seeded IRs, at 2e-5 scale-relative unless the JAX package's own test
# (tests/test_transfer_functions.py) states another tolerance


def _irs(n=8192, seed=4):
    """Three room-like IRs ``(n, 3)`` float32 from `_rooms`, peak 1."""
    return _rooms(n, seed).astype(np.float32)


def _ir_pair(td):
    return ImpulseResponse(None, td.copy(), FS), jclasses.ImpulseResponse(None, td.copy(), FS)


@pytest.mark.parametrize("flanks", [(0.01, None), (None, 0.02), (0.005, 0.03)])
@pytest.mark.parametrize("window", ["Hann", "Blackman"])
def test_window_ir_tukey_matches_jax(flanks, window):
    p, j = _ir_pair(_irs(4096))
    got = tf.window_ir_tukey(p, *flanks, getattr(Window, window))
    want = jtf.window_ir_tukey(j, *flanks, getattr(jenums.Window, window))
    assert isinstance(got, ImpulseResponse) and got.device.type == "cpu"
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 2e-5, "windowed")
    np.testing.assert_array_equal(np.asarray(got.window), np.asarray(want.window))
    for bad in ((None, None, Window.Hann), (0.05, 0.05, Window.Hann),
                (0.01, 0.01, Window.Tukey)):
        with pytest.raises(AssertionError):
            tf.window_ir_tukey(p, *bad)


@pytest.mark.parametrize(
    "peaks,length",
    [((100, 2000, 4090), 1001),   # near the start, inside, near the end (flipped)
     ((500, 500, 4095), 1000),    # even length, the last sample
     ((2048, 1000, 0), 4096),     # the window as long as the IR: centred-even case
     ((3000, 10, 1500), 6000)],   # longer than the IR
    ids=["odd", "even", "whole", "longer"],
)
def test_window_centered_ir_matches_jax(peaks, length):
    rng = np.random.default_rng(6)
    td = (0.05 * rng.standard_normal((4096, 3))).astype(np.float32)
    for c, k in enumerate(peaks):
        td[k, c] = 1.0
    p, j = _ir_pair(td)
    got, starts = tf.window_centered_ir(p, length)
    want, jstarts = jtf.window_centered_ir(j, length)
    assert isinstance(starts, np.ndarray)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(np.asarray(got.window), np.asarray(want.window))
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 2e-5, "centered")
    # a peak past the window's half length flips the channel: the window
    # keeps the samples before the peak
    half = length // 2
    flipped = [k > half for k in peaks]
    assert any(flipped) or length >= 4096


def _tf_inputs(C=2, mono=True, n=16384, seed=8):
    """A noise input and its responses through C short FIR filters with
    noise, float64 (the JAX test's recipe, `tests/test_transfer_functions.py:79`)."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 1 if mono else C)) * 0.3
    firs = ([0.3, 0.2, 0.1], [0.1, -0.4, 0.2, 0.05], [1.0, 0.5], [0.2, 0.2, 0.2, 0.2])
    y = np.stack([lfilter(firs[c], [1.0], x[:, 0 if mono else c]) for c in range(C)], 1)
    return x, y + rng.standard_normal(y.shape) * 0.01


@pytest.mark.parametrize("mode", ["H1", "H2", "H3"])
@pytest.mark.parametrize("mono", [True, False])
@pytest.mark.parametrize("params", [dict(), dict(average="median", overlap_percent=75),
                                    dict(scaling="PowerSpectralDensity")],
                         ids=["default", "median", "psd"])
def test_compute_transfer_function_matches_jax(mode, mono, params):
    x, y = _tf_inputs(3, mono)
    p_in, j_in = Signal(None, x, 16000), jclasses.Signal(None, x, 16000)
    if "scaling" in params:
        p_in.set_spectrum_parameters(scaling=SpectrumScaling.PowerSpectralDensity)
        j_in.set_spectrum_parameters(scaling=jenums.SpectrumScaling.PowerSpectralDensity)
    elif params:
        p_in.set_spectrum_parameters(**params)
        j_in.set_spectrum_parameters(**params)
    for wl in (512, 1024):
        got = tf.compute_transfer_function(Signal(None, y, 16000), p_in, wl,
                                           getattr(tf.TransferFunctionType, mode))
        want = jtf.compute_transfer_function(jclasses.Signal(None, y, 16000), j_in, wl,
                                             getattr(jtf.TransferFunctionType, mode))
        assert got.is_complex and got.spectral_data.shape == (wl // 2 + 1, 3)
        np.testing.assert_array_equal(got.frequency_vector_hz, want.frequency_vector_hz)
        # the JAX package's tolerance (tests/test_transfer_functions.py:103-117);
        # the DC bin, a noise/noise ratio under detrend, is left out
        assert_close(got.spectral_data.numpy()[1:], np.asarray(want.spectral_data)[1:], 5e-4,
                     f"{mode} {wl}")
        assert got.has_coherence and got.coherence.shape == got.spectral_data.shape
        assert_close(got.coherence.numpy()[1:], np.asarray(want.coherence)[1:], 5e-4,
                     "coherence")


def test_compute_transfer_function_from_two_framings_equals_four_welch_calls():
    # one framing of x (mono) and one of y, against four `welch` calls on
    # the JAX package's inputs (x repeated to y's channels), and the
    # framing kernel's wrapper called exactly twice a call
    from dsptoolbox_tpu_torch.ops import cuda_framing, spectral

    x, y = _tf_inputs(4, True)
    xs, ys = Signal(None, x, 16000), Signal(None, y, 16000)
    calls = []
    real = cuda_framing.windowed_frames

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    kw = dict(sampling_rate_hz=16000, window_length_samples=1024, scaling=xs.spectrum_scaling)
    xr = xs._x.repeat(4, 1)
    G_xx = spectral.welch(xr, None, **kw)
    G_yy = spectral.welch(ys._x, None, **kw)
    G_xy = spectral.welch(xr, ys._x, **kw)
    G_yx = spectral.welch(ys._x, xr, **kw)
    spectral.windowed_frames = counted
    try:
        outs = {m: tf.compute_transfer_function(ys, xs, 1024, getattr(tf.TransferFunctionType, m))
                for m in ("H1", "H2", "H3")}
    finally:
        spectral.windowed_frames = real
    assert calls == [(1, len(x)), (4, len(x))] * 3
    want = {"H1": G_xy / G_xx, "H2": G_yy / G_yx,
            "H3": G_xy / G_xy.abs() * (G_yy / G_xx) ** 0.5}
    for m, got in outs.items():
        torch.testing.assert_close(got.spectral_data, want[m].T, rtol=1e-6, atol=0)
        torch.testing.assert_close(got.coherence, (G_xy.abs() ** 2 / G_xx / G_yy).T,
                                   rtol=1e-6, atol=0)


def test_compute_transfer_function_rejects_mismatches():
    x, y = _tf_inputs(3, False)
    with pytest.raises(AssertionError):
        tf.compute_transfer_function(Signal(None, y, 16000), Signal(None, x, 8000), 512)
    with pytest.raises(AssertionError):
        tf.compute_transfer_function(Signal(None, y[:, :2], 16000), Signal(None, x, 16000), 512)
    with pytest.raises(ValueError):
        tf.compute_transfer_function(Signal(None, y, 16000), Signal(None, x, 16000), 1000)


@pytest.mark.parametrize("time_average", [True, False])
@pytest.mark.parametrize("normalize_energy", [True, False])
def test_average_irs_matches_jax(time_average, normalize_energy):
    td = _irs() * np.array([1.0, 0.7, 0.4], np.float32)
    p, j = _ir_pair(td)
    got = tf.average_irs(p, time_average, normalize_energy)
    want = jtf.average_irs(j, time_average, normalize_energy)
    assert got.number_of_channels == 1
    name = f"{time_average} {normalize_energy}"
    if time_average:  # the JAX package's 1e-3 (tests/test_transfer_functions.py:418)
        assert_close(got.time_data.numpy(), np.asarray(want.time_data), 1e-3, name)
        return
    # frequency: the mean of the unwrapped phases (~10³ rad here), which the
    # JAX package sums in float32 numpy (its drift over 4097 bins is ~1e-3
    # rad); held at its own test's 2e-1 (tests/test_transfer_functions.py:390),
    # and against the same average in float64 at 5e-4
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 2e-1, name)
    # the float64 twin starts from the port's float32 spectrum and angle:
    # the unwrap's branch decisions on noise-like bins follow the float32
    # angle, so a float64 spectrum would take other branches
    sp = p.get_spectrum()[1].numpy()
    phase = np.unwrap(np.angle(sp).astype(np.float64), axis=0).mean(1)
    avg = np.abs(sp).astype(np.float64).mean(1) * np.exp(1j * phase)
    assert_close(got.time_data.numpy()[:, 0], np.fft.irfft(avg, n=8192), 5e-4, name)
    with pytest.raises(AssertionError):
        tf.average_irs(p.get_channels(0))


@pytest.mark.parametrize("ir_length", [None, 1024])
def test_min_phase_from_mag_matches_jax(ir_length):
    f = np.linspace(0, 4000, 257)
    mag = np.abs(np.random.default_rng(1).standard_normal((257, 2))) + 0.3
    got = tf.min_phase_from_mag(Spectrum(f, mag), 8000, ir_length)
    want = jtf.min_phase_from_mag(jclasses.Spectrum(f, mag.copy()), 8000, ir_length)
    assert isinstance(got, ImpulseResponse)
    # the JAX package's 1e-6 (tests/test_transfer_functions.py:189)
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 1e-6, "min phase IR")


@pytest.mark.parametrize("case", ["given", "minimum", "factor", "regrid"])
def test_lin_phase_from_mag_matches_jax(case):
    f = np.linspace(0, 4000, 257)
    mag = np.abs(np.random.default_rng(2).standard_normal((257, 2))) + 0.3
    kw = {"given": dict(group_delay_ms=20, check_causality=False),
          "minimum": dict(),
          "factor": dict(minimum_group_delay_factor=1.5),
          # causal check passes, and 400 ms is past the first grid's period
          "regrid": dict(group_delay_ms=400)}[case]
    got = tf.lin_phase_from_mag(Spectrum(f, mag), 8000, **kw)
    want = jtf.lin_phase_from_mag(jclasses.Spectrum(f, mag.copy()), 8000, **kw)
    assert got.length_samples == want.time_data.shape[0]
    # the JAX package's 5e-5 (tests/test_transfer_functions.py:206)
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 5e-5, case)


def test_lin_phase_from_mag_causality_assert_as_jax():
    f = np.linspace(0, 4000, 257)
    mag = np.abs(np.random.default_rng(2).standard_normal((257, 1))) + 0.3
    for pkg, spec in ((tf, Spectrum(f, mag)), (jtf, jclasses.Spectrum(f, mag.copy()))):
        with pytest.raises(AssertionError, match="lower than minimal group delay"):
            pkg.lin_phase_from_mag(spec, 8000, group_delay_ms=0.5)
        with pytest.raises(AssertionError, match="factor"):
            pkg.lin_phase_from_mag(spec, 8000, minimum_group_delay_factor=0.5)


@pytest.mark.parametrize("kw", [dict(), dict(padding_factor=1), dict(alpha=0.999)],
                         ids=["default", "pad1", "alpha"])
def test_min_phase_ir_matches_jax(kw):
    p, j = _ir_pair(_irs(4096))
    got = tf.min_phase_ir(p, **kw)
    want = jtf.min_phase_ir(j, **kw)
    assert isinstance(got, ImpulseResponse) and got.time_data.shape == (4096, 3)
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 2e-5, str(kw))


def test_min_phase_ir_scipy_branch_raises_as_jax():
    # parity: scipy's Hilbert minimum phase is half the input's length, so
    # writing it into the IR's column raises in the JAX package (ROADMAP C)
    p, j = _ir_pair(_irs(1024))
    with pytest.raises(ValueError):
        jtf.min_phase_ir(j, use_real_cepstrum=False)
    with pytest.raises(ValueError):
        tf.min_phase_ir(p, use_real_cepstrum=False)


@pytest.mark.parametrize("analytic", [True, False])
@pytest.mark.parametrize("remove_latency", [False, True])
@pytest.mark.parametrize("smoothing", [0, 3])
def test_group_delay_matches_jax(analytic, remove_latency, smoothing):
    p, j = _ir_pair(_irs(2048))
    f, got = tf.group_delay(p, analytic, smoothing, remove_latency)
    jf, want = jtf.group_delay(j, analytic, smoothing, remove_latency)
    np.testing.assert_allclose(f, jf)
    assert got.device.type == "cpu" and got.shape == (len(f), 3)
    # the JAX package's 1e-4 (tests/test_transfer_functions.py:166)
    assert_close(got.numpy(), want, 1e-4, f"{analytic} {remove_latency} {smoothing}")


def test_group_delay_matches_scipy_float64():
    from scipy.signal import group_delay as scipy_gd

    td = _irs(2048)
    f, got = tf.group_delay(ImpulseResponse(None, td, FS))
    for c in range(3):
        _, want = scipy_gd([td[:, c].astype(np.float64), [1.0]], w=f, fs=FS)
        assert_close(got[:, c].numpy() * FS, want, 1e-5, f"channel {c}")


@pytest.mark.parametrize("kw", [dict(), dict(padding_factor=1),
                                dict(use_real_cepstrum=False, padding_factor=2)],
                         ids=["default", "pad1", "scipy"])
def test_minimum_phase_and_group_delays_match_jax(kw):
    p, j = _ir_pair(_irs(2048))
    f, got = tf.minimum_phase(p, **kw)
    jf, want = jtf.minimum_phase(j, **kw)
    np.testing.assert_allclose(f, jf)
    # the JAX package's 1e-5 (tests/test_transfer_functions.py:180); scipy's
    # Hilbert method gives NaN at the same bins on both sides
    assert_finite_close(got.numpy(), want, 1e-5, f"minimum phase {kw}")
    if kw.get("use_real_cepstrum", True):
        for smoothing in (0, 6):
            kw2 = dict(smoothing=smoothing, padding_factor=kw.get("padding_factor", 8))
            assert_close(tf.minimum_group_delay(p, **kw2)[1].numpy(),
                         jtf.minimum_group_delay(j, **kw2)[1], 1e-5, f"min gd {kw2}")


@pytest.mark.parametrize("analytic", [True, False])
@pytest.mark.parametrize("remove_latency", [False, True])
def test_excess_group_delay_matches_jax(analytic, remove_latency):
    p, j = _ir_pair(_irs(2000))  # not 5-smooth: the minimum's grid differs
    for smoothing in (0, 3):
        f, got = tf.excess_group_delay(p, smoothing, remove_latency, analytic)
        jf, want = jtf.excess_group_delay(j, smoothing, remove_latency, analytic)
        np.testing.assert_allclose(f, jf)
        assert_close(got.numpy(), want, 1e-4, f"{analytic} {remove_latency} {smoothing}")


@pytest.mark.parametrize("keep_low", [True, False])
@pytest.mark.parametrize("norm", [None, "energy", "Peak", -6.0])
def test_combine_ir_with_dirac_matches_jax(keep_low, norm):
    p, j = _ir_pair(_irs(4096) * 0.8)
    got = tf.combine_ir_with_dirac(p, 1000, keep_low, normalization=norm)
    want = jtf.combine_ir_with_dirac(j, 1000, keep_low, normalization=norm)
    assert isinstance(got, ImpulseResponse)
    # the JAX package's 5e-4 (tests/test_transfer_functions.py:458)
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 5e-4, f"{keep_low} {norm}")
    with pytest.raises(AssertionError):
        tf.combine_ir_with_dirac(p, 1000, keep_low, normalization="rms")


@pytest.mark.parametrize("mode", ["direct", "min", "lin"])
def test_ir_to_filter_and_back_match_jax(mode):
    from dsptoolbox_tpu_torch.classes import Filter, FilterBank

    p, j = _ir_pair(_irs(1024))
    filt = tf.ir_to_filter(p, 1, mode)
    jfilt = jtf.ir_to_filter(j, 1, mode)
    assert isinstance(filt, Filter) and filt.is_fir
    # lin: the group delay in use is the float32 maximum of the minimum
    # group delay, and a rounding difference δ in it turns the phase at
    # Nyquist by π·fs·δ: held at the JAX package's 5e-5
    # (tests/test_transfer_functions.py:206) or four float32 ulps of that
    # delay, whichever is larger; the composition itself is exact
    def tol_for(n_samples):
        if mode != "lin":
            return {"direct": 0, "min": 1e-6}[mode]
        gd = n_samples / (2 * FS)
        return max(5e-5, 4 * np.pi * FS * float(np.spacing(np.float32(gd))))

    assert_close(filt.ba[0], jfilt.ba[0], tol_for(len(filt.ba[0])), mode)
    if mode == "lin":
        own = tf.lin_phase_from_mag(Spectrum.from_signal(p.get_channels(1)), FS)
        np.testing.assert_array_equal(filt.ba[0], own.time_data[:, 0].double().numpy())
    bank = tf.ir_to_filter(p, None, mode)
    assert isinstance(bank, FilterBank) and len(bank) == 3
    back = tf.filter_to_ir(bank)
    assert_close(back.time_data.numpy(), np.asarray(jtf.filter_to_ir(
        jtf.ir_to_filter(j, None, mode)).time_data), tol_for(back.length_samples),
        f"{mode} bank")
    if mode == "direct":  # the round trip (tests/test_transfer_functions.py:213)
        assert_close(tf.filter_to_ir(filt).time_data[:, 0].numpy(),
                     p.time_data[:, 1].numpy(), 1e-6, "round trip")
    with pytest.raises(AssertionError):
        tf.ir_to_filter(p, 0, "zero")
    with pytest.raises(TypeError):
        tf.filter_to_ir(p)


def test_window_frequency_dependent_matches_jax():
    p, j = _ir_pair(_irs(2048))
    got = tf.window_frequency_dependent(p, 8)
    want = jtf.window_frequency_dependent(j, 8)
    np.testing.assert_allclose(got.frequency_vector_hz, want.frequency_vector_hz)
    assert got.is_complex and got.spectral_data.shape == (1025, 3)
    assert_close(got.spectral_data.numpy(), np.asarray(want.spectral_data), 2e-5, "fdw")
    with pytest.raises(AssertionError):
        tf.window_frequency_dependent(p, 8, 3.0)


def test_fdw_core_phase_accuracy_long_signal():
    # twin of the JAX package's guard (tests/test_transfer_functions.py:249):
    # the rotation phase f·n/T reaches ~1e4 cycles; the coarse/fine mod-1
    # split keeps the complex error near float32's accumulation floor
    # against a float64 direct sum (the unsplit float32 phase: ~2e-3)
    rng = np.random.default_rng(7)
    T, C = 16384, 2
    x = rng.standard_normal((T, C)).astype(np.float32)
    freqs = np.linspace(50.0, T / 2 - 50.0, 32)  # fractional bins
    alpha = np.full(32, 3.0)
    peaks = np.array([64, T - 200])
    spec = bk.fdw_core(torch.from_numpy(x), freqs, alpha, peaks).numpy()
    half = (T - 1) / 2
    n_rel = np.arange(T)[:, None] - peaks[None, :]
    n = np.arange(T)
    oracle = np.zeros((32, C), complex)
    for i, (f, a) in enumerate(zip(freqs, alpha)):
        win = np.exp(-0.5 * (n_rel / half) ** 2 * a)
        rot = np.exp(-2j * np.pi * f * n / T)
        oracle[i] = (win * rot[:, None] * x).sum(0)
    err = np.abs(spec - oracle).max() / np.abs(oracle).max()
    assert err < 2e-4, f"fdw complex error {err:.2e}"


def test_fdw_core_chunks_by_its_memory_budget(monkeypatch):
    td = torch.from_numpy(_irs(1024))
    f = np.arange(1, 513, dtype=np.float64)
    alpha = np.linspace(1, 50, 512)
    whole = bk.fdw_core(td, f, alpha, np.array([96, 211, 430]))
    monkeypatch.setattr(bk, "_FDW_CHUNK_BYTES", 5 * 1024 * 3 * 4)  # 5 bins a chunk
    torch.testing.assert_close(bk.fdw_core(td, f, alpha, np.array([96, 211, 430])), whole,
                               rtol=0, atol=0)


@pytest.mark.parametrize("min_phase", [True, False])
def test_find_ir_latency_matches_jax(min_phase):
    p, j = _ir_pair(_irs(4096))
    got = tf.find_ir_latency(p, min_phase)
    want = jtf.find_ir_latency(j, min_phase)
    assert isinstance(got, np.ndarray)
    # the JAX package's 1e-2 samples (tests/test_transfer_functions.py:232)
    np.testing.assert_allclose(got, want, atol=1e-2)
    np.testing.assert_allclose(got, DELAYS, atol=1.0)


@pytest.fixture(scope="module")
def distorted_sweep_ir():
    """A 2 s SyncLog sweep through x + 0.05x² + 0.02x³ and a short room IR,
    deconvolved with padding by the JAX package: its IR, with harmonic IRs
    before the main peak."""
    jsweep, _ = jgen.chirp(FS, jgen.ChirpType.SyncLog, [20, 20000], 2.0,
                           padding_end_seconds=1.0)
    s = np.asarray(jsweep.time_data)[:, 0].astype(np.float64)
    rec = np.convolve(s + 0.05 * s**2 + 0.02 * s**3, _rooms(2000)[:, 0])[: len(s)]
    ir = jtf.spectral_deconvolve(jclasses.Signal(None, rec.astype(np.float32)[:, None], FS),
                                 jclasses.Signal(None, s.astype(np.float32)[:, None], FS),
                                 padding=True)
    return np.asarray(ir.time_data)


def test_harmonics_from_chirp_ir_match_jax(distorted_sweep_ir):
    p, j = _ir_pair(distorted_sweep_ir)
    got = tf.harmonics_from_chirp_ir(p, [20, 20000], 2.0, 4)
    want = jtf.harmonics_from_chirp_ir(j, [20, 20000], 2.0, 4)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert isinstance(g, ImpulseResponse)
        assert_close(g.time_data.numpy(), np.asarray(w.time_data), 2e-5, "harmonic")
    # each harmonic IR peaks where `get_harmonic_times` puts it
    ts = bk.get_harmonic_times([20, 20000], 2.0, 5)
    np.testing.assert_array_equal(ts, jbk.get_harmonic_times([20, 20000], 2.0, 5))
    assert bk.get_chirp_rate([20000, 20], 2.0) == jbk.get_chirp_rate([20, 20000], 2.0)
    with pytest.raises(AssertionError):
        tf.harmonics_from_chirp_ir(ImpulseResponse(None, _irs(1024), FS), [20, 20000], 2.0)


def test_harmonic_distortion_analysis_matches_jax(distorted_sweep_ir):
    p, j = _ir_pair(distorted_sweep_ir)
    got = tf.harmonic_distortion_analysis(p, [20, 20000], 2.0, 3, generate_plot=False)
    want = jtf.harmonic_distortion_analysis(j, [20, 20000], 2.0, 3, generate_plot=False)
    assert set(got) == set(want) == {"1", "2", "3", "4", "thd", "thd_n", "thd_percent"}
    for key in want:
        np.testing.assert_allclose(got[key].frequency_vector_hz, want[key].frequency_vector_hz)
        g, w = got[key].spectral_data, np.asarray(want[key].spectral_data)
        if g.is_complex():  # the fundamental's and the harmonics' smoothed phases
            assert_phase_close(g, w, phase_range(w), key)
        else:
            assert_close(g.numpy(), w, 2e-5, key)
    # the list form: the fundamental and its harmonics' IRs
    harms = tf.harmonics_from_chirp_ir(p, [20, 20000], 2.0, 2)
    jharms = jtf.harmonics_from_chirp_ir(j, [20, 20000], 2.0, 2)
    got = tf.harmonic_distortion_analysis([p.copy()] + harms, generate_plot=False)
    want = jtf.harmonic_distortion_analysis([j.copy()] + jharms, generate_plot=False)
    for key in ("thd", "thd_n", "thd_percent"):
        assert_close(got[key].spectral_data.numpy(), np.asarray(want[key].spectral_data),
                     2e-5, f"list {key}")
    # the default generate_plot=True adds the figure (ROADMAP C8, repaired)
    import matplotlib

    matplotlib.use("Agg")
    got = tf.harmonic_distortion_analysis(p, [20, 20000], 2.0, 3)
    want = jtf.harmonic_distortion_analysis(j, [20, 20000], 2.0, 3)
    assert set(got) == set(want) and "plot" in got
    assert [type(v) for v in got["plot"]] == [type(v) for v in want["plot"]]
    assert_close(got["thd"].spectral_data.numpy(), np.asarray(want["thd"].spectral_data),
                 2e-5, "thd with the plot")
    matplotlib.pyplot.close("all")
    with pytest.raises(TypeError):
        tf.harmonic_distortion_analysis(Signal(None, _irs(1024), FS), generate_plot=False)


@pytest.mark.parametrize("channel", [None, 1])
@pytest.mark.parametrize("offset", [20e-3, None])
def test_trim_ir_matches_jax(channel, offset):
    p, j = _ir_pair(_irs(16384))
    got, start, stop = tf.trim_ir(p, channel, offset)
    want, jstart, jstop = jtf.trim_ir(j, channel, offset)
    assert (start, stop) == (jstart, jstop)
    assert isinstance(got, ImpulseResponse) and got.device.type == "cpu"
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 0, "trimmed")

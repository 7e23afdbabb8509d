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
    ir.spectrum_smoothing = 3
    with pytest.raises(NotImplementedError):
        ir.get_spectrum()
    ir.spectrum_smoothing = 0
    ir.spectrum_scaling = SpectrumScaling.AmplitudeSpectrum
    with pytest.raises(NotImplementedError):
        ir.get_spectrum()

"""The port's room acoustics (`dsptoolbox_tpu_torch.room_acoustics`, its
helpers and `tools.room_measurement`) against the JAX package on the CPU,
on the same seeded float32 inputs, and against scipy/numpy in float64 where
the JAX package's float32 IIR is no oracle (ROADMAP C3). Sizes are small:
a few thousand samples, 2-8 channels or RIRs, image lattices of order ≤ 14.

The per-channel fits are host numpy in both packages, so on the same float32
data they agree bit for bit (held at rtol 1e-9); the image-source support is
held identical to the JAX package's float64 host oracle."""

import warnings

import numpy as np
import pytest
import torch
from scipy.signal import butter, lfilter, sosfilt, sosfiltfilt

import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu import room_acoustics as jra
from dsptoolbox_tpu.helpers import gain_and_level as jgl
from dsptoolbox_tpu.helpers import other as jother
from dsptoolbox_tpu.helpers import smoothing as jsmooth
from dsptoolbox_tpu.room_acoustics import _backend as jbk
from dsptoolbox_tpu.standard.pad_trim_methods import pad_trim as jpad_trim
from dsptoolbox_tpu.transfer_functions import _backend as jtf
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch import room_acoustics as ra
from dsptoolbox_tpu_torch.classes import Filter, ImpulseResponse, MultiBandSignal, Signal
from dsptoolbox_tpu_torch.filterbanks import fractional_octave_bands
from dsptoolbox_tpu_torch.helpers import gain_and_level as gl
from dsptoolbox_tpu_torch.helpers import other
from dsptoolbox_tpu_torch.helpers import smoothing
from dsptoolbox_tpu_torch.room_acoustics import _backend as bk
from dsptoolbox_tpu_torch.room_acoustics import room_acoustics as ra_api
from dsptoolbox_tpu_torch.standard.enums import FilterPassType, IirDesignMethod
from dsptoolbox_tpu_torch.standard.pad_trim_methods import pad_trim
from dsptoolbox_tpu_torch.tools import measurement
from dsptoolbox_tpu_torch.tools import room_measurement as rm
from dsptoolbox_tpu_torch.transfer_functions import _backend as tf

torch.set_num_threads(1)
warnings.filterwarnings("ignore", message="Correlation coefficient")
warnings.filterwarnings("ignore", message="Signal was over 0 dBFS")

REVERB_TIMES = ["T20", "T30", "T60", "EDT", "Adaptive"]
ROOM = ([6.07, 5.13, 3.01], 0.5)
SOURCE, RECEIVER = [1.23, 2.17, 1.31], [4.29, 1.17, 1.63]


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's classes put numpy data on the default device, "cuda" out
    of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


@pytest.fixture(autouse=True)
def _ism_routes_restored():
    yield
    bk.set_ism_device(None)
    jbk.set_ism_device(None)


def _decaying_irs(fs=16000, T=8000, C=3, seed=0) -> np.ndarray:
    """``(T, C)`` float32: a direct sound at a seeded delay, then noise
    decaying by 60 dB in 0.5 s over a −80 dB floor; peak below 1, so neither
    package normalizes."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    x = 0.1 * rng.standard_normal((T, C)) * np.exp(-13.8 * t)[:, None]
    x += 1e-4 * rng.standard_normal((T, C))
    for c in range(C):
        x[: 20 + 11 * c, c] = 1e-4 * rng.standard_normal(20 + 11 * c)
        x[20 + 11 * c, c] = 0.9
    return x.astype(np.float32)


def _room_irs(channels=2) -> np.ndarray:
    """``tools.measurement``'s room IRs (48 kHz, RT60 0.6 s), float32."""
    return (measurement.room_irs()[0][:, :channels] * 0.9).astype(np.float32)


def _modal_ir(fs=48000, T=24000, C=2, seed=1) -> np.ndarray:
    """``(T, C)`` float32: four decaying room modes (63-140 Hz) over
    decaying noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    x = np.zeros((T, C))
    for c in range(C):
        for f in (63.0, 87.5, 111.0, 140.0):
            x[:, c] += rng.uniform(0.5, 1) * np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) \
                * np.exp(-8 * t)
        x[:, c] += 0.3 * rng.standard_normal(T) * np.exp(-11.5 * t) + 1e-4 * rng.standard_normal(T)
    return (x / np.abs(x).max() * 0.9).astype(np.float32)


def _both_irs(x, fs):
    return jdsp.ImpulseResponse(None, x, fs), ImpulseResponse(None, x, fs)


def _fleet(n=8):
    """`tests/test_room_acoustics.py`'s batched-descriptor fleet."""
    rng = np.random.default_rng(0)
    fs, T = 16000, 8000
    rirs = np.zeros((n, T))
    for i in range(n):
        t60 = 0.2 + 0.05 * i
        tail = rng.standard_normal(T) * np.exp(-np.arange(T) / fs * (6.9 / t60))
        b, a = butter(2, 0.4)
        rirs[i] = lfilter(b, a, tail)
        rirs[i, : i * 7] = 0.0
        rirs[i, i * 7] = np.max(np.abs(rirs[i])) * 3
    return rirs.astype(np.float32), fs


def _delayed_decays():
    """`tests/test_room_acoustics.py`'s EDT regression: a 0.5 s decay of a
    1 kHz sine, plain and delayed by 0.25 s."""
    fs = 16000
    t = np.arange(fs) / fs
    decay = np.exp(-3.0 * np.log(10) / 0.5 * t) * np.sin(2 * np.pi * 1000 * t)
    delayed = np.zeros(fs)
    delayed[fs // 4:] = decay[: fs - fs // 4]
    return np.stack([decay, delayed]).astype(np.float32), fs


# ---- helpers ---------------------------------------------------------------


@pytest.mark.parametrize("amplitude", [True, False])
def test_db_helpers_match_jax(amplitude):
    """`to_db` (raw log, floor, dynamic range) and `from_db` on numpy and on
    tensors, against the JAX package's numpy path: float32 tensors within
    1e-5 dB (float32 log10), numpy at rtol 1e-12."""
    x = np.abs(np.random.default_rng(2).standard_normal(64)) + 1e-3
    for kw in ({}, {"dynamic_range_db": 30.0}, {"min_value": None}):
        want = jgl.to_db(x, amplitude, **kw)
        np.testing.assert_allclose(gl.to_db(x, amplitude, **kw), want, rtol=1e-12)
        got = gl.to_db(torch.as_tensor(x, dtype=torch.float32), amplitude, **kw)
        assert torch.is_tensor(got)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    db = 20 * np.log10(x)
    np.testing.assert_allclose(gl.from_db(db, amplitude), jgl.from_db(db, amplitude), rtol=1e-12)
    np.testing.assert_allclose(gl.from_db(torch.as_tensor(db), amplitude).numpy(),
                               jgl.from_db(db, amplitude), rtol=1e-12)


def test_correlation_and_smoothing_match_jax():
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal(500), rng.standard_normal(500) + np.arange(500) * 1e-2
    assert other.pearson_correlation(x, y) == jother.pearson_correlation(x, y)
    assert other.pearson_correlation(x, np.ones(500)) == 0.0
    for tau in (20e-3, 0.0):
        np.testing.assert_array_equal(smoothing.time_smoothing_host(x, 16000, tau),
                                      jsmooth.time_smoothing_host(x, 16000, tau))
    assert smoothing.get_smoothing_factor_ema(0.1, 48000) == jsmooth.get_smoothing_factor_ema(0.1, 48000)


@pytest.mark.parametrize("offset_s, safety_db", [(1e-3, 10.0), (0.0, 10.0), (0.0, 0.0)])
def test_trim_ir_indices_match_jax(offset_s, safety_db):
    for c in range(3):
        h = _decaying_irs(C=3)[:, c]
        assert tf.trim_ir_indices(h, 16000, offset_s, safety_db) == jtf.trim_ir_indices(
            h, 16000, offset_s, safety_db)


def test_pad_trim_matches_jax():
    x = _decaying_irs(C=2)
    j, p = _both_irs(x, 16000)
    for n in (5000, 8000, 9001):
        np.testing.assert_array_equal(pad_trim(p, n).time_data.numpy(),
                                      np.asarray(jpad_trim(j, n).time_data))
    mb = MultiBandSignal([p, p.copy()])
    got = pad_trim(mb, 6000)
    assert got.number_of_bands == 2 and got.length_samples == 6000


# ---- reverberation time, descriptors, IR start ------------------------------


@pytest.mark.parametrize("mode", REVERB_TIMES)
def test_reverb_time_matches_jax(mode):
    """The same float32 IR: the same host float fits, rtol 1e-9."""
    j, p = _both_irs(_decaying_irs(), 16000)
    want = jra.reverb_time(j, getattr(jra.ReverbTime, mode))
    got = ra.reverb_time(p, getattr(ra.ReverbTime, mode))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)


@pytest.mark.parametrize("ir_start", [None, 5, [5, 6, 7]])
@pytest.mark.parametrize("mode", REVERB_TIMES)
def test_reverb_time_multiband_matches_jax(mode, ir_start):
    """A MultiBandSignal of IRs (octave bands filtered by scipy, the same
    float32 data on both sides), with ``ir_start`` given and not: rtol
    1e-9."""
    x = _decaying_irs()
    bank = fractional_octave_bands([500, 2000], filter_order=4, sampling_rate_hz=16000)[0]
    bands = [sosfilt(f.sos, x.astype(np.float64), axis=0).astype(np.float32)
             for f in bank.filters]
    jmb = jdsp.MultiBandSignal([jdsp.ImpulseResponse(None, b, 16000) for b in bands])
    pmb = MultiBandSignal([ImpulseResponse(None, b, 16000) for b in bands])
    want = jra.reverb_time(jmb, getattr(jra.ReverbTime, mode), ir_start=ir_start)
    got = ra.reverb_time(pmb, getattr(ra.ReverbTime, mode), ir_start=ir_start)
    assert got[0].shape == (3, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)


def test_banked_bands_fetch_and_fit_like_single_irs():
    """The bank's bands (views of its output plane) come to the host in one
    ``(B, C, T)`` array; the fits on them equal each band IR's own."""
    p = ImpulseResponse(None, _decaying_irs(), 16000)
    mb = rm.octave_bands(p, fractional_octave_bands([500, 2000], 1, 4, 16000)[0])
    planes = ra_api._host_planes(mb)
    np.testing.assert_array_equal(planes, np.stack([b._x.numpy() for b in mb.bands]))
    got = ra.reverb_time(mb, ra.ReverbTime.T20)[0]
    for i, b in enumerate(mb.bands):
        np.testing.assert_array_equal(got[i], ra.reverb_time(b, ra.ReverbTime.T20)[0])
    with pytest.raises(TypeError):
        ra.reverb_time(MultiBandSignal([Signal(None, _decaying_irs(), 16000)]))


@pytest.mark.parametrize("mode", REVERB_TIMES)
def test_reverb_fit_decisions_are_the_jax_fits(mode):
    """`_backend.reverb_fit`'s decisions (trimming stop, IR start, EDC
    length, fit range) are those of the JAX package's fit on the same
    float32 channel: the line fitted over that range of the JAX package's
    EDC gives its reverberation time bit for bit; the port's time is
    `reverb`'s."""
    x = _decaying_irs()
    m, jm = getattr(ra.ReverbTime, mode), getattr(jra.ReverbTime, mode)
    for c in range(x.shape[1]):
        h = x[:, c]
        time, corr, (stop, start, n, i1, i2) = bk.reverb_fit(h, 16000, m)
        assert (time, corr) == tuple(bk.reverb(h, 16000, m, None, False, True))
        assert stop == jtf.trim_ir_indices(h, 16000, 1e-3)[1]
        assert start == jbk.find_ir_start(h)
        edc = jbk.compute_energy_decay_curve(h, True, 16000)
        assert n == len(edc) and 0 <= i1 < i2 <= n
        tv = np.linspace(0, n / 16000, n)
        slope = np.polyfit(tv[i1:i2], edc[i1:i2], 1)[0]
        want = jbk.reverb(h, 16000, jm, None, False, True)[0]
        assert (10 if mode == "EDT" else 60) / np.abs(slope) == want


@pytest.mark.parametrize("trim", [True, False])
def test_descriptor_window_is_the_jax_descriptors_window(trim):
    """`_backend.descriptor_window`: the JAX descriptors' IR start and
    trimming stop on the same float32 channel; D50, C80 and centre time on
    it stay the JAX package's, rtol 1e-9."""
    x = _decaying_irs()
    for c in range(x.shape[1]):
        h = x[:, c]
        start, stop = bk.descriptor_window(h, 16000, trim)
        assert start == jbk.find_ir_start(h)
        assert stop == (jtf.trim_ir_indices(h[start:], 16000, 0)[1] if trim else len(h) - start)
        for name in ("d50_from_rir", "c80_from_rir", "ts_from_rir"):
            np.testing.assert_allclose(getattr(bk, name)(h, 16000, trim),
                                       getattr(jbk, name)(h, 16000, trim), rtol=1e-9)


@pytest.mark.parametrize("trim", [True, False])
def test_energy_decay_curve_and_ir_start_match_jax(trim):
    x = _decaying_irs()
    for c in range(x.shape[1]):
        np.testing.assert_allclose(bk.compute_energy_decay_curve(x[:, c], trim, 16000),
                                   jbk.compute_energy_decay_curve(x[:, c], trim, 16000),
                                   rtol=1e-9)
    j, p = _both_irs(x, 16000)
    for threshold in (-20, -6):
        np.testing.assert_array_equal(ra.find_ir_start(p, threshold),
                                      jra.find_ir_start(j, threshold))


@pytest.mark.parametrize("trim", [True, False])
@pytest.mark.parametrize("desc", ["D50", "C80", "CenterTime"])
def test_descriptors_match_jax(desc, trim):
    """Per channel of an IR and per band of a MultiBandSignal: rtol 1e-9."""
    x = _decaying_irs()
    j, p = _both_irs(x, 16000)
    want = jra.descriptors(j, getattr(jra.RoomAcousticsDescriptor, desc), trim)
    got = ra.descriptors(p, getattr(ra.RoomAcousticsDescriptor, desc), trim)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    x2 = _decaying_irs(seed=1)
    jmb = jdsp.MultiBandSignal([j, jdsp.ImpulseResponse(None, x2, 16000)])
    pmb = MultiBandSignal([p, ImpulseResponse(None, x2, 16000)])
    np.testing.assert_allclose(
        ra.descriptors(pmb, getattr(ra.RoomAcousticsDescriptor, desc), trim),
        jra.descriptors(jmb, getattr(jra.RoomAcousticsDescriptor, desc), trim), rtol=1e-9)


def test_bass_ratio_matches_scipy_float64():
    """BassRatio (order-10 octaves 125-1000 Hz, zero phase, through the
    port's blocked IIR) against scipy's float64 ``sosfiltfilt`` followed by
    the port's host RT on the float64 bands. Tolerance 1e-4: float32 bands
    (~1e-7 off) into fits whose decisions stay put here (2.6e-5 seen). The
    JAX package's float32 filter is no oracle at 125 Hz (C3)."""
    x = _room_irs()
    fs = measurement.FS
    got = ra.descriptors(ImpulseResponse(None, x, fs), ra.RoomAcousticsDescriptor.BassRatio)
    bank = fractional_octave_bands([125, 1000], filter_order=10, sampling_rate_hz=fs)[0]
    rt = np.array([[bk.reverb(sosfiltfilt(f.sos, x[:, c].astype(np.float64)), fs,
                              ra.ReverbTime.Adaptive, None, False, True)[0]
                    for c in range(x.shape[1])] for f in bank.filters])
    np.testing.assert_allclose(got, (rt[0] + rt[1]) / (rt[2] + rt[3]), rtol=1e-4)


def test_host_fits_run_in_the_data_dtype():
    """C4 (a parity fact): the fits' sums (the EDC's cumsum, the powers)
    run in the data's float32, in the JAX package as in the port, so on
    float32 data they sit measurably off the same fits on float64 data,
    while the two packages agree bit for bit."""
    x = _room_irs(4)
    fs = measurement.FS
    j, p = _both_irs(x, fs)
    got = ra.reverb_time(p, ra.ReverbTime.T20)[0]
    np.testing.assert_array_equal(got, jra.reverb_time(j, jra.ReverbTime.T20)[0])
    f64 = np.array([bk.reverb(x[:, c].astype(np.float64), fs, ra.ReverbTime.T20, None, False,
                              True)[0] for c in range(x.shape[1])])
    assert np.max(np.abs(got - f64) / f64) > 1e-7


# ---- batched descriptors ----------------------------------------------------


def test_batch_energy_decay_matches_jax():
    """EDCs in dB within 1e-4 dB: float32 backward sums over 8000 samples
    in two orders (torch's sequential cumsum, XLA's)."""
    rirs, _ = _fleet()
    got = ra.batch_energy_decay(rirs)
    assert got.shape == rirs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jra.batch_energy_decay(rirs)),
                               rtol=0, atol=1e-4)
    assert float(got[:, 0].max()) <= 1e-5


@pytest.mark.parametrize("fleet", ["fleet", "delayed"])
def test_batch_descriptors_match_jax(fleet):
    """D50 and centre time at rtol 1e-5, C80 within 1e-4 dB."""
    rirs, fs = _fleet() if fleet == "fleet" else _delayed_decays()
    got, want = ra.batch_descriptors(rirs, fs), jra.batch_descriptors(rirs, fs)
    np.testing.assert_allclose(got["d50"].numpy(), want["d50"], rtol=1e-5)
    np.testing.assert_allclose(got["center_time_s"].numpy(), want["center_time_s"], rtol=1e-5)
    np.testing.assert_allclose(got["c80"].numpy(), want["c80"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["EDT", "T20", "T30"])
@pytest.mark.parametrize("fleet", ["fleet", "delayed"])
def test_batch_reverb_times_match_jax(mode, fleet):
    rirs, fs = _fleet() if fleet == "fleet" else _delayed_decays()
    np.testing.assert_allclose(ra.batch_reverb_times(rirs, fs, mode).numpy(),
                               np.asarray(jra.batch_reverb_times(rirs, fs, mode)), rtol=1e-5)


def test_batch_edt_ignores_leading_silence_and_matches_convention():
    """The JAX package's regression (`tests/test_room_acoustics.py:259`) on
    the port: EDT is the 0 → −10 dB time, T20 the 60 dB extrapolation."""
    rirs, fs = _delayed_decays()
    edt = ra.batch_reverb_times(rirs, fs, "EDT").numpy()
    t20 = ra.batch_reverb_times(rirs, fs, "T20").numpy()
    np.testing.assert_allclose(edt, 0.5 / 6, rtol=0.1)
    np.testing.assert_allclose(t20, 0.5, rtol=0.05)
    np.testing.assert_allclose(edt[1], edt[0], rtol=0.05)


def test_battery_matches_float64_and_jax_up_to_mask_flips():
    """Config 4's recipe (50 RIRs): the port in float32 against itself in
    float64 at rtol 1e-5 (C80 within 1e-3 dB: its late energy is a
    difference of float32 sums up to 27 dB apart, ×500 their relative
    error); against the JAX package every RT
    row off by more than 1e-5 has a fit mask that differs by at least one
    sample at a dB edge (the EDCs' float32 sums in two orders), and is
    within 1e-3 (C5)."""
    rirs = rm.battery_rirs(50)
    assert rirs.shape == (50, rm.BATTERY_LENGTH) and rirs.dtype == np.float32
    got = rm.battery(rirs)
    f64 = rm.battery(torch.as_tensor(rirs, dtype=torch.float64))
    for k, v in got.items():
        assert v.shape == (50,) and v.dtype == torch.float32
        if k == "c80":
            np.testing.assert_allclose(v.numpy(), f64[k].numpy(), rtol=0, atol=1e-3)
        else:
            np.testing.assert_allclose(v.numpy(), f64[k].numpy(), rtol=1e-5)
    fs = rm.BATTERY_FS
    edc_p = ra.batch_energy_decay(rirs).numpy()
    edc_j = np.asarray(jra.batch_energy_decay(rirs))
    flipped = 0
    for mode, (hi, lo) in {"EDT": (0.0, -10.0), "T20": (-5.0, -25.0), "T30": (-5.0, -35.0)}.items():
        want = np.asarray(jra.batch_reverb_times(rirs, fs, mode))
        rel = np.abs(got[mode].numpy() - want) / want
        masks_differ = (((edc_p <= hi) & (edc_p >= lo)) != ((edc_j <= hi) & (edc_j >= lo))).any(1)
        assert np.all(masks_differ[rel > 1e-5]), mode
        assert rel.max() <= 1e-3, mode
        flipped += int(masks_differ.sum())
    assert flipped > 0


# ---- image-source model -----------------------------------------------------


@pytest.mark.parametrize("max_order", [8, 14])
def test_ism_matches_jax_float64_oracle(max_order):
    """The port's float64 lattice and its own oracle route against the JAX
    package's float64 host oracle at 44.1 kHz: identical support, values
    within 2e-7·max (the JAX test's bound)."""
    jbk.set_ism_device(False)
    want = np.asarray(jra.generate_synthetic_rir(
        jra.ShoeboxRoom(*ROOM), SOURCE, RECEIVER, 44100, max_order=max_order).time_data)[:, 0]
    room = ra.ShoeboxRoom(*ROOM)
    for route in (None, False):
        bk.set_ism_device(route)
        got = ra.generate_synthetic_rir(room, SOURCE, RECEIVER, 44100, max_order=max_order)
        assert isinstance(got, ImpulseResponse) and got.device.type == "cpu"
        g = got.time_data[:, 0].numpy()
        np.testing.assert_array_equal(np.nonzero(g)[0], np.nonzero(want)[0])
        np.testing.assert_allclose(g, want, rtol=0, atol=2e-7 * np.max(np.abs(want)))


@pytest.mark.parametrize("fs,max_order", [(44100, 14), (16000, 12)])
def test_ism_images_match_jax_oracle_per_image(fs, max_order):
    """Every image of the lattice (`_backend.ism_images`, two pairs, chunks
    of 1000 cells × pairs) against the JAX package's float64 host image
    math on the same cells: identical sample indices, values (the
    duplicate drop included) within 1e-12 relative."""
    room = ra.ShoeboxRoom(*ROOM)
    dim = np.asarray(room.dimensions_m, np.float64)
    b1, b2 = bk.wall_reflection_factors(room.absorption_coefficient)
    s = np.array([SOURCE, [5.1, 4.2, 2.2]])
    r = np.array([RECEIVER, [0.7, 0.9, 1.4]])
    limit, _ = bk.ism_limits(dim, room.t60_s, max_order, fs)
    old = bk._ISM_CHUNK
    bk._ISM_CHUNK = 1000
    try:
        chunks = list(bk.ism_images(dim, b1, b2, s, r, fs, limit, "cpu"))
    finally:
        bk._ISM_CHUNK = old
    lv = torch.cat([c[0] for c in chunks]).numpy()
    assert lv.shape == ((2 * limit + 1) ** 3, 3)
    for p in range(2):
        idx = torch.cat([c[1][p] for c in chunks]).numpy().reshape(-1)
        vals = torch.cat([c[2][p] for c in chunks]).numpy().reshape(-1)
        want_idx, want_vals = jbk._host_group_images(lv, dim, b1, b2, s[p], r[p], fs, 343)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_allclose(vals, want_vals, rtol=1e-12, atol=0)


def test_ism_lattice_chunks_agree(monkeypatch):
    """The lattice in chunks of 1000 cells × pairs (ragged last chunk)
    places every image where one chunk does."""
    room = ra.ShoeboxRoom(*ROOM)
    whole = ra.generate_synthetic_rir(room, SOURCE, RECEIVER, 16000, max_order=9)
    monkeypatch.setattr(bk, "_ISM_CHUNK", 1000)
    chunked = ra.generate_synthetic_rir(room, SOURCE, RECEIVER, 16000, max_order=9)
    np.testing.assert_array_equal(np.nonzero(chunked.time_data.numpy())[0],
                                  np.nonzero(whole.time_data.numpy())[0])
    np.testing.assert_allclose(chunked.time_data.numpy(), whole.time_data.numpy(), rtol=1e-6)


def test_batch_synthetic_rirs_rows_match_single():
    """`tests/test_room_acoustics.py:113`'s fleet: each row against the
    single-RIR oracle, identical support and values within 1e-7·max."""
    room = ra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
    rng = np.random.default_rng(3)
    s = rng.uniform([0.3] * 3, [3.7, 2.7, 2.2], (4, 3))
    r = rng.uniform([0.3] * 3, [3.7, 2.7, 2.2], (4, 3))
    rirs = ra.batch_synthetic_rirs(room, s, r, 16000, max_order=10)
    assert tuple(rirs.shape) == (4, 8000) and rirs.dtype == torch.float32
    bk.set_ism_device(False)
    for b in range(4):
        single = ra.generate_synthetic_rir(room, s[b], r[b], 16000, max_order=10)
        single = single.time_data[:, 0].numpy()
        row = rirs[b].numpy()
        np.testing.assert_array_equal(np.nonzero(row)[0], np.nonzero(single)[0])
        np.testing.assert_allclose(row, single, rtol=0, atol=1e-7 * np.max(np.abs(single)))


def _detailed(room):
    return room.add_detailed_absorption({
        "north": [0.1, 0.2, 0.3], "south": [0.2, 0.3], "east": [0.15, 0.2, 0.2],
        "west": [0.25, 0.2], "floor": [0.05, 0.1, 0.2], "ceiling": [0.3, 0.4, 0.5],
    })


@pytest.mark.parametrize("option", ["add_noise_reverberant_tail", "use_detailed_absorption"])
def test_synthetic_rir_options_match_jax(option):
    """The reverberant tail (numpy's global RNG, seeded alike) and the
    detailed absorption (one RIR per octave band, zero-phase LR bands
    summed) against the JAX package: 1e-6 of the peak."""
    rj, rp = jra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4), ra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
    if option == "use_detailed_absorption":
        _detailed(rj), _detailed(rp)
    args = ([1.0, 1.0, 1.0], [2.5, 2.0, 1.2], 16000)
    np.random.seed(7)
    want = np.asarray(jra.generate_synthetic_rir(rj, *args, max_order=8, **{option: True})
                      .time_data)[:, 0]
    np.random.seed(7)
    got = ra.generate_synthetic_rir(rp, *args, max_order=8, **{option: True}).time_data[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.max(np.abs(want)))


def test_synthetic_rir_bandpass_matches_scipy_float64():
    """``apply_bandpass`` (order-12 Butterworth, 20 Hz-0.9·Nyquist) against
    scipy's float64 ``sosfilt`` of the unfiltered RIR: 5e-6 scale-relative.
    The JAX package's float32 filter is 2.1e-3 off at 16 kHz (C3)."""
    room = ra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
    args = (room, [1.0, 1.0, 1.0], [2.5, 2.0, 1.2], 16000)
    raw = ra.generate_synthetic_rir(*args, max_order=8).time_data[:, 0].double().numpy()
    got = ra.generate_synthetic_rir(*args, max_order=8, apply_bandpass=True).time_data[:, 0]
    f = Filter.iir_filter(order=12, frequency_hz=[20.0, 8000 * 0.9],
                          type_of_pass=FilterPassType.Bandpass, sampling_rate_hz=16000,
                          filter_design_method=IirDesignMethod.Butterworth)
    want = sosfilt(f.sos, raw)
    assert np.max(np.abs(got.numpy() - want)) <= 5e-6 * np.max(np.abs(want))


# ---- rooms, modes, convolution ----------------------------------------------


def test_rooms_match_jax():
    """Sabine quantities, modes (rtol 1e-12), mixing times, detailed
    absorption, and the analytical transfer function (complex64 modal sum,
    1e-5 scale-relative)."""
    rj, rp = jra.ShoeboxRoom([5.0, 4.0, 3.0], t60_s=0.6), ra.ShoeboxRoom([5.0, 4.0, 3.0], t60_s=0.6)
    for name in ("volume", "area", "absorption_coefficient", "schroeders_frequency",
                 "critical_distance_m"):
        assert getattr(rp, name) == getattr(rj, name), name
    np.testing.assert_allclose(rp.get_room_modes(4), rj.get_room_modes(4), rtol=1e-12)
    assert rp.get_mixing_time("perceptual") == rj.get_mixing_time("perceptual")
    assert rp.get_mixing_time("physical", 400) == rj.get_mixing_time("physical", 400)
    assert rp.modal_density(100.0) == rj.modal_density(100.0)
    freqs = np.linspace(20, 300, 100)
    for room_j, room_p in ((rj, rp), (_detailed(jra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)),
                                      _detailed(ra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)))):
        pj, mj, _ = room_j.get_analytical_transfer_function(
            [1.0, 1.0, 1.0], [2.5, 2.0, 1.2], freqs, max_mode_order=6, generate_plot=False)
        pp, mp, plot = room_p.get_analytical_transfer_function(
            [1.0, 1.0, 1.0], [2.5, 2.0, 1.2], freqs, max_mode_order=6, generate_plot=False)
        assert plot is None and pp.dtype == np.complex64
        assert np.max(np.abs(pp - pj)) <= 1e-5 * np.max(np.abs(pj))
        np.testing.assert_array_equal(mp, mj)
    np.testing.assert_allclose(rp.t60_s, rj.t60_s, rtol=1e-12)
    # with its default generate_plot=True the call draws the JAX package's
    # figure (ROADMAP C8, repaired)
    import matplotlib

    matplotlib.use("Agg")
    pp, mp, plot = rp.get_analytical_transfer_function([1, 1, 1], [2, 2, 1], freqs)
    pj, mj, jplot = rj.get_analytical_transfer_function([1, 1, 1], [2, 2, 1], freqs)
    assert type(plot[0]) is type(jplot[0]) and type(plot[1]) is type(jplot[1])
    assert np.max(np.abs(pp - pj)) <= 1e-5 * np.max(np.abs(pj))
    np.testing.assert_array_equal(mp, mj)
    matplotlib.pyplot.close("all")


@pytest.mark.parametrize("antiresonances", [False, True])
def test_find_modes_matches_jax(antiresonances):
    """CMIF peaks of a modal IR (two channels: a batched 2 × 2 SVD per bin):
    the same frequencies."""
    j, p = _both_irs(_modal_ir(), 48000)
    want = jra.find_modes(j, [50, 160], antiresonances=antiresonances)
    got = ra.find_modes(p, [50, 160], antiresonances=antiresonances)
    np.testing.assert_array_equal(got, want)
    assert len(got) >= 3


def test_convolve_rir_on_signal_matches_jax():
    """`tests/test_room_acoustics.py:185`'s case on a synthetic RIR: 5e-5
    scale-relative, as there."""
    rng = np.random.default_rng(0)
    noise = rng.standard_normal((8000, 2)) * 0.3
    rir = _modal_ir()[:, :1].copy()
    for keep in (True, False):
        want = jra.convolve_rir_on_signal(jdsp.Signal(None, noise, 48000),
                                          jdsp.ImpulseResponse(None, rir, 48000), keep, keep)
        got = ra.convolve_rir_on_signal(Signal(None, noise, 48000),
                                        ImpulseResponse(None, rir, 48000), keep, keep)
        w = np.asarray(want.time_data)
        assert got.time_data.shape == w.shape
        assert np.max(np.abs(got.time_data.numpy() - w)) <= 5e-5 * np.max(np.abs(w))


# ---- the configurations (tools.room_measurement) at small sizes ------------


def test_measured_room_small():
    """(a) on two of `tools.measurement`'s room IRs: the octave bands
    within 5e-6 of scipy's float64 ``sosfilt`` (scale-relative), every RT
    mode and descriptor equal to the entry points' own, plausible RT60s."""
    x = _room_irs()
    fs = measurement.FS
    ir = ImpulseResponse(None, x, fs)
    bank = rm.octave_bank(fs)
    out = rm.measured_room(ir, bank)
    assert out["bands"].number_of_bands == 6
    for f, band in zip(bank.filters, out["bands"].bands):
        want = sosfilt(f.sos, x.astype(np.float64), axis=0)
        assert np.max(np.abs(band.time_data.numpy() - want)) <= 5e-6 * np.max(np.abs(want))
    for mode in rm.REVERB_TIMES:
        np.testing.assert_array_equal(out["rt"][mode.name],
                                      ra.reverb_time(out["bands"], mode)[0])
        assert out["rt"][mode.name].shape == (6, 2)
    # 0.75 s IRs over a −60 dB floor: each band's fit scatters around the
    # decay's 0.6 s
    assert abs(np.median(out["rt"]["T20"]) - measurement.RT60_S) <= 0.15 * measurement.RT60_S
    assert np.all((out["rt"]["T30"] > 0.3) & (out["rt"]["T30"] < 1.0))
    for name, v in out["descriptors"].items():
        assert v.shape == (2,) and np.all(np.isfinite(v)), name


def test_ism_fleet_small():
    """(c) at a lattice limit of 6: positions inside the room, rows with
    the single-RIR oracle's support, descriptors of the fleet."""
    s, r = rm.fleet_positions(3, seed=1)
    room = rm.room()
    assert all(room.check_if_in_room(p) for p in np.concatenate([s, r]))
    rirs, desc = rm.ism_fleet(room, s, r, max_order=6)
    assert tuple(rirs.shape) == (3, int(rm.FLEET_SECONDS * rm.FLEET_FS))
    bk.set_ism_device(False)
    for b in range(3):
        single = ra.generate_synthetic_rir(room, s[b], r[b], rm.FLEET_FS,
                                           rm.FLEET_SECONDS, max_order=6)
        np.testing.assert_array_equal(np.nonzero(rirs[b].numpy())[0],
                                      np.nonzero(single.time_data[:, 0].numpy())[0])
    assert set(desc) == {"d50", "c80", "center_time_s"}
    assert all(bool(torch.isfinite(v).all()) for v in desc.values())


def test_exports_match_jax():
    assert ra.__all__ == jra.__all__
    for name in jra.__all__ + ["batch_energy_decay", "batch_descriptors", "batch_reverb_times"]:
        assert hasattr(ra, name), name
    assert [m.name for m in ra.ReverbTime] == [m.name for m in jra.ReverbTime]
    assert [m.name for m in ra.RoomAcousticsDescriptor] == [
        m.name for m in jra.RoomAcousticsDescriptor]

"""The port's file layer (`io`: WAV, FLAC, object archives), the classes'
file, calibration, structure and saving methods, their plots, the new
helpers and the two calls whose default plot raised (ROADMAP C8), on the
CPU against the JAX package: file bytes and samples exact both ways,
archives loading in the other package with equal arrays and metadata,
`CalibrationData` at 1e-6, helpers at 2e-5, plots under Agg. Small sizes:
up to 3 channels × 0.5 s."""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy import signal as ss  # noqa: E402

from conftest import assert_close  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import dsptoolbox_tpu as jdsp  # noqa: E402
from dsptoolbox_tpu import helpers as jhelpers  # noqa: E402
from dsptoolbox_tpu import io as jio  # noqa: E402
from dsptoolbox_tpu.helpers import bytes_conversion as jbytes  # noqa: E402
from dsptoolbox_tpu.room_acoustics import ShoeboxRoom as JShoeboxRoom  # noqa: E402
import dsptoolbox_tpu_torch as dtt  # noqa: E402
from dsptoolbox_tpu_torch import _config, helpers, io  # noqa: E402
from dsptoolbox_tpu_torch.classes import (  # noqa: E402
    CalibrationData, Filter, FilterBank, ImpulseResponse, MultiBandSignal, Signal, Spectrum,
)
from dsptoolbox_tpu_torch.helpers import bytes_conversion  # noqa: E402
from dsptoolbox_tpu_torch.room_acoustics import ShoeboxRoom  # noqa: E402
from dsptoolbox_tpu_torch.standard import load_pkl_object  # noqa: E402
from dsptoolbox_tpu_torch.standard.enums import (  # noqa: E402
    FilterBankMode, FilterCoefficientsType, FilterPassType,
)

torch.set_num_threads(1)

FS = 48000
RNG = np.random.default_rng(61)
X = (0.4 * RNG.standard_normal((24000, 3))).clip(-0.99, 0.99)


@pytest.fixture(autouse=True)
def _cpu_and_close():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)
    plt.close("all")


# ---- WAV and FLAC -------------------------------------------------------------

WAV_SUBTYPES = ["PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE"]


@pytest.mark.parametrize("subtype", WAV_SUBTYPES)
def test_wav_is_bit_exact_both_ways(subtype, tmp_path):
    """The port's writer writes the JAX package's bytes, and each package
    reads the other's file to the same samples."""
    p, j = str(tmp_path / "p.wav"), str(tmp_path / "j.wav")
    io.write_wav(p, X, FS, subtype)
    jio.write_wav(j, X, FS, subtype)
    assert open(p, "rb").read() == open(j, "rb").read()
    got, fs = io.read_wav(j)
    want, jfs = jio.read_wav(p)
    assert fs == jfs == FS
    np.testing.assert_array_equal(got, want)
    step = {"PCM_16": 2.0**-15, "PCM_24": 2.0**-23, "PCM_32": 2.0**-31, "FLOAT": 1e-7,
            "DOUBLE": 0.0}[subtype]
    assert np.max(np.abs(got - X)) <= step


def _extensible_and_rf64(path: str, data: np.ndarray, rf64: bool) -> None:
    """A 16-bit WAVE_FORMAT_EXTENSIBLE file, in an RF64 container when
    ``rf64`` (32-bit sizes 0xFFFFFFFF, real sizes in ``ds64``)."""
    import struct

    ints = np.round(data * 2.0**15).astype("<i2")
    payload = ints.tobytes()
    ch = data.shape[1]
    fmt = struct.pack("<HHIIHHHHIH14s", 0xFFFE, ch, FS, FS * 2 * ch, 2 * ch, 16, 22, 16,
                      0, 1, b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71")
    with open(path, "wb") as fh:
        if rf64:
            fh.write(struct.pack("<4sI4s", b"RF64", 0xFFFFFFFF, b"WAVE"))
            fh.write(struct.pack("<4sIQQQI", b"ds64", 28, 0, len(payload), ints.shape[0], 0))
        else:
            fh.write(struct.pack("<4sI4s", b"RIFF", 4 + 8 + len(fmt) + 8 + len(payload),
                                 b"WAVE"))
        fh.write(struct.pack("<4sI", b"fmt ", len(fmt)) + fmt)
        fh.write(struct.pack("<4sI", b"data", 0xFFFFFFFF if rf64 else len(payload)))
        fh.write(payload)


@pytest.mark.parametrize("rf64", [False, True])
def test_wav_extensible_and_rf64_read_as_the_jax_package_reads_them(rf64, tmp_path):
    path = str(tmp_path / "x.wav")
    _extensible_and_rf64(path, X[:1000], rf64)
    got, fs = io.read_wav(path)
    want, _ = jio.read_wav(path)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1000, 3) and fs == FS


def test_wav_8_bit_and_mono(tmp_path):
    import struct

    path = str(tmp_path / "u8.wav")
    u8 = RNG.integers(0, 256, 500).astype(np.uint8)
    fmt = struct.pack("<HHIIHH", 1, 1, FS, FS, 1, 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sI4s", b"RIFF", 4 + 8 + 16 + 8 + 500, b"WAVE"))
        fh.write(struct.pack("<4sI", b"fmt ", 16) + fmt)
        fh.write(struct.pack("<4sI", b"data", 500) + u8.tobytes())
    got, _ = io.read_wav(path)
    np.testing.assert_array_equal(got, jio.read_wav(path)[0])
    assert got.shape == (500,)


@pytest.mark.parametrize("bits", [8, 16, 24])
def test_flac_is_bit_exact_both_ways(bits, tmp_path):
    p, j = str(tmp_path / "p.flac"), str(tmp_path / "j.flac")
    io.audio.write_audio(p, X, FS, f"PCM_{bits}")
    jio.write_audio(j, X, FS, f"PCM_{bits}")
    assert open(p, "rb").read() == open(j, "rb").read()
    got, fs = io.read_audio(j)
    want, _ = jio.read_audio(p)
    np.testing.assert_array_equal(got, want)
    assert fs == FS and np.max(np.abs(got - X)) <= 2.0 ** (1 - bits)
    with pytest.raises(ValueError):
        io.write_audio(p, X, FS, "FLOAT")


def test_flac_codec_builds_from_the_port_into_its_build_directory():
    from dsptoolbox_tpu_torch.io import flac

    from dsptoolbox_tpu_torch import _cuda

    path = flac._build()
    assert os.path.dirname(path) == str(_cuda.BUILD_DIR)
    assert _cuda.BUILD_DIR.parent.name == "dsptoolbox_tpu_torch"
    assert os.path.basename(path).startswith("libflac_codec-")


def test_bytes_conversion_matches_jax():
    v = RNG.integers(-(2**23), 2**23, 300).astype(np.int32)
    packed = bytes_conversion.array_to_bytes_24bits(v)
    assert packed == jbytes.array_to_bytes_24bits(v)
    np.testing.assert_array_equal(bytes_conversion.bytes_to_array_24bits(packed, True), v)
    np.testing.assert_array_equal(bytes_conversion.bytes_to_array_24bits(packed, False),
                                  jbytes.bytes_to_array_24bits(packed, False))


# ---- Signal from and to files -------------------------------------------------

@pytest.mark.parametrize("ext", ["wav", "flac"])
def test_signal_from_path_and_add_channel(ext, tmp_path):
    path, more = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
    io.write_audio(path, X[:, :2], FS, "PCM_24")
    io.write_audio(more, X[:20000, 2], FS, "PCM_24")
    got = Signal(path)
    want = jdsp.Signal(path)
    assert got.device.type == "cpu" and got.sampling_rate_hz == want.sampling_rate_hz
    np.testing.assert_array_equal(got.time_data.numpy(), np.asarray(want.time_data))
    np.testing.assert_array_equal(Signal.from_file(path).time_data.numpy(),
                                  got.time_data.numpy())
    with pytest.warns(UserWarning, match="Padding"):
        got.add_channel(more)
    with pytest.warns(UserWarning, match="Padding"):
        want.add_channel(more)
    np.testing.assert_array_equal(got.time_data.numpy(), np.asarray(want.time_data))
    ir = ImpulseResponse.from_file(path)
    assert isinstance(ir, ImpulseResponse) and ir.number_of_channels == 2
    with pytest.raises(AssertionError):
        Signal(path, X, FS)


@pytest.mark.parametrize("mode,bits", [("wav", 16), ("wav", 24), ("wav", 32), ("wav", 64),
                                       ("flac", 16), ("flac", 24), ("pkl", 32)])
def test_save_signal_matches_jax(mode, bits, tmp_path):
    s = Signal(None, X, FS)
    js = jdsp.Signal(None, X, FS)
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    s.save_signal(p, mode, bits)
    js.save_signal(j, mode, bits)
    if mode == "pkl":
        back = load_pkl_object(p + ".pkl")
        assert type(back) is Signal
        np.testing.assert_array_equal(back.time_data.numpy(), s.time_data.numpy())
        assert back.metadata == s.metadata
        return
    assert open(f"{p}.{mode}", "rb").read() == open(f"{j}.{mode}", "rb").read()
    np.testing.assert_array_equal(Signal(f"{p}.{mode}").time_data.numpy(),
                                  np.asarray(jdsp.Signal(f"{j}.{mode}").time_data))
    with pytest.raises(ValueError):
        s.save_signal(p, "mp3")


def test_signal_metadata_and_calibrated_flag():
    s = Signal(None, X, FS)
    js = jdsp.Signal(None, X, FS)
    assert s.metadata == js.metadata and str(s) == str(js) == s.metadata_str
    assert s.calibrated_signal is False
    s.calibrated_signal = True
    assert s.copy_with_new_time_data(X[:100]).calibrated_signal


# ---- object archives (save_object / load_object) -------------------------------

def _objects(pkg):
    """The same objects in either package: a Signal, an IR with its window,
    a Filter in each representation, a FilterBank, a MultiBandSignal and a
    Spectrum with coherence."""
    m = pkg
    sig_ = m.Signal(None, X[:4000], FS)
    ir = m.ImpulseResponse(None, X[:4000, :2], FS)
    ir.set_window(np.hanning(4000)[:, None].repeat(2, 1))
    zpk = ss.butter(4, 1000.0, fs=FS, output="zpk")
    filters = [m.Filter.from_zpk(*zpk, FS), m.Filter.from_ba(*ss.butter(2, 500.0, fs=FS), FS),
               m.Filter.from_sos(ss.butter(6, 3000.0, fs=FS, output="sos"), FS)]
    fb = m.FilterBank(filters[1:], info={"name": "two"})
    mb = m.MultiBandSignal([m.Signal(None, X[:2000], FS), m.Signal(None, 0.5 * X[:2000], FS)],
                           info={"bands": 2})
    spec = m.Spectrum(np.linspace(1, 24000, 200), np.abs(X[:200, :2]) + 0.1)
    spec.set_coherence(np.full((200, 2), 0.7))
    return {"signal": sig_, "ir": ir, "zpk": filters[0], "ba": filters[1], "sos": filters[2],
            "bank": fb, "bands": mb, "spectrum": spec}


def _arrays(obj) -> dict:
    """The arrays and metadata an archive holds, as host numpy."""
    from dsptoolbox_tpu_torch.io import serialization as ser

    name = type(obj).__name__
    if "dsptoolbox_tpu_torch" in type(obj).__module__:
        meta, arrays = ser._ENCODERS[name](obj)
    else:
        from dsptoolbox_tpu.io import serialization as jser

        enc = {"Signal": jser._encode_signal, "ImpulseResponse": jser._encode_signal,
               "Filter": jser._encode_filter, "FilterBank": jser._encode_filterbank,
               "MultiBandSignal": jser._encode_multiband, "Spectrum": jser._encode_spectrum}
        meta, arrays = enc[name](obj)
    return meta, {k: np.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("name", ["signal", "ir", "zpk", "ba", "sos", "bank", "bands",
                                  "spectrum"])
def test_archives_load_in_the_other_package(name, tmp_path):
    port_obj, jax_obj = _objects(dtt)[name], _objects(jdsp)[name]
    p = io.save_object(port_obj, str(tmp_path / "p"))
    j = jio.save_object(jax_obj, str(tmp_path / "j"))
    loaded_in_jax = jio.load_object(p)
    loaded_in_port = io.load_object(j)
    assert type(loaded_in_port).__name__ == type(jax_obj).__name__
    assert "dsptoolbox_tpu_torch" in type(loaded_in_port).__module__
    for a, b in ((loaded_in_jax, jax_obj), (loaded_in_port, port_obj),
                 (io.load_object(p), port_obj)):
        ma, aa = _arrays(a)
        mb, ab = _arrays(b)
        assert ma == mb
        assert aa.keys() == ab.keys()
        for k in aa:
            # the port holds spectra in float32, the JAX package in float64
            rtol = 2.0**-23 if name == "spectrum" else 0.0
            np.testing.assert_allclose(aa[k].astype(ab[k].dtype), ab[k], rtol=rtol, atol=0)
    with pytest.raises(TypeError):
        io.save_object(object(), str(tmp_path / "x"))


# ---- pickles of the classes ---------------------------------------------------

def test_class_pickles_round_trip(tmp_path):
    objs = _objects(dtt)
    cases = [(objs["signal"], "save_signal"), (objs["bands"], "save_signal"),
             (objs["zpk"], "save_filter"), (objs["bank"], "save_filterbank"),
             (objs["spectrum"], "save_spectrum")]
    for obj, method in cases:
        path = str(tmp_path / method)
        getattr(obj, method)(path) if method != "save_signal" or isinstance(
            obj, MultiBandSignal) else obj.save_signal(path, "pkl")
        back = load_pkl_object(path)
        assert type(back) is type(obj)
        m1, a1 = _arrays(back)
        m0, a0 = _arrays(obj)
        assert m1 == m0
        for k in a0:
            np.testing.assert_array_equal(a1[k], a0[k])


# ---- CalibrationData ----------------------------------------------------------

@pytest.mark.parametrize("high_snr", [True, False])
def test_calibration_matches_jax(high_snr, tmp_path):
    t = np.arange(FS) / FS
    tone = 0.3 * np.sin(2 * np.pi * 1000 * t)
    path = str(tmp_path / "cal.wav")
    io.write_wav(path, tone, FS, "PCM_24")
    second = (0.2 * np.sin(2 * np.pi * 1000 * t + 0.3), FS)
    cal = CalibrationData(path, 94, high_snr).add_calibration_channel(second)
    jcal = jdsp.CalibrationData(path, 94, high_snr).add_calibration_channel(second)
    rec = Signal(None, X[:, :2], FS)
    got = cal.calibrate_signal(rec)
    want = jcal.calibrate_signal(jdsp.Signal(None, X[:, :2], FS))
    # the port reduces in float64 on the device; the JAX package's np.std
    # of its float32 mirror accumulates in float32 (1.8e-5 off here)
    if high_snr:
        td = np.stack([io.read_wav(path)[0], second[0]], 1).astype(np.float32)
        p_ref = 10 ** (94 / 20) * 20e-6 / np.std(td.astype(np.float64), axis=0)
        np.testing.assert_allclose(cal.calibration_factors, p_ref, rtol=1e-9)
    tol = 5e-5 if high_snr else 1e-6
    np.testing.assert_allclose(cal.calibration_factors, jcal.calibration_factors, rtol=tol)
    assert got.calibrated_signal and not got.constrain_amplitude
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), tol)
    mb = MultiBandSignal([rec, rec.copy()])
    got_mb = cal.calibrate_signal(mb)
    assert all(b.calibrated_signal for b in got_mb.bands)
    one = CalibrationData((tone, FS))
    assert len(one.calibrate_signal(Signal(None, X, FS)).time_data.T) == 3
    with pytest.raises(TypeError):
        CalibrationData(3.0)
    with pytest.raises(AssertionError):
        cal.calibrate_signal(Signal(None, X, FS))


# ---- class structure methods --------------------------------------------------

def test_filterbank_and_multiband_structure_match_jax(tmp_path):
    objs, jobs = _objects(dtt), _objects(jdsp)
    fb, jfb = objs["bank"], jobs["bank"]
    f = np.linspace(10, 20000, 64)
    for mode in (FilterBankMode.Parallel, FilterBankMode.Sequential, FilterBankMode.Summed):
        jmode = getattr(jdsp.FilterBankMode, mode.name)
        np.testing.assert_allclose(fb.get_transfer_function(f, mode),
                                   jfb.get_transfer_function(f, jmode), rtol=1e-12)
    assert fb.metadata_str == jfb.metadata_str
    fb.swap_filters([1, 0]).add_filter(objs["sos"])
    _, removed = fb.remove_filter(0, return_filter=True)
    assert removed is objs["sos"] and fb.filters[0] is objs["ba"] and fb.number_of_filters == 2
    mb, jmb = objs["bands"], jobs["bands"]
    assert mb.metadata_str == jmb.metadata_str and mb.length_seconds == jmb.length_seconds
    got = FilterBank([objs["ba"], objs["sos"]]).filter_multiband_signal(mb, activate_zi=True)
    want = jdsp.FilterBank([jobs["ba"], jobs["sos"]]).filter_multiband_signal(
        jmb, activate_zi=True)
    for g, w in zip(got.bands, want.bands):
        assert_close(g.time_data.numpy(), np.asarray(w.time_data), 2e-5)
    all_bands = mb.get_all_bands(1)
    np.testing.assert_array_equal(all_bands.time_data.numpy(),
                                  np.asarray(jmb.get_all_bands(1).time_data))
    mb.swap_bands([1, 0])
    _, band = mb.remove_band(0, return_band=True)
    assert mb.number_of_bands == 1
    path = str(tmp_path / "fir.wav")
    io.write_wav(path, X[:64, :2], FS, "DOUBLE")
    fir_bank = FilterBank.firs_from_file(path)
    np.testing.assert_array_equal(fir_bank.filters[1].ba[0], X[:64, 1].astype(np.float32))
    fir = Filter.fir_from_file(path, 1)
    np.testing.assert_array_equal(fir.ba[0], jdsp.Filter.fir_from_file(path, 1).ba[0])
    assert str(fir) == str(jdsp.Filter.fir_from_file(path, 1))


# ---- plots ----------------------------------------------------------------------

def _fig_ax(out):
    fig, ax = out
    assert isinstance(fig, matplotlib.figure.Figure)
    return ax


@pytest.mark.parametrize("call", [
    lambda s: s.plot_magnitude(), lambda s: s.plot_time(), lambda s: s.plot_spl(),
    lambda s: s.plot_spl(window_length_s=0.01, normalize_at_peak=True),
    lambda s: s.plot_group_delay(remove_ir_latency="peak"),
    lambda s: s.plot_spectrogram(), lambda s: s.plot_csm(),
])
def test_signal_plots(call):
    _fig_ax(call(Signal(None, X[:8000], FS)))


def test_signal_phase_and_ir_plots():
    ir = ImpulseResponse(None, X[:4096, :2] * np.exp(-np.arange(4096) / 300)[:, None], FS)
    ir.set_window(np.hanning(4096)[:, None].repeat(2, 1))
    _fig_ax(ir.plot_phase(unwrap=True, smoothing=3))
    _fig_ax(ir.plot_time())
    _fig_ax(ir.plot_spl())
    _fig_ax(ir.plot_bode(show_group_delay=True, remove_ir_latency="min_phase"))


def test_filter_filterbank_and_spectrum_plots():
    iir = Filter.iir_filter(4, 1000.0, FilterPassType.Lowpass, FS)
    fir = Filter.fir_filter(64, 3000.0, FilterPassType.Lowpass, FS)
    for out in (iir.plot_magnitude(), iir.plot_group_delay(), iir.plot_phase(), iir.plot_zp(),
                fir.plot_taps(in_db=True)):
        _fig_ax(out)
    with pytest.raises(AssertionError):
        iir.plot_taps()
    fb = FilterBank([iir, fir])
    for out in (fb.plot_magnitude(), fb.plot_phase(unwrap=True), fb.plot_group_delay()):
        _fig_ax(out)
    multirate = FilterBank([iir, Filter.iir_filter(2, 500.0, FilterPassType.Lowpass, 16000)],
                           same_sampling_rate=False)
    with pytest.warns(UserWarning, match="multirate"):
        assert multirate.plot_magnitude() is None
    spec = _objects(dtt)["spectrum"]
    _fig_ax(spec.plot_magnitude())
    _fig_ax(spec.plot_coherence())


@pytest.mark.parametrize("call", ["harmonic_distortion_analysis", "analytical_transfer_function"])
def test_c8_calls_return_figures_with_their_defaults(call):
    """ROADMAP C8 (repaired): both calls raised with their default
    ``generate_plot=True``; they return the JAX package's outputs and
    figure."""
    if call == "analytical_transfer_function":
        freqs = np.linspace(20, 200, 50)
        p, modes, plot = ShoeboxRoom([4, 3, 2.5], t60_s=0.4).get_analytical_transfer_function(
            [1, 1, 1], [2, 2, 1.2], freqs)
        jp, jmodes, jplot = JShoeboxRoom([4, 3, 2.5], t60_s=0.4).get_analytical_transfer_function(
            [1, 1, 1], [2, 2, 1.2], freqs)
        assert np.max(np.abs(p - jp)) <= 1e-5 * np.max(np.abs(jp))
        np.testing.assert_array_equal(modes, jmodes)
        assert [type(v) for v in plot] == [type(v) for v in jplot]
        return
    from dsptoolbox_tpu import transfer_functions as jtf
    from dsptoolbox_tpu_torch import transfer_functions as tf

    n = FS
    x = ss.chirp(np.arange(n) / FS, 20, 1.0, 20000, method="logarithmic")
    y = x + 0.05 * x**2
    h = np.fft.irfft(np.fft.rfft(y, 2 * n) / (np.fft.rfft(x, 2 * n) + 1e-3), 2 * n)[:n]
    ir = ImpulseResponse(None, h.astype(np.float32), FS)
    jir = jdsp.ImpulseResponse(None, h.astype(np.float32), FS)
    got = tf.harmonic_distortion_analysis(ir, [20, 20000], 1.0, 3)
    want = jtf.harmonic_distortion_analysis(jir, [20, 20000], 1.0, 3)
    assert set(got) == set(want) and "plot" in got
    assert [type(v) for v in got["plot"]] == [type(v) for v in want["plot"]]
    for key in ("thd", "thd_n", "thd_percent"):
        assert_close(got[key].spectral_data.numpy(), np.asarray(want[key].spectral_data),
                     2e-5, key)


# ---- helpers ----------------------------------------------------------------------

def test_helpers_match_jax():
    x = X[:, 0]
    assert helpers.next_power_2(1000) == jhelpers.next_power_2(1000)
    assert helpers.next_power_2(1000, "floor") == jhelpers.next_power_2(1000, "floor")
    assert helpers.check_format_in_path("a/b", "wav") == jhelpers.check_format_in_path("a/b", "wav")
    f = np.linspace(0, 24000, 500)
    spec = np.abs(np.fft.rfft(x[:998])) + 1e-3
    assert helpers.find_frequencies_above_threshold(spec, f, -20) == \
        jhelpers.find_frequencies_above_threshold(spec, f, -20)
    h = X[:32, 1].astype(np.float32)
    np.testing.assert_array_equal(
        helpers.toeplitz_convolution_matrix(torch.from_numpy(h), 50).numpy(),
        np.asarray(jhelpers.toeplitz_convolution_matrix(jnp.asarray(h), 50)))
    a, b = X[:20, :3], X[20:50, :3]
    assert_close(helpers.euclidean_distance_matrix(torch.from_numpy(a),
                                                   torch.from_numpy(b)).numpy(),
                 np.asarray(jhelpers.euclidean_distance_matrix(jnp.asarray(a, jnp.float32),
                                                               jnp.asarray(b, jnp.float32))),
                 2e-5)
    for sym in (True, False):
        np.testing.assert_array_equal(helpers.gaussian_window(101, 2.5, sym, 3),
                                      jhelpers.gaussian_window(101, 2.5, sym, 3))
    assert helpers.gaussian_window_sigma(101) == jhelpers.gaussian_window_sigma(101)
    xt = torch.from_numpy(X.T.astype(np.float32))
    assert_close(helpers.rms(xt).numpy(), np.asarray(jhelpers.rms(jnp.asarray(X.T, jnp.float32))))
    assert_close(helpers.rms(xt, remove_mean=False).numpy(),
                 np.asarray(jhelpers.rms(jnp.asarray(X.T, jnp.float32), remove_mean=False)))
    assert_close(helpers.amplify_db(xt, 6).numpy(),
                 np.asarray(jhelpers.amplify_db(jnp.asarray(X.T, jnp.float32), 6)))
    for flip in (False, True):
        x32 = X[:1001].astype(np.float32)
        poly, pad = helpers.polyphase_decomposition(torch.from_numpy(x32), 4, flip)
        jpoly, jpad = jhelpers.polyphase_decomposition(jnp.asarray(x32), 4, flip)
        assert pad == jpad
        np.testing.assert_array_equal(poly.numpy(), np.asarray(jpoly))
        np.testing.assert_array_equal(helpers.polyphase_reconstruction(poly).numpy(),
                                      np.asarray(jhelpers.polyphase_reconstruction(jpoly)))

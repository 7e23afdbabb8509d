"""The port's public `tools` (the JAX package's `dsptoolbox_tpu/tools.py`)
and `audio_io` against the JAX package's on the CPU.

`tools`: its 19 names; framing in the reference layout equal to the JAX
package's (numpy and tensors); the host functions equal. `audio_io`:
without sounddevice every call raises ``RuntimeError`` and the module
imports; with `tests/test_audio_io.py`'s loopback fake (copied here, so
nothing is installed) the API plays, records, loops back and configures."""

import sys
import types

import numpy as np
import pytest
import torch

import dsptoolbox_tpu as jdsp
import dsptoolbox_tpu_torch as dtt
from dsptoolbox_tpu_torch import _config, audio_io, tools
from dsptoolbox_tpu_torch.classes import Signal

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


# ======== tools =============================================================
def test_tools_exports_the_jax_names_and_no_scripts():
    assert set(tools.__all__) == set(jdsp.tools.__all__) and len(tools.__all__) == 19
    assert dtt.tools is tools
    for name in ("camera", "profile_chain", "effects_chain"):
        assert name not in tools.__all__


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_framed_signal_and_reconstruction(keep, as_tensor):
    from dsptoolbox_tpu_torch.ops.windows import get_window

    x = np.random.default_rng(2).standard_normal((1000, 2)).astype(np.float32)
    want = np.asarray(jdsp.tools.framed_signal(x, 128, 64, keep))
    got = tools.framed_signal(torch.from_numpy(x) if as_tensor else x, 128, 64, keep)
    assert torch.is_tensor(got) == as_tensor
    got = got.numpy() if as_tensor else got
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tools.framed_signal(x[:, 0], 128, 64, keep),
                                  np.asarray(jdsp.tools.framed_signal(x[:, 0], 128, 64, keep)))
    w = get_window("hann", 128)
    frames = want * w[:, None, None]
    rec = tools.reconstruct_from_framed_signal(
        torch.from_numpy(frames) if as_tensor else frames, 64, w, 1000)
    rec = rec.numpy() if as_tensor else rec
    want_rec = np.asarray(jdsp.tools.reconstruct_from_framed_signal(frames, 64, w, 1000))
    np.testing.assert_allclose(rec, want_rec, rtol=1e-6, atol=1e-6)
    if keep:
        np.testing.assert_allclose(rec[64:-64], x[64:-64], atol=1e-5)


def test_host_tools_equal_the_jax_package():
    f = tools.log_frequency_vector([20, 20000], 12)
    np.testing.assert_array_equal(f, jdsp.tools.log_frequency_vector([20, 20000], 12))
    y = np.sin(np.arange(len(f)) / 7.0)
    for freq in (20.0, 1000.0, f[-1], 5123.4):
        assert tools.get_exact_value_at_frequency(f, y, freq) == \
            jdsp.tools.get_exact_value_at_frequency(f, y, freq)
    m = np.random.default_rng(0).random((50, 3))
    np.testing.assert_array_equal(tools.log_mean(m), jdsp.tools.log_mean(m))
    np.testing.assert_array_equal(tools.log_mean(m.T, axis=1), jdsp.tools.log_mean(m.T, axis=1))
    for log in (True, False):
        x = np.linspace(50, 2500, 97)
        np.testing.assert_array_equal(tools.frequency_crossover([100, 2000], log)(x),
                                      jdsp.tools.frequency_crossover([100, 2000], log)(x))
    for args in ((3, (20, 20e3), True), (1, (50, 5e3), False), (6, (100, 1e4), True)):
        for a, b in zip(tools.fractional_octave_frequencies(*args),
                        jdsp.tools.fractional_octave_frequencies(*args)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tools.erb_frequencies([50, 8000], 0.5),
                                  jdsp.tools.erb_frequencies([50, 8000], 0.5))
    assert tools.next_power_2(1000) == jdsp.tools.next_power_2(1000)
    assert tools.get_smoothing_factor_ema(0.1, 48000) == \
        pytest.approx(jdsp.tools.get_smoothing_factor_ema(0.1, 48000), rel=1e-15)


@pytest.mark.parametrize("fmt", [("f32", "i16", True, False), ("f64", "u8", True, False),
                                 ("f32", "i24", True, True), ("f32", "i16", False, True),
                                 ("i16", "f32", True, False)])
def test_convert_sample_representation(fmt):
    src, dst, cast, as_bytes = fmt
    x = np.random.default_rng(1).uniform(-1.2, 1.2, 64)
    if src == "i16":
        x = (x.clip(-1, 1) * 32767).astype(np.int16).tobytes()
    got = tools.convert_sample_representation(x, src, dst, cast, as_bytes)
    want = jdsp.tools.convert_sample_representation(x, src, dst, cast, as_bytes)
    assert got[1:] == want[1:]
    if as_bytes and isinstance(want[0], bytes):
        assert got[0] == want[0]
    else:
        np.testing.assert_array_equal(got[0], want[0])
        assert np.asarray(got[0]).dtype == np.asarray(want[0]).dtype
    with pytest.raises(AssertionError):
        tools.convert_sample_representation(x, "f32", "f32")


# ======== audio_io ============================================================
def test_audio_io_exports_and_raises_without_sounddevice(monkeypatch):
    assert set(audio_io.__all__) == set(jdsp.audio_io.__all__) and len(audio_io.__all__) == 11
    monkeypatch.setitem(sys.modules, "sounddevice", None)  # importing it raises
    s = Signal(None, np.zeros((100, 1), np.float32), 8000)
    calls = [lambda: audio_io.print_device_info(), lambda: audio_io.set_latency(True, True),
             lambda: audio_io.set_blocksize(64), lambda: audio_io.set_device(0),
             lambda: audio_io.play(s), lambda: audio_io.record(0.1),
             lambda: audio_io.play_and_record(s), lambda: audio_io.CallbackStop(),
             lambda: audio_io.sleep(0.1), lambda: audio_io.output_stream(s),
             lambda: audio_io.default_config.blocksize]
    for call in calls:
        with pytest.raises(RuntimeError, match="sounddevice is not available"):
            call()


@pytest.fixture
def fake_sd(monkeypatch):
    """A loopback sounddevice fake for the duration of a test (the one of
    `tests/test_audio_io.py`)."""
    sd = types.ModuleType("sounddevice")
    state = {"played": None, "slept_ms": None}

    sd.default = types.SimpleNamespace(
        device=None, samplerate=None, blocksize=None, latency=None
    )

    class DeviceList(list):
        pass

    sd.DeviceList = DeviceList
    sd.query_devices = lambda *a, **k: (
        {"name": "fake", "index": a[0]} if a else DeviceList(
            [{"name": "fake", "index": 0}, {"name": "other", "index": 1}]
        )
    )

    def playrec(data, samplerate, input_mapping, output_mapping,
                blocking=True, **kw):
        state["played"] = np.array(data)
        out = np.zeros((len(data), len(input_mapping)))
        # loopback: copy first played channel into every record channel
        for c in range(len(input_mapping)):
            out[:, c] = np.asarray(data)[:, 0]
        return out

    def rec(frames, samplerate, mapping, blocking=True, **kw):
        rng = np.random.default_rng(0)
        return rng.standard_normal((frames, len(mapping))) * 1e-3

    def play(data, samplerate, mapping=None, blocking=True, **kw):
        state["played"] = np.array(data)

    sd.playrec, sd.rec, sd.play = playrec, rec, play

    def _sleep(ms):
        state["slept_ms"] = ms

    sd.sleep = _sleep

    class CallbackStop(Exception):
        pass

    sd.CallbackStop = CallbackStop

    class OutputStream:
        def __init__(self, *a, **k):
            self.kwargs = k

    sd.OutputStream = OutputStream

    monkeypatch.setitem(sys.modules, "sounddevice", sd)
    return sd, state


def _tone(fs=8000, n=4000):
    t = np.arange(n) / fs
    return Signal(None, (0.3 * np.sin(2 * np.pi * 440 * t))[:, None], fs)


def test_audio_io_defaults_and_device(fake_sd):
    sd, _ = fake_sd
    audio_io.set_latency(True, False)
    assert sd.default.latency == ("low", "high")
    audio_io.set_blocksize(256)
    assert sd.default.blocksize == 256
    audio_io.set_device(0, sampling_rate_hz=44100)
    assert sd.default.device == 0 and sd.default.samplerate == 44100
    audio_io.set_device("other")
    assert sd.default.device == 1
    audio_io.set_device([0, 1])
    assert sd.default.device == [0, 1]
    audio_io.set_device(["fake", "other"])
    assert sd.default.device == [0, 1]
    assert audio_io.default_config.blocksize == 256
    with pytest.raises(ValueError, match="No device"):
        audio_io.set_device("missing")
    with pytest.raises(TypeError):
        audio_io.set_device(1.5)
    assert audio_io.print_device_info(device_number=0) is not None


def test_audio_io_play_record_loopback(fake_sd):
    _, state = fake_sd
    s = _tone()
    audio_io.play(s, normalized_dbfs=None)
    np.testing.assert_allclose(state["played"], s.time_data.numpy())
    audio_io.play(s, duration_seconds=0.25)
    assert state["played"].shape == (2000, 1)
    np.testing.assert_allclose(np.max(np.abs(state["played"])), 10 ** (-6 / 20), rtol=1e-6)
    rec = audio_io.play_and_record(s, normalized_dbfs=None, rec_channels=[1, 2])
    assert rec.number_of_channels == 2 and rec.sampling_rate_hz == s.sampling_rate_hz
    assert rec.device.type == "cpu"
    np.testing.assert_allclose(rec.time_data[:, 0].numpy(), s.time_data[:, 0].numpy(),
                               atol=1e-7)
    rec = audio_io.record(duration_seconds=0.5, sampling_rate_hz=8000)
    assert len(rec) == 4000 and rec.sampling_rate_hz == 8000
    audio_io.sleep(0.25)
    assert state["slept_ms"] == 250
    stream = audio_io.output_stream(_tone(), blocksize=128)
    assert stream.kwargs["blocksize"] == 128 and stream.kwargs["channels"] == 1

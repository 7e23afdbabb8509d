"""The float64 mode's host routing in the port
(`classes/filter_helpers._oracle_exact_f64`, the JAX package's switch of the
same name): a real `Filter` on a CPU signal runs scipy's recursions in float64,
so its output is scipy's to the last bit (the reference's tests hold it at
``rtol=1e-7, atol=0``); ``DSPTB_F64_DEVICE_IIR=1`` keeps the torch paths;
float32 mode never takes scipy. `room_acoustics.convolve_rir_on_signal`
takes the reference's scipy convolution, and `StateVariableFilter` the host
loop `_process_host_f64`, equal bit for bit to the JAX package's. A signal
on a card stays on the card's torch float64 paths."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import dsptoolbox_tpu_torch as dsp
from dsptoolbox_tpu.realtime.misc import StateVariableFilter as JaxSVF
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch.classes import filter_helpers
from dsptoolbox_tpu_torch.realtime import StateVariableFilter
from dsptoolbox_tpu_torch.room_acoustics import convolve_rir_on_signal

torch.set_num_threads(1)

FS = 48000


@pytest.fixture(autouse=True)
def _cpu_float64(monkeypatch):
    """Float64 mode on the CPU without the device switch; the default
    float, device and lazy switch restored after each test."""
    monkeypatch.delenv("DSPTB_F64_DEVICE_IIR", raising=False)
    old = _config.default_device()
    _config.set_default_device("cpu")
    _config.set_default_float("float64")
    yield
    _config.set_default_float("float32")
    _config.set_lazy_host_returns(None)
    _config.set_default_device(old)


def _x(channels=3, n=6000, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, channels))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


FILTERS = {
    "sos": lambda: dsp.Filter.iir_filter(6, 200.0, dsp.FilterPassType.Lowpass, FS),
    "sos bandpass": lambda: dsp.Filter.iir_filter(4, [300.0, 1200.0],
                                                  dsp.FilterPassType.Bandpass, FS),
    "ba": lambda: dsp.Filter.from_ba(*ss.butter(4, 1000.0, fs=FS), FS),
    "ba order 6": lambda: dsp.Filter.from_ba(*ss.butter(6, 200.0, fs=FS), FS),
    "fir": lambda: dsp.Filter.fir_filter(64, 2000.0, dsp.FilterPassType.Lowpass, FS),
}


def _scipy(filt, x, zero_phase=False, zi=None):
    """scipy on ``x (T, C)`` as the reference runs it."""
    if filt.has_sos:
        if zero_phase:
            return ss.sosfiltfilt(filt.sos, x, axis=0), None
        if zi is not None:
            y, zf = ss.sosfilt(filt.sos, x, axis=0, zi=np.stack(zi, axis=-1))
            return y, [zf[..., c] for c in range(x.shape[1])]
        return ss.sosfilt(filt.sos, x, axis=0), None
    b, a = filt.ba
    if zero_phase:
        return ss.filtfilt(b, a, x, axis=0), None
    if zi is not None:
        y, zf = ss.lfilter(b, a, x, axis=0, zi=np.stack(zi, axis=1))
        return y, [zf[:, c] for c in range(x.shape[1])]
    if filt.is_fir:
        return ss.oaconvolve(x, np.asarray(b)[:, None], mode="full", axes=0)[: len(x)], None
    return ss.lfilter(b, a, x, axis=0), None


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("how", ["plain", "zero phase", "zi, two blocks"])
def test_float64_filter_equals_scipy(name, how):
    filt = FILTERS[name]()
    x = _x()
    s = dsp.Signal(None, x, FS)
    if how == "plain":
        got = filt.filter_signal(s).time_data.numpy()
        _close(got, _scipy(filt, x)[0])
    elif how == "zero phase":
        got = filt.filter_signal(s, zero_phase=True).time_data.numpy()
        _close(got, _scipy(filt, x, zero_phase=True)[0])
    else:
        filt.initialize_zi(3)
        zi = [z.copy() for z in filt.zi]
        for block in (x[:2500], x[2500:]):
            got = filt.filter_signal(dsp.Signal(None, block, FS), activate_zi=True)
            want, zi = _scipy(filt, block, zi=zi)
            _close(got.time_data.numpy(), want)
            for z_got, z_want in zip(filt.zi, zi):
                _close(np.asarray(z_got), z_want)


def test_float64_filter_of_selected_channels_equals_scipy():
    filt = FILTERS["sos"]()
    x = _x()
    got = filt.filter_signal(dsp.Signal(None, x, FS), channels=[0, 2]).time_data.numpy()
    _close(got[:, [0, 2]], ss.sosfilt(filt.sos, x[:, [0, 2]], axis=0))
    np.testing.assert_array_equal(got[:, 1], x[:, 1])


class _NoScipy:
    def __getattr__(self, name):
        raise AssertionError(f"scipy.signal.{name} was called")


@pytest.mark.parametrize("name", ["sos", "ba"])
def test_device_switch_keeps_the_torch_paths(monkeypatch, name):
    """``DSPTB_F64_DEVICE_IIR=1``: float64 mode on the torch recursions,
    which take no scipy call and meet scipy at the IIR bound, not bit for
    bit (the order-6 lowpass at 200 Hz: 3e-7 of the peak)."""
    monkeypatch.setenv("DSPTB_F64_DEVICE_IIR", "1")
    assert not filter_helpers._oracle_exact_f64("cpu")
    monkeypatch.setattr(filter_helpers, "ssig", _NoScipy())
    filt = FILTERS[name]()
    x = _x()
    got = filt.filter_signal(dsp.Signal(None, x, FS)).time_data.numpy()
    want = _scipy(filt, x)[0]
    assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()


def test_float64_mode_routes_only_cpu_signals_to_scipy():
    """scipy's host route is for data on the CPU: a card signal's filters
    stay on the card (on the torch float64 paths)."""
    assert filter_helpers._oracle_exact_f64("cpu")
    assert filter_helpers._oracle_exact_f64(torch.device("cpu"))
    assert not filter_helpers._oracle_exact_f64(torch.device("cuda", 0))
    assert not filter_helpers._oracle_exact_f64("cuda")


def test_float32_mode_never_takes_scipy(monkeypatch):
    _config.set_default_float("float32")
    assert not filter_helpers._oracle_exact_f64("cpu")
    monkeypatch.setattr(filter_helpers, "ssig", _NoScipy())
    filt = FILTERS["sos"]()
    x = _x().astype(np.float32)
    got = filt.filter_signal(dsp.Signal(None, x, FS)).time_data
    assert got.dtype == torch.float32
    want = ss.sosfilt(filt.sos, x.astype(np.float64), axis=0)
    assert np.abs(got.numpy() - want).max() <= 5e-6 * np.abs(want).max()


@pytest.mark.parametrize("rir_len", [4000, 300], ids=["oaconvolve", "convolve"])
@pytest.mark.parametrize("keep", [True, False])
def test_convolve_rir_on_signal_takes_scipys_dispatch(rir_len, keep):
    x = _x(2, 6000, seed=1)
    rng = np.random.default_rng(2)
    h = rng.standard_normal(rir_len) * np.exp(-np.arange(rir_len) / 400.0)
    sig, rir = dsp.Signal(None, x, FS), dsp.Signal(None, h, FS)
    got = convolve_rir_on_signal(sig, rir, keep_peak_level=keep, keep_length=keep).time_data
    ratio = len(x) / rir_len
    if ratio < 15.0:
        want = ss.oaconvolve(x, h[:, None], axes=0, mode="full")
    else:
        want = ss.convolve(x, h[:, None], mode="full")
    if keep:
        want = want[: len(x)]
        want = want * (np.max(np.abs(x), axis=0) / np.max(np.abs(want), axis=0))[None]
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_svf_equals_the_jax_host_loop():
    x = _x(2, 3000, seed=3)
    port, ref = StateVariableFilter(1500.0, 0.7, FS), JaxSVF(1500.0, 0.7, FS)
    port.set_n_channels(2)
    ref.set_n_channels(2)
    bands = port.filter_signal(dsp.Signal(None, x, FS))
    want = ref._process_host_f64(x.copy())  # (T, 4, C)
    for i, band in enumerate(bands.bands):
        np.testing.assert_array_equal(band.time_data.numpy(), want[:, i, :])
    np.testing.assert_array_equal(port.state, ref.state)
    # and `process_sample`, sample by sample, from the same state
    y = [port.process_sample(v, 0) for v in x[:5, 0]]
    np.testing.assert_array_equal(
        np.array(y), np.array([ref.process_sample(v, 0) for v in x[:5, 0]]))


def test_svf_float32_mode_keeps_the_device_recursion(monkeypatch):
    _config.set_default_float("float32")
    monkeypatch.setattr(StateVariableFilter, "_process_host_f64",
                        lambda self, x: pytest.fail("host loop in float32 mode"))
    x = _x(2, 3000, seed=3).astype(np.float32)
    bands = StateVariableFilter(1500.0, 0.7, FS).filter_signal(dsp.Signal(None, x, FS))
    want = JaxSVF(1500.0, 0.7, FS)
    want.set_n_channels(2)
    want = want._process_host_f64(x.astype(np.float64))
    for i, band in enumerate(bands.bands):
        np.testing.assert_allclose(band.time_data.numpy(), want[:, i, :], rtol=1e-5, atol=1e-6)

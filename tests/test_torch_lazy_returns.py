"""The getters' lazy host returns in the port (`classes/lazy_array.py`),
held to the contracts of the JAX package's `tests/test_lazy_returns.py` and
`tests/test_aliasing_contracts.py::TestDeviceReturns`, on the CPU with
synthetic noise (the JAX tests read audio files the repository does not
have), and against the JAX package's getters on the same data; and the CSM
and spectrogram caches, which follow writes into the `time_data` view."""

import copy
import pickle

import numpy as np
import pytest
import torch

import dsptoolbox_tpu as jdsp
import dsptoolbox_tpu_torch as dsp
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch.classes import DeviceSpectralData
from dsptoolbox_tpu_torch.classes.lazy_array import LazyHostArray, materialize_all

torch.set_num_threads(1)

FS = 8000


@pytest.fixture(autouse=True)
def _cpu_float32_lazy_default():
    """The port on the CPU in float32 with the default lazy switch, restored
    after each test."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)
    _config.set_default_float("float32")
    _config.set_lazy_host_returns(None)


def _noise(channels: int, seconds: float = 0.5, seed: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((int(FS * seconds), channels))).astype(np.float32)


@pytest.fixture
def speech():
    s = dsp.Signal(None, _noise(1, 1.0, seed=1), FS)
    s.set_spectrogram_parameters(window_length_samples=256)
    return s


@pytest.fixture
def stereo():
    return dsp.Signal(None, _noise(2), FS)


def _eager(call):
    _config.set_lazy_host_returns(False)
    try:
        return call()
    finally:
        _config.set_lazy_host_returns(None)


class TestGetterWiring:
    def test_spectrum_lazy_and_matching(self, speech):
        f, sp = speech.get_spectrum(force_computation=True)
        assert isinstance(sp, LazyHostArray) and not sp.is_materialized
        f_e, sp_e = _eager(lambda: speech.get_spectrum(force_computation=True))
        assert isinstance(sp_e, np.ndarray)
        np.testing.assert_allclose(f, f_e)
        np.testing.assert_allclose(np.asarray(sp), sp_e, rtol=5e-4, atol=1e-5)

    def test_mono_welch_spectrum_is_1d(self, speech):
        _, sp = speech.get_spectrum(force_computation=True)
        assert sp.ndim == 1

    def test_csm_lazy_and_matching(self, stereo):
        f, C = stereo.get_csm(force_computation=True)
        assert isinstance(C, LazyHostArray)
        assert np.dtype(C.dtype).kind == "c"
        _, C_e = _eager(lambda: stereo.get_csm(force_computation=True))
        np.testing.assert_allclose(np.asarray(C), C_e, rtol=5e-4, atol=1e-6)

    def test_spectrogram_lazy_and_matching(self, speech):
        t, f, S = speech.get_spectrogram(force_computation=True)
        assert isinstance(S, LazyHostArray)
        t_e, f_e, S_e = _eager(lambda: speech.get_spectrogram(force_computation=True))
        np.testing.assert_allclose(t, t_e, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(f, f_e)
        np.testing.assert_allclose(np.asarray(S), S_e, rtol=5e-4, atol=1e-5)

    def test_f64_mode_returns_plain_numpy(self):
        assert _config.lazy_host_returns()
        _config.set_default_float("float64")
        assert not _config.lazy_host_returns()
        s = dsp.Signal(None, _noise(2).astype(np.float64), FS)
        for value in (s.get_spectrum()[1], s.get_csm()[1], s.get_spectrogram()[2]):
            assert type(value) is np.ndarray and value.dtype in (np.float64, np.complex128)

    def test_istft_consumes_without_materializing(self, speech):
        _, _, S = speech.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=speech)
        assert not S.is_materialized
        np.testing.assert_allclose(y.time_data[:, 0].numpy(), speech.time_data[:, 0].numpy(),
                                   atol=5e-4)

    def test_istft_uses_mutated_host_buffer(self, speech):
        _, _, S = speech.get_spectrogram(force_computation=True)
        S[...] = 0.0  # materializes and zeroes the host view
        y = dsp.transforms.istft(S, original_signal=speech)
        assert float(y.time_data.abs().max()) == 0.0

    def test_spectrum_takes_a_lazy_value_on_the_device(self, stereo):
        stereo.set_spectrum_parameters(method=dsp.SpectrumMethod.FFT)
        f, sp = stereo.get_spectrum()
        spec = dsp.Spectrum(f, sp)
        assert not sp.is_materialized and spec.spectral_data.is_complex()
        torch.testing.assert_close(spec.spectral_data, stereo.get_spectrum(return_device=True)[1])

    def test_pipeline_getters_return_tensors(self, stereo):
        def chain(s):
            return s.get_spectrum()[1], s.get_csm()[1], s.get_spectrogram()[2]

        for value in dsp.pipeline(chain)(stereo):
            assert torch.is_tensor(value)


class TestWrapperProtocols:
    @pytest.fixture
    def pair(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        return C, np.asarray(C).copy()

    def test_metadata_without_fetch(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        assert (C.shape, C.ndim, C.size, len(C)) == ((513, 2, 2), 3, 513 * 4, 513)
        assert C.dtype == np.complex64
        assert not C.is_materialized

    def test_ufuncs_and_operators(self, pair):
        C, ref = pair
        np.testing.assert_allclose(np.abs(C), np.abs(ref))
        np.testing.assert_allclose(C + 1, ref + 1)
        np.testing.assert_allclose(1 + C, 1 + ref)
        np.testing.assert_allclose(C * C, ref * ref)
        np.testing.assert_allclose(-C, -ref)
        np.testing.assert_allclose(C / 2.0, ref / 2.0)
        np.testing.assert_allclose(ref - C, 0 * ref)
        assert np.all(C == ref)

    def test_getattr_delegation(self, pair):
        C, ref = pair
        np.testing.assert_allclose(C.real, ref.real)
        np.testing.assert_allclose(C.conj(), ref.conj())
        np.testing.assert_allclose(C.sum(axis=0), ref.sum(axis=0))
        assert C.T.shape == ref.T.shape

    def test_indexing_and_iter(self, pair):
        C, ref = pair
        np.testing.assert_allclose(C[0], ref[0])
        np.testing.assert_allclose(C[:, 0, 1], ref[:, 0, 1])
        np.testing.assert_allclose(next(iter(C)), ref[0])

    def test_numpy_functions_coerce(self, pair):
        C, ref = pair
        np.testing.assert_allclose(np.concatenate([C, ref]), np.concatenate([ref, ref]))
        np.testing.assert_allclose(np.mean(C, axis=0), np.mean(ref, axis=0))

    def test_mutation_persists(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        arr = np.asarray(C)
        arr[0, 0, 0] = 42.0
        assert complex(C[0, 0, 0]) == 42.0
        # the library's consumers now read the host buffer
        assert complex(C.device_tensor()[0, 0, 0]) == 42.0
        assert float(C.device_real[0, 0, 0]) == 42.0

    def test_copies_are_independent(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        C2 = C.copy()
        assert isinstance(C2, LazyHostArray)
        np.asarray(C)[0, 0, 0] = 7.0
        assert complex(C2[0, 0, 0]) != 7.0

    def test_two_getter_calls_are_independent(self, stereo):
        _, C1 = stereo.get_csm()
        _, C2 = stereo.get_csm()
        np.asarray(C1)[0, 0, 0] = 9.0
        assert complex(C2[0, 0, 0]) != 9.0
        # and the signal's cached CSM is untouched
        assert complex(stereo._csm()[1][0, 0, 0]) != 9.0

    def test_deepcopy_and_pickle(self, pair):
        C, ref = pair
        C2 = copy.deepcopy(C)
        assert isinstance(C2, LazyHostArray)
        np.testing.assert_allclose(np.asarray(C2), ref)
        loaded = pickle.loads(pickle.dumps(C))
        assert type(loaded) is np.ndarray
        np.testing.assert_allclose(loaded, ref)

    def test_device_consumption_stays_on_device(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        dev = C.device_tensor()
        assert torch.is_tensor(dev) and dev.is_complex()
        assert dev is stereo._csm()[1]  # the cached tensor itself, no copy
        assert not C.is_materialized

    def test_device_spectral_data_compose(self, stereo):
        _, dsd = stereo.get_csm(force_computation=True, return_device=True)
        assert isinstance(dsd, DeviceSpectralData)
        assert dsd.shape == (513, 2, 2) and dsd.ndim == 3 and dsd.dtype == torch.complex64
        composed = dsd.complex_device()
        assert torch.is_tensor(composed)
        np.testing.assert_allclose(composed.numpy(), dsd.to_numpy(), rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(dsd), dsd.to_numpy())

    def test_materialize_all(self, stereo, speech):
        _, C = stereo.get_csm(force_computation=True)
        _, sp = speech.get_spectrum(force_computation=True)
        c_np, sp_np, other = materialize_all(C, sp, [1.0, 2.0])
        assert isinstance(c_np, np.ndarray) and isinstance(sp_np, np.ndarray)
        assert c_np is C.numpy() and sp_np is sp.numpy()
        np.testing.assert_array_equal(other, [1.0, 2.0])


class TestDeviceReturns:
    @pytest.fixture
    def noise(self):
        return dsp.Signal(None, _noise(2, 0.25, seed=4), FS)

    def test_get_spectrum_return_device(self, noise):
        f, sp = noise.get_spectrum(return_device=True)
        assert torch.is_tensor(sp) and not sp.is_complex()
        _, sp_host = noise.get_spectrum(force_computation=True)
        np.testing.assert_allclose(sp.numpy(), np.asarray(sp_host), rtol=1e-5, atol=1e-6)

    def test_get_csm_return_device(self, noise):
        f, C = noise.get_csm(return_device=True)
        assert isinstance(C, DeviceSpectralData)
        _, C_host = noise.get_csm(force_computation=True)
        np.testing.assert_allclose(C.to_numpy(), np.asarray(C_host), rtol=1e-4, atol=5e-7)

    def test_istft_accepts_device_spectrogram(self, noise):
        noise.set_spectrogram_parameters(window_length_samples=256)
        t, f, S = noise.get_spectrogram(force_computation=True, return_device=True)
        assert torch.is_tensor(S)
        y = dsp.transforms.istft(S, original_signal=noise)
        np.testing.assert_allclose(y.time_data.numpy(), noise.time_data.numpy(), rtol=0,
                                   atol=5e-5)


@pytest.mark.parametrize("getter", ["spectrum", "csm", "spectrogram"])
def test_lazy_getters_match_the_jax_package(getter):
    """The port's lazy values against the JAX package's lazy values on the
    same data, both read as numpy."""
    x = _noise(3, 0.5, seed=7)
    s, js = dsp.Signal(None, x, FS), jdsp.Signal(None, x, FS)
    s.set_spectrogram_parameters(window_length_samples=512)
    js.set_spectrogram_parameters(window_length_samples=512)
    got = getattr(s, f"get_{getter}")()
    want = getattr(js, f"get_{getter}")()
    assert isinstance(got[-1], LazyHostArray)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-9)
    g, w = np.asarray(got[-1]), np.asarray(want[-1])
    assert g.shape == w.shape
    scale = np.abs(w).max()
    assert np.abs(g - w).max() <= 2e-5 * scale


class TestCacheFollowsTheData:
    """Writing into the `time_data` view changes the data the caches were
    computed from: the next getter call computes them anew."""

    def test_csm_after_writing_into_time_data(self):
        s = dsp.Signal(None, _noise(3), FS)
        _, before = s.get_csm()
        s.time_data[: len(s) // 2] = 0
        _, after = s.get_csm()
        fresh = dsp.Signal(None, s.time_data.numpy(), FS)
        _, want = fresh.get_csm()
        assert not np.allclose(np.asarray(before), np.asarray(after))
        np.testing.assert_array_equal(np.asarray(after), np.asarray(want))

    def test_csm_cache_kept_while_the_data_is_unchanged(self):
        s = dsp.Signal(None, _noise(3), FS)
        c1 = s._csm()[1]
        assert s._csm()[1] is c1
        s.time_data.mul_(1.0)  # an in-place write, however harmless
        assert s._csm()[1] is not c1

    def test_spectrogram_after_writing_into_time_data(self):
        s = dsp.Signal(None, _noise(2), FS)
        _, _, before = s.get_spectrogram(return_device=True)
        s.time_data[:100] = 0
        _, _, after = s.get_spectrogram(return_device=True)
        assert after is not before
        fresh = dsp.Signal(None, s.time_data.numpy(), FS)
        torch.testing.assert_close(after, fresh.get_spectrogram(return_device=True)[2],
                                   rtol=0, atol=0)

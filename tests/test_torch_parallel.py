"""`dsptoolbox_tpu_torch.parallel` on meshes of 4 and 8 CPU shards (one
process issuing every shard's work, the CPU named once a shard) and on a
``("dp", "ch")`` mesh of shape (2, 4), against the port's single-device ops
and the JAX package's `parallel` on its 8-device virtual mesh, on the same
seeded numpy inputs, at the tolerances of `tests/test_parallel.py`. The
filter bank is held to scipy float64 and to the JAX package only on bands
where the JAX package's float32 bank itself meets scipy (ROADMAP C3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import dsptoolbox_tpu_torch as dsp
from dsptoolbox_tpu import parallel as jpar
from dsptoolbox_tpu.beamforming.beamforming import _das_map_core as jax_das_map_core
from dsptoolbox_tpu.standard.enums import SpectrumScaling as JScaling
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch import parallel as par
from dsptoolbox_tpu_torch.ops.cuda_das import das_map_plain
from dsptoolbox_tpu_torch.ops.iir import sosfilt
from dsptoolbox_tpu_torch.ops.iir_block import sosfilt_bank_apply, sosfilt_bank_operators
from dsptoolbox_tpu_torch.ops.spectral import csm_welch, stft, welch
from dsptoolbox_tpu_torch.room_acoustics.batch import batch_descriptors
from dsptoolbox_tpu_torch.standard.enums import SpectrumScaling

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def cpu_mesh(n: int) -> par.Mesh:
    devs = np.empty(n, dtype=object)
    devs[:] = [CPU] * n
    return par.Mesh(devs, ("dp",))


@pytest.fixture(params=[4, 8], ids=["4 shards", "8 shards"])
def mesh(request):
    return cpu_mesh(request.param)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "expected 8 virtual CPU devices"
    return jpar.device_mesh(8)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class TestMesh:
    def test_device_mesh_on_the_cpu(self):
        m = par.device_mesh()
        assert m.devices.size == 1 and m.axis_names == ("dp",)
        assert m.shape == {"dp": 1} and m.devices.flat[0] == CPU
        # one CPU device, as JAX has without forced host devices
        with pytest.raises(AssertionError):
            par.device_mesh(4)

    def test_mesh_shapes(self):
        m = cpu_mesh(8)
        assert m.devices.size == 8 and m.shape == {"dp": 8}
        m2 = par.Mesh(np.array([[CPU] * 4] * 2, dtype=object), ("dp", "ch"))
        assert m2.devices.shape == (2, 4) and m2.shape == {"dp": 2, "ch": 4}
        assert m2.shard_devices() == [CPU, CPU]
        with pytest.raises(AssertionError):
            par.device_mesh(1, axis_names=("dp", "ch"))
        with pytest.raises(AssertionError):
            par.Mesh([CPU, CPU], ("dp", "ch"))

    def test_shardings(self):
        m = cpu_mesh(4)
        s = par.shard_batch(m, ndim=3, axis=0)
        assert s.mesh is m and s.spec[0] == m.axis_names[0] and len(s.spec) == 3
        assert all(ax is None for ax in par.replicate(m).spec)
        m2 = par.Mesh(np.array([[CPU] * 4] * 2, dtype=object), ("dp", "ch"))
        assert par.shard_channels(m2, ndim=2, channel_axis=1).spec == (None, "ch")
        assert par.shard_channels(m, ndim=2).spec == ("dp", None)

    def test_exports_match_the_jax_package(self):
        assert set(par.__all__) == set(jpar.__all__)


def test_parallel_welch(mesh, jmesh):
    x = _x((16, 8192), 0)
    got = par.parallel_welch(torch.from_numpy(x), mesh, sampling_rate_hz=48000,
                             window_length_samples=1024)
    want = welch(torch.from_numpy(x), sampling_rate_hz=48000, window_length_samples=1024)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-9)
    jgot = jpar.parallel_welch(jnp.asarray(x), jmesh, sampling_rate_hz=48000,
                               window_length_samples=1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("scaling", ["PowerSpectralDensity", "AmplitudeSpectralDensity"])
def test_parallel_csm(mesh, jmesh, scaling):
    x = _x((8, 8192), 1) * 0.3
    kw = dict(sampling_rate_hz=48000, window_length_samples=1024)
    f_p, c_p = par.parallel_csm(torch.from_numpy(x), mesh, scaling=SpectrumScaling[scaling], **kw)
    f_s, c_s = csm_welch(torch.from_numpy(x), scaling=SpectrumScaling[scaling], **kw)
    np.testing.assert_allclose(f_p, f_s)
    assert c_p.shape == c_s.shape == (513, 8, 8)
    np.testing.assert_allclose(c_p.numpy(), c_s.numpy(), rtol=2e-3, atol=1e-8)
    _, c_j = jpar.parallel_csm(jnp.asarray(x), jmesh, scaling=JScaling[scaling], **kw)
    c_j = np.asarray(c_j)
    if scaling == "PowerSpectralDensity":
        np.testing.assert_allclose(c_p.numpy(), c_j, rtol=2e-3, atol=1e-8)
    else:
        # magnitudes and the real diagonal, as `test_parallel.py` compares
        # them: conj does not commute with the root on the branch cut
        il = np.tril_indices(8, -1)
        np.testing.assert_allclose(np.abs(c_p.numpy()[:, il[0], il[1]]),
                                   np.abs(c_j[:, il[0], il[1]]), rtol=5e-3, atol=1e-6)
        dg = np.arange(8)
        np.testing.assert_allclose(c_p.numpy()[:, dg, dg].real, c_j[:, dg, dg].real,
                                   rtol=5e-3, atol=1e-6)


def test_parallel_filterbank(mesh, jmesh):
    bank = np.stack([ss.butter(4, fc, btype="lowpass", fs=48000, output="sos")
                     for fc in [250, 500, 1000, 2000, 4000, 8000, 12000, 16000]])
    x = _x((4, 4096), 2)
    got = par.parallel_filterbank(bank, torch.from_numpy(x), mesh)
    assert got.shape == (8, 4, 4096) and not got.is_complex()
    jgot = np.asarray(jpar.parallel_filterbank(bank, jnp.asarray(x), jmesh))
    compared = 0
    for b in range(bank.shape[0]):
        want, _ = sosfilt(bank[b], torch.from_numpy(x))
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
        ref = ss.sosfilt(bank[b], x.astype(np.float64), axis=-1)
        scale = np.abs(ref).max()
        assert np.abs(got[b].numpy() - ref).max() <= 5e-6 * scale, b
        if np.abs(jgot[b] - ref).max() <= 5e-6 * scale:  # where the JAX bank is accurate
            np.testing.assert_allclose(got[b].numpy(), jgot[b], rtol=1e-4, atol=1e-5)
            compared += 1
    assert compared >= 4


def test_parallel_filterbank_keeps_imaginary_parts(mesh, jmesh):
    poles = 0.9 * np.exp(1j * np.linspace(0.2, 1.2, 8))
    bank = np.zeros((8, 2, 6), np.complex128)
    bank[:, :, 0] = 1.0
    bank[:, :, 3] = 1.0
    bank[:, :, 4] = -poles[:, None]
    x = _x((2, 256), 71)
    got = par.parallel_filterbank(bank, torch.from_numpy(x), mesh)
    assert got.is_complex() and float(got.imag.abs().sum()) > 0
    want = sosfilt_bank_apply(sosfilt_bank_operators(bank, 256), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=1e-5)
    jgot = np.asarray(jpar.parallel_filterbank(bank, jnp.asarray(x), jmesh))
    np.testing.assert_allclose(got.numpy(), jgot, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("reduce", [None, "sum", "mean"])
def test_sharded_map_reduce(mesh, jmesh, reduce):
    x = _x((32, 512), 3)
    got = par.sharded_map_reduce(lambda row: torch.sum(row**2), torch.from_numpy(x), mesh,
                                 reduce=reduce)
    jgot = np.asarray(jpar.sharded_map_reduce(lambda row: jnp.sum(row**2), jnp.asarray(x),
                                              jmesh, reduce=reduce))
    energy = (x.astype(np.float64) ** 2).sum(axis=1)
    want = {None: energy, "sum": energy.sum(), "mean": energy.mean()}[reduce]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-5)
    with pytest.raises(ValueError):
        par.sharded_map_reduce(lambda row: row.sum(), torch.from_numpy(x), mesh, reduce="max")


def test_sharded_map_reduce_keeps_shape(mesh):
    x = _x((16, 512), 4)
    got = par.sharded_map_reduce(lambda row: torch.max(torch.abs(row)), torch.from_numpy(x),
                                 mesh)
    np.testing.assert_allclose(got.numpy(), np.max(np.abs(x), axis=1), rtol=1e-6)


def test_parallel_fir_filter(mesh, jmesh):
    x = _x((3, 4096), 5)
    h = ss.firwin(129, 0.3)
    got = par.parallel_fir_filter(h, torch.from_numpy(x), mesh)
    want = ss.lfilter(h, [1.0], x, axis=-1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    jgot = np.asarray(jpar.parallel_fir_filter(h, jnp.asarray(x), jmesh))
    np.testing.assert_allclose(got.numpy(), jgot, atol=1e-5)


def test_parallel_fir_single_tap(mesh):
    x = _x((2, 64), 72)
    y = par.parallel_fir_filter(np.array([0.5]), x, mesh)
    np.testing.assert_allclose(y.numpy(), 0.5 * x, rtol=1e-6)


def test_multi_axis_mesh_uses_first_axis():
    mesh2 = par.Mesh(np.array([[CPU] * 4] * 2, dtype=object), ("dp", "ch"))
    jmesh2 = jpar.device_mesh(8, axis_names=("dp", "ch"), shape=(2, 4))
    x = _x((2, 128), 73)
    h = ss.firwin(9, 0.3)
    y = par.parallel_fir_filter(h, x, mesh2)
    np.testing.assert_allclose(y.numpy(), ss.lfilter(h, [1.0], x, axis=-1), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jpar.parallel_fir_filter(h, x, jmesh2)),
                               rtol=1e-4, atol=1e-6)
    # channels split over "dp" (2 shards), not over all 8 devices
    got = par.parallel_welch(_x((2, 4096), 74), mesh2, sampling_rate_hz=16000)
    assert got.shape == (2, 513)


def test_parallel_stft(mesh, jmesh):
    x = _x((2, 8 * 4096), 7)
    kw = dict(sampling_rate_hz=48000, window_length_samples=512, overlap_percent=50.0)
    t_p, f_p, S_p = par.parallel_stft(torch.from_numpy(x), mesh, **kw)
    t_s, f_s, S_s = stft(torch.from_numpy(x), padding=False, **kw)
    np.testing.assert_allclose(f_p, f_s)
    np.testing.assert_allclose(t_p, t_s)
    assert S_p.shape == S_s.shape
    np.testing.assert_allclose(S_p.numpy(), S_s.numpy(), rtol=1e-4, atol=1e-5)
    _, _, S_j = jpar.parallel_stft(jnp.asarray(x), jmesh, **kw)
    np.testing.assert_allclose(S_p.numpy(), np.asarray(S_j), rtol=1e-4, atol=1e-5)


def test_parallel_stft_physical_scaling(mesh, jmesh):
    x = _x((8 * 2048,), 8)
    kw = dict(sampling_rate_hz=16000, window_length_samples=256)
    _, _, S_p = par.parallel_stft(torch.from_numpy(x), mesh,
                                  scaling=SpectrumScaling.PowerSpectralDensity, **kw)
    _, _, S_s = stft(torch.from_numpy(x), padding=False,
                     scaling=SpectrumScaling.PowerSpectralDensity, **kw)
    np.testing.assert_allclose(S_p.numpy(), S_s.numpy(), rtol=1e-4, atol=1e-8)
    _, _, S_j = jpar.parallel_stft(jnp.asarray(x), jmesh,
                                   scaling=JScaling.PowerSpectralDensity, **kw)
    np.testing.assert_allclose(S_p.numpy(), np.asarray(S_j), rtol=1e-4, atol=1e-8)


def test_parallel_welch_time(mesh, jmesh):
    x = _x((3, 8 * 4096), 9)
    kw = dict(sampling_rate_hz=48000, window_length_samples=1024)
    got = par.parallel_welch_time(torch.from_numpy(x), mesh, **kw)
    want = welch(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-9)
    jgot = jpar.parallel_welch_time(jnp.asarray(x), jmesh, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4, atol=1e-9)


def test_parallel_das_map(mesh, jmesh):
    rng = np.random.default_rng(11)
    M, G, F = 8, 16, 5
    amp = rng.standard_normal((M, G)) ** 2 + 0.1
    diff = rng.standard_normal((M, G)) * 0.01
    k = np.linspace(30.0, 40.0, F)
    spectra = rng.standard_normal((F, M, 3)) + 1j * rng.standard_normal((F, M, 3))
    csm = np.einsum("fmk,fnk->fmn", spectra, np.conj(spectra))
    got = par.parallel_das_map(amp, diff, k, csm, mesh)
    f32 = [torch.as_tensor(a, dtype=torch.float32) for a in (amp, diff, k, csm.real, csm.imag)]
    want = das_map_plain(*f32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())  # point by point: the same sums
    jwant = np.asarray(jax_das_map_core(*[jnp.asarray(a, jnp.float32)
                                          for a in (amp, diff, k, csm.real, csm.imag)]))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=2e-5, atol=1e-4)
    jgot = np.asarray(jpar.parallel_das_map(amp, diff, k, csm, jmesh))
    np.testing.assert_allclose(got.numpy(), jgot, rtol=2e-5, atol=1e-4)


def test_parallel_batch_descriptors(mesh, jmesh):
    rng = np.random.default_rng(12)
    fs, B = 8000, 16
    T = fs // 4
    t = np.arange(T) / fs
    rirs = (rng.standard_normal((B, T)) * np.exp(-rng.uniform(4, 10, B)[:, None] * t)
            ).astype(np.float32)
    rirs[:, 0] = 1.0
    got = par.parallel_batch_descriptors(rirs, fs, mesh)
    want = batch_descriptors(torch.from_numpy(rirs), fs)
    jgot = jpar.parallel_batch_descriptors(rirs, fs, jmesh)
    assert set(got) == set(want) == set(jgot)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jgot[key]), rtol=1e-5,
                                   atol=1e-6)


class TestErrors:
    def test_parallel_stft_bad_shard_raises(self):
        x = torch.zeros(8 * 1000)  # 1000 is not a multiple of the hop of 256
        with pytest.raises(AssertionError):
            par.parallel_stft(x, cpu_mesh(8), sampling_rate_hz=48000, window_length_samples=512)

    @pytest.mark.parametrize("call", ["welch", "csm", "filterbank", "map_reduce", "fir", "das",
                                      "descriptors", "welch_time"])
    def test_shards_that_do_not_divide_raise(self, call):
        m = cpu_mesh(4)
        x = torch.zeros((6, 1002))
        calls = {
            "welch": lambda: par.parallel_welch(x, m, sampling_rate_hz=8000),
            "csm": lambda: par.parallel_csm(x, m, sampling_rate_hz=8000),
            "filterbank": lambda: par.parallel_filterbank(np.zeros((6, 1, 6)), x, m),
            "map_reduce": lambda: par.sharded_map_reduce(torch.sum, x, m),
            "fir": lambda: par.parallel_fir_filter(np.ones(3), x, m),
            "das": lambda: par.parallel_das_map(np.ones((2, 6)), np.zeros((2, 6)), np.ones(3),
                                                np.zeros((3, 2, 2), complex), m),
            "descriptors": lambda: par.parallel_batch_descriptors(x, 8000, m),
            "welch_time": lambda: par.parallel_welch_time(x, m, sampling_rate_hz=8000),
        }
        with pytest.raises(AssertionError):
            calls[call]()

    def test_fir_longer_than_a_shard_raises(self):
        with pytest.raises(AssertionError):
            par.parallel_fir_filter(np.ones(300), torch.zeros((1, 1024)), cpu_mesh(4))

    @pytest.mark.parametrize("setting", ["median", "fft"])
    def test_mesh_csm_takes_welch_mean_only(self, setting):
        s = dsp.Signal(None, _x((4000, 4), 13), 8000)
        if setting == "median":
            s.set_spectrum_parameters(average="median")
        else:
            s.set_spectrum_parameters(method=dsp.SpectrumMethod.FFT)
        with pytest.raises(AssertionError):
            s.get_csm(mesh=cpu_mesh(4))
        s.get_csm()  # the single-device path takes both

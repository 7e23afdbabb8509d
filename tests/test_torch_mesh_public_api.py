"""The ``mesh=`` keywords of the port's class layer on meshes of 4 and 8
CPU shards: `Signal.get_csm(mesh=)` (channels padded to the mesh),
`FilterBank.filter_signal(mesh=)` in Parallel and Summed mode (bands padded
with silent sections), the `LRFilterBank` hint, the DAS map's grid split
(`BeamformerDASFrequency.get_beamformer_map(mesh=)`, points padded) and
`pipeline(mesh=)`, each against the port without a mesh and the JAX
package's mesh path on its 8-device virtual mesh (`tests/test_mesh_public_api.py`),
on the same seeded data; a one-device mesh takes the single-device path."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import dsptoolbox_tpu as jdsp
import dsptoolbox_tpu_torch as dsp
from dsptoolbox_tpu import beamforming as jbf
from dsptoolbox_tpu.parallel import device_mesh as jax_device_mesh
from dsptoolbox_tpu.standard.enums import FilterBankMode as JFilterBankMode
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch import beamforming as bf
from dsptoolbox_tpu_torch.classes.lazy_array import LazyHostArray
from dsptoolbox_tpu_torch.parallel import Mesh, device_mesh
from dsptoolbox_tpu_torch.standard.enums import FilterBankMode

torch.set_num_threads(1)

FS = 16000
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def cpu_mesh(n: int) -> Mesh:
    devs = np.empty(n, dtype=object)
    devs[:] = [CPU] * n
    return Mesh(devs, ("dp",))


@pytest.fixture(params=[4, 8], ids=["4 shards", "8 shards"])
def mesh(request):
    return cpu_mesh(request.param)


@pytest.fixture(scope="module")
def jmesh():
    return jax_device_mesh(8)


def _data(channels=6, seconds=1.0, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((int(FS * seconds), channels)).astype(np.float32)


def _pair(channels=6, seed=0):
    x = _data(channels, seed=seed)
    s, js = dsp.Signal(None, x, FS), jdsp.Signal(None, x, FS)
    s.set_spectrum_parameters(window_length_samples=512)
    js.set_spectrum_parameters(window_length_samples=512)
    return s, js


class TestMeshSignalCSM:
    @pytest.mark.parametrize("channels", [6, 8], ids=["padded", "divisible"])
    def test_csm_matches_single_device_and_jax(self, mesh, jmesh, channels):
        s, js = _pair(channels)
        f0, c0 = s.get_csm(force_computation=True)
        f1, c1 = s.get_csm(force_computation=True, mesh=mesh)
        assert isinstance(c1, LazyHostArray)
        np.testing.assert_allclose(f1, f0)
        assert c1.shape == c0.shape == (257, channels, channels)
        np.testing.assert_allclose(np.asarray(c1), np.asarray(c0), rtol=5e-4, atol=1e-5)
        _, cj = js.get_csm(force_computation=True, mesh=jmesh)
        np.testing.assert_allclose(np.asarray(c1), np.asarray(cj), rtol=5e-4, atol=1e-5)

    def test_csm_mesh_output_hermitian(self):
        s, _ = _pair(4)
        _, c = s.get_csm(mesh=cpu_mesh(4))
        c = np.asarray(c)
        np.testing.assert_allclose(c, np.conj(np.swapaxes(c, -1, -2)), rtol=1e-5, atol=1e-8)

    def test_csm_mesh_bypasses_the_cache(self):
        s, _ = _pair(4)
        cached = s._csm()[1]
        s.get_csm(mesh=cpu_mesh(4))
        assert s._csm()[1] is cached

    def test_one_device_mesh_is_no_mesh(self):
        s, _ = _pair(6)
        _, c0 = s.get_csm()
        _, c1 = s.get_csm(mesh=device_mesh(1))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c0))


class TestMeshFilterBank:
    @pytest.mark.parametrize("mode", ["Parallel", "Summed"])
    def test_bank_matches_single_device_scipy_and_jax(self, mesh, jmesh, mode):
        s, js = _pair(2)
        rng = [125, 4000] if mode == "Parallel" else [250, 4000]
        fb = dsp.filterbanks.fractional_octave_bands(frequency_range_hz=rng,
                                                     sampling_rate_hz=FS)[0]
        jfb = jdsp.filterbanks.fractional_octave_bands(frequency_range_hz=rng,
                                                       sampling_rate_hz=FS)[0]
        n_bands = len(fb.filters)
        assert n_bands % mesh.devices.size  # the bank is padded with silent bands
        y0 = fb.filter_signal(s, FilterBankMode[mode])
        y1 = fb.filter_signal(s, FilterBankMode[mode], mesh=mesh)
        yj = jfb.filter_signal(js, JFilterBankMode[mode], mesh=jmesh)
        x64 = s.time_data.numpy().astype(np.float64)
        if mode == "Parallel":
            assert y1.number_of_bands == y0.number_of_bands == n_bands
            pairs = [(b1.time_data.numpy(), b0.time_data.numpy(), np.asarray(bj.time_data),
                      ss.sosfilt(f.sos, x64, axis=0))
                     for b1, b0, bj, f in zip(y1.bands, y0.bands, yj.bands, fb.filters)]
        else:
            ref = sum(ss.sosfilt(f.sos, x64, axis=0) for f in fb.filters)
            pairs = [(y1.time_data.numpy(), y0.time_data.numpy(), np.asarray(yj.time_data), ref)]
        for got, single, jax_out, ref in pairs:
            np.testing.assert_allclose(got, single, atol=5e-4)
            scale = np.abs(ref).max()
            assert np.abs(got - ref).max() <= 5e-6 * scale
            if np.abs(jax_out - ref).max() <= 5e-6 * scale:  # the JAX bank is accurate (C3)
                np.testing.assert_allclose(got, jax_out, atol=5e-4)

    def test_one_device_mesh_is_no_mesh(self):
        s, _ = _pair(2)
        fb = dsp.filterbanks.fractional_octave_bands(frequency_range_hz=[125, 4000],
                                                     sampling_rate_hz=FS)[0]
        y0 = fb.filter_signal(s, FilterBankMode.Parallel)
        y1 = fb.filter_signal(s, FilterBankMode.Parallel, mesh=device_mesh(1))
        for b0, b1 in zip(y0.bands, y1.bands):
            torch.testing.assert_close(b1.time_data, b0.time_data, rtol=0, atol=0)

    def test_hint_ignored_where_the_bank_cannot_shard(self, mesh):
        s, _ = _pair(2)
        fb = dsp.filterbanks.fractional_octave_bands(frequency_range_hz=[250, 2000],
                                                     sampling_rate_hz=FS)[0]
        y0 = fb.filter_signal(s, FilterBankMode.Parallel, zero_phase=True)
        y1 = fb.filter_signal(s, FilterBankMode.Parallel, zero_phase=True, mesh=mesh)
        for b0, b1 in zip(y0.bands, y1.bands):
            torch.testing.assert_close(b1.time_data, b0.time_data, rtol=0, atol=0)

    def test_lr_bank_accepts_mesh_hint(self, mesh):
        s, _ = _pair(2)
        fb = dsp.filterbanks.linkwitz_riley_crossovers([500.0, 2000.0], [4, 4],
                                                       sampling_rate_hz=FS)
        y0 = fb.filter_signal(s, FilterBankMode.Parallel)
        y1 = fb.filter_signal(s, FilterBankMode.Parallel, mesh=mesh)
        for b0, b1 in zip(y0.bands, y1.bands):
            torch.testing.assert_close(b1.time_data, b0.time_data, rtol=0, atol=0)


def _scene(seed=3, grid_n=5):
    """8 random microphones, a 5 × 5 grid (25 points: the mesh path pads
    it), noise from a monopole; the port's and the JAX package's
    beamformers on the same array signal."""
    rng = np.random.default_rng(seed)
    coords = {"x": rng.uniform(-0.15, 0.15, 8), "y": rng.uniform(-0.15, 0.15, 8),
              "z": np.zeros(8)}
    axis = np.linspace(-0.2, 0.2, grid_n)
    mics, jmics = bf.MicArray(dict(coords)), jbf.MicArray(dict(coords))
    grid = bf.Regular2DGrid(axis, axis, ["x", "y"], value3=0.5)
    jgrid = jbf.Regular2DGrid(axis, axis, ["x", "y"], value3=0.5)
    src = bf.MonopoleSource(dsp.generators.noise(0.3, FS, seed=5), [0.05, -0.05, 0.5])
    sig = src.get_signals_on_array(mics)
    jsig = jdsp.Signal(None, sig.time_data.numpy(), FS)
    das = bf.BeamformerDASFrequency(sig, mics, grid,
                                    bf.SteeringVector(formulation=bf.SteeringVectorType.TrueLocation))
    jdas = jbf.BeamformerDASFrequency(
        jsig, jmics, jgrid, jbf.SteeringVector(formulation=jbf.SteeringVectorType.TrueLocation))
    return das, jdas


class TestMeshBeamforming:
    @pytest.mark.parametrize("remove_diag", [True, False])
    def test_das_map_matches(self, mesh, jmesh, remove_diag):
        das, jdas = _scene()
        m0 = das.get_beamformer_map(1000, 3, remove_csm_diagonal=remove_diag)
        m1 = das.get_beamformer_map(1000, 3, remove_csm_diagonal=remove_diag, mesh=mesh)
        mj = np.asarray(jdas.get_beamformer_map(1000, 3, remove_csm_diagonal=remove_diag,
                                                mesh=jmesh))
        assert m1.shape == m0.shape == mj.shape == (5, 5)
        scale = float(m0.abs().max())
        np.testing.assert_allclose(m1.numpy() / scale, m0.numpy() / scale, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(m1.numpy() / scale, mj / scale, rtol=1e-4, atol=1e-5)

    def test_one_device_mesh_is_no_mesh(self):
        das, _ = _scene()
        torch.testing.assert_close(das.get_beamformer_map(1000, 3, mesh=device_mesh(1)),
                                   das.get_beamformer_map(1000, 3), rtol=0, atol=0)


def _chain(s):
    t, f, S = s.get_spectrogram(force_computation=True)
    y = dsp.transforms.istft(S, original_signal=s)
    f2, sp = s.get_spectrum(force_computation=True)
    f3, C = dsp.append_signals([s, y]).get_csm(force_computation=True)
    return y, sp, C


def _jchain(s):
    t, f, S = s.get_spectrogram(force_computation=True)
    y = jdsp.transforms.istft(S, original_signal=s)
    f2, sp = s.get_spectrum(force_computation=True)
    f3, C = jdsp.append_signals([s, y]).get_csm(force_computation=True)
    return y, sp, C


def test_pipeline_mesh_matches_pipeline_and_jax(mesh, jmesh):
    s, js = _pair(3)
    run = dsp.pipeline(_chain, mesh=mesh)
    y1, sp1, C1 = run(s)
    y0, sp0, C0 = dsp.pipeline(_chain)(s)
    yj, spj, Cj = jdsp.pipeline(_jchain, mesh=jmesh)(js)
    torch.testing.assert_close(y1.time_data, y0.time_data, rtol=0, atol=0)
    torch.testing.assert_close(sp1, sp0, rtol=0, atol=0)
    torch.testing.assert_close(C1, C0, rtol=0, atol=0)
    np.testing.assert_allclose(y1.time_data.numpy(), np.asarray(yj.time_data), atol=1e-5)
    for got, want in ((sp1, spj), (C1, Cj)):  # scale-relative: the DC bins are detrended noise
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()
    assert run.mesh is mesh


def test_pipeline_caches_per_mesh():
    """The captures are keyed on the mesh's first device, not the whole
    mesh: meshes that share it, and any ``partition``, share the key."""
    s, _ = _pair(3)
    a, b = dsp.pipeline(_chain, mesh=cpu_mesh(4)), dsp.pipeline(_chain, mesh=cpu_mesh(8))
    assert a._key([s]) == b._key([s])
    assert a._key([s])[0] == "cpu"
    assert dsp.pipeline(_chain, mesh=cpu_mesh(4), partition=("dp",))._key([s]) == a._key([s])
    assert dsp.pipeline(_chain)._key([s]) == a._key([s])


def test_chirp_deconvolve_csm_das():
    """The JAX package's end-to-end chain (`tests/test_mesh_public_api.py:154`):
    chirp → deconvolution → CSM → DAS through the public objects, a mesh at
    every step that takes one, each against the same step without it."""
    mesh = cpu_mesh(8)
    rng = np.random.default_rng(11)
    chirp = dsp.generators.chirp(FS, dsp.generators.ChirpType.Logarithmic, length_seconds=0.5)
    system = dsp.Filter.biquad(eq_type=dsp.BiquadEqType.Peaking, frequency_hz=900.0,
                               gain_db=-6.0, q=2.0, sampling_rate_hz=FS)
    rec = system.filter_signal(chirp)
    ir = dsp.transfer_functions.spectral_deconvolve(rec, chirp, padding=False,
                                                    keep_original_length=True)
    assert bool(torch.isfinite(ir.time_data).all())

    mics = bf.MicArray({"x": rng.uniform(-0.1, 0.1, 8), "y": rng.uniform(-0.1, 0.1, 8),
                        "z": np.zeros(8)})
    src = bf.MonopoleSource(dsp.generators.noise(0.3, FS, seed=6), [0.04, -0.03, 0.4])
    arr_sig = src.get_signals_on_array(mics)
    f, csm = arr_sig.get_csm(mesh=mesh)
    assert csm.shape[1:] == (8, 8)
    np.testing.assert_allclose(np.asarray(csm), np.asarray(arr_sig.get_csm()[1]),
                               rtol=5e-4, atol=1e-5)

    grid = bf.Regular2DGrid(np.linspace(-0.12, 0.12, 4), np.linspace(-0.12, 0.12, 4),
                            ["x", "y"], value3=0.4)
    st = bf.SteeringVector(formulation=bf.SteeringVectorType.TrueLocation)
    das = bf.BeamformerDASFrequency(arr_sig, mics, grid, st)
    m_mesh = das.get_beamformer_map(2000, 3, mesh=mesh)
    m_single = das.get_beamformer_map(2000, 3)
    scale = float(m_single.abs().max())
    np.testing.assert_allclose(m_mesh.numpy() / scale, m_single.numpy() / scale, rtol=1e-4,
                               atol=1e-5)
    # the peak lands on the grid point nearest the true source
    peak = int(torch.argmax(m_mesh.reshape(-1)))
    d = np.linalg.norm(grid.coordinates[:, :2] - np.array([0.04, -0.03]), axis=1)
    assert peak == int(np.argmin(d))

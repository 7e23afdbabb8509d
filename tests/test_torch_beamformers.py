"""The port's MVDR, CLEAN-SC, orthogonal, functional and time-domain DAS
beamformers (`dsptoolbox_tpu_torch.beamforming`) against the JAX package and
float64 numpy oracles on the CPU: the same seeded numpy inputs through both
packages. Each tolerance is the JAX package's own bound for that map
(`tests/test_beamforming.py`)."""

import numpy as np
import pytest
import torch
from scipy.integrate import simpson

from conftest import assert_close
from dsptoolbox_tpu import beamforming as jbf
from dsptoolbox_tpu.classes import Signal as JSignal
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch import beamforming as bf
from dsptoolbox_tpu_torch.beamforming import beamforming as bfm
from dsptoolbox_tpu_torch.classes import Signal
from dsptoolbox_tpu_torch.ops import cuda_das
from dsptoolbox_tpu_torch.standard.backend import fractional_delay_filter_batch

torch.set_num_threads(1)

FS = 16000
C_SOUND = 343


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's `Signal` puts numpy data on the default device, "cuda"
    out of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _planar(n, pitch):
    x = np.arange(n) * pitch
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return dict(x=xx.flatten(), y=yy.flatten(), z=np.zeros(xx.size))


def _scene(positions, lines, source, seconds, seed, noise_sigma=None):
    """A white-noise monopole (seeded numpy) recorded by an array, in both
    packages: the port's signal carries the JAX package's array signal, plus
    independent sensor noise of ``noise_sigma`` where given."""
    j_ma, t_ma = jbf.MicArray(positions), bf.MicArray(positions)
    j_g = jbf.Regular2DGrid(*lines, ["x", "y"], value3=0.5)
    t_g = bf.Regular2DGrid(*lines, ["x", "y"], value3=0.5)
    x = (0.3 * np.random.default_rng(seed).standard_normal(int(seconds * FS))).astype(np.float32)
    td = np.asarray(jbf.MonopoleSource(JSignal(None, x, FS), source)
                    .get_signals_on_array(j_ma).time_data)
    if noise_sigma is not None:
        td = (td + np.random.default_rng(3).normal(0.0, noise_sigma, td.shape)).astype(np.float32)
    return dict(j=(JSignal(None, td, FS), j_ma, j_g), t=(Signal(None, td, FS), t_ma, t_g),
                td=td)


@pytest.fixture(scope="module")
def small():
    """9 mics, 15 grid points, 0.2 s: the DAS tests' setting."""
    return _scene(_planar(3, 0.5), (np.arange(-0.2, 0.21, 0.2), np.arange(-0.4, 0.5, 0.2)),
                  [0.0, 0.4, 0.5], 0.2, 0)


@pytest.fixture(scope="module")
def square():
    """25 mics (5 × 5 at 0.25 m), 64 grid points, 1.5 s: the JAX package's
    MVDR tests' scene (`tests/test_beamforming.py:258-365`)."""
    lines = (np.arange(-0.2, 0.2, 0.05), np.arange(-0.2, 0.2, 0.05))
    return _scene(_planar(5, 0.25), lines, [0.1, -0.1, 0.5], 1.5, 11)


@pytest.fixture(scope="module")
def square_noisy():
    """The same scene plus independent sensor noise (σ = 1e-3): a CSM that
    the unloaded reference form can invert."""
    lines = (np.arange(-0.2, 0.2, 0.05), np.arange(-0.2, 0.2, 0.05))
    return _scene(_planar(5, 0.25), lines, [0.1, -0.1, 0.5], 1.5, 11, noise_sigma=1e-3)


def _pair(scene, name):
    st_j = jbf.SteeringVector(jbf.SteeringVectorType.TrueLocation)
    st_t = bf.SteeringVector(bf.SteeringVectorType.TrueLocation)
    return getattr(jbf, name)(*scene["j"], st_j), getattr(bf, name)(*scene["t"], st_t)


# ---------------------------------------------------------------- float64 oracles


def _band64(beam, center=2000, fraction=3):
    """The band's frequencies, CSM (the port's, in complex128) and float64
    steering ``h (F, M, G)``."""
    f, _, csm = beam._band_csm(center, fraction)
    h = beam.st_vec.get_vector(f * 2 * np.pi / beam.c, beam.grid, beam.mics)
    return f, csm.numpy().astype(np.complex128), h


def _quad64(h, C):
    """``Re(h^H C_f h)`` in float64, ``(G, F)``."""
    return np.einsum("fmg,fmg->gf", np.conj(h), C @ h).real


def _integrate(map_gf, f):
    return simpson(map_gf, dx=f[1] - f[0], axis=1) if len(f) > 1 else map_gf[:, 0]


def _das64(C, h, n):
    off = 1 - np.eye(n)
    m = _quad64(h, C * (n / (n - 1) * off))
    return np.maximum(m, 0.0)


def _mvdr_loaded64(C, h, gamma=10.0):
    d = np.einsum("fii->fi", C).real
    loaded = C + 10.0 ** (-gamma / 10.0) * (d[:, :, None] * np.eye(C.shape[-1])[None])
    return 1 / np.einsum("fmg,fmg->gf", np.conj(h), np.linalg.solve(loaded, h)).real


def _functional64(C, h, gamma=10.0):
    u, s, vh = np.linalg.svd(C)
    num = _quad64(h, (u * s[:, None, :] ** (1 / gamma)) @ vh)
    norm = np.sum(np.abs(h) ** 2, axis=1).T
    return (num / norm) ** gamma * norm


def _orthogonal64(h, v, w):
    """Float64 transcription of the reference's loop: each eigenvector's map
    ``|h^H v|^2``, its argmax, the eigenvalue times the maximum written there,
    eigenvalue by eigenvalue (the last write wins)."""
    F, _, G = h.shape
    prod = np.abs(np.einsum("fmg,fme->fge", np.conj(h), v)) ** 2
    out = np.zeros((G, F))
    for fi in range(F):
        for e in range(v.shape[-1]):
            i = int(np.argmax(prod[fi, :, e]))
            out[i, fi] = prod[fi, i, e] * w[fi, e]
    return out


def _eigenpairs(C, E):
    w, v = np.linalg.eigh(C)
    return v[:, :, ::-1][:, :, :E], w[:, ::-1][:, :E]


def _clean_sc64(C, h, iterations, remove_diagonal):
    if remove_diagonal:
        C = C * (1 - np.eye(C.shape[-1]))
    map0 = _quad64(h, C)
    hH = np.swapaxes(h, 1, 2).conj()
    return np.stack([
        bfm.clean_sc_deconvolve(map0[:, fi].copy(), C[fi], h[fi], hH[fi], iterations,
                                remove_diagonal, 0.5)
        for fi in range(C.shape[0])], axis=1)


def _das_time64(td, ma, grid):
    """Time-domain DAS in float64 by direct convolution: each (point, mic)
    pair's Kaiser-sinc FIR applied with `np.convolve`, shifted by its integer
    delay, weighted by the distance over the mic count, summed over mics."""
    ds = ma.get_distances_to_point(grid.coordinates)  # (M, G)
    M, G = ds.shape
    r0 = ds.max()
    T = td.shape[0]
    total = T + int((r0 - ds.min()) / C_SOUND * FS + 2)
    s, h = fractional_delay_filter_batch(((r0 - ds) / C_SOUND * FS).ravel(), 30, 60)
    s, h = s.reshape(M, G), h.reshape(M, G, -1)
    out = np.zeros((total, G))
    for g in range(G):
        for m in range(M):
            c = np.convolve(td[:, m].astype(np.float64), h[m, g])
            lo = max(0, s[m, g])
            hi = min(total, s[m, g] + len(c))
            out[lo:hi, g] += ds[m, g] / M * c[lo - s[m, g]:hi - s[m, g]]
    return out


# ---------------------------------------------------------------- dispatch


def test_quadratic_map_dispatch(monkeypatch):
    """`_quadratic_map` is B5's plain version on a CPU tensor (no launch),
    asks for the DAS kernel, and takes the plain version for complex128."""
    rng = np.random.default_rng(1)
    M, G, F = 6, 11, 3
    amp = torch.from_numpy(rng.uniform(0.5, 1.0, (M, G)).astype(np.float32))
    diff = torch.from_numpy((rng.standard_normal((M, G)) * 0.1).astype(np.float32))
    k = torch.linspace(10.0, 60.0, F)
    C = torch.from_numpy((rng.standard_normal((F, M, M))
                          + 1j * rng.standard_normal((F, M, M))).astype(np.complex64))
    cuda_das.launches = 0
    got = bfm._quadratic_map(amp, diff, k, C)
    assert torch.equal(got, cuda_das.das_map_plain(amp, diff, k, C.real, C.imag))
    h = amp.double().numpy()[None] * np.exp(
        -1j * k.double().numpy()[:, None, None] * diff.double().numpy()[None])
    want = _quad64(h, C.numpy().astype(np.complex128))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * np.abs(want).max())
    assert bfm._quadratic_map(amp.double(), diff.double(), k.double(),
                              C.to(torch.complex128)).dtype == torch.float64
    asked = []
    monkeypatch.setattr(_config, "use_kernel", lambda name, x: asked.append(name) or False)
    assert torch.equal(bfm._quadratic_map(amp, diff, k, C), got)
    assert asked == ["das"]
    assert cuda_das.launches == 0


# ---------------------------------------------------------------- MVDR


def test_mvdr_loaded_matches_jax_and_float64(square):
    """The default loaded solve against the JAX map and a float64 numpy
    solve of the same loaded system: 1e-4 scale-relative, the same argmax."""
    jb, tb = _pair(square, "BeamformerMVDR")
    got = tb.get_beamformer_map(2000, 3, gamma=10)
    assert got.shape == (8, 8) and torch.equal(tb.map, got)
    assert_close(got.numpy(), np.asarray(jb.get_beamformer_map(2000, 3, gamma=10)),
                 tol=1e-4, name="MVDR vs JAX")
    f, C, h = _band64(tb)
    want = tb.grid.reconstruct_map_shape(_integrate(_mvdr_loaded64(C, h), f))
    assert_close(got.numpy(), want, tol=1e-4, name="MVDR vs float64")
    assert int(torch.argmax(got)) == int(np.argmax(want))


def test_mvdr_reference_form_matches_float64_with_sensor_noise(square_noisy):
    """``solve_on_device=False``: the host float64 inverse, the quadratic form
    through `_quadratic_map` in float32. Projections onto near-null
    eigenvectors cancel in float32: 5e-3 of the map's maximum, the same
    argmax (`tests/test_beamforming.py:365`)."""
    jb, tb = _pair(square_noisy, "BeamformerMVDR")
    got = tb.get_beamformer_map(2000, 3, solve_on_device=False)
    f, C, h = _band64(tb)
    want = tb.grid.reconstruct_map_shape(
        _integrate(1 / _quad64(h, np.linalg.inv(C)), f))
    assert_close(got.numpy(), want, tol=5e-3, name="MVDR reference form vs float64")
    assert int(torch.argmax(got)) == int(np.argmax(want))
    ref = np.asarray(jb.get_beamformer_map(2000, 3, solve_on_device=False))
    assert int(torch.argmax(got)) == int(np.argmax(ref))


def test_mvdr_stays_finite_on_a_singular_csm(small):
    """The loaded path on the coherent scene's raw CSM (rank-deficient), and
    on a CSM with a silent mic, whose zero auto-power the two-step scaling
    keeps finite."""
    _, tb = _pair(small, "BeamformerMVDR")
    assert bool(torch.isfinite(tb.get_beamformer_map(2000, 3)).all())
    td = small["td"].copy()
    td[:, 4] = 0.0
    sig, ma, g = small["t"]
    silent = bf.BeamformerMVDR(Signal(None, td, FS), ma, g, bf.SteeringVector())
    assert bool(torch.isfinite(silent.get_beamformer_map(2000, 3)).all())


# ---------------------------------------------------------------- Functional


@pytest.mark.parametrize("gamma", [10, 3])
def test_functional_matches_jax_and_float64(square, gamma):
    jb, tb = _pair(square, "BeamformerFunctional")
    cuda_das.launches = 0
    got = tb.get_beamformer_map(2000, 3, gamma=gamma)
    assert cuda_das.launches == 0
    assert_close(got.numpy(), np.asarray(jb.get_beamformer_map(2000, 3, gamma=gamma)),
                 tol=5e-3, name="Functional vs JAX")
    f, C, h = _band64(tb)
    want = tb.grid.reconstruct_map_shape(_integrate(_functional64(C, h, gamma), f))
    assert_close(got.numpy(), want, tol=5e-3, name="Functional vs float64")
    assert int(torch.argmax(got)) == int(np.argmax(want))


# ---------------------------------------------------------------- CLEAN-SC


@pytest.mark.parametrize("remove_diag", [False, True])
def test_clean_sc_matches_jax(small, remove_diag):
    jb, tb = _pair(small, "BeamformerCleanSC")
    kw = dict(maximum_iterations=10, safety_factor=0.5, remove_csm_diagonal=remove_diag)
    got = tb.get_beamformer_map(2000, 3, **kw)
    assert got.shape == (3, 5)
    assert_close(got.numpy(), np.asarray(jb.get_beamformer_map(2000, 3, **kw)), tol=5e-3,
                 name="CLEAN-SC vs JAX")
    # the default: twice the channels, no diagonal removal
    assert_close(tb.get_beamformer_map(2000, 3).numpy(),
                 np.asarray(jb.get_beamformer_map(2000, 3)), tol=5e-3, name="default")


@pytest.mark.parametrize("iterations", [10, None])
@pytest.mark.parametrize("remove_diag", [False, True])
def test_clean_sc_device_loop_matches_host_oracle(square, remove_diag, iterations):
    """The batched device loop against the host per-bin loop
    (`set_clean_sc_on_device(False)`): rtol 1e-3, atol 1e-5 of the maximum
    (`tests/test_beamforming.py:193-198`); and per bin against the float64
    oracle."""
    _, tb = _pair(square, "BeamformerCleanSC")
    kw = dict(maximum_iterations=iterations, safety_factor=0.5,
              remove_csm_diagonal=remove_diag)
    assert _config.clean_sc_on_device()
    m_dev = tb.get_beamformer_map(2000, 3, **kw).numpy()
    f, bins_dev = tb._bin_maps(2000, 3, **kw)
    _config.set_clean_sc_on_device(False)
    try:
        assert not _config.clean_sc_on_device()
        m_host = tb.get_beamformer_map(2000, 3, **kw).numpy()
    finally:
        _config.set_clean_sc_on_device(True)
    np.testing.assert_allclose(m_dev, m_host, rtol=1e-3, atol=1e-5 * np.abs(m_host).max())
    _, C, h = _band64(tb)
    want = _clean_sc64(C, h, iterations or 50, remove_diag)
    np.testing.assert_allclose(bins_dev.numpy(), want, rtol=1e-3,
                               atol=1e-5 * np.abs(want).max())


def test_clean_sc_core_keeps_a_stopped_bin_still():
    """A bin whose CSM is zero stops at once (its norms are equal): it
    deposits its first peak and nothing after, while a live bin goes on."""
    rng = np.random.default_rng(4)
    M, G = 4, 9
    h = torch.from_numpy((rng.standard_normal((2, M, G))
                          + 1j * rng.standard_normal((2, M, G))).astype(np.complex64))
    v = rng.standard_normal(M) + 1j * rng.standard_normal(M)
    C = np.zeros((2, M, M), np.complex64)
    C[1] = np.outer(v, v.conj())
    C = torch.from_numpy(C)
    map0 = torch.from_numpy(rng.uniform(0.1, 1.0, (G, 2)).astype(np.float32))
    out = bfm._clean_sc_device_core(map0, C, h, 6, False, 0.5)
    first = int(torch.argmax(map0[:, 0]))
    assert torch.count_nonzero(out[:, 0]) == 1
    assert float(out[first, 0]) == pytest.approx(0.5 * float(map0[first, 0]))
    hH = np.swapaxes(h.numpy(), 1, 2).conj()
    want = bfm.clean_sc_deconvolve(map0[:, 1].double().numpy(), C[1].numpy(), h[1].numpy(),
                                   hH[1], 6, False, 0.5)
    np.testing.assert_allclose(out[:, 1].numpy(), want, rtol=1e-3,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- Orthogonal


def test_orthogonal_first_eigenvalue_matches_jax(small):
    """Only the dominant eigenvalue is comparable with the JAX package (the
    noise subspace's argmaxes are decided by float32 noise in the CSM): the
    same argmax and maximum within rtol 1e-3 (`tests/test_beamforming.py:
    225-227`); the default number of eigenvalues runs."""
    jb, tb = _pair(small, "BeamformerOrthogonal")
    got = tb.get_beamformer_map(2000, 3, number_eigenvalues=1).numpy()
    want = np.asarray(jb.get_beamformer_map(2000, 3, number_eigenvalues=1))
    assert np.argmax(got) == np.argmax(want)
    np.testing.assert_allclose(got.max(), want.max(), rtol=1e-3)
    full = tb.get_beamformer_map(2000, 0)
    assert full.shape == (3, 5) and bool(torch.isfinite(full).all())


def test_orthogonal_map_matches_float64_transcription(small):
    """The default number of eigenvalues (half the channels) against the
    reference's loop in float64, fed the same eigenpairs: 1e-5."""
    _, tb = _pair(small, "BeamformerOrthogonal")
    got = tb.get_beamformer_map(2000, 3)
    f, C, h = _band64(tb)
    want = _integrate(_orthogonal64(h, *_eigenpairs(C, 9 // 2)), f)
    assert_close(got.numpy().ravel(), want, tol=1e-5, name="orthogonal vs float64")


def test_orthogonal_scatter_last_write_wins():
    """Eigenvectors that pick the same grid point: the map keeps the last
    (smallest) one's value there, as the reference's overwrite does; the
    picks and values against the float64 transcription at 1e-5."""
    rng = np.random.default_rng(8)
    F, M, G, E = 3, 6, 20, 5
    h = rng.standard_normal((F, M, G)) + 1j * rng.standard_normal((F, M, G))
    v = rng.standard_normal((F, M, E)) + 1j * rng.standard_normal((F, M, E))
    v[:, :, 3] = 0.5 * v[:, :, 1]  # eigenvalues 1 and 3 pick one point
    w = np.sort(rng.uniform(1.0, 5.0, (F, E)))[:, ::-1].copy()
    idx, vals = bfm._orthogonal_picks(*(torch.from_numpy(a) for a in (h, v, w)))
    got = bfm._orthogonal_scatter(idx, vals, G).numpy()
    assert torch.equal(idx[:, 1], idx[:, 3])
    want = _orthogonal64(h, v, w)
    rows = idx[:, 3].numpy()
    np.testing.assert_allclose(got[rows, np.arange(F)], vals[:, 3].numpy(), rtol=1e-12)
    assert_close(got, want, tol=1e-5, name="orthogonal scatter")


# ---------------------------------------------------------------- DAS time


def _time_pair(small, lines):
    (j_sig, j_ma, _), (t_sig, t_ma, _) = small["j"], small["t"]
    return (jbf.BeamformerDASTime(j_sig, j_ma, jbf.LineGrid(lines, "y", 0.5, 0)),
            bf.BeamformerDASTime(t_sig, t_ma, bf.LineGrid(lines, "y", 0.5, 0)))


def test_das_time_matches_jax_and_float64(small):
    jb, tb = _time_pair(small, np.arange(-0.5, 0.5, 0.1))
    out = tb.get_beamformer_output()
    want = np.asarray(jb.get_beamformer_output().time_data)
    assert out.time_data.shape == want.shape and out.sampling_rate_hz == FS
    assert_close(out.time_data.numpy(), want, tol=1e-4, name="DAS time vs JAX")
    ref = _das_time64(small["td"], tb.mics, tb.grid)
    assert_close(out.time_data.numpy(), ref, tol=1e-4, name="DAS time vs float64")


def test_das_time_chunked_equals_single_chunk(small, monkeypatch):
    """Many grid chunks (a budget of one byte: one point each) against one
    chunk: rtol 1e-5, atol 1e-6 (`tests/test_beamforming.py:400`); the
    designed chunks are cached per geometry."""
    _, tb = _time_pair(small, np.arange(-0.5, 0.5, 0.15))
    full = tb.get_beamformer_output().time_data
    assert len(tb._das_time_cache[2]) == 1
    monkeypatch.setattr(bfm, "_DAS_TIME_CHUNK_BYTES", 1.0)
    tb._das_time_cache = None
    chunked = tb.get_beamformer_output().time_data
    cached = tb._das_time_cache
    assert len(cached[2]) == tb.grid.number_of_points
    assert torch.equal(tb.get_beamformer_output().time_data, chunked)
    assert tb._das_time_cache is cached
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- argmax


@pytest.mark.parametrize(
    "name", ["das", "mvdr", "mvdr_reference", "functional", "clean_sc", "orthogonal",
             "das_time"])
def test_every_map_peaks_where_the_float64_oracle_peaks(square, square_noisy, name):
    """On the seeded monopole, each map's argmax is the float64 oracle's."""
    cls = {"das": "BeamformerDASFrequency", "mvdr": "BeamformerMVDR",
           "mvdr_reference": "BeamformerMVDR", "functional": "BeamformerFunctional",
           "clean_sc": "BeamformerCleanSC", "orthogonal": "BeamformerOrthogonal"}
    if name == "das_time":
        (sig, ma, g) = square["t"]
        line = bf.LineGrid(np.arange(-0.3, 0.3, 0.1), "x", -0.1, 0.5)
        out = bf.BeamformerDASTime(sig, ma, line).get_beamformer_output().time_data
        ref = _das_time64(square["td"], ma, line)
        assert int(torch.argmax((out.double() ** 2).sum(0))) == int(np.argmax((ref ** 2).sum(0)))
        return
    scene = square_noisy if name == "mvdr_reference" else square
    _, tb = _pair(scene, cls[name])
    kw = {"mvdr_reference": {"solve_on_device": False}}.get(name, {})
    got = tb.get_beamformer_map(2000, 3, **kw)
    f, C, h = _band64(tb)
    n = C.shape[-1]
    oracle = {
        "das": lambda: _das64(C, h, n),
        "mvdr": lambda: _mvdr_loaded64(C, h),
        "mvdr_reference": lambda: 1 / _quad64(h, np.linalg.inv(C)),
        "functional": lambda: _functional64(C, h),
        "clean_sc": lambda: _clean_sc64(C, h, 2 * n, False),
        "orthogonal": lambda: _orthogonal64(h, *_eigenpairs(C, n // 2)),
    }[name]()
    want = _integrate(oracle, f)
    assert int(torch.argmax(got)) == int(np.argmax(want))


def test_jax_state_carried_into_the_new_maps(square):
    """The JAX package's Welch CSM, carried into the port's signal cache,
    gives the JAX package's MVDR map (1e-4) and CLEAN-SC map (5e-3)."""
    (j_sig, _, _), (t_sig, t_ma, t_g) = square["j"], square["t"]
    f, csm_j = j_sig.get_csm()
    fresh = Signal(None, square["td"], FS)
    key = fresh._spectrum_param_key()
    fresh._cache["csm"] = (key, np.asarray(f), torch.from_numpy(np.asarray(csm_j)))
    for name, tol in (("BeamformerMVDR", 1e-4), ("BeamformerCleanSC", 5e-3)):
        jb = getattr(jbf, name)(*square["j"], jbf.SteeringVector())
        tb = getattr(bf, name)(fresh, t_ma, t_g, bf.SteeringVector())
        assert_close(tb.get_beamformer_map(2000, 3).numpy(),
                     np.asarray(jb.get_beamformer_map(2000, 3)), tol=tol, name=name)

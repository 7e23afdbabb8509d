"""Port beamforming path (`dsptoolbox_tpu_torch.beamforming`, thin `Signal`,
`ops.cuda_das`) against the JAX package on the CPU: the same seeded numpy
inputs through both. The JAX package's Pallas DAS kernel runs in interpret
mode."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import assert_close
from dsptoolbox_tpu import _config as jconfig
from dsptoolbox_tpu import beamforming as jbf
from dsptoolbox_tpu.beamforming import beamforming as jbfm
from dsptoolbox_tpu.classes import Signal as JSignal
from dsptoolbox_tpu.ops import spectral as jspec
from dsptoolbox_tpu.ops.pallas_das import das_map_fused
from dsptoolbox_tpu.standard import backend as jbackend
from dsptoolbox_tpu.standard.enums import SpectrumScaling as JScaling
from dsptoolbox_tpu.standard.enums import Window as JWindow
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch import beamforming as bf
from dsptoolbox_tpu_torch.beamforming import beamforming as bfm
from dsptoolbox_tpu_torch.classes import Signal
from dsptoolbox_tpu_torch.ops import cuda_das
from dsptoolbox_tpu_torch.standard import backend
from dsptoolbox_tpu_torch.standard.enums import SpectrumMethod, SpectrumScaling, Window

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's `Signal` puts numpy data on the default device, "cuda"
    out of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)

FS = 16000
FORMULATIONS = ["Classic", "Inverse", "TruePower", "TrueLocation"]


def _mic_positions(n=3, pitch=0.5):
    """An n × n planar array at z = 0."""
    x = np.arange(n) * pitch
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return dict(x=xx.flatten(), y=yy.flatten(), z=np.zeros(xx.size))


def _grid_lines():
    return np.arange(-0.2, 0.21, 0.2), np.arange(-0.4, 0.5, 0.2)


def _noise(seconds, seed, channels=None):
    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    shape = (n,) if channels is None else (n, channels)
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def setting():
    """Array, grid and a monopole source's array signal, in both packages;
    the port's signal carries the JAX package's array signal."""
    pos = _mic_positions()
    l1, l2 = _grid_lines()
    j_ma, t_ma = jbf.MicArray(pos), bf.MicArray(pos)
    j_g = jbf.Regular2DGrid(l1, l2, ["x", "y"], value3=0.5)
    t_g = bf.Regular2DGrid(l1, l2, ["x", "y"], value3=0.5)
    src = [0.0, 0.4, 0.5]
    j_sig = jbf.MonopoleSource(JSignal(None, _noise(0.2, 0), FS), src).get_signals_on_array(j_ma)
    td = np.asarray(j_sig.time_data)
    t_sig = Signal(None, td, FS)
    return dict(j_ma=j_ma, t_ma=t_ma, j_g=j_g, t_g=t_g, j_sig=j_sig,
                t_sig=t_sig, src=src, lines=(l1, l2))


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("kind", ["2d", "3d", "line"])
def test_grids_and_array_match_jax(kind):
    l1, l2 = _grid_lines()
    make = {
        "2d": lambda m: m.Regular2DGrid(l1, l2, ["x", "z"], value3=0.7),
        "3d": lambda m: m.Regular3DGrid(l1, l2, np.array([0.3, 0.6])),
        "line": lambda m: m.LineGrid(l2, "y", 0.1, 0.5),
    }[kind]
    jg, tg = make(jbf), make(bf)
    np.testing.assert_array_equal(tg.coordinates, jg.coordinates)
    assert tg.dim == jg.dim and tg.ndim == jg.ndim
    v = np.arange(tg.number_of_points, dtype=float)
    np.testing.assert_array_equal(
        tg.reconstruct_map_shape(v), jg.reconstruct_map_shape(v)
    )
    pos = _mic_positions(4, 0.1)
    jm, tm = jbf.MicArray(pos), bf.MicArray(pos)
    assert tm.aperture == jm.aperture and tm.min_distance == jm.min_distance
    np.testing.assert_array_equal(tm.array_center_coordinates, jm.array_center_coordinates)
    assert tm.get_maximum_frequency_range() == jm.get_maximum_frequency_range()
    assert tg.find_nearest_point([0.1, 0.1, 0.5])[0] == jg.find_nearest_point([0.1, 0.1, 0.5])[0]


def test_mic_array_from_xml(tmp_path):
    pos = _mic_positions(2, 0.25)
    lines = "".join(
        f'<pos Name="P{i}" x="{x}" y="{y}" z="{z}"/>'
        for i, (x, y, z) in enumerate(zip(pos["x"], pos["y"], pos["z"]))
    )
    path = tmp_path / "array.xml"
    path.write_text(f'<?xml version="1.0"?><MicArray name="a">{lines}</MicArray>')
    tm, jm = bf.MicArray.from_xml(str(path)), jbf.MicArray.from_xml(str(path))
    np.testing.assert_array_equal(tm.coordinates, jm.coordinates)
    assert tm.number_of_points == 4


@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_steering_amp_diff_matches_jax(formulation, setting):
    """Host float64 steering factors and full vectors: exact."""
    j_amp, j_diff = jbfm._steering_amp_diff(
        jbf.SteeringVectorType[formulation], setting["j_g"], setting["j_ma"]
    )
    t_st = bf.SteeringVector(bf.SteeringVectorType[formulation])
    t_amp, t_diff = t_st.get_amp_diff(setting["t_g"], setting["t_ma"])
    np.testing.assert_allclose(t_amp, j_amp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_diff, j_diff, rtol=0, atol=1e-12)
    k = np.linspace(10.0, 300.0, 7)
    j_h = jbf.SteeringVector(jbf.SteeringVectorType[formulation]).get_vector(
        k, setting["j_g"], setting["j_ma"]
    )
    np.testing.assert_allclose(
        t_st.get_vector(k, setting["t_g"], setting["t_ma"]), j_h, rtol=0, atol=1e-12
    )


def test_fractional_delay_design_matches_jax():
    d = np.array([0.0, 3.25, 17.5, 40.9])
    for order in (30, 31):
        s_t, h_t = backend.fractional_delay_filter_batch(d, order, 60)
        s_j, h_j = jbackend.fractional_delay_filter_batch(d, order, 60)
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(h_t, h_j)
        s1, h1 = backend.fractional_delay_filter(17.5, order, 60)
        assert s1 == s_t[2]
        np.testing.assert_allclose(h1, h_t[2], rtol=0, atol=1e-12)


# ---------------------------------------------------------------- DAS core

# the (M, G, F) cases of tests/test_pallas_das.py, the 64-mic ones at
# G <= 128
DAS_CASES = [(64, 100, 37), (9, 20, 13), (25, 130, 5), (64, 128, 16)]


def _das_inputs(M, G, F):
    rng = np.random.default_rng(0)
    amp = rng.uniform(0.5, 1.0, (M, G)).astype(np.float32)
    diff = (rng.standard_normal((M, G)) * 0.01).astype(np.float32)
    k = np.linspace(10.0, 400.0, F).astype(np.float32)
    cre = rng.standard_normal((F, M, M)).astype(np.float32)
    cim = rng.standard_normal((F, M, M)).astype(np.float32)
    return amp, diff, k, cre, cim


@pytest.mark.parametrize("M,G,F", DAS_CASES)
@pytest.mark.parametrize("reference", ["core", "pallas", "pallas_uniform"])
def test_das_map_plain_matches_jax(M, G, F, reference):
    args = _das_inputs(M, G, F)
    got = cuda_das.das_map(*(torch.from_numpy(a) for a in args))
    jargs = [jnp.asarray(a) for a in args]
    if reference == "core":
        want = jbfm._das_map_core(*jargs)
    else:
        want = das_map_fused(*jargs, interpret=True,
                             uniform_grid=reference == "pallas_uniform")
    assert got.shape == (G, F)
    assert_close(got.numpy(), np.asarray(want), tol=5e-5, name="das map")


def test_packed_quadratic_gf_matches_complex_form():
    rng = np.random.default_rng(5)
    F, M, G = 3, 6, 11
    h = rng.standard_normal((F, M, G)) + 1j * rng.standard_normal((F, M, G))
    C = rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M))
    want = np.real(np.einsum("fmg,fmn,fng->gf", np.conj(h), C, h))
    got = bfm._packed_quadratic_gf(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (h.real, h.imag, C.real, C.imag))
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


def test_das_dispatch_on_cpu():
    args = [torch.from_numpy(a) for a in _das_inputs(9, 20, 13)]
    cuda_das.launches = 0
    want = cuda_das.das_map_plain(*args)
    assert torch.equal(cuda_das.das_map(*args), want)
    assert cuda_das.launches == 0
    _config.set_das_kernel("on")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            cuda_das.das_map(*args)
        with pytest.raises(ValueError, match="float32"):
            cuda_das.das_map(*(a.double() for a in args))
    finally:
        _config.set_das_kernel("auto")
    _config.set_das_kernel("off")
    try:
        assert torch.equal(cuda_das.das_map(*args), want)
    finally:
        _config.set_das_kernel("auto")
    # float64 under "auto" takes the plain version
    got64 = cuda_das.das_map(*(a.double() for a in args))
    assert got64.dtype == torch.float64
    assert cuda_das.launches == 0
    with pytest.raises(ValueError):
        _config.set_das_kernel("fast")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_das.das_map_cuda(*args)


def _das_kernel_emulated(amp, diff, k, cre, cim):
    """The CUDA kernel's arithmetic (`csrc/das_map.cu`) in torch, in the
    inputs' dtype: mic tiles and tile pairs from `cuda_das.design`, each pair
    folded into D = C + Cᴴ's upper triangle as the kernel folds it, each
    warp's run of steps (`cuda_das.unit_steps`) summed in the kernel's order
    (a row block's t over its columns, then Re(conj(h_l) t_l) row by row into
    the warp's sum), the warps' sums added in order."""
    M, G = amp.shape
    F = k.shape[0]
    plan = cuda_das.design(M, G, F)
    R, n = plan["R"], plan["mic_tiles"]
    pad = n * R - M
    ph = k[:, None, None] * diff[None]  # (F, M, G)
    h_re = torch.nn.functional.pad(amp * torch.cos(ph), (0, 0, 0, pad))
    h_im = torch.nn.functional.pad(-(amp * torch.sin(ph)), (0, 0, 0, pad))
    c_re = torch.nn.functional.pad(cre, (0, pad, 0, pad))
    c_im = torch.nn.functional.pad(cim, (0, pad, 0, pad))
    q = [torch.zeros((F, G), dtype=amp.dtype) for _ in range(cuda_das.WARPS)]
    upper = torch.triu(torch.ones(R, R, dtype=torch.bool), 1)
    for lt in range(n):
        for kt in range(lt, n):
            rows, cols = slice(lt * R, lt * R + R), slice(kt * R, kt * R + R)
            a_re, a_im = c_re[:, rows, cols], c_im[:, rows, cols]  # C[L, K]
            b_re, b_im = c_re[:, cols, rows], c_im[:, cols, rows]  # C[K, L]
            d_re = a_re + b_re.transpose(1, 2)  # D[l][m] = C[l][m] + conj(C[m][l])
            d_im = a_im - b_im.transpose(1, 2)
            if lt == kt:  # upper triangle, Re C[l][l] on the diagonal
                d_re = torch.where(upper, d_re, torch.zeros_like(d_re))
                d_im = torch.where(upper, d_im, torch.zeros_like(d_im))
                d_re = d_re + torch.diag_embed(torch.diagonal(a_re, dim1=1, dim2=2))
            for u in range(cuda_das.WARPS):
                for b, c0, c1 in cuda_das.unit_steps(R, lt == kt, u):
                    r8 = slice(lt * R + 8 * b, lt * R + 8 * b + 8)
                    tr = torch.zeros((F, 8, G), dtype=amp.dtype)
                    ti = torch.zeros_like(tr)
                    for c in range(c0, c1):
                        dr = d_re[:, 8 * b:8 * b + 8, c, None]
                        di = d_im[:, 8 * b:8 * b + 8, c, None]
                        hr = h_re[:, None, kt * R + c]
                        hi = h_im[:, None, kt * R + c]
                        tr = tr + dr * hr
                        tr = tr - di * hi
                        ti = ti + dr * hi
                        ti = ti + di * hr
                    for r in range(8):
                        q[u] = q[u] + h_re[:, r8][:, r] * tr[:, r]
                        q[u] = q[u] + h_im[:, r8][:, r] * ti[:, r]
    out = q[0]
    for u in range(1, cuda_das.WARPS):
        out = out + q[u]
    return out.T


@pytest.mark.parametrize("R", [8, 16, 32, 64])
@pytest.mark.parametrize("diag", [True, False])
def test_das_kernel_split_covers_each_step_once(R, diag):
    """The warps' runs cover a tile's steps (row block, column) exactly once,
    in order, and are balanced to a step."""
    got, sizes = [], []
    for u in range(cuda_das.WARPS):
        segs = cuda_das.unit_steps(R, diag, u)
        sizes.append(sum(c1 - c0 for _, c0, c1 in segs))
        got += [(b, c) for b, c0, c1 in segs for c in range(c0, c1)]
    want = [(b, c) for b in range(R // 8) for c in range(8 * b if diag else 0, R)]
    assert got == want
    assert max(sizes) - min(sizes) <= 1


def test_das_kernel_design_fills_the_card_at_the_path_shapes():
    """At the DAS path's 10 and 30 bins (64 mics, 900 points) the grid gives
    each of the H100's 132 SMs at least two blocks of 8 warps; the sweep
    takes 64 points a block; M = 160 takes tiles of 32 with the steering
    resident, M = 300 rebuilds it per tile pair."""
    for F in (10, 30):
        d = cuda_das.design(64, 900, F)
        assert d["P"] == 1 and d["mic_tiles"] == 1 and d["warps"] == 8
        assert d["blocks"] // 132 * d["warps"] >= 16
    assert cuda_das.design(64, 900, 513)["P"] == 2
    d160 = cuda_das.design(160, 900, 30)
    assert (d160["R"], d160["mic_tiles"], d160["pairs"], d160["resident"]) == (32, 5, 15, True)
    assert not cuda_das.design(300, 40, 2)["resident"]
    assert max(cuda_das.design(m, 900, 513)["smem_bytes"] for m in range(1, 400)) <= 232448


def _das_inputs_any_csm(M, G, F, seed=7):
    """Non-Hermitian C (its parts independent N(0, 1)), the camera's range
    of phases."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.5, 1.0, (M, G)).astype(np.float32)
    diff = rng.uniform(-0.3, 0.3, (M, G)).astype(np.float32)
    k = (np.arange(F) * (FS / 1024) * 2 * np.pi / 343 + 10.0).astype(np.float32)
    cre = rng.standard_normal((F, M, M)).astype(np.float32)
    cim = rng.standard_normal((F, M, M)).astype(np.float32)
    return amp, diff, k, cre, cim


@pytest.mark.parametrize(
    "M,G,F", DAS_CASES + [(64, 900, 10), (64, 900, 30), (160, 70, 3)])
@pytest.mark.parametrize("reference", ["core", "pallas"])
def test_das_kernel_emulation_matches_jax(M, G, F, reference):
    """The kernel's fold, split and summation order in float32, on a
    non-Hermitian C, against the JAX package's core and its Pallas kernel
    (interpret mode), 5e-5 scale-relative."""
    args = _das_inputs_any_csm(M, G, F)
    got = _das_kernel_emulated(*(torch.from_numpy(a) for a in args))
    jargs = [jnp.asarray(a) for a in args]
    if reference == "core":
        want = jbfm._das_map_core(*jargs)
    else:
        want = das_map_fused(*jargs, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (G, F)
    assert_close(got.numpy(), np.asarray(want), tol=5e-5, name="das kernel emulation")


@pytest.mark.parametrize("M,G,F", [(9, 20, 13), (64, 33, 3), (70, 11, 2)])
def test_das_kernel_fold_exact_for_any_csm(M, G, F):
    """In float64 the fold and the upper-triangle sum give Re(hᴴCh) of a
    non-Hermitian C to 1e-12."""
    amp, diff, k, cre, cim = (a.astype(np.float64) for a in _das_inputs_any_csm(M, G, F, 11))
    got = _das_kernel_emulated(*(torch.from_numpy(a) for a in (amp, diff, k, cre, cim)))
    h = amp[None] * np.exp(-1j * k[:, None, None] * diff[None])  # (F, M, G)
    want = np.real(np.einsum("fmg,fmn,fng->gf", np.conj(h), cre + 1j * cim, h))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_jax_state_carried_into_port(setting):
    """The JAX package's steering factors and Welch CSM, fed to the port's
    plain DAS core, give the JAX core's map."""
    j_amp, j_diff = jbfm._steering_amp_diff(
        jbf.SteeringVectorType.TrueLocation, setting["j_g"], setting["j_ma"]
    )
    x = np.asarray(setting["j_sig"].time_data).T
    f, csm = jspec.csm_welch(jnp.asarray(x), sampling_rate_hz=FS,
                             scaling=JScaling.FFTBackward)
    band = slice(110, 146)
    cre = np.array(jnp.real(csm))[band]
    cim = np.array(jnp.imag(csm))[band]
    k = (np.asarray(f)[band] * 2 * np.pi / 343).astype(np.float32)
    want = jbfm._das_map_core(jnp.asarray(j_amp, jnp.float32),
                              jnp.asarray(j_diff, jnp.float32),
                              jnp.asarray(k), jnp.asarray(cre), jnp.asarray(cim))
    amp, diff = bf.amp_diff_to_torch(j_amp, j_diff, "cpu")
    got = bfm._das_map_core(amp, diff, torch.from_numpy(k),
                            torch.from_numpy(cre), torch.from_numpy(cim))
    assert_close(got.numpy(), np.asarray(want), tol=5e-5, name="carried map")


# ---------------------------------------------------------------- sources


def test_monopole_projection_matches_jax():
    pos = _mic_positions()
    x = _noise(0.2, 1)
    src = [0.3, -0.2, 0.6]
    want = jbf.MonopoleSource(JSignal(None, x, FS), src).get_signals_on_array(
        jbf.MicArray(pos))
    t_src = bf.MonopoleSource(Signal(None, x, FS), src)
    got = t_src.get_signals_on_array(bf.MicArray(pos))
    assert got.number_of_channels == 9 and got.sampling_rate_hz == FS
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), tol=2e-5,
                 name="projection")
    # a second projection comes from the cache
    cached = t_src._projection_cache
    again = t_src.get_signals_on_array(bf.MicArray(pos))
    assert t_src._projection_cache is cached
    assert torch.equal(again.time_data, got.time_data)


@pytest.mark.parametrize("second_seconds", [0.2, 0.15])
def test_mix_sources_matches_jax(second_seconds):
    pos = _mic_positions()
    xs = [_noise(0.2, 2), _noise(second_seconds, 3)]
    where = [[0.3, -0.2, 0.6], [-0.1, 0.5, 0.4]]
    want = jbf.mix_sources_on_array(
        [jbf.MonopoleSource(JSignal(None, x, FS), p) for x, p in zip(xs, where)],
        jbf.MicArray(pos))
    got = bf.mix_sources_on_array(
        [bf.MonopoleSource(Signal(None, x, FS), p) for x, p in zip(xs, where)],
        bf.MicArray(pos))
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), tol=2e-5,
                 name="mix")


# ---------------------------------------------------------------- Signal


@pytest.mark.parametrize(
    "params",
    [{}, {"window_length_samples": 256, "scaling": "PowerSpectralDensity"},
     {"window_length_samples": 512, "overlap_percent": 75, "average": "median",
      "window_type": "Hamming"}],
)
def test_signal_csm_matches_jax(params):
    x = _noise(0.25, 4, channels=9)
    jkw, tkw = dict(params), dict(params)
    if "scaling" in params:
        jkw["scaling"] = JScaling[params["scaling"]]
        tkw["scaling"] = SpectrumScaling[params["scaling"]]
    if "window_type" in params:
        jkw["window_type"] = JWindow[params["window_type"]]
        tkw["window_type"] = Window[params["window_type"]]
    js = JSignal(None, x, FS).set_spectrum_parameters(**jkw)
    ts = Signal(None, x, FS).set_spectrum_parameters(**tkw)
    f_j, c_j = js.get_csm()
    f_t, c_t = ts.get_csm()
    np.testing.assert_array_equal(f_t, f_j)
    assert c_t.shape == (len(f_t), 9, 9) and c_t.dtype == torch.complex64
    assert_close(c_t.numpy(), np.asarray(c_j), tol=2e-5, name="signal csm")
    _, re, im = ts._get_csm_device()
    assert re.data_ptr() == c_t.real.data_ptr()
    assert torch.equal(torch.complex(re, im), c_t)


def test_signal_csm_cache():
    ts = Signal(None, _noise(0.25, 5, channels=3), FS)
    _, c1 = ts.get_csm()
    assert ts.get_csm()[1] is c1
    assert ts.get_csm(force_computation=True)[1] is not c1
    _, c2 = ts.get_csm()
    ts.set_spectrum_parameters(window_length_samples=512)
    _, c3 = ts.get_csm()
    assert c3.shape[0] == 257 and c3 is not c2
    ts.time_data = _noise(0.25, 6, channels=3)
    assert ts.get_csm()[1] is not c3
    ts.set_spectrum_parameters(method=SpectrumMethod.FFT)
    f, c4 = ts.get_csm()  # the FFT-method CSM, cached on the parameters too
    assert c4.shape == (len(f), 3, 3) and ts.get_csm()[1] is c4


def test_signal_time_data_rules_match_jax():
    rng = np.random.default_rng(7)
    # fewer samples than channels: transposed, as in the JAX package
    short = rng.standard_normal((3, 40))
    for td in (short, short.T, rng.standard_normal(50), rng.standard_normal((50, 1))):
        js, ts = JSignal(None, td, FS), Signal(None, td, FS)
        np.testing.assert_allclose(ts.time_data.numpy(), np.asarray(js.time_data), rtol=1e-7)
        assert ts.number_of_channels == js.number_of_channels
    loud = 3.0 * rng.standard_normal((60, 2)) + 1j * rng.standard_normal((60, 2))
    with pytest.warns(UserWarning):
        js = JSignal(None, loud, FS, constrain_amplitude=True)
    with pytest.warns(UserWarning):
        ts = Signal(None, loud, FS, constrain_amplitude=True)
    assert ts.is_complex_signal and js.is_complex_signal
    np.testing.assert_allclose(ts.time_data.numpy(), np.asarray(js.time_data), rtol=1e-6)
    np.testing.assert_allclose(ts.time_data_imaginary.numpy(),
                               np.asarray(js.time_data_imaginary), rtol=1e-6)
    assert ts.amplitude_scale_factor == pytest.approx(js.amplitude_scale_factor)
    with pytest.raises(NotImplementedError):
        Signal("a.wav")
    copy = ts.copy_with_new_time_data(np.ones((60, 2)) * 0.1)
    assert copy.sampling_rate_hz == FS and copy.constrain_amplitude
    assert copy._spectrum_parameters == ts._spectrum_parameters


# ---------------------------------------------------------------- public map


@pytest.mark.parametrize("remove_diag", [True, False])
@pytest.mark.parametrize("fraction", [3, 200])
def test_public_das_map_matches_jax(setting, remove_diag, fraction):
    """`BeamformerDASFrequency.get_beamformer_map`; fraction 200 narrows the
    band to one bin (the single-bin tail)."""
    st = "TrueLocation"
    jb = jbf.BeamformerDASFrequency(setting["j_sig"], setting["j_ma"], setting["j_g"],
                                    jbf.SteeringVector(jbf.SteeringVectorType[st]))
    tb = bf.BeamformerDASFrequency(setting["t_sig"], setting["t_ma"], setting["t_g"],
                                   bf.SteeringVector(bf.SteeringVectorType[st]))
    want = np.asarray(jb.get_beamformer_map(2000, fraction, remove_csm_diagonal=remove_diag))
    got = tb.get_beamformer_map(2000, fraction, remove_csm_diagonal=remove_diag)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape == (3, 5)
    assert torch.equal(tb.map, got)
    np.testing.assert_array_equal(tb.f_range_hz, jb.f_range_hz)
    assert_close(got.numpy(), want, tol=1e-4, name="public map")
    if fraction == 3:
        l1, l2 = setting["lines"]
        px, py = np.unravel_index(int(torch.argmax(got)), got.shape)
        assert abs(l1[px] - setting["src"][0]) < 0.11
        assert abs(l2[py] - setting["src"][1]) < 0.11


def test_public_das_map_pallas_forced_matches_port(setting):
    """The JAX map with its Pallas kernel forced (interpret mode) against
    the port's map."""
    jb = jbf.BeamformerDASFrequency(setting["j_sig"], setting["j_ma"], setting["j_g"],
                                    jbf.SteeringVector())
    jconfig.set_pallas_das("on")
    try:
        want = np.asarray(jb.get_beamformer_map(2000, 3))
    finally:
        jconfig.set_pallas_das("auto")
    tb = bf.BeamformerDASFrequency(setting["t_sig"], setting["t_ma"], setting["t_g"],
                                   bf.SteeringVector())
    assert_close(tb.get_beamformer_map(2000, 3).numpy(), want, tol=1e-4, name="forced")


def test_public_das_map_on_cpu_launches_nothing_and_caches(setting):
    tb = bf.BeamformerDASFrequency(setting["t_sig"], setting["t_ma"], setting["t_g"],
                                   bf.SteeringVector())
    cuda_das.launches = 0
    first = tb.get_beamformer_map(2000, 3)
    cached = tb._amp_diff_dev
    second = tb.get_beamformer_map(2000, 3)
    assert tb._amp_diff_dev is cached
    assert torch.equal(first, second)
    tb.st_vec = bf.SteeringVector(bf.SteeringVectorType.Classic)
    tb.get_beamformer_map(2000, 3)
    assert tb._amp_diff_dev is not cached
    assert cuda_das.launches == 0
    with pytest.raises(NotImplementedError):
        tb.get_beamformer_map(2000, 3, mesh=object())
    f, csm, h = tb._csm_and_steering(2000, 3)
    assert csm.shape == (len(f), 9, 9) and h.shape == (len(f), 9, 15)


def test_beamforming_import_leaves_jax_out():
    import subprocess

    code = (
        "import dsptoolbox_tpu_torch.beamforming, sys\n"
        "assert 'jax' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr

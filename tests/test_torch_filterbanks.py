"""The port's filter-bank path (`dsptoolbox_tpu_torch`: the bank operators
and the plain version of kernel B3, `Filter`, `FilterBank`,
`MultiBandSignal`, the Linkwitz-Riley and gammatone banks, the
fractional-octave factory, `resample` and `tools.filterbank_chain`) against
the JAX package on the CPU (its Pallas bank kernel in interpret mode) and
scipy's float64 ``sosfilt``, on the same seeded numpy inputs. Sizes are
small: a few thousand samples, 2-3 channels."""

import warnings

import numpy as np
import pytest
import torch
import scipy.signal as sig
from scipy.signal import butter, resample_poly, sosfilt, sosfiltfilt, upfirdn

import jax.numpy as jnp
from conftest import assert_close
from crossover_chain import lr_chain
import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu.ops import iir_block as jblock
from dsptoolbox_tpu.ops.pallas_iir_bank import bank_dense_operators, sosfilt_bank_pallas
from dsptoolbox_tpu.standard.enums import FilterBankMode as JMode
from dsptoolbox_tpu_torch import _config, filterbanks, tools
from dsptoolbox_tpu_torch.classes import Filter, FilterBank, MultiBandSignal, Signal
from dsptoolbox_tpu_torch.classes.filterbank import _sos_bank_or_none
from dsptoolbox_tpu_torch.classes.signal import DeviceTimeData
from dsptoolbox_tpu_torch.ops import cuda_iir_bank, fft_conv, iir, iir_block
from dsptoolbox_tpu_torch.standard.enums import FilterBankMode, FilterPassType
from dsptoolbox_tpu_torch.standard.resampling import resample
from dsptoolbox_tpu_torch.tools import filterbank_chain

torch.set_num_threads(1)
warnings.filterwarnings("ignore", message="Filter output is complex")

RNG = np.random.default_rng(11)
FS = 44100


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port's classes put numpy data on the default device, "cuda" out
    of the box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _port_bank(jax_bank) -> FilterBank:
    """The port's FilterBank from a JAX bank's ``.sos`` arrays: the same
    coefficients on both sides."""
    filters = []
    for f in jax_bank.filters:
        g = Filter.from_sos(np.asarray(f.sos), f.sampling_rate_hz)
        g.warning_if_complex = f.warning_if_complex
        filters.append(g)
    return FilterBank(filters)


def _band_data(sig) -> np.ndarray:
    """A port Signal's data (complex when it has an imaginary part)."""
    td = sig.time_data.numpy()
    return td + 1j * sig.time_data_imaginary.numpy() if sig.is_complex_signal else td


def _jax_band_data(sig) -> np.ndarray:
    td = np.asarray(sig.time_data)
    return td + 1j * np.asarray(sig.time_data_imaginary) if sig.is_complex_signal else td


def _complex_bank(n_bands, sections, radius=0.95):
    poles = radius * np.exp(1j * np.linspace(0.1, 1.0, n_bands * sections))
    bank = np.zeros((n_bands, sections, 6), np.complex128)
    bank[:, :, 0] = 0.3
    bank[:, :, 3] = 1.0
    bank[:, :, 4] = -poles.reshape(n_bands, sections)
    return bank


def _butter_bank():
    return np.stack([butter(4, [f, f * 1.4], btype="bandpass", fs=48000, output="sos")
                     for f in (200.0, 500.0, 1200.0, 3000.0)])


def _third_octave_bank():
    fb = filterbanks.fractional_octave_bands([31.5, 16e3], 3, 6, FS)[0]
    return np.stack([f.sos for f in fb.filters])


# ======== the bank operators and B3's plain version =========================
@pytest.mark.parametrize("kind", ["complex", "real"])
def test_bank_operators_match_jax(kind):
    bank = _complex_bank(3, 4) if kind == "complex" else _butter_bank()
    T = 3000 + 50
    own = iir_block.sosfilt_bank_operators(bank, T)
    ref = jblock.sosfilt_bank_operators(bank, T)
    np.testing.assert_array_equal(own["sos"], bank)
    for k in ("L", "n_full", "rem"):
        assert own[k] == ref[k]
    for k in ("HmatT", "GyT", "ALT", "MT"):
        np.testing.assert_allclose(own[k], ref[k], rtol=0, atol=1e-12)
    for a, b in zip(own["rem_ops"], ref["rem_ops"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


# the cases of tests/test_pallas_bank.py, at its tolerances: rtol 5e-4,
# atol 2e-4·scale (8e-4 for its near-unit-pole Butterworth bank)
_PALLAS_CASES = {
    "complex-chunk-padding": (_complex_bank(6, 4), (2, 5000), 2e-4),
    "real-butterworth": (_butter_bank(), (1, 3000), 8e-4),
    "single-band-T1000": (butter(4, 0.2, output="sos")[None], (1, 1000), 2e-4),
}


@pytest.mark.parametrize("case", list(_PALLAS_CASES))
def test_plain_bank_matches_jax_and_pallas_interpret(case):
    bank, shape, atol = _PALLAS_CASES[case]
    x = (RNG.standard_normal(shape) * 0.4).astype(np.float32)
    T = shape[-1]
    before = cuda_iir_bank.launches
    got = iir_block.sosfilt_bank_apply(
        iir_block.sosfilt_bank_operators(bank, T), torch.from_numpy(x)
    ).numpy()
    assert cuda_iir_bank.launches == before  # a CPU tensor takes the plain version
    want = np.asarray(jblock.sosfilt_bank_apply(jblock.sosfilt_bank_operators(bank, T),
                                                jnp.asarray(x)))
    pallas = np.asarray(sosfilt_bank_pallas(bank_dense_operators(bank, T), jnp.asarray(x),
                                            interpret=True))
    for ref in (want, pallas):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=atol * np.abs(ref).max())


def test_kernel_real_form_reproduces_the_plain_lead():
    """`cuda_iir_bank.kernel_operators` (the kernel's real form: 2N real
    lanes and two planes for a complex bank) run through the kernel's three
    passes in float64 torch reproduce `sosfilt_bank_lead_plain`."""
    for bank in (_complex_bank(3, 4), _butter_bank()):
        R, T = 2, 128 * 20 + 5
        x = torch.from_numpy(RNG.standard_normal((R, T)).astype(np.float32))
        ops = iir_block.bank_device_operators(bank, T, torch.float32, "cpu")
        k = cuda_iir_bank.kernel_operators(ops)
        P, B, L = k["h"].shape
        Ns, K = k["lanes"], ops["n_full"]
        assert (P, Ns) == ((2, 16) if np.iscomplexobj(bank) else (1, 8))
        xb = x[:, : K * L].reshape(R * K, L).double()
        v = (xb @ k["M"]).reshape(R, K, B, Ns)  # pass 1
        s = torch.zeros(R, B, Ns, dtype=torch.float64)
        starts = torch.zeros(R, K, B, Ns, dtype=torch.float64)
        for kk in range(K):  # pass 2
            starts[:, kk] = s
            s = torch.einsum("rbj,bjn->rbn", s, k["A"]) + v[:, kk]
        i = torch.arange(L)
        toeplitz = torch.where(i[None, :] >= i[:, None],
                               k["h"][..., (i[None, :] - i[:, None]).clamp(min=0)], 0.0)
        y = (torch.einsum("rkl,pblm->pbrkm", xb.float().reshape(R, K, L), toeplitz).double()
             + torch.einsum("rkbn,pbnm->pbrkm", starts, k["G"]))  # pass 3
        out = torch.zeros(P, B, R, T)
        s_end = cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out)
        lead = out[..., : K * L].reshape(P, B, R, K, L)
        assert float((y.float() - lead).abs().max()) <= 1e-6 * float(lead.abs().max())
        s = s.permute(1, 0, 2)
        if P == 2:
            s = torch.complex(s[..., : Ns // 2], s[..., Ns // 2:])
        assert float((s - s_end).abs().max()) <= 1e-9 * float(s_end.abs().max())


def _tile_route_states(k: dict, x: torch.Tensor, K: int, s0=None) -> tuple:
    """The state path of B3's wide route (`csrc/iir_bank.cu`, namespace
    ``tiles``) in float64 torch on the kernel's real form ``k``, step by step
    as the kernel takes it: x·M per block (zero input past block K); per
    tile of `cuda_iir_bank.TILE` blocks, the injections of its 16
    super-blocks of 4 blocks (V·P4) and their walk with A^4; the end state
    of every full tile walked from zero; the carry S_{t+1} = S_t A^64 +
    end_t over the tile starts from ``s0`` (zero when None); in each tile
    the super-blocks walked from
    S_t and the states inside them in three steps s_{4m+j} = s_{4m+j-1} A +
    v_{4m+j-1}. Returns the state entering every block ``(B, R, K, Ns)``
    and the state after block K ``(B, R, Ns)``."""
    A, M, Ns = k["A"], k["M"], k["lanes"]
    B, L, R, F = A.shape[0], M.shape[0], x.shape[0], cuda_iir_bank.TILE
    P4, A4, A64 = k["W"][:, : 4 * Ns], k["W"][:, 4 * Ns: 5 * Ns], k["W"][:, 5 * Ns:]
    n_tiles = -(-K // F)
    v = (x[:, : K * L].reshape(R, K, L).double() @ M).reshape(R, K, B, Ns).permute(2, 0, 1, 3)
    v = torch.cat([v, torch.zeros(B, R, n_tiles * F - K, Ns, dtype=torch.float64)], 2)
    w4 = torch.einsum("brtmc,bcn->brtmn", v.reshape(B, R, n_tiles, F // 4, 4 * Ns), P4)

    def walk(s, t):
        """The state entering each super-block of tile t from s, and after."""
        starts = []
        for m in range(F // 4):
            starts.append(s)
            s = torch.einsum("brj,bjn->brn", s, A4) + w4[:, :, t, m]
        return torch.stack(starts, 2), s

    zero = torch.zeros(B, R, Ns, dtype=torch.float64)
    ends = [walk(zero, t)[1] for t in range(n_tiles - 1)]
    starts = [zero if s0 is None else s0]
    for end in ends:
        starts.append(torch.einsum("brj,bjn->brn", starts[-1], A64) + end)
    tiles = []
    for t, s in enumerate(starts):
        rows, last = walk(s, t)
        rows = [rows]
        for j in range(1, 4):
            rows.append(torch.einsum("brmj,bjn->brmn", rows[-1], A)
                        + v[:, :, t * F + j - 1: (t + 1) * F: 4])
        tiles.append(torch.stack(rows, 3).reshape(B, R, F, Ns))
    states = torch.cat(tiles, 2)
    return states[:, :, :K], states[:, :, K] if K < n_tiles * F else last


@pytest.mark.parametrize(
    "kind,K,with_s0",
    [("complex", 63, True), ("complex", 130, False), ("complex", 201, True),
     ("real", 65, True), ("real", 130, True), ("real", 193, False)],
)
def test_wide_route_tiles_reproduce_the_doubling_prefix(kind, K, with_s0):
    """B3's wide route chunks the state chain by tiles of 64 blocks and
    super-blocks of 4 (a walk from zero per tile, a carry over the tile
    starts, a walk inside each tile from its start and the states inside
    its super-blocks) where the plain version doubles: the same states
    within 1e-12 of their scale, for the 16-band gammatone bank at 44.1 kHz
    (complex, 256 band-lanes) and eight order-8 Butterworth bandpasses at 1-12
    kHz (real, 64), at K not a multiple of 64 (one partial tile at K = 63)
    and from a zero or a random start state. (On the 1/3-octave bank's
    lowest bands any two float64 orders of the chain, the serial walk and
    the doubling too, differ by up to ~5e-9 of the scale: a bound of the
    operators' conditioning, not of the chunking.)"""
    if kind == "complex":
        bank = _sos_bank_or_none(filterbanks.auditory_filters_gammatone(
            [500, 4000], sampling_rate_hz=FS).filters)
    else:
        bank = np.stack([butter(4, [f, f * 1.4], btype="bandpass", fs=48000, output="sos")
                         for f in np.geomspace(1000.0, 12000.0, 8)])
    R, T = 2, 128 * K + 33
    x = torch.from_numpy(RNG.standard_normal((R, T)).astype(np.float32))
    ops = iir_block.bank_device_operators(bank, T, torch.float32, "cpu")
    k = cuda_iir_bank.kernel_operators(ops)
    _, B, L = k["h"].shape
    Ns = k["lanes"]
    assert ops["n_full"] == K and cuda_iir_bank.keeps_state_on_chip(L, B, Ns)
    s0 = s0_real = None
    if with_s0:
        s0_real = torch.from_numpy(RNG.standard_normal((B, R, Ns)))
        s0 = s0_real if kind == "real" else torch.complex(s0_real[..., : Ns // 2],
                                                          s0_real[..., Ns // 2:])
    xb = x[:, : K * L].reshape(R, K, L).to(ops["HmatT"].dtype)
    want = cuda_iir_bank.block_states(ops, xb, s0)
    got = _tile_route_states(k, x, K, s0_real)
    for g, w in zip(got, want):
        if kind == "complex":
            g = torch.complex(g[..., : Ns // 2], g[..., Ns // 2:])
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


@pytest.mark.parametrize("bank", ["gammatone", "third_octave"])
def test_plain_bank_matches_scipy_float64(bank):
    """Every band within 5e-6 of scipy's float64 sosfilt at 44.1 kHz: the
    16-band gammatone bank and the 28-band 1/3-octave bank, whose lowest
    bands have poles within 1e-3 of the unit circle."""
    if bank == "gammatone":
        b = _sos_bank_or_none(filterbanks.auditory_filters_gammatone(
            [500, 4000], sampling_rate_hz=FS).filters)
    else:
        b = _third_octave_bank()
    x = RNG.standard_normal((2, 8192 + 77)).astype(np.float32)
    re, im = iir_block.sosfilt_bank_apply_planes(
        iir_block.sosfilt_bank_operators(b, x.shape[-1]), torch.from_numpy(x))
    y = re.numpy() if im is None else re.numpy() + 1j * im.numpy()
    assert y.shape == (len(b), 2, x.shape[-1])
    for i in range(len(b)):
        assert _rel(y[i], sosfilt(b[i], x.astype(np.float64), axis=-1)) < 5e-6


def test_jax_float32_bank_misses_scipy_on_low_third_octave_bands():
    """Why the port's bank keeps a float64 state, unlike the JAX package's:
    on the lowest 1/3-octave bands at 44.1 kHz the JAX float32 bank is more
    than 1e-3 off scipy's float64 sosfilt, the port's within 5e-6."""
    bank = _third_octave_bank()[:4]  # 25 (31.5 Hz nominal is first), 40, 50, 63 Hz
    x = RNG.standard_normal((1, 4096)).astype(np.float32)
    T = x.shape[-1]
    jax_y = np.asarray(jblock.sosfilt_bank_apply(jblock.sosfilt_bank_operators(bank, T),
                                                 jnp.asarray(x)))
    port_y = iir_block.sosfilt_bank_apply(iir_block.sosfilt_bank_operators(bank, T),
                                          torch.from_numpy(x)).numpy()
    for b in range(len(bank)):
        ref = sosfilt(bank[b], x[0].astype(np.float64))
        assert _rel(jax_y[b, 0], ref) > 1e-3
        assert _rel(port_y[b, 0], ref) < 5e-6


def test_long_cascades_split_beyond_the_kernels_lanes(monkeypatch):
    """A bank of 18 real (or 9 complex) sections: its operators stay whole,
    the JAX package's; the kernel's route splits it into a first stage of
    16 (8) sections on the shared input and a stage per band for the rest.
    Both give scipy's result (the stages run here through the kernel's
    plain version)."""
    real = np.stack([np.concatenate([butter(2, f, output="sos")
                                     for f in np.linspace(0.05 + 0.02 * b, 0.8, 18)])
                     for b in range(2)])
    monkeypatch.setattr(iir_block, "sosfilt_bank_lead_cuda",
                        cuda_iir_bank.sosfilt_bank_lead_plain)
    for bank, n_rest in ((real, 2), (_complex_bank(2, 9, 0.9), 1)):
        T = 3000 + 77
        ops = iir_block.sosfilt_bank_operators(bank, T)
        ref = jblock.sosfilt_bank_operators(bank, T)
        for k in ("HmatT", "GyT", "ALT", "MT"):
            np.testing.assert_allclose(ops[k], ref[k], rtol=0, atol=1e-12)
        first, rest = iir_block.bank_kernel_stages(bank, T, "cpu")
        assert first["kernel"]["lanes"] == 32  # 16 real, 8 complex sections
        assert [len(r) for r in rest] == [1, 1]
        assert rest[0][0]["ALT"].shape[-1] == 2 * n_rest
        x = RNG.standard_normal((2, T)).astype(np.float32)
        y = iir_block.sosfilt_bank_apply(ops, torch.from_numpy(x)).numpy()
        planes = iir_block._kernel_route((first, rest), torch.from_numpy(x)).numpy()
        staged = planes[0] + 1j * planes[1] if np.iscomplexobj(bank) else planes[0]
        for b in range(2):
            want = sosfilt(bank[b], x.astype(np.float64), axis=-1)
            assert _rel(y[b], want) < 5e-6
            assert _rel(staged[b], want) < 5e-6


def test_bank_switch_and_kernels_off(monkeypatch):
    bank = _butter_bank()
    x = torch.from_numpy(RNG.standard_normal((2, 4096)).astype(np.float32))
    ops = iir_block.sosfilt_bank_operators(bank, 4096)
    want = iir_block.sosfilt_bank_apply(ops, x)
    for b in range(len(bank)):
        assert _rel(want[b], sosfilt(bank[b], x.numpy().astype(np.float64), axis=-1)) < 5e-6
    with _config.kernels_off():
        assert torch.equal(iir_block.sosfilt_bank_apply(ops, x), want)
    asked = []
    monkeypatch.setattr(_config, "use_kernel", lambda name, t: asked.append(name) or False)
    assert torch.equal(iir_block.sosfilt_bank_apply(ops, x), want)
    assert asked == ["bank"]
    with pytest.raises(TypeError):
        iir_block.sosfilt_bank_apply_planes(ops, x.to(torch.complex64))


# ======== ops: zero phase, convolution, resampling ==========================
def test_sosfiltfilt_fft_convolve_and_upfirdn_match_scipy():
    sos = butter(4, [0.05, 0.2], btype="bandpass", output="sos")
    x = RNG.standard_normal((2, 3000))
    assert_close(iir.sosfiltfilt(sos, torch.from_numpy(x)).numpy(),
                 sosfiltfilt(sos, x, axis=-1), 1e-9, "sosfiltfilt f64")
    got32 = iir.sosfiltfilt(sos, torch.from_numpy(x.astype(np.float32))).numpy()
    assert_close(got32, sosfiltfilt(sos, x, axis=-1), 5e-6, "sosfiltfilt f32")
    h = RNG.standard_normal(37)
    for mode in ("full", "same", "valid"):
        assert_close(fft_conv.fft_convolve(torch.from_numpy(x), torch.from_numpy(h), mode).numpy(),
                     np.stack([np.convolve(r, h, mode) for r in x]), 1e-12, mode)
    for up, down in ((1, 3), (2, 1), (3, 2)):
        assert_close(fft_conv.upfirdn(h, torch.from_numpy(x), up, down).numpy(),
                     upfirdn(h, x, up, down, axis=-1), 1e-12, f"upfirdn {up}/{down}")
        assert_close(fft_conv.resample_poly(torch.from_numpy(x), up, down).numpy(),
                     resample_poly(x, up, down, axis=-1), 1e-12, f"resample_poly {up}/{down}")


def test_frequency_grids_match_jax():
    for kw in (dict(num_fractions=3, frequency_range=(31.5, 16e3), return_cutoff=True),
               dict(num_fractions=1, frequency_range=(63, 8000)),
               dict(num_fractions=6, frequency_range=(100, 1000), return_cutoff=True)):
        got = tools.fractional_octave_frequencies(**kw)
        want = jdsp.tools.fractional_octave_frequencies(**kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for args in (([500, 4000], 1), ([20, 20000], 0.5), ([4000, 100], 2)):
        np.testing.assert_array_equal(tools.erb_frequencies(*args),
                                      jdsp.tools.erb_frequencies(*args))


def test_resample_matches_jax():
    x = RNG.standard_normal((4410, 2)).astype(np.float32)
    got = resample(Signal(None, x, FS), 14700)
    want = jdsp.resample(jdsp.Signal(None, x, FS), 14700)
    assert got.sampling_rate_hz == want.sampling_rate_hz == 14700
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 2e-6, "resample")
    assert resample(Signal(None, x, FS), FS).time_data.shape == (4410, 2)
    rescaled = resample(Signal(None, x, FS), 14700, rescaling=True)
    assert_close(rescaled.time_data.numpy(), 3 * got.time_data.numpy(), 1e-6, "rescaling")


# ======== classes ===========================================================
def test_signal_takes_device_pairs_and_peak_hints():
    x = torch.from_numpy(RNG.standard_normal((3, 500)).astype(np.float32))
    y = torch.from_numpy(RNG.standard_normal((3, 500)).astype(np.float32))
    base = Signal(None, x.T, FS)
    pair = base.copy_with_new_time_data(DeviceTimeData(x.T, y.T))
    assert pair.is_complex_signal and pair._x.data_ptr() == x.data_ptr()  # views stay views
    cplx = base.copy_with_new_time_data(torch.complex(x, y).T)
    torch.testing.assert_close(cplx.time_data_imaginary, pair.time_data_imaginary)
    with pytest.warns(UserWarning, match="0 dBFS"):
        loud = Signal(None, 2 * x.T, FS, constrain_amplitude=True)
    with pytest.warns(UserWarning, match="0 dBFS"):
        hinted = loud.copy_with_new_time_data(DeviceTimeData(2 * x.T, None, 4.0))
    assert hinted.amplitude_scale_factor == 0.25
    torch.testing.assert_close(hinted._x, x / 2)


def test_filter_designs_and_responses_match_jax():
    for args in ((4, [300.0, 3000.0], "Bandpass"), (6, 1000.0, "Highpass")):
        order, freq, kind = args
        got = Filter.iir_filter(order, freq, getattr(FilterPassType, kind), FS)
        want = jdsp.Filter.iir_filter(order, freq, getattr(jdsp.FilterPassType, kind), FS)
        np.testing.assert_allclose(got.sos, want.sos, atol=1e-12)
        assert got.order == want.order and got.is_iir
        f = np.linspace(10, 20000, 64)
        np.testing.assert_allclose(got.get_transfer_function(f), want.get_transfer_function(f))
        assert_close(got.get_ir(2048).time_data.numpy(),
                     np.asarray(want.get_ir(2048).time_data), 1e-5, f"{kind} ir")
    b, a = butter(2, 0.1)
    fir = Filter.from_ba(np.hanning(31), [1.0], FS)
    assert fir.is_fir and fir.get_ir(64).time_data.shape == (64, 1)
    x = RNG.standard_normal((2000, 2)).astype(np.float32)
    for filt, jfilt in ((Filter.from_ba(b, a, FS), jdsp.Filter.from_ba(b, a, FS)),
                        (fir, jdsp.Filter.from_ba(np.hanning(31), [1.0], FS))):
        assert_close(filt.filter_signal(Signal(None, x, FS)).time_data.numpy(),
                     np.asarray(jfilt.filter_signal(jdsp.Signal(None, x, FS)).time_data),
                     1e-5, "ba")


def test_filter_state_and_channel_selection_match_scipy():
    sos = butter(4, [200.0, 2000.0], btype="bandpass", fs=FS, output="sos")
    filt = Filter.from_sos(sos, FS)
    x = RNG.standard_normal((3000, 3)).astype(np.float32)
    sig = Signal(None, x, FS)
    out = filt.filter_signal(sig, channels=[0, 2], activate_zi=True)
    zi = np.stack(filt.zi)  # (3, S, 2) after the call
    z0 = np.tile(np.asarray(Filter.from_sos(sos, FS).initialize_zi(1).zi[0])[:, None],
                 (1, 2, 1))
    y_ref, zf_ref = sosfilt(sos, x[:, [0, 2]].T.astype(np.float64), axis=-1, zi=z0)
    assert _rel(out.time_data.numpy()[:, [0, 2]].T, y_ref) < 5e-6
    np.testing.assert_array_equal(out.time_data.numpy()[:, 1], x[:, 1])
    np.testing.assert_allclose(zi[[0, 2]], np.moveaxis(zf_ref, 1, 0), atol=1e-5)
    zp = filt.filter_signal(sig, zero_phase=True)
    assert _rel(zp.time_data.numpy().T, sosfiltfilt(sos, x.T.astype(np.float64))) < 5e-6


def test_filterbank_modes_on_fractional_octave_bank_match_scipy():
    fb, centers, (lo, hi) = filterbanks.fractional_octave_bands([125, 2000], 1, 6, 8000)
    jfb, jcenters, _ = jdsp.filterbanks.fractional_octave_bands([125, 2000], 1, 6, 8000)
    np.testing.assert_array_equal(centers, jcenters)
    for f, g in zip(fb.filters, jfb.filters):
        np.testing.assert_allclose(f.sos, g.sos, atol=1e-10)
    x = RNG.standard_normal((3000, 2)).astype(np.float32)
    x64 = x.T.astype(np.float64)
    refs = [sosfilt(f.sos, x64, axis=-1) for f in fb.filters]
    par = fb.filter_signal(Signal(None, x, 8000), FilterBankMode.Parallel)
    assert isinstance(par, MultiBandSignal) and par.number_of_bands == len(refs)
    for band, ref in zip(par.bands, refs):
        assert _rel(band.time_data.numpy().T, ref) < 5e-6
    summed = fb.filter_signal(Signal(None, x, 8000), FilterBankMode.Summed)
    assert _rel(summed.time_data.numpy().T, np.sum(refs, axis=0)) < 5e-6
    two = FilterBank(fb.filters[1:3])
    seq = two.filter_signal(Signal(None, x, 8000), FilterBankMode.Sequential)
    ref = sosfilt(two.filters[1].sos, sosfilt(two.filters[0].sos, x64, axis=-1), axis=-1)
    assert _rel(seq.time_data.numpy().T, ref) < 5e-6
    td, fs = par.get_all_time_data()
    assert fs == 8000 and tuple(td.shape) == (3000, len(refs), 2)
    assert _rel(par.collapse().time_data.numpy(), summed.time_data.numpy()) < 1e-6
    ir = fb.get_ir(512)
    assert ir.number_of_bands == len(refs) and ir.bands[0].time_data.shape == (512, 1)


@pytest.mark.parametrize("T", [500, 4096], ids=["sosfilt-split", "frequency-sampling"])
def test_lr_filterbank_matches_jax(T):
    freqs = [250, 1000, 4000]
    lr = filterbanks.linkwitz_riley_crossovers(freqs, [4, 4, 4], 48000)
    jlr = jdsp.filterbanks.linkwitz_riley_crossovers(freqs, [4, 4, 4], 48000)
    assert (lr._freq_nfft(T) is None) == (T == 500)
    x = (RNG.standard_normal((T, 2)) * 0.3).astype(np.float32)
    par = lr.filter_signal(Signal(None, x, 48000), FilterBankMode.Parallel)
    jpar = jlr.filter_signal(jdsp.Signal(None, x, 48000), JMode.Parallel)
    for b, jb in zip(par.bands, jpar.bands):
        assert_close(b.time_data.numpy(), np.asarray(jb.time_data), 5e-5, "LR band")
    summed = lr.filter_signal(Signal(None, x, 48000), FilterBankMode.Summed)
    jsummed = jlr.filter_signal(jdsp.Signal(None, x, 48000), JMode.Summed)
    assert_close(summed.time_data.numpy(), np.asarray(jsummed.time_data), 5e-5, "LR summed")


@pytest.mark.parametrize("mode", ["zero_phase", "zi"])
def test_lr_filterbank_zero_phase_and_state_match_jax(mode):
    kw = dict(zero_phase=True) if mode == "zero_phase" else dict(activate_zi=True)
    lr = filterbanks.linkwitz_riley_crossovers([500, 1500], [4, 2], 8000)
    jlr = jdsp.filterbanks.linkwitz_riley_crossovers([500, 1500], [4, 2], 8000)
    x = (RNG.standard_normal((1500, 2)) * 0.3).astype(np.float32)
    for _ in range(2 if mode == "zi" else 1):  # the second call starts from the states
        par = lr.filter_signal(Signal(None, x, 8000), FilterBankMode.Parallel, **kw)
        jpar = jlr.filter_signal(jdsp.Signal(None, x, 8000), JMode.Parallel, **kw)
        for b, jb in zip(par.bands, jpar.bands):
            assert_close(b.time_data.numpy(), np.asarray(jb.time_data), 5e-5, f"LR {mode}")
    if mode == "zi":
        np.testing.assert_allclose(lr.channels_zi[1][0][0][0], jlr.channels_zi[1][0][0][0],
                                   atol=1e-5)


@pytest.mark.parametrize(
    "freqs,orders,fs",
    [([250, 1000, 4000], [4, 4, 4], FS), ([500, 1500], [4, 2], 8000), ([1000], [8], 48000),
     ([100, 1000], [8, 8], 48000), ([500, 2000], [4, 2], 8000)],
    ids=["lr4-44k1", "lr4-lr2-8k", "lr8-one-crossover", "lr8-low-allpass", "lr2-at-fs4"],
)
def test_lr_cascade_bank_matches_the_chain(monkeypatch, freqs, orders, fs):
    """The bands' composite SOS cascades (`LRFilterBank._cascade_bank`, the
    split's route on a float32 CUDA signal) through scipy's float64
    ``sosfilt`` equal the sequential LP/HP/all-pass chain to 1e-9 of each
    band's peak. The bank's plain version in float32, through
    `filter_signal` on that route (the kernel replaced by its plain
    version), is within 5e-6 of it, one bank call a split, Parallel and
    Summed. LR8 at 100 Hz puts the all-pass's poles close to DC; the LR2
    at fs/4 has the pure delay z⁻¹ as its all-pass."""
    lr = filterbanks.linkwitz_riley_crossovers(freqs, orders, fs)
    bank = lr._cascade_bank
    assert bank.shape[0] == lr.number_of_bands
    x = (RNG.standard_normal((6000, 2)) * 0.3).astype(np.float32)
    want = lr_chain(lr, x.T.astype(np.float64))
    for b, w in enumerate(want):
        assert _rel(sosfilt(bank[b], x.T.astype(np.float64), axis=-1), w) <= 1e-9
    calls = []

    def counted(*args):
        calls.append(1)
        return cuda_iir_bank.sosfilt_bank_lead_plain(*args)

    monkeypatch.setattr(iir_block, "sosfilt_bank_lead_cuda", counted)
    monkeypatch.setattr(_config, "use_kernel", lambda name, t: name == "bank")
    par = lr.filter_signal(Signal(None, x, fs), FilterBankMode.Parallel)
    summed = lr.filter_signal(Signal(None, x, fs), FilterBankMode.Summed)
    assert len(calls) == 2
    for band, w in zip(par.bands, want, strict=True):
        assert _rel(band.time_data.numpy().T, w) <= 5e-6
    assert _rel(summed.time_data.numpy().T, np.sum(want, axis=0)) <= 5e-6


def test_lr_odd_orders_keep_frequency_sampling(monkeypatch):
    """Odd orders (not Linkwitz-Riley) have no all-pass cascade: the bank is
    None and the split keeps frequency sampling where the kernel rule
    holds, with no bank call, equal to the route outside it."""
    lr = filterbanks.linkwitz_riley_crossovers([500, 2000], [3, 3], 16000)
    assert lr._cascade_bank is None
    x = (RNG.standard_normal((4000, 2)) * 0.3).astype(np.float32)
    want = lr.filter_signal(Signal(None, x, 16000), FilterBankMode.Parallel)
    monkeypatch.setattr(iir_block, "sosfilt_bank_lead_cuda", lambda *a: pytest.fail("bank call"))
    monkeypatch.setattr(_config, "use_kernel", lambda name, t: name == "bank")
    got = lr.filter_signal(Signal(None, x, 16000), FilterBankMode.Parallel)
    for g, w in zip(got.bands, want.bands, strict=True):
        np.testing.assert_array_equal(g.time_data, w.time_data)


@pytest.mark.parametrize("fs,rng_hz", [(5000, [500, 1000]), (FS, [500, 4000]),
                                       (FS, [500, 2000]), (48000, [500, 2000])],
                         ids=["5k", "44k1", "44k1-500-2000", "48k-500-2000"])
def test_gammatone_matches_jax(fs, rng_hz):
    """The 500-2000 Hz banks at 44.1 and 48 kHz are where the gain
    iteration amplifies a last-bit difference in the coefficients: they
    hold the coefficients bit-identical and the gains to 1e-9."""
    gt = filterbanks.auditory_filters_gammatone(rng_hz, sampling_rate_hz=fs)
    jgt = jdsp.filterbanks.auditory_filters_gammatone(rng_hz, sampling_rate_hz=fs)
    np.testing.assert_array_equal(gt._delays, jgt._delays)
    np.testing.assert_array_equal(gt._coefficients, jgt._coefficients)
    # parity: at 44.1 kHz the upper bands' phase factors and every gain are
    # NaN on both sides (their responses' last samples underflow)
    np.testing.assert_allclose(gt._phase_factors, jgt._phase_factors, rtol=1e-12)
    np.testing.assert_allclose(gt._gains, jgt._gains, rtol=1e-9)
    x = (RNG.standard_normal((2000, 2)) * 0.2).astype(np.float32)
    mb = gt.filter_signal(Signal(None, x, fs), FilterBankMode.Parallel)
    jmb = jgt.filter_signal(jdsp.Signal(None, x, fs), JMode.Parallel)
    assert mb.is_complex_signal and mb.number_of_bands == jmb.number_of_bands
    for b, jb in zip(mb.bands, jmb.bands):
        assert_close(_band_data(b), _jax_band_data(jb), 2e-4, "gammatone band")
    rec = gt.reconstruct(mb).time_data.numpy()
    jrec = np.asarray(jgt.reconstruct(jmb).time_data)
    if rng_hz[1] <= 2000:
        assert np.isfinite(rec).all()
        assert_close(rec, jrec, 2e-4, "gammatone reconstruct")
    else:
        assert np.isnan(rec).all() and np.isnan(jrec).all()


def test_filterbank_chain_matches_jax_and_scipy():
    """`tools.filterbank_chain` at a small size (0.1 s × 2 channels at 44.1
    kHz) against the same chain through the JAX package, and its 1/3-octave
    bands against scipy's float64 sosfilt."""
    sig = filterbank_chain.signal(seconds=0.1, channels=2, device="cpu")
    lr, gt, third = filterbank_chain.banks()
    lr_b, gt_b, res, third_b = filterbank_chain.run(sig, lr, gt, third)
    x = sig.time_data.numpy()
    jsig = jdsp.Signal(None, x, FS)
    jlr = jdsp.filterbanks.linkwitz_riley_crossovers([250.0, 1000.0, 4000.0], [4, 4, 4], FS)
    jgt = jdsp.filterbanks.auditory_filters_gammatone([500.0, 4000.0], sampling_rate_hz=FS)
    for got, want, tol in (
        (lr_b, jlr.filter_signal(jsig, JMode.Parallel), 5e-5),
        (gt_b, _port_bank(jgt).filter_signal(sig, FilterBankMode.Parallel), 1e-6),
        (gt_b, jgt.filter_signal(jsig, JMode.Parallel), 2e-4),
    ):
        assert got.number_of_bands == want.number_of_bands
        for b, w in zip(got.bands, want.bands):
            want_td = _band_data(w) if isinstance(w, Signal) else _jax_band_data(w)
            assert_close(_band_data(b), want_td, tol, "chain band")
    jres = jdsp.resample(jsig, FS // 3)
    assert_close(res.time_data.numpy(), np.asarray(jres.time_data), 2e-6, "chain resample")
    bank = _third_octave_bank()
    assert third_b.number_of_bands == len(bank) == 28
    for b, band in enumerate(third_b.bands):
        assert _rel(band.time_data.numpy().T, sosfilt(bank[b], x.T.astype(np.float64),
                                                        axis=-1)) < 5e-6


def test_filterbank_modules_import_without_jax_or_triton():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import dsptoolbox_tpu_torch.filterbanks, dsptoolbox_tpu_torch.tools.filterbank_chain\n"
        "import dsptoolbox_tpu_torch.standard.resampling, dsptoolbox_tpu_torch.ops.cuda_iir_bank\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dsptoolbox_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ======== C6 through the classes: zero phase and a streamed Filter ==========
@pytest.mark.parametrize("band", [(31.5, 1, 6, 48000), (63, 1, 4, 48000), (25, 3, 4, 44100)],
                         ids=lambda b: f"{b[0]}Hz-1/{b[1]}")
def test_low_band_zero_phase_and_streamed_filter_meet_scipy_f64(band):
    """`Filter.filter_signal` (zero phase, and ``activate_zi`` over 16
    chunks of 1024 samples) and `FilterBank.filter_signal(zero_phase=True)`
    on float32 noise (σ 0.1, 2 channels, seed 1) within 5e-6 of scipy's
    float64 ``sosfiltfilt`` / ``sosfilt``; the filter keeps its state in
    float64 between calls."""
    from scipy.signal import sosfilt_zi

    fc, fraction, order, fs = band
    fb, _, _ = filterbanks.fractional_octave_bands([fc, fc * 1.01], fraction, order, fs)
    sos = np.asarray(fb.filters[0].sos)
    x = (0.1 * np.random.default_rng(1).standard_normal((16384, 2))).astype(np.float32)
    x64 = x.T.astype(np.float64)
    zp = fb.filters[0].filter_signal(Signal(None, x, fs), zero_phase=True)
    assert _rel(zp.time_data.numpy().T, sosfiltfilt(sos, x64, axis=-1)) < 5e-6
    zp_bank = fb.filter_signal(Signal(None, x, fs), FilterBankMode.Parallel, zero_phase=True)
    assert _rel(zp_bank.bands[0].time_data.numpy().T, sosfiltfilt(sos, x64, axis=-1)) < 5e-6
    filt = Filter.from_sos(sos, fs)
    parts = [filt.filter_signal(Signal(None, x[k * 1024:(k + 1) * 1024], fs),
                                activate_zi=True).time_data.numpy() for k in range(16)]
    assert all(z.dtype == np.float64 for z in filt.zi)
    zi = np.stack([sosfilt_zi(sos)] * 2, axis=1)
    want = sosfilt(sos, x64, axis=-1, zi=zi)[0]
    assert _rel(np.concatenate(parts).T, want) < 5e-6


# ======== the rest of filterbanks/: designs, the reconstructing bank, QMF ===
def _both(fn):
    """``fn`` on the port's and the JAX package's modules."""
    import dsptoolbox_tpu_torch as dtt

    return fn(dtt), fn(jdsp)


_DESIGNS = {
    "weighting_a": lambda m: m.filterbanks.weighting_filter(True, sampling_rate_hz=48000),
    "weighting_c": lambda m: m.filterbanks.weighting_filter(False, sampling_rate_hz=48000),
    "pinking": lambda m: m.filterbanks.pinking_filter(500, FS),
    "gaussian": lambda m: m.filterbanks.gaussian_kernel(0.01, sampling_rate_hz=FS),
    "fractional_delay": lambda m: m.filterbanks.fractional_delay(0.4, 30, sampling_rate_hz=FS),
    "complementary_odd": lambda m: m.filterbanks.complementary_fir_filter(
        m.Filter.from_ba(np.hanning(65) / 32, [1.0], FS)),
    "complementary_even": lambda m: m.filterbanks.complementary_fir_filter(
        m.Filter.fir_filter(64, 1000, m.FilterPassType.Lowpass, FS)),
    **{f"matched_{t}": (lambda t: lambda m: m.filterbanks.matched_biquad(
        getattr(m.BiquadEqType, t), 1000.0, 5.0, 0.9, FS))(t)
       for t in ("Peaking", "Lowpass", "Highpass", "BandpassPeak", "BandpassSkirt",
                 "Lowshelf", "Highshelf")},
}


@pytest.mark.parametrize("name", list(_DESIGNS))
def test_filter_designs_of_filterbanks_match_jax(name):
    """Host designs at the JAX tests' bounds (`tests/test_filterbanks.py`:
    coefficients within 1e-10 relative, 1e-7 for the complementary FIR)
    and their impulse responses on the device within float32 rounding."""
    mine, ref = _both(_DESIGNS[name])
    assert mine.has_sos == ref.has_sos
    for got, want in zip([mine.sos] if mine.has_sos else mine.ba,
                         [ref.sos] if ref.has_sos else ref.ba):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10,
                                   atol=1e-7 if name.startswith("complementary") else 1e-12)
    ir_m = mine.get_ir(1024).time_data.numpy()
    ir_r = np.asarray(ref.get_ir(1024).time_data)
    assert _rel(ir_m, ir_r) <= 5e-4


@pytest.mark.parametrize("method,order_b", [("yule-walker", 0), ("burg", 0),
                                            ("yule-walker", 8), ("burg", 8)])
def test_arma_matches_jax(method, order_b):
    """AR by Yule-Walker or Burg in float64 (on the IR's device), MA by
    host least squares: the JAX package's coefficients within 1e-10."""
    rng = np.random.default_rng(21)
    t = np.arange(2048) / FS
    ir = (rng.standard_normal(2048) * np.exp(-t / 0.01)).astype(np.float32)
    ir[5] = 1.0
    mine, ref = _both(lambda m: m.filterbanks.arma(
        m.ImpulseResponse(None, ir[:, None], FS), 12, order_b, method))
    for got, want in zip(mine.ba, ref.ba):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10, atol=1e-10)


def test_reconstructing_bank_matches_jax_and_reconstructs():
    """The linear-phase FIR bank: every band within 1e-5 x peak of the JAX
    package's, and the summed bands equal to the input delayed by half the
    FIR length within 2e-4 (`tests/test_filterbanks.py:102`)."""
    x = (0.3 * np.random.default_rng(22).standard_normal((12000, 2))).astype(np.float32)
    kw = dict(octave_fraction=3, n_samples=2**11, sampling_rate_hz=FS)
    mine, ref = _both(lambda m: m.filterbanks.reconstructing_fractional_octave_bands(**kw))
    assert mine.number_of_filters == ref.number_of_filters
    mb_m = mine.filter_signal(Signal(None, x, FS), FilterBankMode.Parallel)
    mb_r = ref.filter_signal(jdsp.Signal(None, x, FS), JMode.Parallel)
    for bm, br in zip(mb_m.bands, mb_r.bands):
        assert _rel(bm.time_data.numpy(), np.asarray(br.time_data)) <= 1e-5
    summed = mine.filter_signal(Signal(None, x, FS), FilterBankMode.Summed).time_data.numpy()
    delay = len(mine.filters[0].ba[0]) // 2
    np.testing.assert_allclose(summed[delay:], x[:-delay], atol=2e-4)


@pytest.mark.parametrize("kind", ["fir", "iir"])
def test_qmf_crossover_matches_jax(kind):
    """Analysis with downsampling (Parallel, Summed) and the reconstruction
    with upsampling: 1e-5 x peak of the JAX package's; Sequential with
    downsampling refuses its second, decimated stage in both packages."""
    x = (0.3 * np.random.default_rng(23).standard_normal((6000, 2))).astype(np.float32)

    def lowpass(m):
        if kind == "fir":
            return m.Filter.from_ba(sig.firwin(63, 0.5), [1.0], FS)
        return m.Filter.iir_filter(order=5, frequency_hz=FS / 4,
                                   type_of_pass=m.FilterPassType.Lowpass,
                                   filter_design_method=m.IirDesignMethod.Butterworth,
                                   sampling_rate_hz=FS)

    mine, ref = _both(lambda m: m.filterbanks.qmf_crossover(lowpass(m)))
    s_m, s_r = Signal(None, x, FS), jdsp.Signal(None, x, FS)
    for f, sg, mode in ((mine, s_m, FilterBankMode.Sequential), (ref, s_r, JMode.Sequential)):
        with pytest.raises(AssertionError, match="Sampling rates"):
            f.filter_signal(sg, mode, downsample=True)
    for mode, jmode in ((FilterBankMode.Parallel, JMode.Parallel),
                        (FilterBankMode.Summed, JMode.Summed)):
        got = mine.filter_signal(s_m, mode, downsample=True)
        want = ref.filter_signal(s_r, jmode, downsample=True)
        pairs = zip(got.bands, want.bands) if mode == FilterBankMode.Parallel else \
            [(got, want)]
        for g, w in pairs:
            assert g.sampling_rate_hz == w.sampling_rate_hz == FS // 2
            assert _rel(g.time_data.numpy(), np.asarray(w.time_data)) <= 1e-5
    bands_m = mine.filter_signal(s_m, FilterBankMode.Parallel, downsample=True)
    bands_r = ref.filter_signal(s_r, JMode.Parallel, downsample=True)
    rec_m = mine.reconstruct_signal(bands_m, upsample=True)
    rec_r = ref.reconstruct_signal(bands_r, upsample=True)
    assert rec_m.sampling_rate_hz == FS
    assert _rel(rec_m.time_data.numpy(), np.asarray(rec_r.time_data)) <= 1e-5


def test_filterbank_plots_draw():
    """The LR bank's three plots from the dirac's bands: the magnitudes
    those of the JAX package within 1e-6 of the unit peak as amplitudes
    (float32 rounding of the bands), the phase and group delay finite with
    one line a band; the crossover's downsampled magnitude plot in each
    mode that runs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lr = filterbanks.linkwitz_riley_crossovers([500, 2000], 4, FS)
    jlr = jdsp.filterbanks.linkwitz_riley_crossovers([500, 2000], 4, FS)
    for name, args in (("plot_magnitude", (1024,)), ("plot_phase", (1024,)),
                       ("plot_group_delay", (1024,))):
        fig, ax = getattr(lr, name)(*args)
        jfig, jax_ax = getattr(jlr, name)(*args)
        assert len(ax.get_lines()) == len(jax_ax.get_lines()) == 3
        for line, jline in zip(ax.get_lines(), jax_ax.get_lines()):
            got, want = np.asarray(line.get_ydata()), np.asarray(jline.get_ydata())
            assert np.all(np.isfinite(got[1:]))
            if name == "plot_magnitude":
                np.testing.assert_allclose(10 ** (got / 20), 10 ** (want / 20), atol=1e-6)
        plt.close(fig)
        plt.close(jfig)
    fig, _ = lr.plot_magnitude(1024, FilterBankMode.Summed)
    plt.close(fig)
    qmf = filterbanks.qmf_crossover(Filter.from_ba(sig.firwin(63, 0.5), [1.0], FS))
    for mode in (FilterBankMode.Parallel, FilterBankMode.Summed):
        fig, _ = qmf.plot_magnitude(512, mode)
        plt.close(fig)

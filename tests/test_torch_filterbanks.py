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
from scipy.signal import butter, resample_poly, sosfilt, sosfiltfilt, upfirdn

import jax.numpy as jnp
from conftest import assert_close
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


def test_bank_switch_and_kernels_off():
    bank = _butter_bank()
    x = torch.from_numpy(RNG.standard_normal((2, 4096)).astype(np.float32))
    ops = iir_block.sosfilt_bank_operators(bank, 4096)
    _config.set_bank_kernel("on")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            iir_block.sosfilt_bank_apply(ops, x)
        with _config.kernels_off():
            assert _config.bank_kernel() == "off"
            iir_block.sosfilt_bank_apply(ops, x)
        assert _config.bank_kernel() == "on"
    finally:
        _config.set_bank_kernel("auto")
    with pytest.raises(ValueError):
        _config.set_bank_kernel("fast")
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

"""The rest of the port's IIR ops (`ops.iir`: `linear_recurrence`,
`lfilter`, `lfilter_zi`, `sosfilt_assoc`, `filtfilt_ba`; `ops.iir_freq`'s
bank by frequency sampling), the repaired ``ba`` paths of `Filter` (a
state of any order, zero phase), `Filter.filter_and_resample_signal`,
`helpers.smoothing.time_smoothing` and the EMA kernel's plain loop, on the
CPU against the JAX package at its tests' tolerances (2e-5 for
``lfilter``/``filtfilt_ba``, 5e-6 for the bank's frequency sampling, 2e-4
for ``time_smoothing``) and against scipy float64 where the JAX package's
float32 is no oracle (ROADMAP C3, C9). Up to 3 channels, T <= 48,000."""

import numpy as np
import pytest
import torch
from scipy import signal as ss

from conftest import assert_close
import jax.numpy as jnp
from dsptoolbox_tpu.classes import Filter as JFilter, Signal as JSignal
from dsptoolbox_tpu.helpers import smoothing as jsmooth
from dsptoolbox_tpu.ops import iir as jiir
from dsptoolbox_tpu.ops import iir_freq as jiir_freq
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch.classes import Filter, Signal
from dsptoolbox_tpu_torch.helpers import smoothing
from dsptoolbox_tpu_torch.ops import cuda_ema, cuda_iir, iir, iir_block, iir_freq
from dsptoolbox_tpu_torch.standard.enums import FilterCoefficientsType, FilterPassType

torch.set_num_threads(1)

FS = 48000
RNG = np.random.default_rng(16)
X = RNG.standard_normal((3, 48000)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _scale_rel(a, b) -> float:
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _ba(order, fc, btype="low"):
    return ss.butter(order, fc, btype=btype, fs=FS)


# ---- ops.iir -----------------------------------------------------------------

@pytest.mark.parametrize("with_zi", [False, True])
def test_linear_recurrence_matches_jax(with_zi):
    A = np.array([[0.5, 0.2, 0.0], [-0.3, 0.4, 0.1], [0.0, 0.2, -0.6]])
    Bx = RNG.standard_normal((300, 2, 3)).astype(np.float32)
    zi = RNG.standard_normal((2, 3)).astype(np.float32) if with_zi else None
    want = np.asarray(jiir.linear_recurrence(jnp.asarray(A, jnp.float32), jnp.asarray(Bx),
                                             None if zi is None else jnp.asarray(zi)))
    got = iir.linear_recurrence(A, torch.from_numpy(Bx),
                                None if zi is None else torch.from_numpy(zi))
    assert_close(got.numpy(), want, 2e-5)


def test_tdf2_system_is_the_jax_packages():
    b, a = _ba(5, 3000.0)
    for g, w in zip(iir._tdf2_system(b, a), jiir._tdf2_system(b, a)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(iir.lfilter_zi(b, a), jiir.lfilter_zi(b, a))


@pytest.mark.parametrize("case", ["order2_state", "order2", "order5", "fir_long", "fir_state"])
def test_lfilter_matches_jax(case):
    """The JAX package's routes where its float32 is sound: order <= 2 with
    and without a state, a higher order without one, an FIR by FFT
    convolution, an FIR of order 3 with a state (its scan is exact)."""
    x = X[:, :8000]
    zi = None
    if case.startswith("order2"):
        b, a = _ba(2, 1000.0)
    elif case == "order5":
        b, a = _ba(5, 3000.0)
    elif case == "fir_long":
        b, a = ss.firwin(101, 2000.0, fs=FS), np.array([1.0])
    else:
        b, a = np.array([0.4, 0.3, 0.2, 0.1]), np.array([1.0])
    if case in ("order2_state", "fir_state"):
        zi = iir.lfilter_zi(b, a) * x[:, :1]
    yj, zj = jiir.lfilter(b, a, jnp.asarray(x), None if zi is None else jnp.asarray(zi))
    y, zf = iir.lfilter(b, a, torch.from_numpy(x), zi=zi)
    assert_close(y.numpy(), np.asarray(yj), 2e-5)
    if zi is not None:
        assert_close(zf.numpy(), np.asarray(zj), 2e-5)
    assert zf.dtype == torch.float64 and zf.shape == (3, max(len(a), len(b)) - 1)


@pytest.mark.parametrize("order,fc,btype", [(4, 1000.0, "low"), (6, 200.0, "low"),
                                            (3, 1000.0, "low"), (6, 200.0, "high"),
                                            (4, [300.0, 3000.0], "bandpass")])
def test_stateful_lfilter_above_order_two_meets_scipy_float64(order, fc, btype):
    """The port's stateful route above order 2 (the SOS cascade of the
    zeros and polished poles, its state mapped to and from scipy's TDF2
    layout): within 5e-6 of scipy's float64 ``lfilter`` of the same
    ``(b, a)``, ``zf`` too, and a state handed to scipy and back continues
    both equally."""
    b, a = _ba(order, fc, btype)
    x = X.astype(np.float64)
    zi = ss.lfilter_zi(b, a) * x[:, :1]
    ref, zref = ss.lfilter(b, a, x, zi=zi)
    y, zf = iir.lfilter(b, a, torch.from_numpy(X), zi=zi)
    assert _scale_rel(y.numpy(), ref) <= 5e-6
    assert _scale_rel(zf.numpy(), zref) <= 5e-6
    # half through the port, the state to scipy for the rest, and back
    h = 24000
    y1, z1 = iir.lfilter(b, a, torch.from_numpy(X[:, :h]), zi=zi)
    y2, z2 = ss.lfilter(b, a, x[:, h:], zi=z1.numpy())
    assert _scale_rel(np.concatenate([y1.numpy(), y2], -1), ref) <= 5e-6
    y3, _ = iir.lfilter(b, a, torch.from_numpy(X[:, h:]),
                        zi=ss.lfilter(b, a, x[:, :h], zi=zi)[1])
    assert _scale_rel(y3.numpy(), ref[:, h:]) <= 5e-6


def test_companion_basis_blocks_diverge_where_the_cascade_does_not():
    """Why the stateful route runs the SOS cascade's basis: the block
    operators of order 6 at 200 Hz in the TDF2 companion basis have a
    spectral radius above 1 once formed in float64 (their exact one is
    0.86^(128/…) < 1), so a blocked recursion in that basis diverges."""
    b, a = _ba(6, 200.0)
    _, _, AL, _ = iir_block._abcd_operators(*iir_block._tdf2_abcd(b, a), 128)
    assert np.max(np.abs(np.linalg.eigvals(AL))) > 1.0
    sos, to_c, to_t = iir_block._ba_cascade((tuple(b), tuple(a)))
    np.testing.assert_allclose(to_t @ to_c, np.eye(6), atol=1e-9)


@pytest.mark.parametrize("T", [48000, 700, 5])
def test_stateful_long_fir_is_a_convolution_and_meets_scipy(T):
    """A stateful FIR above order 2 is one FFT convolution with its state
    added (no state-space system, whatever its order): a 1023-tap firwin
    lowpass against scipy's float64 ``lfilter``, ``y`` and ``zf``, also for
    a block shorter than the filter, and streamed in blocks = one call."""
    b = ss.firwin(1023, 1000.0, fs=FS)
    x = X[:2, :T]
    zi = RNG.standard_normal((2, 1022)) * 0.1
    ref, zref = ss.lfilter(b, [1.0], x.astype(np.float64), zi=zi)
    before = cuda_iir.launches
    y, zf = iir.lfilter(b, np.array([1.0]), torch.from_numpy(x), zi=zi)
    assert cuda_iir.launches == before
    assert y.dtype == torch.float32 and zf.dtype == torch.float64 and zf.shape == (2, 1022)
    assert _scale_rel(y.numpy(), ref) <= 5e-6
    assert _scale_rel(zf.numpy(), zref) <= 1e-12
    z, parts = zi, []
    for k in range(0, T, 4000):
        yk, z = iir.lfilter(b, [1.0], torch.from_numpy(x[:, k:k + 4000]), zi=z)
        parts.append(yk.numpy())
    assert _scale_rel(np.concatenate(parts, -1), y.numpy()) <= 1e-6


def test_high_order_state_takes_linear_recurrence():
    """Above 32 states the stateful ``ba`` runs `linear_recurrence` in
    float64 (B2's chain holds 32): order 34 against scipy float64."""
    poles = 0.6 * np.exp(1j * np.linspace(0.1, 3.0, 17))
    a = np.real(np.poly(np.r_[poles, poles.conj()]))
    b = RNG.standard_normal(35) * 0.1
    x = X[:2, :4000]
    zi = ss.lfilter_zi(b, a) * x[:, :1]
    ref, zref = ss.lfilter(b, a, x.astype(np.float64), zi=zi)
    before = cuda_iir.launches
    y, zf = iir.lfilter(b, a, torch.from_numpy(x), zi=zi)
    assert cuda_iir.launches == before
    assert _scale_rel(y.numpy(), ref) <= 5e-6
    assert _scale_rel(zf.numpy(), zref) <= 1e-9
    with pytest.raises(ValueError, match="32 states"):
        iir_block.lfilter_statespace(b, a, torch.from_numpy(x), zi)


def test_sosfilt_assoc_matches_jax():
    sos = ss.butter(4, 2000.0, fs=FS, output="sos")
    x = X[:, :6000]
    zi = np.broadcast_to(ss.sosfilt_zi(sos), (3, 2, 2)) * x[:, :1, None]
    yj, zj = jiir.sosfilt_assoc(sos, jnp.asarray(x), jnp.asarray(zi))
    y, zf = iir.sosfilt_assoc(sos, torch.from_numpy(x), zi)
    assert_close(y.numpy(), np.asarray(yj), 2e-5)
    assert_close(zf.numpy(), np.asarray(zj), 2e-5)
    assert zf.shape == (3, 2, 2)


@pytest.mark.parametrize("order,fc", [(2, 1000.0), (1, 300.0), (4, 1000.0)])
def test_filtfilt_ba_matches_jax_and_scipy(order, fc):
    b, a = _ba(order, fc)
    x = X[:, :12000]
    y = iir.filtfilt_ba(b, a, torch.from_numpy(x))
    assert _scale_rel(y.numpy(), ss.filtfilt(b, a, x.astype(np.float64))) <= 5e-6
    if order <= 2:
        assert_close(y.numpy(), np.asarray(jiir.filtfilt_ba(b, a, jnp.asarray(x))), 2e-5)
    with pytest.raises(ValueError, match="too short") as got:
        iir.filtfilt_ba(b, a, torch.from_numpy(x[:, :3 * max(len(a), len(b))]))
    with pytest.raises(ValueError) as want:
        jiir.filtfilt_ba(b, a, jnp.asarray(x[:, :3 * max(len(a), len(b))]))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("order,fc,T,non_finite,first", [
    (4, 1000.0, 4800, 3064, 3249), (4, 1000.0, 48000, 89464, 3249),
    (6, 200.0, 48000, 95534, 233)])
def test_jax_float32_stateful_lfilter_diverges_where_port_meets_scipy(order, fc, T, non_finite,
                                                                       first):
    """ROADMAP C9: above order 2 with a state, the JAX package's float32
    associative scan on the companion form runs to inf/NaN at low cutoffs
    (two channels of white noise, `lfilter_zi` start: the table's counts of
    non-finite samples and the first one); the port stays within 5e-6 of
    scipy's float64 ``lfilter`` on the same ``(b, a)``."""
    x = X[:2, :T]
    b, a = _ba(order, fc)
    zi = ss.lfilter_zi(b, a) * x[:, :1]
    ref = ss.lfilter(b, a, x.astype(np.float64), zi=zi)[0]
    yj = np.asarray(jiir.lfilter(b, a, jnp.asarray(x), jnp.asarray(zi))[0])
    bad = ~np.isfinite(yj)
    assert int(bad.sum()) == non_finite and int(np.argmax(bad.any(0))) == first
    y = iir.lfilter(b, a, torch.from_numpy(x), zi=zi)[0].numpy()
    assert np.isfinite(y).all() and _scale_rel(y, ref) <= 5e-6


def test_jax_float32_stateful_lfilter_agrees_where_its_scan_is_sound():
    """Order 4 at 5 kHz, where the JAX package's scan stays finite: the
    port agrees with it at its tests' 2e-5."""
    x = X[:2, :4800]
    b, a = _ba(4, 5000.0)
    zi = ss.lfilter_zi(b, a) * x[:, :1]
    yj = np.asarray(jiir.lfilter(b, a, jnp.asarray(x), jnp.asarray(zi))[0])
    y = iir.lfilter(b, a, torch.from_numpy(x), zi=zi)[0].numpy()
    assert np.isfinite(yj).all()
    assert_close(y, yj, 2e-5)


# ---- ops.iir_freq ------------------------------------------------------------

@pytest.mark.parametrize("complex_input", [False, True])
def test_sosfilt_bank_freq_meets_scipy_and_jax(complex_input):
    bank = np.stack([ss.butter(4, f, output="sos") for f in (0.1, 0.3, 0.5, 0.8)])
    x = X[:2, :5000].astype(np.complex64 if complex_input else np.float32)
    if complex_input:
        x = x + 1j * X[1:3, :5000]
    y = iir_freq.sosfilt_bank_freq(bank, torch.from_numpy(x))
    want = np.asarray(jiir_freq.sosfilt_bank_freq(bank, jnp.asarray(x)))
    assert y.shape == (4, 2, 5000)
    for i in range(4):
        assert _scale_rel(y[i].numpy(), ss.sosfilt(bank[i], x.astype(np.complex128
                          if complex_input else np.float64), axis=-1)) < 5e-6
    assert_close(y.numpy(), want, 5e-6)
    H = iir_freq.sos_bank_freq_response(bank, 1024, False)
    assert_close(H.numpy(), np.asarray(jiir_freq.sos_bank_freq_response(bank, 1024, False)),
                 5e-6)


# ---- Filter: the repaired ba paths ------------------------------------------

@pytest.mark.parametrize("order,fc", [(4, 1000.0), (6, 200.0)])
def test_stateful_ba_filter_streams_and_meets_scipy(order, fc):
    """R1: a stateful ``ba`` above order 2 through `Filter`, streamed in
    blocks, equals one call on the whole signal, and both are within 5e-6
    of scipy's float64 ``lfilter`` of the same coefficients (it raised
    before)."""
    b, a = _ba(order, fc)
    sig = Signal(None, X.T, FS)
    whole = Filter.from_ba(b, a, FS).filter_signal(sig, activate_zi=True).time_data.numpy()
    streamed = Filter.from_ba(b, a, FS)
    parts = [streamed.filter_signal(Signal(None, X[:, k:k + 4800].T, FS),
                                    activate_zi=True).time_data.numpy()
             for k in range(0, X.shape[1], 4800)]
    assert _scale_rel(np.concatenate(parts), whole) <= 1e-6
    # `Filter.initialize_zi` seeds every channel with the unit step's steady state
    ref = ss.lfilter(b, a, X.astype(np.float64), zi=np.tile(ss.lfilter_zi(b, a), (3, 1)))[0].T
    assert _scale_rel(whole, ref) <= 5e-6
    assert len(streamed.zi) == 3 and streamed.zi[0].shape == (order,)


def test_interleaved_streams_of_one_filter_design_stay_exact():
    """Two `Filter`s of the same ``(b, a)`` streamed in turn, one of them
    on a subset of channels part of the time: each keeps its own exact
    cascade states, so each stream equals its one call on the whole
    signal as a single stream does; a ``zi`` set by hand is mapped into
    the cascade and the result meets scipy from that state."""
    b, a = _ba(6, 200.0)
    sig = Signal(None, X.T, FS)
    whole = Filter.from_ba(b, a, FS).filter_signal(sig, activate_zi=True).time_data.numpy()
    f, g = Filter.from_ba(b, a, FS), Filter.from_ba(b, a, FS)
    parts_f, parts_g = [], []
    for k in range(0, X.shape[1], 4800):
        block = Signal(None, X[:, k:k + 4800].T, FS)
        parts_f.append(f.filter_signal(block, activate_zi=True).time_data.numpy())
        # g: channel 1 alone, then channels 0 and 2, on every block
        y1 = g.filter_signal(block, channels=[1], activate_zi=True).time_data.numpy()
        y02 = g.filter_signal(block, channels=[0, 2], activate_zi=True).time_data.numpy()
        parts_g.append(np.stack([y02[:, 0], y1[:, 1], y02[:, 2]], axis=1))
    assert _scale_rel(np.concatenate(parts_f), whole) <= 1e-6
    assert _scale_rel(np.concatenate(parts_g), whole) <= 1e-6
    # a state set by hand: mapped, and the run meets scipy from it
    f.zi = [z * 0.5 for z in f.zi]
    x = X[:, :4800]
    got = f.filter_signal(Signal(None, x.T, FS), activate_zi=True).time_data.numpy()
    ref = ss.lfilter(b, a, x.astype(np.float64), zi=np.stack(
        [z for z in ss.lfilter(b, a, X.astype(np.float64),
                               zi=np.tile(ss.lfilter_zi(b, a), (3, 1)))[1] * 0.5]))[0]
    assert _scale_rel(got, ref.T) <= 5e-6


@pytest.mark.parametrize("kind", ["iir1", "iir2", "iir4", "fir"])
def test_zero_phase_ba_meets_scipy_filtfilt(kind):
    """R2: zero-phase ``ba`` filtering (it raised before): the FIR in
    convolution form, the IIR through `filtfilt_ba`; within 5e-6 of scipy's
    float64 ``filtfilt``, and up to order 2 within 2e-5 of the JAX
    package."""
    if kind == "fir":
        b, a = ss.firwin(255, 3000.0, fs=FS), np.array([1.0])
    else:
        b, a = _ba(int(kind[-1]), 800.0)
    x = X[:, :16000]
    got = Filter.from_ba(b, a, FS).filter_signal(Signal(None, x.T, FS), zero_phase=True)
    ref = ss.filtfilt(b, a, x.astype(np.float64)).T
    assert _scale_rel(got.time_data.numpy(), ref) <= 5e-6
    if kind != "iir4":
        want = JFilter.from_ba(b, a, FS).filter_signal(JSignal(None, x.T, FS), zero_phase=True)
        assert_close(got.time_data.numpy(), np.asarray(want.time_data), 2e-5)


@pytest.mark.parametrize("kind,new_fs", [("fir", 16000), ("fir", 96000), ("iir", 16000),
                                         ("iir", 96000)])
def test_filter_and_resample_signal_matches_jax(kind, new_fs):
    x = X[:2, :6000]
    filt_fs = FS if new_fs < FS else new_fs
    if kind == "fir":
        p = Filter.fir_filter(64, 7000.0, FilterPassType.Lowpass, filt_fs)
        j = JFilter.fir_filter(64, 7000.0, jenums().FilterPassType.Lowpass, filt_fs)
        np.testing.assert_array_equal(p.ba[0], j.ba[0])
    else:
        p = Filter.iir_filter(4, 7000.0, FilterPassType.Lowpass, filt_fs)
        j = JFilter.iir_filter(4, 7000.0, jenums().FilterPassType.Lowpass, filt_fs)
    got = p.filter_and_resample_signal(Signal(None, x.T, FS), new_fs)
    want = j.filter_and_resample_signal(JSignal(None, x.T, FS), new_fs)
    assert got.sampling_rate_hz == want.sampling_rate_hz == new_fs
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 2e-5)


def jenums():
    from dsptoolbox_tpu.standard import enums

    return enums


# ---- time smoothing ----------------------------------------------------------

@pytest.mark.parametrize("descending", [None, 0.2])
def test_time_smoothing_matches_jax_and_float64(descending):
    """Both forms against the JAX package (2e-4, `tests/test_helpers.py`)
    and a float64 numpy recursion (1e-5 scale-relative: float32 rounding
    of a contracting recursion)."""
    x = (X[:, :20000] ** 2).astype(np.float32)
    got = smoothing.time_smoothing(torch.from_numpy(x), FS, 0.005, descending)
    want = np.asarray(jsmooth.time_smoothing(jnp.asarray(x), FS, 0.005, descending))
    assert_close(got.numpy(), want, 2e-4)
    alpha = smoothing.get_smoothing_factor_ema(0.005, FS)
    beta = alpha if descending is None else smoothing.get_smoothing_factor_ema(descending, FS)
    ref = np.empty(x.shape)
    xd = x.astype(np.float64)
    carry = xd[:, 0].copy()
    ref[:, 0] = carry
    for t in range(1, x.shape[1]):
        coeff = np.where(xd[:, t] > carry, alpha, beta) if descending else alpha
        carry = carry + coeff * (xd[:, t] - carry)
        ref[:, t] = carry
    assert _scale_rel(got.numpy(), ref) <= 1e-5
    assert got.shape == x.shape
    # along another axis
    got_t = smoothing.time_smoothing(torch.from_numpy(x.T.copy()), FS, 0.005, descending, axis=0)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy().T)


def test_ema_plain_loop_is_the_scan_and_the_switch_holds(monkeypatch):
    x = torch.from_numpy((X[:2, :3000] ** 2).astype(np.float32))
    y = cuda_ema.ema_attack_release_plain(x, 0.3, 0.01)
    assert torch.equal(y[:, 0], x[:, 0])
    # one step by hand, in float32
    a = torch.where(x[:, 1] > x[:, 0], torch.tensor(0.3), torch.tensor(0.01))
    assert torch.equal(y[:, 1], x[:, 0] + a * (x[:, 1] - x[:, 0]))
    before = cuda_ema.launches
    assert torch.equal(cuda_ema.ema_attack_release(x, 0.3, 0.01), y)
    assert cuda_ema.launches == before
    asked = []
    monkeypatch.setattr(_config, "use_kernel", lambda name, t: asked.append(name) or False)
    assert torch.equal(cuda_ema.ema_attack_release(x, 0.3, 0.01), y)
    assert asked == ["ema"] and cuda_ema.launches == before

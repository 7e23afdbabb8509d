"""The port's streaming filters (`dsptoolbox_tpu_torch.realtime`) against the
JAX package's (`dsptoolbox_tpu.realtime`) on the CPU, on the same seeded
numpy inputs, and against scipy float64 where the JAX package's float32
stateful ``lfilter`` runs to inf/NaN (ROADMAP C9). Sizes are small: at most
2 channels, 48,000 samples, order 6.

Tolerances: per-sample host code and the lattice, warped IIR and designer
arithmetic equal (the same numpy operations); block FIR convolutions 1e-5;
the SVF 1e-5 x peak against the JAX scan and 1e-6 x peak against a float64
loop; the warped FIR and the Kautz filter 1e-5 x peak; the parallel filter
1e-5 x its largest section's output; the exponential average 1e-6 x peak;
IIR streams 1e-5 (order <= 2) and 5e-6 against scipy float64 above."""

import numpy as np
import pytest
import scipy.signal as sig
import torch
from scipy.linalg import lstsq

import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu import realtime as jrt
from dsptoolbox_tpu_torch import _config, realtime as rt
from dsptoolbox_tpu_torch.classes import ImpulseResponse, Signal
from dsptoolbox_tpu_torch.ops import cuda_ema, cuda_iir

torch.set_num_threads(1)

FS = 48000


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port puts numpy data on the default device, "cuda" out of the
    box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _noise(shape, seed=0, scale=0.3):
    return np.random.default_rng(seed).standard_normal(shape) * scale


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _stream(f, x, block, channel=0):
    """``f.process_block`` over consecutive blocks of ``x (T,)``, joined."""
    return np.concatenate([np.asarray(f.process_block(x[i:i + block], channel))
                           for i in range(0, len(x), block)])


# ======== per-sample host code: the JAX package's arithmetic ================
def _sample_pairs():
    b2, a2 = sig.butter(2, 0.2)
    b4, a4 = sig.butter(4, 0.3)
    A, B, C, D = sig.tf2ss(*sig.butter(2, 0.25))
    return {
        "iir2": lambda m: m.IIRFilter(b2, a2),
        "iir4": lambda m: m.IIRFilter(b4, a4),
        "fir": lambda m: m.FIRFilter(sig.firwin(31, 0.3)),
        "ema": lambda m: m.ExponentialAverageFilter(0.01, 0.05, FS),
        "chain": lambda m: m.FilterChain([m.IIRFilter(b2, a2),
                                          m.IIRFilter(*sig.butter(2, 0.3, "highpass"))]),
        "state_space": lambda m: m.StateSpaceFilter(A, B, C, D),
        "warped_fir": lambda m: m.WarpedFIR(sig.firwin(16, 0.3), 0.6, FS),
        "warped_iir": lambda m: m.WarpedIIR(b2, a2, 0.4, FS),
        "svf": lambda m: m.StateVariableFilter(1000.0, 0.7, FS),
        "kautz": lambda m: m.KautzFilter(np.array([0.6 + 0.4j, 0.3 + 0.1j, 0.5]), FS),
    }


@pytest.mark.parametrize("name", list(_sample_pairs()))
def test_process_sample_equals_the_jax_package(name):
    make = _sample_pairs()[name]
    mine, ref = make(rt), make(jrt)
    for f in (mine, ref):
        f.set_n_channels(2)
    x = _noise((300, 2), seed=1)
    for t in range(300):
        for ch in (0, 1):
            got, want = mine.process_sample(x[t, ch], ch), ref.process_sample(x[t, ch], ch)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_lattice_ladder_filters_equal_the_jax_package():
    """Coefficients (ba, SOS, FIR) and filtering, sample by sample, equal
    to the JAX package's; the reference-named aliases too."""
    from dsptoolbox_tpu.classes import lattice_ladder_filter as jll
    from dsptoolbox_tpu_torch.classes import lattice_ladder_filter as ll
    from dsptoolbox_tpu_torch.realtime import misc

    b, a = np.array([1, 3, 3, 1.0]) / 10, np.array([1, -0.9, 0.64, -0.576])
    for got, want in ((misc.lattice_ladder_coefficients_iir(b, a),
                       jrt.misc.lattice_ladder_coefficients_iir(b, a)),
                      (ll._get_lattice_ladder_coefficients_iir(b, a),
                       jll._get_lattice_ladder_coefficients_iir(b, a))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    sos = sig.butter(4, 0.2, output="sos")
    for g, w in zip(ll._get_lattice_ladder_coefficients_iir_sos(sos),
                    jrt.misc.lattice_ladder_coefficients_iir_sos(sos)):
        np.testing.assert_array_equal(g, w)
    x = _noise((600, 2), seed=2).astype(np.float32)
    designs = [
        lambda m: m.Filter.iir_filter(order=4, frequency_hz=1000,
                                      type_of_pass=m.FilterPassType.Lowpass,
                                      filter_design_method=m.IirDesignMethod.Bessel,
                                      sampling_rate_hz=FS),
        lambda m: m.Filter.from_ba(b, a, FS),
        lambda m: m.Filter.from_ba(np.array([1.0, 0.5, 0.2, -0.1]), [1.0], FS),
    ]
    import dsptoolbox_tpu_torch as dtt

    for design in designs:
        mine = rt.LatticeLadderFilter.from_filter(design(dtt))
        ref = jrt.LatticeLadderFilter.from_filter(design(jdsp))
        got = mine.filter_signal(Signal(None, x, FS)).time_data.numpy()
        want = np.asarray(ref.filter_signal(jdsp.Signal(None, x, FS)).time_data)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        rt.LatticeLadderFilter(*misc.lattice_ladder_coefficients_iir(b, a), FS)
        .filter_signal(Signal(None, x[:, :1], FS)).time_data.numpy()[:, 0],
        sig.lfilter(b, a, x[:, 0].astype(np.float64)), atol=1e-6)


def test_warped_iir_equals_the_jax_package_and_restores_its_buffer():
    b, a = sig.butter(2, 0.3)
    x = _noise((500, 2), seed=3).astype(np.float32)
    mine, ref = rt.WarpedIIR(b, a, 0.4, FS), jrt.WarpedIIR(b, a, 0.4, FS)
    mine.set_n_channels(2)
    mine.buffer[:] = 0.25
    got = mine.filter_signal(Signal(None, x, FS)).time_data.numpy()
    want = np.asarray(ref.filter_signal(jdsp.Signal(None, x, FS)).time_data)
    np.testing.assert_array_equal(got, want)
    assert np.all(mine.buffer == 0.25)


# ======== IIRFilter blocks: ops.iir.lfilter with the channel's state ========
@pytest.mark.parametrize("order,fc", [(1, 300.0), (2, 1000.0), (2, 40.0)])
def test_iir_block_stream_low_orders_match_the_jax_package(order, fc):
    """Order <= 2 within 1e-5 of the JAX package's stream and of scipy's
    float64 lfilter; at 40 Hz the JAX package's float32 scan is itself
    1.9e-4 off scipy, so there the stream is held to scipy alone."""
    b, a = sig.butter(order, fc, fs=FS)
    x = _noise(8192, seed=order)
    mine, ref = rt.IIRFilter(b, a), jrt.IIRFilter(b, a)
    got, want = _stream(mine, x, 512), _stream(ref, x, 512)
    np.testing.assert_allclose(got, sig.lfilter(b, a, x), atol=1e-5)
    if fc > 100.0:
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(mine.state, ref.state, atol=1e-5)


@pytest.mark.parametrize("order,fc", [(4, 1000.0), (6, 200.0), (3, 1000.0), (4, 5000.0)])
def test_iir_block_stream_above_order_two_meets_scipy_float64(order, fc):
    """Above order 2 the stream runs the exact cascade (ROADMAP C9: the JAX
    package's float32 stateful lfilter runs to inf/NaN at low cutoffs), its
    state on the block's device, handing on the cascade's own state: 5e-6
    of the output's scale against scipy's float64 lfilter over 48,000
    samples in blocks of 1024 (the last one partial); where the JAX package
    stays finite (order 4 at 5 kHz) against it too."""
    b, a = sig.butter(order, fc, fs=FS)
    x = _noise(48000, seed=order).astype(np.float32)
    mine = rt.IIRFilter(b, a)
    got = _stream(mine, torch.from_numpy(x), 1024)
    want = sig.lfilter(b, a, x.astype(np.float64))
    assert _rel(got, want) <= 5e-6
    assert mine._host_state is None  # the state stayed on the device
    np.testing.assert_allclose(mine.state[:, 0], sig.lfilter(
        b, a, x.astype(np.float64), zi=np.zeros(order))[1], atol=5e-6 * np.abs(want).max())
    if fc == 5000.0:
        ref = jrt.IIRFilter(b, a)
        assert _rel(got, _stream(ref, x, 1024)) <= 5e-6


def test_iir_state_carried_from_the_jax_package_and_read_mid_stream():
    """Half a stream through the JAX filter, its ``state`` copied into the
    port's, the rest streamed: one JAX stream (order 2). Above order 2, a
    stream whose state is read (fetched to the host) and handed back
    unchanged continues from its exact cascade state: equal bit for bit to
    the uninterrupted stream; a changed state is mapped anew."""
    b, a = sig.butter(2, 800.0, fs=FS)
    x = _noise((4096, 2), seed=5)
    ref, half = jrt.IIRFilter(b, a), jrt.IIRFilter(b, a)
    for f in (ref, half):
        f.set_n_channels(2)
    want = np.stack([_stream(ref, x[:, c], 256, c) for c in (0, 1)], axis=1)
    first = np.stack([_stream(half, x[:2048, c], 256, c) for c in (0, 1)], axis=1)
    mine = rt.IIRFilter(b, a)
    mine.set_n_channels(2)
    mine.state = half.state
    rest = np.stack([_stream(mine, x[2048:, c], 256, c) for c in (0, 1)], axis=1)
    np.testing.assert_allclose(np.concatenate([first, rest]), want, atol=1e-5)

    b, a = sig.butter(4, 1000.0, fs=FS)
    x = torch.from_numpy(_noise(8192, seed=6).astype(np.float32))
    whole, read = rt.IIRFilter(b, a), rt.IIRFilter(b, a)
    y_whole = _stream(whole, x, 1024)
    parts = []
    for i in range(0, 8192, 1024):
        parts.append(np.asarray(read.process_block(x[i:i + 1024], 0)))
        read.state = read.state.copy()  # fetched and handed back unchanged
    np.testing.assert_array_equal(np.concatenate(parts), y_whole)
    moved = rt.IIRFilter(b, a)
    _stream(moved, x[:4096], 1024)
    moved.state = moved.state * 0.5  # a new state: mapped into the cascade
    y = np.asarray(moved.process_block(x[4096:], 0))
    zi = sig.lfilter(b, a, x[:4096].double().numpy(), zi=np.zeros(4))[1] * 0.5
    want = sig.lfilter(b, a, x[4096:].double().numpy(), zi=zi)[0]
    assert _rel(y, want) <= 5e-6


def test_iir_block_stream_launches_no_kernel_on_the_cpu():
    before = cuda_iir.launches
    f = rt.IIRFilter(*sig.butter(4, 1000.0, fs=FS))
    _stream(f, torch.from_numpy(_noise(4096).astype(np.float32)), 1024)
    f.reset_state()
    assert np.all(f.state == 0) and cuda_iir.launches == before


# ======== FIR block convolutions: torch.fft on the device ===================
@pytest.mark.parametrize("kind", ["overlap_save", "partitioned", "multichannel"])
def test_fir_block_convolutions_match_the_jax_package_and_scipy(kind):
    x = _noise((1024, 2), seed=7)
    if kind == "multichannel":
        firs = np.stack([sig.firwin(300, 0.25), sig.firwin(300, 0.5)], axis=-1)
        mine, ref = (m.FIRUniformPartitionedMultichannel(firs) for m in (rt, jrt))
        for f in (mine, ref):
            f.prepare(128)
        got = np.concatenate([np.asarray(mine.process_block(x[i:i + 128]))
                              for i in range(0, 1024, 128)])
        want = np.concatenate([np.asarray(ref.process_block(x[i:i + 128]))
                               for i in range(0, 1024, 128)])
        scipy_out = np.stack([sig.lfilter(firs[:, c], [1.0], x[:, c]) for c in (0, 1)], 1)
    else:
        b = sig.firwin(63, 0.25) if kind == "overlap_save" else sig.firwin(400, 0.25)
        cls = "FIRFilterOverlapSave" if kind == "overlap_save" else "FIRUniformPartitioned"
        mine, ref = getattr(rt, cls)(b), getattr(jrt, cls)(b)
        for f in (mine, ref):
            f.prepare(128, 2)
        got = np.stack([_stream(mine, x[:, c], 128, c) for c in (0, 1)], axis=1)
        want = np.stack([_stream(ref, x[:, c], 128, c) for c in (0, 1)], axis=1)
        scipy_out = np.stack([sig.lfilter(b, [1.0], x[:, c]) for c in (0, 1)], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, scipy_out, atol=1e-5)
    mine.reset_state()
    assert not bool(mine.input_buffer.any() if kind != "overlap_save" else mine.buffer.any())


# ======== ExponentialAverageFilter: ema.cu's average form ===================
def test_exponential_average_blocks_match_the_jax_scan_with_carried_state():
    """Streamed over blocks with the carried state (the first half through
    the JAX filter, its state copied into the port's): 1e-6 x peak against
    one JAX stream; the plain loop launches no kernel on the CPU and equals
    the per-row loop seeded with each block's carry."""
    x = np.abs(_noise((20000, 2), seed=8)).astype(np.float32)
    ref, half = (jrt.ExponentialAverageFilter(0.01, 0.05, FS) for _ in range(2))
    for f in (ref, half):
        f.set_n_channels(2)
    want = np.stack([_stream(ref, x[:, c], 1024, c) for c in (0, 1)], axis=1)
    first = np.stack([_stream(half, x[:10240, c], 1024, c) for c in (0, 1)], axis=1)
    mine = rt.ExponentialAverageFilter(0.01, 0.05, FS)
    mine.set_n_channels(2)
    mine.state = half.state
    before = cuda_ema.average_launches
    rest = np.stack([_stream(mine, torch.from_numpy(x[10240:, c]), 1024, c) for c in (0, 1)],
                    axis=1)
    assert cuda_ema.average_launches == before
    got = np.concatenate([first, rest])
    assert _rel(got, want) <= 1e-6
    np.testing.assert_allclose(mine.state, ref.state, rtol=1e-6)
    # the blocks again, batched: each row one block seeded with the last
    # block's carry, equal bit for bit
    blocks = torch.from_numpy(x[10240:19456, 0].reshape(-1, 1024))
    carry = torch.cat([torch.tensor([half.state[0, 0]], dtype=torch.float32),
                       torch.from_numpy(rest[1023:9216:1024, 0])[:-1]])
    batched = cuda_ema.ema_average_plain(blocks, carry, mine.increase_coefficient,
                                         mine.decrease_coefficient)
    np.testing.assert_array_equal(batched.reshape(-1).numpy(), rest[:9216, 0])


# ======== StateVariableFilter: linear_recurrence in float64 =================
def _svf_loop_f64(f, x):
    """The per-sample recursion in float64 numpy over ``x (T, C)``."""
    g, res, iv = f.g, f.resonance, f.intermediate_value
    s = np.zeros((2, x.shape[1]))
    out = np.empty((x.shape[0], 4, x.shape[1]))
    for t in range(x.shape[0]):
        yh = (x[t] - (res + g) * s[0] - s[1]) * iv
        yb = g * yh + s[0]
        s[0] = g * yh + yb
        yl = g * yb + s[1]
        s[1] = g * yb + yl
        out[t] = yl, yh, yb, yl - res * yb + yh
    return out, s


@pytest.mark.parametrize("freq,res", [(1000.0, 0.5), (80.0, 1.4)])
def test_svf_bands_match_the_jax_scan_and_a_float64_loop(freq, res):
    x = _noise((24000, 2), seed=9).astype(np.float32)
    mine, ref = rt.StateVariableFilter(freq, res, FS), jrt.StateVariableFilter(freq, res, FS)
    got = mine.filter_signal(Signal(None, x, FS))
    want = ref.filter_signal(jdsp.Signal(None, x, FS))
    loop, s_end = _svf_loop_f64(mine, x.astype(np.float64))
    assert got.number_of_bands == 4
    for i in range(4):
        g = got.bands[i].time_data.numpy()
        assert _rel(g, np.asarray(want.bands[i].time_data)) <= 1e-5
        assert _rel(g, loop[:, i]) <= 1e-6
    np.testing.assert_allclose(mine.state, s_end, rtol=1e-9, atol=1e-12)


def test_svf_continues_from_its_state_and_draws_its_ir():
    """Two halves from the carried state equal one call; the IR's first LP
    sample is g² · intermediate_value; the three plots draw."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = _noise((6000, 1), seed=10).astype(np.float32)
    one, two = (rt.StateVariableFilter(500.0, 1.0, FS) for _ in range(2))
    whole = one.filter_signal(Signal(None, x, FS))
    a = two.filter_signal(Signal(None, x[:3000], FS))
    b = two.filter_signal(Signal(None, x[3000:], FS))
    for i in range(4):
        joined = np.concatenate([a.bands[i].time_data.numpy(), b.bands[i].time_data.numpy()])
        np.testing.assert_allclose(joined, whole.bands[i].time_data.numpy(),
                                   atol=1e-6 * np.abs(joined).max())
    f = rt.StateVariableFilter(1000.0, 0.5, FS)
    ir = f.get_ir(512)
    np.testing.assert_allclose(float(ir.bands[0].time_data[0, 0]),
                               f.g**2 * f.intermediate_value, rtol=1e-6)
    for fig, _ in (f.plot_magnitude(256), f.plot_group_delay(256), f.plot_phase(256, unwrap=True)):
        plt.close(fig)


# ======== WarpedFIR: the allpass cascade through ops.iir.lfilter ============
def _allpass_cascade_f64(x, b, lam):
    stage, out = x, b[0] * x
    for k in range(1, len(b)):
        stage = sig.lfilter([-lam, 1.0], [1.0, -lam], stage, axis=0)
        out = out + b[k] * stage
    return out


@pytest.mark.parametrize("lam", [0.766, 0.0, -0.4])
def test_warped_fir_matches_the_jax_scan_and_scipy_cascade(lam):
    b = sig.firwin(24, 0.3) * np.hanning(48)[24:]
    x = _noise((6000, 2), seed=11).astype(np.float32)
    mine, ref = rt.WarpedFIR(b, lam, FS), jrt.WarpedFIR(b, lam, FS)
    mine.set_n_channels(2)
    mine.buffer[:] = 1.0
    got = mine.filter_signal(Signal(None, x, FS)).time_data.numpy()
    assert np.all(mine.buffer == 1.0)  # restored, the run from zeros
    assert _rel(got, np.asarray(ref.filter_signal(jdsp.Signal(None, x, FS)).time_data)) <= 1e-5
    assert _rel(got, _allpass_cascade_f64(x.astype(np.float64), b, lam)) <= 1e-5


# ======== KautzFilter: chained sections through ops.iir.lfilter =============
def _decaying_ir(n=2048, seed=12):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    ir = rng.standard_normal(n) * np.exp(-t / 0.01) * 0.3
    ir[3] = 1.0
    return ir


def test_kautz_fit_and_filter_match_the_jax_package():
    """The pole search (host scipy float64) gives the JAX package's poles,
    the coefficient fit its coefficients, and filtering its output within
    1e-5 x peak; a fixed-pole fit with a real pole too."""
    ir = _decaying_ir()
    mine = rt.KautzFilter.from_ir(ImpulseResponse(None, ir[:, None], FS), 8, 2)
    ref = jrt.KautzFilter.from_ir(jdsp.ImpulseResponse(None, ir[:, None], FS), 8, 2)
    np.testing.assert_array_equal(np.sort_complex(mine.poles_complex),
                                  np.sort_complex(ref.poles_complex))
    np.testing.assert_allclose(mine.coefficients_complex_poles,
                               ref.coefficients_complex_poles, rtol=1e-5, atol=1e-7)
    x = _noise((8000, 2), seed=13).astype(np.float32)
    got = mine.filter_signal(Signal(None, x, FS)).time_data.numpy()
    assert _rel(got, np.asarray(ref.filter_signal(jdsp.Signal(None, x, FS)).time_data)) <= 1e-5
    poles = np.array([0.6 + 0.4j, 0.3 + 0.1j, 0.5])
    mine, ref = rt.KautzFilter(poles, FS), jrt.KautzFilter(poles, FS)
    mine.fit_coefficients_to_ir(ImpulseResponse(None, ir[:512, None], FS))
    ref.fit_coefficients_to_ir(jdsp.ImpulseResponse(None, ir[:512, None], FS))
    np.testing.assert_allclose(mine.coefficients_real_poles, ref.coefficients_real_poles,
                               rtol=1e-5)
    got = mine.get_ir(512).time_data.numpy()
    assert _rel(got, np.asarray(ref.get_ir(512).time_data)) <= 1e-5


# ======== ParallelFilter: one sosfilt a section, summed in float64 ==========
def _bank_poles(n, f_lo=100.0, f_hi=12000.0):
    """Fixed poles log-spaced over [f_lo, f_hi], each radius from its
    neighbours' spacing (Bank's design)."""
    f = np.geomspace(f_lo, f_hi, n)
    th = 2 * np.pi * f / FS
    bw = np.gradient(th)
    return np.exp(-bw / 2) * np.exp(1j * th)


def _parallel_case(n_poles=12, n=4096):
    ir = _decaying_ir(n, seed=14)
    return ir, _bank_poles(n_poles)


def _fitted_spectrum(f, freqs):
    """The fitted filter's response at ``freqs``, in float64."""
    z1 = np.exp(-2j * np.pi * freqs / FS)
    h = sum(sig.sosfreqz(s[None], freqs, fs=FS)[1] for s in f._sos) * z1**f.delay_iir_samples
    fir = np.asarray(f._fir_coefficients, np.float64)
    return h + (np.polyval(fir[::-1], z1) if len(fir) else 0.0)


def _jax_model_projection(ref, ir):
    """The least-squares optimum over the JAX package's model (three
    numerator coefficients a section, delayed by ``delay_iir_samples``,
    and the FIR taps), found by a truncated SVD that drops the model's
    repeated directions → (bins, the IR's spectrum, the optimum)."""
    td = np.asarray(ir.time_data, np.float64)[:, 0]
    freqs = np.fft.rfftfreq(len(td), 1 / FS)[1:]
    spec = np.fft.rfft(td)[1:]
    z1 = np.exp(-2j * np.pi * freqs / FS)
    cols = [sig.freqz(np.eye(3)[j], s[3:], freqs, fs=FS)[1] * z1**ref.delay_iir_samples
            for s in ref._sos for j in range(3)]
    cols += [z1 ** (n * ref.fir_offset_samples) for n in range(ref.n_fir)]
    M = np.stack(cols, axis=1)
    x = lstsq(np.vstack([M.real, M.imag]), np.hstack([spec.real, spec.imag]), cond=1e-10)[0]
    return freqs, spec, M @ x


def _parallel_output_check(mine, ref, x, of_largest=False):
    """The port's float32 output against scipy float64 of its own sections
    at 1e-5 of the output's peak (of the largest section's output, no more
    than 100 times the peak, where ``of_largest``), and against the JAX
    package's filter given the same coefficients: no further from it than
    it is from scipy float64, plus that 1e-5 (the JAX package filters in
    float32 with its coefficients rounded to float32, up to 5e-3 of the
    peak off scipy float64 on these poles)."""
    got = mine.filter_signal(Signal(None, x, FS)).time_data.numpy()
    x64 = x.astype(np.float64)
    xd = np.pad(x64, ((mine.delay_iir_samples, 0), (0, 0)))[: len(x)]
    sections = [sig.sosfilt(s[None], xd, axis=0) for s in mine._sos]
    want = sum(sections)
    if len(mine._fir_coefficients):
        want = want + sig.lfilter(mine._fir_coefficients, [1.0], x64, axis=0)
    peak = np.abs(want).max()
    scale = max(np.abs(s).max() for s in sections) if of_largest else peak
    assert scale <= 100 * peak
    assert np.max(np.abs(got - want)) <= 1e-5 * scale
    ref._sos, ref._fir_coefficients = mine._sos.copy(), np.array(mine._fir_coefficients)
    jax_out = np.asarray(ref.filter_signal(jdsp.Signal(None, x, FS)).time_data)
    assert np.max(np.abs(got - jax_out)) <= np.max(np.abs(jax_out - want)) + 1e-5 * scale


def test_parallel_filter_fit_and_output_match_the_jax_package_and_scipy():
    """The port's fit is the least-squares optimum over the JAX package's
    model (its fitted response within 1e-7 of the spectrum's peak of an
    independent solve), with the JAX package's denominators; its float32
    output meets scipy float64 at 1e-5 of the output's peak, and the JAX
    package's filter on the same coefficients within that beyond the JAX
    package's own float32 error. The JAX package's own numerators are not
    unique (its basis repeats the direct term), so they are not compared."""
    ir, poles = _parallel_case()
    mine = rt.ParallelFilter(poles, 1, FS).fit_to_ir(ImpulseResponse(None, ir[:, None], FS))
    jir = jdsp.ImpulseResponse(None, ir[:, None], FS)
    ref = jrt.ParallelFilter(poles, 1, FS).fit_to_ir(jir)
    np.testing.assert_array_equal(mine._sos[:, 3:], ref._sos[:, 3:])
    freqs, spec, best = _jax_model_projection(ref, jir)
    assert np.max(np.abs(_fitted_spectrum(mine, freqs) - best)) <= 1e-7 * np.abs(spec).max()
    _parallel_output_check(mine, ref, _noise((6000, 2), seed=15).astype(np.float32))


@pytest.mark.parametrize("poles, n_fir, delay", [
    (_bank_poles(12), 0, 0),
    (_bank_poles(12), 16, 3),
    (np.array([0.5, 0.9, -0.3, 0.6 + 0.3j, 0.2 + 0.7j]), 0, 2),  # a first-order section
    (np.array([0.5, 0.9, -0.3, 0.6 + 0.3j, 0.2 + 0.7j]), 4, 0),
], ids=["no-fir", "fir16-delay3", "first-order-delay2", "first-order-fir4"])
def test_parallel_filter_fit_spans_the_jax_package_model_without_its_repeats(poles, n_fir, delay):
    """Without an FIR tap at the IIR delay, with a delay, with a
    first-order section (which spans ``z⁻ᵈ`` and ``z⁻ᵈ⁻¹``): the port's fit
    is the JAX package's model's least-squares optimum, its numerators
    within 100 of the IR's peak, and its output meets scipy float64 at
    1e-5 of the largest section's output (the first-order case's sections
    reach 72 times the output) and the JAX package's filter beyond its own
    float32 error by no more."""
    ir = _decaying_ir(2048, seed=17)
    mine = rt.ParallelFilter(poles, n_fir, FS).set_parameters(delay)
    mine.fit_to_ir(ImpulseResponse(None, ir[:, None], FS))
    jir = jdsp.ImpulseResponse(None, ir[:, None], FS)
    ref = jrt.ParallelFilter(poles, n_fir, FS).set_parameters(delay).fit_to_ir(jir)
    np.testing.assert_array_equal(mine._sos[:, 3:], ref._sos[:, 3:])
    freqs, spec, best = _jax_model_projection(ref, jir)
    assert np.max(np.abs(_fitted_spectrum(mine, freqs) - best)) <= 1e-7 * np.abs(spec).max()
    assert np.abs(mine._sos[:, :3]).max() <= 100 * np.abs(ir).max()
    _parallel_output_check(mine, ref, _noise((4000, 1), seed=18).astype(np.float32), True)


def test_parallel_filter_on_a_room_ir_does_not_cancel_where_the_jax_fit_does():
    """The path's 32 pole pairs (30 Hz-18 kHz) on a room IR: the JAX
    package's sections reach 1e3 times its output and cancel (ROADMAP C);
    the port's reach at most 10 times its output, and the fitted responses
    agree to the JAX fit's own rounding (1e-2 of the spectrum's peak)."""
    from dsptoolbox_tpu_torch.tools.measurement import room_irs

    ir = room_irs()[0][:8192, 0]
    poles = _bank_poles(32, 30.0, 18000.0)
    mine = rt.ParallelFilter(poles, 1, FS).fit_to_ir(ImpulseResponse(None, ir[:, None], FS))
    jir = jdsp.ImpulseResponse(None, ir[:, None], FS)
    ref = jrt.ParallelFilter(poles, 1, FS).fit_to_ir(jir)
    x64 = _noise(48000, seed=16)
    out = {}
    for name, f in (("mine", mine), ("jax", ref)):
        sections = [sig.sosfilt(s[None], x64) for s in f._sos]
        out[name] = (max(np.abs(s).max() for s in sections),
                     np.abs(sum(sections) + f._fir_coefficients[0] * x64).max())
    assert out["jax"][0] > 1e3 * out["jax"][1] and out["mine"][0] <= 10 * out["mine"][1], out
    freqs, spec, best = _jax_model_projection(ref, jir)
    fitted = _fitted_spectrum(mine, freqs)
    assert np.max(np.abs(fitted - best)) <= 1e-7 * np.abs(spec).max()
    assert np.max(np.abs(fitted - _fitted_spectrum(ref, freqs))) <= 1e-2 * np.abs(spec).max()


def test_parallel_filter_sums_its_sections_in_float64():
    """A battery whose sections cancel (here, the JAX package's fit of 32
    pole pairs on a room IR: numerators of ~1e8 against an output of ~1)
    is held to scipy's float64 sum at 1e-5 of the largest section's
    output. Each section's float32 output carries its own rounding, which
    bounds what the float64 sum gains; the sum taken in float32 adds its
    own and misses scipy by more than 1.25 times the float64 sum's error."""
    from dsptoolbox_tpu_torch.tools.measurement import room_irs

    ir = room_irs()[0][:8192, 0]
    ref = jrt.ParallelFilter(_bank_poles(32, 30.0, 18000.0), 1, FS)
    ref.fit_to_ir(jdsp.ImpulseResponse(None, ir[:, None], FS))
    f = rt.ParallelFilter(_bank_poles(32, 30.0, 18000.0), 1, FS)
    f._sos, f._fir_coefficients = ref._sos.copy(), np.array(ref._fir_coefficients)
    x = _noise((48000, 1), seed=16).astype(np.float32)
    x64 = x[:, 0].astype(np.float64)
    sections = [sig.sosfilt(f._sos[n][None], x64) for n in range(len(f._sos))]
    largest = max(np.abs(s).max() for s in sections)
    want = sum(sections) + f._fir_coefficients[0] * x64
    got = f.filter_signal(Signal(None, x, FS)).time_data.numpy()[:, 0]
    f32 = f._sum(torch.from_numpy(x.T), torch.float32).numpy()[0]
    e64, e32 = (float(np.max(np.abs(v - want))) for v in (got, f32))
    assert largest > 1e3 * np.abs(want).max()  # the sections cancel
    assert e64 <= 1e-5 * largest and e32 > 1.25 * e64, (e64 / largest, e32 / largest)


# ======== designers =========================================================
def _lr_collapsed_ir(m, length=2**12):
    fb = m.filterbanks.linkwitz_riley_crossovers([570, 2000], order=[2, 2],
                                                sampling_rate_hz=FS)
    return fb.get_ir(length_samples=length).collapse()


def test_designers_match_the_jax_package():
    """PhaseLinearizer and GroupDelayDesigner (with and without extra
    length, integer delay, Simpson integration) on an LR crossover's
    summed IR: the taps of the JAX package within float32 rounding."""
    import dsptoolbox_tpu_torch as dtt
    from dsptoolbox_tpu.realtime import designers as jd
    from dsptoolbox_tpu_torch.realtime import designers as md

    ir_j = _lr_collapsed_ir(jdsp)
    ir_m = _lr_collapsed_ir(dtt)
    phase = np.angle(np.fft.rfft(np.asarray(ir_j.time_data)[:, 0]))
    gd = -np.gradient(np.unwrap(phase)) / (2 * np.pi) * len(ir_j) / FS
    gd = gd.max() * 2 - gd
    np.testing.assert_allclose(ir_m.time_data.numpy(), np.asarray(ir_j.time_data), atol=1e-6)
    cases = [
        (lambda m: m.PhaseLinearizer(phase, len(ir_j), FS), ()),
        (lambda m: m.PhaseLinearizer(phase, len(ir_j), FS), (50.0, 10, False, True)),
        (lambda m: m.GroupDelayDesigner(gd, len(ir_j), FS), (1.0,)),
        (lambda m: m.GroupDelayDesigner(gd, len(ir_j), FS), (1.0, 10, True, True)),
        (lambda m: m.FirDesigner(np.linspace(1, 0.5, len(gd)), gd, len(ir_j), FS), (0.5,)),
    ]
    for make, params in cases:
        mine, ref = make(md), make(jd)
        mine.set_parameters(*params)
        ref.set_parameters(*params)
        got, want = mine.get_filter().ba[0], np.asarray(ref.get_filter().ba[0])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-6 * np.abs(want).max())
        assert mine.get_filter_as_ir().time_data.shape == (len(want), 1)

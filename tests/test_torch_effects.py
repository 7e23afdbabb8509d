"""The port's effects (`dsptoolbox_tpu_torch.effects`) against the JAX
package's (`dsptoolbox_tpu.effects`) on the CPU, on the same seeded inputs:
the effects chain's bursts in noise (`tools.effects_chain.inputs`), 2
channels × 1 s at 16 kHz.

Tolerances, scale-relative (max abs difference over the JAX output's
peak): the elementwise effects (distortion, tremolo, chorus with a
modulator array) 1e-6; the compressor, the delay and both subtractor modes
2e-5. The adaptive subtractor's frame decisions (below the threshold or
not) are compared first and must agree. The LFOs draw their random phase
from a ``RandomState`` seeded as the JAX package's global one: equal."""

import numpy as np
import pytest
import torch

import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu_torch import _config, effects
from dsptoolbox_tpu_torch.classes import MultiBandSignal, Signal
from dsptoolbox_tpu_torch.tools import effects_chain

torch.set_num_threads(1)

FS = 16000


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The port puts numpy data on the default device, "cuda" out of the
    box: these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


@pytest.fixture(scope="module")
def pair():
    """``(clean, noisy)`` as ``(T, C)`` float32 numpy."""
    clean, noisy = effects_chain.inputs(2, 1.0, fs=FS)
    return clean.time_data.numpy().copy(), noisy.time_data.numpy().copy()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _both(td, fs=FS):
    return Signal(None, td, fs), jdsp.Signal(None, td, fs)


def _run(port_fx, jax_fx, td, fs=FS):
    s, js = _both(td, fs)
    return port_fx.apply(s).time_data.numpy(), np.asarray(jax_fx.apply(js).time_data)


# ======== spectral subtraction ===============================================
def test_adaptive_subtractor_decisions_then_output(pair):
    import jax.numpy as jnp
    from dsptoolbox_tpu.helpers.gain_and_level import to_db as jto_db
    from dsptoolbox_tpu.ops.framing import frame_signal as jframe

    _, noisy = pair
    port, jax_fx = effects.SpectralSubtractor(), jdsp.effects.SpectralSubtractor()
    port._compute_window(FS)
    L, step = len(port.window), port.step_size
    xp = np.pad(noisy.T, ((0, 0), (L, L)))
    below = port._adaptive_noise_below(torch.from_numpy(xp)).numpy()
    below_j = np.asarray(jto_db(jnp.var(jframe(jnp.asarray(xp), L, step, True), axis=-1),
                                False) < port.threshold_rms_dbfs)
    assert below.any() and not below.all()
    assert np.array_equal(below, below_j), int((below != below_j).sum())
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 2e-5
    assert torch.equal(port._peak_values, torch.from_numpy(np.abs(noisy).max(axis=0)))


@pytest.mark.parametrize("advanced", [False, True])
def test_offline_subtractor(pair, advanced):
    _, noisy = pair
    port = effects.SpectralSubtractor(adaptive_mode=False)
    jax_fx = jdsp.effects.SpectralSubtractor(adaptive_mode=False)
    if advanced:
        kw = dict(overlap_percent=75, noise_forgetting_factor=0.95, subtraction_factor=3,
                  subtraction_exponent=3, ad_attack_time_ms=1.5, ad_release_time_ms=30)
        port.set_advanced_parameters(window_type=effects_chain.effects.effects.Window.Hamming,
                                     **kw)
        jax_fx.set_advanced_parameters(window_type=jdsp.Window.Hamming, **kw)
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 2e-5


def test_subtractor_with_a_spectrum_to_subtract(pair):
    _, noisy = pair
    spectrum = np.abs(np.random.default_rng(3).standard_normal(1025)) * 1e-3
    with pytest.warns(UserWarning, match="adaptive"):
        port = effects.SpectralSubtractor(spectrum_to_subtract=spectrum)
    with pytest.warns(UserWarning, match="adaptive"):
        jax_fx = jdsp.effects.SpectralSubtractor(spectrum_to_subtract=spectrum)
    assert not port.adaptive_mode
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 2e-5


# ======== elementwise effects =================================================
@pytest.mark.parametrize("kind", ["Arctan", "HardClip", "SoftClip"])
def test_distortion_single(pair, kind):
    _, noisy = pair
    port = effects.Distortion(12, 0, getattr(effects.DistortionType, kind))
    jax_fx = jdsp.effects.Distortion(12, 0, getattr(jdsp.effects.DistortionType, kind))
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 1e-6
    np.testing.assert_allclose(port._peak_values.numpy(), np.abs(noisy).max(axis=0))


def test_distortion_mixed_with_offset_and_post_gain(pair):
    _, noisy = pair
    kw = dict(distortion_levels_db=[20, 10, 5], mix_percent=[50, 30, 20],
              offset_db=[-20, -np.inf, -30], post_gain_db=-3)
    port, jax_fx = effects.Distortion(), jdsp.effects.Distortion()
    port.set_advanced_parameters(
        type_of_distortion=[effects.DistortionType.Arctan, effects.DistortionType.SoftClip,
                            effects.DistortionType.HardClip], **kw)
    jax_fx.set_advanced_parameters(
        type_of_distortion=[jdsp.effects.DistortionType.Arctan,
                            jdsp.effects.DistortionType.SoftClip,
                            jdsp.effects.DistortionType.HardClip], **kw)
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("modulator", ["lfo", "array"])
def test_tremolo(pair, modulator):
    _, noisy = pair
    if modulator == "lfo":
        port = effects.Tremolo(0.7, effects.LFO(3.0, "triangle", smooth=2))
        jax_fx = jdsp.effects.Tremolo(0.7, jdsp.effects.LFO(3.0, "triangle", smooth=2))
    else:
        mod = np.sin(np.arange(FS // 2) / 300.0)  # shorter than the signal: zero-padded
        port, jax_fx = effects.Tremolo(0.4, mod), jdsp.effects.Tremolo(0.4, mod)
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("mix", [100, 60])
def test_chorus_with_a_modulator_array(pair, mix):
    _, noisy = pair
    t = np.arange(noisy.shape[0] - 100) / FS  # shorter than the signal
    mods = np.stack([12 + 4 * np.sin(2 * np.pi * 1.3 * t), 20 + 3 * np.cos(2 * np.pi * 0.7 * t)],
                    axis=1)
    port = effects.Chorus(modulators=mods, mix_percent=mix)
    jax_fx = jdsp.effects.Chorus(modulators=mods, mix_percent=mix)
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 1e-6


def test_chorus_with_seeded_lfos(pair):
    """Three voices of one random-phase LFO: the port draws from a
    ``RandomState``, the JAX package from numpy's global state, seeded
    alike."""
    _, noisy = pair
    port = effects.Chorus(depths_ms=[3, 4, 5], base_delays_ms=[10, 15, 20],
                          modulators=effects.LFO(2, "sawtooth", True, 3,
                                                 rng=np.random.RandomState(11)))
    jax_fx = jdsp.effects.Chorus(depths_ms=[3, 4, 5], base_delays_ms=[10, 15, 20],
                                 modulators=jdsp.effects.LFO(2, "sawtooth", True, 3))
    s, js = _both(noisy)
    got = port.apply(s).time_data.numpy()
    np.random.seed(11)
    want = np.asarray(jax_fx.apply(js).time_data)
    assert _rel(got, want) <= 1e-6


def test_chorus_1d_modulator_is_one_voice():
    s = Signal(None, np.random.default_rng(41).standard_normal((4800, 1)) * 0.3, 48000)
    ch = effects.Chorus(depths_ms=5.0, base_delays_ms=10.0, modulators=np.full(4800, 5.0))
    assert ch.number_of_voices == 1
    out = ch.apply(s)
    assert out.length_samples == s.length_samples and torch.isfinite(out._x).all()


# ======== recursive effects ===================================================
@pytest.mark.parametrize("case", ["default", "knee_upward", "absolute_levels"])
def test_compressor(pair, case):
    _, noisy = pair
    args = dict(threshold_dbfs=-20, attack_time_ms=5, release_time_ms=50, ratio=4)
    adv = {"default": {}, "knee_upward": dict(knee_factor_db=6, downward_compression=False),
           "absolute_levels": dict(pre_gain_db=3, automatic_make_up_gain=False)}[case]
    rel = case != "absolute_levels"
    port = effects.Compressor(**args, relative_to_peak_level=rel)
    jax_fx = jdsp.effects.Compressor(**args, relative_to_peak_level=rel)
    port.set_advanced_parameters(**adv)
    jax_fx.set_advanced_parameters(**adv)
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 2e-5


def test_compressor_core_is_the_average_form_of_its_gain(pair):
    """The gain smoother is `ema_average` from a gain of 1 on the gain each
    sample asks for; the core takes ``(T, C)`` and ``(T,)``."""
    from dsptoolbox_tpu_torch.effects._backend import compressor_core

    x = torch.from_numpy(pair[1])
    y = compressor_core(x, -20, 4, 6, 80, 800, 1.0, True)
    y1 = compressor_core(x[:, 1], -20, 4, 6, 80, 800, 1.0, True)
    assert y.shape == x.shape and torch.equal(y[:, 1], y1)


def test_compressor_keeps_the_core_gain(pair):
    """`Compressor.apply` keeps the gain request and the smoothed gain of
    its rows (`_last_gain_request`, `_last_gain`): the gain is the EMA's
    average form of the request from 1, and ``compressor_core`` on the same
    rows is the rows times that gain, bit for bit."""
    from dsptoolbox_tpu_torch.effects import _backend as fx
    from dsptoolbox_tpu_torch.ops import cuda_ema

    noisy = torch.from_numpy(pair[1])
    comp = effects.Compressor(-20, 5, 50, 4, relative_to_peak_level=False)
    comp.set_advanced_parameters(knee_factor_db=6, automatic_make_up_gain=False)
    comp.apply(Signal(None, noisy, FS))
    rows = noisy.T.contiguous()
    att, rel = int(5e-3 * FS), int(50e-3 * FS)
    request = fx.gain_request(rows, -20, 4, 6, True)
    assert torch.equal(comp._last_gain_request, request)
    want = cuda_ema.ema_average_plain(request, torch.ones(rows.shape[0]),
                                      *fx.smoothing_coefficients(att, rel))
    assert torch.equal(comp._last_gain, want)
    y = fx.compressor_core(noisy, -20, 4, 6, att, rel, 1.0, True)
    assert torch.equal(y.T, rows * comp._last_gain)


@pytest.mark.parametrize("saturation", ["digital", "arctan"])
def test_digital_delay(pair, saturation):
    _, noisy = pair
    port, jax_fx = effects.DigitalDelay(300, 0.3), jdsp.effects.DigitalDelay(300, 0.3)
    port.set_advanced_parameters(saturation)
    jax_fx.set_advanced_parameters(saturation)
    got, want = _run(port, jax_fx, noisy)
    assert got.shape[0] > noisy.shape[0]
    assert _rel(got, want) <= 2e-5


def test_digital_delay_custom_saturation(pair):
    import jax.numpy as jnp

    _, noisy = pair
    port, jax_fx = effects.DigitalDelay(50.0, 0.4), jdsp.effects.DigitalDelay(50.0, 0.4)
    port.set_advanced_parameters(saturation=torch.tanh)
    jax_fx.set_advanced_parameters(saturation=jnp.tanh)
    got, want = _run(port, jax_fx, noisy)
    assert _rel(got, want) <= 2e-5
    plain = effects.DigitalDelay(50.0, 0.4).apply(Signal(None, noisy, FS)).time_data.numpy()
    assert not np.allclose(got, plain)


@pytest.mark.parametrize("saturation", [lambda x: float(np.tanh(float(x))),
                                        lambda x: np.tanh(np.asarray(x)),
                                        lambda x: x[:1]])
def test_digital_delay_refuses_a_saturation_not_on_tensors(saturation):
    s = Signal(None, np.random.default_rng(43).standard_normal((2048, 1)) * 0.3, 48000)
    d = effects.DigitalDelay(delay_time_ms=10.0, feedback=0.2)
    d.set_advanced_parameters(saturation=saturation)
    with pytest.raises(ValueError, match="traceable"):
        d.apply(s)


def test_digital_delay_checks():
    s = Signal(None, np.random.default_rng(42).standard_normal((2048, 1)) * 0.3, 8000)
    with pytest.raises(AssertionError, match="zero samples"):
        effects.DigitalDelay(delay_time_ms=0.05, feedback=0.2).apply(s)
    with pytest.raises(AssertionError, match="Feedback must be larger than one"):
        effects.DigitalDelay(100, 0)
    with pytest.raises(ValueError, match="not be valid"):
        effects.DigitalDelay().set_advanced_parameters("tube")


def test_effect_on_a_multiband_signal(pair):
    _, noisy = pair
    s = Signal(None, noisy, FS)
    mbs = MultiBandSignal([s, s.copy()])
    out = effects.Distortion().apply(mbs)
    assert isinstance(out, MultiBandSignal) and out.number_of_bands == 2
    assert torch.equal(out.bands[0]._x, effects.Distortion().apply(s)._x)
    with pytest.raises(TypeError):
        effects.Tremolo().apply(noisy)


# ======== LFOs and helpers ====================================================
@pytest.mark.parametrize("waveform", ["harmonic", "sawtooth", "square", "triangle"])
@pytest.mark.parametrize("smooth", [0, 4])
def test_lfo_waveforms_from_a_seeded_generator(waveform, smooth):
    port = effects.LFO(3.5, waveform, random_phase=True, smooth=smooth,
                       rng=np.random.RandomState(5))
    jax_lfo = jdsp.effects.LFO(3.5, waveform, random_phase=True, smooth=smooth)
    got = [port.get_waveform(1000, 700), port.get_waveform(1000)]
    np.random.seed(5)
    want = [jax_lfo.get_waveform(1000, 700), jax_lfo.get_waveform(1000)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    gen = effects.LFO(("quarter", 120), waveform, True, smooth, rng=np.random.default_rng(1))
    again = effects.LFO(("quarter", 120), waveform, True, smooth, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(gen.get_waveform(800), again.get_waveform(800))


def test_musical_rhythm_helpers():
    fx = effects
    assert fx.get_frequency_from_musical_rhythm("quarter", 60) == 1
    assert fx.get_frequency_from_musical_rhythm("eighth", 60) == 2
    assert fx.get_frequency_from_musical_rhythm("eighth 3", 60) == 3
    assert fx.get_frequency_from_musical_rhythm("dotted quarter", 60) == 2 / 3
    for note in ("whole", "half", "sixteenth", "32th", "quintuplet", "dotted eighth 3"):
        assert fx.get_frequency_from_musical_rhythm(note, 97) == \
            jdsp.effects.get_frequency_from_musical_rhythm(note, 97)
        assert fx.get_time_period_from_musical_rhythm(note, 97) == \
            jdsp.effects.get_time_period_from_musical_rhythm(note, 97)
    with pytest.raises(ValueError):
        fx.get_frequency_from_musical_rhythm("breve", 60)


def test_host_plots():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = effects.Compressor(-15, 1, 20, 3)
    c.set_advanced_parameters(knee_factor_db=4, mix_percent=80)
    d = effects.DigitalDelay(100, 0.5)
    d.set_advanced_parameters("arctan")
    for fig, ax in (c.show_compression(), d.plot_delay(),
                    effects.LFO(2, "square", smooth=3).plot_waveform()):
        assert ax.lines
        plt.close(fig)
    knee = effects._backend.get_knee_func(-15, 3, 4, True)
    jknee = jdsp.effects._backend.get_knee_func(-15, 3, 4, True)
    x = np.linspace(-40, 0, 201)
    np.testing.assert_allclose(knee(x), np.asarray(jknee(x)), rtol=1e-6, atol=1e-5)

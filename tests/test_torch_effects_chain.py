"""The effects path (`tools.effects_chain.run`: denoise, compress, the
rack, the scores, the EQ match) at 2 channels × 1 s at 16 kHz on the CPU,
against the same steps run on the JAX package from the same inputs.

Each step's output is held against the JAX package's step on the JAX
package's previous output (two independent chains) at 2e-5 of the JAX
output's peak; the scores of the port's outputs against the JAX package's
measures of the same signals at SNR 1e-5, SI-SDR and log-spectral 1e-4,
Itakura-Saito 5e-4 (below), fwSNRseg 1e-3 (relative); the fitted EQ through
`Filter` and through `sosfilt_diff` against scipy's float64 sosfilt of
the fitted sections (5e-6 and 1e-3 of the peak), the fit's first losses against the JAX
package's fit on the same target (1e-3 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import sosfilt

import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu.ops import differentiable as jdiff
from dsptoolbox_tpu_torch import _config
from dsptoolbox_tpu_torch.tools import effects_chain as ec

torch.set_num_threads(1)

FS = 16000
FW_RANGE = (100.0, 4000.0)
SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def chains(_cpu_default_device):
    clean, noisy = ec.inputs(2, 1.0, fs=FS)
    out = ec.run(clean, noisy, FW_RANGE, rng=np.random.RandomState(SEED))
    c_np, n_np = clean.time_data.numpy().copy(), noisy.time_data.numpy().copy()
    jnoisy = jdsp.Signal(None, n_np, FS)
    jout = {"adaptive": jdsp.effects.SpectralSubtractor().apply(jnoisy),
            "offline": jdsp.effects.SpectralSubtractor(adaptive_mode=False).apply(jnoisy)}
    comp = jdsp.effects.Compressor(**ec.COMPRESSOR)
    comp.set_advanced_parameters(knee_factor_db=ec.KNEE_DB)
    jout["compressed"] = comp.apply(jout["adaptive"])
    kinds, mix, level = ec.DISTORTION
    dist = jdsp.effects.Distortion()
    dist.set_advanced_parameters(
        type_of_distortion=[getattr(jdsp.effects.DistortionType, k.name) for k in kinds],
        mix_percent=list(mix), distortion_levels_db=[level, level],
        offset_db=[-np.inf, -np.inf])
    bases, depth, f_lfo = ec.CHORUS
    chorus = jdsp.effects.Chorus(
        depths_ms=depth, base_delays_ms=list(bases),
        modulators=[jdsp.effects.LFO(f_lfo, "harmonic", random_phase=True) for _ in bases])
    delay = jdsp.effects.DigitalDelay(ec.DELAY[0], ec.DELAY[1])
    delay.set_advanced_parameters(ec.DELAY[2])
    np.random.seed(SEED)  # the chorus' phases: the port drew from RandomState(SEED)
    s, jout["rack"] = jout["compressed"], []
    for e in (dist, jdsp.effects.Tremolo(ec.TREMOLO[1], jdsp.effects.LFO(ec.TREMOLO[0])),
              chorus, delay):
        s = e.apply(s)
        jout["rack"].append(s)
    return clean, c_np, out, jout


@pytest.mark.parametrize("step", ["adaptive", "offline", "compressed"])
def test_denoise_and_compress_steps(chains, step):
    _, _, out, jout = chains
    assert _rel(out[step].time_data, jout[step].time_data) <= 2e-5


@pytest.mark.parametrize("index", range(4))
def test_rack_steps(chains, index):
    _, _, out, jout = chains
    got, want = out["rack"][index].time_data, np.asarray(jout["rack"][index].time_data)
    assert np.isfinite(want).all()
    assert _rel(got, want) <= 2e-5


@pytest.mark.parametrize("step", ["denoised", "compressed"])
def test_scores_against_the_jax_measures(chains, step):
    clean, c_np, out, _ = chains
    got = out[f"scores_{step}"]
    processed = out["adaptive" if step == "denoised" else "compressed"]
    p_np = processed.time_data.numpy()
    jc, jp = jdsp.Signal(None, c_np, FS), jdsp.Signal(None, p_np, FS)
    want = {"snr": jdsp.distances.snr(jc, jdsp.Signal(None, p_np - c_np, FS)),
            "si_sdr": jdsp.distances.si_sdr(jc, jp),
            "log_spectral": jdsp.distances.log_spectral(jc, jp, f_range_hz=[20, 8000]),
            "itakura_saito": jdsp.distances.itakura_saito(jc, jp, f_range_hz=[20, 8000]),
            "fw_snr_seg": jdsp.distances.fw_snr_seg(jc, jp, f_range_hz=list(FW_RANGE))}
    # Itakura-Saito: its terms take both signs and cancel; on these signals
    # the JAX package's float32 integrand lands 1.7e-4 off a float64 one
    # (the port's, formed in float64, 1.7e-5): held against the JAX package
    # at 5e-4 and against float64 numpy at 1e-4 (tests/test_torch_distances.py)
    tol = {"snr": 1e-5, "si_sdr": 1e-4, "log_spectral": 1e-4, "itakura_saito": 5e-4,
           "fw_snr_seg": 1e-3}
    for name, value in got.items():
        assert value.shape == (2,) and np.isfinite(value).all(), name
        assert np.max(np.abs(value / want[name] - 1)) <= tol[name], name
    assert got["snr"].min() > 15 and got["si_sdr"].min() > 15  # the denoiser did its job


def test_eq_match(chains):
    clean, _, out, _ = chains
    eq = out["eq"]
    assert eq["params"].shape == (ec.EQ_SECTIONS, 3) and len(eq["losses"]) == ec.EQ_STEPS
    assert float(eq["losses"][-1]) <= float(eq["losses"][0])
    sos = eq["sos"].double().numpy()
    x = out["adaptive"]._x.double().numpy()
    assert _rel(eq["equalized"].time_data.T, sosfilt(sos, x, axis=-1)) <= 5e-6
    x0 = x[0, : int(ec.SOSFILT_S * FS)]
    # the float32 doubling squares A 14 times: a fitted low section's pole at
    # radius ~0.996 keeps ~1e-4 of the output's peak
    assert _rel(eq["sosfilt_diff"], sosfilt(sos, x0)) <= 1e-3
    assert torch.isfinite(eq["grad"]).all() and eq["grad"].abs().max() > 0

    def make_sos_jax(p):
        import jax

        import dsptoolbox_tpu.standard.enums as jenums

        lo, hi = ec._fc_range(FS)
        fc = lo * (hi / lo) ** jax.nn.sigmoid(p[:, 0])
        return jdiff.biquad_coefficients_diff(jenums.BiquadEqType.Peaking, FS, fc, p[:, 1],
                                              0.1 + jax.nn.softplus(p[:, 2]))

    _, jlosses = jdiff.fit_sos_to_magnitude(
        make_sos_jax, jnp.asarray(ec.initial_params(FS), jnp.float32), eq["target_db"],
        eq["freqs"], FS, steps=10)
    np.testing.assert_allclose(eq["losses"][:10].numpy(), np.asarray(jlosses), rtol=1e-3)

"""The port's differentiable filter ops and prefix sums
(`dsptoolbox_tpu_torch.ops.differentiable`, `ops.prefix`) against the JAX
package's, scipy and finite differences, on the CPU.

Bounds: the designers within the JAX tests' 2e-5 rel / 2e-6 abs of the
host designer; `sosfreqz_diff` 1e-4 rel / 1e-5 abs of scipy; `sosfilt_diff`
5e-4 rel / 5e-5 abs of scipy's float64 sosfilt (`tests/test_differentiable.py`'s
bounds); gradients within 1e-3 (rel) of `jax.grad`, and
`torch.autograd.gradcheck` in float64; the fit's criteria of the JAX test
(the last loss under 5 % of the first, the fitted response within 1 dB of
the target), its first losses within 1e-4 (rel) of the JAX fit's; the
prefix sums at `tests/test_prefix.py`'s bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import butter, sosfilt as scipy_sosfilt, sosfreqz as scipy_sosfreqz

from dsptoolbox_tpu.ops import differentiable as jdiff
from dsptoolbox_tpu_torch.classes.filter_helpers import biquad_coefficients
from dsptoolbox_tpu_torch.ops import (
    biquad_coefficients_diff,
    cumsum_mxu,
    fit_sos_to_magnitude,
    sosfilt_diff,
    sosfreqz_diff,
    sosfreqz_host,
)
from dsptoolbox_tpu_torch._enums import BiquadEqType

torch.set_num_threads(1)

FS = 48000
TYPES = ["Peaking", "Lowpass", "Highpass", "BandpassSkirt", "BandpassPeak", "Notch",
         "Allpass", "Lowshelf", "Highshelf"]


@pytest.mark.parametrize("eq_type", TYPES)
def test_designer_matches_host_designer_and_jax(eq_type):
    t = getattr(BiquadEqType, eq_type)
    fc, g, q = 1234.0, 5.5, 0.9
    b, a = biquad_coefficients(t, FS, fc, g, q)
    expected = np.concatenate([b / a[0], a / a[0]])
    got = biquad_coefficients_diff(t, FS, fc, g, q)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=2e-5, atol=2e-6)
    import dsptoolbox_tpu.standard.enums as jenums

    want = np.asarray(jdiff.biquad_coefficients_diff(getattr(jenums.BiquadEqType, eq_type), FS,
                                                     fc, g, q))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_designer_broadcasts_and_keeps_float64():
    fc = torch.tensor([500.0, 1000.0, 2000.0], dtype=torch.float64)
    sos = biquad_coefficients_diff(BiquadEqType.Peaking, FS, fc, 3.0, 1.0)
    assert sos.shape == (3, 6) and sos.dtype == torch.float64
    with pytest.raises(ValueError, match="not supported"):
        biquad_coefficients_diff(BiquadEqType.LowpassFirstOrder, FS, 100.0, 0.0, 1.0)


def test_sosfreqz_matches_scipy():
    sos = butter(4, [400, 4000], btype="bandpass", fs=FS, output="sos")
    freqs = np.linspace(10, 20000, 64)
    _, H_ref = scipy_sosfreqz(sos, worN=freqs, fs=FS)
    H = sosfreqz_diff(torch.as_tensor(sos), freqs, FS)
    assert H.dtype == torch.complex128
    np.testing.assert_allclose(H.numpy(), H_ref, rtol=1e-4, atol=1e-5)
    H32 = sosfreqz_diff(torch.as_tensor(sos, dtype=torch.float32), freqs, FS)
    assert H32.dtype == torch.complex64
    np.testing.assert_allclose(H32.numpy(), H_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sosfreqz_host(sos, freqs, FS), H_ref, rtol=1e-4, atol=1e-5)


def test_sosfilt_matches_scipy():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 2048)).astype(np.float32)
    sos = butter(4, 2000, btype="lowpass", fs=FS, output="sos")
    y = sosfilt_diff(torch.as_tensor(sos), torch.from_numpy(x))
    assert y.dtype == torch.float32
    y_ref = scipy_sosfilt(sos, x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=5e-4, atol=5e-5)
    with pytest.raises(ValueError, match="sos must be"):
        sosfilt_diff(torch.ones(6), torch.from_numpy(x))


def _loss_torch(params, x):
    sos = biquad_coefficients_diff(BiquadEqType.Peaking, FS, params[0], params[1], params[2])
    H = sosfreqz_diff(sos[None], torch.tensor([500.0, 1000.0, 2000.0]), FS)
    return (H.abs() ** 2).sum() + sosfilt_diff(sos[None], x).square().mean()


def _loss_jax(params, x):
    sos = jdiff.biquad_coefficients_diff(_jax_peaking(), FS, params[0], params[1], params[2])
    H = jdiff.sosfreqz_diff(sos[None], jnp.asarray([500.0, 1000.0, 2000.0]), FS)
    return jnp.sum(jnp.abs(H) ** 2) + jnp.mean(jdiff.sosfilt_diff(sos[None], x) ** 2)


def _jax_peaking():
    import dsptoolbox_tpu.standard.enums as jenums

    return jenums.BiquadEqType.Peaking


def test_gradients_match_jax_grad():
    x = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    p = torch.tensor([1000.0, 6.0, 1.0], requires_grad=True)
    (g,) = torch.autograd.grad(_loss_torch(p, torch.from_numpy(x)), p)
    want = np.asarray(jax.grad(_loss_jax)(jnp.asarray([1000.0, 6.0, 1.0]), jnp.asarray(x)))
    assert np.all(np.isfinite(g.numpy())) and float(g[1]) > 0
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-3)


def test_gradcheck_in_float64():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(96))
    p = torch.tensor([2000.0, 3.0, 0.8], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda q: _loss_torch(q, x), (p,), eps=1e-6, atol=1e-5)
    sos = biquad_coefficients_diff(BiquadEqType.Highshelf, FS, 3000.0, -4.0, 0.7).detach()
    sos = sos.double()[None].requires_grad_(True)
    assert torch.autograd.gradcheck(lambda s: sosfilt_diff(s, x), (sos,), eps=1e-6, atol=1e-5)


def test_fit_recovers_a_peaking_eq_and_starts_as_jax():
    freqs = np.geomspace(50, 20000, 96).astype(np.float32)
    true = biquad_coefficients_diff(BiquadEqType.Peaking, FS, 1500.0, 6.0, 1.2)[None]
    target_db = 20 * np.log10(np.abs(sosfreqz_diff(true, freqs, FS).numpy()) + 1e-12)

    def make_sos(params):
        fc = torch.exp(params[0])
        q = 0.1 + torch.nn.functional.softplus(params[2])
        return biquad_coefficients_diff(BiquadEqType.Peaking, FS, fc, params[1], q)[None]

    def make_sos_jax(params):
        fc = jnp.exp(params[0])
        q = 0.1 + jax.nn.softplus(params[2])
        return jdiff.biquad_coefficients_diff(_jax_peaking(), FS, fc, params[1], q)[None]

    params0 = np.asarray([np.log(800.0), 0.0, 0.5], np.float32)
    params, losses = fit_sos_to_magnitude(make_sos, params0, target_db, freqs, FS, steps=400,
                                          lr=0.05)
    fitted_db = 20 * np.log10(np.abs(sosfreqz_diff(make_sos(params), freqs, FS).numpy()) + 1e-12)
    assert float(losses[-1]) < float(losses[0]) * 0.05
    assert np.max(np.abs(fitted_db - target_db)) < 1.0
    # from 0 dB the section is flat: its frequency and Q have gradients of
    # float noise, whose signs Adam's first steps follow; from 2 dB the two
    # fits walk together
    start = np.asarray([np.log(800.0), 2.0, 0.5], np.float32)
    _, early = fit_sos_to_magnitude(make_sos, start, target_db, freqs, FS, steps=20, lr=0.05)
    _, jearly = jdiff.fit_sos_to_magnitude(make_sos_jax, jnp.asarray(start), target_db, freqs,
                                           FS, steps=20, lr=0.05)
    np.testing.assert_allclose(early.numpy(), np.asarray(jearly), rtol=1e-4)


@pytest.mark.parametrize("T", [17, 255, 256, 1000, 4097])
@pytest.mark.parametrize("reverse", [False, True])
def test_cumsum_mxu(T, reverse):
    from dsptoolbox_tpu.ops.prefix import cumsum_mxu as jcumsum

    x = np.random.default_rng(7 + T).standard_normal((3, T)).astype(np.float32)
    got = cumsum_mxu(torch.from_numpy(x), reverse=reverse).numpy()
    ref = np.cumsum(x[:, ::-1] if reverse else x, axis=-1, dtype=np.float64)
    if reverse:
        ref = ref[:, ::-1]
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4 * np.sqrt(T))
    np.testing.assert_allclose(got, np.asarray(jcumsum(jnp.asarray(x), reverse=reverse)),
                               rtol=2e-5, atol=1e-4 * np.sqrt(T))


def test_cumsum_mxu_energy_accuracy_and_float64():
    e = np.random.default_rng(0).standard_normal((2, 48000)).astype(np.float32) ** 2
    got = cumsum_mxu(torch.from_numpy(e), reverse=True).numpy()
    ref = np.cumsum(e[:, ::-1].astype(np.float64), axis=-1)[:, ::-1]
    np.testing.assert_allclose(got, ref, rtol=5e-6)
    x64 = np.random.default_rng(1).standard_normal((2, 3, 700))
    np.testing.assert_allclose(cumsum_mxu(x64).numpy(), np.cumsum(x64, axis=-1), rtol=1e-12,
                               atol=1e-12)

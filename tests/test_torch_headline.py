"""The port's measurement chain (`dsptoolbox_tpu_torch.headline.run`)
against the JAX package's single-chip entry (`__graft_entry__._make_fn`) on
the CPU, in both filter-bank modes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import assert_close
from dsptoolbox_tpu_torch import headline
from dsptoolbox_tpu_torch.transfer_functions import _backend as tf_backend

torch.set_num_threads(1)

T = 4096
_RNG = np.random.default_rng(0)
X = _RNG.standard_normal((4, T)).astype(np.float32)
EXC = np.fft.rfft(_RNG.standard_normal(T).astype(np.float32)).astype(np.complex64)
REG = np.full(T // 2 + 1, 1e-3, dtype=np.float32)


@pytest.fixture(scope="module")
def jax_outputs():
    from __graft_entry__ import _make_fn

    fn = _make_fn(T)
    return [np.asarray(a) for a in fn(jnp.asarray(X), jnp.asarray(EXC))]


@pytest.mark.parametrize("bank", ["per_band", "banked"])
def test_run_matches_jax_entry(bank, jax_outputs):
    got = headline.run(
        torch.from_numpy(X), torch.from_numpy(EXC), bank=bank, reg=REG
    )
    for name, g, w in zip(("energy", "bands", "ir"), got, jax_outputs):
        assert_close(g.numpy(), w, name=f"{bank}-{name}")


def test_scalar_reg_equals_profile():
    a = headline.run(torch.from_numpy(X), torch.from_numpy(EXC), reg=1e-3)[2]
    b = headline.run(torch.from_numpy(X), torch.from_numpy(EXC), reg=REG)[2]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rejects_unknown_bank():
    with pytest.raises(ValueError, match="bank"):
        headline.run(torch.from_numpy(X), torch.from_numpy(EXC), bank="x")


def test_deconvolution_backend_matches_jax():
    from dsptoolbox_tpu.transfer_functions import _backend as jtf

    num = np.fft.rfft(X.T, axis=0).astype(np.complex64)
    den = np.fft.rfft(_RNG.standard_normal((T, 1)), axis=0).astype(np.complex64)
    freqs = np.fft.rfftfreq(T, 1 / 48000)
    eps = tf_backend.regularization_window([70.0, 100.0, 16000.0, 22000.0], freqs)
    np.testing.assert_array_equal(
        eps, jtf.regularization_window([70.0, 100.0, 16000.0, 22000.0], freqs)
    )
    for e in (eps[:, None], None):
        got = tf_backend.spectral_deconvolve_core(
            torch.from_numpy(num), torch.from_numpy(den), T, e
        )
        want = jtf.spectral_deconvolve_core(
            jnp.asarray(num), jnp.asarray(den), T, e
        )
        assert_close(got.numpy(), np.asarray(want), name="deconvolve")

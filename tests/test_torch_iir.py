"""Port IIR path (`dsptoolbox_tpu_torch.ops.iir_block`, `iir`, `iir_freq`)
against the JAX package on the CPU (its Pallas lead in interpret mode) and
scipy's float64 sosfilt."""

import numpy as np
import pytest
import torch
from scipy.linalg import toeplitz
from scipy.signal import butter, cheby1, sosfilt, sosfilt_zi

import jax.numpy as jnp
from dsptoolbox_tpu.ops import iir as jiir
from dsptoolbox_tpu.ops import iir_block as jblock
from dsptoolbox_tpu.ops import iir_freq as jfreq
from dsptoolbox_tpu.ops.pallas_iir import sosfilt_pallas
from dsptoolbox_tpu_torch import headline
from dsptoolbox_tpu_torch.ops import cuda_iir, cuda_iir_bank, iir, iir_block, iir_freq

torch.set_num_threads(1)

RNG = np.random.default_rng(5)


def _rel_err(got, want):
    return np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))


def _scipy_zi(zi):
    """(B, S, 2) → scipy's (S, B, 2) layout for axis=-1 input."""
    return np.moveaxis(zi, 0, 1)


class TestSosfiltBlock:
    # 4096 + 77 samples: 32 full blocks of 128 and a 77-sample tail
    sos = butter(6, 0.3, output="sos")
    x = RNG.standard_normal((2, 4096 + 77)).astype(np.float32)
    zi = np.tile(sosfilt_zi(sos)[None], (2, 1, 1)) * 0.3

    def test_matches_jax_block(self):
        y_j, zf_j = jblock.sosfilt_block(
            self.sos, jnp.asarray(self.x), zi=jnp.asarray(self.zi, jnp.float32)
        )
        y_t, zf_t = iir_block.sosfilt_block(
            self.sos, torch.from_numpy(self.x), zi=self.zi
        )
        assert y_t.dtype == torch.float32 and zf_t.shape == (2, 3, 2)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
        np.testing.assert_allclose(zf_t.numpy(), np.asarray(zf_j), atol=1e-6)

    def test_lead_matches_pallas_interpret(self):
        L = 128
        lead = (self.x.shape[-1] // L) * L
        key = tuple(np.asarray(self.sos, np.float64).reshape(-1).tolist())
        ops = jblock._block_operators(key, L)
        s0 = self.zi.reshape(2, -1)
        y_p, zf_p = sosfilt_pallas(
            *(np.asarray(m, np.float32) for m in ops),
            jnp.asarray(self.x[:, :lead]),
            s0=jnp.asarray(s0, jnp.float32),
            interpret=True,
        )
        t = iir_block.operators_to_torch(
            dict(zip(("HmatT", "GyT", "ALT", "MT"), ops), zi=s0),
            "cpu",
            torch.float32,
        )
        xb = torch.from_numpy(self.x[:, :lead]).reshape(2, -1, L)
        y_t, zf_t = cuda_iir.sosfilt_lead(
            t["HmatT"], t["GyT"], t["ALT"], t["MT"], xb, t["zi"]
        )
        np.testing.assert_allclose(
            y_t.reshape(2, lead).numpy(), np.asarray(y_p), atol=1e-5
        )
        np.testing.assert_allclose(zf_t.numpy(), np.asarray(zf_p), atol=1e-6)

    def test_lead_through_bank_matches_pallas_interpret(self):
        """The lead as one band of the bank (`cuda_iir.bank_form` through
        the bank's plain version, the kernel's route on the card) against
        the JAX lead, as `test_lead_matches_pallas_interpret` runs it."""
        L = 128
        lead = (self.x.shape[-1] // L) * L
        key = tuple(np.asarray(self.sos, np.float64).reshape(-1).tolist())
        ops = jblock._block_operators(key, L)
        s0 = self.zi.reshape(2, -1)
        y_p, zf_p = sosfilt_pallas(
            *(np.asarray(m, np.float32) for m in ops),
            jnp.asarray(self.x[:, :lead]),
            s0=jnp.asarray(s0, jnp.float32),
            interpret=True,
        )
        t = iir_block.operators_to_torch(
            dict(zip(("HmatT", "GyT", "ALT", "MT"), ops), zi=s0), "cpu", torch.float32
        )
        xb = torch.from_numpy(self.x[:, :lead]).reshape(2, -1, L)
        b_ops, x2, s0b = cuda_iir.bank_form(
            t["HmatT"], t["GyT"], t["ALT"], t["MT"], xb, t["zi"]
        )
        out = torch.zeros((1, 1) + tuple(x2.shape))
        zf_t = cuda_iir_bank.sosfilt_bank_lead_plain(b_ops, x2, out, s0b)
        np.testing.assert_allclose(out[0, 0].numpy(), np.asarray(y_p), atol=1e-5)
        np.testing.assert_allclose(zf_t[0].numpy(), np.asarray(zf_p), atol=1e-6)

    @pytest.mark.parametrize(
        "sos",
        [butter(4, 250.0, fs=48000, output="sos"),
         butter(4, [250.0, 1000.0], btype="bandpass", fs=48000, output="sos")],
        ids=["lp250", "bp250-1k"],
    )
    def test_low_bands_match_scipy_f64(self, sos):
        """The float64 boundary state keeps the low crossover bands within
        5e-6 of scipy, where a float32 state misses it."""
        x = RNG.standard_normal((2, 48000)).astype(np.float32)
        zi = np.tile(sosfilt_zi(sos)[None], (2, 1, 1)) * 0.5
        y, zf = iir_block.sosfilt_block(sos, torch.from_numpy(x), zi=zi)
        y_ref, zf_ref = sosfilt(
            sos, x.astype(np.float64), zi=_scipy_zi(zi)
        )
        assert _rel_err(y.numpy(), y_ref) < 5e-6
        np.testing.assert_allclose(zf.numpy(), _scipy_zi(zf_ref), atol=1e-6)

    @pytest.mark.parametrize(
        "sos",
        [butter(4, 250.0, fs=48000, output="sos"),
         butter(4, [250.0, 1000.0], btype="bandpass", fs=48000, output="sos")],
        ids=["lp250", "bp250-1k"],
    )
    def test_float32_state_misses_scipy(self, sos):
        """Why the boundary state is float64, unlike the JAX lead: the same
        lead with a float32 state misses scipy's 5e-6 on these bands."""
        L = 128
        x = RNG.standard_normal((2, 375 * L)).astype(np.float32)
        zi = np.tile(sosfilt_zi(sos)[None], (2, 1, 1)) * 0.5
        key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
        ops = dict(zip(("HmatT", "GyT", "ALT", "MT"), iir_block._block_operators(key, L)))
        y_ref, _ = sosfilt(sos, x.astype(np.float64), zi=_scipy_zi(zi))
        xb = torch.from_numpy(x).reshape(2, -1, L)
        err = {}
        for state in (torch.float32, torch.float64):
            H, G, A, M = (
                torch.as_tensor(ops[k], dtype=torch.float32 if k == "HmatT" else state)
                for k in ("HmatT", "GyT", "ALT", "MT")
            )
            s0 = torch.as_tensor(zi.reshape(2, -1), dtype=state)
            y, _ = cuda_iir.sosfilt_lead_plain(H, G, A, M, xb, s0)
            err[state] = _rel_err(y.reshape(2, -1).numpy(), y_ref)
        assert err[torch.float64] < 5e-6 < err[torch.float32]

    def test_float64_mode(self):
        x = self.x.astype(np.float64)
        y, zf = iir_block.sosfilt_block(self.sos, torch.from_numpy(x), zi=self.zi)
        y_ref, zf_ref = sosfilt(self.sos, x, zi=_scipy_zi(self.zi))
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-10)
        np.testing.assert_allclose(zf.numpy(), _scipy_zi(zf_ref), atol=1e-10)

    def test_lfilter_block_matches_jax(self):
        b, a = butter(2, 0.2)
        x = torch.from_numpy(self.x)
        zi = np.array([0.1, -0.2])
        y_t, zf_t = iir_block.lfilter_block(b, a, x, zi=zi)
        y_j, zf_j = jblock.lfilter_block(b, a, jnp.asarray(self.x), zi=jnp.asarray(zi))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
        np.testing.assert_allclose(zf_t.numpy(), np.asarray(zf_j), atol=1e-6)


def test_kernel_range(monkeypatch):
    """Every float32 lead goes to `sosfilt_lead`, at any number of blocks
    (T = 1000: 7 blocks of 128) and any block length; a cascade of more
    than 16 sections (N > 32, beyond the kernel's warp-wide state) runs as
    a series of shorter cascades."""
    seen = []

    def lead(H, G, A, M, xb, s0):
        seen.append((xb.shape[-1], A.shape[0]))
        return cuda_iir.sosfilt_lead_plain(H, G, A, M, xb, s0)

    monkeypatch.setattr(iir_block, "sosfilt_lead", lead)
    sos = np.concatenate(
        [butter(2, f, output="sos") for f in np.linspace(0.05, 0.9, 18)]
    )
    x = RNG.standard_normal((2, 16 * 512 + 33)).astype(np.float32)
    zi = RNG.standard_normal((2, 18, 2)) * 0.1
    y, zf = iir_block.sosfilt_block(sos, torch.from_numpy(x), zi=zi, block_size=512)
    assert seen == [(512, 32), (512, 4)]
    assert cuda_iir.MAX_STATES == 32
    y_ref, zf_ref = sosfilt(sos, x.astype(np.float64), zi=_scipy_zi(zi))
    assert _rel_err(y.numpy(), y_ref) < 5e-6
    np.testing.assert_allclose(zf.numpy(), _scipy_zi(zf_ref), atol=1e-6)
    seen.clear()
    short = butter(4, 0.2, output="sos")
    x = RNG.standard_normal((2, 1000)).astype(np.float32)
    y, _ = iir_block.sosfilt_block(short, torch.from_numpy(x))
    assert seen == [(128, 4)]
    assert _rel_err(y.numpy(), sosfilt(short, x.astype(np.float64))) < 5e-6


@pytest.mark.parametrize("L", [3, 8, 98, 128, 200])
def test_hmat_is_the_toeplitz_matrix_of_its_row_0(L):
    """On the card the lead runs on the bank's kernel with h = H[0]: that
    holds because `_block_operators` fills HmatT by diagonals, so it is
    exactly the upper-triangular Toeplitz matrix of its row 0 (HmatT[i, j] =
    h[j - i]). The crossover bands and Butterworth orders 2-32."""
    cascades = list(headline.crossover_bank(48000)) + [
        butter(order, 0.2, output="sos") for order in range(2, 33)
    ]
    for sos in cascades:
        key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
        HmatT = iir_block._block_operators(key, L)[0]
        h = HmatT[0]
        np.testing.assert_array_equal(HmatT, toeplitz(np.r_[h[0], np.zeros(L - 1)], h))


@pytest.mark.parametrize("band", range(4))
@pytest.mark.parametrize("L,K", [(128, 20), (98, 7), (3, 40)])
def test_lead_as_one_bank_band(band, L, K):
    """The lead's argument mapping (`cuda_iir.bank_form`, which the CUDA
    wrapper runs) through the bank's plain version, one crossover band from
    a nonzero start state, equals the lead's plain version (y at 1e-6
    scale-relative, zf at 1e-9); the real form it hands the kernel is the
    bank's own (`kernel_operators`); the bank's default start state is
    zero."""
    sos = headline.crossover_bank(48000)[band]
    B = 3
    key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
    zi = np.tile(sosfilt_zi(sos)[None], (B, 1, 1)) * RNG.uniform(0.2, 1.0, (B, 1, 1))
    t = iir_block.operators_to_torch(
        dict(zip(("HmatT", "GyT", "ALT", "MT"), iir_block._block_operators(key, L)), zi=zi),
        "cpu", torch.float32,
    )
    xb = torch.from_numpy(RNG.standard_normal((B, K, L)).astype(np.float32))
    args = (t["HmatT"], t["GyT"], t["ALT"], t["MT"], xb, t["zi"].reshape(B, -1))
    y_want, zf_want = cuda_iir.sosfilt_lead_plain(*args)
    ops, x, s0 = cuda_iir.bank_form(*args)
    assert x.shape == (B, K * L) and s0.shape == (1,) + tuple(args[5].shape)
    out = torch.zeros((1, 1, B, K * L))
    zf = cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out, s0)
    assert _rel_err(out.reshape(B, K, L).numpy(), y_want.numpy()) <= 1e-6
    z_scale = max(1.0, float(zf_want.abs().max()))
    assert float((zf[0] - zf_want).abs().max()) <= 1e-9 * z_scale

    real = cuda_iir_bank.kernel_operators({k: ops[k] for k in ("HmatT", "GyT", "ALT", "MT")})
    assert ops["kernel"]["lanes"] == real["lanes"] == 2 * len(sos)
    for k in ("h", "G", "A", "M"):
        assert ops["kernel"][k].shape == real[k].shape and torch.equal(ops["kernel"][k], real[k])

    zero = cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out, torch.zeros_like(s0))
    out_default = torch.zeros_like(out)
    assert torch.equal(cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out_default), zero)
    assert torch.equal(out_default, out)


class TestZeroState:
    sos = butter(4, 0.25, output="sos")

    @pytest.mark.parametrize(
        "B,T", [(2, 1024), (2, 50000), (1, 140000)],
        ids=["block", "freq", "block-long"],
    )
    def test_sosfilt_zero_state_regimes(self, B, T):
        x = RNG.standard_normal((B, T)).astype(np.float32)
        got = iir.sosfilt_zero_state(self.sos, torch.from_numpy(x))
        want = jiir.sosfilt_zero_state(self.sos, jnp.asarray(x))
        y_ref = sosfilt(self.sos, x.astype(np.float64), axis=-1)
        assert _rel_err(got.numpy(), y_ref) < 5e-6
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_freq_helpers_match_jax(self):
        sos = cheby1(6, 0.5, 0.05, output="sos")
        assert iir_freq.decay_margin(sos) == jfreq.decay_margin(sos)
        assert iir_freq.plan_nfft(sos, 20000) == jfreq.plan_nfft(sos, 20000)
        for full in (False, True):
            got = iir_freq.sos_freq_response(sos, 4096, full)
            want = jfreq.sos_freq_response(sos, 4096, full)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(
                iir_freq.sos_freq_response_host(sos, 4096, full),
                jfreq.sos_freq_response_host(sos, 4096, full),
            )

    def test_sosfilt_zi_matches_jax(self):
        np.testing.assert_array_equal(iir.sosfilt_zi(self.sos), jiir.sosfilt_zi(self.sos))


class TestBank:
    bank = np.stack([butter(4, f, output="sos") for f in (0.1, 0.3, 0.5, 0.8)])

    @pytest.mark.parametrize("T", [4096 + 50, 3000], ids=["tail", "exact"])
    def test_bank_apply_matches_jax(self, T):
        x = RNG.standard_normal((3, T)).astype(np.float32)
        ops = jblock.sosfilt_bank_operators(self.bank, T)
        want = jblock.sosfilt_bank_apply(ops, jnp.asarray(x))
        # operators built by the JAX package, carried over to the port
        t_ops = iir_block.operators_to_torch(ops, "cpu", torch.float32)
        got = iir_block.sosfilt_bank_apply(t_ops, torch.from_numpy(x))
        assert got.shape == (4, 3, T)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        # the port's own builder gives the same operators
        own = iir_block.sosfilt_bank_operators(self.bank, T)
        for k in ("HmatT", "GyT", "ALT", "MT"):
            np.testing.assert_array_equal(own[k], ops[k])
        for i in range(len(x)):
            for b in range(4):
                y_ref = sosfilt(self.bank[b], x[i].astype(np.float64))
                assert _rel_err(got[b, i].numpy(), y_ref) < 5e-6

"""The port's generators (`dsptoolbox_tpu_torch.generators`: `noise`,
`dirac`, `oscillator`) and `helpers.frequency_conversion` against the JAX
package on the CPU. `dirac` and `oscillator` are held to the JAX package
directly; `noise` draws from a `torch.Generator`, which cannot give
``jax.random``'s samples, so it is held as the JAX package's own tests
hold it (`tests/test_distances_generators.py:94-130`): the same seed gives
the same samples, the shape and the peak level are right, the spectral
slope is within 0.2."""

import numpy as np
import pytest
import torch
from scipy.signal import welch

from conftest import assert_close
import dsptoolbox_tpu as jdsp
from dsptoolbox_tpu.helpers import frequency_conversion as jfc
from dsptoolbox_tpu_torch import _config, generators
from dsptoolbox_tpu_torch.classes import ImpulseResponse
from dsptoolbox_tpu_torch.generators import NoiseType, WaveForm
from dsptoolbox_tpu_torch.helpers import frequency_conversion as fc
from dsptoolbox_tpu_torch.standard.enums import FadeType

torch.set_num_threads(1)

FS = 10000


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The generators build on the default device, "cuda" out of the box:
    these tests run on the CPU."""
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)


@pytest.mark.parametrize("length,delay,channels", [(512, 0, 1), (100, 37, 3), (7, 6, 2)])
def test_dirac_matches_jax(length, delay, channels):
    got = generators.dirac(length, FS, delay, channels)
    want = jdsp.generators.dirac(length, FS, delay, channels)
    assert isinstance(got, ImpulseResponse)
    np.testing.assert_array_equal(got.time_data.numpy(), np.asarray(want.time_data))
    with pytest.raises(AssertionError):
        generators.dirac(length, FS, length, channels)


@pytest.mark.parametrize("mode", [m.name for m in WaveForm])
@pytest.mark.parametrize("f0,fs,cutoff", [(100.0, 8000, None), (997.0, 48000, 12000.0),
                                          (440.0, 44100, None)])
def test_oscillator_matches_jax(mode, f0, fs, cutoff):
    kw = dict(length_seconds=0.5, harmonic_cutoff_hz=cutoff, peak_level_dbfs=-6.0,
              number_of_channels=2, padding_end_seconds=0.01)
    got = generators.oscillator(f0, fs, mode=getattr(WaveForm, mode), **kw)
    want = jdsp.generators.oscillator(f0, fs, mode=getattr(jdsp.generators.WaveForm, mode), **kw)
    assert got.time_data.shape == np.asarray(want.time_data).shape
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 1e-5, mode)


def test_oscillator_blocks_and_uncorrelated_phases(monkeypatch):
    """A harmonic sum split into blocks gives the unblocked sum; the
    uncorrelated phases follow the seed."""
    whole = generators.oscillator(50.0, 8000, 0.25, WaveForm.Sawtooth, fade=None)
    monkeypatch.setattr(generators.generators, "_HARMONIC_BLOCK", 2000)
    blocked = generators.oscillator(50.0, 8000, 0.25, WaveForm.Sawtooth, fade=None)
    assert_close(blocked.time_data.numpy(), whole.time_data.numpy(), 1e-6, "blocks")
    a = generators.oscillator(300.0, 8000, 0.1, number_of_channels=3, uncorrelated=True, seed=4)
    b = generators.oscillator(300.0, 8000, 0.1, number_of_channels=3, uncorrelated=True, seed=4)
    torch.testing.assert_close(a.time_data, b.time_data, rtol=0, atol=0)
    assert float((a.time_data[:, 0] - a.time_data[:, 1]).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", ["White", "Pink", "Red", "Blue", "Violet", "Grey", 1.5])
def test_noise_shape_peak_and_seed(kind):
    nt = kind if isinstance(kind, float) else getattr(NoiseType, kind)
    a = generators.noise(0.5, FS, nt, peak_level_dbfs=-20, number_of_channels=2, seed=10,
                         padding_end_seconds=0.1)
    b = generators.noise(0.5, FS, nt, peak_level_dbfs=-20, number_of_channels=2, seed=10,
                         padding_end_seconds=0.1)
    c = generators.noise(0.5, FS, nt, peak_level_dbfs=-20, number_of_channels=2, seed=11,
                         padding_end_seconds=0.1)
    td = a.time_data.numpy()
    assert td.shape == (FS // 2 + FS // 10, 2) and np.all(np.isfinite(td))
    np.testing.assert_array_equal(td, b.time_data.numpy())
    assert np.abs(td - c.time_data.numpy()).max() > 1e-3
    np.testing.assert_array_equal(td[FS // 2:], 0.0)
    # normalised before the fades, which may lower the peak a little
    peak = 20 * np.log10(np.abs(td).max(axis=0))
    np.testing.assert_allclose(peak, -20, atol=0.5)
    assert np.all(peak <= -20 + 1e-4)


@pytest.mark.parametrize("kind,slope", [("Pink", -1.0), ("Red", -2.0), ("Blue", 1.0),
                                        ("Violet", 2.0), ("White", 0.0), (0.5, -0.5)])
def test_noise_spectral_slope(kind, slope):
    """The psd's log-log slope within 0.2 (`test_distances_generators.py:117`)."""
    nt = kind if isinstance(kind, float) else getattr(NoiseType, kind)
    n = generators.noise(4.0, FS, nt, seed=2)
    f, psd = welch(n.time_data[:, 0].numpy(), fs=FS, nperseg=2048)
    keep = (f > 50) & (f < 4000)
    got = np.polyfit(np.log10(f[keep]), np.log10(psd[keep]), 1)[0]
    assert abs(got - slope) < 0.2, got


def test_white_noise_keeps_the_always_true_low_band_cut():
    """parity: ``type != White or type != 0.0`` is always true, so white
    noise too has its bins below 15 Hz at 1e-20 (`generators.py:87-88`), in
    the JAX package and the port."""
    for gen in (generators, jdsp.generators):
        n = gen.noise(2.0, FS, gen.NoiseType.White, fade=None, seed=1)
        spec = np.abs(np.fft.rfft(np.asarray(n.time_data)[:, 0].astype(np.float64)))
        f = np.fft.rfftfreq(2 * FS, 1 / FS)
        low = (f > 0) & (f < 14)
        assert spec[low].max() < 1e-4 * np.median(spec), gen


def test_frequency_conversion_matches_jax():
    f = np.linspace(10, 20000, 333)
    np.testing.assert_allclose(fc.hz2mel(f), jfc.hz2mel(f))
    np.testing.assert_allclose(fc.mel2hz(fc.hz2mel(f)), f)
    for mode in ("a", "c"):
        for db in (True, False):
            np.testing.assert_allclose(fc.frequency_weighting(f, mode, db),
                                       np.asarray(jfc.frequency_weighting(f, mode, db)),
                                       rtol=1e-12, atol=1e-12)


def test_chirp_fades_unchanged():
    got = generators.chirp(FS, generators.ChirpType.Logarithmic, [50, 4000], 0.5,
                           fade=FadeType.Linear, number_of_channels=2)
    want = jdsp.generators.chirp(FS, jdsp.generators.ChirpType.Logarithmic, [50, 4000], 0.5,
                                 fade=jdsp.FadeType.Linear, number_of_channels=2)
    assert_close(got.time_data.numpy(), np.asarray(want.time_data), 1e-5, "chirp")


@pytest.mark.parametrize("mode", ["Harmonic", "Square"])
def test_oscillator_phase_does_not_drift_over_a_minute(mode):
    """The JAX package wraps each harmonic's phase in float64 before its
    float32 sine, and so does the port: at 60 s × 48 kHz the sine stays
    within float32 rounding of float64 numpy (no drift) and of the JAX
    package."""
    fs, f0, cutoff = 48000, 997.0, 4000.0
    got = generators.oscillator(f0, fs, 60.0, getattr(WaveForm, mode), cutoff,
                                peak_level_dbfs=0.0, fade=None).time_data[:, 0].numpy()
    n = np.arange(60 * fs, dtype=np.float64)
    orders = [1] if mode == "Harmonic" else [k for k in (1, 3) if k * f0 < cutoff]
    ref = sum(np.sin(2 * np.pi * (k * f0 / fs) * n) / k for k in orders)
    ref /= np.abs(ref).max()
    err = np.abs(got - ref).max()
    print(f"oscillator {mode} 60 s vs float64 numpy: max abs err {err:.3e}")
    assert err < 2e-6
    want = jdsp.generators.oscillator(f0, fs, 60.0, getattr(jdsp.generators.WaveForm, mode),
                                      cutoff, peak_level_dbfs=0.0, fade=None)
    assert np.abs(got - np.asarray(want.time_data)[:, 0]).max() < 2e-6

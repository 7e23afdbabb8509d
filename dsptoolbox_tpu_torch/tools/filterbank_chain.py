"""The filter-bank configuration, built through the public API (the JAX
package's BASELINE config 3, `tools/bench_suite.py:222`: a Linkwitz-Riley
crossover, a gammatone analysis bank and polyphase resampling), with the
ANSI S1.11 1/3-octave analysis as its real-bank path.

At full width: 64 channels × 10 s at 44.1 kHz (441,000 samples), float32.
The repository has no ``fuer_elise.wav``, so `signal` makes the input from
a seed: per channel three decaying harmonic tones (fundamentals 100-1000
Hz, harmonics up to 4 kHz) over noise at −40 dB.

`run` applies, to one `Signal`:

- ``linkwitz_riley_crossovers([250, 1000, 4000], [4, 4, 4])`` in Parallel
  mode (4 bands, frequency sampling of the composite responses);
- ``auditory_filters_gammatone([500, 4000])`` in Parallel mode (16 complex
  bands: the complex route of the filter-bank kernel B3 on a CUDA device);
- ``resample(sig, fs // 3)``;
- ``fractional_octave_bands([31.5, 16e3], 3, 6)`` in Parallel mode (28
  bands × 6 sections: the real route of B3).

The signals go to `_config.default_device()` unless a device is given.
Used by ``chip_smoke.py`` and `tools.profile_chain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..classes import Signal
from ..filterbanks import (
    auditory_filters_gammatone,
    fractional_octave_bands,
    linkwitz_riley_crossovers,
)
from ..standard.enums import FilterBankMode
from ..standard.resampling import resample

FS = 44100
CHANNELS = 64
SECONDS = 10
CROSSOVERS_HZ = (250.0, 1000.0, 4000.0)
CROSSOVER_ORDERS = (4, 4, 4)
GAMMATONE_RANGE_HZ = (500.0, 4000.0)
THIRD_OCTAVE_RANGE_HZ = (31.5, 16e3)
THIRD_OCTAVE_ORDER = 6
NOISE_DB = -40.0


def signal(seconds: float = SECONDS, channels: int = CHANNELS, fs: int = FS,
           seed: int = 0, device=None) -> Signal:
    """The synthetic recording ``(seconds·fs, channels)``: per channel
    three tones with onsets in the first half, each with harmonics 1-4
    below 4 kHz at amplitudes 0.2/k, decaying with time constants of
    0.3-2 s, plus white noise at `NOISE_DB`; float64 sines on the device,
    float32 data."""
    from .._config import default_device

    rng = np.random.default_rng(seed)
    dev = torch.device(default_device() if device is None else device)
    T = int(seconds * fs)
    n_tones = 3
    f0 = rng.uniform(100.0, 1000.0, (channels, n_tones))
    onset = rng.uniform(0.0, seconds / 2, (channels, n_tones))
    tau = rng.uniform(0.3, 2.0, (channels, n_tones))
    phase = rng.uniform(0, 2 * np.pi, (channels, n_tones, 4))
    t = torch.arange(T, dtype=torch.float64, device=dev) / fs
    x = torch.as_tensor(10 ** (NOISE_DB / 20) * rng.standard_normal((channels, T)),
                        dtype=torch.float64, device=dev)
    for j in range(n_tones):
        dt = t[None, :] - torch.as_tensor(onset[:, j, None], device=dev)
        env = torch.where(dt >= 0, torch.exp(-dt / torch.as_tensor(tau[:, j, None], device=dev)),
                          torch.zeros((), dtype=torch.float64, device=dev))
        for k in range(1, 5):
            f = f0[:, j] * k
            amp = np.where(f < 4000.0, 0.2 / k, 0.0)
            arg = (2 * np.pi * torch.as_tensor(f[:, None], device=dev) * t[None, :]
                   + torch.as_tensor(phase[:, j, k - 1, None], device=dev))
            x += torch.as_tensor(amp[:, None], device=dev) * env * torch.sin(arg)
    return Signal(None, x.to(torch.float32).T, fs)


def banks(fs: int = FS):
    """``(lr, gammatone, third_octave)``: the three banks of the
    configuration (host designs; built once)."""
    lr = linkwitz_riley_crossovers(list(CROSSOVERS_HZ), list(CROSSOVER_ORDERS), fs)
    gt = auditory_filters_gammatone(list(GAMMATONE_RANGE_HZ), sampling_rate_hz=fs)
    third = fractional_octave_bands(list(THIRD_OCTAVE_RANGE_HZ), 3, THIRD_OCTAVE_ORDER, fs)[0]
    return lr, gt, third


def run(sig: Signal, lr, gt, third):
    """The chain: ``(LR bands, gammatone bands, resampled signal,
    1/3-octave bands)``."""
    lr_bands = lr.filter_signal(sig, FilterBankMode.Parallel)
    gt_bands = gt.filter_signal(sig, FilterBankMode.Parallel)
    resampled = resample(sig, sig.sampling_rate_hz // 3)
    third_bands = third.filter_signal(sig, FilterBankMode.Parallel)
    return lr_bands, gt_bands, resampled, third_bands

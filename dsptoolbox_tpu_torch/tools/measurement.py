"""The transfer-function measurement configuration, built through the
public API (the JAX package's BASELINE config 1, "chirp → rir: spectral
deconvolution transfer function + windowed IR", carried through to a
1/3-octave smoothed transfer function).

A 16-microphone room measurement at 48 kHz, at full width:

- the excitation: ``generators.chirp(48000, ChirpType.SyncLog, [20, 20000],
  5.0, padding_end_seconds=1.0)``, 288,000 samples;
- the recording: the sweep convolved in float64 with 16 synthetic room IRs
  (`room_irs`: a propagation delay of 2-10 ms, exponentially decaying noise
  with RT60 0.6 s, noise at −60 dB), float32, (288,000, 16). The
  repository has no ``chirp.wav`` / ``rir.wav``, so the inputs are made from
  a seed;
- `run`: ``spectral_deconvolve`` with automatic regularization (−30 dB) →
  IR (288,000, 16); ``window_ir(ir, 65536)`` (adaptive Hann, 75 % constant)
  → (65,536, 16); ``complex_smoothing(windowed, 3, RealImaginary)`` over
  32,769 bins, which runs the banded operator (kernel B4 on a CUDA device).

The signals go to `_config.default_device()`. Used by ``chip_smoke.py`` and
`tools.profile_chain`.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve

from ..classes import Signal
from ..generators import ChirpType, chirp
from ..transfer_functions import (
    SmoothingDomain,
    complex_smoothing,
    spectral_deconvolve,
    window_ir,
)

FS = 48000
CHANNELS = 16
SWEEP_RANGE_HZ = (20, 20000)
SWEEP_S = 5.0
PAD_S = 1.0
RT60_S = 0.6
IR_SECONDS = 0.75
NOISE_DB = -60.0
IR_LENGTH = 65536
OCTAVE_FRACTION = 3


def excitation():
    """The SyncLog sweep as a `Signal` (288,000 × 1)."""
    sig, _ = chirp(FS, ChirpType.SyncLog, list(SWEEP_RANGE_HZ), SWEEP_S,
                   padding_end_seconds=PAD_S)
    return sig


def room_irs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``(irs (n, 16) float64, delays (16,) in samples)``: a unit direct
    sound at a seeded delay of 2-10 ms, then noise decaying by 60 dB in
    `RT60_S` (peak ≤ 0.1, so the direct sound is each IR's peak), over
    noise at `NOISE_DB`."""
    rng = np.random.default_rng(seed)
    n = int(IR_SECONDS * FS)
    delays = np.round(rng.uniform(2e-3, 10e-3, CHANNELS) * FS).astype(int)
    t = np.arange(n) / FS
    decay = np.exp(-np.log(1e3) * t / RT60_S)
    irs = 10 ** (NOISE_DB / 20) * rng.standard_normal((n, CHANNELS))
    for c, d in enumerate(delays):
        irs[d, c] += 1.0
        irs[d + 1:, c] += 0.1 * decay[: n - d - 1] * np.clip(
            rng.standard_normal(n - d - 1), -3, 3) / 3
    return irs, delays


def recording(sweep: Signal, irs: np.ndarray) -> Signal:
    """The sweep through each room IR, convolved in float64, float32."""
    x = sweep.time_data[:, 0].double().cpu().numpy()
    rec = np.stack(
        [fftconvolve(x, irs[:, c])[: len(x)] for c in range(irs.shape[1])], axis=1
    )
    return Signal(None, rec.astype(np.float32), FS)


def run(rec: Signal, sweep: Signal):
    """The measurement path: ``(ir, windowed ir, start positions (device),
    smoothed Spectrum)``."""
    ir = spectral_deconvolve(rec, sweep)
    windowed, starts = window_ir(ir, IR_LENGTH, return_device=True)
    smoothed = complex_smoothing(windowed, OCTAVE_FRACTION,
                                 SmoothingDomain.RealImaginary)
    return ir, windowed, starts, smoothed

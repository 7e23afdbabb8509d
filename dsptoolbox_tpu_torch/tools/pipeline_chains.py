"""The chains that run through `pipeline`, at full width: each is a user
function of `Signal`s built from the public API, with its inputs made from
a seed. Used by ``chip_smoke.py`` and `tools.profile_chain` (``--case
pipeline``), which capture each chain into a CUDA graph and hold the
replays against the eager run.

- ``C2 (a)``, ``C2 (b)``: config 2 (`speech_chain.run`: STFT → ISTFT,
  Welch spectrum, append, Welch CSM; kernel B1 three times) at 1 × 4 s and
  16 × 60 s at 48 kHz;
- ``TF``: the transfer-function measurement (`measurement`, 16 mics × 6 s):
  `spectral_deconvolve` with the automatic regularization range →
  `window_ir(..., return_device=True)` → `complex_smoothing` (B4), returning
  the windowed IR (with its window) and the smoothed data;
- ``FB``: config 3 (`filterbank_chain.run`, 64 channels × 10 s at 44.1 kHz,
  B3 for the gammatone and 1/3-octave banks) on a signal with
  ``constrain_amplitude=True``, so that the input's and every band's
  amplitude constraint run in-program (the bank's peaks stay on the
  device);
- ``IIR``: `headline.crossover_bank`'s four Butterworth bands as `Filter`s,
  each `filter_signal` on 16 × 8 s at 48 kHz (longer than 131,072 samples:
  the blocked IIR, B2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import headline
from ..classes import Filter, Signal
from ..transfer_functions import SmoothingDomain, complex_smoothing, spectral_deconvolve, window_ir
from . import filterbank_chain as fc
from . import measurement as ms
from . import speech_chain as sc

IIR_FS = 48000
IIR_SHAPE = (16, 8 * IIR_FS)


@dataclass
class Chain:
    """``fn`` on ``inputs(seed)``; ``kernels``: the counted kernel modules
    (`chip_smoke.counted_modules`' names) its capture must launch; ``tol``:
    the replay's bound against the eager run (scale-relative);
    ``audio_s``: seconds of audio a call (channels × duration)."""

    name: str
    fn: Callable
    inputs: Callable
    kernels: tuple
    tol: float
    audio_s: float


def tf_chain(rec: Signal, sweep: Signal):
    """The measurement path as one function: ``(windowed IR, smoothed
    transfer function (F, C))``."""
    ir = spectral_deconvolve(rec, sweep)
    windowed, _ = window_ir(ir, ms.IR_LENGTH, return_device=True)
    smoothed = complex_smoothing(windowed, ms.OCTAVE_FRACTION, SmoothingDomain.RealImaginary)
    return windowed, smoothed.spectral_data


def chains(dev) -> list[Chain]:
    """The four chains (five sizes) on ``dev``."""
    dev = torch.device(dev)
    lr, gt, third = fc.banks()
    filters = [Filter.from_sos(sos, IIR_FS) for sos in headline.crossover_bank(IIR_FS)]
    sweep = ms.excitation()

    def c2(size):
        C, seconds = size
        return lambda seed: (sc.signal(C, seconds, seed=seed),)

    def tf(seed):
        return ms.recording(sweep, ms.room_irs(seed)[0]), sweep

    def fb(seed):
        sig = fc.signal(seed=seed, device=dev)
        return (Signal(None, sig.time_data, sig.sampling_rate_hz, constrain_amplitude=True),)

    def iir(seed):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal(IIR_SHAPE).astype(np.float32)).to(dev)
        return (Signal(None, x.T, IIR_FS),)

    def iir_chain(sig):
        return tuple(f.filter_signal(sig) for f in filters)

    return [
        Chain("C2 (a)", sc.run, c2(sc.SPEECH), ("framing",), 2e-5, sc.SPEECH[0] * sc.SPEECH[1]),
        Chain("C2 (b)", sc.run, c2(sc.MINUTE), ("framing",), 2e-5, sc.MINUTE[0] * sc.MINUTE[1]),
        Chain("TF", tf_chain, tf, ("banded",), 1e-4,
              ms.CHANNELS * (ms.SWEEP_S + ms.PAD_S)),
        Chain("FB", lambda sig: fc.run(sig, lr, gt, third), fb, ("iir_bank",), 2e-5,
              fc.CHANNELS * fc.SECONDS),
        Chain("IIR", iir_chain, iir, ("iir_lead",), 2e-5,
              IIR_SHAPE[0] * IIR_SHAPE[1] / IIR_FS),
    ]


def leaves(out) -> list:
    """The tensors of a chain's result, in `pipeline`'s order."""
    from ..pipeline import _flatten_result

    got: list = []
    _flatten_result(out, got)
    return got

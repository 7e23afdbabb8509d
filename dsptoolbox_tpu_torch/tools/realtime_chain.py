"""The filter-design and streaming path at real size, on config 2's session
(`tools.speech_chain.signal`: 16 channels × 60 s of pink noise at 48 kHz,
from a seed) and the first of the transfer-function cell's room IRs
(`tools.measurement.room_irs`, 65,536 samples):

- **designs**: A-weighting, a pinking filter at 1 kHz, ten matched peaking
  biquads (31.5 Hz-16 kHz, ±6 dB, Q 1.4), a Thiran fractional delay (0.5
  samples, order 30), a Gaussian kernel (5 ms), the complementary FIR of a
  255-tap lowpass, and ARMA fits of the IR (16, 16) by Yule-Walker and Burg;
  the A-weighting and the EQ cascade applied to the session (B2);
- **parallel filter**: 32 pole pairs log-spaced over 30 Hz-18 kHz, each
  radius from its neighbours' spacing (Bank's fixed-pole design), ``n_fir =
  1``, fitted to the IR, on the session (B2, one launch a section);
- **Kautz filter**: ``from_ir(ir, order=32, iterations=3)`` on the session
  (B2, three launches a pole pair);
- **warped FIR**: 32 taps (the IR's first 32 samples under a Hann
  half-window) at the Bark warping factor for 48 kHz (Smith & Abel), on the
  session (B2, one launch a stage);
- **state-variable filter**: 1 kHz, resonance 0.5, its four bands of the
  session (`ops.iir.linear_recurrence` in float64);
- **streams**: channel 0 in `N_BLOCKS` blocks of `BLOCK` samples through an
  order-4 Butterworth ``(b, a)`` `IIRFilter` at 1 kHz (B2, one launch a
  block) and, rectified, an `ExponentialAverageFilter` (0.01 s up, 0.05 s
  down; `csrc/ema.cu`'s average form, one launch a block); all 16 channels
  through `FIRUniformPartitionedMultichannel` of the 16 room IRs;
- **banks**: the reconstructing 1/3-octave FIR bank (4096 taps) on the
  session and its sum, and a QMF crossover of a 63-tap half-band lowpass,
  analysis with downsampling and reconstruction with upsampling;
- **host loops**: 0.1 s of channel 0 through the order-4 lattice/ladder,
  the warped IIR and the state-space filter, sample by sample.

Each step is a function of its inputs; `chip_smoke.py` (`realtime_phase`)
drives them and holds each to its oracle.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sig
import torch

from .. import filterbanks, realtime
from .._enums import BiquadEqType, FilterBankMode
from ..classes import Filter, ImpulseResponse, Signal
from . import measurement, speech_chain

FS = 48000
SESSION = speech_chain.MINUTE
BLOCK = 1024
N_BLOCKS = 469
HOST_S = 0.1
EQ_HZ = np.geomspace(31.5, 16000.0, 10)
EQ_DB = 6.0
EQ_Q = 1.4
PARALLEL = (32, 30.0, 18000.0)  # pole pairs, lowest and highest frequency
KAUTZ = (32, 3)  # order, iterations
WARPED_TAPS = 32
STREAM_FC = 1000.0
EMA_S = (0.01, 0.05)  # increase, decrease
SVF = (1000.0, 0.5)  # frequency, resonance


def bark_warping(fs: int) -> float:
    """Smith & Abel's Bark warping factor for the sampling rate."""
    return 1.0674 * np.sqrt(2 / np.pi * np.arctan(0.06583 * fs / 1000)) - 0.1916


def session() -> Signal:
    return speech_chain.signal(*SESSION)


def room_irs() -> np.ndarray:
    """The transfer-function cell's 16 room IRs ``(65536, 16)`` float64."""
    return measurement.room_irs()[0]


def ir_signal(irs: np.ndarray) -> ImpulseResponse:
    """The first room IR as a one-channel ImpulseResponse."""
    return ImpulseResponse(None, irs[:, :1], FS)


def designs(ir: ImpulseResponse) -> dict:
    """Every design of the path, as Filters (host designs)."""
    lowpass = Filter.from_ba(sig.firwin(255, 4000.0, fs=FS), [1.0], FS)
    return {
        "a_weighting": filterbanks.weighting_filter(True, sampling_rate_hz=FS),
        "pinking": filterbanks.pinking_filter(1000.0, FS),
        "eq": [filterbanks.matched_biquad(BiquadEqType.Peaking, f, EQ_DB * (-1) ** i, EQ_Q, FS)
               for i, f in enumerate(EQ_HZ)],
        "fractional_delay": filterbanks.fractional_delay(0.5, 30, FS),
        "gaussian": filterbanks.gaussian_kernel(0.005, sampling_rate_hz=FS),
        "complementary": filterbanks.complementary_fir_filter(lowpass),
        "arma_yule_walker": filterbanks.arma(ir, 16, 16, "yule-walker"),
        "arma_burg": filterbanks.arma(ir, 16, 16, "burg"),
    }


def weighted_eq(s: Signal, d: dict) -> Signal:
    """The A-weighting, then the EQ cascade, on the session (B2 each)."""
    y = d["a_weighting"].filter_signal(s)
    for f in d["eq"]:
        y = f.filter_signal(y)
    return y


def bank_poles(n: int, f_lo: float, f_hi: float) -> np.ndarray:
    """``n`` poles log-spaced over [f_lo, f_hi], each radius from its
    neighbours' spacing in angle (Bank's fixed-pole design)."""
    theta = 2 * np.pi * np.geomspace(f_lo, f_hi, n) / FS
    return np.exp(-np.gradient(theta) / 2) * np.exp(1j * theta)


def parallel_filter(ir: ImpulseResponse) -> realtime.ParallelFilter:
    return realtime.ParallelFilter(bank_poles(*PARALLEL), 1, FS).fit_to_ir(ir)


def kautz_filter(ir: ImpulseResponse) -> realtime.KautzFilter:
    return realtime.KautzFilter.from_ir(ir, *KAUTZ)


def warped_fir(irs: np.ndarray) -> realtime.WarpedFIR:
    taps = irs[:WARPED_TAPS, 0] * np.hanning(2 * WARPED_TAPS)[WARPED_TAPS:]
    return realtime.WarpedFIR(taps, bark_warping(FS), FS)


def svf() -> realtime.StateVariableFilter:
    return realtime.StateVariableFilter(*SVF, FS)


def stream_blocks(x: torch.Tensor) -> list:
    """``x (..., T)`` cut into `N_BLOCKS` blocks of `BLOCK` samples along
    its last axis (views)."""
    return [x[..., i * BLOCK:(i + 1) * BLOCK] for i in range(N_BLOCKS)]


def stream_coefficients() -> tuple:
    return sig.butter(4, STREAM_FC, fs=FS)


def stream_iir(x0: torch.Tensor) -> torch.Tensor:
    """Channel 0 ``(T,)`` through a fresh order-4 `IIRFilter`, block by
    block → the joined output ``(N_BLOCKS·BLOCK,)``."""
    f = realtime.IIRFilter(*stream_coefficients())
    return torch.cat([f.process_block(b, 0) for b in stream_blocks(x0)])


def stream_ema(x0: torch.Tensor) -> torch.Tensor:
    """Channel 0, rectified, through a fresh `ExponentialAverageFilter`,
    block by block → ``(N_BLOCKS·BLOCK,)``."""
    f = realtime.ExponentialAverageFilter(*EMA_S, FS)
    return torch.cat([f.process_block(b.abs(), 0) for b in stream_blocks(x0)])


def stream_fir(x: torch.Tensor, irs: np.ndarray) -> torch.Tensor:
    """All channels ``(C, T)`` through `FIRUniformPartitionedMultichannel`
    of the room IRs, block by block → ``(N_BLOCKS·BLOCK, C)``."""
    f = realtime.FIRUniformPartitionedMultichannel(irs)
    f.prepare(BLOCK)
    return torch.cat([f.process_block(b.T) for b in stream_blocks(x)])


def fractional_octave_bank():
    return filterbanks.reconstructing_fractional_octave_bands(
        octave_fraction=3, n_samples=2**12, sampling_rate_hz=FS)


def octave_bands(s: Signal, bank) -> tuple:
    """The bank's bands of ``s`` and their sum ``(bands (B, C, T),
    reconstruction (C, T))``."""
    mb = bank.filter_signal(s, FilterBankMode.Parallel)
    bands = torch.stack([b._x for b in mb.bands])
    return bands, bands.sum(dim=0)


def qmf_crossover():
    return filterbanks.qmf_crossover(Filter.from_ba(sig.firwin(63, 0.5), [1.0], FS))


def qmf(s: Signal, crossover) -> tuple:
    """Analysis with downsampling and reconstruction with upsampling →
    ``(low (C, T/2), high (C, T/2), reconstruction (C, T))``."""
    mb = crossover.filter_signal(s, FilterBankMode.Parallel, downsample=True)
    rec = crossover.reconstruct_signal(mb, upsample=True)
    return mb.bands[0]._x, mb.bands[1]._x, rec._x


def host_filters() -> dict:
    """The filters that run sample by sample on the host."""
    b4, a4 = stream_coefficients()
    b2, a2 = sig.butter(2, STREAM_FC, fs=FS)
    return {
        "lattice": realtime.LatticeLadderFilter(
            *realtime.misc.lattice_ladder_coefficients_iir(b4, a4), FS),
        "warped_iir": realtime.WarpedIIR(b2, a2, bark_warping(FS), FS),
        "state_space": realtime.StateSpaceFilter(*sig.tf2ss(b2, a2)),
    }


def host_loops(x0: np.ndarray) -> dict:
    """``x0`` (host samples of one channel) through each host filter:
    `filter_signal` for the lattice and the warped IIR, `process_sample` in
    a loop for the state-space filter."""
    out = {}
    for name, f in host_filters().items():
        if name == "state_space":
            out[name] = np.array([f.process_sample(v, 0) for v in x0])
        else:
            out[name] = f.filter_signal(Signal(None, x0[:, None], FS)).time_data[:, 0]
    return out


"""The feature-extraction path of `transforms`, built through the public
API at real sizes. Inputs are synthetic from a seed (the repository has no
audio):

- **(a) Speech features** on config 2's session (`tools.speech_chain`:
  16 channels × 60 s of pink noise at 48 kHz, STFT 1024 at 50 %, 5,626
  frames × 513 bins a channel, the framing kernel B1): `log_mel_spectrogram`
  with 40 bands, `mfcc` and `chroma_stft`, each without a plot; `hilbert`;
  `dft` at the 31 one-third-octave centres (`THIRD_OCTAVES`).
- **(b) Spectrum via filter bank** on the same session: 31 order-8
  Butterworth bandpasses a third of an octave wide, in parallel (the
  filter-bank kernel B3, 31 × 16 × 2.88 M float32 outputs), and in zero
  phase (each band through B2, forward and backward).
- **(c) Music analysis** on 1 channel × 10 s at 44.1 kHz (`music`: a
  chord of harmonic tones with vibrato, plus noise): `cwt` with a Morlet
  wavelet at 64 log-spaced frequencies from 50 Hz to 16 kHz, plain and
  synchrosqueezed; `vqt` with its defaults.
- **(d) LPC** on the session resampled to 16 kHz (16 × 960,000,
  `lpc_signal`): order 16, 512-sample windows, hop 256 (3,750 frames a
  channel), Yule-Walker and Burg, with synthesis.
- **(e) IR warping** on 65,536-sample room IRs (`tools.measurement`'s
  windows): `warp` with "bark" at 48 kHz at `WARP_LENGTH` samples and at
  the whole length; `laguerre` at `LAGUERRE_FACTOR` on their first
  `WARP_LENGTH` samples.

`calls` gives every step as ``{name: call}``. Used by ``chip_smoke.py``
(`features_phase`) and `tools.profile_chain` (``--case feat``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import standard, transforms
from .._config import default_device
from ..classes import ImpulseResponse, Signal

FS = 48000
N_MELS = 40
# the 31 one-third-octave centres from 20 Hz to 20 kHz (base 10, exact)
THIRD_OCTAVES = 1000.0 * 10.0 ** (np.arange(-17, 14) / 10)
BANK_ORDER = 8
MUSIC_FS = 44100
MUSIC_S = 10.0
CWT_FREQUENCIES = np.geomspace(50.0, 16000.0, 64)
CWT_H = 3.0
CWT_STEP = 1e-3
LPC_FS = 16000
LPC_ORDER = 16
LPC_WINDOW = 512
LPC_HOP = 256
LPC_SEED = 5
WARP_SCALE = "bark"
WARP_LENGTH = 4096
LAGUERRE_FACTOR = -0.7
# the steps that read the session's power spectrogram (cached with its STFT)
STFT_STEPS = ("(a) log_mel_spectrogram", "(a) mfcc", "(a) chroma_stft")


def music(seed: int = 3, seconds: float = MUSIC_S) -> Signal:
    """A chord (A3, C#4, E4, A4) of harmonic tones with a 5 Hz vibrato and
    decaying harmonics, plus noise at −40 dB, 1 channel at 44.1 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * MUSIC_FS)) / MUSIC_FS
    x = np.zeros_like(t)
    for f0 in (220.0, 277.18, 329.63, 440.0):
        phase = 2 * np.pi * f0 * t + 0.3 * np.sin(2 * np.pi * 5.0 * t)
        for k in range(1, 9):
            x += 0.5**k * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    x = 0.2 * x / np.abs(x).max() + 0.002 * rng.standard_normal(len(t))
    return Signal(None, x.astype(np.float32), MUSIC_FS, device=default_device())


def lpc_signal(session: Signal) -> Signal:
    """The session resampled to `LPC_FS`."""
    return standard.resample(session, LPC_FS)


def morlet() -> transforms.MorletWavelet:
    return transforms.MorletWavelet(b=None, h=CWT_H, step=CWT_STEP)


def laguerre_input(irs: ImpulseResponse) -> ImpulseResponse:
    """The IRs' first `WARP_LENGTH` samples."""
    return irs.copy_with_new_time_data(irs._x[:, :WARP_LENGTH].T)


def calls(session: Signal, music_signal: Signal, lpc_sig: Signal,
          irs: ImpulseResponse) -> dict:
    """Every step of (a)-(e) as ``{name: call}``."""
    tf = transforms
    lag = laguerre_input(irs)
    wavelet = morlet()
    return {
        "(a) log_mel_spectrogram": lambda: tf.log_mel_spectrogram(
            session, n_bands=N_MELS, generate_plot=False),
        "(a) mfcc": lambda: tf.mfcc(session, generate_plot=False),
        "(a) chroma_stft": lambda: tf.chroma_stft(session),
        "(a) hilbert": lambda: tf.hilbert(session),
        "(a) dft at 31 third-octave centres": lambda: tf.dft(session, THIRD_OCTAVES),
        "(b) spectrum_via_filterbank": lambda: tf.spectrum_via_filterbank(
            session, THIRD_OCTAVES, bandwidth_octaves=1 / 3, order=BANK_ORDER),
        "(b) spectrum_via_filterbank, zero phase": lambda: tf.spectrum_via_filterbank(
            session, THIRD_OCTAVES, bandwidth_octaves=1 / 3, order=BANK_ORDER,
            zero_phase=True),
        "(c) cwt": lambda: tf.cwt(music_signal, CWT_FREQUENCIES, wavelet, return_device=True),
        "(c) cwt, synchrosqueezed": lambda: tf.cwt(
            music_signal, CWT_FREQUENCIES, wavelet, synchrosqueezed=True, return_device=True),
        "(c) vqt": lambda: tf.vqt(music_signal, return_device=True),
        "(d) lpc, Yule-Walker": lambda: tf.lpc(lpc_sig, LPC_ORDER, LPC_WINDOW,
                                              hop_size_samples=LPC_HOP),
        "(d) lpc, Burg": lambda: tf.lpc(lpc_sig, LPC_ORDER, LPC_WINDOW, use_burg_method=True,
                                       hop_size_samples=LPC_HOP),
        "(d) lpc, Burg with synthesis": lambda: tf.lpc(
            lpc_sig, LPC_ORDER, LPC_WINDOW, synthesize_encoded_signal=True,
            use_burg_method=True, hop_size_samples=LPC_HOP, seed=LPC_SEED),
        f"(e) warp {WARP_SCALE}, {WARP_LENGTH} samples": lambda: tf.warp(
            irs, WARP_SCALE, False, WARP_LENGTH),
        f"(e) warp {WARP_SCALE}, whole IR": lambda: tf.warp(irs, WARP_SCALE, False),
        f"(e) laguerre {LAGUERRE_FACTOR}, {WARP_LENGTH} samples": lambda: tf.laguerre(
            lag, LAGUERRE_FACTOR),
    }


def run(session: Signal, music_signal: Signal, lpc_sig: Signal, irs: ImpulseResponse) -> dict:
    """Every step once: ``{name: output}``."""
    out = {name: fn() for name, fn in calls(session, music_signal, lpc_sig, irs).items()}
    if torch.cuda.is_available() and session.device.type == "cuda":
        torch.cuda.synchronize()
    return out

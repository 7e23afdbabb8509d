"""The denoise → compress → evaluate path: speech-like bursts in a
multichannel recording, cleaned, compressed, colored by an effects rack and
scored against the clean take, with an EQ matched by gradient descent.

The users are speech and audio engineers who run a denoiser and a dynamics
chain on a long multichannel recording, then score the result against the
clean take. The input is config 2's session (`speech_chain.signal`, pink
noise from a seed; `SESSION`: 16 channels × 60 s at 48 kHz):

- *clean*: the session gated by a burst envelope per channel (bursts of
  `BURST_S`, pauses of `PAUSE_S`, `EDGE_S` raised-cosine edges), the bursts
  at `BURST_DBFS` RMS. The pauses keep the session at `FLOOR_DB` below the
  bursts, a room's floor: at an exact zero the gammatone bands of
  `distances.fw_snr_seg` decay to 0 in float32 and its normalized band
  spectra become 0/0;
- *noisy*: *clean* plus stationary white noise at `NOISE_DBFS` RMS, so the
  pauses fall below the subtractor's −40 dBFS threshold.

`run` drives the path's steps, each a public call:

1. `effects.SpectralSubtractor()` (adaptive, its defaults) on *noisy*;
2. the same subtractor offline: one activity detection and one Welch noise
   PSD (kernel B1) per channel;
3. `effects.Compressor` (`COMPRESSOR`, knee `KNEE_DB`) on step 1's output:
   one launch of `csrc/ema.cu`'s average form on a CUDA signal;
4. the rack (`rack`): distortion, tremolo, chorus and digital delay;
5. the scores of steps 1 and 3 against *clean* (`scores`: SNR, SI-SDR, the
   log-spectral and Itakura-Saito distances on Welch PSDs (B1), fwSNRseg
   over `FW_RANGE_HZ`: the gammatone bank (B3) twice, then B1);
6. the EQ match (`eq_match`): `EQ_SECTIONS` peaking biquads fitted by
   `ops.fit_sos_to_magnitude` (`EQ_STEPS` Adam steps) to the dB ratio of
   *clean*'s and step 1's Welch PSDs on `EQ_POINTS` log-spaced points,
   applied through `Filter` (kernel B2) and through `ops.sosfilt_diff` on
   `SOSFILT_S` of channel 0 with a gradient back to the parameters.

Used by ``chip_smoke.py`` (``effects_phase``) and the CPU tests, which cut
`SESSION`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import distances, effects
from .._enums import BiquadEqType, FilterCoefficientsType
from ..classes import Filter, Signal
from ..generators import NoiseType, noise
from ..ops.differentiable import biquad_coefficients_diff, fit_sos_to_magnitude, sosfilt_diff
from . import speech_chain

FS = speech_chain.FS
SESSION = speech_chain.MINUTE
SEED = 2
BURST_S = (0.3, 1.2)
PAUSE_S = (0.2, 0.6)
EDGE_S = 0.005
BURST_DBFS = -20.0
NOISE_DBFS = -50.0
FLOOR_DB = -60.0
COMPRESSOR = dict(threshold_dbfs=-20, attack_time_ms=5, release_time_ms=50, ratio=4)
KNEE_DB = 6
DISTORTION = ([effects.DistortionType.Arctan, effects.DistortionType.SoftClip], [70, 30], 20)
TREMOLO = (5.0, 0.5)  # LFO frequency, depth
CHORUS = ((15.0, 20.0, 25.0), 5.0, 2.0)  # base delays (ms), depth (ms), LFO frequency
DELAY = (300.0, 0.3, "arctan")  # ms, feedback, saturation
FW_RANGE_HZ = (20.0, 10e3)
SPECTRAL_RANGE_HZ = (20.0, 20000.0)
EQ_POINTS = 512
EQ_RANGE_HZ = (50.0, 16e3)
EQ_SECTIONS = 4
EQ_STEPS = 200
SOSFILT_S = 1.0


def envelope(channels: int, length: int, fs: int, seed: int = SEED) -> np.ndarray:
    """The burst envelope ``(channels, length)``, float64: 1 in a burst,
    ``10^(FLOOR_DB/20)`` in a pause, raised-cosine edges."""
    rng = np.random.default_rng(seed)
    floor = 10 ** (FLOOR_DB / 20)
    edge = int(EDGE_S * fs)
    ramp = floor + (1 - floor) * 0.5 * (1 - np.cos(np.pi * np.arange(edge) / edge))
    env = np.full((channels, length), floor)
    for c in range(channels):
        t = int(rng.uniform(*PAUSE_S) * fs)
        while t < length:
            n = int(rng.uniform(*BURST_S) * fs)
            seg = np.ones(n)
            seg[:edge] = ramp
            seg[-edge:] = ramp[::-1]
            env[c, t:t + n] = seg[: length - t]
            t += n + int(rng.uniform(*PAUSE_S) * fs)
    return env


def inputs(channels: int | None = None, seconds: float | None = None,
           seed: int = SEED, fs: int = FS) -> tuple:
    """``(clean, noisy)`` Signals on `_config.default_device()`: the
    session (`speech_chain.signal`'s pink noise, at ``fs``) gated by
    `envelope`, its bursts at `BURST_DBFS` RMS, plus white noise at
    `NOISE_DBFS` RMS drawn on the device from ``seed``."""
    channels, seconds = (SESSION[0] if channels is None else channels,
                         SESSION[1] if seconds is None else seconds)
    session = noise(seconds, fs, NoiseType.Pink, number_of_channels=channels, seed=seed)
    x = session._x
    env = torch.as_tensor(envelope(x.shape[0], x.shape[1], fs, seed), dtype=x.dtype,
                          device=x.device)
    scale = 10 ** (BURST_DBFS / 20) / x.double().std(dim=-1, correction=0).to(x.dtype)
    clean = x * scale[:, None] * env
    del env
    gen = torch.Generator(device=x.device).manual_seed(seed)
    white = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
    noisy = clean + white * 10 ** (NOISE_DBFS / 20)
    return (session.copy_with_new_time_data(clean.T),
            session.copy_with_new_time_data(noisy.T))


def denoise(noisy: Signal, adaptive: bool = True) -> Signal:
    """Steps 1 and 2: the spectral subtractor with its defaults."""
    return effects.SpectralSubtractor(adaptive_mode=adaptive).apply(noisy)


def compressor() -> effects.Compressor:
    c = effects.Compressor(**COMPRESSOR)
    c.set_advanced_parameters(knee_factor_db=KNEE_DB)
    return c


def compress(sig: Signal) -> Signal:
    """Step 3."""
    return compressor().apply(sig)


def rack(rng=None) -> list:
    """Step 4's effects, the chorus' LFOs with random phases from ``rng``
    (a numpy ``Generator`` or ``RandomState``; by default one seeded with
    `SEED`)."""
    kinds, mix, level = DISTORTION
    distortion = effects.Distortion()
    distortion.set_advanced_parameters(type_of_distortion=list(kinds), mix_percent=list(mix),
                                       distortion_levels_db=[level, level],
                                       offset_db=[-np.inf, -np.inf])
    rng = np.random.default_rng(SEED) if rng is None else rng
    bases, depth, f_lfo = CHORUS
    chorus = effects.Chorus(
        depths_ms=depth, base_delays_ms=list(bases),
        modulators=[effects.LFO(f_lfo, "harmonic", random_phase=True, rng=rng)
                    for _ in bases])
    delay = effects.DigitalDelay(DELAY[0], DELAY[1])
    delay.set_advanced_parameters(saturation=DELAY[2])
    return [distortion,
            effects.Tremolo(TREMOLO[1], effects.LFO(TREMOLO[0], "harmonic")),
            chorus, delay]


def apply_rack(sig: Signal, fx: list) -> list:
    """Each effect of ``fx`` on the output of the one before: the outputs."""
    out = []
    for e in fx:
        sig = e.apply(sig)
        out.append(sig)
    return out


def spectral_range(fs: int) -> list:
    """The log-spectral and Itakura-Saito range: `SPECTRAL_RANGE_HZ` cut at
    Nyquist."""
    return [SPECTRAL_RANGE_HZ[0], min(SPECTRAL_RANGE_HZ[1], fs // 2)]


def score_calls(clean: Signal, processed: Signal, fw_range_hz=FW_RANGE_HZ) -> dict:
    """Step 5's measures of ``processed`` against ``clean``, as calls."""
    f_range = spectral_range(clean.sampling_rate_hz)
    return {
        "snr": lambda: distances.snr(
            clean, processed.copy_with_new_time_data((processed._x - clean._x).T)),
        "si_sdr": lambda: distances.si_sdr(clean, processed),
        "log_spectral": lambda: distances.log_spectral(clean, processed,
                                                       f_range_hz=f_range),
        "itakura_saito": lambda: distances.itakura_saito(clean, processed,
                                                         f_range_hz=f_range),
        "fw_snr_seg": lambda: distances.fw_snr_seg(clean, processed, f_range_hz=fw_range_hz),
    }


def scores(clean: Signal, processed: Signal, fw_range_hz=FW_RANGE_HZ) -> dict:
    return {k: fn() for k, fn in score_calls(clean, processed, fw_range_hz).items()}


def _fc_range(fs: int) -> tuple:
    """The EQ's centre frequencies: 20 Hz to 0.45 × fs (a section at
    Nyquist is a double pole on the unit circle)."""
    return 20.0, 0.45 * fs


def make_sos(params: torch.Tensor, fs: int = FS) -> torch.Tensor:
    """``EQ_SECTIONS`` peaking biquads ``(S, 6)`` from ``params (S, 3)``:
    the centre frequency log-spaced over `_fc_range` by a sigmoid, the
    gain in dB and a softplus Q above 0.1 (bounded, positive, and the three
    on comparable scales)."""
    lo, hi = _fc_range(fs)
    fc = lo * (hi / lo) ** torch.sigmoid(params[:, 0])
    return biquad_coefficients_diff(BiquadEqType.Peaking, fs, fc, params[:, 1],
                                    0.1 + torch.nn.functional.softplus(params[:, 2]))


def eq_target(clean: Signal, denoised: Signal, points: int = EQ_POINTS,
              f_range_hz=EQ_RANGE_HZ) -> tuple:
    """``(freqs, target dB)``: 10·log10 of the channel-mean Welch PSDs of
    ``clean`` over ``denoised``, at ``points`` log-spaced frequencies
    (host float64, one fetch of the ratio), the range cut at 0.9 × Nyquist."""
    top = 0.45 * clean.sampling_rate_hz
    f_range_hz = (f_range_hz[0], min(f_range_hz[1], top))
    f, pc = clean.get_spectrum(return_device=True)
    _, pd = denoised.get_spectrum(return_device=True)
    pc, pd = pc.reshape(len(f), -1), pd.reshape(len(f), -1)
    ratio = (10 * torch.log10(pc.double().mean(dim=-1) / pd.double().mean(dim=-1))).cpu().numpy()
    freqs = np.geomspace(*f_range_hz, points)
    return freqs, np.interp(freqs, f, ratio)


def initial_params(fs: int = FS, sections: int = EQ_SECTIONS) -> np.ndarray:
    """Start of the fit: centres log-spaced 100 Hz-8 kHz (within
    `_fc_range`), 1 dB, Q ≈ 1 (at 0 dB a section is flat and its frequency
    and Q have no gradient)."""
    lo, hi = _fc_range(fs)
    u = np.log(np.geomspace(100.0, min(8000.0, 0.9 * hi), sections) / lo) / np.log(hi / lo)
    return np.stack([np.log(u / (1 - u)), np.ones(sections), np.full(sections, 0.5)], axis=1)


def eq_match(clean: Signal, denoised: Signal, steps: int = EQ_STEPS) -> dict:
    """Step 6: the fit (params, losses, sos), the fitted EQ through
    `Filter` on ``denoised`` (B2 on a float32 CUDA signal), and
    `sosfilt_diff` on `SOSFILT_S` of channel 0 with the gradient of its
    mean square back to the parameters."""
    fs = denoised.sampling_rate_hz
    freqs, target = eq_target(clean, denoised)
    p0 = torch.as_tensor(initial_params(fs), dtype=torch.float32, device=denoised.device)
    params, losses = fit_sos_to_magnitude(lambda p: make_sos(p, fs), p0, target, freqs, fs,
                                          steps=steps)
    sos = make_sos(params, fs).detach()
    eq = Filter({FilterCoefficientsType.Sos: sos.double().cpu().numpy()}, fs)
    p = params.clone().requires_grad_(True)
    x0 = denoised._x[0, : int(SOSFILT_S * fs)]
    y0 = sosfilt_diff(make_sos(p, fs), x0)
    (grad,) = torch.autograd.grad(y0.square().mean(), p)
    return {"freqs": freqs, "target_db": target, "params": params, "losses": losses,
            "sos": sos, "filter": eq, "equalized": eq.filter_signal(denoised),
            "sosfilt_diff": y0.detach(), "grad": grad}


def run(clean: Signal, noisy: Signal, fw_range_hz=FW_RANGE_HZ, rng=None,
        on_step=None) -> dict:
    """Steps 1-6 in order: every output by name, and the `Compressor` as
    ``"compressor"`` (its `_last_gain`). ``rng``: the chorus' LFOs', as
    `rack`; ``on_step(name)`` is called after each step."""
    step = on_step or (lambda name: None)
    out = {"adaptive": denoise(noisy, True)}
    step("adaptive subtractor")
    out["offline"] = denoise(noisy, False)
    step("offline subtractor")
    out["compressor"] = compressor()
    out["compressed"] = out["compressor"].apply(out["adaptive"])
    step("compressor")
    out["rack"] = apply_rack(out["compressed"], rack(rng))
    step("rack")
    out["scores_denoised"] = scores(clean, out["adaptive"], fw_range_hz)
    step("scores, denoised")
    out["scores_compressed"] = scores(clean, out["compressed"], fw_range_hz)
    step("scores, compressed")
    out["eq"] = eq_match(clean, out["adaptive"])
    step("eq match")
    return out

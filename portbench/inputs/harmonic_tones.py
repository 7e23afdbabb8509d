"""Decaying harmonic tones over noise, as config 3's input (the shape of
``dsptoolbox_tpu_torch/tools/filterbank_chain.py:signal``, rewritten here
from the seed in plain torch): per channel ``tones`` tones with onsets in
the first half, fundamentals uniform in ``f0_hz``, harmonics 1 to
``harmonics`` below ``harmonic_limit_hz`` at amplitudes ``amplitude``/k,
decaying with time constants uniform in ``tau_s``, over white noise at
``noise_db``; float64 on the device, float32 data."""

from __future__ import annotations

import math

import numpy as np
import torch


def make(config: dict, count: int, seed: int, device) -> torch.Tensor:
    """``(count, channels, T)`` float32 on ``device``, from ``seed``: the
    tones' parameters from a numpy generator, the noise from a
    `torch.Generator` on the device."""
    fs = int(config["sampling_rate_hz"])
    C = int(config["channels"])
    seconds = float(config["seconds"])
    T = int(round(seconds * fs))
    spec = config["input"]
    n_tones, n_harm = int(spec["tones"]), int(spec["harmonics"])
    rng = np.random.default_rng(int(seed))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    t = torch.arange(T, dtype=torch.float64, device=device) / fs
    out = torch.empty((count, C, T), dtype=torch.float32, device=device)
    for r in range(count):
        f0 = rng.uniform(*spec["f0_hz"], (C, n_tones))
        onset = rng.uniform(0.0, seconds / 2, (C, n_tones))
        tau = rng.uniform(*spec["tau_s"], (C, n_tones))
        phase = rng.uniform(0.0, 2 * math.pi, (C, n_tones, n_harm))
        x = torch.randn((C, T), generator=g, device=device, dtype=torch.float64)
        x *= 10 ** (float(spec["noise_db"]) / 20)
        for j in range(n_tones):
            dt = t[None, :] - torch.as_tensor(onset[:, j, None], device=device)
            env = torch.where(dt >= 0, torch.exp(-dt / torch.as_tensor(tau[:, j, None], device=device)),
                              torch.zeros((), dtype=torch.float64, device=device))
            for k in range(1, n_harm + 1):
                f = f0[:, j] * k
                amp = np.where(f < float(spec["harmonic_limit_hz"]), float(spec["amplitude"]) / k, 0.0)
                arg = (2 * math.pi * torch.as_tensor(f[:, None], device=device) * t[None, :]
                       + torch.as_tensor(phase[:, j, k - 1, None], device=device))
                x += torch.as_tensor(amp[:, None], device=device) * env * torch.sin(arg)
        out[r] = x.to(torch.float32)
    return out

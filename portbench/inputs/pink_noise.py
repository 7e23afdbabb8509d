"""Pink-noise recordings, as config 2's session input (the shape of
``dsptoolbox_tpu_torch/tools/speech_chain.py:signal``, rewritten here from
the seed in plain torch): white Gaussian noise shaped by 1/sqrt(f) in the
frequency domain (DC removed), each channel scaled to ``peak_dbfs`` and
faded in and out over ``fade_ms`` with a raised cosine."""

from __future__ import annotations

import math

import torch


def make(config: dict, count: int, seed: int, device) -> torch.Tensor:
    """``(count, channels, T)`` float32 on ``device``, from ``seed`` (a
    `torch.Generator` on the device; one recording a call)."""
    fs = int(config["sampling_rate_hz"])
    C = int(config["channels"])
    T = int(round(float(config["seconds"]) * fs))
    spec = config["input"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    k = torch.arange(T // 2 + 1, device=device, dtype=torch.float32)
    shape = torch.where(k > 0, k.clamp(min=1).rsqrt(), torch.zeros_like(k))
    n_fade = int(round(float(spec["fade_ms"]) * 1e-3 * fs))
    fade = 0.5 - 0.5 * torch.cos(
        math.pi * torch.arange(n_fade, device=device, dtype=torch.float32) / n_fade)
    peak = 10 ** (float(spec["peak_dbfs"]) / 20)
    out = torch.empty((count, C, T), dtype=torch.float32, device=device)
    for r in range(count):
        white = torch.randn((C, T), generator=g, device=device, dtype=torch.float32)
        pink = torch.fft.irfft(torch.fft.rfft(white, dim=-1) * shape, n=T, dim=-1)
        pink *= peak / pink.abs().amax(dim=-1, keepdim=True)
        pink[:, :n_fade] *= fade
        pink[:, T - n_fade:] *= fade.flip(0)
        out[r] = pink
    return out

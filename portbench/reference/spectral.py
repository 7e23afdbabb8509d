"""Plain reference of the spectral chain (config 2): STFT → ISTFT → Welch
spectrum → the Welch CSM of the signal appended with its ISTFT; the STFT is
compared too, so that a fault in it that the program's own inverse undoes
still shows.

A frozen copy of ``chip_smoke.py:1409-1464`` (``np_frames``, ``np_welch``,
``np_assemble``, ``np_csm_welch``), rewritten in plain torch so that it runs
in float64 on the card; the ISTFT (window² overlap-add) follows upstream
dsptoolbox's ``transforms.istft``. It designs its own window from the
configuration and takes nothing that the program built.

Supported: the periodic Hann window, mean averaging, the FFTBackward
scaling (Welch's amplitude: the square root of the mean |X|²; the CSM's
per-pair square root), hops that divide the window.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..compare import gap, row_gap, to_bf16

ENVELOPE_FLOOR = 1e-4


def _check(p: dict) -> None:
    if (p.get("window_type") != "hann" or p.get("scaling") != "fft_backward"
            or p.get("average", "mean") != "mean" or p.get("method", "welch") != "welch"):
        raise ValueError(f"the spectral reference does not support {p}")


def hann(L: int, dtype, device) -> torch.Tensor:
    """The periodic Hann window of ``L`` samples."""
    n = torch.arange(L, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * n / L)).to(dtype)


def frames(x: torch.Tensor, w: torch.Tensor, step: int, pad: int, detrend: bool) -> torch.Tensor:
    """``x (C, T)`` with ``pad`` zeros at both ends, cut into ceil(T' /
    step) frames (the last zero-padded at the end), times the window, minus
    each frame's mean with ``detrend`` (after the window): ``(C, K, L)``."""
    L = w.shape[0]
    x = F.pad(x, (pad, pad))
    n = x.shape[-1]
    K = -(-n // step)
    x = F.pad(x, (0, max(0, (K - 1) * step + L - n)))
    fr = x.unfold(-1, L, step)[:, :K] * w
    if detrend:
        fr = fr - fr.mean(dim=-1, keepdim=True)
    return fr


def overlap_add(fr: torch.Tensor, step: int) -> torch.Tensor:
    """``fr (C, K, L)`` overlap-added at hop ``step`` (``L`` a multiple of
    it): ``(C, (K + L/step - 1)·step)``."""
    C, K, L = fr.shape
    r = L // step
    out = fr.new_zeros((C, K + r - 1, step))
    for j in range(r):
        out[:, j:j + K] += fr[:, :, j * step:(j + 1) * step]
    return out.reshape(C, -1)


def chain(x: torch.Tensor, config: dict, dtype=torch.float64, rnd=None) -> dict:
    """``{"stft": (C, K, F), "y": (C, T), "welch": (C, F), "csm": (F, 2C,
    2C)}`` of ``x (C, T)``, computed in ``dtype``; ``rnd`` rounds every stage's data (the
    input, the frames, the spectra and each output) for the control."""
    rnd = rnd or (lambda t: t)
    sp, sg = config["spectrum"], config["spectrogram"]
    _check(sp)
    _check(sg)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    C, T = x.shape
    x = rnd(x.to(dtype))

    # STFT (the overlap rounded) and its inverse (the hop truncated)
    L = int(sg["window_length_samples"])
    w = hann(L, dtype, x.device)
    overlap = int(sg["overlap_percent"] / 100 * L + 0.5)
    fr = rnd(frames(x, w, L - overlap, overlap if sg["padding"] else 0, sg["detrend"]))
    S = rnd(torch.fft.rfft(fr, dim=-1))
    del fr
    step = int((1 - sg["overlap_percent"] / 100) * L)
    if L % step or not sg["padding"]:
        raise ValueError("the spectral reference takes padded STFTs with hops dividing the window")
    fr = rnd(torch.fft.irfft(S, n=L, dim=-1))
    out = overlap_add(fr * w, step)
    del fr
    env = overlap_add((w * w).expand(1, out.shape[-1] // step - L // step + 1, L), step)
    y = torch.where(env > ENVELOPE_FLOOR, out / env, out)
    del out
    cut = int(sg["overlap_percent"] / 100 * L)
    y = y[:, cut:-cut]
    y = F.pad(y, (0, max(0, T - y.shape[-1])))[:, :T]
    y = rnd(y)

    # Welch (the overlap truncated)
    L = int(sp["window_length_samples"])
    w = hann(L, dtype, x.device)
    step = L - int(sp["overlap_percent"] / 100 * L)
    X = rnd(torch.fft.rfft(rnd(frames(x, w, step, 0, sp["detrend"])), dim=-1))
    welch = rnd(torch.sqrt((X.real ** 2 + X.imag ** 2).mean(dim=-2)))
    del X

    # the Welch CSM of [x; y]: per-pair square root, Hermitian assembly
    z = torch.cat([x, y])
    X = rnd(torch.fft.rfft(rnd(frames(z, w, step, 0, sp["detrend"])), dim=-1))
    K = X.shape[-2]
    Y = X.permute(2, 0, 1).contiguous()  # (F, 2C, K)
    del X
    Q = torch.matmul(Y.conj(), Y.transpose(-1, -2)) / K  # Q[f, a, b] = mean conj(X_a) X_b
    del Y
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=Q.device)
    Q = Q * (1 - eye) + Q.diagonal(dim1=-2, dim2=-1).real[..., None] * eye
    R = torch.sqrt(torch.complex(Q.real, Q.imag + 0.0))
    mask = torch.ones((n, n), dtype=dtype, device=Q.device).tril()
    mask.diagonal().fill_(0.5)
    lower = R.transpose(-1, -2) * mask
    csm = rnd((lower + lower.transpose(-1, -2).conj()).to(cdtype))
    return {"stft": S, "y": y, "welch": welch, "csm": csm}


def sample_rows(config: dict, rng) -> list:
    """Every channel is compared (the reference runs on the card)."""
    return list(range(int(config["channels"])))


def compare(config: dict, x: torch.Tensor, got: dict, rows: list) -> dict:
    """The numbers compared for one call on the recording ``x (C, T)``:
    ``stft_gap`` and ``y_gap`` (each channel against its own peak),
    ``welch_gap`` and ``csm_gap`` (against the whole output's peak)."""
    ref = chain(x, config)
    return {
        "stft_gap": row_gap(got["stft"], ref["stft"], 0),
        "y_gap": row_gap(got["y"], ref["y"], 0),
        "welch_gap": gap(got["welch"], ref["welch"]),
        "csm_gap": gap(got["csm"], ref["csm"]),
    }


class Control:
    """The reference in the program's place, in float32 arithmetic with
    every stage's data rounded to bfloat16 (the storage a later change
    would be tempted to halve)."""

    def __init__(self, config: dict, traffic: dict, recordings: torch.Tensor, device,
                 rows: list):
        self.config, self.recordings = config, recordings

    def call(self, index: int, span) -> dict:
        return chain(self.recordings[index], self.config, torch.float32, to_bf16)

    @staticmethod
    def extract(outputs: dict, rows: list) -> dict:
        return outputs

"""Effects backend: waveshapers, the compressor's gain computer, LFOs
(`dsptoolbox_tpu/effects/_backend.py`).

The waveshapers and the knee are elementwise torch code on the signal's
rows ``(C, T)``. The compressor's gain smoother is the exponential average
of `ops.cuda_ema` (`csrc/ema.cu`'s average form on a CUDA tensor): the JAX
package's gain recursion, ``coeff = where(g > gain, attack, release)``,
``gain = coeff·g + (1 − coeff)·gain`` from a gain of 1
(`dsptoolbox_tpu/effects/_backend.py:167-183`), is that form with the same
operations in the same order. The LFOs are host numpy, as in the JAX
package; their random phase comes from ``rng`` (a ``numpy.random.Generator``
or ``RandomState``) or, without one, from numpy's global state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..helpers.gain_and_level import from_db
from ..helpers.smoothing import get_smoothing_factor_ema
from ..ops.cuda_ema import ema_average


# ========= Distortion: rows (C, T), each normalized by its peak ===========
def arctan_distortion(inp, distortion_level_db, offset_db):
    offset = 10 ** (offset_db / 20)
    level = 10 ** (distortion_level_db / 20)
    normalized = inp / inp.abs().amax(dim=-1, keepdim=True)
    return torch.atan(normalized * level + offset) * (2 / np.pi)


def hard_clip_distortion(inp, distortion_level_db, offset_db):
    offset = 10 ** (offset_db / 20)
    level = 10 ** (distortion_level_db / 20)
    normalized = inp / inp.abs().amax(dim=-1, keepdim=True)
    return torch.clamp(normalized * level + offset, min=-1, max=1)


def soft_clip_distortion(inp, distortion_level_db, offset_db):
    offset = 10 ** (offset_db / 20)
    level = 10 ** (distortion_level_db / 20)
    normalized = inp / inp.abs().amax(dim=-1, keepdim=True) * (2 / 3)
    normalized = (normalized + offset) * level
    normalized = normalized - normalized**3 / 3
    return torch.clamp(normalized, min=-2 / 3, max=2 / 3)


def clean_signal(inp, distortion_level_db, offset_db):
    return inp


# ========= Compressor =======================================================
def get_knee_func(
    threshold_db: float,
    ratio: float,
    knee_factor_db: float,
    downward_compression: bool,
):
    """Soft-knee compression curve in dB (`_effects.py:152-215`): a callable
    on tensors (numpy input is taken in float64 and returned as numpy)."""
    T = threshold_db
    R = ratio
    W = knee_factor_db

    def curve(x):
        if downward_compression:
            below = x
            knee = x + (1 / R - 1) * (x - T + W / 2) ** 2 / 2 / max(W, 1e-12)
            above = T + (x - T) / R
        else:
            below = T + (x - T) / R
            knee = x - (1 / R - 1) * (x - T - W / 2) ** 2 / 2 / max(W, 1e-12)
            above = x
        y = torch.where(x - T < -W / 2, below,
                        torch.where((x - T).abs() <= W / 2, knee, above))
        if W == 0:
            keep = x <= T if downward_compression else x >= T
            y = torch.where(keep, x, T + (x - T) / R)
        return y

    def compress_in_db(x):
        if torch.is_tensor(x):
            return curve(x)
        return curve(torch.as_tensor(np.asarray(x, np.float64))).numpy()

    return compress_in_db


def gain_request(rows: torch.Tensor, threshold_db: float, ratio: float,
                 knee_factor_db: float, downward_compression: bool) -> torch.Tensor:
    """The gain each sample of ``rows`` asks for: ``10^((knee(L) − L)/20)``
    with ``L = 10·log10(max(x², 1e-30))``, elementwise in the data's dtype
    (`dsptoolbox_tpu/effects/_backend.py:171-174`)."""
    func = get_knee_func(float(threshold_db), float(ratio), float(knee_factor_db),
                         bool(downward_compression))
    min_power = float(from_db(-300.0, False))
    samp_db = 10 * torch.log10(torch.clamp(rows**2, min=min_power))
    return 10 ** ((func(samp_db) - samp_db) / 20)


def smoothing_coefficients(attack_samples: int, release_samples: int) -> tuple:
    """The gain smoother's ``(attack, release)`` coefficients: the
    exponential average's increase and decrease."""
    return (get_smoothing_factor_ema(max(int(attack_samples), 1e-12), 1),
            get_smoothing_factor_ema(max(int(release_samples), 1e-12), 1))


def compressor_gain(
    rows: torch.Tensor,
    threshold_db: float,
    ratio: float,
    knee_factor_db: float,
    attack_samples: int,
    release_samples: int,
    downward_compression: bool,
) -> tuple:
    """``(request, gain)`` of the compressor on ``rows (C, T)``: the
    `gain_request` of every sample and its attack/release average along time
    (`ops.cuda_ema.ema_average` from a gain of 1: one launch of
    `csrc/ema.cu` on a CUDA tensor)."""
    rows = rows.contiguous()
    request = gain_request(rows, threshold_db, ratio, knee_factor_db, downward_compression)
    gain = ema_average(request, rows.new_ones(rows.shape[0]),
                       *smoothing_coefficients(attack_samples, release_samples))
    return request, gain


def compressor_core(
    x: torch.Tensor,
    threshold_db: float,
    ratio: float,
    knee_factor_db: float,
    attack_samples: int,
    release_samples: int,
    mix_compressed: float,
    downward_compression: bool,
) -> torch.Tensor:
    """The reference compressor (`_effects.py:61-149`) on ``x (T, C)`` or
    ``(T,)``: `compressor_gain` on the rows, then ``x·gain``. The rows are
    one contiguous transpose of ``x`` (none for a `Signal`'s time data, a
    view of its rows).

    Departure: the JAX scan also carries an RMS envelope that it never
    reads (`dsptoolbox_tpu/effects/_backend.py:168-170`); it is not
    computed. Parity: ``mix_compressed`` is accepted and not applied, as in
    the reference."""
    single = x.ndim == 1
    rows = x[None] if single else x.T
    _, gain = compressor_gain(rows, threshold_db, ratio, knee_factor_db, attack_samples,
                              release_samples, downward_compression)
    y = rows * gain
    return y[0] if single else y.T


# ========= LFO (host numpy) =================================================
def _uniform(rng, low: float, high: float) -> float:
    return (np.random if rng is None else rng).uniform(low, high)


def harmonic_oscillator(freq, fs, length, random_phase, smooth, rng=None):
    if length is None:
        length = int(fs / freq)
    phase_shift = _uniform(rng, -np.pi, np.pi) if random_phase else 0
    return np.sin(freq / fs * 2 * np.pi * np.arange(length) + phase_shift)


def square_oscillator(freq, fs, length, random_phase, smooth, rng=None):
    if length is None:
        length = int(fs / freq)
    phase_shift = _uniform(rng, -np.pi, np.pi) if random_phase else 0
    x = np.sin(freq / fs * 2 * np.pi * np.arange(length) + phase_shift)
    if smooth == 0:
        return np.sign(x)
    smooth *= 0.25 / 10
    return np.arctan(x / smooth)


def sawtooth_oscillator(freq, fs, length, random_phase, smooth, rng=None):
    if length is None:
        length = int(fs / freq)
    norm_freq = freq / fs
    if smooth == 0:
        phase_shift = _uniform(rng, 0, 1) if random_phase else 0
        x = norm_freq * np.arange(length) + phase_shift
        return (x % 1 - 0.5) * 2
    phase_shift = _uniform(rng, -np.pi, np.pi) if random_phase else 0
    x = np.pi * norm_freq * np.arange(length) + phase_shift
    smooth = max(1, (12 - smooth) ** 1.5)
    waveform = np.arcsin(np.tanh(np.cos(x) * smooth) * np.sin(x))
    return waveform / np.abs(np.max(waveform))


def triangle_oscillator(freq, fs, length, random_phase, smooth, rng=None):
    if length is None:
        length = int(fs / freq)
    phase_shift = _uniform(rng, -np.pi, np.pi) if random_phase else 0
    x = np.sin(freq / fs * 2 * np.pi * np.arange(length) + phase_shift)
    if smooth == 0:
        waveform = 2 / np.pi * np.arcsin(x)
    else:
        smooth *= 0.08 / 10
        waveform = 1 - 2 / np.pi * np.arccos((1 - smooth) * x)
    return waveform / np.max(np.abs(waveform))


def get_frequency_from_musical_rhythm(note, bpm) -> float:
    """Musical rhythm → frequency (`_effects.py:475-532`)."""
    assert isinstance(note, str) and isinstance(bpm, (float, int)), (
        "Wrong data types for note duration and bpm"
    )
    factor = 0
    if "quarter" in note:
        factor = 1
    if "half" in note:
        factor = 2
    if "whole" in note:
        factor = 4
    if "eighth" in note:
        factor = 1 / 2
    if "sixteenth" in note:
        factor = 1 / 4
    if "32th" in note:
        factor = 1 / 8
    if "quintuplet" in note:
        factor = 1 / 5
    if "3" in note:
        factor *= 2 / 3
    if "dotted" in note:
        factor *= 1.5
    if factor == 0:
        raise ValueError("No valid note description was passed")
    return 60 / bpm / factor


def get_time_period_from_musical_rhythm(note, bpm) -> float:
    return 1 / get_frequency_from_musical_rhythm(note, bpm)


class LFO:
    """Low-frequency oscillator (`_effects.py:289-413`). ``rng`` (port
    only): the ``numpy.random.Generator`` (or ``RandomState``) of the
    random phase; None takes numpy's global state, as the JAX package."""

    def __init__(
        self,
        frequency_hz,
        waveform: str = "harmonic",
        random_phase: bool = False,
        smooth: float = 0,
        rng=None,
    ):
        self.rng = rng
        self.__set_parameters(frequency_hz, waveform, random_phase, smooth)

    def __set_parameters(self, frequency_hz, waveform, random_phase, smooth):
        if frequency_hz is not None:
            if isinstance(frequency_hz, (float, int)):
                self.frequency_hz = abs(frequency_hz)
            elif isinstance(frequency_hz, (tuple, list)):
                assert len(frequency_hz) == 2, (
                    "frequency_hz as tuple must have length 2"
                )
                self.frequency_hz = get_frequency_from_musical_rhythm(
                    frequency_hz[0], frequency_hz[1]
                )
            else:
                raise TypeError("frequency_hz does not have a valid type")
        if waveform is not None:
            waveform = waveform.lower()
            oscillators = {
                "harmonic": harmonic_oscillator,
                "sawtooth": sawtooth_oscillator,
                "square": square_oscillator,
                "triangle": triangle_oscillator,
            }
            if waveform not in oscillators:
                raise ValueError("Selected waveform is not valid")
            self.oscillator = oscillators[waveform]
        if smooth is not None:
            self.smooth = smooth
        if random_phase is not None:
            self.random_phase = random_phase

    def set_parameters(
        self,
        frequency_hz=None,
        waveform: str | None = None,
        random_phase: bool | None = None,
        smooth: float | None = None,
    ):
        self.__set_parameters(frequency_hz, waveform, random_phase, smooth)

    def get_waveform(
        self, sampling_rate_hz: int, length_samples: int | None = None
    ):
        if length_samples is None:
            length_samples = int(sampling_rate_hz / self.frequency_hz)
        return self.oscillator(
            self.frequency_hz,
            sampling_rate_hz,
            length_samples,
            self.random_phase,
            self.smooth,
            self.rng,
        )

    def plot_waveform(self):
        from ..plots import general_plot

        osc = self.oscillator(2, 1000, 1000, self.random_phase, self.smooth, self.rng)
        fig, ax = general_plot(None, osc, log_x=False, xlabel=None)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_title("Waveform")
        return fig, ax

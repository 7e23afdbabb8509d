"""The speech-analysis configuration, built through the public API (the
JAX package's BASELINE config 2, ``tools/bench_suite.py:121-219``: "STFT →
ISTFT round trip + Welch PSD + CSM" on ``speech.flac``).

`run` is config 2's call sequence on one recording:
``Signal.get_spectrogram`` (window 1024, Hann, 50 % overlap, padding) →
``transforms.istft(S, original_signal=sig)`` → ``Signal.get_spectrum``
(Welch, the Signal's default parameters) → ``standard.append_signals([sig,
y])`` → ``get_csm`` of the appended signal (Welch). On a float32 CUDA
signal the STFT, the Welch spectrum and the Welch CSM frame through kernel
B1.

The repository has no ``speech.flac`` (about 3.9 s at 48 kHz, from the
JAX package's BASELINE timings), so `signal` makes the input: pink
`generators.noise` from a seed, on `_config.default_device()`. Sizes:
`SPEECH` (1 channel × 4 s, the JAX package's) and `MINUTE` (16 channels ×
60 s, a one-minute 16-microphone recording). Used by ``chip_smoke.py`` and
`tools.profile_chain` (``--case c2``), as is `standard_calls`, the
standard functions a user runs on such a recording.
"""

from __future__ import annotations

from .. import standard
from ..classes import Filter, Signal
from ..generators import NoiseType, noise
from ..standard import append_signals
from ..standard.enums import FilterPassType
from ..transforms import istft

FS = 48000
WINDOW = 1024
# (channels, seconds) of the two sizes
SPEECH = (1, 4.0)
MINUTE = (16, 60.0)
# `standard_calls`' delays (samples) and activity-detector settings
SHIFT = 1234
FRACTIONAL_SHIFT = 250.3
ACTIVITY_CHANNEL = 3
ACTIVITY_THRESHOLD_DB = -20.0


def signal(channels: int, seconds: float, seed: int = 2) -> Signal:
    """Pink noise at −10 dBFS peak, faded, as config 2's input."""
    sig = noise(seconds, FS, NoiseType.Pink, number_of_channels=channels, seed=seed)
    sig.set_spectrogram_parameters(window_length_samples=WINDOW)
    return sig


def run(sig: Signal):
    """Config 2's chain: ``(y, Welch spectrum, CSM (F, 2C, 2C))``, as
    tensors (the getters with ``return_device``; the CSM is `get_csm`'s
    cached complex tensor)."""
    t, f, S = sig.get_spectrogram(force_computation=True, return_device=True)
    y = istft(S, original_signal=sig)
    f2, sp = sig.get_spectrum(force_computation=True, return_device=True)
    two = append_signals([sig, y])
    f3, C = two._csm()
    return y, sp, C


def activity_pre_filter(fs: int = FS) -> Filter:
    """The activity detector's pre-filter: a 4th-order Butterworth
    high-pass at 100 Hz, run in zero phase."""
    return Filter.iir_filter(4, 100.0, FilterPassType.Highpass, fs)


def standard_calls(sig: Signal) -> dict:
    """The standard functions on a recording of at least 5 channels, as
    ``{name: call}``: `lufs_integrated` on its first 5 channels (K-weighting
    through kernel B2 on a float32 CUDA signal longer than 131,072 samples),
    `true_peak_level`, `rms` and `crest_factor` on all, `latency` against
    copies shifted by `delay` (`SHIFT`) and `fractional_delay`
    (`FRACTIONAL_SHIFT`, sub-sample), `activity_detector` on one channel
    with the zero-phase `activity_pre_filter` (B2, two leads), `envelope`.
    The shifted copies are made here, once."""
    five = sig.get_channels(list(range(5)))
    delayed = standard.delay(sig, SHIFT)
    frac = standard.fractional_delay(sig, FRACTIONAL_SHIFT / sig.sampling_rate_hz)
    hp = activity_pre_filter(sig.sampling_rate_hz)
    return {
        "lufs_integrated (5 ch, B2)": lambda: standard.lufs_integrated(five),
        "true_peak_level": lambda: standard.true_peak_level(sig),
        "rms": lambda: standard.rms(sig),
        "crest_factor": lambda: standard.crest_factor(sig),
        "latency vs delay": lambda: standard.latency(delayed, sig),
        "latency vs fractional_delay (polynomial 2)": lambda: standard.latency(frac, sig, 2),
        "activity_detector (zero-phase pre-filter, B2)": lambda: standard.activity_detector(
            sig, ACTIVITY_THRESHOLD_DB, channel=ACTIVITY_CHANNEL, pre_filter=hp),
        "envelope": lambda: standard.envelope(sig),
    }

"""Signal generators (`dsptoolbox_tpu/generators/generators.py`): colored
noise, sine sweeps, diracs and band-limited oscillators, on
`_config.default_device()`, where the returned signals live.

A phase that reaches ~1e4 rad, where one float32 step is ~1e-3 rad, is
formed in float64 and wrapped before its sine is taken in float32: a
sweep's on the host, an oscillator's harmonics on the device. `noise`
draws from a `torch.Generator` seeded from ``seed`` on the device, so its
samples are not those of the JAX package's ``jax.random`` draws (the same
seed gives the same samples, the spectrum has the same shape).
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import default_device, default_float
from ..classes.filter_helpers import impulse
from ..classes.impulse_response import ImpulseResponse
from ..classes.signal import Signal
from ..helpers.frequency_conversion import frequency_weighting
from ..helpers.gain_and_level import fade as _fade
from ..helpers.gain_and_level import normalize as _normalize
from ..ops.pad_trim import pad_trim_axis
from .._enums import FadeType
from .enums import ChirpType, NoiseType, WaveForm

# elements of an oscillator's (samples, channels, harmonics) block summed at once
_HARMONIC_BLOCK = 2**25


def _generator(seed, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (drawn from
    ``np.random`` when None)."""
    if seed is None:
        seed = np.random.randint(0, 2**31 - 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _fade_both(td: torch.Tensor, fade: FadeType | None, length_seconds: float,
               sampling_rate_hz: int) -> torch.Tensor:
    """Fade in and out over 5 % of the length each, along the last axis."""
    if fade is None:
        return td
    fade_length = 0.05 * length_seconds
    td = _fade(td, fade_length, fade, sampling_rate_hz, True)
    return _fade(td, fade_length, fade, sampling_rate_hz, False)


def noise(
    length_seconds: float,
    sampling_rate_hz: int,
    type_of_noise: NoiseType | float = NoiseType.White,
    peak_level_dbfs: float = -10.0,
    number_of_channels: int = 1,
    fade: FadeType = FadeType.Logarithmic,
    padding_end_seconds: float = 0.0,
    seed=None,
) -> Signal:
    """Colored noise by spectral magnitude shaping with random phase
    (`generators.py:37`). ``type_of_noise`` may be a float ``beta``, for a
    power spectral density ∝ f^-beta.

    parity: ``type_of_noise != White or type_of_noise != 0.0`` is always
    true, so white noise too has its bins below 15 Hz set to 1e-20
    (`generators.py:87-88`)."""
    if not isinstance(type_of_noise, NoiseType):
        assert isinstance(type_of_noise, float), (
            "type_of_noise must be either NoiseType or float"
        )
    assert length_seconds > 0, "Length has to be positive"
    assert peak_level_dbfs <= 0, "Peak level cannot surpass 0 dBFS"
    assert number_of_channels >= 1, "At least one channel should be generated"

    l_samples = int(length_seconds * sampling_rate_hz + 0.5)
    f = np.fft.rfftfreq(l_samples, 1 / sampling_rate_hz)
    p_samples = 0
    if padding_end_seconds != 0:
        assert padding_end_seconds > 0, "Padding has to be a positive time"
        p_samples = int(padding_end_seconds * sampling_rate_hz + 0.5)

    dev = torch.device(default_device())
    dt = default_float()
    gen = _generator(seed, dev)
    F, C = len(f), number_of_channels
    mag = 2.0 + 0.0025 * torch.randn((F, C), generator=gen, dtype=dt, device=dev)
    ph = (torch.rand((F, C), generator=gen, dtype=dt, device=dev) * 2 - 1) * np.pi

    id_low = int(np.argmin(np.abs(f - 15)))
    shape = np.ones(F)
    if type_of_noise == NoiseType.Pink:
        shape[id_low:] = f[id_low:] ** -0.5
    elif type_of_noise == NoiseType.Red:
        shape[id_low:] = 1.0 / f[id_low:]
    elif type_of_noise == NoiseType.Blue:
        shape[id_low:] = f[id_low:] ** 0.5
    elif type_of_noise == NoiseType.Violet:
        shape[id_low:] = f[id_low:]
    elif type_of_noise == NoiseType.Grey:
        w = np.asarray(frequency_weighting(f, "a", db_output=False))
        shape[id_low:] = 1.0 / w[id_low:]
    elif isinstance(type_of_noise, float):
        shape[id_low:] = f[id_low:] ** (-type_of_noise * 0.5)
    if type_of_noise != NoiseType.White or type_of_noise != 0.0:
        shape[:id_low] = 1e-20
    shape[0] = 0.0

    mag = mag * torch.as_tensor(shape, dtype=dt, device=dev)[:, None]
    ph[0, :] = 0.0
    if l_samples % 2 == 0:
        ph[-1, :] = 0.0
    vec = torch.fft.irfft(mag * torch.exp(1j * ph), n=l_samples, dim=0).T  # (C, T)
    vec = _normalize(vec, peak_level_dbfs, peak_normalization=True, per_channel=True)
    vec = _fade_both(vec, fade, length_seconds, sampling_rate_hz)
    return Signal(None, pad_trim_axis(vec, l_samples + p_samples).T, sampling_rate_hz)


def _sin(phase: np.ndarray) -> torch.Tensor:
    return torch.sin(
        torch.as_tensor(phase, dtype=default_float(), device=default_device())
    )


def sync_log_chirp(
    chirp_range_hz, length_seconds: float, sampling_rate_hz: int
):
    """Novak synchronized swept sine (`generators/_generators.py:5-45`):
    ``(sweep (T,), T in seconds)``."""
    f1, f2 = chirp_range_hz[0], chirp_range_hz[1]
    f2f1 = np.log(f2 / f1)
    k = int(f1 * length_seconds / f2f1 + 0.5)
    T = k / f1 * f2f1
    L = int(0.5 + T * f1 / f2f1) / f1
    t = np.linspace(0.0, T, int(T * sampling_rate_hz + 0.5))
    phase = 2.0 * np.pi * f1 * L * (np.exp(t / L) - 1.0)
    return _sin(np.mod(phase, 2.0 * np.pi)), T


def chirp(
    sampling_rate_hz: int,
    type_of_chirp: ChirpType = ChirpType.Logarithmic,
    range_hz=None,
    length_seconds: float = 1.0,
    peak_level_dbfs: float = -10.0,
    number_of_channels: int = 1,
    fade: FadeType = FadeType.Logarithmic,
    phase_offset: float = 0.0,
    padding_end_seconds: float = 0.0,
):
    """Sine sweeps (`generators/generators.py:147-270`). Returns
    ``(Signal, T)`` for SyncLog, else ``Signal``."""
    if range_hz is not None:
        assert len(range_hz) == 2, (
            "range_hz has to contain exactly two frequencies"
        )
        range_hz = sorted(range_hz)
        assert range_hz[0] > 0, (
            "Range has to start with positive frequencies excluding 0"
        )
        assert range_hz[1] <= sampling_rate_hz // 2, (
            "Upper limit for frequency range cannot be bigger than the "
            "nyquist frequency"
        )
    else:
        range_hz = [15, sampling_rate_hz // 2]
    p_samples = 0
    if padding_end_seconds != 0:
        assert padding_end_seconds > 0, "Padding has to be a positive time"
        p_samples = int(padding_end_seconds * sampling_rate_hz)
    l_samples = int(sampling_rate_hz * length_seconds + 0.5)

    T = None
    if type_of_chirp == ChirpType.Linear:
        t = np.linspace(0, length_seconds, l_samples)
        k = (range_hz[1] - range_hz[0]) / length_seconds
        freqs = (range_hz[0] + k / 2 * t) * 2 * np.pi
        chirp_td = _sin(np.mod(freqs * t + phase_offset, 2 * np.pi))
    elif type_of_chirp == ChirpType.Logarithmic:
        t = np.linspace(0, length_seconds, l_samples)
        k = np.exp(
            (np.log(range_hz[1]) - np.log(range_hz[0])) / length_seconds
        )
        chirp_td = _sin(np.mod(
            2 * np.pi * range_hz[0] / np.log(k) * (k**t - 1) + phase_offset,
            2 * np.pi,
        ))
    elif type_of_chirp == ChirpType.SyncLog:
        chirp_td, T = sync_log_chirp(
            range_hz, length_seconds, sampling_rate_hz
        )
    else:
        raise ValueError("Unsupported chirp type")

    chirp_td = _normalize(
        chirp_td, peak_level_dbfs, peak_normalization=True, per_channel=True
    )
    chirp_td = _fade_both(chirp_td, fade, length_seconds, sampling_rate_hz)
    chirp_td = pad_trim_axis(chirp_td, l_samples + p_samples, axis=-1)
    chirp_td = chirp_td[:, None].repeat(1, number_of_channels)
    sig = Signal(None, chirp_td, sampling_rate_hz)
    return (sig, T) if type_of_chirp == ChirpType.SyncLog else sig


def dirac(
    length_samples: int,
    sampling_rate_hz: int,
    delay_samples: int = 0,
    number_of_channels: int = 1,
) -> ImpulseResponse:
    """Dirac impulse response (`generators.py:213`)."""
    assert isinstance(length_samples, int) and length_samples > 0, (
        "Only positive lengths are valid"
    )
    assert isinstance(delay_samples, int) and delay_samples >= 0, (
        "Only positive delay is supported"
    )
    assert delay_samples < length_samples, "Delay is bigger than the samples of the signal"
    assert number_of_channels > 0, "At least one channel has to be created"
    assert sampling_rate_hz > 0, "Sampling rate can only be positive"
    td = np.repeat(impulse(length_samples, delay_samples)[:, None], number_of_channels, axis=1)
    return ImpulseResponse(None, td, sampling_rate_hz)


def oscillator(
    frequency_hz: float,
    sampling_rate_hz: int,
    length_seconds: float = 1.0,
    mode: WaveForm = WaveForm.Harmonic,
    harmonic_cutoff_hz: float | None = None,
    peak_level_dbfs: float = -10.0,
    number_of_channels: int = 1,
    uncorrelated: bool = False,
    fade: FadeType = FadeType.Logarithmic,
    padding_end_seconds: float = 0.0,
    seed=None,
) -> Signal:
    """Band-limited tones: a sine, or the square, sawtooth and triangle
    waves' harmonic series up to ``harmonic_cutoff_hz`` (`generators.py:239`).

    As in the JAX package, each harmonic's phase n·k·f/fs is wrapped to one
    cycle in float64 (the same operations give the same values as its host
    numpy) and its sine taken in float32; the harmonics are summed on the
    device in blocks of `_HARMONIC_BLOCK` elements. With ``uncorrelated``
    each channel gets a random phase shift from a `torch.Generator` seeded
    from ``seed``."""
    assert frequency_hz < sampling_rate_hz // 2, "Frequency must be beneath nyquist frequency"
    assert frequency_hz > 0, "Frequency must be bigger than 0"
    p_samples = 0
    if padding_end_seconds != 0:
        assert padding_end_seconds > 0, "Padding has to be a positive time"
        p_samples = int(padding_end_seconds * sampling_rate_hz)
    l_samples = int(sampling_rate_hz * length_seconds + 0.5)
    if harmonic_cutoff_hz is None:
        harmonic_cutoff_hz = sampling_rate_hz // 2
    assert 0 < harmonic_cutoff_hz <= sampling_rate_hz // 2, (
        "Cutoff frequency must be between 0 and the nyquist frequency!"
    )

    dev = torch.device(default_device())
    dt = default_float()
    C = number_of_channels
    if uncorrelated:
        phase_shift = (torch.rand((C, 1), generator=_generator(seed, dev), dtype=dt,
                                  device=dev) * 2 - 1) * np.pi
    else:
        phase_shift = torch.zeros((C, 1), dtype=dt, device=dev)
    n_idx = torch.arange(l_samples, dtype=torch.float64, device=dev)
    cycles0 = frequency_hz / sampling_rate_hz

    def wrapped_phase(order: float) -> torch.Tensor:
        # (T,) wrapped phase of one harmonic in radians, float32
        return (torch.remainder(n_idx * (order * cycles0), 1.0) * (2 * np.pi)).to(dt)

    def harmonic_sum(orders: np.ndarray, weights: np.ndarray) -> torch.Tensor:
        # (C, T): Σ_k w_k sin(phase_k + shift), in blocks of harmonics
        orders = np.asarray(orders, np.float64)
        per = max(1, _HARMONIC_BLOCK // (l_samples * C))
        out = torch.zeros((C, l_samples), dtype=dt, device=dev)
        for i in range(0, len(orders), per):
            ph = torch.stack([wrapped_phase(o) for o in orders[i:i + per]])  # (K, T)
            w = torch.as_tensor(weights[i:i + per], dtype=dt, device=dev)[:, None, None]
            out += (torch.sin(ph[:, None, :] + phase_shift[None]) * w).sum(0)
        return out

    if mode == WaveForm.Harmonic:
        td = torch.sin(wrapped_phase(1.0)[None, :] + phase_shift)
    elif mode == WaveForm.Square:
        ks = np.arange(1, int(harmonic_cutoff_hz / frequency_hz / 2) + 2)
        orders = 2 * ks - 1
        orders = orders[orders * frequency_hz < harmonic_cutoff_hz]
        td = harmonic_sum(orders, 1.0 / orders) * (4 / np.pi)
    elif mode == WaveForm.Sawtooth:
        ks = np.arange(1, int(harmonic_cutoff_hz / frequency_hz) + 2)
        ks = ks[ks * frequency_hz < harmonic_cutoff_hz]
        td = harmonic_sum(ks, ((-1.0) ** ks) / ks) * (-2 / np.pi)
    elif mode == WaveForm.Triangle:
        ks = np.arange(1, int(harmonic_cutoff_hz / frequency_hz / 2) + 2)
        orders = 2 * ks - 1
        keep = orders * frequency_hz < harmonic_cutoff_hz
        orders = orders[keep]
        signs = (-1.0) ** ks[keep]
        td = harmonic_sum(orders, signs / orders**2) * (-8 / np.pi**2)
    else:
        raise ValueError("Unsupported wave form")

    td = _normalize(td, peak_level_dbfs, peak_normalization=True, per_channel=True)
    td = _fade_both(td, fade, length_seconds, sampling_rate_hz)
    return Signal(None, pad_trim_axis(td, l_samples + p_samples).T, sampling_rate_hz)

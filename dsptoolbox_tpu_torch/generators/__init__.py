"""Signal generators (`dsptoolbox_tpu/generators`): colored noise, sine
sweeps, diracs and band-limited oscillators."""

from .enums import ChirpType, NoiseType, WaveForm
from .generators import chirp, dirac, noise, oscillator, sync_log_chirp

__all__ = ["noise", "chirp", "dirac", "oscillator", "sync_log_chirp", "NoiseType",
           "ChirpType", "WaveForm"]

"""Audio effects (`dsptoolbox_tpu/effects`): spectral subtraction,
distortion, compressor, tremolo, chorus and digital delay on the signal's
device; the LFOs on the host."""

from ._backend import (
    LFO,
    get_frequency_from_musical_rhythm,
    get_time_period_from_musical_rhythm,
)
from .effects import (
    AudioEffect,
    Chorus,
    Compressor,
    DigitalDelay,
    Distortion,
    SpectralSubtractor,
    Tremolo,
)
from .enums import DistortionType

__all__ = [
    "AudioEffect",
    "SpectralSubtractor",
    "Distortion",
    "Compressor",
    "Tremolo",
    "Chorus",
    "DigitalDelay",
    "LFO",
    "DistortionType",
    "get_frequency_from_musical_rhythm",
    "get_time_period_from_musical_rhythm",
]

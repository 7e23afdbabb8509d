"""Generator option enums (`dsptoolbox_tpu/generators/enums.py`)."""

from enum import Enum, auto


class NoiseType(Enum):
    White = auto()
    Pink = auto()
    Red = auto()
    Blue = auto()
    Violet = auto()
    Grey = auto()


class ChirpType(Enum):
    """Linear, Logarithmic (exponential), or the Novak synchronized log chirp
    (phase-coherent harmonic responses)."""

    Linear = auto()
    Logarithmic = auto()
    SyncLog = auto()


class WaveForm(Enum):
    Harmonic = auto()
    Square = auto()
    Triangle = auto()
    Sawtooth = auto()

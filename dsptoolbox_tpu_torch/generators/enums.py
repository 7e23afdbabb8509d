"""Generator option enums (`dsptoolbox_tpu/generators/enums.py`); so far
the sweep types."""

from enum import Enum, auto


class ChirpType(Enum):
    """Linear, Logarithmic (exponential), or the Novak synchronized log chirp
    (phase-coherent harmonic responses)."""

    Linear = auto()
    Logarithmic = auto()
    SyncLog = auto()

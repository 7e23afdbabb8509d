"""Beamforming enums (reference `dsptoolbox/beamforming/enums.py`)."""

from enum import Enum, auto


class SteeringVectorType(Enum):
    """Sarradj 2012 steering vector formulations 1-4."""

    Classic = auto()
    Inverse = auto()
    TruePower = auto()
    TrueLocation = auto()

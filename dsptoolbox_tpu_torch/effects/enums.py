"""The effects' enums (`dsptoolbox_tpu/effects/enums.py`)."""

from enum import Enum, auto


class DistortionType(Enum):
    Arctan = auto()
    HardClip = auto()
    SoftClip = auto()
    NoDistortion = auto()

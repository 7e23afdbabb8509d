"""Room acoustics enums (`dsptoolbox_tpu/room_acoustics/enums.py`)."""

from enum import Enum, auto


class ReverbTime(Enum):
    """Adaptive (best-linear-fit), T20, T30, T60, or early decay time."""

    Adaptive = auto()
    T20 = auto()
    T30 = auto()
    T60 = auto()
    EDT = auto()


class RoomAcousticsDescriptor(Enum):
    """D50 (definition), C80 (clarity), BassRatio, CenterTime."""

    D50 = auto()
    C80 = auto()
    BassRatio = auto()
    CenterTime = auto()

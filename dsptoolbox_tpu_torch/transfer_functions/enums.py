"""Transfer-function enums (`dsptoolbox_tpu/transfer_functions/enums.py`)."""

from enum import Enum, auto


class TransferFunctionType(Enum):
    """H1 = Gxy/Gxx (noise in output), H2 = Gyy/Gyx (noise in input),
    H3 = Gxy/|Gxy| · sqrt(Gyy/Gxx) (noise in both)."""

    H1 = auto()
    H2 = auto()
    H3 = auto()


class SmoothingDomain(Enum):
    """Domains for complex smoothing (Hatziantoniou & Mourjopoulos)."""

    RealImaginary = auto()
    PowerPhase = auto()
    MagnitudePhase = auto()
    Power = auto()
    Magnitude = auto()
    EquivalentComplex = auto()

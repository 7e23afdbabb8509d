"""Container classes (`dsptoolbox_tpu/classes`): thin ports of `Signal`,
`ImpulseResponse` and `Spectrum`."""

from .impulse_response import ImpulseResponse
from .signal import Signal
from .spectrum import Spectrum

__all__ = ["ImpulseResponse", "Signal", "Spectrum"]

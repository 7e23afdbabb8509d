"""Container classes (`dsptoolbox_tpu/classes`): thin ports of `Signal`,
`ImpulseResponse`, `Spectrum`, `Filter`, `FilterBank` and
`MultiBandSignal`."""

from .filter import Filter
from .filterbank import FilterBank
from .impulse_response import ImpulseResponse
from .multibandsignal import MultiBandSignal
from .signal import Signal
from .spectrum import Spectrum

__all__ = ["Filter", "FilterBank", "ImpulseResponse", "MultiBandSignal", "Signal", "Spectrum"]

"""Container classes (`dsptoolbox_tpu/classes`): `Signal`,
`ImpulseResponse`, `Spectrum`, `Filter`, `FilterBank`, `MultiBandSignal`
and `CalibrationData`, with the device pairs `DeviceTimeData` and
`DeviceSpectralData`."""

from .calibration_data import CalibrationData
from .filter import Filter
from .filterbank import FilterBank
from .impulse_response import ImpulseResponse
from .multibandsignal import MultiBandSignal
from .signal import DeviceSpectralData, DeviceTimeData, Signal
from .spectrum import Spectrum

__all__ = ["CalibrationData", "DeviceSpectralData", "DeviceTimeData", "Filter", "FilterBank",
           "ImpulseResponse", "MultiBandSignal", "Signal", "Spectrum"]

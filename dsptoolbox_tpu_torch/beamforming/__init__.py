"""Beamforming (`dsptoolbox_tpu/beamforming`): geometry, steering vectors,
monopole sources and the frequency-domain delay-and-sum map."""

from .beamforming import (
    BaseBeamformer,
    BasePoints,
    BeamformerDASFrequency,
    BeamformerGridded,
    Grid,
    LineGrid,
    MicArray,
    MonopoleSource,
    Regular2DGrid,
    Regular3DGrid,
    SteeringVector,
    amp_diff_to_torch,
    classic_steering,
    inverse_steering,
    mix_sources_on_array,
    true_location_steering,
    true_power_steering,
)
from .enums import SteeringVectorType

__all__ = [
    "BasePoints",
    "Grid",
    "Regular2DGrid",
    "Regular3DGrid",
    "LineGrid",
    "MicArray",
    "SteeringVector",
    "BaseBeamformer",
    "BeamformerGridded",
    "BeamformerDASFrequency",
    "MonopoleSource",
    "mix_sources_on_array",
    "amp_diff_to_torch",
    "classic_steering",
    "inverse_steering",
    "true_power_steering",
    "true_location_steering",
    "SteeringVectorType",
]

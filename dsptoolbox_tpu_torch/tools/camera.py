"""The acoustic-camera configuration of the beamforming path, built through
the public API (the JAX package's config 5, `tools/bench_suite.py:328-356`).

- a 64-mic planar array, 8 × 8 at 0.06 m pitch, centred on the origin at
  z = 0 (the repository has no ``array.xml``, the geometry of config 5);
- the 30 × 30 grid ``Regular2DGrid(np.arange(-0.3, 0.3, 0.02)`` twice,
  ``["x", "y"], value3=0.5)``: 900 points;
- one white-noise monopole at the grid point nearest ``[0.1, -0.1, 0.5]``,
  projected onto the array with `MonopoleSource.get_signals_on_array`;
- `BeamformerDASFrequency(...).get_beamformer_map(2000, 3)` with
  ``TrueLocation`` steering.

Used by ``chip_smoke.py`` and `tools.profile_chain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..beamforming import (
    BeamformerDASFrequency,
    MicArray,
    MonopoleSource,
    Regular2DGrid,
    SteeringVector,
    SteeringVectorType,
)
from ..classes import Signal

PITCH_M = 0.06
SIDE = 8
CENTER_HZ = 2000
OCTAVE_FRACTION = 3
SOURCE_NEAR = (0.1, -0.1, 0.5)


def planar_array() -> MicArray:
    x = (np.arange(SIDE) - (SIDE - 1) / 2) * PITCH_M
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return MicArray(dict(x=xx.flatten(), y=yy.flatten(), z=np.zeros(xx.size)))


def grid() -> Regular2DGrid:
    line = np.arange(-0.3, 0.3, 0.02)
    return Regular2DGrid(line, line, ["x", "y"], value3=0.5)


def source_position(g: Regular2DGrid) -> np.ndarray:
    """The grid point nearest `SOURCE_NEAR`."""
    return g.find_nearest_point(SOURCE_NEAR)[1]


def array_signal(seconds: float, fs: int, device, g: Regular2DGrid, seed: int = 0) -> Signal:
    """White noise (seeded numpy, float32) emitted at `source_position` and
    recorded by `planar_array`, on ``device``: ``(T, 64)``."""
    noise = 0.3 * np.random.default_rng(seed).standard_normal(int(seconds * fs))
    emitted = Signal(None, torch.from_numpy(noise.astype(np.float32)).to(device), fs)
    src = MonopoleSource(emitted, source_position(g))
    return src.get_signals_on_array(planar_array())


def beamformer(signal: Signal, g: Regular2DGrid) -> BeamformerDASFrequency:
    return BeamformerDASFrequency(
        signal, planar_array(), g, SteeringVector(SteeringVectorType.TrueLocation)
    )


def peak_position(beam_map: torch.Tensor, g: Regular2DGrid) -> np.ndarray:
    """Coordinates of the map's largest value."""
    return g.coordinates[int(torch.argmax(beam_map.reshape(-1)))]

"""The acoustic-camera configuration of the beamforming path, built through
the public API (the JAX package's config 5, `tools/bench_suite.py:328-356`).

- a 64-mic planar array, 8 × 8 at 0.06 m pitch, centred on the origin at
  z = 0 (the repository has no ``array.xml``, the geometry of config 5);
- the 30 × 30 grid ``Regular2DGrid(np.arange(-0.3, 0.3, 0.02)`` twice,
  ``["x", "y"], value3=0.5)``: 900 points;
- one white-noise monopole at the grid point nearest ``[0.1, -0.1, 0.5]``,
  projected onto the array with `MonopoleSource.get_signals_on_array`;
- `BeamformerDASFrequency(...).get_beamformer_map(2000, 3)` with
  ``TrueLocation`` steering, and the same map from `BeamformerMVDR` (its
  loaded default and, on the recording plus independent sensor noise of
  σ = 1e-3, its reference form), `BeamformerFunctional`,
  `BeamformerCleanSC` and `BeamformerOrthogonal` (`map_calls`);
  `BeamformerDASTime` steers the recording at every grid point.

Used by ``chip_smoke.py`` and `tools.profile_chain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..beamforming import (
    BeamformerCleanSC,
    BeamformerDASFrequency,
    BeamformerDASTime,
    BeamformerFunctional,
    BeamformerMVDR,
    BeamformerOrthogonal,
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
SENSOR_NOISE = 1e-3
# the frequency-domain beamformers of config 5 by name
KINDS = {
    "das": BeamformerDASFrequency,
    "mvdr": BeamformerMVDR,
    "functional": BeamformerFunctional,
    "clean_sc": BeamformerCleanSC,
    "orthogonal": BeamformerOrthogonal,
}


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


def with_sensor_noise(signal: Signal, sigma: float = SENSOR_NOISE, seed: int = 1) -> Signal:
    """``signal`` plus independent white noise of standard deviation
    ``sigma`` in every channel (seeded numpy), on the signal's device: a CSM
    that MVDR's unloaded reference form can invert."""
    td = signal.time_data
    noise = np.random.default_rng(seed).normal(0.0, sigma, tuple(td.shape))
    return signal.copy_with_new_time_data(
        td + torch.as_tensor(noise, dtype=td.dtype, device=td.device))


def beamformer(signal: Signal, g: Regular2DGrid, kind: str = "das"):
    """A beamformer of `KINDS` on `planar_array` with ``TrueLocation``
    steering."""
    return KINDS[kind](
        signal, planar_array(), g, SteeringVector(SteeringVectorType.TrueLocation)
    )


def time_beamformer(signal: Signal, g: Regular2DGrid) -> BeamformerDASTime:
    return BeamformerDASTime(signal, planar_array(), g)


def map_calls(signal: Signal, g: Regular2DGrid, noisy: Signal) -> dict:
    """The config-5 maps at `CENTER_HZ`, `OCTAVE_FRACTION` as calls without
    arguments, by name: DAS, MVDR (loaded), MVDR's reference form on
    ``noisy`` (`with_sensor_noise`), Functional, CLEAN-SC and Orthogonal,
    each with its defaults. Each call reuses its beamformer, so the
    steering factors and the CSM stay cached between calls."""
    b = {kind: beamformer(signal, g, kind) for kind in KINDS}
    mvdr_noisy = beamformer(noisy, g, "mvdr")
    band = (CENTER_HZ, OCTAVE_FRACTION)
    return {
        "das": lambda: b["das"].get_beamformer_map(*band),
        "mvdr": lambda: b["mvdr"].get_beamformer_map(*band),
        "mvdr_reference": lambda: mvdr_noisy.get_beamformer_map(*band, solve_on_device=False),
        "functional": lambda: b["functional"].get_beamformer_map(*band),
        "clean_sc": lambda: b["clean_sc"].get_beamformer_map(*band),
        "orthogonal": lambda: b["orthogonal"].get_beamformer_map(*band),
    }


def peak_position(beam_map: torch.Tensor, g: Regular2DGrid) -> np.ndarray:
    """Coordinates of the map's largest value."""
    return g.coordinates[int(torch.argmax(beam_map.reshape(-1)))]

"""The room-acoustics configurations, built through the public API.

- **(a) The measured room** (the JAX package's BASELINE config 1, "IR +
  RT60"): the 16 windowed IRs of `tools.measurement` (65,536 samples at 48
  kHz, RT60 0.6 s) through the 1/1-octave bank
  ``fractional_octave_bands([125, 4000])`` (6 bands, order 6, Parallel:
  the filter-bank kernel B3 on a CUDA device), `reverb_time` in T20, T30,
  EDT and Adaptive on the bands (96 fits a mode), the D50, C80 and centre
  time of each channel and its bass ratio (zero-phase order-10 octaves
  125-1000 Hz: the IIR lead kernel B2) — `measured_room`.
- **(b) The RIR battery** (BASELINE config 4, `tools/bench_suite.py:277`):
  1000 RIRs × 8000 samples at 16 kHz from a seed (noise decaying at 15-40
  /s over a −60 dB floor, a unit direct sound), `batch_descriptors` and
  `batch_reverb_times` in T20, EDT and T30 — `battery`.
- **(c) The image-source fleet**: 64 source/receiver pairs drawn from a
  seed in ``ShoeboxRoom([6.07, 5.13, 3.01], t60_s=0.5)``, 0.5 s RIRs at 16
  kHz with no order cap (a lattice limit of 40: 81³ cells × 8 images a
  pair, 272 M images), then `batch_descriptors` — `ism_fleet`.

Data goes to `_config.default_device()`. Used by ``chip_smoke.py`` and
`tools.profile_chain` (``--case ra``).
"""

from __future__ import annotations

import numpy as np

from ..filterbanks import fractional_octave_bands
from ..room_acoustics import (
    ReverbTime,
    RoomAcousticsDescriptor,
    ShoeboxRoom,
    batch_descriptors,
    batch_reverb_times,
    batch_synthetic_rirs,
    descriptors,
    reverb_time,
)
from ..standard.enums import FilterBankMode

OCTAVE_RANGE_HZ = (125, 4000)
OCTAVE_ORDER = 6
REVERB_TIMES = (ReverbTime.T20, ReverbTime.T30, ReverbTime.EDT, ReverbTime.Adaptive)
CHANNEL_DESCRIPTORS = (
    RoomAcousticsDescriptor.D50,
    RoomAcousticsDescriptor.C80,
    RoomAcousticsDescriptor.CenterTime,
)

BATTERY_FS = 16000
BATTERY_RIRS = 1000
BATTERY_LENGTH = BATTERY_FS // 2
BATTERY_TIMES = ("T20", "EDT", "T30")

ROOM_DIMENSIONS_M = (6.07, 5.13, 3.01)
ROOM_T60_S = 0.5
FLEET_PAIRS = 64
FLEET_FS = 16000
FLEET_SECONDS = 0.5
WALL_CLEARANCE_M = 0.3


def octave_bank(sampling_rate_hz: int):
    """The 1/1-octave bank over `OCTAVE_RANGE_HZ`, order `OCTAVE_ORDER`."""
    return fractional_octave_bands(list(OCTAVE_RANGE_HZ), 1, OCTAVE_ORDER,
                                   sampling_rate_hz)[0]


def octave_bands(irs, bank):
    """The IRs' octave bands (a MultiBandSignal of IRs), one bank call."""
    return bank.filter_signal(irs, FilterBankMode.Parallel)


def band_reverb_times(bands) -> dict:
    """``{mode name: (bands, channels) seconds}`` for `REVERB_TIMES`."""
    return {mode.name: reverb_time(bands, mode)[0] for mode in REVERB_TIMES}


def channel_descriptors(irs) -> dict:
    """``{descriptor name: (channels,)}``: D50, C80, centre time and the
    bass ratio of each channel."""
    out = {d.name: descriptors(irs, d) for d in CHANNEL_DESCRIPTORS}
    out["BassRatio"] = descriptors(irs, RoomAcousticsDescriptor.BassRatio)
    return out


def measured_room(irs, bank) -> dict:
    """(a): the octave bands, their reverberation times in every mode and
    the channels' descriptors."""
    bands = octave_bands(irs, bank)
    return {"bands": bands, "rt": band_reverb_times(bands),
            "descriptors": channel_descriptors(irs)}


def battery_rirs(n_rirs: int = BATTERY_RIRS, seed: int = 0) -> np.ndarray:
    """Config 4's fleet ``(n_rirs, 8000)`` float32: Gaussian noise decaying
    at a seeded 15-40 /s over noise at −60 dB, a unit first sample."""
    rng = np.random.default_rng(seed)
    t = np.arange(BATTERY_LENGTH) / BATTERY_FS
    decays = rng.uniform(15.0, 40.0, n_rirs)
    rirs = (
        rng.standard_normal((n_rirs, BATTERY_LENGTH)) * np.exp(-decays[:, None] * t)
        + 1e-3 * rng.standard_normal((n_rirs, BATTERY_LENGTH))
    ).astype(np.float32)
    rirs[:, 0] = 1.0
    return rirs


def battery(rirs) -> dict:
    """(b): ``{"d50", "c80", "center_time_s", "T20", "EDT", "T30"}``, each
    ``(B,)``, of a fleet at `BATTERY_FS`."""
    out = dict(batch_descriptors(rirs, BATTERY_FS))
    for mode in BATTERY_TIMES:
        out[mode] = batch_reverb_times(rirs, BATTERY_FS, mode)
    return out


def room() -> ShoeboxRoom:
    return ShoeboxRoom(list(ROOM_DIMENSIONS_M), t60_s=ROOM_T60_S)


def fleet_positions(n_pairs: int = FLEET_PAIRS, seed: int = 0):
    """``(sources (n, 3), receivers (n, 3))`` drawn uniformly from the room
    at `WALL_CLEARANCE_M` from its walls."""
    rng = np.random.default_rng(seed)
    lo = np.full(3, WALL_CLEARANCE_M)
    hi = np.asarray(ROOM_DIMENSIONS_M) - WALL_CLEARANCE_M
    return rng.uniform(lo, hi, (n_pairs, 3)), rng.uniform(lo, hi, (n_pairs, 3))


def ism_fleet(shoebox: ShoeboxRoom, sources, receivers, max_order: int | None = None):
    """(c): ``(rirs (n, 8000) float32, their batch descriptors)``."""
    rirs = batch_synthetic_rirs(shoebox, sources, receivers, FLEET_FS, FLEET_SECONDS,
                                max_order=max_order)
    return rirs, batch_descriptors(rirs, FLEET_FS)

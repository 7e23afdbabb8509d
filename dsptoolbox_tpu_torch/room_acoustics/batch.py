"""Batched room-acoustics descriptors over fleets of RIRs
(`dsptoolbox_tpu/room_acoustics/batch.py`).

Every function takes a ``(B, T)`` fleet (one RIR a row) and computes its
descriptor for all rows at once with torch ops on the fleet's device:
masked least-squares fits instead of the per-channel trimming of
`reverb_time`. The direct sound is each row's energy peak (``argmax
|h|``); the descriptors follow ISO 3382 (D50, C80, centre time, EDT, T20
and T30 from the Schroeder backward integral). A tensor keeps its device
and dtype; numpy goes to `_config.default_device()` in the package's
default float. The backward integral is ``flip``/``cumsum``/``flip``: the
JAX package's blocked triangular products (`ops/prefix.py`) are a choice
for the TPU's matrix unit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import default_device, default_float
from ..ops.pad_trim import pad_trim_axis

__all__ = [
    "batch_energy_decay",
    "batch_descriptors",
    "batch_reverb_times",
    "batch_synthetic_rirs",
]


def batch_synthetic_rirs(
    room,
    source_positions,
    receiver_positions,
    sampling_rate_hz: int,
    total_length_seconds: float = 0.5,
    max_order: int | None = None,
) -> torch.Tensor:
    """Image-source RIRs for a fleet of source/receiver pairs ``(B, 3)`` in
    one room (`batch.py:36`): ``(B, T)`` float32 on
    `_config.default_device()`, from the float64 lattice with a leading
    pair axis (`_backend.ism_lattice`); each row's sample indices are the
    single-RIR oracle's."""
    from ._backend import ism_lattice, ism_limits, wall_reflection_factors

    s = np.atleast_2d(np.asarray(source_positions, np.float64))
    r = np.atleast_2d(np.asarray(receiver_positions, np.float64))
    assert s.shape == r.shape and s.shape[1] == 3, (
        "source/receiver positions must both be (B, 3)"
    )
    for p in np.concatenate([s, r]):
        assert room.check_if_in_room(p), f"Position {p} is not located inside the room"
    room_dim = np.asarray(room.dimensions_m, np.float64)
    beta_1, beta_2 = wall_reflection_factors(room.absorption_coefficient)
    limit, gen_length = ism_limits(room_dim, room.t60_s, max_order, sampling_rate_hz)
    out_length = int(total_length_seconds * sampling_rate_hz)
    # images past the output length are dropped before the scatter: the
    # same RIRs as generating all `gen_length` samples and trimming
    rirs = ism_lattice(room_dim, beta_1, beta_2, s, r, sampling_rate_hz, limit,
                       min(gen_length, out_length), default_device())
    return pad_trim_axis(rirs, out_length, axis=-1)


def _as_fleet(rirs) -> torch.Tensor:
    if torch.is_tensor(rirs):
        return torch.atleast_2d(rirs)
    return torch.atleast_2d(
        torch.as_tensor(np.asarray(rirs), dtype=default_float(), device=default_device())
    )


def _start_indices(rirs: torch.Tensor) -> torch.Tensor:
    """Direct-sound index per row: the energy peak."""
    return torch.argmax(rirs.abs(), dim=-1)


def batch_energy_decay(rirs) -> torch.Tensor:
    """Schroeder backward-integrated energy decay curves in dB, ``(B, T)``
    (`batch.py:124`): samples before each row's direct-sound peak are
    left out of the integral; 0 dB at the decay start."""
    rirs = _as_fleet(rirs)
    T = rirs.shape[-1]
    start = _start_indices(rirs)
    t = torch.arange(T, device=rirs.device)[None, :]
    e = (rirs**2) * (t >= start[:, None]).to(rirs.dtype)
    edc = torch.flip(torch.cumsum(torch.flip(e, dims=(-1,)), dim=-1), dims=(-1,))
    total = edc[:, :1]
    return 10.0 * torch.log10(edc.clamp(min=1e-30) / total.clamp(min=1e-30))


def batch_descriptors(rirs, sampling_rate_hz: int) -> dict[str, torch.Tensor]:
    """D50, C80 (dB) and centre time (s) of a fleet ``(B, T)``
    (`batch.py:153`): a dict of ``(B,)`` tensors."""
    rirs = _as_fleet(rirs)
    T = rirs.shape[-1]
    start = _start_indices(rirs)
    rel = torch.arange(T, device=rirs.device)[None, :] - start[:, None]
    e = rirs**2 * (rel >= 0)

    n50 = int(50e-3 * sampling_rate_hz)
    n80 = int(80e-3 * sampling_rate_hz)
    e_total = torch.sum(e, dim=-1)
    e_50 = torch.sum(e * (rel < n50), dim=-1)
    e_80 = torch.sum(e * (rel < n80), dim=-1)
    d50 = e_50 / e_total.clamp(min=1e-30)
    c80 = 10.0 * torch.log10(e_80.clamp(min=1e-30) / (e_total - e_80).clamp(min=1e-30))
    ts = torch.sum(e * rel.clamp(min=0), dim=-1) / e_total.clamp(min=1e-30) / sampling_rate_hz
    return {"d50": d50, "c80": c80, "center_time_s": ts}


def _masked_linear_fit(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row least-squares line of y over x restricted to ``mask``
    (`batch.py:183`): ``(slope, intercept)``, each ``(B,)``."""
    w = mask.to(y.dtype)
    n = torch.sum(w, dim=-1).clamp(min=1.0)
    mx = torch.sum(w * x, dim=-1) / n
    my = torch.sum(w * y, dim=-1) / n
    cov = torch.sum(w * (x - mx[:, None]) * (y - my[:, None]), dim=-1)
    var = torch.sum(w * (x - mx[:, None]) ** 2, dim=-1).clamp(min=1e-30)
    slope = cov / var
    return slope, my - slope * mx


_RANGES = {"EDT": (0.0, -10.0), "T20": (-5.0, -25.0), "T30": (-5.0, -35.0)}


def batch_reverb_times(rirs, sampling_rate_hz: int, mode: str = "T20") -> torch.Tensor:
    """EDT, T20 or T30 in seconds of a fleet ``(B, T)`` (`batch.py:202`):
    masked line fits over the ISO 3382 ranges of the Schroeder decay, from
    each row's direct sound on. T20 and T30 extrapolate the slope to a 60 dB
    decay; EDT reports the 0 → −10 dB time (the reference's convention,
    `_room_acoustics.py:81`)."""
    assert mode in _RANGES, f"mode must be one of {sorted(_RANGES)}"
    hi, lo = _RANGES[mode]
    rirs = _as_fleet(rirs)
    edc_db = batch_energy_decay(rirs)
    B, T = edc_db.shape
    t = (torch.arange(T, device=rirs.device, dtype=rirs.dtype) / sampling_rate_hz)[None, :]
    t = t * torch.ones((B, 1), device=rirs.device, dtype=rirs.dtype)
    # the flat 0 dB plateau before the direct sound is left out: it would
    # flatten the EDT fit of an RIR with a leading delay
    start = _start_indices(rirs)
    mask = (
        (edc_db <= hi)
        & (edc_db >= lo)
        & (torch.arange(T, device=rirs.device)[None, :] >= start[:, None])
    )
    slope, _ = _masked_linear_fit(t, edc_db, mask)
    factor = 10.0 if mode == "EDT" else 60.0
    return -factor / slope.clamp(max=-1e-10)

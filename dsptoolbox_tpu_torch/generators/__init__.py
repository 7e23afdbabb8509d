"""Signal generators (`dsptoolbox_tpu/generators`); so far the sweeps.
``noise``, ``dirac`` and ``oscillator`` are not ported yet."""

from .enums import ChirpType
from .generators import chirp, sync_log_chirp

__all__ = ["chirp", "sync_log_chirp", "ChirpType"]

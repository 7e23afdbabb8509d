"""Audio reading and writing by file extension (`dsptoolbox_tpu/io/audio.py`)."""

from __future__ import annotations

import os

import numpy as np

from .wav import read_wav, write_wav


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Read a ``.wav`` or ``.flac`` file → (float64 ``(samples,)`` or
    ``(samples, channels)``, sampling rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        from .flac import read_flac

        return read_flac(path)
    raise ValueError(f"Unsupported audio format: {ext}")


def write_audio(path: str, data: np.ndarray, sampling_rate_hz: int,
                subtype: str = "PCM_16") -> None:
    """Write ``data (samples[, channels])`` as ``.wav`` (any subtype of
    `write_wav`) or ``.flac`` (PCM_8, PCM_16 or PCM_24)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return write_wav(path, data, sampling_rate_hz, subtype)
    if ext == ".flac":
        from .flac import write_flac

        bits_map = {"PCM_8": 8, "PCM_16": 16, "PCM_24": 24}
        if subtype not in bits_map:
            raise ValueError(
                f"Subtype {subtype!r} is not supported for FLAC "
                f"(use one of {sorted(bits_map)})"
            )
        return write_flac(path, data, sampling_rate_hz, bits_map[subtype])
    raise ValueError(f"Unsupported audio format for writing: {ext}")

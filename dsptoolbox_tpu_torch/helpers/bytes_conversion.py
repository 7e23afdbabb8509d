"""24-bit PCM byte packing, host numpy
(`dsptoolbox_tpu/helpers/bytes_conversion.py`)."""

from __future__ import annotations

import sys

import numpy as np


def array_to_bytes_24bits(vector: np.ndarray) -> bytes:
    """int32/uint32 samples → packed 3-byte samples (platform endianness)."""
    assert vector.dtype in (np.uint32, np.int32), "Vector data type is not supported"
    b = np.frombuffer(vector.tobytes(), dtype=np.uint8)
    if sys.byteorder == "little":
        indices = np.setdiff1d(np.arange(len(b)), np.arange(3, len(b), 4))
    else:
        indices = np.setdiff1d(np.arange(len(b)), np.arange(0, len(b), 4))
    return b[indices].tobytes()


def bytes_to_array_24bits(vector: bytes, signed_input: bool) -> np.ndarray:
    """Packed 3-byte samples → int32 (signed) or uint32 array."""
    assert len(vector) % 3 == 0, "Vector should have a length with 3-bytes sized samples"
    raw = np.frombuffer(vector, dtype=np.uint8).reshape(-1, 3)
    lo, hi = (0, 2) if sys.byteorder == "little" else (2, 0)
    vals = (raw[:, lo].astype(np.uint32) | (raw[:, 1].astype(np.uint32) << 8)
            | (raw[:, hi].astype(np.uint32) << 16))
    if signed_input:
        vals = vals.astype(np.int32)
        return np.where(vals >= 2**23, vals - 2**24, vals).astype(np.int32)
    return vals

"""FLAC reading and writing through the port's native codec
(`dsptoolbox_tpu/io/flac.py`).

`csrc/flac_decoder.cpp` (a decoder for the FLAC subset encoders use and a
verbatim-subframe encoder, at most 8 channels as the format allows) is
built with ``g++`` at first use into ``_build/libflac_codec-<hash>.so``
by `_cuda.build` (the hash covers the source, as for the CUDA kernels),
and bound with ``ctypes``. Host code: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

from .._cuda import CSRC, build

_SRC = CSRC / "flac_decoder.cpp"
_lib = None
_lock = threading.Lock()


def _build() -> str:
    """The codec's shared library, built with ``g++`` if needed."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ was not found: the FLAC codec is built from source at first use")
    return str(build(_SRC, "flac_codec", [cxx, "-O2", "-shared", "-fPIC", "-std=c++17"]))


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.flac_probe.restype = ctypes.c_int
            lib.flac_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_uint64), u32p, u32p, u32p]
            lib.flac_decode.restype = ctypes.c_int
            lib.flac_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_int32)]
            lib.flac_encode.restype = ctypes.c_int64
            lib.flac_encode.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64,
                                        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                                        ctypes.POINTER(ctypes.c_uint8)]
            _lib = lib
    return _lib


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file → (float64 in [-1, 1), sampling rate): shape
    ``(samples,)`` for one channel, ``(samples, channels)`` for more, as
    ``soundfile.read`` gives them."""
    lib = _get_lib()
    with open(path, "rb") as f:
        raw = f.read()
    total, channels = ctypes.c_uint64(), ctypes.c_uint32()
    rate, bps = ctypes.c_uint32(), ctypes.c_uint32()
    rc = lib.flac_probe(raw, len(raw), ctypes.byref(total), ctypes.byref(channels),
                        ctypes.byref(rate), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"Invalid FLAC stream ({rc}): {path}")
    n, ch = int(total.value), int(channels.value)
    out = np.empty(n * ch, dtype=np.int32)
    rc = lib.flac_decode(raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"FLAC decode failed ({rc}): {path}")
    data = out.astype(np.float64) / float(1 << (int(bps.value) - 1))
    if ch > 1:
        data = data.reshape(n, ch)
    return data, int(rate.value)


def write_flac(path: str, data: np.ndarray, sampling_rate_hz: int, bits: int = 16) -> None:
    """Encode float ``data (samples,)`` or ``(samples, channels)`` in
    [-1, 1) as FLAC at ``bits`` (8, 16 or 24) bits, verbatim subframes."""
    lib = _get_lib()
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    assert data.ndim == 2, "data must be (samples, channels)"
    # (frames, channels) kept as given, like soundfile
    n, ch = data.shape
    assert bits in (8, 16, 24), "bits must be 8, 16 or 24"
    max_val = float(2 ** (bits - 1) - 1)
    scaled = np.clip(np.round(data * (2 ** (bits - 1))), -(max_val + 1), max_val).astype(np.int32)
    interleaved = np.ascontiguousarray(scaled.reshape(-1))
    out = np.empty(128 + interleaved.size * 4 + (n // 4096 + 2) * 64, dtype=np.uint8)
    written = lib.flac_encode(interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                              n, ch, int(sampling_rate_hz), bits,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if written < 0:
        raise ValueError(f"FLAC encode failed ({written})")
    with open(path, "wb") as f:
        f.write(out[:written].tobytes())

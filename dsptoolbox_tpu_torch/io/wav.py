"""WAV (RIFF, RF64/BW64) reading and writing, host numpy: PCM 8/16/24/32-bit,
float32/64, WAVE_FORMAT_EXTENSIBLE (a copy of `dsptoolbox_tpu/io/wav.py`).

Normalization matches soundfile: integer PCM is scaled by 2**(bits-1) into
[-1, 1). 24-bit samples are unpacked with numpy byte operations.
"""

from __future__ import annotations

import struct

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float64 data (samples, channels), sampling_rate).

    Handles plain RIFF and RF64/BW64 (EBU 3306): when the riff magic is
    RF64 the 32-bit size fields are 0xFFFFFFFF placeholders and the real
    64-bit sizes come from the mandatory ``ds64`` chunk.
    """
    with open(path, "rb") as fh:
        riff, _size, wave_id = struct.unpack("<4sI4s", fh.read(12))
        is_rf64 = riff in (b"RF64", b"BW64")
        if (riff != b"RIFF" and not is_rf64) or wave_id != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt = None
        data = None
        ds64_data_size = None
        while True:
            header = fh.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            if chunk_id == b"ds64":
                payload = fh.read(chunk_size + (chunk_size & 1))
                if chunk_size < 24:
                    raise ValueError(f"{path}: truncated ds64 chunk")
                # riffSize (u64), dataSize (u64), sampleCount (u64), then an
                # optional table for other oversized chunks
                _riff64, ds64_data_size, _samples = struct.unpack(
                    "<QQQ", payload[:24]
                )
                continue
            if chunk_size == 0xFFFFFFFF and chunk_id == b"data":
                if is_rf64:
                    if ds64_data_size is None:
                        raise ValueError(
                            f"{path}: RF64 data chunk without a ds64 chunk"
                        )
                    chunk_size = ds64_data_size
                else:
                    # plain RIFF with a streaming/unfinalized size
                    # placeholder: the data runs to end of file
                    payload = fh.read()
                    data = payload
                    continue
            payload = fh.read(chunk_size + (chunk_size & 1))
            if chunk_id == b"fmt ":
                fmt = payload
            elif chunk_id == b"data":
                data = payload[:chunk_size]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

    (tag, n_channels, fs, _byte_rate, block_align, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        tag = struct.unpack("<H", fmt[24:26])[0]

    n_frames = len(data) // block_align
    data = data[: n_frames * block_align]

    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        arr = np.frombuffer(data, dtype=dtype).astype(np.float64)
    elif tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            arr = np.frombuffer(data, dtype="<i2").astype(np.float64) / 2.0**15
        elif bits == 32:
            arr = np.frombuffer(data, dtype="<i4").astype(np.float64) / 2.0**31
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = (ints << 8) >> 8  # sign-extend 24→32
            arr = ints.astype(np.float64) / 2.0**23
        elif bits == 8:
            arr = (
                np.frombuffer(data, dtype=np.uint8).astype(np.float64) - 128.0
            ) / 128.0
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"Unsupported WAV format tag: {tag:#x}")

    arr = arr.reshape(n_frames, n_channels)
    if n_channels == 1:
        arr = arr[:, 0]
    return arr, fs


def write_wav(
    path: str, data: np.ndarray, sampling_rate_hz: int, subtype: str = "PCM_16"
) -> None:
    """Write (samples, channels) float data to WAV.

    ``subtype``: PCM_16 | PCM_24 | PCM_32 | FLOAT | DOUBLE (soundfile naming).
    """
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    assert data.ndim == 2, "data must be (samples, channels)"
    # (frames, channels) preserved as-is, like soundfile — no orientation
    # guessing (a wide buffer with more channels than frames is legitimate)
    n_frames, n_channels = data.shape

    if subtype == "FLOAT":
        payload = data.astype("<f4").tobytes()
        bits, tag = 32, _WAVE_FORMAT_IEEE_FLOAT
    elif subtype == "DOUBLE":
        payload = data.astype("<f8").tobytes()
        bits, tag = 64, _WAVE_FORMAT_IEEE_FLOAT
    elif subtype == "PCM_16":
        ints = np.clip(np.round(data * 2.0**15), -(2**15), 2**15 - 1)
        payload = ints.astype("<i2").tobytes()
        bits, tag = 16, _WAVE_FORMAT_PCM
    elif subtype == "PCM_32":
        ints = np.clip(np.round(data * 2.0**31), -(2**31), 2**31 - 1)
        payload = ints.astype("<i4").tobytes()
        bits, tag = 32, _WAVE_FORMAT_PCM
    elif subtype == "PCM_24":
        ints = np.clip(np.round(data * 2.0**23), -(2**23), 2**23 - 1).astype(
            np.int32
        )
        b = np.empty((ints.size, 3), dtype=np.uint8)
        flat = ints.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
        bits, tag = 24, _WAVE_FORMAT_PCM
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")

    block_align = n_channels * bits // 8
    byte_rate = sampling_rate_hz * block_align
    fmt = struct.pack(
        "<HHIIHH", tag, n_channels, sampling_rate_hz, byte_rate, block_align, bits
    )
    with open(path, "wb") as fh:
        data_size = len(payload)
        pad = data_size & 1  # RIFF chunks are word-aligned
        fh.write(
            struct.pack(
                "<4sI4s",
                b"RIFF",
                4 + 8 + len(fmt) + 8 + data_size + pad,
                b"WAVE",
            )
        )
        fh.write(struct.pack("<4sI", b"fmt ", len(fmt)))
        fh.write(fmt)
        fh.write(struct.pack("<4sI", b"data", data_size))
        fh.write(payload)
        if data_size & 1:
            fh.write(b"\x00")

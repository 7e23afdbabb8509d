"""Audio files and object archives, on the host (`dsptoolbox_tpu/io/`).

WAV is read and written over the RIFF container in numpy; FLAC goes
through the port's native codec (`csrc/flac_decoder.cpp`, built with g++
at first use). Readers return float64 in [-1, 1) shaped ``(samples,
channels)`` like soundfile; the arrays reach the device once, in the
`Signal` built from them. `save_object`/`load_object` keep an object's
arrays in a numpy ``.npz`` archive and the rest in one JSON record, the
JAX package's format: an archive written by either package loads in the
other.
"""

from .audio import read_audio, write_audio
from .serialization import load_object, save_object
from .wav import read_wav, write_wav

__all__ = [
    "read_audio",
    "write_audio",
    "read_wav",
    "write_wav",
    "save_object",
    "load_object",
]

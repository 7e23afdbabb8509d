"""Transforms (`dsptoolbox_tpu/transforms`); so far the inverse STFT.
The rest (cepstrum, mel/MFCC, chroma, CWT, VQT, Hilbert, warping,
Laguerre, LPC, DFT, the filter-bank spectrum) is not ported yet."""

from .transforms import istft

__all__ = ["istft"]

"""Filter banks (`dsptoolbox_tpu/filterbanks`): Linkwitz-Riley crossovers,
the gammatone auditory bank and fractional-octave banks."""

from .filterbanks import (
    auditory_filters_gammatone,
    fractional_octave_bands,
    linkwitz_riley_crossovers,
)
from .gammatone import GammaToneFilterBank
from .lr_filterbank import LRFilterBank

__all__ = [
    "GammaToneFilterBank",
    "LRFilterBank",
    "auditory_filters_gammatone",
    "fractional_octave_bands",
    "linkwitz_riley_crossovers",
]

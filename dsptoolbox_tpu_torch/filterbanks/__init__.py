"""Filter banks (`dsptoolbox_tpu/filterbanks`): Linkwitz-Riley crossovers,
the gammatone auditory bank, fractional-octave banks (IIR and the
reconstructing FIR bank), the QMF crossover and filter designs, with the
streaming filters of `realtime` re-exported as in the JAX package."""

from ..realtime import (
    ExponentialAverageFilter,
    FilterChain,
    FIRFilter,
    FIRFilterOverlapSave,
    FIRUniformPartitioned,
    FIRUniformPartitionedMultichannel,
    IIRFilter,
    KautzFilter,
    LatticeLadderFilter,
    ParallelFilter,
    RealtimeFilter,
    StateSpaceFilter,
    StateVariableFilter,
    WarpedFIR,
    WarpedIIR,
)
from ..realtime.designers import FirDesigner, GroupDelayDesigner, PhaseLinearizer
from .crossovers import BaseCrossover, QMFCrossover
from .filterbanks import (
    arma,
    auditory_filters_gammatone,
    complementary_fir_filter,
    fractional_delay,
    fractional_octave_bands,
    gaussian_kernel,
    linkwitz_riley_crossovers,
    matched_biquad,
    pinking_filter,
    qmf_crossover,
    reconstructing_fractional_octave_bands,
    weighting_filter,
)
from .gammatone import GammaToneFilterBank
from .lr_filterbank import LRFilterBank

__all__ = [
    "linkwitz_riley_crossovers",
    "reconstructing_fractional_octave_bands",
    "auditory_filters_gammatone",
    "qmf_crossover",
    "fractional_octave_bands",
    "weighting_filter",
    "complementary_fir_filter",
    "pinking_filter",
    "matched_biquad",
    "gaussian_kernel",
    "fractional_delay",
    "arma",
    "LRFilterBank",
    "GammaToneFilterBank",
    "BaseCrossover",
    "QMFCrossover",
    "RealtimeFilter",
    "IIRFilter",
    "FIRFilter",
    "FIRFilterOverlapSave",
    "FIRUniformPartitioned",
    "FIRUniformPartitionedMultichannel",
    "LatticeLadderFilter",
    "StateVariableFilter",
    "StateSpaceFilter",
    "KautzFilter",
    "WarpedFIR",
    "WarpedIIR",
    "ExponentialAverageFilter",
    "ParallelFilter",
    "FilterChain",
    "FirDesigner",
    "GroupDelayDesigner",
    "PhaseLinearizer",
]

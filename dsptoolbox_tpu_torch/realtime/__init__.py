"""Streaming filters (`dsptoolbox_tpu/realtime`): the per-sample contract on
the host, blocks and whole signals on the device (`IIRFilter` and the
Kautz, parallel and warped FIR filters through `ops.iir.lfilter`/`sosfilt`,
kernel B2 on a float32 CUDA tensor; `ExponentialAverageFilter` through
`csrc/ema.cu`'s average form)."""

from .base import RealtimeFilter
from .iir_fir import (
    FIRFilter,
    FIRFilterOverlapSave,
    FIRUniformPartitioned,
    FIRUniformPartitionedMultichannel,
    IIRFilter,
)
from .kautz import KautzFilter
from .misc import (
    ExponentialAverageFilter,
    FilterChain,
    LatticeLadderFilter,
    StateSpaceFilter,
    StateVariableFilter,
    WarpedFIR,
    WarpedIIR,
)
from .parallel_filter import ParallelFilter

__all__ = [
    "RealtimeFilter",
    "IIRFilter",
    "FIRFilter",
    "FIRFilterOverlapSave",
    "FIRUniformPartitioned",
    "FIRUniformPartitionedMultichannel",
    "KautzFilter",
    "ExponentialAverageFilter",
    "FilterChain",
    "LatticeLadderFilter",
    "StateSpaceFilter",
    "StateVariableFilter",
    "WarpedFIR",
    "WarpedIIR",
    "ParallelFilter",
]

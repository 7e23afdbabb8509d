"""Multi-device execution over a device mesh (`dsptoolbox_tpu/parallel`).

The JAX package shards its multi-channel pipelines with `shard_map` over a
`jax.sharding.Mesh`, one controller issuing every device's work. The port
keeps that single-process design: a `Mesh` names the devices, and each
function here runs the port's single-device op on each shard, on the
shard's device, with the collectives as explicit tensor moves
(`parallel.ops`). DSP work shards along three axes:

- **dp** (data parallel): independent signals, measurement batches;
- **ch** (channel parallel): microphone channels, where the CSM and the
  beamforming maps are O(C²) and O(C·G);
- **band**: filter-bank bands and grid chunks.

The class layer takes a mesh as a keyword: `Signal.get_csm(mesh=)`,
`FilterBank.filter_signal(mesh=)`,
`BeamformerDASFrequency.get_beamformer_map(mesh=)`, `pipeline(mesh=)`.
"""

from .mesh import (
    Mesh,
    NamedSharding,
    PartitionSpec,
    device_mesh,
    replicate,
    shard_batch,
    shard_channels,
)
from .ops import (
    parallel_batch_descriptors,
    parallel_csm,
    parallel_das_map,
    parallel_fir_filter,
    parallel_filterbank,
    parallel_stft,
    parallel_welch,
    parallel_welch_time,
    sharded_map_reduce,
)

__all__ = [
    "device_mesh",
    "shard_batch",
    "shard_channels",
    "replicate",
    "parallel_welch",
    "parallel_welch_time",
    "parallel_stft",
    "parallel_csm",
    "parallel_fir_filter",
    "parallel_filterbank",
    "parallel_das_map",
    "parallel_batch_descriptors",
    "sharded_map_reduce",
]

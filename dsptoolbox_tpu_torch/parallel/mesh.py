"""Device meshes and shardings (`dsptoolbox_tpu/parallel/mesh.py`).

A JAX `Mesh` is single-controller: one process sees every device and
`shard_map` runs the per-shard function on each. `Mesh` here is the same
single-process design: it names the devices one process issues each
shard's work to (`parallel.ops`). A device may appear more than once; its
shards then run in turn (a mesh of four shards on one card, or on the CPU,
which torch sees as one device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._config import default_device


class Mesh:
    """``devices``: an array (any nesting of lists) of devices, one axis a
    name in ``axis_names``; held as a numpy object array of `torch.device`.
    ``shape`` maps each axis name to its device count, as
    `jax.sharding.Mesh.shape` does."""

    def __init__(self, devices, axis_names):
        shape = np.shape(np.asarray(devices, dtype=object))
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        devs = np.empty(len(flat), dtype=object)
        devs[:] = flat
        self.devices = devs.reshape(shape)
        self.axis_names = tuple(axis_names)
        assert len(self.axis_names) == self.devices.ndim, (
            f"{len(self.axis_names)} axis names for a mesh of {self.devices.ndim} axes"
        )
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def shard_devices(self) -> list:
        """The device of each shard along the first axis: the first device
        of each of its slices (the other axes hold replicas)."""
        n = self.devices.shape[0]
        return list(self.devices.reshape(n, -1)[:, 0])

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices.flat]})"


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (None: not split), as
    `jax.sharding.PartitionSpec`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


class NamedSharding(NamedTuple):
    """A layout of an array over ``mesh``: ``spec`` names, per dimension,
    the mesh axis it is split over."""

    mesh: Mesh
    spec: PartitionSpec


def device_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("dp",),
    shape: tuple[int, ...] | None = None,
) -> Mesh:
    """A `Mesh` over the first ``n_devices`` distinct devices of the default
    device's type (`_config.default_device`): the CUDA devices, or the CPU
    (one device). ``shape`` gives the per-axis counts of a multi-axis mesh
    (``axis_names=("dp", "ch"), shape=(2, 4)``); by default every device
    lies on the first axis. Never falls back to another device type."""
    kind = torch.device(default_device()).type
    if kind == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(kind)]
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices <= len(devices), (
        f"Requested {n_devices} devices, only {len(devices)} available"
    )
    devs = devices[:n_devices]
    if shape is None:
        assert len(axis_names) == 1, "shape must be given for multi-axis meshes"
        shape = (n_devices,)
    assert int(np.prod(shape)) == n_devices, (
        f"Mesh shape {shape} does not use exactly {n_devices} devices"
    )
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def shard_batch(mesh: Mesh, ndim: int = 2, axis: int = 0) -> NamedSharding:
    """Dimension ``axis`` of an ``ndim``-rank array split over the mesh's
    first axis (the data-parallel layout)."""
    spec = [None] * ndim
    spec[axis] = mesh.axis_names[0]
    return NamedSharding(mesh, PartitionSpec(*spec))


def shard_channels(mesh: Mesh, ndim: int = 2, channel_axis: int = 0) -> NamedSharding:
    """The channel axis split over the mesh axis named "ch" when there is
    one, else over the first axis (the layout of cross-spectral work)."""
    name = "ch" if "ch" in mesh.axis_names else mesh.axis_names[0]
    spec = [None] * ndim
    spec[channel_axis] = name
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicate(mesh: Mesh) -> NamedSharding:
    """Every device holds the whole array."""
    return NamedSharding(mesh, PartitionSpec())

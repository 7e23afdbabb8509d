"""Streaming filter base (`dsptoolbox_tpu/realtime/base.py`).

The contract is the reference's per-sample processing; the filters with a
device form also expose `process_block(block, channel)` and whole-signal
filtering on the signal's device. `process_sample` keeps the JAX package's
host numpy arithmetic (the same operations on the same float64 state).

A filter whose blocks run on the device keeps its state there between
blocks (`DeviceState`): reading ``state`` fetches it to the host once (the
per-sample code then works on that array), and the next block moves it back.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from .._config import default_device, default_float


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_block(x, device=None) -> torch.Tensor:
    """A block as a tensor: a tensor stays on its device, numpy data goes to
    ``device`` (default: `_config.default_device()`) in the default float
    dtype, as the JAX package's ``jnp.asarray`` takes it."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), dtype=default_float(),
                           device=default_device() if device is None else device)


class RealtimeFilter(abc.ABC):
    """Sample/block streaming filter contract
    (`dsptoolbox_tpu/realtime/base.py:18`)."""

    @abc.abstractmethod
    def process_sample(self, x: float, channel: int):
        """Process one sample for a channel (state updated in place)."""

    @abc.abstractmethod
    def reset_state(self):
        """Reset all filter states to 0."""

    @abc.abstractmethod
    def set_n_channels(self, n_channels: int):
        """Set the number of channels to be filtered."""

    def process_block(self, block, channel: int):
        """Process a 1D block of samples (default: the per-sample loop on
        the host; the device forms override this)."""
        block = host_array(block)
        out = np.empty_like(block)
        for i in range(len(block)):
            out[i] = self.process_sample(block[i], channel)
        return out


class DeviceState:
    """The ``state`` attribute of a streaming filter, ``(N, C)`` float64:
    on the host as numpy for `process_sample` and for reading, on a device
    as a tensor for blocks. It lives in one place at a time and moves only
    where it is used, so a stream of blocks never syncs with the host."""

    def _init_state(self, shape: tuple) -> None:
        self._host_state = np.zeros(shape)
        self._dev_state = None

    @property
    def state(self) -> np.ndarray:
        """The state as a host float64 array (the JAX package's layout):
        fetched from the device where the last block left it; changes to
        this array act on the filter."""
        if self._host_state is None:
            self._host_state = self._dev_state.cpu().numpy().copy()
            self._dev_state = None
        return self._host_state

    @state.setter
    def state(self, value) -> None:
        self._host_state = np.array(host_array(value), dtype=np.float64)
        self._dev_state = None

    def device_state(self, device) -> torch.Tensor:
        """The state as a float64 tensor on ``device``, moved there if it is
        elsewhere (its host copy dropped)."""
        device = torch.device(device)
        if self._dev_state is None or self._dev_state.device != device:
            if self._host_state is not None:
                self._dev_state = torch.tensor(self._host_state, dtype=torch.float64,
                                               device=device)
            else:
                self._dev_state = self._dev_state.to(device)
            self._host_state = None
        return self._dev_state

    def _zero_state(self) -> None:
        if self._host_state is not None:
            self._host_state.fill(0.0)
        else:
            self._dev_state.zero_()

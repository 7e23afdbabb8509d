"""Streaming IIR/FIR filters (`dsptoolbox_tpu/realtime/iir_fir.py`):
per-sample TDF2 and circular-buffer FIR on the host, blocks on the device.

`IIRFilter.process_block` runs `ops.iir.lfilter` with the channel's state
(B2 on a float32 CUDA tensor); above order 2 it keeps each channel's exact
cascade state beside the TDF2 ``state`` (`iir_block.lfilter_handover`) and
continues from it while ``state`` is the one it handed out, so a stream pays
no lossy state map a block. The state stays on the block's device in
float64, so a stream of blocks never waits on the host. The block
convolutions (overlap-save, uniformly partitioned) are ``torch.fft`` on the
device, with the partition spectra and the frequency-domain delay line
resident there.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.fft import next_fast_len

from .._config import default_device, default_float
from .._enums import FilterCoefficientsType
from ..ops.cuda_iir import MAX_STATES
from ..ops.iir import lfilter
from ..ops.iir_block import lfilter_handover
from .base import DeviceState, RealtimeFilter, as_block


class IIRFilter(DeviceState, RealtimeFilter):
    """Transposed direct-form II streaming IIR
    (`dsptoolbox_tpu/realtime/iir_fir.py:20`)."""

    def __init__(self, b: np.ndarray, a: np.ndarray):
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        b = b / a[0]
        a = a / a[0]
        self.order = max(len(b), len(a)) - 1
        self.b = np.pad(b, (0, self.order + 1 - len(b)))
        self.a = np.pad(a, (0, self.order + 1 - len(a)))
        # the cascade route: an IIR of order 3 to MAX_STATES whose trimmed
        # coefficients keep its order (`ops.iir.lfilter`'s stateful route)
        bt, at = (np.trim_zeros(v, "b") for v in (self.b, self.a))
        self._cascade = (len(at) > 1 and 2 < self.order <= MAX_STATES
                         and max(len(bt), len(at)) - 1 == self.order)
        self.set_n_channels(1)

    @staticmethod
    def from_filter(iir) -> "IIRFilter":
        assert iir.is_iir, "Only valid for IIR filters"
        b, a = iir.get_coefficients(FilterCoefficientsType.Ba)
        return IIRFilter(b, a)

    def set_n_channels(self, n_channels: int):
        self._init_state((self.order, n_channels))
        self._kept = [None] * n_channels

    def reset_state(self):
        self._zero_state()
        self._kept = [None] * len(self._kept)

    def process_sample(self, x: float, channel: int):
        state = self.state
        y = self.b[0] * x + state[0, channel]
        for i in range(self.order - 1):
            state[i, channel] = (
                x * self.b[i + 1] - y * self.a[i + 1] + state[i + 1, channel]
            )
        state[-1, channel] = x * self.b[-1] - y * self.a[-1]
        return y

    def process_block(self, block, channel: int):
        """One block ``(T,)`` through `ops.iir.lfilter` from the channel's
        state, on the block's device (numpy goes to the default device);
        returns the output there. Above order 2 the run continues from the
        channel's cascade state while ``state`` is still the one the last
        block left (`iir_block.lfilter_handover`: no host sync)."""
        x = as_block(block)
        s = self.device_state(x.device)
        if not self._cascade:
            y, zf = lfilter(self.b, self.a, x, zi=s[:, channel])
            s[:, channel] = zf
            return y
        kept = self._kept[channel]
        if kept is not None and kept[0].device != x.device:
            kept = None
        y, zf, self._kept[channel] = lfilter_handover(self.b, self.a, x, s[:, channel], kept)
        s[:, channel] = zf
        return y


class FIRFilter(RealtimeFilter):
    """Time-domain circular-buffer FIR on the host
    (`dsptoolbox_tpu/realtime/iir_fir.py:71`)."""

    def __init__(self, b: np.ndarray):
        b = np.asarray(b, dtype=np.float64)
        self.order = len(b) - 1
        self.b = b
        self.set_n_channels(1)

    @staticmethod
    def from_filter(fir) -> "FIRFilter":
        assert fir.is_fir, "Only valid for FIR filters"
        b, _ = fir.get_coefficients(FilterCoefficientsType.Ba)
        return FIRFilter(b)

    def set_n_channels(self, n_channels: int):
        self.state = np.zeros((self.order, n_channels))
        self.current_state_ind = np.zeros(n_channels, dtype=int)

    def reset_state(self):
        self.state.fill(0.0)

    def process_sample(self, x: float, channel: int):
        y = self.b[0] * x
        write_index = self.current_state_ind[channel]
        for i in range(self.order):
            read_index = (write_index - i) % self.order
            y += self.state[read_index, channel] * self.b[i + 1]
        write_index = (write_index + 1) % self.order
        self.state[write_index, channel] = x
        self.current_state_ind[channel] = write_index
        return y


class FIRFilterOverlapSave(RealtimeFilter):
    """Block overlap-save convolution on the device
    (`dsptoolbox_tpu/realtime/iir_fir.py:108`): the filter's spectrum and
    the input buffer ``(total_length, C)`` stay on the default device."""

    def __init__(self, b: np.ndarray):
        b = np.asarray(b, dtype=np.float64)
        assert b.ndim == 1, "A single dimension should be provided"
        self.fir = b

    @staticmethod
    def from_filter(fir) -> "FIRFilterOverlapSave":
        assert fir.is_fir, "Only valid for FIR filters"
        b, _ = fir.get_coefficients(FilterCoefficientsType.Ba)
        return FIRFilterOverlapSave(b)

    def prepare(self, blocksize_samples: int, n_channels: int):
        self.blocksize = blocksize_samples
        self.total_length = next_fast_len(len(self.fir) + blocksize_samples, True)
        dev = default_device()
        self.fir_spectrum = torch.fft.rfft(
            torch.as_tensor(self.fir, dtype=default_float(), device=dev), n=self.total_length)
        self.buffer = torch.zeros((self.total_length, n_channels), dtype=default_float(),
                                  device=dev)

    def process_block(self, block, channel: int):
        buf = self.buffer
        buf[-self.blocksize:, channel] = as_block(block, buf.device)
        spec = torch.fft.rfft(buf[:, channel])
        out = torch.fft.irfft(spec * self.fir_spectrum, n=self.total_length)[-self.blocksize:]
        buf[: -self.blocksize, channel] = buf[self.blocksize:, channel].clone()
        return out

    def process_sample(self, x: float, channel: int):
        raise NotImplementedError("The convolution can only done via block-processing")

    def reset_state(self):
        self.buffer.zero_()

    def set_n_channels(self, n_channels: int):
        raise NotImplementedError("Use prepare method for setting the filter")


def _partition_spectra(fir: np.ndarray, blocksize: int, fft_size: int, device) -> torch.Tensor:
    """``(F, P, ...)`` complex spectra of the FIR ``(K, ...)`` cut into P
    partitions of ``blocksize`` taps (host float64, as the JAX package cuts
    them), kept on ``device`` in the default complex dtype."""
    n_partitions = fir.shape[0] // blocksize + 1
    partitioned = np.zeros((blocksize, n_partitions) + fir.shape[1:])
    for n in range(n_partitions):
        part = fir[n * blocksize: (n + 1) * blocksize]
        partitioned[: len(part), n] = part
    spec = np.fft.rfft(partitioned, axis=0, n=fft_size)
    cdt = torch.complex64 if default_float() == torch.float32 else torch.complex128
    return torch.as_tensor(spec, device=device).to(cdt)


class FIRUniformPartitioned(FIRFilterOverlapSave):
    """Uniformly partitioned overlap-save with a frequency-domain delay line
    on the device (`dsptoolbox_tpu/realtime/iir_fir.py:154`). The delay
    line ``(F, P, C)`` is indexed circularly as in the JAX package; the
    partitions each step reads come from a table kept on the device, so a
    block uploads nothing."""

    def __init__(self, fir: np.ndarray):
        fir = np.asarray(fir, dtype=np.float64)
        assert fir.ndim == 1
        self.fir = fir

    @staticmethod
    def from_filter(fir) -> "FIRUniformPartitioned":
        assert fir.is_fir, "Only valid for FIR filters"
        b, _ = fir.get_coefficients(FilterCoefficientsType.Ba)
        return FIRUniformPartitioned(b)

    def prepare(self, blocksize_samples: int, n_channels: int):
        self.blocksize = blocksize_samples
        self.fft_size = blocksize_samples * 2
        self._prepare_partitions(n_channels)

    def _prepare_partitions(self, n_channels: int):
        dev = default_device()
        self._spectra = _partition_spectra(self.fir, self.blocksize, self.fft_size, dev)
        self.n_partitions = self._spectra.shape[1]
        self.buffer_ind = 0
        P = self.n_partitions
        # row i: the partition slots read at write index i, (i - p) % P
        self._select = torch.as_tensor(
            (np.arange(P)[:, None] - np.arange(P)[None, :]) % P, device=dev)
        self._state = torch.zeros((self.fft_size // 2 + 1, P, n_channels),
                                  dtype=self._spectra.dtype, device=dev)
        self.input_buffer = torch.zeros((self.fft_size, n_channels), dtype=default_float(),
                                        device=dev)

    def reset_state(self):
        self._state.zero_()
        self.input_buffer.zero_()

    def _shift_in(self, buf: torch.Tensor, block) -> None:
        buf[: self.blocksize] = buf[-self.blocksize:].clone()
        buf[-self.blocksize:] = as_block(block, buf.device)

    def process_block(self, block, channel: int):
        self._shift_in(self.input_buffer[:, channel], block)
        self._state[:, self.buffer_ind, channel] = torch.fft.rfft(self.input_buffer[:, channel])
        buf = self._state[:, self._select[self.buffer_ind], channel]  # (F, P)
        out = torch.fft.irfft(torch.sum(self._spectra * buf, dim=1), n=self.fft_size)
        self.buffer_ind = (self.buffer_ind + 1) % self.n_partitions
        return out[-self.blocksize:]


class FIRUniformPartitionedMultichannel(FIRUniformPartitioned):
    """Uniformly partitioned convolution of every channel with its own FIR
    in one step (`dsptoolbox_tpu/realtime/iir_fir.py:236`)."""

    def __init__(self, fir: np.ndarray):
        fir = np.atleast_2d(np.asarray(fir, dtype=np.float64))
        if fir.shape[0] < fir.shape[1]:
            fir = fir.T
        self.fir = fir

    def prepare(self, blocksize_samples: int):  # type: ignore[override]
        self.blocksize = blocksize_samples
        self.fft_size = blocksize_samples * 2
        self.n_channels = self.fir.shape[1]
        self._prepare_partitions(self.n_channels)

    def process_block(self, block):  # type: ignore[override]
        """One block ``(blocksize, C)`` → ``(blocksize, C)`` on the device."""
        self._shift_in(self.input_buffer, block)
        self._state[:, self.buffer_ind] = torch.fft.rfft(self.input_buffer, dim=0)
        buf = self._state[:, self._select[self.buffer_ind]]  # (F, P, C)
        out = torch.fft.irfft(torch.sum(self._spectra * buf, dim=1), n=self.fft_size, dim=0)
        self.buffer_ind = (self.buffer_ind + 1) % self.n_partitions
        return out[-self.blocksize:]

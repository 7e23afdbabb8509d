"""FilterBank: an ordered list of Filters applied in Parallel, Sequential
or Summed mode (`dsptoolbox_tpu/classes/filterbank.py`).

A bank of two or more SOS filters without state or zero phase is stacked
into one ``(B, S, 6)`` bank and applied in one call of
`ops.iir_block.sosfilt_bank_apply_planes` (the filter-bank kernel B3 on a
float32 CUDA tensor); its operators are built once per (bank, length,
dtype, device) and kept on the device. The bands stay on the device as
views of the bank's output planes. Not ported: ``mesh=`` (band-parallel
banks over several devices), the frequency-sampling bank path, multirate
filtering of a MultiBandSignal, the bank's transfer function, filter
removal and reordering, saving and plots.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from ..ops.iir_block import bank_device_operators, sosfilt_bank_apply_planes, stack_sos_bank
from .._enums import FilterBankMode
from .filter import Filter
from .filter_helpers import _replace_channels, impulse
from .impulse_response import ImpulseResponse
from .multibandsignal import MultiBandSignal
from .signal import DeviceTimeData, Signal

def _sos_bank_or_none(filters: list) -> np.ndarray | None:
    """The filters stacked ``(B, S_max, 6)`` by `iir_block.stack_sos_bank`
    when every one is SOS and all are real or all complex; None when the
    bank cannot be stacked (`classes/filterbank.py:25`)."""
    if not filters or not all(f.has_sos for f in filters):
        return None
    return stack_sos_bank([f.sos for f in filters])


def _banked_filter_apply(signal: Signal, bank: np.ndarray, summed: bool = False):
    """All bands of ``bank`` on the signal's real part in one bank call.

    Returns per band ``(real (T, C), imag (T, C) | None, peak)`` (one such
    triple when ``summed``); ``peak`` is ``max(|real|, |imag|)`` when the
    signal constrains its amplitude, from one reduction over all bands and
    one host sync, else None.
    """
    x = signal._x  # (C, T)
    ops = bank_device_operators(bank, x.shape[-1], x.dtype, x.device)
    re, im = sosfilt_bank_apply_planes(ops, x)  # (B, C, T)
    if summed:
        re, im = re.sum(0, keepdim=True), (None if im is None else im.sum(0, keepdim=True))
    peaks = [None] * re.shape[0]
    if signal.constrain_amplitude:
        p = re.abs().amax(dim=(1, 2))
        if im is not None:
            p = torch.maximum(p, im.abs().amax(dim=(1, 2)))
        peaks = p.tolist()
    triples = [
        (re[b].T, None if im is None else im[b].T, peaks[b]) for b in range(re.shape[0])
    ]
    return triples[0] if summed else triples


def filterbank_on_signal(
    signal: Signal,
    filters: list[Filter],
    mode: FilterBankMode,
    activate_zi: bool = False,
    zero_phase: bool = False,
    same_sampling_rate: bool = True,
):
    """Apply a list of filters in the selected mode
    (`classes/filterbank.py:246`)."""
    n_filt = len(filters)
    bankable = not activate_zi and not zero_phase and same_sampling_rate and n_filt > 1
    bank = _sos_bank_or_none(filters) if bankable else None
    if mode == FilterBankMode.Parallel:
        if bank is not None:
            channels = np.arange(signal.number_of_channels)
            bands = [
                _replace_channels(signal, DeviceTimeData(*t), channels,
                                  filters[b].warning_if_complex)
                for b, t in enumerate(_banked_filter_apply(signal, bank))
            ]
        else:
            bands = [f.filter_signal(signal, activate_zi=activate_zi, zero_phase=zero_phase)
                     for f in filters]
        return MultiBandSignal(bands, same_sampling_rate=same_sampling_rate)
    if mode == FilterBankMode.Sequential:
        out_sig = signal.copy()
        for f in filters:
            out_sig = f.filter_signal(out_sig, activate_zi=activate_zi, zero_phase=zero_phase)
        return out_sig
    if mode == FilterBankMode.Summed:
        if bank is not None:
            return signal.copy_with_new_time_data(
                DeviceTimeData(*_banked_filter_apply(signal, bank, summed=True))
            )
        # parity: the filters' real parts are summed, as in the JAX package
        total = None
        for f in filters:
            td = f.filter_signal(signal, activate_zi=activate_zi, zero_phase=zero_phase).time_data
            total = td if total is None else total + td
        return signal.copy_with_new_time_data(total)
    raise ValueError("Invalid filter bank apply mode")


class FilterBank:
    def __init__(
        self,
        filters: list | None = None,
        same_sampling_rate: bool = True,
        info: dict | None = None,
    ):
        """Bank of filters applied in parallel, sequentially or summed
        (`classes/filterbank.py:327`)."""
        self.same_sampling_rate = same_sampling_rate
        self.filters = filters if filters is not None else []
        self.info: dict = {} if info is None else info

    # ======== Properties ====================================================
    @property
    def filters(self) -> list[Filter]:
        return self.__filters

    @filters.setter
    def filters(self, new_filters):
        if new_filters is None:
            new_filters = []
        if isinstance(new_filters, tuple):
            new_filters = list(new_filters)
        assert isinstance(new_filters, list), "filters must be a list"
        if new_filters:
            for f in new_filters:
                assert isinstance(f, Filter), (
                    f"{type(f)} is not a valid filter type. Use Filter objects"
                )
            if self.same_sampling_rate:
                self.sampling_rate_hz = new_filters[0].sampling_rate_hz
                for f in new_filters:
                    assert f.sampling_rate_hz == self.sampling_rate_hz, (
                        "Not all filters have the same sampling rate. For a multirate "
                        "bank set same_sampling_rate to False"
                    )
            else:
                self.sampling_rate_hz = [f.sampling_rate_hz for f in new_filters]
        self.__filters = new_filters

    @property
    def same_sampling_rate(self) -> bool:
        return self.__same_sampling_rate

    @same_sampling_rate.setter
    def same_sampling_rate(self, new_same):
        assert isinstance(new_same, bool)
        self.__same_sampling_rate = new_same

    @property
    def sampling_rate_hz(self):
        return self.__sampling_rate_hz

    @sampling_rate_hz.setter
    def sampling_rate_hz(self, new_sampling_rate_hz):
        if self.same_sampling_rate:
            self.__sampling_rate_hz = int(np.squeeze(new_sampling_rate_hz))
        else:
            self.__sampling_rate_hz = [int(s) for s in np.atleast_1d(new_sampling_rate_hz)]

    @property
    def number_of_filters(self) -> int:
        return len(self.filters)

    def __len__(self):
        return self.number_of_filters

    def __iter__(self):
        return iter(self.filters)

    # ======== Filter management =============================================
    def add_filter(self, filt: Filter, index: int = -1) -> "FilterBank":
        filters = self.filters
        filters = filters + [filt] if index == -1 else filters[:index] + [filt] + filters[index:]
        self.filters = filters
        return self

    def copy(self) -> "FilterBank":
        return deepcopy(self)

    def initialize_zi(self, number_of_channels: int = 1) -> "FilterBank":
        for f in self.filters:
            f.initialize_zi(number_of_channels)
        return self

    # ======== Filtering =====================================================
    def filter_signal(
        self,
        signal: Signal,
        mode: FilterBankMode,
        activate_zi: bool = False,
        zero_phase: bool = False,
    ):
        """Apply the bank (`classes/filterbank.py:475`): Parallel →
        MultiBandSignal, Sequential and Summed → Signal."""
        if isinstance(signal, MultiBandSignal):
            raise TypeError(
                "This method only supports Signal objects. Multirate filtering of a "
                "MultiBandSignal is not ported yet"
            )
        if mode in (FilterBankMode.Sequential, FilterBankMode.Summed):
            assert self.same_sampling_rate, (
                "Multirate filtering is not valid for sequential or summed filtering"
            )
        assert np.all(signal.sampling_rate_hz == self.sampling_rate_hz), (
            "Sampling rates do not match"
        )
        if zero_phase:
            assert not activate_zi, (
                "Zero-phase filtering and zi cannot be used at the same time"
            )
        if activate_zi and (
            not hasattr(self.filters[0], "zi")
            or len(self.filters[0].zi) != signal.number_of_channels
        ):
            self.initialize_zi(signal.number_of_channels)
        return filterbank_on_signal(
            signal, self.filters, mode=mode, activate_zi=activate_zi,
            zero_phase=zero_phase, same_sampling_rate=self.same_sampling_rate,
        )

    # ======== Getters =======================================================
    def get_ir(
        self,
        length_samples: int = 1024,
        mode: FilterBankMode = FilterBankMode.Parallel,
        zero_phase: bool = False,
        device=None,
    ):
        """Impulse responses of the bank (`classes/filterbank.py:595`), on
        ``device`` (default: `_config.default_device()`); a multirate bank
        delivers one dirac per filter at that filter's rate (Parallel
        only)."""
        if not self.same_sampling_rate:
            assert mode == FilterBankMode.Parallel, (
                "Multirate filter bank can only deliver an IR in parallel mode"
            )
            mb = MultiBandSignal(same_sampling_rate=False)
            for fs, filt in zip(self.sampling_rate_hz, self.filters):
                d = ImpulseResponse(None, impulse(length_samples), fs,
                                    constrain_amplitude=False, device=device)
                mb.add_band(filt.filter_signal(d, zero_phase=zero_phase))
            return mb
        d = ImpulseResponse(None, impulse(length_samples), self.sampling_rate_hz,
                            constrain_amplitude=False, device=device)
        return self.filter_signal(d, mode, zero_phase=zero_phase)

"""FilterBank: an ordered list of Filters applied in Parallel, Sequential
or Summed mode (`dsptoolbox_tpu/classes/filterbank.py`).

A bank of two or more SOS filters without state or zero phase is stacked
into one ``(B, S, 6)`` bank and applied in one call of
`ops.iir_block.sosfilt_bank_apply_planes` (the filter-bank kernel B3 on a
float32 CUDA tensor); its operators are built once per (bank, length,
dtype, device) and kept on the device. The bands stay on the device as
views of the bank's output planes. With a ``mesh`` of more than one
device such a bank runs band-parallel (`parallel.parallel_filterbank`),
padded with silent sections to a band count the mesh divides.
`filter_multiband_signal` filters each band with its own filter; the plots
draw the bank's IRs' spectra on `plots`; `save_filterbank` pickles. Not
ported: the frequency-sampling bank path.
"""

from __future__ import annotations

from copy import deepcopy
from pickle import HIGHEST_PROTOCOL, dump
from warnings import warn

import numpy as np
import torch

from .._config import in_pipeline
from ..helpers.other import check_format_in_path
from ..ops.iir_block import bank_device_operators, sosfilt_bank_apply_planes, stack_sos_bank
from .._trace import spanned
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


def _banked_planes_mesh(signal: Signal, bank: np.ndarray, mesh) -> tuple:
    """The bank's ``(real, imag)`` planes ``(B, C, T)`` over a device mesh
    (`dsptoolbox_tpu/classes/filterbank.py:74-141`): the bands split over
    the mesh's first axis, padded to a count it divides with silent
    sections (zero numerator, ``a0 = 1``), which Parallel drops and Summed
    adds as zeros; on the mesh's first device."""
    from ..parallel import parallel_filterbank

    B = bank.shape[0]
    pad = (-B) % int(mesh.shape[mesh.axis_names[0]])
    if pad:
        silent = np.zeros((pad, bank.shape[1], 6), bank.dtype)
        silent[:, :, 3] = 1.0
        bank = np.concatenate([bank, silent], axis=0)
    y = parallel_filterbank(bank, signal._x, mesh)[:B]
    return (y.real, y.imag) if y.is_complex() else (y, None)


def _banked_filter_apply(signal: Signal, bank: np.ndarray, summed: bool = False, mesh=None):
    """All bands of ``bank`` on the signal's real part in one bank call
    (band-parallel over ``mesh`` when it has more than one device).

    Returns per band ``(real (T, C), imag (T, C) | None, peak)`` (one such
    triple when ``summed``); ``peak`` is ``max(|real|, |imag|)`` when the
    signal constrains its amplitude, from one reduction over all bands and
    one host sync (in a pipeline, `_config.in_pipeline`, no sync: 0-d
    tensors on the device), else None.
    """
    x = signal._x  # (C, T)
    if mesh is not None and mesh.devices.size > 1:
        re, im = _banked_planes_mesh(signal, bank, mesh)
    else:
        ops = bank_device_operators(bank, x.shape[-1], x.dtype, x.device)
        re, im = sosfilt_bank_apply_planes(ops, x)  # (B, C, T)
    if summed:
        re, im = re.sum(0, keepdim=True), (None if im is None else im.sum(0, keepdim=True))
    peaks = [None] * re.shape[0]
    if signal.constrain_amplitude:
        p = re.abs().amax(dim=(1, 2))
        if im is not None:
            p = torch.maximum(p, im.abs().amax(dim=(1, 2)))
        peaks = list(p.unbind()) if in_pipeline() else p.tolist()
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
    mesh=None,
):
    """Apply a list of filters in the selected mode
    (`classes/filterbank.py:246`). ``mesh``: a stackable bank (all SOS, no
    state, no zero phase) runs band-parallel over it; otherwise the hint is
    ignored."""
    n_filt = len(filters)
    bankable = not activate_zi and not zero_phase and same_sampling_rate and n_filt > 1
    bank = _sos_bank_or_none(filters) if bankable else None
    if mode == FilterBankMode.Parallel:
        if bank is not None:
            channels = np.arange(signal.number_of_channels)
            bands = [
                _replace_channels(signal, DeviceTimeData(*t), channels,
                                  filters[b].warning_if_complex)
                for b, t in enumerate(_banked_filter_apply(signal, bank, mesh=mesh))
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
                DeviceTimeData(*_banked_filter_apply(signal, bank, summed=True, mesh=mesh))
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

    def __str__(self):
        return self.metadata_str

    @property
    def metadata(self) -> dict:
        info = {
            "number_of_filters": self.number_of_filters,
            "same_sampling_rate": self.same_sampling_rate,
        }
        if self.same_sampling_rate and self.filters:
            info["sampling_rate_hz"] = self.sampling_rate_hz
        info["types_of_filters"] = tuple(set(f.metadata["filter_type"] for f in self.filters))
        return info

    @property
    def metadata_str(self) -> str:
        txt = "Filter bank:"
        for k, v in (self.metadata | self.info).items():
            txt += f" | {str(k).replace('_', ' ').capitalize()}: {v}"
        txt += "\n" + "–" * len(txt)
        for ind, f in enumerate(self.filters):
            txt += f"\nFilter {ind}:"
            for kf, vf in f.metadata.items():
                txt += f" | {str(kf).replace('_', ' ').capitalize()}: {vf}"
        return txt

    def show_info(self):
        print(self.metadata_str)
        return self

    # ======== Filter management =============================================
    def add_filter(self, filt: Filter, index: int = -1) -> "FilterBank":
        filters = self.filters
        filters = filters + [filt] if index == -1 else filters[:index] + [filt] + filters[index:]
        self.filters = filters
        return self

    def remove_filter(self, index: int = -1, return_filter: bool = False):
        assert self.filters, "There are no filters to remove"
        filters = list(self.filters)
        f = filters.pop(index)
        self.filters = filters
        if return_filter:
            return self, f
        return self

    def swap_filters(self, new_order) -> "FilterBank":
        new_order = np.atleast_1d(np.asarray(new_order).squeeze())
        assert len(new_order) == self.number_of_filters, "The number of filters does not match"
        assert all(new_order < self.number_of_filters) and all(new_order >= 0), (
            f"Indexes of new filters have to be in [0, {self.number_of_filters - 1}]"
        )
        assert len(np.unique(new_order)) == len(new_order), (
            "There are repeated indexes in the new order vector"
        )
        self.filters = [self.filters[i] for i in new_order]
        return self

    def save_filterbank(self, path: str):
        """Pickle the bank (`classes/filterbank.py:762`)."""
        path = check_format_in_path(path, "pkl")
        with open(path, "wb") as data_file:
            dump(self, data_file, HIGHEST_PROTOCOL)
        return self

    @staticmethod
    def firs_from_file(path: str) -> "FilterBank":
        """One FIR per channel of a WAV or FLAC file."""
        ir = ImpulseResponse.from_file(path)
        taps = ir.time_data.cpu().numpy()
        return FilterBank([Filter.from_ba(taps[:, ch], [1.0], ir.sampling_rate_hz)
                           for ch in range(ir.number_of_channels)])

    def copy(self) -> "FilterBank":
        return deepcopy(self)

    def initialize_zi(self, number_of_channels: int = 1) -> "FilterBank":
        for f in self.filters:
            f.initialize_zi(number_of_channels)
        return self

    # ======== Filtering =====================================================
    @spanned("dsp.entry.FilterBank.filter_signal")
    def filter_signal(
        self,
        signal: Signal,
        mode: FilterBankMode,
        activate_zi: bool = False,
        zero_phase: bool = False,
        mesh=None,
    ):
        """Apply the bank (`classes/filterbank.py:475`): Parallel →
        MultiBandSignal, Sequential and Summed → Signal. ``mesh``: a
        `parallel.Mesh` for band-parallel execution (Parallel and Summed SOS
        banks without zi or zero phase); ignored where the bank cannot be
        split."""
        if isinstance(signal, MultiBandSignal):
            raise TypeError(
                "This method only supports Signal objects. Use "
                "filter_multiband_signal() for multirate parallel filtering"
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
            zero_phase=zero_phase, same_sampling_rate=self.same_sampling_rate, mesh=mesh,
        )

    def filter_multiband_signal(self, mbsignal: MultiBandSignal, activate_zi: bool = False,
                                zero_phase: bool = False) -> MultiBandSignal:
        """Each band through its own filter (`classes/filterbank.py:521`)."""
        assert np.all(mbsignal.sampling_rate_hz == self.sampling_rate_hz), (
            "Sampling rates do not match"
        )
        if zero_phase:
            assert not activate_zi, "Zero-phase filtering and zi cannot be used at the same time"
        if activate_zi and (not hasattr(self.filters[0], "zi")
                            or len(self.filters[0].zi) != mbsignal.number_of_channels):
            self.initialize_zi(mbsignal.number_of_channels)
        new_sig = mbsignal.copy()
        for n in range(mbsignal.number_of_bands):
            new_sig.bands[n] = self.filters[n].filter_signal(
                mbsignal.bands[n], channels=None, activate_zi=activate_zi, zero_phase=zero_phase)
        return new_sig

    # ======== Getters =======================================================
    def get_transfer_function(self, frequency_vector_hz: np.ndarray, mode: FilterBankMode
                              ) -> np.ndarray:
        """The bank's complex transfer function, host scipy
        (`classes/filterbank.py:568`): Parallel → (frequency, filter),
        Sequential and Summed → (frequency,). Parity: the Summed sum starts
        from ones, as in the reference."""
        if mode == FilterBankMode.Parallel:
            h = np.zeros((len(frequency_vector_hz), self.number_of_filters), dtype=np.complex128)
            for ind, f in enumerate(self.filters):
                h[:, ind] = f.get_transfer_function(frequency_vector_hz)
            return h
        if mode in (FilterBankMode.Sequential, FilterBankMode.Summed):
            h = np.ones(len(frequency_vector_hz), dtype=np.complex128)
            for f in self.filters:
                tf = f.get_transfer_function(frequency_vector_hz)
                h = h * tf if mode == FilterBankMode.Sequential else h + tf
            return h
        raise ValueError("No valid mode")

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

    # ======== Plots =========================================================
    def _response_spectra(self, length_samples: int, mode, zero_phase: bool = False):
        """``(f, spectra (F, n))`` of the bank's IRs: one per filter in
        Parallel, the combined one otherwise; None for a multirate bank,
        whose plots the reference skips with a warning
        (`classes/filterbank.py:633`)."""
        if not self.same_sampling_rate:
            warn("Plotting for multirate FilterBank is not supported, skipping plots")
            return None
        out = self.get_ir(length_samples, mode, zero_phase=zero_phase)
        bands = out.bands if mode == FilterBankMode.Parallel else [out]
        irs = torch.stack([b.time_data[:, 0] for b in bands], dim=1).cpu().numpy()
        return np.fft.rfftfreq(length_samples, 1 / self.sampling_rate_hz), np.fft.rfft(irs, axis=0)

    def _labels(self, n: int) -> list:
        return [f"Filter {k}" for k in range(n)]

    def plot_magnitude(self, length_samples: int = 1024,
                       mode: FilterBankMode = FilterBankMode.Parallel, range_hz=[20, 20e3],
                       zero_phase: bool = False):
        """Magnitude responses (`classes/filterbank.py:655`)."""
        from ..helpers.gain_and_level import to_db
        from ..plots import general_plot

        resp = self._response_spectra(length_samples, mode, zero_phase)
        if resp is None:
            return None
        f, sp = resp
        return general_plot(f, to_db(np.abs(sp), True), range_hz, ylabel="Magnitude / dB",
                            labels=self._labels(sp.shape[1]))

    def plot_phase(self, length_samples: int = 1024,
                   mode: FilterBankMode = FilterBankMode.Parallel, range_hz=[20, 20e3],
                   unwrap: bool = False):
        """Phase responses (`classes/filterbank.py:690`)."""
        from ..plots import general_plot

        resp = self._response_spectra(length_samples, mode)
        if resp is None:
            return None
        f, sp = resp
        ph = np.angle(sp)
        if unwrap:
            ph = np.unwrap(ph, axis=0)
        return general_plot(f, ph, range_hz, ylabel="Phase / rad",
                            labels=self._labels(sp.shape[1]))

    def plot_group_delay(self, length_samples: int = 1024,
                         mode: FilterBankMode = FilterBankMode.Parallel, range_hz=[20, 20e3]):
        """Group delays (`classes/filterbank.py:724`)."""
        from ..plots import general_plot
        from ..standard.backend import group_delay_direct

        resp = self._response_spectra(length_samples, mode)
        if resp is None:
            return None
        f, sp = resp
        gd = group_delay_direct(torch.as_tensor(np.angle(sp)), f[1] - f[0]).numpy() * 1e3
        return general_plot(f, gd, range_hz, ylabel="Group delay / ms",
                            labels=self._labels(sp.shape[1]))

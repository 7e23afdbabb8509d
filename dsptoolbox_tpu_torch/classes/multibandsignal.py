"""MultiBandSignal: a list of per-band Signals, optionally multirate
(`dsptoolbox_tpu/classes/multibandsignal.py`). The bands' data stays on
their device. Not ported: band removal and reordering, ``get_all_bands``,
metadata strings, plots and saving.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from .signal import DeviceTimeData, Signal


class MultiBandSignal:
    def __init__(
        self,
        bands: list | None = None,
        same_sampling_rate: bool = True,
        info: dict | None = None,
    ):
        self.same_sampling_rate = same_sampling_rate
        self.bands = bands if bands is not None else []
        self.info: dict = {} if info is None else info

    # ======== Properties ====================================================
    @property
    def bands(self) -> list[Signal]:
        return self.__bands

    @bands.setter
    def bands(self, new_bands):
        if new_bands is None:
            new_bands = []
        if isinstance(new_bands, tuple):
            new_bands = list(new_bands)
        assert isinstance(new_bands, list), "bands has to be a list"
        if new_bands:
            n_ch = new_bands[0].number_of_channels
            complex_data = new_bands[0].is_complex_signal
            for s in new_bands:
                assert isinstance(s, Signal), (
                    f"{type(s)} is not a valid band type. Use Signal objects"
                )
                assert s.number_of_channels == n_ch, (
                    "Signals have different number of channels. This behaviour is not "
                    "supported"
                )
                assert s.is_complex_signal == complex_data, (
                    "Some bands have imaginary time data and others do not. This "
                    "behavior is not supported."
                )
            if self.same_sampling_rate:
                self.sampling_rate_hz = new_bands[0].sampling_rate_hz
                expected = new_bands[0].length_samples
                for s in new_bands:
                    assert s.sampling_rate_hz == self.sampling_rate_hz, (
                        "Not all Signals have the same sampling rate. If you wish to "
                        "create a multirate system, set same_sampling_rate to False"
                    )
                    assert s.length_samples == expected, (
                        "The length of the bands is not always the same. This "
                        "behaviour is not supported if there is a constant sampling rate"
                    )
            else:
                self.sampling_rate_hz = [s.sampling_rate_hz for s in new_bands]
        self.__bands = new_bands

    @property
    def sampling_rate_hz(self):
        return self.__sampling_rate_hz

    @sampling_rate_hz.setter
    def sampling_rate_hz(self, new_sampling_rate_hz):
        if isinstance(new_sampling_rate_hz, (list, tuple, np.ndarray)):
            self.__sampling_rate_hz = [int(s) for s in new_sampling_rate_hz]
        else:
            self.__sampling_rate_hz = int(new_sampling_rate_hz)

    @property
    def same_sampling_rate(self) -> bool:
        return self.__same_sampling_rate

    @same_sampling_rate.setter
    def same_sampling_rate(self, new_same):
        assert isinstance(new_same, bool), "Same sampling rate attribute must be a boolean"
        self.__same_sampling_rate = new_same

    @property
    def number_of_bands(self) -> int:
        return len(self.bands)

    @property
    def number_of_channels(self) -> int:
        return self.bands[0].number_of_channels if self.bands else 0

    @property
    def length_samples(self):
        if self.same_sampling_rate:
            return self.bands[0].length_samples
        return [b.length_samples for b in self.bands]

    @property
    def is_complex_signal(self) -> bool:
        return self.bands[0].is_complex_signal

    def __len__(self):
        return self.number_of_bands

    def __iter__(self):
        return iter(self.bands)

    def copy(self) -> "MultiBandSignal":
        """A deep copy: the bands' tensors are copied on their device."""
        return deepcopy(self)

    # ======== Band management ===============================================
    def add_band(self, sig: Signal, index: int = -1) -> "MultiBandSignal":
        """Insert a band (validated through the bands setter)."""
        bands = self.bands
        bands = bands + [sig] if index == -1 else bands[:index] + [sig] + bands[index:]
        self.bands = bands
        return self

    def collapse(self) -> Signal:
        """The sum of all bands as one Signal, on the bands' device
        (`classes/multibandsignal.py:192`)."""
        assert self.same_sampling_rate, (
            "Collapsing is only available for same sampling rate bands"
        )
        total = self.bands[0]._x.clone()
        for b in self.bands[1:]:
            total += b._x
        total_imag = None
        if self.is_complex_signal:
            total_imag = self.bands[0]._x_imag.clone()
            for b in self.bands[1:]:
                total_imag += b._x_imag
        return self.bands[0].copy_with_new_time_data(
            DeviceTimeData(total.T, None if total_imag is None else total_imag.T)
        )

    # ======== Getters =======================================================
    def _band_data(self, b: Signal) -> torch.Tensor:
        td = b.time_data
        return torch.complex(td, b.time_data_imaginary) if self.is_complex_signal else td

    def get_all_time_data(self):
        """All data stacked ``(T, bands, channels)`` with the sampling rate
        (same rate), or a ``(data, rate)`` list per band
        (`classes/multibandsignal.py:243`); complex when the bands are."""
        if self.same_sampling_rate:
            return (torch.stack([self._band_data(b) for b in self.bands], dim=1),
                    self.sampling_rate_hz)
        return [(self._band_data(b), b.sampling_rate_hz) for b in self.bands]

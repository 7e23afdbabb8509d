"""Maximally decimated two-band crossovers (QMF;
`dsptoolbox_tpu/filterbanks/crossovers.py`). Downsampled analysis and
upsampled synthesis run on the signal's device through
`Filter.filter_and_resample_signal` (an FIR by its polyphase branches, an
IIR by `ops.iir.lfilter`).
"""

from __future__ import annotations

import numpy as np

from .._enums import FilterBankMode, FilterCoefficientsType
from ..classes.filter import Filter
from ..classes.filterbank import FilterBank
from ..classes.multibandsignal import MultiBandSignal
from ..classes.signal import Signal


def _crossover_downsample(
    signal: Signal,
    filters: list,
    mode: FilterBankMode,
    down_factor: int = 2,
):
    """Filter and decimate (`dsptoolbox_tpu/filterbanks/crossovers.py:20`)."""
    n_filt = len(filters)
    assert n_filt == 2, "A crossover should contain exactly 2 filters"
    new_rate = signal.sampling_rate_hz // down_factor
    if mode == FilterBankMode.Parallel:
        bands = [
            f.filter_and_resample_signal(signal, new_rate) for f in filters
        ]
        return MultiBandSignal(bands, same_sampling_rate=True)
    if mode == FilterBankMode.Sequential:
        out_sig = signal.copy()
        for f in filters:
            out_sig = f.filter_and_resample_signal(out_sig, new_rate)
        return out_sig
    total = None
    for f in filters:
        s = f.filter_and_resample_signal(signal, new_rate)
        total = s.time_data if total is None else total + s.time_data
    out_sig = signal.copy_with_new_time_data(total)
    out_sig.sampling_rate_hz = new_rate
    return out_sig


def _reconstruct_from_crossover_upsample(
    sig_low: Signal,
    sig_high: Signal,
    filters: list,
    up_factor: int = 2,
) -> Signal:
    """Upsample and synthesis filtering
    (`dsptoolbox_tpu/filterbanks/crossovers.py:47`)."""
    assert len(filters) == 2, "A crossover should contain exactly 2 filters"
    new_rate = sig_low.sampling_rate_hz * up_factor
    rec_sig = filters[0].filter_and_resample_signal(sig_low, new_rate)
    temp_sig = filters[1].filter_and_resample_signal(sig_high, new_rate)
    rec_sig.time_data = rec_sig.time_data + temp_sig.time_data
    return rec_sig


class BaseCrossover(FilterBank):
    """Two-band analysis/synthesis crossover
    (`_filterbank.py:842-1076`)."""

    def __init__(
        self,
        analysis_filters: list,
        synthesis_filters: list,
        info: dict | None = None,
    ):
        assert len(analysis_filters) == 2, (
            "Exactly two filters are needed for a valid crossover"
        )
        self.filters_synthesis = synthesis_filters
        super().__init__(
            filters=analysis_filters, same_sampling_rate=True, info=info
        )

    @property
    def filters_synthesis(self):
        return self.__filters_synthesis

    @filters_synthesis.setter
    def filters_synthesis(self, new_filters):
        assert len(new_filters) == 2, (
            "Two synthesis filters are needed in a crossover"
        )
        assert all(isinstance(n, Filter) for n in new_filters), (
            "Filters have to be of type Filter"
        )
        self.__filters_synthesis = new_filters

    def filter_signal(
        self,
        signal: Signal,
        mode: FilterBankMode,
        downsample: bool = False,
        zero_phase: bool = False,
        activate_zi: bool = False,
    ):
        if not downsample:
            return super().filter_signal(
                signal, mode, activate_zi, zero_phase=zero_phase
            )
        if zero_phase:
            raise NotImplementedError(
                "No zero-phase implementation with downsampling"
            )
        assert signal.sampling_rate_hz == self.sampling_rate_hz, (
            "Sampling rates do not match"
        )
        return _crossover_downsample(
            signal, self.filters, mode=mode, down_factor=2
        )

    def reconstruct_signal(
        self, signal: MultiBandSignal, upsample: bool = False
    ):
        assert signal.number_of_bands == 2, (
            "There must be exactly two bands in order to reconstruct "
            "signal using a crossover"
        )
        return _reconstruct_from_crossover_upsample(
            signal.bands[0],
            signal.bands[1],
            self.filters_synthesis,
            up_factor=2 if upsample else 1,
        )

    def plot_magnitude(
        self,
        length_samples: int = 512,
        mode: FilterBankMode = FilterBankMode.Parallel,
        range_hz=[20.0, 20e3],
        downsample: bool = True,
    ):
        """Magnitude response plot; with ``downsample`` the dirac is run
        through the downsampling analysis path and each band is plotted at
        its decimated rate (`_filterbank.py:954-1075`)."""
        if not downsample:
            return super().plot_magnitude(length_samples, mode, range_hz)
        from .._enums import SpectrumMethod
        from ..generators import dirac
        from ..helpers.gain_and_level import to_db
        from ..plots import general_plot

        d = dirac(
            length_samples,
            sampling_rate_hz=self.sampling_rate_hz,
            number_of_channels=1,
        )
        bs = self.filter_signal(d, mode=mode, downsample=True)
        if mode == FilterBankMode.Parallel:
            sigs = list(bs.bands)
            labels = [f"Filter {h}" for h in range(len(sigs))]
        elif mode == FilterBankMode.Sequential:
            sigs = [bs]
            labels = [
                f"Sequential - Channel {n}"
                for n in range(bs.number_of_channels)
            ]
        elif mode == FilterBankMode.Summed:
            sigs = [bs]
            labels = ["Summed"]
        else:
            raise ValueError("Invalid filter bank mode")
        mats = []
        f = None
        for b in sigs:
            b.spectrum_method = SpectrumMethod.FFT
            f_b, sp = b.get_spectrum(return_device=True)
            mats.append(np.squeeze(to_db(np.abs(sp.cpu().numpy()), True)))
            if f is None:
                f = f_b
        mat = np.atleast_2d(np.array(mats)).T
        return general_plot(
            f, mat, range_hz, ylabel="Magnitude / dB", labels=labels
        )


class QMFCrossover(BaseCrossover):
    """Quadrature-mirror-filter crossover
    (`_filterbank.py:1078-1201`)."""

    def __init__(self, lowpass: Filter):
        super().__init__(
            analysis_filters=self._get_analysis_filters(lowpass),
            synthesis_filters=self._get_synthesis_filters(lowpass),
            info=dict(Info="Quadrature mirror filters crossover"),
        )

    def _get_analysis_filters(self, lowpass: Filter):
        if not lowpass.is_iir:
            b_base, _ = lowpass.get_coefficients(FilterCoefficientsType.Ba)
            b_high = b_base.copy()
            b_high[1::2] *= -1  # H1(z) = H0(-z)
            highpass = Filter(
                {FilterCoefficientsType.Ba: [b_high, [1.0]]},
                sampling_rate_hz=lowpass.sampling_rate_hz,
            )
            self.fir_filterbank = True
        else:
            z, p, k = lowpass.get_coefficients(FilterCoefficientsType.Zpk)
            highpass = Filter(
                {FilterCoefficientsType.Zpk: [z * -1, p * -1, k]},
                sampling_rate_hz=lowpass.sampling_rate_hz,
            )
            self.fir_filterbank = False
        return [lowpass, highpass]

    def _get_synthesis_filters(self, lowpass: Filter):
        if not lowpass.is_iir:
            b_low, _ = lowpass.get_coefficients(FilterCoefficientsType.Ba)
            b_high = b_low.copy()
            b_high[1::2] *= -1
            hp_filter = Filter(
                {FilterCoefficientsType.Ba: [-b_high, [1.0]]},
                sampling_rate_hz=lowpass.sampling_rate_hz,
            )
        else:
            z, p, k = lowpass.get_coefficients(FilterCoefficientsType.Zpk)
            hp_filter = Filter(
                {FilterCoefficientsType.Zpk: [z * -1, p * -1, -k]},
                sampling_rate_hz=lowpass.sampling_rate_hz,
            )
        return [lowpass, hp_filter]

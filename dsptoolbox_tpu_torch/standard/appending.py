"""Appending of signals, filter banks and spectra
(`dsptoolbox_tpu/standard/appending.py`; reference
`dsptoolbox/standard/appending.py`), on the data's device."""

from __future__ import annotations

import torch

from ..classes import FilterBank, MultiBandSignal, Signal, Spectrum
from ..classes.signal import DeviceTimeData
from ..ops.pad_trim import pad_trim_axis
from .enums import SpectrumType


def append_signals(signals, allow_padding_trimming: bool = True, at_end: bool = True):
    """The channels of several signals as one (`appending.py:13`): every
    signal padded or trimmed to the first one's length (at its end, or at
    its start with ``at_end`` False), concatenated on the device; the
    result keeps the first signal's settings."""
    assert len(signals) > 1, "At least two signals should be passed"
    if isinstance(signals[0], Signal):
        complex_data = False
        for s in signals:
            assert isinstance(s, Signal), (
                "All signals must be of type Signal or ImpulseResponse"
            )
            assert s.sampling_rate_hz == signals[0].sampling_rate_hz, (
                "Sampling rates do not match"
            )
            if not allow_padding_trimming:
                assert len(s) == len(signals[0]), (
                    "Lengths do not match and padding or trimming is not "
                    "activated"
                )
            complex_data |= s.is_complex_signal
        total_length = len(signals[0])

        def cat(planes):
            return torch.cat(
                [pad_trim_axis(p, total_length, axis=-1, in_the_end=at_end) for p in planes]
            )

        re = cat([s._x for s in signals])
        im = None
        if complex_data:
            im = cat([torch.zeros_like(s._x) if s._x_imag is None else s._x_imag
                      for s in signals])
        # the first signal's settings without a copy of its data and caches
        return signals[0].copy_with_new_time_data(
            DeviceTimeData(re.T, None if im is None else im.T)
        )
    if isinstance(signals[0], MultiBandSignal):
        for s in signals:
            assert isinstance(s, MultiBandSignal), (
                "All signals must be of type MultiBandSignal"
            )
            assert s.same_sampling_rate == signals[0].same_sampling_rate, (
                "Sampling rates do not match"
            )
            assert s.sampling_rate_hz == signals[0].sampling_rate_hz, (
                "Sampling rates do not match"
            )
            if not allow_padding_trimming:
                assert s.length_samples == signals[0].length_samples, (
                    "Lengths do not match and padding or trimming is not "
                    "activated"
                )
            assert s.number_of_bands == signals[0].number_of_bands, (
                "Number of bands does not match"
            )
        new_bands = [
            append_signals([s.bands[n] for s in signals], allow_padding_trimming, at_end)
            for n in range(signals[0].number_of_bands)
        ]
        return MultiBandSignal(new_bands, same_sampling_rate=signals[0].same_sampling_rate)
    raise ValueError("Signals have to be type of type Signal or MultiBandSignal")


def append_filterbanks(fbs: list) -> FilterBank:
    """Merge the filters of several banks (`appending.py:116`)."""
    assert len(fbs) > 1, "At least two filter banks should be passed"
    same_sampling_rate = fbs[0].same_sampling_rate
    filters = []
    for fb in fbs:
        assert isinstance(fb, FilterBank), "All elements must be FilterBank"
        assert fb.same_sampling_rate == same_sampling_rate, (
            "Sampling rate handling does not match"
        )
        filters.extend([f.copy() for f in fb.filters])
    return FilterBank(filters, same_sampling_rate=same_sampling_rate)


def append_spectra(spectra: list, complex_if_available: bool = True) -> Spectrum:
    """The channels of several spectra (`appending.py:131`): each
    interpolated onto the FIRST spectrum's frequency vector; complex data
    only when the first spectrum is complex and ``complex_if_available``,
    magnitudes otherwise."""
    assert len(spectra) > 1, "There must be at least two spectra to join"
    assert all(isinstance(sp, Spectrum) for sp in spectra), (
        "All elements must be Spectrum"
    )
    complex_append = complex_if_available and not spectra[0].is_magnitude
    if complex_append:
        assert all(not s.is_magnitude for s in spectra), (
            "At least one spectrum is not complex"
        )
    freqs = spectra[0].frequency_vector_hz
    kind = SpectrumType.Complex if complex_append else SpectrumType.Magnitude
    spec = torch.cat([s.get_interpolated_spectrum(freqs, kind) for s in spectra], dim=1)
    if complex_append and not spec.is_complex():
        # parity: the reference fills a complex array, so a real-valued
        # interpolation (e.g. the default Power domain) stays complex
        spec = torch.complex(spec, torch.zeros_like(spec))
    return Spectrum(freqs, spec)

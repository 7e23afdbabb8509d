"""Room acoustics public API
(`dsptoolbox_tpu/room_acoustics/room_acoustics.py`).

Behavioral reference: `dsptoolbox/room_acoustics/room_acoustics.py`.

The per-channel fits and descriptors are host numpy decision logic: each
entry point fetches a signal's data in one transfer (a MultiBandSignal's
``(bands, channels, T)`` planes at once) and loops over the channels on
the host. The filters, convolutions, SVDs and the image-source lattice run
on the data's device; in float64 mode on the CPU `convolve_rir_on_signal`
runs the reference's scipy convolution (`classes.filter_helpers.
_oracle_exact_f64`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..classes import Filter, ImpulseResponse, MultiBandSignal, Signal
from ..helpers.gain_and_level import to_db
from ..helpers.other import find_nearest_points_index_in_vector
from ..ops.fft_conv import fft_convolve
from ..ops.pad_trim import pad_trim_axis
from .._enums import (
    FilterBankMode,
    FilterPassType,
    IirDesignMethod,
    SpectrumMethod,
)
from ..standard.pad_trim_methods import pad_trim
from . import _backend as bk
from .enums import ReverbTime, RoomAcousticsDescriptor
from .rooms import ShoeboxRoom


def _host_planes(signal) -> np.ndarray:
    """The real time data of an ImpulseResponse ``(C, T)`` or of a
    same-rate MultiBandSignal ``(B, C, T)`` (its bands stacked on their
    device) as host numpy, in one transfer."""
    if isinstance(signal, Signal):
        return signal._x.cpu().numpy()
    return torch.stack([b._x for b in signal.bands]).cpu().numpy()


def _check_impulse_responses(signal: MultiBandSignal) -> None:
    for b in signal.bands:
        if not isinstance(b, ImpulseResponse):
            raise TypeError(
                f"Passed signal has type {type(b)}. It should be of type "
                "ImpulseResponse or MultiBandSignal"
            )


def _reverb_channels(td: np.ndarray, fs: int, mode, automatic_trimming: bool):
    """RT and correlation of each host channel ``td (C, T)``."""
    times = np.zeros(td.shape[0])
    corrs = np.zeros(td.shape[0])
    for n in range(td.shape[0]):
        times[n], corrs[n] = bk.reverb(
            td[n], fs, mode, ir_start=None, return_ir_start=False,
            automatic_trimming=automatic_trimming,
        )
    return times, corrs


def reverb_time(
    signal,
    mode: ReverbTime = ReverbTime.Adaptive,
    ir_start=None,
    automatic_trimming: bool = True,
):
    """RT per channel, or per band and channel (`room_acoustics.py:26`):
    ``(times, correlation coefficients)`` as host numpy, ``(C,)`` for an
    ImpulseResponse, ``(B, C)`` for a MultiBandSignal of IRs. ``ir_start``
    is validated, as in the reference, and not used by the fits."""
    if isinstance(signal, ImpulseResponse):
        _check_ir_start_reverb(signal, ir_start)
        return _reverb_channels(_host_planes(signal), signal.sampling_rate_hz, mode,
                                automatic_trimming)
    if isinstance(signal, MultiBandSignal):
        _check_impulse_responses(signal)
        ir_start = _check_ir_start_reverb(signal, ir_start)
        if ir_start is not None:
            for ind, band in enumerate(signal.bands):
                _check_ir_start_reverb(band, ir_start[ind, :])
        planes = _host_planes(signal)
        times = np.zeros(planes.shape[:2])
        corrs = np.zeros_like(times)
        for ind in range(planes.shape[0]):
            times[ind], corrs[ind] = _reverb_channels(
                planes[ind], signal.sampling_rate_hz, mode, automatic_trimming
            )
        return times, corrs
    raise TypeError(
        f"Passed signal has type {type(signal)}. It should be of type "
        "ImpulseResponse or MultiBandSignal"
    )


def find_modes(
    signal: ImpulseResponse,
    f_range_hz=[50, 200],
    dist_hz: float = 5,
    prominence_db: float | None = None,
    antiresonances: bool = False,
) -> np.ndarray:
    """Room modes as the peaks of the complex mode indicator function
    (`room_acoustics.py:70`): the IR padded or trimmed to one second, its
    FFT spectrum and the CMIF's SVDs on its device, the peak search on the
    host. Sets the IR's spectrum method to FFT, as the reference does."""
    from scipy.signal import find_peaks

    assert len(f_range_hz) == 2, (
        "Range of frequencies must have a minimum and a maximum value"
    )
    assert isinstance(signal, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    signal.spectrum_method = SpectrumMethod.FFT
    signal = pad_trim(signal, signal.sampling_rate_hz)
    f, sp = signal.get_spectrum(return_device=True)
    ids = find_nearest_points_index_in_vector(f_range_hz, f)
    f = f[ids[0] : ids[1]]
    df = f[1] - f[0]
    sp = sp[ids[0] : ids[1], :]
    if antiresonances:
        sp = 1 / sp
    cmif = bk.complex_mode_identification(sp, True).squeeze()
    dist_samp = max(1, int(np.ceil(dist_hz / df)))
    id_cmif, _ = find_peaks(
        np.asarray(to_db(cmif, False)), distance=dist_samp, prominence=prominence_db
    )
    return f[id_cmif]


def convolve_rir_on_signal(
    signal: Signal,
    rir: Signal,
    keep_peak_level: bool = True,
    keep_length: bool = True,
) -> Signal:
    """Convolve a single-channel RIR onto every channel
    (`room_acoustics.py:108`), by FFT on the signal's device; in float64
    mode on the CPU by the reference's scipy dispatch
    (`dsptoolbox_tpu/room_acoustics/room_acoustics.py:124-134`)."""
    from ..classes.filter_helpers import _oracle_exact_f64

    assert rir.number_of_channels == 1, "RIR should not contain more than one channel."
    assert rir.sampling_rate_hz == signal.sampling_rate_hz, (
        "The sampling rates do not match"
    )
    x = signal._x  # (C, T)
    if _oracle_exact_f64(x.device):
        from scipy.signal import convolve, oaconvolve

        xh = x.T.cpu().numpy()
        h = rir._x.T.cpu().numpy()
        ratio = signal.length_samples / rir.length_samples
        if ratio < 15.0 or ratio < 1.0 / 15.0:
            yh = oaconvolve(xh, h, axes=0, mode="full")
        else:
            yh = convolve(xh, h, mode="full")
        if keep_length:
            yh = yh[: x.shape[-1]]
        if keep_peak_level:
            yh = yh * (np.max(np.abs(xh), axis=0) / np.max(np.abs(yh), axis=0))[None]
        return signal.copy_with_new_time_data(torch.from_numpy(yh).to(x.device))
    y = fft_convolve(x, rir._x[0].to(device=x.device), mode="full")
    if keep_length:
        y = y[..., : x.shape[-1]]
    if keep_peak_level:
        y = y * (x.abs().amax(dim=-1) / y.abs().amax(dim=-1))[:, None]
    return signal.copy_with_new_time_data(y.T)


def find_ir_start(signal: ImpulseResponse, threshold_dbfs: float = -20) -> np.ndarray:
    """Per-channel IR start (ISO 3382; `room_acoustics.py:152`), host
    numpy."""
    assert threshold_dbfs <= 0, "Threshold must be negative"
    td = _host_planes(signal)
    start_index = np.empty(signal.number_of_channels, dtype=int)
    for n in range(signal.number_of_channels):
        start_index[n] = bk.find_ir_start(td[n], threshold_dbfs)
    return start_index


def generate_synthetic_rir(
    room: ShoeboxRoom,
    source_position,
    receiver_position,
    sampling_rate_hz: int,
    total_length_seconds: float = 0.5,
    add_noise_reverberant_tail: bool = False,
    apply_bandpass: bool = False,
    use_detailed_absorption: bool = False,
    max_order: int | None = None,
) -> ImpulseResponse:
    """Image-source RIR (`room_acoustics.py:165`): the image lattice on
    `_config.default_device()` (`_backend.generate_rir`). Returns an
    ImpulseResponse whose data stays on that device; the reverberant tail
    noise is drawn on the host (numpy's global RNG, as in the reference).
    ``use_detailed_absorption`` generates one RIR per octave band of the
    room's detailed absorption and sums their zero-phase Linkwitz-Riley
    bands."""
    from ..filterbanks import linkwitz_riley_crossovers

    assert sampling_rate_hz is not None, "Sampling rate can not be None"
    assert isinstance(room, ShoeboxRoom), "Room must be of type ShoeboxRoom"
    source_position = np.asarray(source_position)
    receiver_position = np.asarray(receiver_position)
    assert room.check_if_in_room(source_position), "Source is not located inside the room"
    assert room.check_if_in_room(receiver_position), (
        "Receiver is not located inside the room"
    )
    total_length_samples = int(total_length_seconds * sampling_rate_hz)

    def one_rir(alpha) -> torch.Tensor:
        rir = bk.generate_rir(
            room_dim=room.dimensions_m, alpha=alpha, s_pos=source_position,
            r_pos=receiver_position, rt=room.t60_s, mo=max_order, sr=sampling_rate_hz,
        )
        return torch.nan_to_num(pad_trim_axis(rir, total_length_samples), nan=0.0)

    if not use_detailed_absorption:
        rir = one_rir(room.absorption_coefficient)
    else:
        assert hasattr(room, "detailed_absorption"), (
            "Given room has no detailed absorption dictionary"
        )
        freqs = room.detailed_absorption["center_frequencies"][:-1] * np.sqrt(2)
        fb = linkwitz_riley_crossovers(
            crossover_frequencies_hz=freqs, order=12, sampling_rate_hz=sampling_rate_hz
        )
        rir = None
        for ind in range(fb.number_of_bands):
            band = ImpulseResponse(
                None, one_rir(room.detailed_absorption["absorption_matrix"][:, ind]),
                sampling_rate_hz,
            )
            # summed in float64, as the reference sums into float64 zeros
            part = fb.filter_signal(band, zero_phase=True).bands[ind]._x[0].double()
            rir = part if rir is None else rir + part

    if add_noise_reverberant_tail:
        if getattr(room, "mixing_time_s", None) is None:
            room.get_mixing_time("physical", n_reflections=1000)
        rir = torch.as_tensor(
            bk.add_reverberant_tail_noise(rir, room.mixing_time_s, room.t60_s,
                                          sr=sampling_rate_hz),
            device=rir.device,
        )
    rir_output = ImpulseResponse(None, rir, sampling_rate_hz)
    if apply_bandpass:
        f = Filter.iir_filter(
            order=12,
            frequency_hz=[20.0, (sampling_rate_hz // 2) * 0.9],
            filter_design_method=IirDesignMethod.Butterworth,
            type_of_pass=FilterPassType.Bandpass,
            sampling_rate_hz=sampling_rate_hz,
        )
        rir_output = f.filter_signal(rir_output)
    return rir_output


def descriptors(
    rir,
    descriptor: RoomAcousticsDescriptor,
    automatic_trimming_rir: bool = True,
):
    """D50, C80, BassRatio or CenterTime (`room_acoustics.py:285`) per
    channel ``(C,)``, or per band and channel ``(B, C)`` for a
    MultiBandSignal (there the trimming is always automatic, as in the
    reference), as host numpy."""
    funcs = {
        RoomAcousticsDescriptor.D50: bk.d50_from_rir,
        RoomAcousticsDescriptor.C80: bk.c80_from_rir,
        RoomAcousticsDescriptor.CenterTime: bk.ts_from_rir,
    }
    if isinstance(rir, ImpulseResponse):
        if descriptor == RoomAcousticsDescriptor.BassRatio:
            return _bass_ratio(rir)
        return _descriptor_channels(_host_planes(rir), rir.sampling_rate_hz,
                                    funcs[descriptor], automatic_trimming_rir)
    if isinstance(rir, MultiBandSignal):
        assert descriptor != RoomAcousticsDescriptor.BassRatio, (
            "Bass-ratio is not a valid descriptor to be used on a "
            "MultiBandSignal. Pass a RIR as Signal to compute it"
        )
        _check_impulse_responses(rir)
        planes = _host_planes(rir)
        return np.stack([
            _descriptor_channels(p, rir.sampling_rate_hz, funcs[descriptor], True)
            for p in planes
        ])
    raise TypeError("RIR must be of type Signal or MultiBandSignal")


def _descriptor_channels(td: np.ndarray, fs: int, func, automatic_trimming: bool):
    return np.array([func(td[ch], fs, automatic_trimming) for ch in range(td.shape[0])])


def _bass_ratio_bank(sampling_rate_hz: int):
    """The bass ratio's order-10 Butterworth octave bands, 125-1000 Hz."""
    from ..filterbanks import fractional_octave_bands

    return fractional_octave_bands(
        [125, 1000], filter_order=10, sampling_rate_hz=sampling_rate_hz
    )[0]


def _bass_ratio(rir: ImpulseResponse) -> np.ndarray:
    """Bass ratio from the adaptive RTs of the 125-1000 Hz octave bands
    (`room_acoustics.py:321`), filtered with zero phase on the IR's
    device."""
    fb = _bass_ratio_bank(rir.sampling_rate_hz)
    rir_multi = fb.filter_signal(rir, FilterBankMode.Parallel, zero_phase=True)
    rt, _ = reverb_time(rir_multi)
    return (rt[0] + rt[1]) / (rt[2] + rt[3])


def _check_ir_start_reverb(sig, ir_start):
    """Normalize ir_start into per-channel / per-band arrays
    (`room_acoustics.py:338`)."""
    if ir_start is not None and isinstance(ir_start, (list, tuple)):
        ir_start = np.atleast_1d(ir_start).astype(int)
    if isinstance(sig, ImpulseResponse):
        if ir_start is None:
            return [None] * sig.number_of_channels
        if np.issubdtype(type(ir_start), np.integer):
            ir_start = np.ones(sig.number_of_channels, dtype=int) * int(ir_start)
        ir_start = np.asarray(ir_start)
        assert ir_start.ndim == 1 and len(ir_start) == (sig.number_of_channels), (
            "Shape of ir_start is not valid"
        )
        return ir_start.astype(int)
    if ir_start is None:
        return None
    if np.issubdtype(type(ir_start), np.integer):
        ir_start = np.ones((sig.number_of_bands, sig.number_of_channels), dtype=int) * int(
            ir_start
        )
    ir_start = np.asarray(ir_start)
    if ir_start.ndim == 1:
        ir_start = np.repeat(ir_start[None, ...], sig.number_of_bands, axis=0)
    else:
        assert ir_start.shape == (sig.number_of_bands, sig.number_of_channels), (
            "Shape of ir_start is not valid for the passed signal"
        )
    return ir_start.astype(int)

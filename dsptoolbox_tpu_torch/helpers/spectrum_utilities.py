"""Spectrum scaling, normalization and frequency-response interpolation
(`dsptoolbox_tpu/helpers/spectrum_utilities.py`; reference
`dsptoolbox/helpers/spectrum_utilities.py`).

Frequency vectors are host float64 numpy. Interpolation onto a new grid is
a static operator applied to the data on its device: gathers and a lerp for
the linear scheme, and for the quadratic and cubic splines one dense
operator built on the host through scipy (the reference's numerics) and
applied as a float32 product (TF32 stays off, the port's Numerics rule).
`get_normalized_spectrum` feeds plots: it fetches the data once and works
in host numpy, as the JAX package does.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._enums import MagnitudeNormalization, SpectrumScaling
from .gain_and_level import from_db, to_db
from .interpolation import linear_interpolate
from .other import find_nearest_points_index_in_vector
from .smoothing import fractional_octave_smoothing


def wrap_phase(phase_vector):
    """Phase wrapped into [-π, π) (`helpers/spectrum_utilities.py:25`);
    numpy or a tensor."""
    return (phase_vector + np.pi) % (2 * np.pi) - np.pi


def get_exact_gain_1khz(f: np.ndarray, sp_db):
    """The spectrum (in dB or not) linearly interpolated at 1 kHz along its
    first axis (`helpers/spectrum_utilities.py:32`)."""
    assert np.min(f) < 1e3 and np.max(f) >= 1e3, (
        "No gain at 1 kHz can be obtained because it is outside the "
        "given frequency vector"
    )
    ind = int(find_nearest_points_index_in_vector(1e3, f).squeeze())
    if f[ind] > 1e3:
        ind -= 1
    w = (1e3 - f[ind]) / (f[ind + 1] - f[ind])
    return sp_db[ind] + (sp_db[ind + 1] - sp_db[ind]) * w


def correct_for_real_phase_spectrum(phase_spectrum: torch.Tensor) -> torch.Tensor:
    """A linear phase added so that the phase at Nyquist is a multiple of π
    (`helpers/spectrum_utilities.py:48`); frequency on the first axis."""
    factor = torch.remainder(phase_spectrum[-1], np.pi)
    ramp = torch.linspace(0.0, 1.0, phase_spectrum.shape[0], dtype=phase_spectrum.dtype,
                          device=phase_spectrum.device)
    if phase_spectrum.ndim == 1:
        return phase_spectrum - ramp * factor
    return phase_spectrum - ramp[:, None] * factor[None, ...]


def scale_spectrum(
    spectrum: torch.Tensor,
    scaling: SpectrumScaling,
    time_length_samples: int,
    sampling_rate_hz: int,
    window: np.ndarray | None = None,
) -> torch.Tensor:
    """A backward-normalised rfft spectrum (frequency first) in the given
    scaling (`helpers/spectrum_utilities.py:58`): DC (and an even length's
    Nyquist) divided by √2, squared for the power scalings, times the
    scaling's factor."""
    assert time_length_samples in (
        (spectrum.shape[0] - 1) * 2,
        spectrum.shape[0] * 2 - 1,
    ), "Time length does not match"
    factor = scaling.get_scaling_factor(time_length_samples, sampling_rate_hz, window)
    edge = np.ones(spectrum.shape[0])
    edge[0] = 1 / 2**0.5
    if time_length_samples % 2 == 0:
        edge[-1] = 1 / 2**0.5
    spectrum = spectrum * torch.as_tensor(
        edge, dtype=spectrum.real.dtype, device=spectrum.device
    ).reshape((-1,) + (1,) * (spectrum.ndim - 1))
    if not scaling.is_amplitude_scaling():
        spectrum = spectrum.abs() ** 2
    return spectrum * factor


def _to_db_np(x, amplitude_input: bool, dynamic_range_db=None):
    factor = 20.0 if amplitude_input else 10.0
    x_abs = np.abs(x)
    if dynamic_range_db is not None:
        min_val = np.max(x_abs) * 10.0 ** (-abs(dynamic_range_db) / factor)
    else:
        min_val = float(np.finfo(np.float64).smallest_normal)
    return factor * np.log10(np.clip(x_abs, min_val, None))


def _smoothed_np(x: np.ndarray, smoothing: int) -> np.ndarray:
    """`fractional_octave_smoothing` of host data in the package's float,
    back as numpy."""
    from .._config import default_float

    return fractional_octave_smoothing(
        torch.as_tensor(x, dtype=default_float()), None, smoothing
    ).double().numpy()


def get_normalized_spectrum(
    f: np.ndarray,
    spectra,
    is_amplitude_scaling: bool,
    f_range_hz,
    normalize: MagnitudeNormalization,
    smoothing: int,
    phase: bool,
    calibrated_data: bool,
):
    """The magnitude spectrum in dB over a frequency range, smoothed and
    normalized, and optionally its phase (`helpers/spectrum_utilities.py:85`):
    the data of plots, in host numpy after one fetch."""
    if torch.is_tensor(spectra):
        spectra = spectra.cpu().numpy()
    spectra = np.asarray(spectra)
    one_dimensional = spectra.ndim < 2
    if one_dimensional:
        spectra = spectra[..., None]
    if phase:
        assert np.iscomplexobj(spectra), (
            "Phase computation is not possible since the spectra are not complex"
        )
    calibrated = calibrated_data and normalize == MagnitudeNormalization.NoNormalization
    if is_amplitude_scaling:
        scale_factor = 20e-6 if calibrated else 1
    else:
        scale_factor = 4e-10 if calibrated else 1
    if f_range_hz is not None:
        assert len(f_range_hz) == 2, (
            "Frequency range must have only a lower and an upper bound"
        )
        ids = find_nearest_points_index_in_vector(np.sort(np.asarray(f_range_hz)), f)
        id1, id2 = int(ids[0]), int(ids[1]) + 1
    else:
        id1, id2 = 0, len(f)
    spectra = spectra[id1:id2]
    mag = np.abs(spectra)
    f = f[id1:id2]
    # parity: the reference's nested `if is_amplitude_scaling:` leaves
    # power-scaled spectra unsmoothed (`spectrum_utilities.py:155-165`)
    if smoothing != 0 and is_amplitude_scaling:
        mag = _smoothed_np(mag, smoothing)
    mag_db = _to_db_np(mag / scale_factor, is_amplitude_scaling, 500)

    if normalize == MagnitudeNormalization.OneKhz:
        norm_db = np.asarray(get_exact_gain_1khz(f, mag_db))
    elif normalize == MagnitudeNormalization.OneKhzFirstChannel:
        norm_db = np.ones(spectra.shape[1]) * get_exact_gain_1khz(f, mag_db[:, 0])
    elif normalize == MagnitudeNormalization.Max:
        norm_db = np.max(mag_db, axis=0)
    elif normalize == MagnitudeNormalization.MaxFirstChannel:
        norm_db = np.max(mag_db[:, 0], axis=0, keepdims=True)
    elif normalize == MagnitudeNormalization.Energy:
        norm_db = _to_db_np(np.mean(mag**2.0 if is_amplitude_scaling else mag, axis=0), False)
    elif normalize == MagnitudeNormalization.EnergyFirstChannel:
        norm_db = _to_db_np(
            np.mean(mag[:, 0] ** 2.0 if is_amplitude_scaling else mag, axis=0, keepdims=True),
            False,
        )
    elif normalize == MagnitudeNormalization.NoNormalization:
        norm_db = np.zeros(mag.shape[1])
    else:
        raise ValueError("No valid normalization")
    mag_db = mag_db - np.atleast_1d(norm_db)[None, :]

    phase_spectra = None
    if phase:
        phase_spectra = np.angle(spectra)
        if smoothing != 0:
            smoothed = _smoothed_np(np.unwrap(phase_spectra, axis=0), smoothing)
            phase_spectra = (smoothed + np.pi) % (2 * np.pi) - np.pi
    if one_dimensional:
        mag_db = np.squeeze(mag_db)
        if phase:
            phase_spectra = np.squeeze(phase_spectra)
    if phase:
        return f, mag_db, phase_spectra
    return f, mag_db


@lru_cache(maxsize=32)
def _spline_operator(f_interp_key: tuple, f_target_key: tuple, kind: str) -> np.ndarray:
    """The static operator ``A`` with ``interpolated = A @ y``: identity
    basis vectors through scipy's ``interp1d`` (zero fill)
    (`helpers/spectrum_utilities.py:245`)."""
    from scipy.interpolate import interp1d

    eye = np.eye(len(f_interp_key))
    return np.asarray(interp1d(
        np.asarray(f_interp_key), eye, kind=kind, axis=0, copy=False,
        bounds_error=False, fill_value=0.0, assume_sorted=True,
    )(np.asarray(f_target_key)))


def apply_real_operator(A: np.ndarray, y: torch.Tensor) -> torch.Tensor:
    """``A (Fq, F) @ y (F, ...)`` on ``y``'s device in its real dtype (a
    complex ``y`` as its real and imaginary parts)."""
    Aj = torch.as_tensor(A, dtype=y.real.dtype, device=y.device)
    y2d = y.reshape(y.shape[0], -1)
    out = torch.complex(Aj @ y2d.real, Aj @ y2d.imag) if y.is_complex() else Aj @ y2d
    return out.reshape((A.shape[0],) + tuple(y.shape[1:]))


def interpolate_fr(
    f_interp: np.ndarray,
    fr_interp: torch.Tensor,
    f_target: np.ndarray,
    mode: str | None = None,
    interpolation_scheme: str = "linear",
) -> torch.Tensor:
    """A frequency response interpolated onto a new static frequency vector
    along the first axis (`helpers/spectrum_utilities.py:268`): the linear
    scheme by gathers and a lerp, quadratic and cubic by one static-operator
    product. Out of range the result is 0, except in a ``*2db`` mode, which
    takes the edge values."""
    f_interp = np.asarray(f_interp, dtype=np.float64)
    f_target = np.asarray(f_target, dtype=np.float64)
    y = torch.as_tensor(fr_interp)
    db_fill = False
    if mode is not None:
        mode = mode.lower()
        if mode == "power2amplitude":
            y = y**0.5
        elif mode == "amplitude2power":
            y = y**2.0
        elif mode[:3] == "db2":
            y = from_db(y, "amplitude" in mode)
        elif mode[-3:] == "2db":
            y = to_db(y, "amplitude" in mode)
            db_fill = True
        else:
            raise ValueError(f"Unsupported interpolation mode: {mode}")

    shape = (-1,) + (1,) * (y.ndim - 1)
    if interpolation_scheme == "linear":
        in_range = (f_target >= f_interp[0]) & (f_target <= f_interp[-1])
        interpolated = linear_interpolate(f_interp, y, f_target, axis=0)
        mask = torch.as_tensor(in_range, device=y.device).reshape(shape)
        interpolated = torch.where(mask, interpolated, 0.0)
    elif interpolation_scheme in ("quadratic", "cubic"):
        A = _spline_operator(tuple(f_interp.tolist()), tuple(f_target.tolist()),
                             interpolation_scheme)
        interpolated = apply_real_operator(A, y)
    else:
        raise ValueError(f"Unsupported interpolation scheme: {interpolation_scheme}")

    if db_fill:
        below = torch.as_tensor(f_target < f_interp[0], device=y.device).reshape(shape)
        above = torch.as_tensor(f_target > f_interp[-1], device=y.device).reshape(shape)
        interpolated = torch.where(below, y[0], interpolated)
        interpolated = torch.where(above, y[-1], interpolated)

    if mode is not None:
        if mode == "power2amplitude":
            interpolated = interpolated**2.0
        elif mode == "amplitude2power":
            interpolated = interpolated**0.5
        elif mode[:3] == "db2":
            interpolated = to_db(interpolated, "amplitude" in mode)
        elif mode[-3:] == "2db":
            interpolated = from_db(interpolated, "amplitude" in mode)
    return interpolated


def warp_frequency_vector(
    freqs_hz: np.ndarray, sampling_rate_hz: int, warping_factor: float
) -> np.ndarray:
    """The warped frequency vector (Ramos et al.; host float64,
    `helpers/spectrum_utilities.py:312`)."""
    assert np.abs(warping_factor) < 1.0, "Warping factor must be between ]-1;1["
    omega = 2 * np.pi * np.asarray(freqs_hz) / sampling_rate_hz
    return freqs_hz + sampling_rate_hz / np.pi * np.arctan(
        -warping_factor * np.sin(omega) / (1 + warping_factor * np.cos(omega))
    )

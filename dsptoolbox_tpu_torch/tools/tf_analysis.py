"""The transfer-function analysis path, built through the public API: what
follows a room or loudspeaker measurement, at full width.

- **(a) A dual-channel noise measurement** (what an FFT analyzer runs):
  10 s of pink ``generators.noise`` at 48 kHz from a seed, recorded through
  the 16 room IRs of `tools.measurement` (``room_irs``, convolved in
  float64), (480,000 × 16); `estimators` gives
  ``compute_transfer_function(rec, noise, 8192, mode)`` for H1, H2 and H3
  with their coherence: 4,097 bins from 118 Welch frames a channel (the
  last ones zero-padded, as the framing pads), the
  noise's spectrum parameters with the power spectral density scaling.
  Each call frames the noise once and the recording once (the framing
  kernel B1, two launches).
- **(b) IR analysis** (`ir_calls`) on the measurement path's IRs
  (`tools.measurement.run`): the deconvolved (288,000 × 16) IR, its
  (65,536 × 16) window, the 1/3-octave smoothed spectrum and the trimmed
  IR: trimming, latency, averaging, minimum phase, group delays, windows,
  frequency-dependent windowing, minimum and linear phase from the smoothed
  magnitude, IR ↔ FIR filters, the crossover merge with a dirac, a
  spectral difference and a smoothed spectrum.
- **(c) Harmonic distortion** (Farina's method on a loudspeaker): the
  measurement's SyncLog sweep through the memoryless polynomial
  x + 0.05·x² + 0.02·x³ and channel 0's room IR (`distorted_recording`),
  deconvolved, its harmonic IRs and `harmonic_distortion_analysis`
  (`harmonic_analysis`).

The signals go to `_config.default_device()`. Used by ``chip_smoke.py``
(`tf_analysis_phase`) and `tools.profile_chain` (``--case tfa``).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve

from .. import standard
from ..classes import Signal
from ..generators import ChirpType, NoiseType, chirp, noise
from ..standard.enums import SpectrumScaling
from ..transfer_functions import (
    TransferFunctionType,
    average_irs,
    combine_ir_with_dirac,
    compute_transfer_function,
    excess_group_delay,
    filter_to_ir,
    find_ir_latency,
    group_delay,
    harmonic_distortion_analysis,
    harmonics_from_chirp_ir,
    ir_to_filter,
    lin_phase_from_mag,
    min_phase_from_mag,
    min_phase_ir,
    minimum_group_delay,
    minimum_phase,
    spectral_deconvolve,
    trim_ir,
    window_centered_ir,
    window_frequency_dependent,
    window_ir_tukey,
)
from . import measurement

FS = measurement.FS
NOISE_S = 10.0
WELCH_LENGTH = 8192
MODES = (TransferFunctionType.H1, TransferFunctionType.H2, TransferFunctionType.H3)
FDW_CYCLES = 8
TUKEY_FLANKS_S = (0.005, 0.1)
CENTERED_LENGTH = 65536
PADDING_FACTOR = 8
SMOOTHING = 3
CROSSOVER_HZ = 200.0
DIRAC_NORMALIZATIONS = (None, "energy", "peak", -6.0)
POLYNOMIAL = (1.0, 0.05, 0.02)  # x, x², x³
N_HARMONICS = 5


def noise_measurement(seed: int = 0, seconds: float | None = None,
                      channels: int | None = None) -> tuple[Signal, Signal]:
    """``(recording (T, channels), noise (T, 1))``: pink noise from
    ``seed`` (`NOISE_S` long by default) through the first ``channels``
    (default all) room IRs of `measurement.room_irs`, convolved in float64;
    the noise carries the power spectral density scaling, so the estimates
    are the textbook H1, H2 and H3."""
    excitation = noise(NOISE_S if seconds is None else seconds, FS, NoiseType.Pink, seed=seed)
    excitation.set_spectrum_parameters(scaling=SpectrumScaling.PowerSpectralDensity)
    irs, _ = measurement.room_irs(seed)
    return measurement.recording(excitation, irs[:, :channels]), excitation


def estimators(rec: Signal, excitation: Signal, window_length: int = WELCH_LENGTH) -> dict:
    """``{"H1": Spectrum, "H2": …, "H3": …}``, each with its coherence."""
    return {m.name: compute_transfer_function(rec, excitation, window_length, m)
            for m in MODES}


def ir_calls(ir, windowed, smoothed, trimmed, cycles: int = FDW_CYCLES,
             tukey_s: tuple = TUKEY_FLANKS_S, centered: int = CENTERED_LENGTH) -> dict:
    """(b)'s steps as ``{name: callable}``: ``ir`` the deconvolved IRs,
    ``windowed`` their windows, ``smoothed`` the smoothed Spectrum,
    ``trimmed`` the trimmed IRs (`trim_ir`)."""
    smooth = windowed.copy()  # its FFT spectrum 1/SMOOTHING-octave smoothed
    smooth.spectrum_smoothing = SMOOTHING
    calls = {
        "trim_ir": lambda: trim_ir(ir),
        "find_ir_latency": lambda: find_ir_latency(windowed),
        "average_irs, time": lambda: average_irs(windowed, True),
        "average_irs, frequency": lambda: average_irs(windowed, False),
        "min_phase_ir": lambda: min_phase_ir(windowed, padding_factor=PADDING_FACTOR),
        "minimum_phase": lambda: minimum_phase(windowed, padding_factor=PADDING_FACTOR),
    }
    for analytic in (True, False):
        for remove in (False, True):
            calls[f"group_delay, analytic {analytic}, latency removed {remove}"] = (
                lambda a=analytic, r=remove: group_delay(windowed, a, SMOOTHING, r))
    calls.update({
        "minimum_group_delay": lambda: minimum_group_delay(windowed, SMOOTHING),
        "excess_group_delay": lambda: excess_group_delay(windowed, SMOOTHING),
        "window_centered_ir": lambda: window_centered_ir(ir, centered),
        "window_ir_tukey": lambda: window_ir_tukey(windowed, *tukey_s),
        "window_frequency_dependent": lambda: window_frequency_dependent(trimmed, cycles),
        "min_phase_from_mag": lambda: min_phase_from_mag(smoothed, FS),
        "lin_phase_from_mag": lambda: lin_phase_from_mag(smoothed, FS),
    })
    for mode in ("direct", "min", "lin"):
        calls[f"ir_to_filter {mode} -> filter_to_ir"] = (
            lambda m=mode: filter_to_ir(ir_to_filter(windowed, None, m)))
    for norm in DIRAC_NORMALIZATIONS:
        calls[f"combine_ir_with_dirac, {norm}"] = (
            lambda n=norm: combine_ir_with_dirac(windowed, CROSSOVER_HZ, True, normalization=n))
    calls["spectral_difference"] = lambda: standard.spectral_difference(
        windowed.get_channels(0), windowed.get_channels(1), SMOOTHING)
    calls["get_spectrum, smoothing"] = lambda: smooth.get_spectrum(return_device=True)
    return calls


def distorted_recording(seed: int = 0) -> tuple[Signal, Signal, float]:
    """``(recording (T, 1), sweep, sweep length s)``: the measurement's
    SyncLog sweep through `POLYNOMIAL` and channel 0 of
    `measurement.room_irs`, in float64; the length is the synchronized
    sweep's own (`generators.sync_log_chirp`), which places the harmonics."""
    sweep, length_s = chirp(FS, ChirpType.SyncLog, list(measurement.SWEEP_RANGE_HZ),
                            measurement.SWEEP_S, padding_end_seconds=measurement.PAD_S)
    irs, _ = measurement.room_irs(seed)
    x = sweep.time_data[:, 0].double().cpu().numpy()
    y = sum(c * x ** (k + 1) for k, c in enumerate(POLYNOMIAL))
    rec = fftconvolve(y, irs[:, 0])[: len(x)]
    return Signal(None, rec[:, None].astype(np.float32), FS), sweep, length_s


def harmonic_analysis(rec: Signal, sweep: Signal, length_s: float):
    """``(ir, harmonic IRs, analysis)``: the deconvolved IR, its
    `N_HARMONICS` harmonic IRs and `harmonic_distortion_analysis` of it."""
    ir = spectral_deconvolve(rec, sweep)
    harmonics = harmonics_from_chirp_ir(ir, list(measurement.SWEEP_RANGE_HZ), length_s,
                                        N_HARMONICS)
    analysis = harmonic_distortion_analysis(ir, list(measurement.SWEEP_RANGE_HZ), length_s,
                                            N_HARMONICS, generate_plot=False)
    return ir, harmonics, analysis

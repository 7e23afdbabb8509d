"""Audio effects: spectral subtraction, distortion, compressor, tremolo,
chorus, digital delay (`dsptoolbox_tpu/effects/effects.py`).

Each effect works on the signal's rows ``(C, T)`` on its device; levels
saved and restored by an effect (peaks, RMS) stay there as tensors.

- Spectral subtraction: the padded signal's windowed frames come from
  `ops.spectral._windowed_frames` (kernel B1 on a float32 CUDA tensor).
  The adaptive noise track, ``noise[k] = below[k] ? ff·noise[k−1] +
  (1 − ff)·mag[k] : noise[k−1]``, is a first-order affine recursion over
  frames with coefficients known beforehand, evaluated by doubling over the
  frames (the JAX package's associative scan); no host sync. The offline
  mode runs the activity detector and a Welch noise PSD (B1) per channel.
- Compressor: `_backend.compressor_gain` (`csrc/ema.cu`'s average form).
- Chorus: one gather over the ``(T, voices)`` index tensor.
- Digital delay: the feedback comb ``y_k = x_k + fb·sat(y_{k−1})`` over
  delay-sized blocks, a loop over the blocks on the device.
"""

from __future__ import annotations

import math
from warnings import warn

import numpy as np
import torch
import torch.nn.functional as F

from .._enums import SpectrumMethod, SpectrumScaling, Window
from ..classes import MultiBandSignal, Signal
from ..helpers.gain_and_level import to_db
from ..helpers.other import next_power_2
from ..ops.framing import frame_signal, reconstruct_framed_signal
from ..ops.spectral import _windowed_frames
from ..ops.windows import get_window as get_window_np
from ._backend import (
    LFO,
    arctan_distortion,
    clean_signal,
    compressor_gain,
    get_knee_func,
    hard_clip_distortion,
    soft_clip_distortion,
)
from .enums import DistortionType


class AudioEffect:
    """Base class for audio effects (`effects.py:35-135`). The level
    helpers take the rows ``(C, T)`` of a signal."""

    def __init__(self, description: str | None = None):
        self.description = description

    def apply(self, signal):
        if isinstance(signal, Signal):
            return self._apply_this_effect(signal)
        if isinstance(signal, MultiBandSignal):
            new_mbs = signal.copy()
            new_mbs.bands = [self.apply(b) for b in new_mbs.bands]
            return new_mbs
        raise TypeError(
            "Audio effect can only be applied to Signal or MultiBandSignal"
        )

    def _apply_this_effect(self, signal: Signal) -> Signal:
        return signal

    def _add_gain_in_db(self, rows, gain_db):
        if gain_db is None:
            return rows
        return rows * 10 ** (gain_db / 20)

    def _save_peak_values(self, rows):
        self._peak_values = rows.abs().amax(dim=-1)

    def _restore_peak_values(self, rows):
        if not hasattr(self, "_peak_values"):
            return rows
        if self._peak_values.shape[0] != rows.shape[0]:
            warn(
                "Number of saved peak values does not match number of "
                "channels. Restoring is ignored"
            )
            return rows
        return rows * (self._peak_values / rows.abs().amax(dim=-1))[:, None]

    def _save_rms_values(self, rows):
        self._rms_values = rows.std(dim=-1, correction=0)

    def _restore_rms_values(self, rows):
        if not hasattr(self, "_rms_values"):
            return rows
        if self._rms_values.shape[0] != rows.shape[0]:
            warn(
                "Number of saved RMS values does not match number of "
                "channels. Restoring is ignored"
            )
            return rows
        return rows * (self._rms_values / rows.std(dim=-1, correction=0))[:, None]


class SpectralSubtractor(AudioEffect):
    """STFT-domain spectral subtraction denoiser
    (`effects.py:138-551`)."""

    def __init__(
        self,
        adaptive_mode: bool = True,
        threshold_rms_dbfs: float = -40,
        block_length_s: float = 0.1,
        spectrum_to_subtract=False,
    ):
        super().__init__(description="Spectral Subtraction (Denoiser)")
        self.__set_parameters(
            adaptive_mode,
            threshold_rms_dbfs,
            block_length_s,
            spectrum_to_subtract,
        )
        self.set_advanced_parameters()

    def __set_parameters(
        self,
        adaptive_mode,
        threshold_rms_dbfs,
        block_length_s,
        spectrum_to_subtract,
    ):
        if adaptive_mode is not None:
            assert isinstance(adaptive_mode, bool), (
                "Adaptive mode must be of boolean type"
            )
            self.adaptive_mode = adaptive_mode
        if threshold_rms_dbfs is not None:
            assert isinstance(threshold_rms_dbfs, (int, float)), (
                "Threshold must be of type int or float"
            )
            if threshold_rms_dbfs >= 0:
                warn("Threshold is positive. This might be a wrong input")
            self.threshold_rms_dbfs = threshold_rms_dbfs
        if block_length_s is not None:
            assert isinstance(block_length_s, (int, float)), (
                "Block length should be of type int or float"
            )
            self.block_length_s = block_length_s
        if spectrum_to_subtract is not None:
            if np.any(spectrum_to_subtract):
                spectrum_to_subtract = np.squeeze(
                    np.asarray(spectrum_to_subtract)
                )
                assert spectrum_to_subtract.ndim == 1, (
                    "Spectrum to subtract could not be broadcasted to a "
                    "1D-Array"
                )
                if self.adaptive_mode:
                    warn(
                        "A spectrum to subtract was passed but adaptive "
                        "mode was selected. This is unsupported. Setting "
                        "adaptive mode to False"
                    )
                    self.adaptive_mode = False
            self.spectrum_to_subtract = spectrum_to_subtract

    def set_advanced_parameters(
        self,
        overlap_percent: int = 50,
        window_type: Window = Window.Hann,
        noise_forgetting_factor: float = 0.9,
        subtraction_factor: float = 2,
        subtraction_exponent: float = 2,
        ad_attack_time_ms: float = 0.5,
        ad_release_time_ms: float = 30,
    ):
        assert 0 <= overlap_percent < 100, "Overlap should be in [0, 100["
        self.overlap = overlap_percent / 100
        self.window_type = window_type
        assert 0 < noise_forgetting_factor <= 1, (
            "Noise forgetting factor must be in ]0, 1]"
        )
        self.noise_forgetting_factor = noise_forgetting_factor
        assert subtraction_factor > 0, (
            "The subtraction factor must be positive"
        )
        self.subtraction_factor = subtraction_factor
        assert subtraction_exponent > 0, (
            "Subtraction exponent should be above zero"
        )
        self.subtraction_exponent = subtraction_exponent
        assert ad_attack_time_ms >= 0, (
            "Attack time for activity detector must be 0 or above"
        )
        self.ad_attack_time_ms = ad_attack_time_ms
        assert ad_release_time_ms >= 0, (
            "Release time for activity detector must be 0 or above"
        )
        self.ad_release_time_ms = ad_release_time_ms

    def set_parameters(
        self,
        adaptive_mode: bool | None = None,
        threshold_rms_dbfs: float | None = None,
        block_length_s: float | None = None,
        spectrum_to_subtract=False,
    ):
        self.__set_parameters(
            adaptive_mode,
            threshold_rms_dbfs,
            block_length_s,
            spectrum_to_subtract,
        )

    def _compute_window(self, sampling_rate_hz):
        if not np.any(self.spectrum_to_subtract):
            self.window_length = next_power_2(
                self.block_length_s * sampling_rate_hz
            )
        else:
            self.window_length = (len(self.spectrum_to_subtract) - 1) * 2
        self.window = np.clip(
            get_window_np(self.window_type, self.window_length, False),
            a_min=1e-6,
            a_max=None,
        )
        self.step_size = int(self.window_length * (1 - self.overlap))

    def _apply_this_effect(self, signal: Signal) -> Signal:
        if self.adaptive_mode:
            return self._apply_adaptive_mode(signal)
        self._save_peak_values(signal._x)
        out = self._apply_offline(signal)
        out.time_data = self._restore_peak_values(out._x).T
        return out

    def _padded(self, signal: Signal) -> torch.Tensor:
        """The rows padded by a window at both ends."""
        L = len(self.window)
        return F.pad(signal._x, (L, L))

    def _subtract(self, spec, noise_power):
        """The frames' spectra ``spec`` with ``subtraction_factor ·
        noise_power`` subtracted from their power (floored at 0), back to
        frames with the original phase."""
        e = self.subtraction_exponent
        sub = torch.clamp(spec.abs() ** e - self.subtraction_factor * noise_power, min=0)
        return torch.fft.irfft(torch.polar(sub ** (1 / e), spec.angle()), n=len(self.window),
                               dim=-1)

    def _reconstruct(self, frames, original_length, safety_threshold):
        """The overlap-added frames without the padding windows: rows
        ``(C, T)``."""
        L = len(self.window)
        return reconstruct_framed_signal(frames, self.step_size, self.window, original_length,
                                         safety_threshold=safety_threshold)[..., L:-L]

    def _apply_offline(self, signal: Signal) -> Signal:
        from ..standard.other import activity_detector

        self._compute_window(signal.sampling_rate_hz)
        L = len(self.window)
        xp = self._padded(signal)
        frames_w = _windowed_frames(xp, self.window, self.step_size, False)
        e = self.subtraction_exponent

        noise_psds = []
        for n in range(signal.number_of_channels):
            if not np.any(self.spectrum_to_subtract):
                _, noise = activity_detector(
                    signal,
                    channel=n,
                    threshold_dbfs=self.threshold_rms_dbfs,
                    attack_time_ms=self.ad_attack_time_ms,
                    release_time_ms=self.ad_release_time_ms,
                )
                noise["noise"].set_spectrum_parameters(
                    method=SpectrumMethod.WelchPeriodogram,
                    window_length_samples=L,
                    overlap_percent=self.overlap * 100,
                    window_type=self.window_type,
                    scaling=SpectrumScaling.FFTBackward,
                )
                _, noise_psd = noise["noise"].get_spectrum(return_device=True)
                noise_psd = noise_psd.abs().reshape(-1) ** (e / 2)
            else:
                noise_psd = torch.as_tensor(
                    np.abs(self.spectrum_to_subtract.copy()) ** (e / 2),
                    dtype=frames_w.dtype, device=frames_w.device)
            noise_psds.append(noise_psd)
        noise_power = torch.stack(noise_psds, 0)[:, None, :]  # (C, 1, F)
        new_frames = self._subtract(torch.fft.rfft(frames_w, dim=-1), noise_power)
        # parity: the reference's offline mode reconstructs with
        # safety_threshold=None — no window-envelope clipping
        # (`effects.py:482-484`)
        rec = self._reconstruct(new_frames, xp.shape[-1], safety_threshold=None)
        return signal.copy_with_new_time_data(rec.T)

    def _adaptive_noise_below(self, xp: torch.Tensor) -> torch.Tensor:
        """Frames ``(C, K)`` whose power is below the threshold: the
        variance of the unwindowed frames in dB (`effects.py:392`)."""
        frames = frame_signal(xp, len(self.window), self.step_size, True)
        var = (frames - frames.mean(dim=-1, keepdim=True)).square().mean(dim=-1)
        return to_db(var, False) < self.threshold_rms_dbfs

    def _apply_adaptive_mode(self, signal: Signal) -> Signal:
        """Adaptive spectral subtraction (`effects.py:354-437`): frame,
        rfft, the adaptive noise track by doubling over the frames,
        subtraction, irfft, overlap-add, peak restore."""
        self._compute_window(signal.sampling_rate_hz)
        ff = float(self.noise_forgetting_factor)
        peak0 = signal._x.abs().amax(dim=-1)
        xp = self._padded(signal)
        below = self._adaptive_noise_below(xp)
        spec = torch.fft.rfft(_windowed_frames(xp, self.window, self.step_size, False), dim=-1)
        mag = spec.abs()  # (C, K, F)
        below_f = below[:, :, None].to(mag.dtype)
        a = 1.0 - below_f * (1.0 - ff)  # (C, K, 1)
        b = below_f * (1.0 - ff) * mag  # (C, K, F)
        del mag
        shift, K = 1, b.shape[1]
        while shift < K:
            # compose each frame's map with the one `shift` frames before:
            # (a, b)[k] <- (a[k]·a[k−s], a[k]·b[k−s] + b[k])
            b = torch.cat([b[:, :shift], b[:, shift:] + a[:, shift:] * b[:, :-shift]], dim=1)
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
            shift *= 2
        new_frames = self._subtract(spec, b**self.subtraction_exponent)
        del spec, b
        rec = self._reconstruct(new_frames, xp.shape[-1], safety_threshold=1e-4)
        self._peak_values = peak0
        rec = rec * (peak0 / rec.abs().amax(dim=-1))[:, None]
        return signal.copy_with_new_time_data(rec.T)


class Distortion(AudioEffect):
    """Waveshaping distortion, mixable stages
    (`effects.py:553-751`)."""

    def __init__(
        self,
        distortion_level: float = 20,
        post_gain_db: float = 0,
        type_of_distortion: DistortionType = DistortionType.Arctan,
    ):
        super().__init__("Distortion")
        self.set_advanced_parameters(
            type_of_distortion=type_of_distortion,
            distortion_levels_db=distortion_level,
            post_gain_db=post_gain_db,
        )

    def set_advanced_parameters(
        self,
        type_of_distortion=DistortionType.Arctan,
        distortion_levels_db=20,
        mix_percent=100,
        offset_db=-np.inf,
        post_gain_db: float = 0,
    ):
        mix_percent = np.atleast_1d(mix_percent)
        assert np.all(mix_percent <= 100), (
            "No value of mix_percent can be greater than 100"
        )
        self.__select_distortions(type_of_distortion)
        n = len(self._distortion_funcs)
        self.mix = mix_percent / 100
        self.distortion_levels = np.atleast_1d(distortion_levels_db)
        self.offset_db = np.atleast_1d(offset_db)
        if n == 1:
            self._distortion_funcs.append(clean_signal)
            self.mix = np.append(self.mix, 1 - self.mix[0])
            self.distortion_levels = np.append(self.distortion_levels, 0)
            self.offset_db = np.append(self.offset_db, -np.inf)
            n += 1
        assert n == len(self.mix), (
            "Length of mix_percent does not match distortions"
        )
        assert np.isclose(np.sum(self.mix), 1), (
            "mix_percent does not sum up to 100"
        )
        assert n == len(self.distortion_levels), (
            "Length of distortion_levels does not match distortions"
        )
        assert n == len(self.offset_db), (
            "Length of offset_db does not match distortions"
        )
        self.post_gain_db = post_gain_db

    def __select_distortions(self, type_of_distortion):
        if not isinstance(type_of_distortion, list):
            type_of_distortion = [type_of_distortion]
        mapping = {
            DistortionType.Arctan: arctan_distortion,
            DistortionType.HardClip: hard_clip_distortion,
            DistortionType.SoftClip: soft_clip_distortion,
            DistortionType.NoDistortion: clean_signal,
        }
        self._distortion_funcs = []
        for dist in type_of_distortion:
            if dist not in mapping:
                raise ValueError(
                    "The type of distortion is not implemented."
                )
            self._distortion_funcs.append(mapping[dist])

    def _apply_this_effect(self, signal: Signal) -> Signal:
        x = signal._x
        post_gain_db = 0.0 if self.post_gain_db is None else float(self.post_gain_db)
        peak_in = x.abs().amax(dim=-1, keepdim=True)
        new = torch.zeros_like(x)
        for f, mix, level, offset in zip(self._distortion_funcs, self.mix,
                                         self.distortion_levels, self.offset_db):
            if mix == 0.0:
                continue
            part = f(x, float(level), float(offset)) * float(mix)
            new = new + part * (peak_in / part.abs().amax(dim=-1, keepdim=True))
        self._peak_values = peak_in[:, 0]
        return signal.copy_with_new_time_data((new * 10 ** (post_gain_db / 20)).T)


class Compressor(AudioEffect):
    """Dynamic range compressor / expander
    (`effects.py:753-1014`)."""

    def __init__(
        self,
        threshold_dbfs: float = -10,
        attack_time_ms: float = 0.5,
        release_time_ms: float = 20,
        ratio: float = 3,
        relative_to_peak_level: bool = True,
    ):
        super().__init__("Compressor")
        self.__set_parameters(
            threshold_dbfs,
            attack_time_ms,
            release_time_ms,
            ratio,
            relative_to_peak_level,
        )
        self.set_advanced_parameters()

    def __set_parameters(
        self,
        threshold_dbfs,
        attack_time_ms,
        release_time_ms,
        ratio,
        relative_to_peak_level,
    ):
        if threshold_dbfs is not None:
            if threshold_dbfs > 0:
                warn(
                    "Threshold is above 0 dBFS, this might lead to "
                    "unexpected results"
                )
            self.threshold_dbfs = threshold_dbfs
        if attack_time_ms is not None:
            assert attack_time_ms >= 0, "Attack time has to be 0 or above"
            self.attack_time_ms = attack_time_ms
        if release_time_ms is not None:
            assert release_time_ms >= 0, "Release time has to be 0 or above"
            self.release_time_ms = release_time_ms
        if ratio is not None:
            assert ratio >= 1, "Compression ratio must be above 1"
            self.ratio = ratio
        if relative_to_peak_level is not None:
            self.relative_to_peak_level = relative_to_peak_level

    def set_parameters(
        self,
        threshold_dbfs=None,
        attack_time_ms=None,
        release_time_ms=None,
        ratio=None,
        relative_to_peak_level=None,
    ):
        self.__set_parameters(
            threshold_dbfs,
            attack_time_ms,
            release_time_ms,
            ratio,
            relative_to_peak_level,
        )

    def set_advanced_parameters(
        self,
        knee_factor_db: float = 0,
        pre_gain_db: float = 0,
        post_gain_db: float = 0,
        mix_percent: float = 100,
        automatic_make_up_gain: bool = True,
        downward_compression: bool = True,
    ):
        assert knee_factor_db >= 0, "Knee factor must be 0 or above"
        self.knee_factor_db = knee_factor_db
        assert 0 < mix_percent <= 100, "Mix percent must be in ]0, 100]"
        self.mix = mix_percent / 100
        self.pre_gain_db = pre_gain_db
        self.post_gain_db = post_gain_db
        self.automatic_make_up_gain = automatic_make_up_gain
        self.downward_compression = downward_compression

    def show_compression(self):
        from ..plots import general_plot

        gains_db = np.linspace(self.threshold_dbfs - 20, 0, 2_000)
        func = get_knee_func(
            self.threshold_dbfs,
            self.ratio,
            self.knee_factor_db,
            self.downward_compression,
        )
        gains_db_after = np.asarray(func(gains_db))
        gains_mixed = 10 ** (gains_db_after / 20) * self.mix + 10 ** (
            gains_db / 20
        ) * (1 - self.mix)
        gains_mixed = 20 * np.log10(gains_mixed)
        fig, ax = general_plot(
            gains_db,
            gains_db,
            log_x=False,
            xlabel="Input Gain / dB",
            ylabel="Output Gain / dB",
        )
        ax.plot(gains_db, gains_mixed)
        ax.axvline(
            self.threshold_dbfs,
            alpha=0.5,
            color="xkcd:greenish",
            linestyle="dashed",
        )
        ax.axhline(
            self.threshold_dbfs,
            alpha=0.5,
            color="xkcd:greenish",
            linestyle="dashed",
        )
        ax.legend(["Input", "Output", "Threshold"])
        fig.tight_layout()
        return fig, ax

    def _apply_this_effect(self, signal: Signal) -> Signal:
        fs_hz = signal.sampling_rate_hz
        td = self._add_gain_in_db(signal._x, self.pre_gain_db)
        self._save_rms_values(td)
        self._save_peak_values(td)
        if self.relative_to_peak_level:
            td = td / self._peak_values[:, None]
        attack_samples = int(self.attack_time_ms * 1e-3 * fs_hz)
        release_samples = int(self.release_time_ms * 1e-3 * fs_hz)
        # `compressor_core`'s gain on the rows; the gain request and its smoothed
        # gain stay on the effect (`_last_gain_request`, `_last_gain`)
        self._last_gain_request, self._last_gain = compressor_gain(
            td,
            self.threshold_dbfs,
            self.ratio,
            self.knee_factor_db,
            attack_samples,
            release_samples,
            self.downward_compression,
        )
        td = td * self._last_gain
        # parity: the reference accepts `mix_compressed` (`self.mix`) but
        # never applies it (`_effects.py:119-148` ignores the argument), and
        # its "post-compression gain" re-applies `pre_gain_db`
        # (`effects.py:1011-1012`)
        if self.relative_to_peak_level:
            td = td * self._peak_values[:, None]
        if self.automatic_make_up_gain:
            td = self._restore_rms_values(td)
        td = self._add_gain_in_db(td, self.pre_gain_db)
        return signal.copy_with_new_time_data(td.T)


def _pad_trim_host(values: np.ndarray, length: int) -> np.ndarray:
    """``values`` zero-padded or trimmed along axis 0 to ``length``, in
    float32 (the JAX package pads a float32 device copy)."""
    values = np.asarray(values, np.float32)
    if values.shape[0] >= length:
        return values[:length]
    return np.concatenate([values, np.zeros((length - values.shape[0],) + values.shape[1:],
                                            np.float32)])


class Tremolo(AudioEffect):
    """LFO amplitude modulation (`effects.py:1016-1103`)."""

    def __init__(self, depth: float = 0.5, modulator=None):
        super().__init__("Modulation effect: Tremolo")
        if modulator is None:
            modulator = LFO(1, "harmonic")
        self.__set_parameters(depth, modulator)

    def __set_parameters(self, depth, modulator):
        if modulator is not None:
            assert isinstance(modulator, (LFO, np.ndarray)), (
                "Unsupported modulator type. Use LFO or numpy.ndarray"
            )
            if isinstance(modulator, np.ndarray):
                modulator = modulator.squeeze()
                assert modulator.ndim == 1, (
                    "Modulator signal can have only one channel"
                )
            self.modulator = modulator
        if depth is not None:
            if isinstance(self.modulator, LFO):
                assert 0 < depth <= 1, "Depth must be in ]0, 1]"
            self.depth = depth

    def set_parameters(self, depth=None, modulator=None):
        self.__set_parameters(depth, modulator)

    def _apply_this_effect(self, signal: Signal) -> Signal:
        if isinstance(self.modulator, LFO):
            modulation = self.modulator.get_waveform(
                signal.sampling_rate_hz, len(signal)
            )
        else:
            modulation = _pad_trim_host(self.modulator, len(signal))
        modulation = np.abs(modulation * self.depth + 1)
        x = signal._x
        return signal.copy_with_new_time_data(
            (x * torch.as_tensor(modulation, dtype=x.dtype, device=x.device)).T
        )


class Chorus(AudioEffect):
    """Multi-voice modulated delay (`effects.py:1105-1323`). The per-sample
    voice loop is one gather over a ``(T, V)`` delay-index tensor."""

    def __init__(
        self,
        depths_ms=5,
        base_delays_ms=15,
        modulators=None,
        mix_percent: float = 100,
    ):
        super().__init__("Modulation effect: Chorus/Flanger")
        if modulators is None:
            modulators = LFO(2, "harmonic", random_phase=True)
        self.__set_parameters(
            depths_ms, base_delays_ms, modulators, mix_percent
        )

    def __set_parameters(
        self, depths_ms, base_delays_ms, modulators, mix_percent
    ):
        nv_base = nv_depths = nv_mod = 0
        if base_delays_ms is not None:
            base_delays_ms = np.atleast_1d(base_delays_ms)
            nv_base = len(base_delays_ms)
        else:
            nv_base = len(self.base_delays_ms)
        if depths_ms is not None:
            depths_ms = np.atleast_1d(depths_ms)
            nv_depths = len(depths_ms)
        else:
            nv_depths = len(self.depths_ms)
        if modulators is not None:
            if isinstance(modulators, (list, tuple)):
                nv_mod = len(modulators)
            elif isinstance(modulators, np.ndarray):
                # docstring contract: (time samples, voice) — a 1D array
                # is ONE voice's modulation, not T voices
                if modulators.ndim == 1:
                    modulators = modulators[:, None]
                nv_mod = modulators.shape[1]
            else:
                nv_mod = 1
        else:
            nv_mod = (
                self.modulators.shape[1]
                if isinstance(self.modulators, np.ndarray)
                else len(self.modulators)
            )
        self.number_of_voices = max(nv_base, nv_depths, nv_mod)

        if base_delays_ms is not None:
            assert np.all(base_delays_ms > 0), "Base delays must be above 0"
            assert len(base_delays_ms) in (1, self.number_of_voices), (
                "Base delays can only be length 1 or number of voices"
            )
            self.base_delays_ms = base_delays_ms
            if len(self.base_delays_ms) == 1:
                self.base_delays_ms = np.repeat(
                    self.base_delays_ms, self.number_of_voices
                )
        if modulators is not None:
            assert isinstance(modulators, (LFO, list, tuple, np.ndarray)), (
                "Unsupported modulators type. Use LFO or numpy.ndarray"
            )
            if isinstance(modulators, np.ndarray):
                self.modulators = modulators
            elif isinstance(modulators, LFO):
                self.modulators = [modulators] * self.number_of_voices
            else:
                assert len(modulators) in (1, self.number_of_voices), (
                    "The number of modulators signals does not match the "
                    f"number of voices {self.number_of_voices}"
                )
                assert all(isinstance(i, LFO) for i in modulators), (
                    "All modulators signals have to be of type LFO"
                )
                self.modulators = list(modulators)
                if len(self.modulators) == 1:
                    self.modulators = (
                        [self.modulators[0]] * self.number_of_voices
                    )
        if depths_ms is not None:
            self.depths_ms = np.atleast_1d(depths_ms)
            assert len(self.depths_ms) in (1, self.number_of_voices), (
                "Depth must be of length 1 or number of voices "
                f"{self.number_of_voices}"
            )
            if len(self.depths_ms) == 1:
                self.depths_ms = np.repeat(
                    self.depths_ms, self.number_of_voices
                )
        if mix_percent is not None:
            mix_percent /= 100
            assert 0 < mix_percent <= 1, (
                "Mix percent must be below 100 and above 0"
            )
            self.mix = mix_percent

    def set_parameters(
        self,
        depths_ms=None,
        base_delays_ms=None,
        modulators=None,
        mix_percent=None,
    ):
        self.__set_parameters(
            depths_ms, base_delays_ms, modulators, mix_percent
        )

    def _apply_this_effect(self, signal: Signal) -> Signal:
        fs = signal.sampling_rate_hz
        le = len(signal)
        if not isinstance(self.modulators, np.ndarray):
            modulation = np.zeros((le, self.number_of_voices))
            for ind, m in enumerate(self.modulators):
                modulation[:, ind] = (
                    m.get_waveform(fs, le) * self.depths_ms[ind]
                    + self.base_delays_ms[ind]
                )
        else:
            modulation = _pad_trim_host(self.modulators, le)
        modulation = np.round(modulation * 1e-3 * fs).astype(int)
        max_delay = int(np.abs(modulation).max())

        td = F.pad(signal._x, (0, max_delay))  # (C, T + max_delay)
        self._save_peak_values(td)
        idx = torch.as_tensor(np.arange(le)[:, None] + modulation[:le], device=td.device)
        new_head = td[:, :le] + td[:, idx].sum(dim=-1)  # gather (C, T, V)
        new_td = F.pad(new_head, (0, max_delay))
        new_td = new_td * self.mix + td * (1 - self.mix)
        return signal.copy_with_new_time_data(self._restore_peak_values(new_td[:, :le]).T)


def _sat_digital(x):
    return x


def _sat_arctan(x):
    return 0.5 * torch.atan(2 * x)


class DigitalDelay(AudioEffect):
    """Feedback delay line (`effects.py:1326-1473`): the comb recursion
    runs over delay-sized blocks, a loop over the blocks on the device.
    The saturation is a callable on tensors."""

    def __init__(self, delay_time_ms: float = 300, feedback: float = 0.1):
        super().__init__("Digital Delay")
        self.__set_parameters(delay_time_ms, feedback)
        self.set_advanced_parameters()

    def __set_parameters(self, delay_time_ms, feedback):
        assert delay_time_ms > 0, "Delay time must be larger than 0"
        self.delay_ms = delay_time_ms
        assert feedback > 0, "Feedback must be larger than one"
        self.feedback = feedback

    def set_parameters(self, delay_time_ms=None, feedback=None):
        if delay_time_ms is None:
            delay_time_ms = self.delay_ms
        if feedback is None:
            feedback = self.feedback
        self.__set_parameters(delay_time_ms, feedback)

    def set_advanced_parameters(self, saturation: str | None = None):
        if saturation is None:
            saturation = "digital"
        if callable(saturation):
            self.saturation_func = saturation
            return
        saturation = saturation.lower()
        if saturation == "digital":
            self.saturation_func = _sat_digital
        elif saturation == "arctan":
            self.saturation_func = _sat_arctan
        else:
            raise ValueError("Saturation function might not be valid")

    def plot_delay(self):
        from ..plots import general_plot

        fs = 2_000
        delay_samples = int(round(self.delay_ms * 1e-3 * fs))
        imp = np.zeros(delay_samples * 10)
        imp[0] = 1
        for i in np.arange(delay_samples, len(imp)):
            imp[i] = imp[i] + self.feedback * float(self.saturation_func(
                torch.tensor(imp[i - delay_samples], dtype=torch.float64)))
        imp = to_db(imp, True)
        x = np.arange(len(imp)) / fs * 1e3
        fig, ax = general_plot(
            x,
            imp[..., None],
            log_x=False,
            xlabel="Time / ms",
            ylabel="Amplitude [dB]",
        )
        ax.set_ylim([-100, 1])
        ax.set_title("Delay – Repetitions decay")
        fig.tight_layout()
        return fig, ax

    def _check_saturation(self, like: torch.Tensor):
        """One call of the saturation on a ``(2, 2)`` tensor: it must give
        a tensor of that shape (it is applied to whole delay blocks on the
        device)."""
        sat = self.saturation_func
        try:
            probe = sat(like.new_zeros((2, 2)))
            error = None if torch.is_tensor(probe) and probe.shape == (2, 2) else (
                f"it returned {type(probe).__name__} "
                f"{tuple(getattr(probe, 'shape', ()))} for a (2, 2) tensor")
        except Exception as e:  # noqa: BLE001 - any failure is reported as one
            error = str(e)
        if error is not None:
            raise ValueError(
                "The saturation function must be traceable over torch "
                "tensors (use torch operations — it is applied to whole "
                f"delay blocks on device): {error}"
            )

    def _apply_this_effect(self, signal: Signal) -> Signal:
        D = int(round(self.delay_ms * 1e-3 * signal.sampling_rate_hz))
        assert D >= 1, (
            f"delay_time_ms={self.delay_ms} rounds to zero samples at "
            f"{signal.sampling_rate_hz} Hz"
        )
        x = signal._x
        self._save_peak_values(x)
        self._check_saturation(x)
        padding = int(D * (1 + self.feedback * 15))
        total = x.shape[-1] + padding
        n_blocks = math.ceil(total / D)
        xb = F.pad(x, (0, n_blocks * D - x.shape[-1])).reshape(x.shape[0], n_blocks, D)
        fb, sat = self.feedback, self.saturation_func
        y = torch.empty_like(xb)
        prev = torch.zeros_like(xb[:, 0])
        for k in range(n_blocks):
            prev = xb[:, k] + fb * sat(prev)
            y[:, k] = prev
        y = y.reshape(x.shape[0], -1)[:, :total]
        return signal.copy_with_new_time_data(self._restore_peak_values(y).T)

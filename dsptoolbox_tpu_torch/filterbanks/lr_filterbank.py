"""Linkwitz-Riley crossover filter bank
(`dsptoolbox_tpu/filterbanks/lr_filterbank.py`).

The band-split cascade with allpass phase correction runs batched over
channels on the signal's device. On a float32 CUDA signal the zero-state
split is one parallel bank of the bands' composite SOS cascades (each
crossover's low + high pass summed into one all-pass cascade), one launch of
the filter-bank kernel B3. Elsewhere, zero-state splits whose decay margin
allows it go through the composite band responses (one rfft, one batched
irfft: exact frequency sampling, `ops.iir_freq`); the others through the
`sosfilt` chain (the blocked IIR, kernel B2). The per-channel ``zi`` path
keeps scipy's state conventions. The impulse responses and their plots
(magnitude, phase, group delay) are drawn from the bands on the host. Not
ported: saving and copies.
"""

from __future__ import annotations

from functools import cached_property
from warnings import warn

import numpy as np
import torch
from scipy.signal import butter, sosfilt_zi

from .. import _config
from .._config import retain
from ..classes.multibandsignal import MultiBandSignal
from ..classes.signal import Signal
from ..ops.fft_conv import next_fast_len
from ..ops.iir import sosfilt, sosfiltfilt
from ..ops.iir_block import bank_device_operators, sosfilt_bank_apply_planes, stack_sos_bank
from ..ops.iir_freq import decay_margin, sos_freq_response_host
from .._trace import spanned
from .._enums import FilterBankMode


def _get_2nd_order_linkwitz_riley(freq: float, fs: int):
    """Sallen-Key (Q = 0.5) 2nd-order LR crossover SOS pair; the high band
    is phase-inverted (`lr_filterbank.py:23`)."""
    w0 = 2 * np.pi * freq / fs
    K = np.tan(w0 / 2)
    q = 0.5
    denom = K**2 * q + K + q
    a = np.array([1.0, 2 * q * (K**2 - 1) / denom, (K**2 * q - K + q) / denom])
    b_lp = np.array([K**2 * q / denom, 2 * K**2 * q / denom, K**2 * q / denom])
    b_hp = np.array([q / denom, -2 * q / denom, q / denom])
    return np.hstack([b_lp, a])[None, :], np.hstack([-b_hp, a])[None, :]


def _allpass(lp: np.ndarray, order: int) -> np.ndarray | None:
    """LP + HP of one crossover as one all-pass cascade, or None for an odd
    (not Linkwitz-Riley) order.

    An LR crossover of order 4k is a Butterworth of order 2k, squared:
    ``LP + HP = B(−s) / B(s)``, so each section ``[1, a1, a2]`` of the
    Butterworth half (the first half of ``lp``'s rows) gives the all-pass
    section ``[a2, a1, 1] / [1, a1, a2]``. The Sallen-Key LR2 has ``a = (1 +
    p z⁻¹)²`` and ``LP + HP = (p + z⁻¹) / (1 + p z⁻¹)``."""
    if order == 2:
        p = lp[0, 4] / 2
        return np.array([[p, 1.0, 0.0, 1.0, p, 0.0]])
    if order % 4:
        return None
    a = lp[: len(lp) // 2, 3:]
    return np.hstack([a[:, ::-1], a])


class LRFilterBank:
    """Near-perfect-magnitude-reconstruction crossover bank."""

    def __init__(self, freqs, order=4, sampling_rate_hz: int = 48000, info: dict | None = None):
        freqs = np.atleast_1d(np.asarray(freqs).squeeze())
        order = np.atleast_1d(np.asarray(order).squeeze())
        if len(order) == 1:
            order = np.ones(len(freqs)) * order
        assert np.max(freqs) <= sampling_rate_hz // 2, (
            "Highest frequency is above nyquist frequency for the given sampling rate"
        )
        assert len(freqs) == len(order), (
            "Number of frequencies and number of order of the crossovers do not match"
        )
        for o in order:
            if o % 2 != 0 and o != 1:
                warn("Order of the crossovers is recommended to be even. Odd orders "
                     "have band crossing at -3 dB and are not really Linkwitz-Riley "
                     "crossovers, although they have perfect magnitude reconstruction.")
        idx = freqs.argsort()
        self.freqs = freqs[idx]
        self.order = order[idx]
        self.number_of_cross = len(freqs)
        self.number_of_bands = self.number_of_cross + 1
        self.sampling_rate_hz = sampling_rate_hz
        centers, val = [], 0
        for cr in self.freqs:
            centers.append((val + cr) / 2)
            val = cr
        centers.append((val + sampling_rate_hz // 2) / 2)
        self.center_frequencies = np.asarray(centers)
        self._create_filters_sos()
        self.info = {
            "crossover_frequencies": self.freqs,
            "crossover_orders": self.order,
            "number_of_crossovers": self.number_of_cross,
            "number_of_bands": self.number_of_bands,
            "sampling_rate_hz": self.sampling_rate_hz,
        } | ({} if info is None else info)
        self._responses: dict = {}

    def _create_filters_sos(self):
        self.sos = []
        for i in range(self.number_of_cross):
            if self.order[i] == 2:
                self.sos.append(list(_get_2nd_order_linkwitz_riley(
                    self.freqs[i], self.sampling_rate_hz)))
                continue
            if self.order[i] % 2 == 0:
                assert self.order[i] % 4 == 0, (
                    f"{self.order[i]} order is not supported for crossover"
                )
                order = int(self.order[i] // 2)
            else:
                order = int(self.order[i])
            lp = butter(order, self.freqs[i], btype="lowpass", fs=self.sampling_rate_hz,
                        output="sos")
            hp = butter(order, self.freqs[i], btype="highpass", fs=self.sampling_rate_hz,
                        output="sos")
            if self.order[i] % 2 == 0:
                lp, hp = np.vstack([lp, lp]), np.vstack([hp, hp])
            self.sos.append([lp, hp])

    # ======== streaming state ==============================================
    def initialize_zi(self, number_of_channels: int = 1):
        """Per-channel state trees in the reference layout
        (`lr_filterbank.py:136`): ``[crossover states, allpass states]``."""
        self.channels_zi = []
        for _ in range(number_of_channels):
            cross_zi = [[sosfilt_zi(self.sos[i][0]), sosfilt_zi(self.sos[i][1])]
                        for i in range(self.number_of_cross)]
            allpass_zi = [
                [[sosfilt_zi(self.sos[i2][0]), sosfilt_zi(self.sos[i2][1])]
                 for i2 in range(self.number_of_cross)]
                for _ in range(self.number_of_cross)
            ]
            self.channels_zi.append([cross_zi, allpass_zi])
        return self

    # ======== filtering =====================================================
    @spanned("dsp.entry.LRFilterBank.filter_signal")
    def filter_signal(
        self,
        s: Signal,
        mode: FilterBankMode = FilterBankMode.Parallel,
        activate_zi: bool = False,
        zero_phase: bool = False,
        mesh=None,
    ):
        """Split ``s`` into bands with allpass corrections
        (`lr_filterbank.py:160`): Parallel → MultiBandSignal, Summed (and
        Sequential, which falls back to it with a warning) → Signal.
        ``mesh`` is accepted, as `FilterBank.filter_signal` takes it, and
        ignored: each stage of the crossover tree filters the previous
        stage's output, so the bands cannot be split over devices."""
        if mode == FilterBankMode.Sequential:
            warn("sequential mode is not supported for this filter bank. It is "
                 "automatically changed to summed")
            mode = FilterBankMode.Summed
        assert s.sampling_rate_hz == self.sampling_rate_hz, "Sampling rates do not match"
        assert not (activate_zi and zero_phase), (
            "Zero phase filtering and activating zi is a valid setting"
        )
        if activate_zi:
            C = s.number_of_channels
            if not hasattr(self, "channels_zi") or len(self.channels_zi) != C:
                self.initialize_zi(C)
            out = s._x.new_empty((self.number_of_bands, C, s.length_samples))
            for ch in range(C):
                x = s._x[ch]
                for cn in range(self.number_of_cross):
                    band, x = self._two_way_split_zi(x, ch, cn)
                    for ap_n in range(cn + 1, self.number_of_cross):
                        band = self._allpass_zi(band, ch, cn, ap_n)
                    out[cn, ch] = band
                out[self.number_of_cross, ch] = x
        else:
            out = self._split(s._x, zero_phase)  # (B, C, T)
        bands = [s.copy_with_new_time_data(out[n].T) for n in range(self.number_of_bands)]
        out_sig = MultiBandSignal(
            bands=bands, same_sampling_rate=True,
            info=dict(readme="MultiBandSignal made using Linkwitz-Riley filter bank",
                      filterbank_freqs=self.freqs, filterbank_order=self.order),
        )
        if mode == FilterBankMode.Summed:
            return out_sig.collapse()
        return out_sig

    def _two_way_split_zi(self, x, ch, cn):
        cross_zi = self.channels_zi[ch][0][cn]
        s_l, zf_l = sosfilt(self.sos[cn][0], x, zi=cross_zi[0])
        s_h, zf_h = sosfilt(self.sos[cn][1], x, zi=cross_zi[1])
        cross_zi[0] = zf_l.cpu().numpy()
        cross_zi[1] = zf_h.cpu().numpy()
        return s_l, s_h

    def _allpass_zi(self, x, ch, cn, ap_n):
        ap_zi = self.channels_zi[ch][1][cn][ap_n]
        s_l, zf_l = sosfilt(self.sos[ap_n][0], x, zi=ap_zi[0])
        s_h, zf_h = sosfilt(self.sos[ap_n][1], x, zi=ap_zi[1])
        ap_zi[0] = zf_l.cpu().numpy()
        ap_zi[1] = zf_h.cpu().numpy()
        return s_l + s_h

    def _freq_nfft(self, T: int) -> int | None:
        """FFT length of the zero-state split by frequency sampling, or
        None when a crossover's decay margin is unusable or would more than
        quadruple the length."""
        margins = [decay_margin(sos) for pair in self.sos for sos in pair]
        if any(m is None for m in margins):
            return None
        nfft = next_fast_len(T + max(margins), real=True)
        return nfft if nfft <= 4 * T else None

    @cached_property
    def _cascade_bank(self) -> np.ndarray | None:
        """The bands' composite SOS cascades stacked ``(B, S, 6)``, built
        once in float64: band cn is HP₀ … HP_{cn−1} · LP_cn · the all-pass
        LP + HP of every higher crossover (`_allpass`), the last band every
        HP; None when a crossover of odd order has no all-pass form. The
        lowest crossover's all-pass is in no band."""
        allpass = [None] + [_allpass(pair[0], order)
                            for pair, order in zip(self.sos[1:], self.order[1:])]
        if any(ap is None for ap in allpass[1:]):
            return None
        hp = [pair[1] for pair in self.sos]
        bands = [np.vstack(hp[:cn] + [self.sos[cn][0]] + allpass[cn + 1 :])
                 for cn in range(self.number_of_cross)]
        return stack_sos_bank(bands + [np.vstack(hp)])

    def _composite_band_responses(self, nfft: int, device) -> torch.Tensor:
        """Per-band composite crossover and allpass responses on the rfft
        grid, evaluated on the host in float64 and kept on ``device`` as
        complex64 ``(B, F)``, per (nfft, device) (`lr_filterbank.py:250`)."""
        key = (nfft, str(device))
        got = self._responses.get(key)
        if got is None:
            lp = [sos_freq_response_host(self.sos[c][0], nfft, False)
                  for c in range(self.number_of_cross)]
            hp = [sos_freq_response_host(self.sos[c][1], nfft, False)
                  for c in range(self.number_of_cross)]
            spectra = []
            cur = np.ones_like(lp[0])
            for cn in range(self.number_of_cross):
                band = cur * lp[cn]
                cur = cur * hp[cn]
                for ap_n in range(cn + 1, self.number_of_cross):
                    band = band * (lp[ap_n] + hp[ap_n])
                spectra.append(band)
            spectra.append(cur)
            got = torch.as_tensor(np.stack(spectra).astype(np.complex64), device=device)
            self._responses[key] = got
        return retain(got)

    def _split(self, x: torch.Tensor, zero_phase: bool) -> torch.Tensor:
        """The zero-state band split of ``x (C, T)`` → ``(B, C, T)``."""
        T = x.shape[-1]
        outs = []
        if zero_phase:
            for cn in range(self.number_of_cross):
                factor = 1 if self.order[cn] % 2 == 1 or self.order[cn] == 2 else 2
                valid = self.sos[cn][0].shape[0] // factor
                outs.append(sosfiltfilt(self.sos[cn][0][:valid], x))
                x = sosfiltfilt(self.sos[cn][1][:valid], x)
            outs.append(x)
            return torch.stack(outs)
        if _config.use_kernel("bank", x) and self._cascade_bank is not None:
            ops = bank_device_operators(self._cascade_bank, T, x.dtype, x.device)
            return sosfilt_bank_apply_planes(ops, x)[0]
        nfft = self._freq_nfft(T)
        if nfft is not None:
            resp = self._composite_band_responses(nfft, x.device)
            X = torch.fft.rfft(x, n=nfft, dim=-1)
            return torch.fft.irfft(X[None] * resp[:, None, :], n=nfft, dim=-1)[..., :T]
        for cn in range(self.number_of_cross):
            band, _ = sosfilt(self.sos[cn][0], x)
            x, _ = sosfilt(self.sos[cn][1], x)
            for ap_n in range(cn + 1, self.number_of_cross):
                band = sosfilt(self.sos[ap_n][0], band)[0] + sosfilt(self.sos[ap_n][1], band)[0]
            outs.append(band)
        outs.append(x)
        return torch.stack(outs)

    # ======== getters / plots ===============================================
    def get_ir(self, length_samples: int, mode: FilterBankMode = FilterBankMode.Parallel,
               zero_phase: bool = False):
        """The bank's response to a dirac (`dsptoolbox_tpu/filterbanks/
        lr_filterbank.py:375`)."""
        from ..generators import dirac

        d = dirac(length_samples=length_samples, number_of_channels=1,
                  sampling_rate_hz=self.sampling_rate_hz)
        return self.filter_signal(d, mode=mode, zero_phase=zero_phase, activate_zi=False)

    def _band_irs(self, length_samples: int, zero_phase: bool = False) -> np.ndarray:
        """Each band's IR ``(length, bands)`` on the host."""
        ir = self.get_ir(length_samples, FilterBankMode.Parallel, zero_phase=zero_phase)
        return torch.stack([b.time_data[:, 0] for b in ir.bands], dim=1).cpu().numpy()

    def plot_magnitude(self, length_samples: int = 2048,
                       mode: FilterBankMode = FilterBankMode.Parallel, range_hz=[20.0, 20e3],
                       zero_phase: bool = False):
        """Magnitude of each band, or of their sum in Summed mode
        (`dsptoolbox_tpu/filterbanks/lr_filterbank.py:392`)."""
        from ..helpers.gain_and_level import to_db
        from ..plots import general_plot

        irs = self._band_irs(length_samples, zero_phase)
        f = np.fft.rfftfreq(length_samples, 1 / self.sampling_rate_hz)
        if mode == FilterBankMode.Summed:
            irs = np.sum(irs, axis=1, keepdims=True)
        mat = np.asarray(to_db(np.abs(np.fft.rfft(irs, axis=0)), True))
        return general_plot(f, mat, range_hz, ylabel="Magnitude / dB",
                            labels=[f"Band {n}" for n in range(mat.shape[1])])

    def plot_phase(self, length_samples: int = 2048, range_hz=[20.0, 20e3]):
        """Phase of each band (`dsptoolbox_tpu/filterbanks/lr_filterbank.py:433`)."""
        from ..plots import general_plot

        f = np.fft.rfftfreq(length_samples, 1 / self.sampling_rate_hz)
        mat = np.angle(np.fft.rfft(self._band_irs(length_samples), axis=0))
        return general_plot(f, mat, range_hz, ylabel="Phase / rad",
                            labels=[f"Band {n}" for n in range(mat.shape[1])])

    def plot_group_delay(self, length_samples: int = 2048, range_hz=[20.0, 20e3]):
        """Group delay of each band in ms (`dsptoolbox_tpu/filterbanks/
        lr_filterbank.py:453`)."""
        from ..plots import general_plot
        from ..standard.backend import group_delay_direct

        f = np.fft.rfftfreq(length_samples, 1 / self.sampling_rate_hz)
        ph = np.angle(np.fft.rfft(self._band_irs(length_samples), axis=0))
        gd = group_delay_direct(torch.as_tensor(ph), f[1] - f[0]).numpy() * 1e3
        return general_plot(f, gd, range_hz, ylabel="Group delay / ms",
                            labels=[f"Band {n}" for n in range(gd.shape[1])])

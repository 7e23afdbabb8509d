"""Linkwitz-Riley crossover filter bank
(`dsptoolbox_tpu/filterbanks/lr_filterbank.py`).

The band-split cascade with allpass phase correction runs batched over
channels on the signal's device. Zero-state splits whose decay margin
allows it go through the composite band responses (one rfft, one batched
irfft: exact frequency sampling, `ops.iir_freq`); the others through the
`sosfilt` chain (the blocked IIR, kernel B2). The per-channel ``zi`` path
keeps scipy's state conventions. Not ported: ``get_ir``, plots, saving
and copies.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch
from scipy.signal import butter, sosfilt_zi

from ..classes.multibandsignal import MultiBandSignal
from ..classes.signal import Signal
from ..ops.fft_conv import next_fast_len
from ..ops.iir import sosfilt, sosfiltfilt
from ..ops.iir_freq import decay_margin, sos_freq_response_host
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
    def filter_signal(
        self,
        s: Signal,
        mode: FilterBankMode = FilterBankMode.Parallel,
        activate_zi: bool = False,
        zero_phase: bool = False,
    ):
        """Split ``s`` into bands with allpass corrections
        (`lr_filterbank.py:160`): Parallel → MultiBandSignal, Summed (and
        Sequential, which falls back to it with a warning) → Signal."""
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
        return got

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

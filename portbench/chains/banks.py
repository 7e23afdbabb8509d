"""Config 3's filter-bank chain through ``dsptoolbox_tpu_torch``'s public
API (the call sequence of ``dsptoolbox_tpu_torch/tools/
filterbank_chain.py:run``): the Linkwitz-Riley crossover, the gammatone
bank, the resampling and the fractional-octave bank, each bank in Parallel
mode. The designs and the bank operators are built once, in set-up. On a
float32 CUDA signal both banks run on kernel B3 (the gammatone's complex
route, the fractional-octave bank's real route); the crossover and the
resampling run on cuFFT."""

from __future__ import annotations

from ..reference.banks import gammatone_poles, octave_bands
from ..roofline import sos_bank


class Program:
    """The three banks, designed once, and one `Signal` a recording."""

    def __init__(self, config: dict, traffic: dict, recordings, device, rows: list):
        from dsptoolbox_tpu_torch import Signal
        from dsptoolbox_tpu_torch.filterbanks import (
            auditory_filters_gammatone,
            fractional_octave_bands,
            linkwitz_riley_crossovers,
        )
        from dsptoolbox_tpu_torch.standard.enums import FilterBankMode

        if config["bank_mode"] != "parallel":
            raise ValueError("the filter-bank chain runs its banks in Parallel mode")
        fs = int(config["sampling_rate_hz"])
        cr, gt, fo = config["crossover"], config["gammatone"], config["fractional_octave"]
        self.mode = FilterBankMode.Parallel
        self.fs_out = int(config["resample_hz"])
        self.lr = linkwitz_riley_crossovers(list(cr["frequencies_hz"]), list(cr["orders"]), fs)
        self.gt = auditory_filters_gammatone(list(gt["frequency_range_hz"]),
                                             resolution=gt["resolution"], sampling_rate_hz=fs)
        self.third = fractional_octave_bands(list(fo["frequency_range_hz"]), fo["fraction"],
                                             fo["order"], fs)[0]
        self.signals = [Signal(None, rec.T, fs) for rec in recordings]

    def call(self, index: int, span):
        from dsptoolbox_tpu_torch.standard.resampling import resample

        sig = self.signals[index]
        with span("lr.filter_signal"):
            lr = self.lr.filter_signal(sig, self.mode)
        with span("gammatone.filter_signal"):
            gt = self.gt.filter_signal(sig, self.mode)
        with span("resample"):
            rs = resample(sig, self.fs_out)
        with span("fractional_octave.filter_signal"):
            third = self.third.filter_signal(sig, self.mode)
        return lr, gt, rs, third

    @staticmethod
    def extract(outputs, rows: list) -> dict:
        """The sampled rows of every output, on the host: ``lr``, ``third``
        ``(bands, rows, T)``, ``gammatone`` complex ``(bands, rows, T)``,
        ``resampled (rows, T')``."""
        import torch

        lr, gt, rs, third = outputs

        def real(mb):
            return torch.stack([b.time_data.T[rows] for b in mb.bands]).cpu()

        return {
            "lr": real(lr),
            "gammatone": torch.stack([torch.complex(b.time_data.T[rows], b.time_data_imaginary.T[rows])
                                      for b in gt.bands]).cpu(),
            "resampled": rs.time_data.T[rows].cpu(),
            "third": real(third),
        }


def work(config: dict, traffic: dict) -> dict:
    """A call's input audio (seconds) and the filter-bank kernel's work:
    the gammatone bank (complex one-pole sections, complex output) and the
    fractional-octave bank (real biquads), each a call on the whole
    recording."""
    C = int(config["channels"])
    T = int(round(float(config["seconds"]) * int(config["sampling_rate_hz"])))
    poles, gains = gammatone_poles(config)
    gt = [[[1, 0, 0, 1, -p, 0]] * 3 + [[g, 0, 0, 1, -p, 0]] for p, g in zip(poles, gains)]
    return {"audio_s": C * float(config["seconds"]),
            "iir_bank": sos_bank(C, T, gt, True) + sos_bank(C, T, octave_bands(config), False)}

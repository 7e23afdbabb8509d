"""Config 2's spectral chain through ``dsptoolbox_tpu_torch``'s public API
(the call sequence of ``dsptoolbox_tpu_torch/tools/speech_chain.py:run``):
``Signal.get_spectrogram`` → ``transforms.istft`` → ``Signal.get_spectrum``
(Welch) → ``standard.append_signals([sig, y])`` → ``get_csm`` of the
appended signal, every getter with ``return_device=True`` (no host copy).
The spectrogram, the ISTFT, the Welch spectrum and the CSM are its
outputs.
On a float32 CUDA signal the three framings run on kernel B1."""

from __future__ import annotations

from ..roofline import Work, framing


def _enums():
    from dsptoolbox_tpu_torch.standard.enums import SpectrumMethod, SpectrumScaling, Window

    return {"hann": Window.Hann, "fft_backward": SpectrumScaling.FFTBackward,
            "welch": SpectrumMethod.WelchPeriodogram}


class Program:
    """One `Signal` a recording, with the configuration's spectrum and
    spectrogram parameters set once."""

    def __init__(self, config: dict, traffic: dict, recordings, device, rows: list):
        from dsptoolbox_tpu_torch import Signal

        e = _enums()
        sp, sg = config["spectrum"], config["spectrogram"]
        fs = int(config["sampling_rate_hz"])
        self.signals = []
        for rec in recordings:
            sig = Signal(None, rec.T, fs)
            sig.set_spectrum_parameters(
                method=e[sp["method"]], window_length_samples=sp["window_length_samples"],
                window_type=e[sp["window_type"]], overlap_percent=sp["overlap_percent"],
                detrend=sp["detrend"], average=sp["average"], scaling=e[sp["scaling"]])
            sig.set_spectrogram_parameters(
                window_length_samples=sg["window_length_samples"],
                window_type=e[sg["window_type"]], overlap_percent=sg["overlap_percent"],
                detrend=sg["detrend"], padding=sg["padding"], scaling=e[sg["scaling"]])
            self.signals.append(sig)

    def call(self, index: int, span):
        from dsptoolbox_tpu_torch.standard import append_signals
        from dsptoolbox_tpu_torch.transforms import istft

        sig = self.signals[index]
        with span("get_spectrogram"):
            _, _, S = sig.get_spectrogram(force_computation=True, return_device=True)
        with span("istft"):
            y = istft(S, original_signal=sig)
        with span("get_spectrum"):
            _, welch = sig.get_spectrum(force_computation=True, return_device=True)
        with span("append_signals"):
            both = append_signals([sig, y])
        with span("get_csm"):
            _, csm = both.get_csm(force_computation=True, return_device=True)
        return S, y, welch, csm

    @staticmethod
    def extract(outputs, rows: list) -> dict:
        """The call's outputs as the reference's tensors: ``stft (C, K, F)``
        complex, ``y (C, T)``, ``welch (C, F)``, ``csm (F, 2C, 2C)``
        complex."""
        import torch

        S, y, welch, csm = outputs
        return {"stft": S.permute(2, 1, 0)[rows], "y": y.time_data.T[rows],
                "welch": welch.T[rows],
                "csm": torch.complex(csm.real, csm.imag)}


def work(config: dict, traffic: dict) -> dict:
    """A call's input audio (seconds) and the framing kernel's work: the
    STFT (padded by its overlap), the Welch spectrum and the CSM's framing
    of the appended 2C channels."""
    C = int(config["channels"])
    T = int(round(float(config["seconds"]) * int(config["sampling_rate_hz"])))
    sp, sg = config["spectrum"], config["spectrogram"]
    L = int(sg["window_length_samples"])
    overlap = int(sg["overlap_percent"] / 100 * L + 0.5)
    stft = framing(C, T, L, L - overlap, overlap if sg["padding"] else 0, sg["detrend"])
    L = int(sp["window_length_samples"])
    step = L - int(sp["overlap_percent"] / 100 * L)
    welch = framing(C, T, L, step, 0, sp["detrend"])
    csm = framing(2 * C, T, L, step, 0, sp["detrend"])
    return {"audio_s": C * float(config["seconds"]), "framing": stft + welch + csm}

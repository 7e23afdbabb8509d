"""Distance measures (`dsptoolbox_tpu/distances`)."""

from .distances import fw_snr_seg, itakura_saito, log_spectral, si_sdr, snr

__all__ = ["log_spectral", "itakura_saito", "snr", "si_sdr", "fw_snr_seg"]

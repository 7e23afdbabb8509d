"""Tools of the port: the filter banks' frequency grids
(`fractional_octave_frequencies`, `erb_frequencies`), and, as submodules,
the configurations the port is driven at (`camera`, `measurement`,
`filterbank_chain`, `room_measurement`, `speech_chain`), `profile_chain`,
which profiles them on a CUDA device, and the measurement tools
`das_phases` and `mma_rates`."""

from .frequencies import erb_frequencies, fractional_octave_frequencies

__all__ = ["erb_frequencies", "fractional_octave_frequencies"]

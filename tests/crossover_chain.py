"""The sequential Linkwitz-Riley crossover chain in scipy's float64
``sosfilt``, the reference that the port's crossover bands are held against
on the CPU (`test_torch_filterbanks.py`) and on the card
(`test_torch_cuda.py`, run without the conftest, so this module imports
nothing of the JAX package)."""

import numpy as np
from scipy.signal import sosfilt


def lr_chain(lr, x: np.ndarray) -> list:
    """The bands of a Linkwitz-Riley bank ``lr`` over ``x (rows, T)``: each
    band's low pass, then the all-pass LP + HP of every higher crossover;
    the last band every high pass."""
    bands, rest = [], x
    for cn, (lp, hp) in enumerate(lr.sos):
        band, rest = sosfilt(lp, rest, axis=-1), sosfilt(hp, rest, axis=-1)
        for lp2, hp2 in lr.sos[cn + 1 :]:
            band = sosfilt(lp2, band, axis=-1) + sosfilt(hp2, band, axis=-1)
        bands.append(band)
    return bands + [rest]

"""Polyphase decomposition and reconstruction as reshapes
(`dsptoolbox_tpu/helpers/polyphase.py`), on the data's device. Layout as
in the reference: (time, polyphase components, channels)."""

from __future__ import annotations

import torch


def polyphase_decomposition(in_sig, number_polyphase_components: int, flip: bool = False):
    """``(T, C)`` → ``((T'/n, n, C), padding)``: the front is padded with
    zeros so that n divides the length, as in the reference."""
    in_sig = torch.as_tensor(in_sig)
    if in_sig.ndim == 1:
        in_sig = in_sig[..., None]
    assert in_sig.ndim == 2, (
        "Vector should have exactly two dimensions: (time samples, channels)"
    )
    n = number_polyphase_components
    remainder = in_sig.shape[0] % n
    padding = n - remainder
    if remainder != 0:
        in_sig = torch.cat([in_sig.new_zeros((padding, in_sig.shape[1])), in_sig])
    poly = in_sig.reshape(in_sig.shape[0] // n, n, in_sig.shape[1])
    if flip:
        poly = poly.flip(1)
    return poly, padding


def polyphase_reconstruction(poly):
    """``(T/n, n, C)`` → ``(T, C)``: the inverse interleave, one reshape."""
    poly = torch.as_tensor(poly)
    if poly.ndim == 2:
        poly = poly[..., None]
    assert poly.ndim == 3, (
        "Invalid shape. The dimensions must be (time samples, polyphase "
        "components, channels)"
    )
    return poly.reshape(poly.shape[0] * poly.shape[1], poly.shape[2])

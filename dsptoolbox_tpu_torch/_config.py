"""Global numeric configuration and kernel switches.

Default dtypes are float32 / complex64, as in the JAX package; float64 mode
(``set_default_float("float64")``) is for tight oracle comparisons and
always takes the plain PyTorch paths, since the CUDA kernels are fp32 only.

Each hand-written kernel sits behind a switch with three values:

- ``"auto"`` (default): a CUDA tensor goes to the kernel, a CPU tensor takes
  the plain PyTorch version;
- ``"on"``: the kernel is required; a CPU tensor raises;
- ``"off"``: always the plain PyTorch version.
"""

from __future__ import annotations

import torch

_FLOAT = torch.float32
_COMPLEX = torch.complex64


def set_default_float(dtype) -> None:
    """Set the package-wide real dtype ("float32" or "float64")."""
    global _FLOAT, _COMPLEX
    if dtype in ("float32", torch.float32):
        _FLOAT, _COMPLEX = torch.float32, torch.complex64
    elif dtype in ("float64", torch.float64):
        _FLOAT, _COMPLEX = torch.float64, torch.complex128
    else:
        raise ValueError(f"Unsupported default float dtype: {dtype}")


def default_float() -> torch.dtype:
    """Package-wide real floating dtype."""
    return _FLOAT


def default_complex() -> torch.dtype:
    """Package-wide complex floating dtype."""
    return _COMPLEX


_MODES = ("auto", "on", "off")
_FRAMING_KERNEL = "auto"
_IIR_KERNEL = "auto"


def _check_mode(mode: str) -> str:
    if mode not in _MODES:
        raise ValueError(f"kernel mode must be one of {_MODES}, got {mode!r}")
    return mode


def set_framing_kernel(mode: str) -> None:
    """Switch for the fused framing kernel (`ops.cuda_framing`)."""
    global _FRAMING_KERNEL
    _FRAMING_KERNEL = _check_mode(mode)


def framing_kernel() -> str:
    return _FRAMING_KERNEL


def set_iir_kernel(mode: str) -> None:
    """Switch for the blocked-IIR lead kernel (`ops.cuda_iir`)."""
    global _IIR_KERNEL
    _IIR_KERNEL = _check_mode(mode)


def iir_kernel() -> str:
    return _IIR_KERNEL


def use_kernel(mode: str, x: torch.Tensor) -> bool:
    """Whether a kernel behind switch ``mode`` runs on tensor ``x``: the
    tensor's device decides under "auto"."""
    if mode == "off":
        return False
    if x.is_cuda:
        return True
    if mode == "on":
        raise ValueError(
            "the CUDA kernel is switched 'on' but the tensor lies on "
            f"{x.device}; move it to a CUDA device or use 'auto'"
        )
    return False

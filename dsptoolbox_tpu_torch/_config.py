"""Global numeric configuration and kernel switches.

Default dtypes are float32 / complex64, as in the JAX package; float64 mode
(``set_default_float("float64")``) is for tight oracle comparisons and
takes the plain PyTorch paths, since the CUDA kernels are fp32 only; on a
CUDA tensor the filter bank raises for it unless its switch is "off".

Default device: ``"cuda"``. A class built from numpy data (`Signal`,
`ImpulseResponse`, `Spectrum`, the generators' signals) puts it on the
``device`` it is given or, without one, on `default_device()`; a tensor
keeps its own device. There is no fallback to the CPU: without a GPU,
building from numpy without a device raises torch's own error unless
``set_default_device("cpu")`` was called.

Each hand-written kernel sits behind a switch with three values:

- ``"auto"`` (default): a CUDA tensor goes to the kernel, a CPU tensor takes
  the plain PyTorch version;
- ``"on"``: the kernel is required; a CPU tensor raises;
- ``"off"``: always the plain PyTorch version.
"""

from __future__ import annotations

from contextlib import contextmanager

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


_DEVICE = "cuda"


def set_default_device(device) -> None:
    """Set the device that numpy data goes to when no device is given."""
    global _DEVICE
    _DEVICE = str(torch.device(device))


def default_device() -> str:
    """Device for numpy data built into a class without a device."""
    return _DEVICE


_MODES = ("auto", "on", "off")
_FRAMING_KERNEL = "auto"
_IIR_KERNEL = "auto"
_DAS_KERNEL = "auto"
_BANDED_KERNEL = "auto"
_BANK_KERNEL = "auto"


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


def set_das_kernel(mode: str) -> None:
    """Switch for the fused DAS map kernel (`ops.cuda_das`); the port's
    counterpart of the JAX package's ``set_pallas_das``."""
    global _DAS_KERNEL
    _DAS_KERNEL = _check_mode(mode)


def das_kernel() -> str:
    return _DAS_KERNEL


def set_banded_kernel(mode: str) -> None:
    """Switch for the banded smoothing-operator kernel (`ops.cuda_banded`);
    the port's counterpart of the JAX package's Pallas dispatch in
    ``banded_apply``."""
    global _BANDED_KERNEL
    _BANDED_KERNEL = _check_mode(mode)


def banded_kernel() -> str:
    return _BANDED_KERNEL


def set_bank_kernel(mode: str) -> None:
    """Switch for the IIR filter-bank kernel (`ops.cuda_iir_bank`), the
    route of `ops.iir_block.sosfilt_bank_apply` on a CUDA tensor."""
    global _BANK_KERNEL
    _BANK_KERNEL = _check_mode(mode)


def bank_kernel() -> str:
    return _BANK_KERNEL


@contextmanager
def kernels_off():
    """Every kernel switch "off" inside the block (the plain PyTorch
    paths); the previous modes are restored after it."""
    global _FRAMING_KERNEL, _IIR_KERNEL, _DAS_KERNEL, _BANDED_KERNEL, _BANK_KERNEL
    saved = (_FRAMING_KERNEL, _IIR_KERNEL, _DAS_KERNEL, _BANDED_KERNEL, _BANK_KERNEL)
    _FRAMING_KERNEL = _IIR_KERNEL = _DAS_KERNEL = _BANDED_KERNEL = _BANK_KERNEL = "off"
    try:
        yield
    finally:
        (_FRAMING_KERNEL, _IIR_KERNEL, _DAS_KERNEL, _BANDED_KERNEL,
         _BANK_KERNEL) = saved


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

"""Global numeric configuration and kernel switches.

Default dtypes are float32 / complex64, as in the JAX package; float64 mode
(``set_default_float("float64")``) is for tight oracle comparisons and
takes the plain PyTorch paths, since the CUDA kernels are fp32 only; on a
CUDA tensor the filter bank raises for it unless its switch is "off". In
float64 mode `Filter` runs its real IIR and zero-phase filters on a CPU
signal through scipy, as the JAX package does (`classes.filter_helpers.
_oracle_exact_f64`, off with ``DSPTB_F64_DEVICE_IIR=1``); a signal on a
card stays on the torch float64 paths there. The getters
return plain numpy (`lazy_host_returns`).

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

`in_pipeline` tells the class layer that a `pipeline` runner is running its
function (`pipeline_context`): the paths that would read a value back to
the host keep it on the device instead. `device_cache` caches the builders
of device constants and keeps what they hand out alive while a graph that
reads it is captured (`retain`).
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache, wraps

import torch

from . import _trace

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


_LAZY_HOST: bool | None = None  # None: lazy in float32 mode, eager in float64


def set_lazy_host_returns(enabled: bool | None) -> None:
    """Override lazy host returns of the getters (`Signal.get_spectrum`,
    `get_csm`, `get_spectrogram`). ``True``/``False`` force them; ``None``
    restores the default: lazy in float32 mode (a
    `classes.lazy_array.LazyHostArray` over the device tensor, fetched at the
    first host access), plain numpy in float64 mode."""
    global _LAZY_HOST
    _LAZY_HOST = enabled


def lazy_host_returns() -> bool:
    """Whether the getters return lazy device-backed host arrays."""
    if _LAZY_HOST is not None:
        return _LAZY_HOST
    return _FLOAT == torch.float32


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
_EMA_KERNEL = "auto"


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


def set_ema_kernel(mode: str) -> None:
    """Switch for the attack/release EMA kernel (`ops.cuda_ema`), the route
    of `helpers.smoothing.time_smoothing` with a release time on a CUDA
    tensor."""
    global _EMA_KERNEL
    _EMA_KERNEL = _check_mode(mode)


def ema_kernel() -> str:
    return _EMA_KERNEL


_CLEAN_SC_DEVICE = True


def set_clean_sc_on_device(enabled: bool) -> None:
    """Dispatch for CLEAN-SC: ``True`` (default) runs the deconvolution of
    every frequency bin as one batched device loop; ``False`` runs the host
    per-bin loop in numpy (the parity oracle)."""
    global _CLEAN_SC_DEVICE
    _CLEAN_SC_DEVICE = bool(enabled)


def clean_sc_on_device() -> bool:
    return _CLEAN_SC_DEVICE


@contextmanager
def kernels_off():
    """Every kernel switch "off" inside the block (the plain PyTorch
    paths); the previous modes are restored after it."""
    global _FRAMING_KERNEL, _IIR_KERNEL, _DAS_KERNEL, _BANDED_KERNEL, _BANK_KERNEL, _EMA_KERNEL
    saved = (_FRAMING_KERNEL, _IIR_KERNEL, _DAS_KERNEL, _BANDED_KERNEL, _BANK_KERNEL,
             _EMA_KERNEL)
    _FRAMING_KERNEL = _IIR_KERNEL = _DAS_KERNEL = _BANDED_KERNEL = _BANK_KERNEL = "off"
    _EMA_KERNEL = "off"
    try:
        yield
    finally:
        (_FRAMING_KERNEL, _IIR_KERNEL, _DAS_KERNEL, _BANDED_KERNEL,
         _BANK_KERNEL, _EMA_KERNEL) = saved


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


_PIPELINE = 0
_RETAINED: list | None = None


def in_pipeline() -> bool:
    """Whether a `pipeline` runner is running its function (its warm-up and
    capture on a CUDA device, every call on the CPU). The class layer then
    keeps its host reads on the device, as the JAX package does under a
    trace: a signal's amplitude constraint runs in-program, a filter bank's
    peaks and `spectral_deconvolve`'s automatic regularization range stay
    device tensors."""
    return _PIPELINE > 0


@contextmanager
def pipeline_context(retained: list | None = None):
    """`in_pipeline` is true inside the block. ``retained``: the list that
    `retain` appends to inside it (the device constants a captured graph
    reads); the enclosing one is restored after the block."""
    global _PIPELINE, _RETAINED
    saved = _RETAINED
    _PIPELINE += 1
    if retained is not None:
        _RETAINED = retained
    try:
        yield
    finally:
        _PIPELINE -= 1
        _RETAINED = saved


def retain(obj):
    """``obj``, kept alive as long as the CUDA graph being captured (if
    any): the graph reads device constants by address, so one that a cache
    drops later must not be freed while the graph can replay."""
    if _RETAINED is not None:
        _RETAINED.append(obj)
    return obj


def device_cache(maxsize: int):
    """`functools.lru_cache` for a builder of device constants whose every
    result, cached or new, also goes through `retain`. A miss runs the
    builder as `_trace.counted_build` (a ``dsp.build`` span, counted with
    its host seconds in `_trace.builds`); a hit costs no more."""

    def wrap(fn):
        cached = lru_cache(maxsize=maxsize)(_trace.counted_build(fn))

        @wraps(fn)
        def get(*args):
            return retain(cached(*args))

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get

    return wrap

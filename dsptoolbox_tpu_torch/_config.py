"""Global numeric configuration and the kernel-or-plain rule.

Default dtypes are float32 / complex64, as in the JAX package; float64 mode
(``set_default_float("float64")``) is for tight oracle comparisons and
takes the plain PyTorch paths wherever a kernel does not take float64. In
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

One rule chooses between each hand-written kernel and its plain PyTorch
version: `use_kernel(name, x)` is true for a CUDA tensor of a dtype that
`KERNEL_DTYPES[name]` lists, and false inside `kernels_off()`, the one
seam through which tests and card checks run the plain versions. Every
dispatcher asks it by its kernel's name; a new kernel adds one entry to the
table.

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


_CLEAN_SC_DEVICE = True


def set_clean_sc_on_device(enabled: bool) -> None:
    """Dispatch for CLEAN-SC: ``True`` (default) runs the deconvolution of
    every frequency bin as one batched device loop; ``False`` runs the host
    per-bin loop in numpy (the parity oracle)."""
    global _CLEAN_SC_DEVICE
    _CLEAN_SC_DEVICE = bool(enabled)


def clean_sc_on_device() -> bool:
    return _CLEAN_SC_DEVICE


# the dtypes each hand-written kernel takes, by the name its dispatcher asks
KERNEL_DTYPES = {
    "framing": (torch.float32,),  # ops.cuda_framing.windowed_frames
    "iir": (torch.float32,),  # ops.cuda_iir.sosfilt_lead
    "bank": (torch.float32,),  # ops.iir_block.sosfilt_bank_apply_planes
    "das": (torch.float32,),  # ops.cuda_das.das_map
    "banded": (torch.float32,),  # ops.banded.banded_apply
    "ema": (torch.float32, torch.float64),  # ops.cuda_ema's two forms
    "csm": (torch.complex64,),  # ops.cuda_csm.gram_mean
}

_KERNELS_OFF = 0


@contextmanager
def kernels_off():
    """Every dispatcher takes the plain PyTorch version inside the block;
    blocks nest."""
    global _KERNELS_OFF
    _KERNELS_OFF += 1
    try:
        yield
    finally:
        _KERNELS_OFF -= 1


def use_kernel(name: str, x) -> bool:
    """Whether the kernel ``name`` (a key of `KERNEL_DTYPES`) runs on the
    tensor ``x``: a CUDA tensor of a dtype the kernel takes, outside
    `kernels_off`."""
    return not _KERNELS_OFF and x.is_cuda and x.dtype in KERNEL_DTYPES[name]


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

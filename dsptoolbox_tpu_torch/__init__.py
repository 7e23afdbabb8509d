"""PyTorch/CUDA port of ``dsptoolbox_tpu``.

The layout mirrors the JAX package module for module (``_config``,
``standard.enums``, ``ops.*``, ``transfer_functions._backend``), so each
function's counterpart is found by path. Public functions keep the JAX
package's channels-first layout ``(..., T)``; the device is the device of
the input tensor. The classes put numpy data on ``device`` or, without
one, on `default_device()` ("cuda" unless `set_default_device` changed it).

Hand-written CUDA kernels replace the JAX package's Pallas kernels
(`ops.cuda_framing`, `ops.cuda_iir`, `ops.cuda_iir_bank`, `ops.cuda_das`,
`ops.cuda_banded`). They are compiled
from ``csrc/`` at first use on a CUDA tensor; a CPU tensor always takes the
plain PyTorch version, so importing this package needs neither ``nvcc`` nor
a GPU.
"""

from ._config import (
    default_complex,
    default_device,
    default_float,
    set_bank_kernel,
    set_banded_kernel,
    set_das_kernel,
    set_default_device,
    set_default_float,
    set_framing_kernel,
    set_iir_kernel,
)

__all__ = [
    "default_complex",
    "default_device",
    "default_float",
    "set_bank_kernel",
    "set_banded_kernel",
    "set_das_kernel",
    "set_default_device",
    "set_default_float",
    "set_framing_kernel",
    "set_iir_kernel",
]

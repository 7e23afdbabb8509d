"""`compute_all` and `deferral_enabled` (`dsptoolbox_tpu/_defer.py`).

The JAX package defers its hot producers into a DAG of pending programs and
flushes it as one composite program, because each program launch on a
remote-attached TPU costs 0.5-1.7 ms. PyTorch already queues every kernel
on the device's stream without waiting, so a call returns as soon as its
work is issued and nothing is left to batch: the DAG is not built here.
What deferral bought the JAX package on the host, `pipeline`'s CUDA graph
buys here. Only the public names remain: `deferral_enabled` is always
False, and `compute_all` waits until every value it is given has been
computed.
"""

from __future__ import annotations

import torch

__all__ = ["compute_all", "deferral_enabled"]


def deferral_enabled() -> bool:
    """Always False: no call is deferred (see the module docstring)."""
    return False


def compute_all(*values):
    """Return ``values`` (one value, or a tuple of several: Signals,
    tensors, any nest of them) once every tensor in them has been computed:
    the work queued on the CUDA devices is waited for, and nothing is
    copied to the host. Useful when timing a chain or handing results to
    code outside torch."""
    if torch.cuda.is_initialized():
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)
    return values if len(values) != 1 else values[0]

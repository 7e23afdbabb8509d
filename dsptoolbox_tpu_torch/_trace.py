"""Spans and build counts of the port, on torch's profiler's clock.

A span is a CPU operator event of torch's profiler, named
``dsp.<layer>.<name>`` after the layers of the port: ``dsp.entry.*`` for
the public calls (the `Signal` getters, `transforms.istft`, the filter
banks' ``filter_signal``, ...), ``dsp.ops.*`` for the ops they plan and
dispatch (`ops.spectral`, `ops.iir_block`, ...) and ``dsp.build.*`` for the
host builds of device constants (`_config.device_cache` on a miss) and of
the CUDA kernels (`_cuda.build` when it compiles). Spans are recorded only
while torch's profiler records, into its own trace: there they share one
clock with the device's operations, and the span enclosing another is its
parent (``cpu_parent``). With no profiler running a span is one flag test.

A span is entered as ``torch._C._profiler._RecordFunctionFast``, an
operator event and not a user annotation: the profiler mirrors a
`record_function` range onto the device's timeline, where it would read as
device work, but not an operator event.

`builds` counts the misses of every `device_cache` builder and their host
seconds, whether or not the profiler records.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from functools import wraps

import torch
import torch.autograd.profiler as _state

_PACKAGE = __name__.rsplit(".", 1)[0] + "."
_OFF = nullcontext()

# "<module>.<builder>" (the module without the package's prefix) →
# [misses, host seconds in the builder], since the process started
builds: dict[str, list] = {}


def span(name: str):
    """A context manager recording the span ``name`` (``dsp.<layer>.<...>``)
    while torch's profiler records; else a shared no-op."""
    if not _state._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""

    def wrap(fn):
        @wraps(fn)
        def call(*args, **kwargs):
            if not _state._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch._C._profiler._RecordFunctionFast(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def counted_build(fn):
    """``fn``, a builder that `_config.device_cache` calls on a miss, run
    inside the span ``dsp.build.<module>.<builder>`` and counted in
    `builds` with its host seconds."""
    key = f"{fn.__module__.removeprefix(_PACKAGE)}.{fn.__qualname__}"
    name = "dsp.build." + key

    @wraps(fn)
    def build(*args):
        t0 = time.perf_counter()
        with span(name):
            out = fn(*args)
        got = builds.setdefault(key, [0, 0.0])
        got[0] += 1
        got[1] += time.perf_counter() - t0
        return out

    return build

"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` at first
use, then loaded with ``ctypes``. The hash covers the source, so an edited
kernel is rebuilt (`build`, which also builds the host FLAC codec with
``g++``, `io.flac`). Nothing here runs at import time.

`Kernel` is the wrappers' launch path: the library and the ``ctypes``
function are resolved once, at the first launch, so a launch adds to the
wrapper's own checks only the current-device test, one call for the
stream handle and the ``ctypes`` call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from . import _trace

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# per kernel source: {"seconds": build time, "log": compiler output}; empty
# for a library found already built
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "dsptoolbox_tpu_torch are built from source at first use"
    )


def build(src: Path, name: str, command: list) -> Path:
    """``_build/lib<name>-<hash>.so`` built from ``src`` with ``command``
    (the compiler and its flags; ``-o <out> <src>`` are appended) unless
    it exists: the hash covers the source, so an edited source is rebuilt.
    The compiler's output and time go to `BUILD_LOG` under ``name``; the
    compile is the span ``dsp.build.nvcc.<name>`` (`_trace`)."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        with _trace.span("dsp.build.nvcc." + name):
            proc = subprocess.run([*command, "-o", tmp, str(src)], capture_output=True,
                                  text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"{command[0]} failed to build {src.name}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr,
        }
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build(CSRC / f"{name}.cu", name, [_nvcc(), *NVCC_FLAGS])))
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


class Kernel:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (its last argument
    the stream), launched by `launch`."""

    def __init__(self, name: str, symbol: str, argtypes: list, what: str):
        self.name, self.symbol, self.argtypes, self.what = name, symbol, argtypes, what
        self._fn = None

    def launch(self, index: int, *args) -> None:
        """Call the entry point with ``args`` and the current stream of CUDA
        device ``index`` (one call: ``torch._C._cuda_getCurrentRawStream``),
        entering that device only when it is not the current one; raise if
        the launch returned a CUDA error."""
        fn = self._fn
        if fn is None:
            fn = getattr(load(self.name), self.symbol)
            fn.argtypes = self.argtypes  # pointers and the stream as c_void_p
            fn.restype = ctypes.c_int
            self._fn = fn
        if index == torch.cuda.current_device():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        check(err, self.what)

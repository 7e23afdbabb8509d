"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` at first
use, then loaded with ``ctypes``. The hash covers the source, so an edited
kernel is rebuilt. Nothing here runs at import time.
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

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple, object] = {}
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


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {src.name}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr,
        }
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of ``csrc/<name>.cu``, returning ``int``, with
    its argument types set (pointers and streams as ``c_void_p``)."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

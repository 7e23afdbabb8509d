"""Where the DAS map kernel's (B5) device time goes, phase by phase.

    python -m dsptoolbox_tpu_torch.tools.das_phases [--source csrc/das_map.cu] [F,M,G ...]

Builds ``csrc/das_map.cu`` (or ``--source``) once as it is and, where the
source has the ``DSPTB_DAS_SKIP`` switch, once for each of its phases left
out: the product (1), the fold (2), ``sincosf`` (4), all three (7) and
everything after the launch (8). At each shape (default: the DAS path's 10
and 30 bins and the 513-bin sweep, 64 mics, 900 points; a Hermitian C from
a seed) it checks the whole kernel against `cuda_das.das_map_plain` and
times every build as 20 launches captured in a CUDA graph, replayed 7 times
in turns: device µs a launch, without the host. The differences to the
whole kernel are the phases' costs: what is left with all three out is the
staging of C, the steering's loads and the sums; the launch alone is the
floor. The builds with a phase left out compute wrong maps. Needs a CUDA
device and ``nvcc``; builds into the kernels' build directory.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from ..ops import cuda_das

SKIPS = {0: "whole kernel", 1: "no product", 2: "no fold", 4: "no sincosf",
         7: "no product, fold or sincosf", 8: "launch alone"}


def build(src: Path, skip: int):
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _cuda.BUILD_DIR / f"libdas_phases-{digest}-{skip}.so"
    if not out.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-DDSPTB_DAS_SKIP={skip}",
                               "-o", str(out), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (skip {skip}):\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).dsptb_das_map_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def capture(launch, n: int = 20) -> torch.cuda.CUDAGraph:
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            launch()
    return g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=_cuda.CSRC / "das_map.cu")
    ap.add_argument("shapes", nargs="*", default=["10,64,900", "30,64,900", "513,64,900"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("das_phases: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; source {args.source}")
    skips = list(SKIPS) if "DSPTB_DAS_SKIP" in args.source.read_text() else [0]
    with ThreadPoolExecutor(len(skips)) as pool:
        fns = dict(zip(skips, pool.map(lambda k: build(args.source, k), skips)))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for shape in args.shapes:
        F, M, G = (int(v) for v in shape.split(","))
        C = rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M))
        C = (C + np.conj(np.swapaxes(C, -1, -2))) / 2
        das = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
               for a in (rng.uniform(0.5, 1.0, (M, G)), rng.uniform(-0.3, 0.3, (M, G)),
                         np.arange(F) * (48000 / 1024) * 2 * np.pi / 343, C.real, C.imag)]
        out = torch.empty((G, F), device=dev)
        stream = torch.cuda.current_stream()

        def launch(fn):
            # inside a capture the capturing stream is current
            _cuda.check(fn(*(t.data_ptr() for t in das), out.data_ptr(), M, G, F,
                           torch.cuda.current_stream().cuda_stream), "das_phases")

        launch(fns[0])
        err = float((out - cuda_das.das_map_plain(*das)).abs().max()
                    / cuda_das.das_map_plain(*das).abs().max())
        for fn in fns.values():
            launch(fn)
        stream.synchronize()
        graphs = {k: capture(lambda fn=fn: launch(fn)) for k, fn in fns.items()}
        times = {k: [] for k in graphs}
        for i in range(7):
            for k in (skips if i % 2 == 0 else skips[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graphs[k].replay()
                end.record()
                end.synchronize()
                times[k].append(start.elapsed_time(end) * 1e3 / 20)
        us = {k: statistics.median(v) for k, v in times.items()}
        print(f"===== B5 phases at (F, M, G) = {(F, M, G)}: whole kernel vs plain "
              f"scale-rel err {err:.2e}")
        for k in skips:
            print(f"  {us[k]:9.2f} us/launch  {SKIPS[k]}")
        if len(skips) > 1:
            print(f"  phases: product {us[0] - us[1]:.2f} us, fold {us[0] - us[2]:.2f}, "
                  f"sincosf {us[0] - us[4]:.2f}, staging + loads + sums "
                  f"{us[7] - us[8]:.2f}, launch {us[8]:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

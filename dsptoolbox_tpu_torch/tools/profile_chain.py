"""Where the measurement chain's time goes on a CUDA device.

    python -m dsptoolbox_tpu_torch.tools.profile_chain [--runs 5]

At the chain's shapes (16 signals × 8 s at 48 kHz, float32) it profiles,
with `torch.profiler`, the framing kernel, the IIR lead kernel on one
crossover band (and each against its plain version), and the whole chain in
both bank modes. For each it prints the device time per kernel and per call,
the host time per call (calls issued without waiting), the wall time per
call, and the device's busy share of the wall time. Needs a CUDA device;
builds the kernels from ``csrc/`` first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch
from scipy.signal import sosfilt_zi
from torch.profiler import ProfilerActivity, profile

from .. import _cuda, headline
from ..ops import cuda_framing, cuda_iir, iir_block
from ..ops.windows import get_window
from ..standard.enums import Window

FS = 48000
BATCH = 16
T = FS * 8
L_IIR = 128


def _device_us(evt) -> float:
    """Self device time of a profiler event in µs (the attribute's name
    changed across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_call(label: str, fn, runs: int) -> None:
    """Device time per kernel (torch.profiler), host and wall time per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, _device_us(e) / runs, e.count // runs)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    n = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    host = (t1 - t0) / n * 1e6
    wall = (t2 - t0) / n * 1e6

    print(f"===== {label}")
    print(f"device busy {busy:.1f} us/call; host {host:.1f} us/call; "
          f"wall {wall:.1f} us/call; device idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    for key, us, count in rows[:16]:
        print(f"  {us:10.1f} us  x{count:<3d} {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5, help="profiled calls per case")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_chain: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name in ("framing", "iir_lead"):
        _cuda.load(name)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((BATCH, T)).astype(np.float32)).to(dev)
    exc = torch.fft.rfft(
        torch.from_numpy(rng.standard_normal(T).astype(np.float32)).to(dev)
    )
    win = torch.as_tensor(get_window(Window.Hann, 1024), dtype=torch.float32, device=dev)
    sos = headline.crossover_bank(FS)[1]
    key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
    ops = iir_block.operators_to_torch(
        dict(zip(("HmatT", "GyT", "ALT", "MT"), iir_block._block_operators(key, L_IIR)),
             zi=sosfilt_zi(sos)[None].repeat(BATCH, 0)),
        dev, torch.float32,
    )
    lead = (ops["HmatT"], ops["GyT"], ops["ALT"], ops["MT"],
            x.reshape(BATCH, -1, L_IIR), ops["zi"].reshape(BATCH, -1))

    profile_call("B1 framing kernel, STFT shapes",
                 lambda: cuda_framing.windowed_frames_cuda(x, win, 512, False, 512),
                 args.runs)
    profile_call("B1 framing plain",
                 lambda: cuda_framing.windowed_frames_plain(x, win, 512, False, 512),
                 args.runs)
    profile_call("B2 lead kernel, band 1", lambda: cuda_iir.sosfilt_lead_cuda(*lead),
                 args.runs)
    profile_call("B2 lead plain, band 1", lambda: cuda_iir.sosfilt_lead_plain(*lead),
                 args.runs)
    for bank in ("per_band", "banked"):
        profile_call(f"chain {bank}", lambda: headline.run(x, exc, bank=bank), args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the port's time goes on a CUDA device.

    python -m dsptoolbox_tpu_torch.tools.profile_chain [--runs 5] [--case chain|das|tf|fb|all]

``chain``: at the measurement chain's shapes (16 signals × 8 s at 48 kHz,
float32) it profiles, with `torch.profiler`, the framing kernel, the IIR
lead kernel on one crossover band (and each against its plain version), and
the whole chain in both bank modes.

``das``: the DAS map kernel against its plain version on the full sweep
(513 bins × 64 mics × 900 points), and the acoustic-camera map
(`tools.camera`, 64 mics, 900 points, 2 kHz third octave) on a 0.5 s ×
16 kHz and a 10 s × 48 kHz recording: the map with the CSM cached, and CSM +
map, each through the kernels and on the plain paths.

``tf``: the transfer-function measurement path (`tools.measurement`: 16
mics × 288,000 samples at 48 kHz → IRs → 65,536-sample windows → 1/3-octave
smoothing over 32,769 bins): the plan's one-time host build and upload,
the banded kernel (B4) against its plain version on the path's plan, and
the whole path and its three steps, through the kernels and on the plain
paths.

``fb``: the filter-bank path (`tools.filterbank_chain`, config 3: 64
channels × 10 s at 44.1 kHz): the filter-bank kernel (B3) against its
plain version at the gammatone and 1/3-octave banks, and the whole path and
its four steps (LR crossover, gammatone, resampling, 1/3 octave), through
the kernels and on the plain paths.

For each case it prints the device time per kernel and per call, the host
time per call (calls issued without waiting), the wall time per call, and
the device's idle share of the wall time. Needs a CUDA device; builds the
kernels from ``csrc/`` first.
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

from .. import _config, _cuda, headline
from ..ops import cuda_das, cuda_framing, cuda_iir, iir_block
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


def plain_paths(fn):
    """``fn`` with every kernel switched off."""
    def run():
        with _config.kernels_off():
            return fn()
    return run


def profile_das(dev, runs: int) -> None:
    from ..beamforming import SteeringVector
    from . import camera

    rng = np.random.default_rng(0)
    F, M, G = 513, 64, 900
    g = camera.grid()
    C = rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M))
    C = (C + np.conj(np.swapaxes(C, -1, -2))) / 2
    amp = rng.uniform(0.5, 1.0, (M, G))
    diff = SteeringVector().get_amp_diff(g, camera.planar_array())[1]
    k = np.arange(F) * (FS / 1024) * 2 * np.pi / 343
    das = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
           for a in (amp, diff, k, C.real, C.imag)]
    profile_call("B5 DAS map kernel, 513 bins x 64 mics x 900 points",
                 lambda: cuda_das.das_map_cuda(*das), runs)
    profile_call("B5 DAS map plain, same shapes",
                 lambda: cuda_das.das_map_plain(*das), runs)
    for seconds, fs in ((0.5, 16000), (10, FS)):
        sig = camera.array_signal(seconds, fs, dev, g)
        beam = camera.beamformer(sig, g)

        def one_map():
            return beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION)

        def csm_and_map():
            sig.get_csm(force_computation=True)
            return one_map()

        label = f"DAS path {seconds} s x {fs} Hz x 64 mics"
        profile_call(f"{label}, map (CSM cached), kernels", one_map, runs)
        profile_call(f"{label}, map (CSM cached), plain paths", plain_paths(one_map), runs)
        profile_call(f"{label}, CSM + map, kernels", csm_and_map, runs)
        profile_call(f"{label}, CSM + map, plain paths", plain_paths(csm_and_map), runs)


def profile_tf(dev, runs: int) -> None:
    from ..ops import banded, cuda_banded
    from ..standard.enums import Window
    from ..transfer_functions import _backend as tf_backend
    from ..transfer_functions import (
        SmoothingDomain,
        complex_smoothing,
        spectral_deconvolve,
        window_ir,
    )
    from . import measurement

    freqs = np.fft.rfftfreq(measurement.IR_LENGTH, 1 / measurement.FS)
    key = tf_backend._plan_key(freqs, measurement.OCTAVE_FRACTION, Window.Hann(3000, True))
    t0 = time.perf_counter()
    plan = tf_backend.device_banded_plan(key, torch.float32, dev)
    torch.cuda.synchronize()
    print(f"===== B4 plan (32769 bins, 1/3 octave): host build and upload "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (len(freqs) + max(seg["span"] for seg in plan), 2 * measurement.CHANNELS)
    ).astype(np.float32)).to(dev)
    for name, fn in (("kernel", cuda_banded.banded_matmul_cuda),
                     ("plain", banded.banded_plan_plain)):
        profile_call(f"B4 banded {name}, the path's plan (6 segments) x 32 columns",
                     lambda fn=fn: fn(plan, x), runs)
    sweep = measurement.excitation()
    rec = measurement.recording(sweep, measurement.room_irs()[0])
    ir = spectral_deconvolve(rec, sweep)
    win, _ = window_ir(ir, measurement.IR_LENGTH, return_device=True)
    steps = (
        ("whole path", lambda: measurement.run(rec, sweep)),
        ("spectral_deconvolve", lambda: spectral_deconvolve(rec, sweep)),
        ("window_ir", lambda: window_ir(ir, measurement.IR_LENGTH, return_device=True)),
        ("complex_smoothing", lambda: complex_smoothing(
            win, measurement.OCTAVE_FRACTION, SmoothingDomain.RealImaginary)),
    )
    for label, fn in steps:
        profile_call(f"TF {label}, kernels", fn, runs)
        profile_call(f"TF {label}, plain paths", plain_paths(fn), runs)


def profile_fb(dev, runs: int) -> None:
    from ..classes.filterbank import _sos_bank_or_none
    from ..ops import cuda_iir_bank
    from ..standard.enums import FilterBankMode
    from ..standard.resampling import resample
    from . import filterbank_chain as fc

    lr, gt, third = fc.banks()
    sig = fc.signal(device=dev)
    x = sig._x
    for name, fb in (("gammatone (16 complex bands)", gt), ("1/3 octave (28 bands)", third)):
        bank = _sos_bank_or_none(fb.filters)
        ops, _ = iir_block.bank_kernel_stages(bank, x.shape[-1], dev)
        P = 2 if np.iscomplexobj(bank) else 1
        out = torch.empty((P, len(bank)) + tuple(x.shape), device=dev)
        for label, fn in (("kernel", cuda_iir_bank.sosfilt_bank_lead_cuda),
                          ("plain", cuda_iir_bank.sosfilt_bank_lead_plain)):
            profile_call(f"B3 bank {label}, {name}, 64 x 441000",
                         lambda fn=fn: fn(ops, x, out), runs)
        del out
    steps = (
        ("whole path", lambda: fc.run(sig, lr, gt, third)),
        ("LR crossover", lambda: lr.filter_signal(sig, FilterBankMode.Parallel)),
        ("gammatone", lambda: gt.filter_signal(sig, FilterBankMode.Parallel)),
        ("resample", lambda: resample(sig, fc.FS // 3)),
        ("1/3 octave", lambda: third.filter_signal(sig, FilterBankMode.Parallel)),
    )
    for label, fn in steps:
        profile_call(f"config-3 {label}, kernels", fn, runs)
        profile_call(f"config-3 {label}, plain paths", plain_paths(fn), runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5, help="profiled calls per case")
    ap.add_argument("--case", choices=("chain", "das", "tf", "fb", "all"), default="all")
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
    for name in ("framing", "iir_lead", "das_map", "banded", "iir_bank"):
        _cuda.load(name)

    dev = torch.device("cuda", 0)
    if args.case in ("das", "all"):
        profile_das(dev, args.runs)
    if args.case in ("tf", "all"):
        profile_tf(dev, args.runs)
    if args.case in ("fb", "all"):
        profile_fb(dev, args.runs)
    if args.case in ("das", "tf", "fb"):
        return 0
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
        kernels = "B1 + B2" if bank == "per_band" else "B1 + B3"
        profile_call(f"chain {bank} ({kernels})", lambda: headline.run(x, exc, bank=bank),
                     args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

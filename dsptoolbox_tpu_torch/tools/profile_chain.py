"""Where the port's time goes on a CUDA device.

    python -m dsptoolbox_tpu_torch.tools.profile_chain [--runs 20] [--case chain das bf tf tfa fb ra c2 feat pipeline | all]

``chain``: at the measurement chain's shapes (16 signals × 8 s at 48 kHz,
float32) it profiles, with `torch.profiler`, the framing kernel, the IIR
lead kernel on one crossover band (each against its plain version) and on
all four (its passes by kernel name: x·M, the three chain launches, the
output pass), and the whole chain in both bank modes; and it times the
host's steps of a framing call (`host_breakdown`).

``das``: the framing kernel (B1) against its plain version at the Welch
CSM's shape of the 10 s × 48 kHz recording (64 × 480,000 samples, L =
1024, hop 512, detrend), the DAS map kernel against its plain version on
the DAS path's own shapes (10 and 30 bins × 64 mics × 900 points) and on
the full sweep (513 bins), and the acoustic-camera map
(`tools.camera`, 64 mics, 900 points, 2 kHz third octave) on a 0.5 s ×
16 kHz and a 10 s × 48 kHz recording: the map with the CSM cached, and CSM +
map, each through the kernels and on the plain paths.

``bf``: every config-5 map of the acoustic camera (`tools.camera.map_calls`:
DAS, MVDR loaded and in its reference form on the recording plus sensor
noise, Functional, CLEAN-SC, Orthogonal) on the 0.5 s × 16 kHz and the 10 s
× 48 kHz recording, the CSM cached, through the kernels and on the plain
paths; `BeamformerDASTime` on the 0.5 s recording at grid chunks of 64, 256
and 1024 MB.

``tf``: the transfer-function measurement path (`tools.measurement`: 16
mics × 288,000 samples at 48 kHz → IRs → 65,536-sample windows → 1/3-octave
smoothing over 32,769 bins): the plan's one-time host build and upload,
the banded kernel (B4) against its plain version on the path's plan, and
the whole path and its three steps, through the kernels and on the plain
paths.

``tfa``: the transfer-function analysis path (`tools.tf_analysis`): (a)
H1, H2 and H3 from 10 s of pink noise through 16 room IRs (B1 twice a
call), through the kernels and on the plain paths; (b) each IR step on the
measurement path's IRs (16 × 65,536 windows, the 288,000-sample IRs,
their smoothed spectrum and trimmed IRs), a few calls each: several are
host-bound; (c) the harmonic analysis of a distorted sweep.

``fb``: the filter-bank path (`tools.filterbank_chain`, config 3: 64
channels × 10 s at 44.1 kHz): the filter-bank kernel (B3) against its
plain version at the gammatone and 1/3-octave banks, and the whole path and
its four steps (LR crossover, gammatone, resampling, 1/3 octave), through
the kernels and on the plain paths.

``ra``: room acoustics (`tools.room_measurement`): (a) on the measurement
path's 16 windowed IRs, the octave bank (B3) against its plain path, the
reverberation-time fits, the descriptors with the bass ratio (B2) and the
whole step (host-bound: a few calls each); (b) config 4's battery of 1000
RIRs; (c) the image-source fleet's generator (64 pairs, 272 M images).

``c2``: config 2 (`tools.speech_chain`) at 1 channel × 4 s and 16 channels
× 60 s at 48 kHz: the whole chain (kernels and plain paths) and its steps
(spectrogram, ISTFT, Welch spectrum, append, Welch CSM); then the standard
functions on the 60 s recording (`speech_chain.standard_calls`: loudness,
true peak, RMS, crest factor, latencies, the activity detector,
the envelope), a few calls each.

``feat``: the transforms path (`tools.feature_chain`): every step of (a)
the STFT features, Hilbert and the DFT on config 2's 16 × 60 s session,
(b) the filter-bank spectrum (B3; zero phase, B2), (c) CWT and VQT on 10 s
of music, (d) LPC at 16 kHz, (e) warping and Laguerre on the measurement
path's 16 windows of 65,536 samples, a few calls each; the STFT features
with the session's STFT computed anew each call.

``pipeline``: each chain of `tools.pipeline_chains` (config 2 at both
sizes, the TF path, config 3, the four crossover bands as `Filter`s)
eager and through `pipeline` (one CUDA graph, captured on the first call,
then replayed), and the graph pool's size.

For each case it prints the device time per kernel and per call, the host
time per call (calls issued without waiting), the wall time per call, the
device's idle share of the wall time, and the median CUDA-event time of a
call issued alone (events around each call, synchronised after it: the
host's time up to the launch included). Needs a CUDA device; builds the
kernels from ``csrc/`` first.
"""

from __future__ import annotations

import argparse
import statistics
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


def profile_call(label: str, fn, runs: int, host_calls: int = 50, event_calls: int = 20,
                 warm: int = 3) -> dict:
    """Device time per kernel (torch.profiler) over ``runs`` calls, host and
    wall time per call over ``host_calls``, CUDA-event time over
    ``event_calls``, after ``warm`` warm-up calls; printed, and returned as
    ``{"busy_us", "host_us", "wall_us", "idle", "events_ms"}`` a call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # the trace may miss a kernel or two of the run (the profiler warns that
    # it clears its events at the end of a cycle), so each kernel's time is
    # also given per launch it recorded
    rows = [
        (e.key, _device_us(e) / runs, e.count, _device_us(e) / e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    n = host_calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    host = (t1 - t0) / n * 1e6
    wall = (t2 - t0) / n * 1e6

    events = []
    for _ in range(event_calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))

    idle = max(0.0, 1 - busy / wall)
    print(f"===== {label}")
    print(f"device busy {busy:.1f} us/call; host {host:.1f} us/call; "
          f"wall {wall:.1f} us/call; device idle share "
          f"{idle:.3f}; CUDA events "
          f"{statistics.median(events):.4f} ms/call")
    for key, us, count, per_launch in rows[:16]:
        print(f"  {us:10.1f} us/call  {per_launch:10.1f} us/launch x{count:<4d} {key[:80]}")
    return {"busy_us": busy, "host_us": host, "wall_us": wall, "idle": idle,
            "events_ms": statistics.median(events)}


def host_breakdown(x, win, step: int, pad: int) -> None:
    """Host µs per call of the framing wrapper and of its steps at one
    shape, each step timed alone over many calls issued without waiting
    (the entry point called with B = 0 returns at its checks, before any
    launch: the ``ctypes`` call alone)."""
    from ..ops.framing import compute_number_frames

    kern = cuda_framing._KERNEL
    L, T = win.shape[0], x.shape[-1]
    K = compute_number_frames(L, step, T + 2 * pad, True)[0]
    fpb = cuda_framing.frames_per_block(L, step, K)
    out = torch.empty(x.shape[:-1] + (K, L), device=x.device)
    ptrs = (x.data_ptr(), win.data_ptr(), out.data_ptr())
    rows = x.numel() // T
    kern.launch(0, *ptrs, rows, T, pad, step, L, K, 0, fpb)
    steps = (
        ("wrapper (checks, allocation, launch)",
         lambda: cuda_framing.windowed_frames_cuda(x, win, step, False, pad)),
        ("_cuda.Kernel.launch (ctypes call and kernel launch)",
         lambda: kern.launch(0, *ptrs, rows, T, pad, step, L, K, 0, fpb)),
        ("ctypes call alone (B = 0)",
         lambda: kern._fn(*ptrs, 0, T, pad, step, L, K, 0, fpb,
                          torch._C._cuda_getCurrentRawStream(0))),
        ("output allocation (new_empty)", lambda: x.new_empty(out.shape)),
        ("current device and stream handle",
         lambda: (torch.cuda.current_device(), torch._C._cuda_getCurrentRawStream(0))),
        ("frame count and partition",
         lambda: cuda_framing.frames_per_block(
             L, step, compute_number_frames(L, step, T + 2 * pad, True)[0])),
    )
    print(f"===== host per call, framing wrapper's steps, x {tuple(x.shape)} L={L}")
    for label, fn in steps:
        n = 200
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        print(f"  {host:8.2f} us  {label}")


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
    # B1 at the Welch CSM of the 10 s x 48 kHz recording: 64 mics, the
    # Signal's default window of 1024 and 50 % overlap, detrend
    x = torch.from_numpy(rng.standard_normal((64, 10 * FS)).astype(np.float32)).to(dev)
    win = torch.as_tensor(get_window(Window.Hann, 1024), dtype=torch.float32, device=dev)
    for name, fn in (("kernel", cuda_framing.windowed_frames_cuda),
                     ("plain", cuda_framing.windowed_frames_plain)):
        profile_call(f"B1 framing {name}, Welch CSM shape (64, {10 * FS}) L=1024 "
                     f"step=512 detrend", lambda fn=fn: fn(x, win, 512, True), runs)
    del x
    g = camera.grid()
    diff = SteeringVector().get_amp_diff(g, camera.planar_array())[1]
    # B5 at the DAS path's own shapes (the 10 s x 48 kHz and 0.5 s x 16 kHz
    # recordings' 10 and 30 bins of the 2 kHz third octave) and at the full
    # 513-bin sweep; 64 mics, 900 points
    for F in (10, 30, 513):
        M, G = diff.shape
        C = rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M))
        C = (C + np.conj(np.swapaxes(C, -1, -2))) / 2
        amp = rng.uniform(0.5, 1.0, (M, G))
        k = np.arange(F) * (FS / 1024) * 2 * np.pi / 343
        das = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
               for a in (amp, diff, k, C.real, C.imag)]
        profile_call(f"B5 DAS map kernel, {F} bins x {M} mics x {G} points",
                     lambda das=das: cuda_das.das_map_cuda(*das), runs)
        profile_call(f"B5 DAS map plain, {F} bins x {M} mics x {G} points",
                     lambda das=das: cuda_das.das_map_plain(*das), runs)
    for seconds, fs in ((0.5, 16000), (10, FS)):
        sig = camera.array_signal(seconds, fs, dev, g)
        beam = camera.beamformer(sig, g)

        def one_map():
            return beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION)

        def csm_and_map():
            sig.get_csm(force_computation=True, return_device=True)
            return one_map()

        label = f"DAS path {seconds} s x {fs} Hz x 64 mics"
        profile_call(f"{label}, map (CSM cached), kernels", one_map, runs)
        profile_call(f"{label}, map (CSM cached), plain paths", plain_paths(one_map), runs)
        profile_call(f"{label}, CSM + map, kernels", csm_and_map, runs)
        profile_call(f"{label}, CSM + map, plain paths", plain_paths(csm_and_map), runs)


def profile_bf(dev, runs: int) -> None:
    from ..beamforming import beamforming as bfm
    from . import camera

    g = camera.grid()
    for seconds, fs in ((0.5, 16000), (10, FS)):
        sig = camera.array_signal(seconds, fs, dev, g)
        calls = camera.map_calls(sig, g, camera.with_sensor_noise(sig))
        label = f"config 5 {seconds} s x {fs} Hz x 64 mics x {g.number_of_points} points"
        for name, fn in calls.items():
            # CLEAN-SC's loop takes tens of ms a map: fewer calls
            n = min(runs, 5) if name == "clean_sc" else runs
            for mode, call in (("kernels", fn), ("plain paths", plain_paths(fn))):
                profile_call(f"{label}, {name} (CSM cached), {mode}", call, n,
                             host_calls=max(n, 5), event_calls=max(n, 5))
        if seconds != 0.5:
            continue
        # DAS-time at grid chunks of 64 MB (the JAX package's budget) and
        # larger: fewer chunks, fewer launches
        default = bfm._DAS_TIME_CHUNK_BYTES
        try:
            for budget in (64e6, 256e6, 1024e6):
                bfm._DAS_TIME_CHUNK_BYTES = budget
                beam = camera.time_beamformer(sig, g)
                beam.get_beamformer_output()
                profile_call(f"{label}, das_time, {len(beam._das_time_cache[2])} chunks of "
                             f"{budget:.3g} B", beam.get_beamformer_output, min(runs, 5),
                             host_calls=5, event_calls=5)
        finally:
            bfm._DAS_TIME_CHUNK_BYTES = default


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


def profile_tfa(dev, runs: int) -> None:
    from ..transfer_functions import compute_transfer_function, trim_ir
    from . import measurement
    from . import tf_analysis as tfa

    rec, noise = tfa.noise_measurement()
    label = f"TF analysis (a) {rec.number_of_channels} ch x {rec.length_samples}"
    for mode in tfa.MODES:
        def fn(m=mode):
            return compute_transfer_function(rec, noise, tfa.WELCH_LENGTH, m)

        profile_call(f"{label}: compute_transfer_function {mode.name} (B1 x 2), kernels",
                     fn, runs)
        profile_call(f"{label}: compute_transfer_function {mode.name}, plain paths",
                     plain_paths(fn), runs)
    del rec, noise
    sweep = measurement.excitation()
    ir, windowed, _, smoothed = measurement.run(
        measurement.recording(sweep, measurement.room_irs()[0]), sweep)
    trimmed = trim_ir(ir)[0]
    # the IR steps, several host-bound: a few calls each
    few = dict(runs=3, host_calls=3, event_calls=5, warm=1)
    label = f"TF analysis (b) {windowed.number_of_channels} x {windowed.length_samples}"
    for name, fn in tfa.ir_calls(ir, windowed, smoothed, trimmed).items():
        profile_call(f"{label}: {name}", fn, **few)
    rec0, sweep0, length_s = tfa.distorted_recording()
    profile_call("TF analysis (c) spectral_deconvolve + harmonics + "
                 "harmonic_distortion_analysis",
                 lambda: tfa.harmonic_analysis(rec0, sweep0, length_s), **few)


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


def profile_ra(dev, runs: int) -> None:
    from ..room_acoustics import batch_synthetic_rirs
    from ..transfer_functions import spectral_deconvolve, window_ir
    from . import measurement
    from . import room_measurement as rm

    sweep = measurement.excitation()
    rec = measurement.recording(sweep, measurement.room_irs()[0])
    win, _ = window_ir(spectral_deconvolve(rec, sweep), measurement.IR_LENGTH,
                       return_device=True)
    bank = rm.octave_bank(measurement.FS)
    bands = rm.octave_bands(win, bank)
    label = f"room (a) {win.number_of_channels} IRs x {win.length_samples}"
    profile_call(f"{label}: octave bank (B3), kernels", lambda: rm.octave_bands(win, bank), runs)
    profile_call(f"{label}: octave bank, plain paths",
                 plain_paths(lambda: rm.octave_bands(win, bank)), runs)
    # the host-bound steps take seconds a call: few calls each
    few = dict(runs=2, host_calls=2, event_calls=3, warm=1)
    for what, fn in (("RT fits (4 modes)", lambda: rm.band_reverb_times(bands)),
                     ("descriptors + bass ratio (B2)", lambda: rm.channel_descriptors(win)),
                     ("whole step", lambda: rm.measured_room(win, bank))):
        profile_call(f"{label}: {what}, kernels", fn, **few)
    rirs = torch.from_numpy(rm.battery_rirs()).to(dev)
    profile_call(f"room (b) config 4, {tuple(rirs.shape)}", lambda: rm.battery(rirs), runs)
    room = rm.room()
    s, r = rm.fleet_positions()
    profile_call(f"room (c) ISM fleet generator, {len(s)} pairs",
                 lambda: batch_synthetic_rirs(room, s, r, rm.FLEET_FS, rm.FLEET_SECONDS),
                 runs=3, host_calls=3, event_calls=5, warm=1)


def profile_c2(dev, runs: int) -> None:
    from ..standard import append_signals
    from ..transforms import istft
    from . import speech_chain as sc

    for C, seconds in (sc.SPEECH, sc.MINUTE):
        sig = sc.signal(C, seconds)
        label = f"config 2, {C} ch x {seconds:g} s"
        _, _, S = sig.get_spectrogram(return_device=True)
        y = istft(S, original_signal=sig)
        steps = (
            ("whole chain", lambda: sc.run(sig)),
            ("get_spectrogram (B1)", lambda: sig.get_spectrogram(force_computation=True, return_device=True)),
            ("istft", lambda: istft(S, original_signal=sig)),
            ("get_spectrum, Welch (B1)", lambda: sig.get_spectrum(return_device=True)),
            ("append_signals", lambda: append_signals([sig, y])),
            ("get_csm of the appended signal, Welch (B1)",
             lambda: append_signals([sig, y]).get_csm(return_device=True)),
        )
        for what, fn in steps:
            profile_call(f"{label}: {what}, kernels", fn, runs, host_calls=10, event_calls=10)
        profile_call(f"{label}: whole chain, plain paths", plain_paths(steps[0][1]), runs,
                     host_calls=10, event_calls=10)
        del S, y
    # the standard functions on the 60 s recording: a few calls each
    for name, fn in sc.standard_calls(sig).items():
        profile_call(f"standard, {C} ch x {seconds:g} s: {name}", fn, runs=2, host_calls=3,
                     event_calls=5, warm=1)


def profile_feat(dev, runs: int) -> None:
    from . import feature_chain as fc
    from . import measurement
    from . import speech_chain as sc

    sweep = measurement.excitation()
    _, windowed, _, _ = measurement.run(
        measurement.recording(sweep, measurement.room_irs()[0]), sweep)
    session = sc.signal(*sc.MINUTE)
    music = fc.music()
    lpc_sig = fc.lpc_signal(session)
    few = dict(runs=min(runs, 5), host_calls=5, event_calls=5, warm=1)
    for name, fn in fc.calls(session, music, lpc_sig, windowed).items():
        if name in fc.STFT_STEPS:
            step = (lambda f=fn: (session._cache.clear(), f()))  # the STFT included
        else:
            step = fn
        profile_call(f"features {name}", step, **few)


def profile_pipeline(dev, runs: int) -> None:
    from .. import pipeline
    from . import pipeline_chains as pc

    for ch in pc.chains(dev):
        ins = ch.inputs(0)
        run = pipeline(ch.fn)
        t0 = time.perf_counter()
        run(*ins)
        torch.cuda.synchronize()
        print(f"===== pipeline {ch.name}: warm-up, capture and first replay "
              f"{time.perf_counter() - t0:.3f} s; graph pool "
              f"{run.graph_pool_bytes() / 2**20:.1f} MB")
        n = min(runs, 10)
        profile_call(f"pipeline {ch.name}, eager", lambda: ch.fn(*ins), n, host_calls=n,
                     event_calls=n)
        profile_call(f"pipeline {ch.name}, replay", lambda: run(*ins), n, host_calls=n,
                     event_calls=n)
        del run, ins
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20, help="profiled calls per case")
    ap.add_argument("--case", choices=("chain", "das", "bf", "tf", "tfa", "fb", "ra", "c2",
                                       "feat", "pipeline", "all"),
                    nargs="+", default=["all"])
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
    for name in ("framing", "das_map", "banded", "iir_bank"):
        _cuda.load(name)
        for line in _cuda.BUILD_LOG.get(name, {}).get("log", "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}")

    dev = torch.device("cuda", 0)
    cases = ({"chain", "das", "bf", "tf", "tfa", "fb", "ra", "c2", "feat", "pipeline"}
             if "all" in args.case else set(args.case))
    if "das" in cases:
        profile_das(dev, args.runs)
    if "bf" in cases:
        profile_bf(dev, args.runs)
    if "tf" in cases:
        profile_tf(dev, args.runs)
    if "tfa" in cases:
        profile_tfa(dev, args.runs)
    if "fb" in cases:
        profile_fb(dev, args.runs)
    if "ra" in cases:
        profile_ra(dev, args.runs)
    if "c2" in cases:
        profile_c2(dev, args.runs)
    if "feat" in cases:
        profile_feat(dev, args.runs)
    if "pipeline" in cases:
        profile_pipeline(dev, args.runs)
    if "chain" not in cases:
        return 0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((BATCH, T)).astype(np.float32)).to(dev)
    exc = torch.fft.rfft(
        torch.from_numpy(rng.standard_normal(T).astype(np.float32)).to(dev)
    )
    win = torch.as_tensor(get_window(Window.Hann, 1024), dtype=torch.float32, device=dev)
    leads = []
    for sos in headline.crossover_bank(FS):
        key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
        ops = iir_block.operators_to_torch(
            dict(zip(("HmatT", "GyT", "ALT", "MT"), iir_block._block_operators(key, L_IIR)),
                 zi=sosfilt_zi(sos)[None].repeat(BATCH, 0)),
            dev, torch.float32,
        )
        leads.append((ops["HmatT"], ops["GyT"], ops["ALT"], ops["MT"],
                      x.reshape(BATCH, -1, L_IIR), ops["zi"].reshape(BATCH, -1)))
    lead = leads[1]

    profile_call("B1 framing kernel, STFT shapes",
                 lambda: cuda_framing.windowed_frames_cuda(x, win, 512, False, 512),
                 args.runs)
    profile_call("B1 framing plain",
                 lambda: cuda_framing.windowed_frames_plain(x, win, 512, False, 512),
                 args.runs)
    host_breakdown(x, win, 512, 512)
    profile_call("B2 lead kernel, band 1", lambda: cuda_iir.sosfilt_lead_cuda(*lead),
                 args.runs)
    profile_call("B2 lead plain, band 1", lambda: cuda_iir.sosfilt_lead_plain(*lead),
                 args.runs)
    profile_call("B2 lead kernel, four bands",
                 lambda: [cuda_iir.sosfilt_lead_cuda(*a) for a in leads], args.runs)
    for bank in ("per_band", "banked"):
        kernels = "B1 + B2" if bank == "per_band" else "B1 + B3"
        profile_call(f"chain {bank} ({kernels})", lambda: headline.run(x, exc, bank=bank),
                     args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

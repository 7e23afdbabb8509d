"""Smoke run of the PyTorch/CUDA port (`dsptoolbox_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``dsptoolbox_tpu_torch/csrc`` (one
``nvcc`` per source, started together, with the FLAC codec's ``g++``) and
drives the port's paths:

- the measurement chain (`dsptoolbox_tpu_torch.headline.run`: 16 signals ×
  8 s at 48 kHz, STFT + 4-band crossover + deconvolution; ``per_band``
  runs B1 + B2, ``banked`` B1 + B3): the framing (B1) and IIR lead (B2,
  one band of the filter-bank kernel's passes with a start state) kernels
  are held against their plain PyTorch versions at the chain's shapes and
  against scipy's float64 sosfilt (B1 also at the DAS path's Welch CSM
  shape with detrend and at frames of 2^16 and 2^18 samples, and timed at
  the chain's and the CSM's shapes; B2 also on a 7-block input; each band
  prints its output pass), the chain against the same chain on the plain
  paths and against scipy/numpy in float64;
- the acoustic-camera DAS map (`dsptoolbox_tpu_torch.tools.camera`: 64 mics,
  900 grid points, `BeamformerDASFrequency.get_beamformer_map(2000, 3)`) on
  a 0.5 s × 16 kHz and a 10 s × 48 kHz recording: the DAS map kernel (B5)
  is held against its plain version on the full 513-bin sweep and ragged
  shapes (Hermitian C) and on a non-Hermitian C at the path's 10 and 30
  bins, M = 1 and M = 160 (each case prints the kernel's plan; two launches
  must give the same bits, and at 10 bins every SM at least 16 warps), and
  timed there, at the two recordings' own shapes (also the library
  yardstick: the GEMM part on cuBLAS fp32, steering pre-built) and at M =
  160, the map against the plain path and the source's position;
- config 5, every map of the acoustic camera on both recordings
  (`tools.camera.map_calls`): DAS, MVDR (loaded, and its reference form on
  the recording plus sensor noise), Functional, CLEAN-SC (128 iterations),
  Orthogonal (32 eigenvalues), and `BeamformerDASTime` on the 0.5 s one:
  counted (B5 once for DAS, MVDR's reference form, Functional and
  CLEAN-SC's initial map), B5 against its plain version at those maps'
  matrices, each map against the plain paths and a float64 numpy oracle on
  the same CSM with its argmax (CLEAN-SC's device loop against the float64
  host loop on every bin, Orthogonal's picks against the float64 maxima),
  DAS-time against a float64 direct convolution on 16 points; each map
  timed against the plain paths with its device idle share;
- the transfer-function measurement (`dsptoolbox_tpu_torch.tools.measurement`:
  a 5 s SyncLog sweep recorded by 16 microphones at 48 kHz, deconvolved,
  windowed to 65,536 samples and 1/3-octave smoothed over 32,769 bins): the
  banded smoothing kernel (B4) is held against its plain version at the
  path's plan and ragged shapes, the path against the plain paths, a
  float64 numpy deconvolution, the float64 host smoothing and the known
  propagation delays; 1/6 octave and the MagnitudePhase and
  EquivalentComplex domains against the float64 host smoothing too;
- the transfer-function analysis path (`dsptoolbox_tpu_torch.tools.tf_analysis`,
  on the measurement's IRs): H1, H2 and H3 with their coherence from 10 s of
  pink noise through the 16 room IRs (B1 counted, two launches a call, and
  held against its plain version at the path's frames), against the plain
  paths and float64 scipy; every IR step (trimming, latency, averaging,
  minimum phase, group delays, windows, frequency-dependent windowing,
  minimum and linear phase from the smoothed magnitude, IR ↔ FIR, the
  crossover merge with a dirac through B2, a spectral difference, a smoothed
  spectrum) against the plain paths, with float64 oracles for the trimming
  indices, the minimum phase, the group delay and the windowing; Farina's
  harmonic analysis of a sweep through a polynomial, its harmonic IRs at
  their times; each step timed;
- the filter-bank path (`dsptoolbox_tpu_torch.tools.filterbank_chain`,
  config 3: 64 channels × 10 s at 44.1 kHz through an LR crossover, the
  16-band gammatone bank, resampling to fs/3 and the 28-band 1/3-octave
  bank): the filter-bank kernel (B3) is held against its plain version at
  the three banks' shapes (the crossover's composite cascades included)
  and ragged shapes (each case prints which output pass it took: the
  tensor cores for blocks up to 128), the path launches it once a bank,
  every band against scipy's float64 sosfilt on 4 channels, the path and
  a gammatone reconstruction against the plain paths;
- room acoustics (`dsptoolbox_tpu_torch.tools.room_measurement`): (a) the
  measurement path's 16 windowed IRs through the 6-band octave bank (B3),
  `reverb_time` in T20, T30, EDT and Adaptive, D50, C80, centre time and the
  bass ratio (zero-phase octaves through B2), the octave bands against
  scipy's float64 sosfilt, the bass ratio's bands against the plain paths
  and scipy's float64 sosfiltfilt, the fits and descriptors against the
  plain paths and a float64 pipeline (each difference reported with whether
  a fit decision flipped); (b) config 4, 1000 RIRs × 8000 samples, against
  the port's float64 run on the CPU; (c) the image-source fleet, 64 pairs
  at a lattice limit of 40 (272 M images), whose rows and a max_order-14
  RIR must have the numpy float64 oracle's support, and every image within
  reach of the kept samples the oracle's sample index;
- config 2 (`dsptoolbox_tpu_torch.tools.speech_chain`: `get_spectrogram` →
  `transforms.istft` → `get_spectrum` → `append_signals` → `get_csm`, pink
  noise from a seed) at 1 channel × 4 s and 16 channels × 60 s at 48 kHz:
  counted (B1: the STFT, the Welch spectrum, the appended signal's Welch
  CSM), B1 against its plain version at the chain's shapes, the ISTFT
  round trip within 1e-5, the outputs against the plain paths and a
  float64 numpy run (also the FFT-method CSM, at 60 s on 2 channels and
  their reconstructions), timed against the plain paths;
- the standard functions on the 60 s recording (`speech_chain.standard_calls`):
  `lufs_integrated` on 5 channels (B2), true peak, RMS, crest factor, the
  latencies of copies shifted by `delay` and `fractional_delay`, the
  activity detector with a zero-phase pre-filter (B2) and the envelope,
  counted, B2's outputs against the plain paths and scipy float64, each
  call against the plain paths (the activity mask's flips against a
  float64 recursion printed), each timed with its device idle share;
- the transforms path (`dsptoolbox_tpu_torch.tools.feature_chain`): (a)
  log-mel (40 bands), MFCC, chroma, Hilbert and the DFT at 31 third-octave
  centres on the 60 s recording, (b) its spectrum through 31 order-8
  third-octave bandpasses in parallel (B3) and in zero phase (B2), (c) CWT
  (64 Morlet scales, plain and synchrosqueezed) and VQT on 10 s of music at
  44.1 kHz, (d) LPC (order 16, Yule-Walker, Burg, synthesis) on the
  recording at 16 kHz, (e) warping ("bark", 4096 samples and the whole
  65,536) and Laguerre on the measurement's 16 windowed IRs: counted (B1,
  B3, B2), each kernel against its plain version at the path's shapes, the
  features against float64 numpy, scipy and direct sums, LPC against
  float64 Burg and Yule-Walker and its synthesis against scipy's lfilter,
  warping and Laguerre against the float64 recursion of the JAX package's
  scans; the device kernels of one warp, Laguerre and LPC synthesis call;
  each step timed;
- the chains of `dsptoolbox_tpu_torch.tools.pipeline_chains` through
  `pipeline`, each captured into one CUDA graph: config 2 at both sizes
  (B1), the transfer-function measurement (B4), config 3 with its amplitude
  constraint (B3) and the four crossover bands as `Filter`s (B2): the
  kernels launched while capturing, the replay against the eager run (2e-5
  scale-relative, TF 1e-4), a second call on other inputs, ``fn`` run at
  most twice, a chain reading a value back raising, eager and replay timed
  in turns with their idle shares and the graph pool's size;
- config 2's session through the file layer
  (`dsptoolbox_tpu_torch.tools.session_files`): written as a 24-bit WAV and
  two 24-bit FLACs and loaded onto the card (equal to the file's numpy
  decode, WAV equal to FLAC), calibrated from a 94 dB SPL calibrator file
  (the factor against a float64 numpy RMS), a stateful ``(b, a)`` lowpass
  (order 4 at 1 kHz, order 6 at 200 Hz) streamed in 60 blocks of 1 s (B2,
  one launch a block) against one call and scipy's float64 ``lfilter``,
  the order-4 zero phase (B2 twice) and a 1023-tap FIR zero phase against
  float64 ``filtfilt``, `plot_spl`'s EMA (B2) and the attack/release
  smoothing (the EMA kernel, `csrc/ema.cu`, against its plain loop and a
  float64 recursion), save/load of the session, a Filter, a FilterBank and
  a Spectrum, and the two calls whose default plot raised (C8); each step
  timed, the host-bound ones with their device idle share.
- the filter-design and streaming path (`dsptoolbox_tpu_torch.tools.realtime_chain`)
  on the same session and the first room IR: the `filterbanks` designs
  against their definitions, the A-weighting and a ten-band EQ, the
  parallel filter (32 pole pairs), the Kautz filter (order 32) and the
  warped FIR (32 taps) through B2, counted a step and held against their
  plain versions at full output and scipy float64 on 2 channels × 10 s;
  the SVF (float64 `linear_recurrence`) against a float64 loop and scipy;
  469 blocks of 1024 through an `IIRFilter` (B2 a block, against scipy)
  and an `ExponentialAverageFilter` (`csrc/ema.cu`'s average form, a launch
  a block, bit-equal to its plain loop over every block, each seeded with
  the kernel's carry); the partitioned FIR of the 16 room IRs, the
  reconstructing 1/3-octave bank (its bands' sum = the delayed input) and
  a QMF crossover against scipy float64; the lattice, warped IIR and
  state-space host loops on 0.1 s; each step timed with its device idle
  share, and `ema.cu`'s average form at (1, 1024) and on one long row.
- the denoise → compress → evaluate path (`dsptoolbox_tpu_torch.tools.effects_chain`)
  on the session gated into bursts and the same with white noise: the
  adaptive and offline spectral subtractors (B1), the compressor (one
  launch of `ema.cu`'s average form, its gain bit-equal to the plain loop
  on six windows of the rows, each from the kernel's carry), the effects
  rack, SNR, SI-SDR (against float64 numpy), the log-spectral and
  Itakura-Saito distances (B1) and fwSNRseg (the gammatone bank, B3, twice,
  then B1) of the denoised and compressed session, and the EQ fitted by
  gradient descent through `Filter` (B2, against scipy float64) and
  `sosfilt_diff`; B1 and B3 against their plain versions at the path's
  shapes; each step timed with its device idle share and the phase's peak
  device memory.
- the parallel layer and every ``mesh=`` keyword (`dsptoolbox_tpu_torch.parallel`)
  on a mesh of four shards of the one card and on `device_mesh()`: the
  session's CSM, Welch, STFT, time-parallel Welch, FIR and energy (B1 a
  shard), the 31-band 1/3-octave bank in Parallel and Summed mode (B3 a
  shard), config 5's map with and without the diagonal removal and the
  513-bin DAS sweep (B5 a shard), config 4's fleet and config 2 (a) through
  `pipeline(mesh=)`, each against the single-device call (and the bank
  against scipy float64), counted, timed sharded and single, with the
  phase's peak device memory; float64 mode's `Filter` against scipy (bit for
  bit, no B2) and the session's lazy spectrogram through `istft` without a
  host copy.

Kernels and paths are timed with CUDA events. Prints a JSON line of
per-kernel results (with each kernel's bound: the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s fp32, 34 TFLOP/s fp64 or, for
fp64 matrix products, 67 TFLOP/s on the fp64 tensor cores; the fp32
Toeplitz products of B2 and B3 and B4's banded product at the faster of 67
TFLOP/s FFMA and three TF32 products at 495 TFLOP/s: the H100 SXM's
peaks), the card's name and
power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is non-zero; without a CUDA device it exits with code 2 before doing
anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

FS = 48000
BATCH = 16
SECONDS = 8
T = FS * SECONDS
WINDOW = 1024
STEP = 512
L_IIR = 128
N_TIMED = 20
KERNELS = ("framing", "das_map", "banded", "iir_bank", "ema", "csm")
# the DAS path: (seconds, sampling rate) of the two recordings
CAMERA_RUNS = ((0.5, 16000), (10, 48000))
# B5 at the full sweep (F, M, G) and two ragged shapes (Hermitian C), and
# on a non-Hermitian C at the DAS path's 10 and 30 bins, M = 1 and M = 160
DAS_SWEEP = (513, 64, 900)
DAS_RAGGED = ((13, 9, 20), (5, 25, 130))
DAS_ANY_CSM = ((10, 64, 900), (30, 64, 900), (2, 1, 5), (3, 160, 70), (30, 160, 900))
# B5 timed against its plain version at M = 160
DAS_M160 = ((3, 160, 70), (30, 160, 900))
# the mesh phase: shards on the one card, and the session cut for the
# time-parallel STFT (each shard a whole number of hops of 512)
MESH_SHARDS = 4
MESH_STFT_T = 4 * 703 * 1024
# config 5's maps (`tools/camera.map_calls`): B5 launches a map, and the
# bound of each against its float64 oracle and the plain paths (scale-
# relative; Orthogonal against the float64 maps of its own picks)
CONFIG5_B5 = {"das": 1, "mvdr": 0, "mvdr_reference": 1, "functional": 1, "clean_sc": 1,
              "orthogonal": 0}
CONFIG5_BOUNDS = {"das": 1e-4, "mvdr": 1e-4, "mvdr_reference": 5e-3, "functional": 5e-3,
                  "clean_sc": 5e-3, "orthogonal": 1e-5}
# timed calls a map where it takes tens of ms or more (CLEAN-SC ~0.5 s)
CONFIG5_TIMED = {"clean_sc": 2, "functional": 5, "orthogonal": 5, "mvdr_reference": 5}
# the DAS path's 10 s x 48 kHz recording: (mics, samples) of its Welch CSM
CSM_SHAPE = (64, 480000)
# the Welch CSM's Gram kernel: X (C, K, F) of config 2's 32 appended
# channels x 60 s and of the camera's 64 mics x 10 s (L = 1024, hop 512)
CSM_GRAM_SHAPES = ((32, 5624, 513), (64, 936, 513))
# B4 ragged shapes: (NB, TR, SPAN, C, F)
BANDED_RAGGED = ((3, 128, 256, 5, 1000), (2, 50, 250, 33, 700))
# H100 SXM peaks (NVIDIA data sheet): device memory, fp32 and fp64 outside
# the tensor cores, fp64 and TF32 on the tensor cores (dense matrix products)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 34e12
FP64_TC_FLOP_S = 67e12
TF32_FLOP_S = 495e12
# ROADMAP C9: non-finite samples of the JAX package's float32 stateful
# lfilter on the session phase's two filters (2 channels x 48,000 samples
# of white noise), asserted by tests/test_torch_iir_ba.py on the CPU (the
# card's machine has no JAX)
C9_NON_FINITE = ("89,464", "95,534")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def rel_err(got, want) -> float:
    import torch

    got = torch.as_tensor(got).cpu()
    want = torch.as_tensor(want).cpu()
    dt = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    got, want = got.to(dt), want.to(dt)
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(n_bytes: float, fp32_flop: float, fp64_flop: float = 0.0,
          fp64_mm_flop: float = 0.0, fp32_mm_flop: float = 0.0,
          tensor_cores: bool = True) -> tuple:
    """``(bound_ms, bound_by)``: the larger of the bytes' time at the
    device-memory rate and the operations' time at the peak rates;
    ``fp64_mm_flop`` counts fp64 matrix products, at the tensor cores'
    rate, ``fp64_flop`` the other fp64 work; ``fp32_mm_flop`` counts fp32
    matrix products at the faster of the FFMA rate and three TF32 products
    (a split at fp32 accuracy) on the tensor cores, or with ``tensor_cores``
    False at the FFMA rate."""
    fp32_mm_s = min(1 / FP32_FLOP_S, 3 / TF32_FLOP_S) if tensor_cores else 1 / FP32_FLOP_S
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = (fp32_flop / FP32_FLOP_S + fp32_mm_flop * fp32_mm_s
             + fp64_flop / FP64_FLOP_S + fp64_mm_flop / FP64_TC_FLOP_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def plain(fn):
    """``fn()`` on the plain PyTorch paths: every kernel switched off."""
    from dsptoolbox_tpu_torch import _config

    with _config.kernels_off():
        return fn()


def time_pair(*fns, n=N_TIMED, warm=3):
    """Median CUDA-event milliseconds of each of ``fns`` (one or more), run
    in turns (a b, b a, ...) after ``warm`` warm-up calls of each."""
    import torch

    for _ in range(warm):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in range(n):
        for j in (order if i % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end))
    return tuple(statistics.median(t) for t in times)


def measurement_phase(dev, rng) -> tuple:
    """B4 and the transfer-function measurement path at full width; returns
    B4's entry of the kernels report and the path's ``(IRs, windowed IRs,
    smoothed Spectrum)``."""
    import numpy as np
    import torch
    from scipy.fft import next_fast_len

    from dsptoolbox_tpu_torch.ops import (
        banded,
        cuda_banded,
        cuda_das,
        cuda_framing,
        cuda_iir,
        cuda_iir_bank,
    )
    from dsptoolbox_tpu_torch.helpers.other import unwrap
    from dsptoolbox_tpu_torch.standard.enums import Window
    from dsptoolbox_tpu_torch.tools import measurement
    from dsptoolbox_tpu_torch.transfer_functions import (
        SmoothingDomain,
        complex_smoothing,
    )
    from dsptoolbox_tpu_torch.transfer_functions import _backend as bk
    from dsptoolbox_tpu_torch.transfer_functions.transfer_functions import (
        regularization_range,
    )

    # 10. the smoothing plan of the path's grid (32,769 bins, 1/3 octave):
    # one-time host build and upload, set-up time
    fs = measurement.FS
    n_bins = measurement.IR_LENGTH // 2 + 1
    freqs = np.fft.rfftfreq(measurement.IR_LENGTH, 1 / fs)
    wy = Window.Hann(3000, True)

    def build_plan(octave):
        key = bk._plan_key(freqs, octave, wy)
        t0 = time.perf_counter()
        plan = bk.device_banded_plan(key, torch.float32, dev)
        torch.cuda.synchronize()
        n_w = sum(seg["slab"].numel() for seg in plan)
        print(f"set-up: B4 plan, {n_bins} bins, 1/{octave} octave: host build and "
              f"upload {time.perf_counter() - t0:.3f} s; spans "
              f"{[seg['span'] for seg in plan]}, "
              f"{sum(seg['slab'].shape[0] for seg in plan)} row tiles, "
              f"{n_w * 4 / 1e6:.1f} MB of slab")
        return plan

    plan = build_plan(measurement.OCTAVE_FRACTION)

    # 11. B4 vs plain at the path's plan (16 complex channels: 32 planes)
    # and ragged shapes. Tolerance: fp32 sums of up to 6912 products
    # (weights in [0, 1] summing to 1, unit-variance x) in two orders
    C = 2 * measurement.CHANNELS
    max_span = max(seg["span"] for seg in plan)
    x_pad = torch.from_numpy(
        rng.standard_normal((n_bins + max_span, C)).astype(np.float32)
    ).to(dev)

    yk = cuda_banded.banded_matmul_cuda(plan, x_pad)
    yp = banded.banded_plan_plain(plan, x_pad)
    torch.cuda.synchronize()
    b4_err = float((yk - yp).abs().max())
    print(f"B4 banded at the path's plan (x {tuple(x_pad.shape)}): max abs err "
          f"{b4_err:.3e} (tol 1e-5)")
    if not b4_err <= 1e-5:
        fail("banded kernel disagrees with its plain version at the path's plan")
    for nb, tr, span, c, f_len in BANDED_RAGGED:
        seg = {"rows": nb * tr, "span": span,
               "slab": torch.from_numpy(
                   rng.standard_normal((nb, tr, span)).astype(np.float32)).to(dev),
               "offsets": torch.from_numpy(
                   rng.integers(0, f_len - span, nb).astype(np.int32)).to(dev)}
        xr = torch.from_numpy(rng.standard_normal((f_len, c)).astype(np.float32)).to(dev)
        err = float((cuda_banded.banded_matmul_cuda([seg], xr)
                     - banded.banded_plan_plain([seg], xr)).abs().max())
        torch.cuda.synchronize()
        print(f"B4 banded ragged (NB, TR, SPAN, C) = {(nb, tr, span, c)}: max abs "
              f"err {err:.3e} (tol 1e-4, as the JAX package's Pallas test)")
        if not err <= 1e-4:
            fail("banded kernel disagrees with its plain version (ragged)")

    # 12. the measurement path at full width, counted
    sweep = measurement.excitation()
    irs, delays = measurement.room_irs()
    rec = measurement.recording(sweep, irs)
    torch.cuda.synchronize()
    modules = {"framing": cuda_framing, "iir_lead": cuda_iir, "das_map": cuda_das,
               "banded": cuda_banded, "iir_bank": cuda_iir_bank}
    for m in modules.values():
        m.launches = 0
    ir, win, starts, sm = measurement.run(rec, sweep)
    torch.cuda.synchronize()
    launched = {name: m.launches for name, m in modules.items()}
    T = rec.length_samples
    label = (f"TF path {measurement.CHANNELS} ch x {T} samples -> "
             f"{measurement.IR_LENGTH} -> 1/{measurement.OCTAVE_FRACTION} octave")
    print(f"{label}: launches {launched}")
    if launched["banded"] == 0:
        fail("the measurement path did not go through the banded kernel")
    for name, got, shape in (("ir", ir.time_data, (T, measurement.CHANNELS)),
                             ("windowed", win.time_data,
                              (measurement.IR_LENGTH, measurement.CHANNELS)),
                             ("smoothed", sm.spectral_data, (n_bins, measurement.CHANNELS))):
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            fail(f"{label} {name}: shape {tuple(got.shape)} or non-finite")
    ref = plain(lambda: measurement.run(rec, sweep))
    for name, got, want in (("ir", ir.time_data, ref[0].time_data),
                            ("windowed", win.time_data, ref[1].time_data),
                            ("smoothed", sm.spectral_data, ref[3].spectral_data)):
        err = rel_err(got, want)
        print(f"{label} {name} vs plain paths: scale-rel {err:.3e} (tol 1e-4)")
        if not err <= 1e-4:
            fail(f"{label}: {name} disagrees with the plain paths")
    # the IR against a float64 numpy deconvolution with the same
    # regularization window (the port's host float64 window function, on
    # the range the port found on the device)
    n_fft = next_fast_len(T, True)
    f_full = np.fft.rfftfreq(n_fft, 1 / fs)
    lo, hi = regularization_range(sweep._spectrum_fft()[1][0], f_full, -30.0)
    eps = bk.regularization_window(
        [lo / np.sqrt(2), lo, hi, min(hi * np.sqrt(2), fs / 2)], f_full)
    num = np.fft.rfft(rec.time_data.double().cpu().numpy(), n=n_fft, axis=0)
    den = np.fft.rfft(sweep.time_data[:, 0].double().cpu().numpy(), n=n_fft)
    ir64 = np.fft.irfft(num * (np.conj(den) / (np.abs(den) ** 2 + eps))[:, None],
                        n=T, axis=0)
    err = rel_err(ir.time_data, ir64)
    print(f"{label} ir vs numpy f64 deconvolution: scale-rel {err:.3e} (tol 2e-5)")
    if not err <= 2e-5:
        fail("the IR disagrees with the float64 deconvolution")
    # the smoothing against the float64 host oracle on the port's window
    sp64 = np.fft.rfft(win.time_data.double().cpu().numpy(), axis=0)
    t0 = time.perf_counter()
    sm64 = bk.complex_smoothing_host(sp64, freqs, measurement.OCTAVE_FRACTION, wy)
    err = rel_err(sm.spectral_data, sm64)
    print(f"{label} smoothed vs float64 host smoothing ({time.perf_counter() - t0:.1f} s "
          f"on the host): scale-rel {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        fail("the smoothed spectrum disagrees with the float64 host smoothing")
    # physical check: each IR peaks at its channel's propagation delay
    peaks = ir.time_data.abs().argmax(dim=0).cpu().numpy()
    off = np.abs(peaks - delays)
    print(f"{label} IR peaks at {peaks.tolist()}, delays {delays.tolist()} "
          f"(tol 1 sample); window starts {starts.cpu().numpy().tolist()}")
    if not off.max() <= 1:
        fail("an IR does not peak at its propagation delay")

    # 13. the same width at 1/6 octave and in two more domains, against the
    # plain paths and the float64 host smoothing. Magnitudes are held at
    # 1e-4 scale-relative. MagnitudePhase smooths the unwrapped phase
    # itself, R ≈ 5e3 rad here: a float32 weighted sum of up to S terms of
    # size ≤ R drifts by ~2^-24·R·sqrt(S) in a random walk, so each path's
    # phase is held at twice that against the float64 smoothing of the
    # phase it smoothed (its own float32 unwrap: at bins near zero the
    # float32 and float64 spectra unwrap to different branches, a property
    # of the domain on float32 data, not of the smoothing).
    # EquivalentComplex takes the angle of the real/imaginary smoothing s1,
    # which cancels where the phase turns within the band: its phase is
    # held where |s1| ≥ 0.1·sqrt(smoothed power), at 2·2^-24·sqrt(S) / 0.1
    # (the sum's relative error over that floor)
    build_plan(6)
    u32 = 2.0**-24
    sp = win.get_spectrum(return_device=True)[1]
    phi = unwrap(sp.angle(), dim=0)
    R = float(phi.abs().max())
    phi64 = np.unwrap(np.angle(sp64), axis=0)
    branches = int((np.abs(phi.double().cpu().numpy() - phi64) > np.pi).sum())
    print(f"phase: range {R:.1f} rad; the float32 unwrap takes another branch "
          f"than the float64 one at {branches} of {phi64.size} bins")
    power64 = bk.complex_smoothing_host(np.abs(sp64) ** 2, freqs, 3, wy)
    cases = (
        (6, SmoothingDomain.RealImaginary, None,
         bk.complex_smoothing_host(sp64, freqs, 6, wy), None, None),
        (3, SmoothingDomain.MagnitudePhase,
         bk.complex_smoothing_host(np.abs(sp64), freqs, 3, wy),
         bk.complex_smoothing_host(phi.double().cpu().numpy(), freqs, 3, wy),
         None, 2 * u32 * R * np.sqrt(max_span)),
        (3, SmoothingDomain.EquivalentComplex, np.sqrt(power64), np.angle(sm64),
         np.abs(sm64) >= 0.1 * np.sqrt(power64), 2 * u32 * np.sqrt(max_span) / 0.1),
    )
    for octave, domain, mag64, ref64, held, tol in cases:
        cuda_banded.launches = 0
        got = complex_smoothing(win, octave, domain).spectral_data
        torch.cuda.synchronize()
        n = cuda_banded.launches
        want = plain(lambda: complex_smoothing(win, octave, domain)).spectral_data
        line = (f"smoothing 1/{octave} {domain.name}, {n} B4 launches: vs plain "
                f"scale-rel {rel_err(got, want):.3e}")
        ok = n > 0
        for side, g in (("kernel", got), ("plain", want)):
            if mag64 is None:  # RealImaginary: the complex values
                err = rel_err(g, ref64)
                line += f"; {side} vs float64 scale-rel {err:.3e} (tol 1e-4)"
                ok = ok and err <= 1e-4
                continue
            g = g.cpu().numpy().astype(np.complex128)
            m_err = rel_err(np.abs(g), mag64)
            dphi = np.abs(np.angle(g * np.exp(-1j * ref64)))
            dphi = dphi[held] if held is not None else dphi
            line += (f"; {side} vs float64 magnitude {m_err:.3e} (tol 1e-4), "
                     f"phase {dphi.max():.3e} rad (tol {tol:.3e})")
            ok = ok and m_err <= 1e-4 and dphi.max() <= tol
        if held is not None:
            line += f"; phase held at {int(held.sum())} of {held.size} bins"
        print(line)
        if not ok:
            fail(f"smoothing 1/{octave} {domain.name} disagrees with the float64 "
                 "smoothing")

    # 14. times: B4 kernel, plain and one library call (torch.bmm on the
    # windows gathered beforehand: not the same function, a lower bound on
    # what cuBLAS needs); the whole path with and without the kernel
    b4_ms, b4_plain = time_pair(lambda: cuda_banded.banded_matmul_cuda(plan, x_pad),
                                lambda: banded.banded_plan_plain(plan, x_pad))
    xgs = [x_pad[seg["offsets"].long()[:, None]
                 + torch.arange(seg["span"], device=dev)] for seg in plan]
    lib_ms, _ = time_pair(
        lambda: [torch.bmm(seg["slab"], g) for seg, g in zip(plan, xgs)],
        lambda: cuda_banded.banded_matmul_cuda(plan, x_pad),
    )
    n_w = sum(seg["slab"].numel() for seg in plan)
    n_out = sum(seg["slab"].shape[0] * seg["slab"].shape[1] for seg in plan)
    b4_bound, b4_by = bound(4 * (n_w + x_pad.numel() + n_out * C + len(plan)), 0.0,
                            fp32_mm_flop=2.0 * n_w * C)
    print(f"time B4 banded, {len(plan)} segments, {n_w} weights x {C} columns: "
          f"kernel {b4_ms:.4f} ms ({4 * n_w / (b4_ms * 1e-3) / 1e12:.3f} TB/s of "
          f"slab), plain {b4_plain:.4f} ms, library bmm (pre-gathered) "
          f"{lib_ms:.4f} ms, bound {b4_bound:.4f} ms ({b4_by})")
    k_ms, p_ms = time_pair(lambda: measurement.run(rec, sweep),
                           lambda: plain(lambda: measurement.run(rec, sweep)))
    audio_s = measurement.CHANNELS * T / fs
    print(f"time {label}: kernels {k_ms:.4f} ms ({audio_s / (k_ms * 1e-3):.1f} "
          f"audio-s/s), plain paths {p_ms:.4f} ms "
          f"({audio_s / (p_ms * 1e-3):.1f} audio-s/s)")
    return {"name": "banded_matmul", "route": "cuda",
            "source": "dsptoolbox_tpu_torch/csrc/banded.cu",
            "replaces": "dsptoolbox_tpu/ops/pallas_banded.py:43",
            "launches": launched["banded"], "max_abs_err": b4_err,
            "ms": b4_ms, "plain_ms": b4_plain, "bound_ms": b4_bound,
            "bound_by": b4_by, "library_ms": lib_ms}, (ir, win, sm)


def output_leaves(obj) -> list:
    """The arrays in a call's output, in order: a Signal's time data, a
    Spectrum's data (and coherence), tensors and numpy arrays, through
    tuples, lists and dicts."""
    import numpy as np
    import torch

    from dsptoolbox_tpu_torch.classes import Signal, Spectrum

    if isinstance(obj, Signal):
        return [obj.time_data]
    if isinstance(obj, Spectrum):
        return [obj.spectral_data] + ([obj.coherence] if obj.has_coherence else [])
    if isinstance(obj, (tuple, list)):
        return [leaf for item in obj for leaf in output_leaves(item)]
    if isinstance(obj, dict):
        return [leaf for item in obj.values() for leaf in output_leaves(item)]
    if torch.is_tensor(obj) or isinstance(obj, np.ndarray):
        return [obj]
    return [np.asarray(obj)]


def np_min_phase_ir(x, padding_factor: int, mag=None):
    """The real-cepstrum minimum-phase IR of ``x (T, C)`` in float64 numpy
    (the method of `helpers/minimum_phase.py`), from ``x``'s float64
    spectrum or from the given magnitude ``(n, C)`` (exact zeros floored
    at float32's resolution of the channel, as the port floors them)."""
    import numpy as np
    from scipy.fft import next_fast_len

    T = x.shape[0]
    n = next_fast_len(max(T * padding_factor, T), False)
    if mag is None:
        mag = np.abs(np.fft.fft(x, n=n, axis=0))
    else:
        mag = np.where(mag == 0, mag.max(axis=0) * np.finfo(np.float32).eps, mag)
    y = np.real(np.fft.ifft(np.log(mag), axis=0))
    half = n // 2 if n % 2 == 0 else (n + 1) // 2
    y[1:half] *= 2.0
    y[half + (n % 2 == 0):] = 0.0
    return np.real(np.fft.ifft(np.exp(np.fft.fft(y, axis=0)), axis=0))[:T]


def tf_analysis_phase(dev, measured: tuple, card: str) -> dict:
    """The transfer-function analysis path (`tools/tf_analysis.py`) at full
    width on the measurement phase's IRs ``measured = (ir, windowed,
    smoothed)``: (a) H1, H2 and H3 with their coherence from 10 s of pink
    noise through the 16 room IRs (B1 counted: two launches a call), held
    against the plain paths (2e-5 scale-relative, DC left out: a
    noise/noise ratio under detrend) and float64 scipy (5e-4 from bin 2);
    B1 against its plain version at the path's frames; (b) every IR step of
    `tf_analysis.ir_calls` against the plain paths (2e-5), with trim_ir's
    indices against the host float64 run, find_ir_latency at the known
    delays, min_phase_ir against a float64 numpy cepstrum (1e-4), the
    analytic group delay against scipy's float64 one and the FDW against a
    float64 direct sum on 64 bins (2e-4); (c) the harmonic analysis of a
    distorted sweep, its harmonic IRs peaking at `get_harmonic_times`'
    samples. Each step timed with CUDA events. Returns B1's launches and
    error on the path and the times."""
    import numpy as np
    import torch
    from scipy.fft import next_fast_len
    from scipy.signal import csd, welch
    from scipy.signal import group_delay as scipy_group_delay

    from dsptoolbox_tpu_torch.ops import cuda_framing, cuda_iir
    from dsptoolbox_tpu_torch.ops.framing import compute_number_frames
    from dsptoolbox_tpu_torch.ops.windows import get_window
    from dsptoolbox_tpu_torch.standard.enums import Window
    from dsptoolbox_tpu_torch.tools import measurement
    from dsptoolbox_tpu_torch.tools import tf_analysis as tfa
    from dsptoolbox_tpu_torch.transfer_functions import _backend as bk
    from dsptoolbox_tpu_torch.transfer_functions import (
        compute_transfer_function,
        group_delay,
        trim_ir,
    )

    t_phase = time.perf_counter()
    ir, windowed, smoothed = measured
    fs = tfa.FS
    out = {"times": []}

    def timed(label: str, fn, n: int = N_TIMED, plain_too: bool = False,
              bound_ms: tuple | None = None) -> None:
        fns = (fn, lambda: plain(fn)) if plain_too else (fn,)
        ms = time_pair(*fns, n=n, warm=1)
        line = f"time TF analysis {label}: {ms[0]:.4f} ms"
        if plain_too:
            line += f", plain paths {ms[1]:.4f} ms"
        if bound_ms is not None:
            line += f", bound {bound_ms[0]:.4f} ms ({bound_ms[1]}, {ms[0] / bound_ms[0]:.0f}×)"
        print(f"{line} (median of {n}; {card})")
        out["times"].append({"step": label, "ms": ms[0],
                             "plain_ms": ms[1] if plain_too else None})

    def held(label: str, got, want, tol: float, skip_bins: int = 0) -> None:
        gl, wl = output_leaves(got), output_leaves(want)
        if len(gl) != len(wl):
            fail(f"{label}: {len(gl)} outputs against {len(wl)}")
        err = 0.0
        for g, w in zip(gl, wl):
            g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
            if g.shape != w.shape:
                fail(f"{label}: shape {tuple(g.shape)} against {tuple(w.shape)}")
            if g.ndim and skip_bins:
                g, w = g[skip_bins:], w[skip_bins:]
            if not bool(torch.isfinite(g).all()):
                fail(f"{label}: non-finite output")
            err = max(err, rel_err(g, w))
        print(f"{label} vs plain paths: scale-rel {err:.3e} (tol {tol:g})")
        if not err <= tol:
            fail(f"{label} disagrees with the plain paths")

    # 27. (a) the dual-channel noise measurement, counted
    rec, noise = tfa.noise_measurement()
    torch.cuda.synchronize()
    step = tfa.WELCH_LENGTH // 2
    K = compute_number_frames(tfa.WELCH_LENGTH, step, rec.length_samples)[0]
    label = (f"TF analysis (a) {rec.number_of_channels} ch x {rec.length_samples} samples, "
             f"Welch {tfa.WELCH_LENGTH} ({K} frames)")
    est, per_call = {}, {}
    for mode in tfa.MODES:
        cuda_framing.launches = 0
        est[mode.name] = compute_transfer_function(rec, noise, tfa.WELCH_LENGTH, mode)
        torch.cuda.synchronize()
        per_call[mode.name] = cuda_framing.launches
    print(f"{label}: B1 launches a call {per_call} (expected 2)")
    if not all(per_call.values()):
        fail("compute_transfer_function did not go through the framing kernel")
    if any(n != 2 for n in per_call.values()):
        fail("compute_transfer_function did not frame each signal once")
    out["framing"] = sum(per_call.values())
    win = torch.as_tensor(get_window(Window.Hann, tfa.WELCH_LENGTH), dtype=torch.float32,
                          device=dev)
    yk = cuda_framing.windowed_frames_cuda(rec._x, win, step, True)
    yp = cuda_framing.windowed_frames_plain(rec._x, win, step, True)
    torch.cuda.synchronize()
    out["framing_err"] = float((yk - yp).abs().max())
    print(f"B1 framing at (a)'s frames x {tuple(rec._x.shape)} L={tfa.WELCH_LENGTH} "
          f"step={step} detrend=True: max abs err {out['framing_err']:.3e} (tol 1e-6)")
    if yk.shape != yp.shape or not out["framing_err"] <= 1e-6:
        fail("framing kernel disagrees with its plain version at (a)'s frames")
    del yk, yp
    ref = plain(lambda: tfa.estimators(rec, noise))
    for m in est:
        held(f"{label} {m} and coherence", est[m], ref[m], 2e-5, skip_bins=1)
    # float64 scipy on the same frames: both signals zero-padded as the
    # framing pads them; from bin 2, since the reference removes each
    # frame's mean after the window and scipy before it, which with the
    # Hann window changes bins 0 and 1 only
    n_pad = (K - 1) * step + tfa.WELCH_LENGTH
    x64 = np.pad(noise.time_data[:, 0].double().cpu().numpy(), (0, n_pad - rec.length_samples))
    y64 = np.pad(rec.time_data.double().cpu().numpy(), ((0, n_pad - rec.length_samples), (0, 0)))
    kw = dict(fs=fs, window="hann", nperseg=tfa.WELCH_LENGTH, noverlap=step,
              detrend="constant", axis=0)
    pxx = welch(x64, **kw)[1][:, None]
    pyy = welch(y64, **kw)[1]
    pxy = csd(x64[:, None], y64, **kw)[1]
    want = {"H1": pxy / pxx, "H2": pyy / np.conj(pxy),
            "H3": pxy / np.abs(pxy) * np.sqrt(pyy / pxx)}
    coh64 = np.abs(pxy) ** 2 / pxx / pyy
    for m, h64 in want.items():
        e_h = rel_err(est[m].spectral_data[2:], h64[2:])
        e_c = rel_err(est[m].coherence[2:], coh64[2:])
        print(f"{label} {m} vs scipy float64: scale-rel {e_h:.3e}, coherence {e_c:.3e} "
              "(tol 5e-4)")
        if not (e_h <= 5e-4 and e_c <= 5e-4):
            fail(f"{m} disagrees with scipy's float64 estimate")
    print(f"{label}: mean coherence {float(est['H1'].coherence[2:].mean()):.4f}")
    for mode in tfa.MODES:
        timed(f"(a) compute_transfer_function {mode.name}",
              lambda m=mode: compute_transfer_function(rec, noise, tfa.WELCH_LENGTH, m),
              plain_too=True)
    del rec, noise, est, ref, x64, y64, pxy, pyy

    # 28. (b) IR analysis on the measurement phase's IRs
    label = f"TF analysis (b) on {windowed.number_of_channels} x {windowed.length_samples}"
    trimmed, start, stop = trim_ir(ir)
    host = ir.time_data.double().cpu().numpy()
    idx = np.array([bk.trim_ir_indices(host[:, c], fs, 20e-3)[:2]
                    for c in range(host.shape[1])])
    print(f"{label}: trim_ir [{start}, {stop}) of {ir.length_samples}; host float64 run "
          f"[{int(idx[:, 0].min())}, {int(idx[:, 1].max())})")
    if (start, stop) != (int(idx[:, 0].min()), int(idx[:, 1].max())):
        fail("trim_ir's indices differ from the host float64 run's")
    calls = tfa.ir_calls(ir, windowed, smoothed, trimmed)
    lead_launches = {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        cuda_iir.launches = 0
        got = fn()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        lead_launches[name] = cuda_iir.launches
        held(f"{label} {name} (first call {first_s:.3f} s)", got, plain(fn), 2e-5)
    # the crossover merge's zero-phase Linkwitz-Riley bands run the IIR lead
    # (B2): forward and backward for each band of the IR and of the diracs
    merges = {k: v for k, v in lead_launches.items() if k.startswith("combine_ir_with_dirac")}
    print(f"{label}: B2 launches {merges}; elsewhere "
          f"{sum(lead_launches.values()) - sum(merges.values())}")
    if not all(merges.values()):
        fail("combine_ir_with_dirac did not go through the IIR lead kernel")
    out["iir_lead"] = sum(lead_launches.values())
    _, delays = measurement.room_irs()
    lat = calls["find_ir_latency"]()
    # against the min-phase version the latency falls a sample or so before
    # the direct sound: the diffuse tail is not minimum phase
    print(f"{label}: find_ir_latency {np.round(lat, 3).tolist()}, delays {delays.tolist()} "
          "(tol 2 samples)")
    if not np.abs(lat - delays).max() <= 2.0:
        fail("find_ir_latency is not at the propagation delays")
    # min_phase_ir against the float64 cepstrum of the float32 spectrum's
    # magnitude (1e-5: the method). Above the sweep the IRs' spectra sit
    # ~1e-7 below their peaks, under float32's resolution: the float32 FFT
    # rounds some of those bins to 0 (floored by the port, NaN in the JAX
    # package: ROADMAP C7) and the rest to noise, whose log moves the
    # minimum phase; so against the float64 spectrum's cepstrum it is only
    # printed (CPU: 2.4e-5 on the channels without an exact zero, 3.3e-4 on
    # the others; the card's FFT rounds otherwise)
    x64 = windowed.time_data.double().cpu().numpy()
    n_fft = next_fast_len(windowed.length_samples * tfa.PADDING_FACTOR, False)
    mag32 = torch.fft.fft(windowed._x, n=n_fft, dim=-1).abs().T.double().cpu().numpy()
    zeros = (mag32 == 0).sum(axis=0)
    got = calls["min_phase_ir"]().time_data.double().cpu().numpy()
    err = rel_err(got, np_min_phase_ir(x64, tfa.PADDING_FACTOR, mag32))
    want = np_min_phase_ir(x64, tfa.PADDING_FACTOR)
    by_channel = np.abs(got - want).max(axis=0) / np.abs(want).max()
    print(f"{label} min_phase_ir vs float64 numpy cepstrum of the float32 magnitude: "
          f"scale-rel {err:.3e} (tol 1e-5); exact float32 zeros a channel {zeros.tolist()}; "
          f"vs the float64 spectrum's cepstrum {by_channel[zeros == 0].max():.3e} on the "
          f"channels without one, {by_channel.max():.3e} on all")
    if not err <= 1e-5:
        fail("min_phase_ir disagrees with the float64 cepstrum")
    f, gd = group_delay(windowed, True, 0, False)
    sub = slice(1, None, 64)
    b64 = windowed.time_data.double().cpu().numpy()
    err = max(rel_err(gd[sub, c], scipy_group_delay([b64[:, c], [1.0]], w=f[sub], fs=fs)[1]
                      / fs) for c in range(min(4, b64.shape[1])))
    print(f"{label} analytic group_delay vs scipy float64 (4 channels, every 64th bin): "
          f"scale-rel {err:.3e} (tol 1e-6)")
    if not err <= 1e-6:
        fail("group_delay disagrees with scipy's float64 group delay")
    fdw = calls["window_frequency_dependent"]()
    T = trimmed.length_samples
    bins = np.linspace(1, T // 2, 64).astype(int)
    td64 = trimmed.time_data.double().cpu().numpy()
    f_fdw = np.fft.rfftfreq(T, 1 / fs)[1:]
    alpha = (np.log(1 / float(10 ** (-50.0 / 20)) ** 2) ** 0.5 * (T - 1) / 2
             / np.round(fs / f_fdw * tfa.FDW_CYCLES).astype(int)) ** 2.0
    n_rel = np.arange(T)[:, None] - np.abs(td64).argmax(axis=0)[None, :]
    n = np.arange(T)
    oracle = np.stack([(np.exp(-0.5 * (n_rel / ((T - 1) / 2)) ** 2 * alpha[k - 1])
                        * np.exp(-2j * np.pi * k * n / T)[:, None] * td64).sum(0)
                       for k in bins])
    err = rel_err(fdw.spectral_data[bins], oracle)
    print(f"{label} window_frequency_dependent ({T} samples, {len(f_fdw)} bins) vs float64 "
          f"direct sum on 64 bins: scale-rel {err:.3e} (tol 2e-4)")
    if not err <= 2e-4:
        fail("the frequency-dependent window disagrees with the float64 direct sum")
    # FDW's bound: the IRs read and the spectrum written once; 7 fp32
    # operations a window product (bins × T × C: the exponent's scale, exp,
    # the sample, two rotation products) and 10 a (bin, sample) phase
    C = trimmed.number_of_channels
    fdw_bound = bound(4 * T * C + 8 * (len(f_fdw) + 1) * C,
                      7.0 * len(f_fdw) * T * C + 10.0 * len(f_fdw) * T)
    for name, fn in calls.items():
        fdw = name == "window_frequency_dependent"
        timed(f"(b) {name}", fn, n=5 if fdw else N_TIMED, bound_ms=fdw_bound if fdw else None)

    # 29. (c) harmonic distortion
    rec0, sweep, length_s = tfa.distorted_recording()
    ir_h, harms, analysis = tfa.harmonic_analysis(rec0, sweep, length_s)
    torch.cuda.synchronize()
    label = f"TF analysis (c) sweep {length_s:.4f} s through {tfa.POLYNOMIAL}"
    held(label, (ir_h, harms, analysis),
         plain(lambda: tfa.harmonic_analysis(rec0, sweep, length_s)), 2e-5)
    ts = bk.get_harmonic_times(list(measurement.SWEEP_RANGE_HZ), length_s, tfa.N_HARMONICS + 1)
    L = ir_h.length_samples
    time_harm = np.insert(L + (ts * fs + 0.5).astype(int), 0, L)
    for nh in range(2):  # the polynomial's harmonics: the 2nd and the 3rd
        min_ind = int(time_harm[nh + 1] - (time_harm[nh + 1] - time_harm[nh + 2]) * 0.05)
        peak = int(harms[nh].time_data[:, 0].abs().argmax()) + min_ind
        print(f"{label}: harmonic {nh + 2} peaks at {peak}, get_harmonic_times puts it at "
              f"{time_harm[nh + 1] + 1} (tol 2 samples)")
        if abs(peak - (time_harm[nh + 1] + 1)) > 2:
            fail(f"harmonic {nh + 2} is not at its time")
    sel = (analysis["thd_percent"].frequency_vector_hz > 100) & (
        analysis["thd_percent"].frequency_vector_hz < 5000)
    thd = float(analysis["thd_percent"].spectral_data[torch.as_tensor(sel, device=dev)]
                .median())
    print(f"{label}: median THD 100 Hz - 5 kHz {thd:.3f} % (the polynomial's second "
          "harmonic at -10 dBFS: 0.79 %)")
    timed("(c) spectral_deconvolve + harmonics + harmonic_distortion_analysis",
          lambda: tfa.harmonic_analysis(rec0, sweep, length_s), n=5)
    print(f"TF analysis phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def bank_ragged() -> list:
    """B3's ragged cases ``(label, bank, R, T)``: B = 1 and 5 complex, R =
    1 and 3, T = 3000 and 5000 (not multiples of 128), a 16-section real
    bank (32 state lanes), a 6-section complex bank (24 lanes), a
    1-section real bank (2 lanes), a short input (T = 1000, 7 blocks), a
    block length that is not a multiple of 8 (T = 100: one block of 100),
    and a 9-section complex bank (36 lanes: its first 8 sections in one B3
    stage, the last one per band in another)."""
    import numpy as np
    from scipy.signal import butter

    def cplx(n_bands, sections, radius=0.95):
        poles = radius * np.exp(1j * np.linspace(0.1, 1.0, n_bands * sections))
        bank = np.zeros((n_bands, sections, 6), np.complex128)
        bank[:, :, 0], bank[:, :, 3] = 0.3, 1.0
        bank[:, :, 4] = -poles.reshape(n_bands, sections)
        return bank

    real16 = np.stack([np.concatenate([butter(2, f, output="sos")
                                       for f in np.linspace(0.05 + 0.02 * b, 0.8, 16)])
                       for b in range(2)])
    return [("complex B=1", cplx(1, 4), 1, 3000), ("complex B=5", cplx(5, 4), 3, 5000),
            ("real 16 sections", real16, 3, 3000), ("complex 6 sections", cplx(3, 6), 1, 5000),
            ("real 1 section", butter(2, 0.1, output="sos")[None].repeat(3, 0), 2, 3000),
            ("complex T=1000", cplx(2, 4), 2, 1000), ("complex L=100", cplx(2, 4), 3, 100),
            ("complex 9 sections (split)", cplx(2, 9, 0.9), 2, 3077)]


def bank_bound(ops: dict, R: int) -> tuple:
    """Bytes, fp32 matrix-product, serial fp64 and fp64 matrix-product
    operations that B3 needs for the full blocks of ``R`` rows: x read and
    every band's planes written once, plus the operators; x·h over the
    Toeplitz triangle, L·(L+1)/2 FMAs per block and plane (for FFMA or the
    TF32 tensor cores); in fp64 over the real state lanes, the chain (Ns²
    FMAs per block, serial) and the products x·M and s·G (dense, for the
    fp64 tensor cores)."""
    k = ops["kernel"]
    P, B, L = k["h"].shape
    Ns = k["lanes"]
    blocks = R * ops["n_full"]
    n_bytes = (4 * blocks * L * (1 + P * B) + 4 * k["h"].numel()
               + 8 * (k["M"].numel() + k["A"].numel() + k["G"].numel()))
    fp32 = 2.0 * P * B * blocks * L * (L + 1) / 2
    chain = 2.0 * B * blocks * Ns * Ns
    products = 2.0 * B * blocks * (L * Ns + P * L * Ns)
    return n_bytes, fp32, chain, products


def filterbank_phase(dev, rng) -> dict:
    """B3 and the filter-bank path (config 3) at full width; returns B3's
    entry of the kernels report."""
    import numpy as np
    import torch
    from scipy.signal import sosfilt as scipy_sosfilt

    from dsptoolbox_tpu_torch.filterbanks import auditory_filters_gammatone
    from dsptoolbox_tpu_torch.ops import (
        cuda_banded,
        cuda_das,
        cuda_framing,
        cuda_iir,
        cuda_iir_bank,
        iir_block,
    )
    from dsptoolbox_tpu_torch.classes.filterbank import _sos_bank_or_none
    from dsptoolbox_tpu_torch.standard.enums import FilterBankMode
    from dsptoolbox_tpu_torch.tools import filterbank_chain as fc

    # 15. the configuration: host designs (set-up) and the recording
    fs = fc.FS
    t0 = time.perf_counter()
    lr, gt, third = fc.banks(fs)
    sig = fc.signal(device=dev)
    torch.cuda.synchronize()
    C, T = sig.number_of_channels, sig.length_samples
    print(f"set-up: config-3 banks and {C} x {T} recording: "
          f"{time.perf_counter() - t0:.3f} s")
    x = sig._x  # (C, T) float32

    # 16. B3 vs plain at the path's three banks (64 x 441,000) and ragged
    # shapes. Tolerance: B2's (fp32 Toeplitz sums in two orders, fp64 state)
    banks = {"lr": lr._cascade_bank, "gammatone": _sos_bank_or_none(gt.filters),
             "third_octave": _sos_bank_or_none(third.filters)}
    b3_err = 0.0
    b3_ops = {}

    def check(label, bank, xin):
        nonlocal b3_err
        Tn = xin.shape[-1]
        ops, rest = iir_block.bank_kernel_stages(bank, Tn, dev)
        P = 2 if np.iscomplexobj(bank) else 1
        lead = ops["n_full"] * ops["L"]
        out_k = torch.empty((P, len(bank), xin.shape[0], Tn), device=dev)
        out_p = torch.empty_like(out_k)
        on_chip = cuda_iir_bank.state_on_chip
        s_k = cuda_iir_bank.sosfilt_bank_lead_cuda(ops, xin, out_k)
        on_chip = cuda_iir_bank.state_on_chip - on_chip
        s_p = cuda_iir_bank.sosfilt_bank_lead_plain(ops, xin, out_p)
        torch.cuda.synchronize()
        y_err = float((out_k[..., :lead] - out_p[..., :lead]).abs().max())
        y_scale = float(out_p[..., :lead].abs().max())
        z_err = float((s_k - s_p).abs().max())
        z_scale = max(1.0, float(s_p.abs().max()))
        print(f"B3 bank {label} (P, B, R, T) = {tuple(out_k.shape)}, "
              f"{ops['kernel']['lanes']} lanes, L = {ops['L']}, output pass "
              f"{cuda_iir_bank.output_pass(ops['L'])}, state on chip {on_chip}: |dy| "
              f"{y_err:.3e} <= 1e-5*{y_scale:.3e}; |dzf| {z_err:.3e} <= 1e-6*{z_scale:.3e}")
        wide = cuda_iir_bank.keeps_state_on_chip(ops["L"], len(bank), ops["kernel"]["lanes"])
        if on_chip != wide:
            fail(f"the bank kernel took the wrong route ({label})")
        if not (y_err <= 1e-5 * y_scale and z_err <= 1e-6 * z_scale):
            fail(f"bank kernel disagrees with its plain version ({label})")
        b3_err = max(b3_err, y_err)
        if rest:
            # a split cascade: the whole route, every stage through B3,
            # against the whole bank's plain version
            whole = iir_block.bank_device_operators(bank, Tn, torch.float32, dev)
            err = rel_err(iir_block.sosfilt_bank_apply(whole, xin),
                          plain(lambda: iir_block.sosfilt_bank_apply(whole, xin)))
            print(f"B3 bank {label}: {len(rest[0])} more stage(s) per band; route vs "
                  f"plain scale-rel {err:.3e} (tol 1e-5)")
            if not err <= 1e-5:
                fail(f"the bank's staged route disagrees with its plain version ({label})")
        return ops

    for name, bank in banks.items():
        b3_ops[name] = check(name, bank, x)
    for label, bank, R, Tn in bank_ragged():
        xr = torch.from_numpy(rng.standard_normal((R, Tn)).astype(np.float32)).to(dev)
        check(label, bank, xr)

    # 17. the path at full width, counted: every kernel's count set to 0
    # just before and read just after
    modules = {"framing": cuda_framing, "iir_lead": cuda_iir, "das_map": cuda_das,
               "banded": cuda_banded, "iir_bank": cuda_iir_bank}
    for m in modules.values():
        m.launches = 0
    cuda_iir_bank.state_on_chip = 0
    out = fc.run(sig, lr, gt, third)
    torch.cuda.synchronize()
    launched = {name: m.launches for name, m in modules.items()}
    on_chip = cuda_iir_bank.state_on_chip
    label = f"config-3 path {C} ch x {T} samples"
    print(f"{label}: launches {launched}, B3 state on chip {on_chip}")
    if launched["iir_bank"] != 3:
        fail("the filter-bank path did not run the bank kernel once for each of its three banks")
    if on_chip != 3:
        fail("the filter-bank path's three banks did not keep their states on the chip")
    lr_b, gt_b, res, third_b = out
    shapes = (("LR", lr_b, 4, False), ("gammatone", gt_b, len(gt.filters), True),
              ("1/3 octave", third_b, len(third.filters), False))
    for name, mb, n, cplx in shapes:
        if (mb.number_of_bands != n or mb.is_complex_signal != cplx
                or tuple(mb.bands[0].time_data.shape) != (T, C)):
            fail(f"{label} {name}: {mb.number_of_bands} bands, shape "
                 f"{tuple(mb.bands[0].time_data.shape)}")
        if not all(bool(torch.isfinite(b._x).all()) for b in mb.bands):
            fail(f"{label} {name}: non-finite output")
    if tuple(res.time_data.shape) != (T // 3, C) or res.sampling_rate_hz != fs // 3:
        fail(f"{label} resample: shape {tuple(res.time_data.shape)}")

    # every band against scipy's float64 sosfilt on 4 of the 64 channels
    ch = sorted({0, C // 3, 2 * C // 3, C - 1})  # 0, 21, 42, 63 at 64 channels
    x64 = x[ch].double().cpu().numpy()
    t0 = time.perf_counter()
    worst = {}
    for name, mb, bank in (("LR", lr_b, banks["lr"]), ("gammatone", gt_b, banks["gammatone"]),
                           ("1/3 octave", third_b, banks["third_octave"])):
        for b, band in enumerate(mb.bands):
            got = band._x[ch]
            if band.is_complex_signal:
                got = torch.complex(got, band._x_imag[ch])
            err = rel_err(got, scipy_sosfilt(bank[b], x64, axis=-1))
            worst[name] = max(worst.get(name, 0.0), err)
    print(f"{label} bands vs scipy f64 sosfilt on channels {ch} "
          f"({time.perf_counter() - t0:.1f} s on the host): worst scale-rel "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + " (tol 5e-6)")
    if not max(worst.values()) <= 5e-6:
        fail("a band disagrees with scipy's float64 sosfilt")

    # the chain against the same chain on the plain paths
    ref = plain(lambda: fc.run(sig, lr, gt, third))
    for name, got, want in (
        ("LR", lr_b, ref[0]), ("gammatone", gt_b, ref[1]), ("1/3 octave", third_b, ref[3]),
    ):
        err = max(rel_err(g._x if g._x_imag is None else torch.complex(g._x, g._x_imag),
                          w._x if w._x_imag is None else torch.complex(w._x, w._x_imag))
                  for g, w in zip(got.bands, want.bands))
        print(f"{label} {name} vs plain paths: worst band scale-rel {err:.3e} (tol 2e-5)")
        if not err <= 2e-5:
            fail(f"{label}: {name} disagrees with the plain paths")
    err = rel_err(res._x, ref[2]._x)
    print(f"{label} resample vs plain paths: scale-rel {err:.3e} (tol 2e-5)")
    if not err <= 2e-5:
        fail(f"{label}: resample disagrees with the plain paths")
    del ref

    # 18. reconstruct. At 44.1 kHz the config's 500-4000 Hz bank has
    # non-finite phase factors above ~2 kHz (the band responses' last
    # samples underflow in float64), as in the JAX package and the
    # reference, so its synthesis is not finite; the 10-band 500-2000 Hz
    # bank's is, and is held against the plain paths at the bound of
    # tests/test_filterbanks.py::TestGammatone::test_reconstruct_roundtrip
    n_bad = int((~np.isfinite(gt._phase_factors)).sum())
    print(f"gammatone 500-4000 Hz at {fs} Hz: {n_bad} of {len(gt.filters)} phase factors "
          f"non-finite, gains finite: {bool(np.isfinite(gt._gains).all())}")
    gt2 = auditory_filters_gammatone([500.0, 2000.0], sampling_rate_hz=fs)
    rec = gt2.reconstruct(gt2.filter_signal(sig, FilterBankMode.Parallel))
    rec_p = plain(lambda: gt2.reconstruct(gt2.filter_signal(sig, FilterBankMode.Parallel)))
    err = rel_err(rec._x, rec_p._x)
    finite = bool(torch.isfinite(rec._x).all())
    print(f"gammatone 500-2000 Hz ({len(gt2.filters)} bands) reconstruct vs plain paths: "
          f"scale-rel {err:.3e} (tol 2e-4), finite {finite}")
    if not (err <= 2e-4 and finite):
        fail("the gammatone reconstruction disagrees with the plain paths")

    # 19. times: B3 and its plain version at the path's three banks; the
    # chain through the kernels and on the plain paths
    b3 = {"ms": 0.0, "plain_ms": 0.0}
    n_bytes = fp32 = fp64 = fp64_mm = 0.0
    for name, ops in b3_ops.items():
        P = 2 if ops["HmatT"].is_complex() else 1
        buf = torch.empty((P, ops["HmatT"].shape[0], C, T), device=dev)
        k_ms, p_ms = time_pair(lambda: cuda_iir_bank.sosfilt_bank_lead_cuda(ops, x, buf),
                               lambda: cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, buf),
                               n=10, warm=2)
        nb, f32, f64, f64_mm = bank_bound(ops, C)
        one, by = bound(nb, 0.0, f64, f64_mm, f32)
        ffma, ffma_by = bound(nb, 0.0, f64, f64_mm, f32, tensor_cores=False)
        n_bytes, fp32, fp64, fp64_mm = n_bytes + nb, fp32 + f32, fp64 + f64, fp64_mm + f64_mm
        b3["ms"] += k_ms
        b3["plain_ms"] += p_ms
        b3[f"ms_{name}"] = k_ms
        print(f"time B3 bank {name} (P, B, R, K, L) = "
              f"{(P, ops['HmatT'].shape[0], C, ops['n_full'], ops['L'])}, output pass "
              f"{cuda_iir_bank.output_pass(ops['L'])}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms; bound with x·h as 3×TF32 {one:.4f} ms ({by}, "
              f"{k_ms / one:.2f}×), with x·h on FFMA {ffma:.4f} ms ({ffma_by}, "
              f"{k_ms / ffma:.2f}×)")
        del buf
    b3_bound, b3_by = bound(n_bytes, 0.0, fp64, fp64_mm, fp32)
    b3_ffma, b3_ffma_by = bound(n_bytes, 0.0, fp64, fp64_mm, fp32, tensor_cores=False)
    print(f"bound B3 three banks: x·h as 3×TF32 {b3_bound:.4f} ms ({b3_by}, "
          f"{b3['ms'] / b3_bound:.2f}×), x·h on FFMA {b3_ffma:.4f} ms ({b3_ffma_by}, "
          f"{b3['ms'] / b3_ffma:.2f}×)")
    k_ms, p_ms = time_pair(lambda: fc.run(sig, lr, gt, third),
                           lambda: plain(lambda: fc.run(sig, lr, gt, third)), n=10, warm=2)
    audio_s = C * T / fs
    print(f"time {label} (LR + gammatone B3 + resample + 1/3 octave B3): kernels "
          f"{k_ms:.4f} ms ({audio_s / (k_ms * 1e-3):.1f} audio-s/s), plain paths "
          f"{p_ms:.4f} ms ({audio_s / (p_ms * 1e-3):.1f} audio-s/s)")
    return {"name": "sosfilt_bank", "route": "cuda",
            "source": "dsptoolbox_tpu_torch/csrc/iir_bank.cu",
            "replaces": "dsptoolbox_tpu/ops/pallas_iir_bank.py:267",
            "launches": launched["iir_bank"], "state_on_chip": on_chip, "max_abs_err": b3_err,
            "ms": b3["ms"], "plain_ms": b3["plain_ms"], "bound_ms": b3_bound,
            "bound_by": b3_by, "library_ms": None, "bound_ms_ffma": b3_ffma,
            "ms_by_bank": {k: b3[f"ms_{k}"] for k in b3_ops}}


def held(label: str, got, want, flips, tol_kept: float, tol_all: float) -> None:
    """Hold ``got`` against ``want`` (relative): within ``tol_kept`` where
    no decision flipped, within ``tol_all`` everywhere; prints the largest
    difference and whether a flip caused it."""
    import numpy as np

    got, want, flips = np.asarray(got), np.asarray(want), np.asarray(flips, bool)
    rel = np.abs(got - want) / np.abs(want)
    kept = float(rel[~flips].max()) if (~flips).any() else 0.0
    worst = int(rel.argmax())
    print(f"{label}: max rel {float(rel.max()):.3e} (tol {tol_all:g}), from "
          f"{'a flipped decision' if flips.flat[worst] else 'arithmetic, no flip'}; "
          f"{int(flips.sum())} of {flips.size} with a flipped decision; without one "
          f"{kept:.3e} (tol {tol_kept:g})")
    if not (float(rel.max()) <= tol_all and kept <= tol_kept):
        fail(f"{label} disagrees")


def ism_indices_held(label: str, room, s, r, fs: int, length: int, dev) -> None:
    """Every image of the fleet that can land in the kept ``length`` (index
    ≤ ``length`` on the card, one ulp from it at most) holds the numpy
    float64 oracle's sample index exactly, on all pairs."""
    import numpy as np
    import torch

    from dsptoolbox_tpu_torch.room_acoustics import _backend as rbk

    dim = np.asarray(room.dimensions_m, np.float64)
    b1, b2 = rbk.wall_reflection_factors(room.absorption_coefficient)
    limit, _ = rbk.ism_limits(dim, room.t60_s, None, fs)
    pairs, cells, got = [], [], []
    for lv, idx, _ in rbk.ism_images(dim, b1, b2, s, r, fs, limit, dev):
        pp, cc = (idx <= length).any(-1).nonzero(as_tuple=True)
        pairs.append(pp.cpu())
        cells.append(lv[cc].cpu())
        got.append(idx[pp, cc].cpu())
    torch.cuda.synchronize()
    pairs = torch.cat(pairs).numpy()
    cells, got = torch.cat(cells).numpy(), torch.cat(got).numpy()
    wrong = 0
    for p in range(len(s)):
        m = pairs == p
        want, _ = rbk._host_group_images(cells[m], dim, b1, b2, s[p], r[p], fs,
                                         rbk.SPEED_OF_SOUND)
        wrong += int(np.count_nonzero(want.reshape(-1, 8) != got[m]))
    print(f"{label}: {got.size} images of {len(cells)} cells within reach of the kept "
          f"{length} samples, on all {len(s)} pairs: {wrong} sample indices differ from "
          "the float64 oracle's (tol 0)")
    if wrong:
        fail(f"{label}: the lattice places images off the float64 oracle's bins")


def descriptors_held(label: str, got: dict, want: dict) -> None:
    """Batch descriptors on the card against the port's float64 run on the
    CPU: D50 and centre time at rtol 1e-5, C80 within 1e-3 dB."""
    for name, tol, rel in (("d50", 1e-5, True), ("center_time_s", 1e-5, True),
                           ("c80", 1e-3, False)):
        diff = (got[name].double().cpu() - want[name]).abs()
        err = float((diff / want[name].abs() if rel else diff).max())
        print(f"{label} {name} vs float64 CPU: max {'rel' if rel else 'abs (dB)'} "
              f"{err:.3e} (tol {tol:g})")
        if not err <= tol:
            fail(f"{label}: {name} disagrees with the float64 run")


def room_phase(dev, win, card: str) -> dict:
    """Room acoustics at full width: (a) the reverberation times and ISO
    3382 descriptors of the measurement path's windowed IRs (B3 for the
    octave bank, B2 for the bass ratio's zero-phase bands), (b) config 4's
    battery of 1000 RIRs, (c) the image-source fleet of 64 pairs. Returns
    (a)'s B2 and B3 launches."""
    import numpy as np
    import torch
    from scipy.signal import sosfilt as scipy_sosfilt
    from scipy.signal import sosfiltfilt

    from dsptoolbox_tpu_torch.room_acoustics import (
        ReverbTime,
        batch_descriptors,
        batch_energy_decay,
        batch_reverb_times,
        batch_synthetic_rirs,
        generate_synthetic_rir,
    )
    from dsptoolbox_tpu_torch.room_acoustics import _backend as rbk
    from dsptoolbox_tpu_torch.room_acoustics.room_acoustics import (
        _bass_ratio_bank,
        _host_planes,
    )
    from dsptoolbox_tpu_torch.standard.enums import FilterBankMode
    from dsptoolbox_tpu_torch.tools import room_measurement as rm
    from dsptoolbox_tpu_torch.tools.profile_chain import profile_call

    # 20. (a) the measured room, counted: every kernel's count set to 0
    # just before and read just after
    fs = win.sampling_rate_hz
    C, T = win.number_of_channels, win.length_samples
    bank = rm.octave_bank(fs)
    out, launched = counted_run(lambda: rm.measured_room(win, bank))
    label = f"room (a) {C} IRs x {T} samples at {fs} Hz"
    print(f"{label}: launches {launched}")
    if launched["iir_bank"] < 1 or launched["iir_lead"] < 1:
        fail("the measured room's step did not run B3 (octave bank) and B2 (bass ratio)")
    bands = out["bands"]
    nb = len(bank.filters)
    if bands.number_of_bands != nb or tuple(bands.bands[0].time_data.shape) != (T, C):
        fail(f"{label}: {bands.number_of_bands} bands of {tuple(bands.bands[0].time_data.shape)}")
    for name, v in list(out["rt"].items()) + list(out["descriptors"].items()):
        if v.shape not in ((nb, C), (C,)) or not np.all(np.isfinite(v)):
            fail(f"{label} {name}: shape {v.shape} or non-finite")
    print(f"{label}: mean RT per band " + "; ".join(
        f"{k} {np.round(v.mean(axis=1), 4).tolist()}" for k, v in out["rt"].items())
        + "; mean " + ", ".join(f"{k} {v.mean():.4f}" for k, v in out["descriptors"].items()))

    # every band against scipy's float64 sosfilt on all channels
    x64 = win._x.double().cpu().numpy()  # (C, T)
    bands64 = np.stack([scipy_sosfilt(f.sos, x64, axis=-1) for f in bank.filters])
    worst = max(rel_err(b._x, bands64[i]) for i, b in enumerate(bands.bands))
    print(f"{label}: bands vs scipy f64 sosfilt worst scale-rel {worst:.3e} (tol 5e-6)")
    if not worst <= 5e-6:
        fail("an octave band disagrees with scipy's float64 sosfilt")

    # the fits and descriptors against (1) the plain paths, (2) scipy's
    # float64 bands given to the fits as float32, as the API gives them
    # data, and (3) the float64 pipeline, the same fits on the float64
    # bands. The fits are decision logic: an index can flip on inputs 1e-6
    # apart. (1) and (2) differ from the card's by the bands' ~1e-6: 1e-3
    # where no decision flipped (arithmetic through the line fits), 2e-2
    # with a flip. (3) differs by the fits' own float32 sums (the EDC's
    # cumsum over up to 65,536 samples, ROADMAP C4): reported, held at
    # 5e-2
    t0 = time.perf_counter()
    ref = plain(lambda: rm.measured_room(win, bank))
    err = max(rel_err(g._x, w._x) for g, w in zip(bands.bands, ref["bands"].bands))
    print(f"{label}: bands vs plain paths worst scale-rel {err:.3e} (tol 2e-5)")
    if not err <= 2e-5:
        fail("the octave bands disagree with the plain paths")
    planes_k, planes_p = _host_planes(bands), _host_planes(ref["bands"])
    bands64_32 = bands64.astype(np.float32)
    grid = [(b, c) for b in range(nb) for c in range(C)]
    for mode in rm.REVERB_TIMES:
        dk = [rbk.reverb_fit(planes_k[b, c], fs, mode)[2] for b, c in grid]
        k = out["rt"][mode.name].reshape(-1)
        for what, planes, want, tol_kept, tol_all in (
            ("plain paths", planes_p, ref["rt"][mode.name].reshape(-1), 1e-3, 2e-2),
            ("scipy f64 bands, float32 fits", bands64_32, None, 1e-3, 2e-2),
            ("float64 pipeline (C4)", bands64, None, 5e-2, 5e-2),
        ):
            fits = [rbk.reverb_fit(planes[b, c], fs, mode) for b, c in grid]
            if want is None:
                want = np.array([f[0] for f in fits])
            flips = [a != f[2] for a, f in zip(dk, fits)]
            held(f"{label} {mode.name} vs {what}", k, want, flips, tol_kept, tol_all)
    win32 = win._x.cpu().numpy()
    flips = [rbk.descriptor_window(win32[c], fs, True) != rbk.descriptor_window(x64[c], fs, True)
             for c in range(C)]
    for name, fn in (("D50", rbk.d50_from_rir), ("C80", rbk.c80_from_rir),
                     ("CenterTime", rbk.ts_from_rir)):
        got = out["descriptors"][name]
        if not np.array_equal(got, ref["descriptors"][name]):
            fail(f"{label} {name}: the plain paths give other values on the same IRs")
        held(f"{label} {name} vs float64", got,
             [fn(x64[c], fs, True) for c in range(C)], flips, 1e-4, 5e-2)
    # the bass ratio's zero-phase bands (B2, two leads a band) against the
    # plain paths (2e-5 scale-relative, as the other paths) and scipy's
    # float64 sosfiltfilt (5e-6, ROADMAP C3: the JAX package's float32
    # filter is no oracle on these bands); then the bass ratio against the
    # plain paths and against scipy's bands + the host fits
    octs = _bass_ratio_bank(fs)
    zk = _host_planes(octs.filter_signal(win, FilterBankMode.Parallel, zero_phase=True))
    zp = _host_planes(plain(lambda: octs.filter_signal(win, FilterBankMode.Parallel,
                                                       zero_phase=True)))
    z64 = np.stack([sosfiltfilt(f.sos, x64, axis=-1) for f in octs.filters])
    b2_err = float(np.abs(zk - zp).max())
    for i, f in enumerate(octs.filters):
        e_p, e_64 = rel_err(zk[i], zp[i]), rel_err(zk[i], z64[i])
        print(f"{label}: zero-phase band {i} (B2) vs plain paths scale-rel {e_p:.3e} "
              f"(tol 2e-5), vs scipy f64 sosfiltfilt {e_64:.3e} (tol 5e-6)")
        if not (e_p <= 2e-5 and e_64 <= 5e-6):
            fail(f"{label}: the bass ratio's zero-phase band {i} disagrees")
    ad = ReverbTime.Adaptive
    nz = len(octs.filters)
    dk = [[rbk.reverb_fit(zk[i, c], fs, ad)[2] for c in range(C)] for i in range(nz)]
    br = out["descriptors"]["BassRatio"]
    for what, planes, want, tol_kept, tol_all in (
        ("plain paths", zp, ref["descriptors"]["BassRatio"], 1e-3, 2e-2),
        ("scipy f64 sosfiltfilt, float32 fits", z64.astype(np.float32), None, 1e-3, 2e-2),
        ("scipy f64 sosfiltfilt + float64 fits (C4)", z64, None, 5e-2, 5e-2),
    ):
        fits = [[rbk.reverb_fit(planes[i, c], fs, ad) for c in range(C)] for i in range(nz)]
        if want is None:
            rt = np.array([[f[0] for f in row] for row in fits])
            want = (rt[0] + rt[1]) / (rt[2] + rt[3])
        flips = [any(dk[i][c] != fits[i][c][2] for i in range(nz)) for c in range(C)]
        held(f"{label} BassRatio vs {what}", br, want, flips, tol_kept, tol_all)
    print(f"{label}: checks against the plain paths and float64 "
          f"{time.perf_counter() - t0:.1f} s on the host")

    # 21. (a)'s times: the bank against its plain path; the fits (host)
    # and the whole step through the kernels, CUDA events; the whole
    # step's device busy time and idle share from one profiled call
    bank_ms, bank_plain = time_pair(lambda: rm.octave_bands(win, bank),
                                    lambda: plain(lambda: rm.octave_bands(win, bank)))
    (fits_ms,) = time_pair(lambda: rm.band_reverb_times(bands), n=3, warm=1)
    step = profile_call(f"{label}: whole step", lambda: rm.measured_room(win, bank),
                        runs=1, host_calls=1, event_calls=2, warm=0)
    n_fits = nb * C * len(rm.REVERB_TIMES)
    print(f"time {label} [{card}]: octave bank (B3) {bank_ms:.4f} ms, plain "
          f"{bank_plain:.4f} ms; RT fits, {n_fits} ({nb} bands x {C} channels x "
          f"{len(rm.REVERB_TIMES)} modes) {fits_ms:.1f} ms ({fits_ms / n_fits:.3f} ms a fit); "
          f"whole step {step['events_ms']:.1f} ms; host {step['host_us']:.0f} us, wall "
          f"{step['wall_us']:.0f} us, device busy {step['busy_us']:.0f} us, idle share "
          f"{step['idle']:.4f}")

    # 22. (b) config 4: 1000 RIRs x 8000 samples at 16 kHz, on the card,
    # against the port's float64 run on the CPU. D50 and centre time at
    # rtol 1e-5; C80 within 1e-3 dB (its late energy e_total − e_80 is a
    # difference of float32 sums up to 27 dB apart: ×500 their relative
    # error); an RT row may flip a fit-mask sample at a dB edge (the
    # float32 EDC's sums in another order, ROADMAP C5): rows whose mask
    # matches the float64 one at rtol 1e-5, the others at 1e-3
    rirs_np = rm.battery_rirs()
    rirs = torch.from_numpy(rirs_np).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = rm.battery(rirs)
    torch.cuda.synchronize()
    peak_b = torch.cuda.max_memory_allocated() - base
    cpu64 = torch.from_numpy(rirs_np).double()
    ref64 = rm.battery(cpu64)
    label = f"room (b) config 4, {rirs.shape[0]} RIRs x {rirs.shape[1]} at {rm.BATTERY_FS} Hz"
    descriptors_held(label, got, ref64)
    edc_k = batch_energy_decay(rirs).cpu()
    edc_64 = batch_energy_decay(cpu64)
    for mode, (hi, lo) in (("EDT", (0.0, -10.0)), ("T20", (-5.0, -25.0)),
                           ("T30", (-5.0, -35.0))):
        flips = (((edc_k <= hi) & (edc_k >= lo)) != ((edc_64 <= hi) & (edc_64 >= lo))).any(1)
        held(f"{label} {mode} vs float64 CPU", got[mode].double().cpu().numpy(),
             ref64[mode].numpy(), flips.numpy(), 1e-5, 1e-3)
    bat_ms, base_ms = time_pair(lambda: rm.battery(rirs),
                                lambda: (batch_descriptors(rirs, rm.BATTERY_FS),
                                         batch_reverb_times(rirs, rm.BATTERY_FS, "T20")),
                                n=20, warm=1)
    B = rirs.shape[0]
    print(f"time {label} [{card}]: D50 + C80 + Ts + T20 {base_ms:.4f} ms "
          f"({B / (base_ms * 1e-3):.0f} RIRs/s); with EDT and T30 too {bat_ms:.4f} ms "
          f"({B / (bat_ms * 1e-3):.0f} RIRs/s); peak device memory {peak_b / 2**20:.1f} MiB "
          "above the inputs")

    # 23. (c) the image-source fleet: 64 pairs, LIMIT 40, 0.5 s at 16 kHz;
    # rows held against the numpy float64 oracle (identical support, values
    # within 2e-7·max), as is the max_order-14 RIR at 44.1 kHz
    room = rm.room()
    s, r = rm.fleet_positions()
    limit, _ = rbk.ism_limits(room.dimensions_m, room.t60_s, None, rm.FLEET_FS)
    n_images = s.shape[0] * (2 * limit + 1) ** 3 * 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fleet, fleet_desc = rm.ism_fleet(room, s, r)
    torch.cuda.synchronize()
    peak_c = torch.cuda.max_memory_allocated() - base
    label = f"room (c) ISM fleet, {s.shape[0]} pairs, LIMIT {limit}, {n_images} images"
    if (tuple(fleet.shape) != (s.shape[0], int(rm.FLEET_FS * rm.FLEET_SECONDS))
            or not bool(torch.isfinite(fleet).all())):
        fail(f"{label}: shape {tuple(fleet.shape)} or non-finite")
    fleet_np = fleet.cpu().numpy()
    t0 = time.perf_counter()
    rbk.set_ism_device(False)
    try:
        oracle = [generate_synthetic_rir(room, s[b], r[b], rm.FLEET_FS, rm.FLEET_SECONDS)
                  for b in range(min(4, len(s)))]
        one64 = generate_synthetic_rir(rm.room(), [1.23, 2.17, 1.31], [4.29, 1.17, 1.63],
                                       44100, max_order=14)
    finally:
        rbk.set_ism_device(None)
    one = generate_synthetic_rir(rm.room(), [1.23, 2.17, 1.31], [4.29, 1.17, 1.63], 44100,
                                 max_order=14)
    rows = [(f"row {b}", fleet_np[b], o.time_data[:, 0].cpu().numpy())
            for b, o in enumerate(oracle)]
    rows.append(("max_order 14 at 44.1 kHz", one.time_data[:, 0].cpu().numpy(),
                 one64.time_data[:, 0].cpu().numpy()))
    for name, g, w in rows:
        same = np.array_equal(np.nonzero(g)[0], np.nonzero(w)[0])
        err = float(np.abs(g - w).max() / np.abs(w).max())
        print(f"{label} {name} vs numpy float64 oracle: support identical {same} "
              f"({np.count_nonzero(w)} bins), values scale-rel {err:.3e} (tol 2e-7)")
        if not (same and err <= 2e-7):
            fail(f"{label}: {name} disagrees with the float64 oracle")
    ism_indices_held(label, room, s, r, rm.FLEET_FS, fleet.shape[1], dev)
    descriptors_held(f"{label} (on the fleet)", fleet_desc,
                     batch_descriptors(fleet.double().cpu(), rm.FLEET_FS))
    print(f"{label}: oracle checks {time.perf_counter() - t0:.1f} s on the host")
    gen_ms, fleet_ms = time_pair(
        lambda: batch_synthetic_rirs(room, s, r, rm.FLEET_FS, rm.FLEET_SECONDS),
        lambda: rm.ism_fleet(room, s, r), n=5, warm=1)
    print(f"time {label} [{card}]: generator {gen_ms:.3f} ms "
          f"({n_images / (gen_ms * 1e-3):.4g} images/s), with the descriptors "
          f"{fleet_ms:.3f} ms; peak device memory {peak_c / 2**20:.1f} MiB")
    return {"iir_lead": launched["iir_lead"], "iir_bank": launched["iir_bank"],
            "iir_lead_err": b2_err}


def np_frames(x, L: int, step: int, pad: int = 0, detrend: bool = False):
    """float64 numpy frames of ``x (C, T)``: padded with ``pad`` zeros at
    both ends, hop ``step``, ceil(T / step) frames zero-padded at the end,
    times the periodic Hann window, minus each frame's mean with
    ``detrend`` (after the window, as the package does)."""
    import numpy as np
    from scipy.signal import get_window

    x = np.pad(x, ((0, 0), (pad, pad)))
    K = -(-x.shape[-1] // step)
    x = np.pad(x, ((0, 0), (0, max(0, (K - 1) * step + L - x.shape[-1]))))
    frames = x[:, np.arange(K)[:, None] * step + np.arange(L)] * get_window("hann", L)
    if detrend:
        frames -= frames.mean(axis=-1, keepdims=True)
    return frames


def np_sqrt(z):
    """Complex sqrt with a zero imaginary part taken as +0 (the package's)."""
    import numpy as np

    return np.sqrt(z.real + 1j * (z.imag + 0.0))


def np_welch(x, L: int = 1024):
    """float64 numpy Welch spectrum ``(F, C)`` at the Signal's defaults
    (Hann, 50 %, detrend, mean, FFTBackward: the mean |X|²'s square root)."""
    import numpy as np

    X = np.fft.rfft(np_frames(x, L, L // 2, detrend=True), axis=-1)
    return np.sqrt(np.mean(np.abs(X) ** 2, axis=-2)).T


def np_assemble(Q):
    """The package's Hermitian assembly of ``Q (F, C, C)``: the lower
    triangle of Qᵀ, half its diagonal, plus its conjugate transpose."""
    import numpy as np

    mask = np.tril(np.ones(Q.shape[-2:]))
    np.fill_diagonal(mask, 0.5)
    lower = np.swapaxes(Q, -1, -2) * mask
    return lower + np.conj(np.swapaxes(lower, -1, -2))


def np_csm_welch(x, L: int = 1024):
    """float64 numpy Welch CSM ``(F, C, C)`` at the Signal's defaults: the
    per-pair square root (FFTBackward is an amplitude scaling), then the
    assembly."""
    import numpy as np

    X = np.fft.rfft(np_frames(x, L, L // 2, detrend=True), axis=-1)  # (C, K, F)
    Q = np.einsum("akf,bkf->fab", np.conj(X), X) / X.shape[-2]
    return np_assemble(np_sqrt(Q))


def np_csm_fft(x, n: int):
    """float64 numpy FFT-method CSM ``(F, C, C)`` (FFTBackward)."""
    import numpy as np

    sp = np.fft.rfft(x, n=n, axis=-1).T  # (F, C)
    return np_assemble(np.conj(sp)[:, :, None] * sp[:, None, :])


class AverageLaunches:
    """The launch count of `cuda_ema`'s average form, read and set as
    ``.launches`` like each wrapper module's own count."""

    def __init__(self, module):
        self.module = module

    @property
    def launches(self) -> int:
        return self.module.average_launches

    @launches.setter
    def launches(self, n: int):
        self.module.average_launches = n


def counted_modules() -> dict:
    from dsptoolbox_tpu_torch.ops import (
        cuda_banded,
        cuda_csm,
        cuda_das,
        cuda_ema,
        cuda_framing,
        cuda_iir,
        cuda_iir_bank,
    )

    return {"framing": cuda_framing, "iir_lead": cuda_iir, "das_map": cuda_das,
            "banded": cuda_banded, "iir_bank": cuda_iir_bank, "ema": cuda_ema,
            "ema_carry": AverageLaunches(cuda_ema), "csm": cuda_csm}


def counted_run(fn):
    """``(fn(), launches)``: every kernel's count set to 0 just before
    ``fn`` and read just after it."""
    import torch

    modules = counted_modules()
    for m in modules.values():
        m.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: m.launches for name, m in modules.items()}


def csm_gram_phase(dev, card: str) -> dict:
    """The Welch CSM's Gram kernel (`ops.cuda_csm`) at `CSM_GRAM_SHAPES`
    on random complex X: against its plain version (fp32 sums of K
    products in two orders: within 8·sqrt(K)·2^-24 of the largest mean
    power), Hermitian with a real diagonal, two launches bit-equal; timed
    with CUDA events against the plain version and, as the library
    yardstick, the layout copy and `torch.matmul` alone. Bound: X's bytes
    or the upper triangle's C(C+1)/2·K·F complex products (8 flop each) at
    fp32 FFMA's 67 TFLOP/s."""
    import torch

    from dsptoolbox_tpu_torch.ops import cuda_csm

    gen = torch.Generator(device=dev).manual_seed(27)
    err, shapes = 0.0, []
    for C, K, F in CSM_GRAM_SHAPES:
        X = torch.randn((C, K, F), dtype=torch.complex64, device=dev, generator=gen)
        before = cuda_csm.launches
        got = cuda_csm.gram_mean(X)
        want = cuda_csm.gram_mean_plain(X)
        again = cuda_csm.gram_mean(X)
        torch.cuda.synchronize()
        scale = float(want.diagonal(dim1=-2, dim2=-1).real.max())
        e = float((got - want).abs().max())
        tol = 8 * K**0.5 * 2.0**-24 * scale
        herm = torch.equal(got, got.mH) and not bool(
            got.diagonal(dim1=-2, dim2=-1).imag.any())
        same = torch.equal(got, again)
        print(f"CSM Gram ({C}, {K}, {F}): {cuda_csm.launches - before} launches; max abs err "
              f"vs plain {e:.3e} (tol {tol:.3e}); Hermitian, real diagonal {herm}; "
              f"bit-equal launches {same}")
        if cuda_csm.launches - before != 2 or not (e <= tol and herm and same):
            fail(f"CSM Gram kernel at ({C}, {K}, {F}) disagrees with its plain version")
        err = max(err, e)

        def library(X=X):
            Y = X.permute(2, 0, 1).contiguous()
            return torch.matmul(Y, Y.mH)

        del got, want, again
        k_ms, p_ms, l_ms = time_pair(lambda: cuda_csm.gram_mean_cuda(X),
                                     lambda: cuda_csm.gram_mean_plain(X), library)
        b_ms, b_by = bound(X.numel() * 8 + F * C * C * 8, C * (C + 1) / 2 * K * F * 8,
                           tensor_cores=False)
        print(f"time CSM Gram ({C}, {K}, {F}) [{card}]: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, permute + torch.matmul {l_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {k_ms / b_ms:.2f}x)")
        if C == 64 and not k_ms <= l_ms:
            fail(f"CSM Gram kernel at ({C}, {K}, {F}) is slower than permute + torch.matmul")
        shapes.append({"shape": [C, K, F], "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": e})
        del X
        torch.cuda.empty_cache()
    return {"max_abs_err": err, "by_shape": shapes, "launches": 2 * len(CSM_GRAM_SHAPES)}


def config2_phase(dev, card: str) -> dict:
    """Config 2 (`tools/speech_chain.py`: STFT → ISTFT, Welch spectrum,
    append, Welch CSM) at (a) the JAX package's size, 1 channel × 4 s, and
    (b) full width, 16 channels × 60 s at 48 kHz: counted (B1), against the
    plain paths (2e-5 scale-relative) and a float64 numpy run (1e-4); the
    ISTFT round trip within 1e-5 of the input; the FFT-method CSM too
    (at (b) on 2 channels and their reconstructions: all 32 would be 12 GB).
    Timed with CUDA events against the plain paths. Returns B1's launches,
    its error against its plain version at the path's shapes, the CSM Gram
    kernel's launches (one a run) and the 60 s recording for the standard
    phase."""
    import numpy as np
    import torch

    from dsptoolbox_tpu_torch.ops import cuda_framing
    from dsptoolbox_tpu_torch.ops.fft_conv import next_fast_len
    from dsptoolbox_tpu_torch.ops.windows import get_window
    from dsptoolbox_tpu_torch.standard import append_signals
    from dsptoolbox_tpu_torch.standard.enums import SpectrumMethod, Window
    from dsptoolbox_tpu_torch.tools import speech_chain as sc

    launches, gram_launches, b1_err, times = 0, 0, 0.0, []
    minute = None
    for name, (C, seconds) in (("(a)", sc.SPEECH), ("(b)", sc.MINUTE)):
        sig = sc.signal(C, seconds)
        T = sig.length_samples
        label = f"config 2 {name} {C} ch x {seconds:g} s at {sc.FS} Hz"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (y, sp, csm), launched = counted_run(lambda: sc.run(sig))
        peak = torch.cuda.max_memory_allocated() - base
        print(f"{label}: launches {launched}; peak device memory {peak / 2**20:.1f} MiB "
              "above the input")
        if launched["framing"] < 3:
            fail(f"{label}: the chain did not run B1 for the STFT, Welch and the CSM")
        if launched["csm"] != 1:
            fail(f"{label}: the Welch CSM launched the Gram kernel {launched['csm']} times, "
                 "not once")
        launches += launched["framing"]
        gram_launches += launched["csm"]
        F = sc.WINDOW // 2 + 1
        shapes = {"y": (T, C), "welch": (F,) if C == 1 else (F, C), "csm": (F, 2 * C, 2 * C)}
        outs = {"y": y.time_data, "welch": sp, "csm": csm}
        for k, v in outs.items():
            if tuple(v.shape) != shapes[k] or not bool(torch.isfinite(v).all()):
                fail(f"{label} {k}: shape {tuple(v.shape)} or non-finite")
        x = sig._x
        rt = float((y._x - x).abs().max())
        print(f"{label}: ISTFT round trip max abs err {rt:.3e} (tol 1e-5)")
        if not rt <= 1e-5:
            fail(f"{label}: the ISTFT does not reconstruct the input")
        ref = plain(lambda: sc.run(sig))
        for k, want in zip(outs, (ref[0].time_data, ref[1], ref[2])):
            err = rel_err(outs[k], want)
            print(f"{label} {k} vs plain paths: scale-rel {err:.3e} (tol 2e-5)")
            if not err <= 2e-5:
                fail(f"{label} {k} disagrees with the plain paths")
        # float64 numpy: the Welch spectrum on every channel; the Welch CSM
        # on 2 channels and their reconstructions (the CSM's entries of
        # those 4 channels of the appended signal)
        x64 = x.double().cpu().numpy()
        welch64 = np_welch(x64)
        err = rel_err(sp, welch64[:, 0] if C == 1 else welch64)
        print(f"{label} welch vs float64 numpy: scale-rel {err:.3e} (tol 1e-4)")
        if not err <= 1e-4:
            fail(f"{label}: the Welch spectrum disagrees with float64 numpy")
        sub = [0, 1] if C > 1 else [0]
        idx = sub + [C + c for c in sub]
        both64 = np.concatenate([x64[sub], x64[sub]])  # y's float64 run is x
        err = rel_err(csm[:, idx][:, :, idx], np_csm_welch(both64))
        print(f"{label} Welch CSM (channels {idx}) vs float64 numpy: scale-rel {err:.3e} "
              "(tol 1e-4)")
        if not err <= 1e-4:
            fail(f"{label}: the Welch CSM disagrees with float64 numpy")
        two = append_signals([sig.get_channels(sub), y.get_channels(sub)])
        two.set_spectrum_parameters(method=SpectrumMethod.FFT)
        fft_csm = two.get_csm(return_device=True)[1].complex_device()
        err_p = rel_err(fft_csm, plain(lambda: two.get_csm(
            force_computation=True, return_device=True)[1].complex_device()))
        err_64 = rel_err(fft_csm, np_csm_fft(both64, next_fast_len(T, True)))
        print(f"{label} FFT-method CSM ({len(idx)} channels, {fft_csm.shape[0]} bins): vs "
              f"plain paths scale-rel {err_p:.3e} (tol 2e-5), vs float64 numpy {err_64:.3e} "
              "(tol 1e-4)")
        if not (err_p <= 2e-5 and err_64 <= 1e-4):
            fail(f"{label}: the FFT-method CSM disagrees")
        del two, fft_csm, ref
        # B1 against its plain version at the chain's shapes: the STFT's
        # padded frames and the CSM's detrended frames of the appended signal
        win = torch.as_tensor(get_window(Window.Hann, sc.WINDOW), dtype=torch.float32,
                              device=dev)
        for xin, pad_, det in ((x, sc.WINDOW // 2, False),
                               (torch.cat([x, y._x]), 0, True)):
            err = float((cuda_framing.windowed_frames_cuda(xin, win, sc.WINDOW // 2, det, pad_)
                         - cuda_framing.windowed_frames_plain(xin, win, sc.WINDOW // 2, det,
                                                              pad_)).abs().max())
            b1_err = max(b1_err, err)
            print(f"{label}: B1 x {tuple(xin.shape)} pad={pad_} detrend={det} vs plain: "
                  f"max abs err {err:.3e} (tol 1e-6)")
            if not err <= 1e-6:
                fail(f"{label}: B1 disagrees with its plain version")
        k_ms, p_ms = time_pair(lambda: sc.run(sig), lambda: plain(lambda: sc.run(sig)))
        audio = C * seconds
        print(f"time {label} [{card}]: kernels {k_ms:.4f} ms ({audio / (k_ms * 1e-3):.1f} "
              f"audio-s/s), plain paths {p_ms:.4f} ms ({audio / (p_ms * 1e-3):.1f} audio-s/s)")
        times.append({"size": name, "shape": [C, T], "ms": k_ms, "plain_ms": p_ms})
        if name == "(b)":
            minute = sig
        del y, sp, csm, outs
    return {"framing": launches, "framing_err": b1_err, "times": times, "minute": minute,
            "csm": gram_launches}


def activity_mask_f64(x, threshold_dbfs: float, release: float):
    """The activity detector's recursion, sequential in float64 numpy on
    ``x`` normalised to its peak: g[i] = c·p[i] + (1 − c)·g[i−1] with c the
    release coefficient where the previous power is > 0, else 0. Returns
    the mask and the gain in dB."""
    import numpy as np

    p = (np.asarray(x, np.float64) / np.max(np.abs(x))) ** 2
    c = np.where(p[:-1] > 0, release, 0.0)
    g = np.zeros_like(p)
    gi = 0.0
    for i, (ci, pi) in enumerate(zip(c.tolist(), p[1:].tolist()), start=1):
        gi = ci * pi + (1 - ci) * gi
        g[i] = gi
    with np.errstate(divide="ignore"):
        db = 10 * np.log10(g)
    return db > threshold_dbfs, db


def standard_phase(dev, sig, card: str) -> dict:
    """The standard functions on config 2's 16 × 60 s recording (c):
    `lufs_integrated` on 5 channels (its K-weighting through B2),
    `true_peak_level`, `rms` and `crest_factor` on all 16, `latency` of the
    16 channels against copies shifted by `delay` and `fractional_delay`,
    `activity_detector` on one channel with a zero-phase high-pass
    pre-filter (B2, two leads), `envelope`; and `lufs_integrated` of a
    full-scale sine of the same length (−3.01 LUFS). Counted; B2's outputs against
    the plain paths (2e-5) and scipy float64 (5e-6); each call against the
    plain paths, and timed with its device idle share
    (`tools.profile_chain.profile_call`). Returns B2's launches and error."""
    import numpy as np
    import torch
    from scipy.signal import sosfilt as scipy_sosfilt
    from scipy.signal import sosfiltfilt

    from dsptoolbox_tpu_torch import generators, standard
    from dsptoolbox_tpu_torch.helpers.smoothing import get_smoothing_factor_ema
    from dsptoolbox_tpu_torch.standard.gain_and_level import _k_weighting
    from dsptoolbox_tpu_torch.tools import speech_chain as sc
    from dsptoolbox_tpu_torch.tools.profile_chain import profile_call

    fs, C, T = sig.sampling_rate_hz, sig.number_of_channels, sig.length_samples
    label = f"standard (c) {C} ch x {T / fs:g} s"
    calls = sc.standard_calls(sig)
    five = sig.get_channels(list(range(5)))
    hp = sc.activity_pre_filter(fs)
    shift, frac_shift = sc.SHIFT, sc.FRACTIONAL_SHIFT
    out, launches = {}, {}
    for name, fn in calls.items():
        out[name], launches[name] = counted_run(fn)
    print(f"{label}: launches {launches}")
    # a steady full-scale 997 Hz sine of the recording's length: -3.01 LUFS
    # (`tests/test_standard.py:146-152`), its K-weighting through B2; without
    # the default 3 s fades, which lower a minute's gated loudness to -3.17
    sine = generators.oscillator(997.0, fs, T / fs, peak_level_dbfs=0.0, fade=None)
    lufs_sine, launches["lufs_integrated (sine)"] = counted_run(
        lambda: standard.lufs_integrated(sine))
    print(f"{label}: lufs_integrated of a full-scale 997 Hz sine {lufs_sine:.4f} LUFS "
          "(-3.01 +- 0.07)")
    if abs(lufs_sine + 3.01) > 0.07 or launches["lufs_integrated (sine)"]["iir_lead"] < 1:
        fail(f"{label}: lufs_integrated of a full-scale sine is off or did not run B2")
    b2 = sum(v["iir_lead"] for v in launches.values())
    if (launches["lufs_integrated (5 ch, B2)"]["iir_lead"] < 1
            or launches["activity_detector (zero-phase pre-filter, B2)"]["iir_lead"] < 2):
        fail(f"{label}: lufs_integrated or activity_detector did not run B2")

    # B2's outputs: the K-weighted 5 channels and the activity pre-filter
    k_filter = _k_weighting(fs)
    x64 = five._x.double().cpu().numpy()
    kw = k_filter.filter_signal(five)._x
    kw_p = plain(lambda: k_filter.filter_signal(five)._x)
    act_ch = sig.get_channels(sc.ACTIVITY_CHANNEL)
    zp = hp.filter_signal(act_ch, zero_phase=True)._x
    zp_p = plain(lambda: hp.filter_signal(act_ch, zero_phase=True)._x)
    act64 = act_ch._x[0].double().cpu().numpy()
    zp64 = np.ascontiguousarray(sosfiltfilt(hp.sos, act64))
    b2_err = max(float((kw - kw_p).abs().max()), float((zp - zp_p).abs().max()))
    for what, got, want_p, want_64 in (
        ("K-weighting (5 ch)", kw, kw_p, scipy_sosfilt(k_filter.sos, x64, axis=-1)),
        ("activity pre-filter, zero phase", zp, zp_p, zp64[None]),
    ):
        e_p, e_64 = rel_err(got, want_p), rel_err(got, want_64)
        print(f"{label}: {what} (B2) vs plain paths scale-rel {e_p:.3e} (tol 2e-5), vs scipy "
              f"f64 {e_64:.3e} (tol 5e-6)")
        if not (e_p <= 2e-5 and e_64 <= 5e-6):
            fail(f"{label}: {what} disagrees")

    # each call against the plain paths
    ref = {name: plain(fn) for name, fn in calls.items()}
    lufs = out["lufs_integrated (5 ch, B2)"]
    d = abs(lufs - ref["lufs_integrated (5 ch, B2)"])
    print(f"{label}: lufs_integrated {lufs:.4f} LUFS, vs plain paths {d:.2e} LU (tol 1e-3)")
    if not d <= 1e-3:
        fail(f"{label}: lufs_integrated disagrees with the plain paths")
    for name in ("true_peak_level", "rms", "crest_factor"):
        got = np.atleast_2d(np.asarray(out[name]))
        want = np.atleast_2d(np.asarray(ref[name]))
        d = float(np.abs(got - want).max())
        print(f"{label}: {name} mean {got.mean(axis=-1).round(3).tolist()} dB, vs plain "
              f"paths max {d:.2e} dB (tol 1e-4)")
        if got.shape[-1] != C or not np.all(np.isfinite(got)) or not d <= 1e-4:
            fail(f"{label}: {name} disagrees with the plain paths or is not finite")
    lat, corr = out["latency vs delay"]
    lat_f, corr_f = out["latency vs fractional_delay (polynomial 2)"]
    print(f"{label}: latency vs delay({shift}): {sorted(set(lat.tolist()))}, correlation min "
          f"{corr.min():.6f}; vs fractional_delay({frac_shift}): "
          f"{np.round(lat_f, 3).tolist()[:4]}..., max |err| {np.abs(lat_f - frac_shift).max():.3f} "
          f"(tol 0.5), correlation min {corr_f.min():.6f}")
    if not (np.all(lat == shift) and np.all(np.abs(lat_f - frac_shift) < 0.5)
            and corr.min() > 0.99):
        fail(f"{label}: latency does not recover the delays")
    # the activity mask against the float64 recursion and the plain paths
    _, others = out["activity_detector (zero-phase pre-filter, B2)"]
    mask = others["signal_indices"]
    release = get_smoothing_factor_ema(25e-3, fs)
    t0 = time.perf_counter()
    mask64, db64 = activity_mask_f64(zp64, sc.ACTIVITY_THRESHOLD_DB, release)
    flips = np.flatnonzero(mask != mask64)
    flips_p = np.flatnonzero(mask != ref["activity_detector (zero-phase pre-filter, B2)"][1][
        "signal_indices"])
    edge = float(np.abs(db64[flips] - sc.ACTIVITY_THRESHOLD_DB).max()) if flips.size else 0.0
    print(f"{label}: activity mask {mask.mean():.4f} active; {flips.size} flips of {T} vs the "
          f"float64 recursion (farthest {edge:.2e} dB from the threshold), {flips_p.size} vs "
          f"the plain paths; float64 recursion {time.perf_counter() - t0:.1f} s on the host")
    if flips.size > 1e-3 * T or edge > 1e-2:
        fail(f"{label}: the activity mask flips beyond the threshold's edge")
    env = out["envelope"]
    err = rel_err(env, ref["envelope"])
    print(f"{label}: envelope {tuple(env.shape)} vs plain paths scale-rel {err:.3e} (tol 2e-5)")
    if tuple(env.shape) != (T, C) or not err <= 2e-5:
        fail(f"{label}: envelope disagrees with the plain paths")
    del ref

    # times: CUDA events and the device's idle share, a few calls each
    for name, fn in calls.items():
        r = profile_call(f"{label}: {name}", fn, runs=2, host_calls=3, event_calls=5, warm=1)
        print(f"time {label} {name} [{card}]: {r['events_ms']:.3f} ms (CUDA events), device "
              f"busy {r['busy_us']:.0f} us, idle share {r['idle']:.4f}")
    return {"iir_lead": b2, "iir_lead_err": b2_err}


def np_burg(x, order: int):
    """Burg's method in float64 numpy over the last axis of ``x (..., L)``:
    (coefficients ``(..., order+1)``, prediction error)."""
    import numpy as np

    fwd, bwd = x[..., 1:], x[..., :-1]
    a = np.zeros(x.shape[:-1] + (order + 1,))
    a[..., 0] = 1.0
    den = np.sum(fwd**2 + bwd**2, axis=-1)
    for i in range(order):
        k = -2.0 * np.sum(bwd * fwd, axis=-1) / (den + np.finfo(np.float64).eps)
        a[..., 1 : i + 2] = a[..., 1 : i + 2] + k[..., None] * a[..., i::-1]
        fwd, bwd = fwd + k[..., None] * bwd, bwd + k[..., None] * fwd
        den = (1.0 - k**2) * den - bwd[..., -1] ** 2 - fwd[..., 0] ** 2
        fwd, bwd = fwd[..., 1:], bwd[..., :-1]
    return a, den


def np_yule_walker(x, order: int):
    """Yule-Walker in float64 numpy over the last axis of ``x (..., L)``:
    the biased autocorrelation, then Levinson-Durbin."""
    import numpy as np

    L = x.shape[-1]
    r = np.stack([np.sum(x[..., : L - k] * x[..., k:], axis=-1) for k in range(order + 1)],
                 axis=-1) / L
    a = np.zeros(x.shape[:-1] + (order + 1,))
    a[..., 0] = 1.0
    err = r[..., 0].copy()
    for i in range(1, order + 1):
        k = -np.sum(a[..., :i] * r[..., i:0:-1], axis=-1) / err
        a[..., : i + 1] = a[..., : i + 1] + k[..., None] * a[..., i::-1]
        err = err * (1.0 - k**2)
    return a, err


def np_allpass_scans(x, lam: float):
    """The JAX package's warping and Laguerre scans in float64 (scipy's
    lfilter T times): ``Σₙ x[n]·Aⁿδ`` and, for the transpose, output k the
    last sample of Aᵏ applied to the reversed x; x ``(T, C)``."""
    import numpy as np
    from scipy.signal import lfilter

    T = len(x)
    d = np.zeros(T)
    d[0] = 1.0
    warped = d[:, None] * x[0][None]
    for n in range(1, T):
        d = lfilter([-lam, 1.0], [1.0, -lam], d)
        warped += d[:, None] * x[n][None]
    cur = x[::-1].T.copy()
    rows = [cur[:, -1]]
    for _ in range(1, T):
        cur = lfilter([-lam, 1.0], [1.0, -lam], cur, axis=-1)
        rows.append(cur[:, -1])
    return warped, np.array(rows)


def device_kernels(fn) -> int | None:
    """CUDA kernels that one call of ``fn`` launches, from `torch.profiler`
    (None where the profiler records no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def features_phase(dev, session, irs, card: str) -> dict:
    """The transforms path (`tools/feature_chain.py`) at full size: (a) the
    STFT features, Hilbert and the DFT on config 2's 16 × 60 s session, (b)
    the filter-bank spectrum at the 31 third-octave centres, parallel (B3)
    and zero phase (B2), (c) CWT (plain, synchrosqueezed) and VQT on 10 s of
    music at 44.1 kHz, (d) LPC (Yule-Walker, Burg, synthesis) on the session
    at 16 kHz, (e) warping and Laguerre on the measured room's 16 windows of
    65,536 samples. Counted (B1, B2, B3), each kernel against its plain
    version at the path's shapes; log-mel, MFCC and chroma against a float64
    numpy STFT times the same matrices; Hilbert against scipy float64; the
    DFT, the CWT (4 scales) against float64 direct sums; the spectra
    against scipy float64 from 100 Hz; LPC against float64 numpy Burg and
    Yule-Walker, its synthesis against scipy's lfilter on the same noise;
    warping and Laguerre against the float64 recursion of the JAX package's
    scans at 4096 samples, at 65,536 against a float64 run of another tile
    width. Each step timed with CUDA events (median of 20, of 5 for the
    host-bound ones), the steps with kernels against the plain paths.
    Returns the kernels' launches and errors on the path and the times."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor as Pool
    from scipy.signal import hilbert as scipy_hilbert
    from scipy.signal import lfilter, sosfilt, sosfiltfilt

    from dsptoolbox_tpu_torch import transforms as tr
    from dsptoolbox_tpu_torch.classes import Filter
    from dsptoolbox_tpu_torch.classes.filterbank import _sos_bank_or_none
    from dsptoolbox_tpu_torch.generators.generators import _generator
    from dsptoolbox_tpu_torch.ops import cuda_framing, cuda_iir_bank, iir, iir_block
    from dsptoolbox_tpu_torch.ops.framing import reconstruct_framed_signal
    from dsptoolbox_tpu_torch.ops.windows import get_window
    from dsptoolbox_tpu_torch.standard.enums import FilterPassType, Window
    from dsptoolbox_tpu_torch.tools import feature_chain as fc
    from dsptoolbox_tpu_torch.transforms import _backend as tb

    t_phase = time.perf_counter()
    fs, C, T = session.sampling_rate_hz, session.number_of_channels, session.length_samples
    music = fc.music()
    lpc_sig = fc.lpc_signal(session)
    torch.cuda.synchronize()
    out = {"times": []}

    def timed(label: str, fn, n: int = N_TIMED, plain_too: bool = False) -> None:
        fns = (fn, lambda: plain(fn)) if plain_too else (fn,)
        ms = time_pair(*fns, n=n, warm=1)
        line = f"time features {label}: {ms[0]:.4f} ms"
        if plain_too:
            line += f", plain paths {ms[1]:.4f} ms"
        print(f"{line} (median of {n}; {card})")
        out["times"].append({"step": label, "ms": ms[0],
                             "plain_ms": ms[1] if plain_too else None})

    def check(label: str, err: float, tol: float, what: str = "scale-rel") -> None:
        print(f"features {label}: {what} {err:.3e} (tol {tol:g})")
        if not err <= tol:
            fail(f"features {label} is off")

    # 30. the path once, counted (the session's STFT not cached)
    session._cache.clear()
    res, launched = counted_run(lambda: fc.run(session, music, lpc_sig, irs))
    print(f"features: launches {launched} (B1: the STFT once and each lpc once; B3 the "
          f"parallel bank; B2 forward and backward for each of the {len(fc.THIRD_OCTAVES)} "
          "zero-phase bands)")
    if (launched["framing"] != 4 or launched["iir_bank"] < 1
            or launched["iir_lead"] != 2 * len(fc.THIRD_OCTAVES)):
        fail("features: the path did not go through B1, B3 and B2 as it should")
    out.update(framing=launched["framing"], iir_bank=launched["iir_bank"],
               iir_lead=launched["iir_lead"])

    # 31. the kernels against their plain versions at the path's shapes:
    # B1 at the STFT's and LPC's frames, B3 at the bank, B2 at one zero-phase band
    win = torch.as_tensor(get_window(Window.Hann, 1024), dtype=torch.float32, device=dev)
    win512 = torch.as_tensor(get_window(Window.Hann, fc.LPC_WINDOW), dtype=torch.float32,
                             device=dev)
    b1_err = 0.0
    for xin, w, step, pad in ((session._x, win, 512, 512),
                              (lpc_sig._x, win512, fc.LPC_HOP, 0)):
        err = float((cuda_framing.windowed_frames_cuda(xin, w, step, False, pad)
                     - cuda_framing.windowed_frames_plain(xin, w, step, False, pad)
                     ).abs().max())
        b1_err = max(b1_err, err)
        check(f"B1 x {tuple(xin.shape)} L={w.shape[0]} step={step} pad={pad} vs plain", err,
              1e-6, "max abs err")
    factor = 2 ** (1 / 6)
    filters = [Filter.iir_filter(fc.BANK_ORDER, [f / factor, f * factor],
                                 FilterPassType.Bandpass, fs) for f in fc.THIRD_OCTAVES]
    bank = _sos_bank_or_none(filters)
    ops, rest = iir_block.bank_kernel_stages(bank, T, dev)
    lead = ops["n_full"] * ops["L"]
    y_k = torch.empty((1, len(bank), C, T), device=dev)
    y_p = torch.empty_like(y_k)
    on_chip = cuda_iir_bank.state_on_chip
    cuda_iir_bank.sosfilt_bank_lead_cuda(ops, session._x, y_k)
    on_chip = cuda_iir_bank.state_on_chip - on_chip
    cuda_iir_bank.sosfilt_bank_lead_plain(ops, session._x, y_p)
    torch.cuda.synchronize()
    b3_err = float((y_k[..., :lead] - y_p[..., :lead]).abs().max())
    scale = float(y_p[..., :lead].abs().max())
    print(f"features: B3 bank (B, R, T) = {(len(bank), C, T)}, {ops['kernel']['lanes']} lanes, "
          f"L = {ops['L']}, {len(rest[0]) if rest else 0} more stages, state on chip "
          f"{on_chip}; |dy| {b3_err:.3e} <= 1e-5*{scale:.3e}")
    wide = cuda_iir_bank.keeps_state_on_chip(ops["L"], len(bank), ops["kernel"]["lanes"])
    if rest or on_chip != wide or not b3_err <= 1e-5 * scale:
        fail("features: B3 disagrees with its plain version at the bank")
    k_ms, p_ms = time_pair(lambda: cuda_iir_bank.sosfilt_bank_lead_cuda(ops, session._x, y_k),
                           lambda: cuda_iir_bank.sosfilt_bank_lead_plain(ops, session._x, y_p),
                           n=5, warm=1)
    nb, f32, f64, f64_mm = bank_bound(ops, C)
    b3_bound, b3_by = bound(nb, 0.0, f64, f64_mm, f32)
    print(f"time features B3 bank (B, R, K, L) = {(len(bank), C, ops['n_full'], ops['L'])}: "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b3_bound:.4f} ms ({b3_by}, "
          f"{k_ms / b3_bound:.2f}×) (median of 5; {card})")
    out["iir_bank_time"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b3_bound,
                            "bound_by": b3_by}
    del y_k, y_p
    sos_1k = filters[17].sos
    z_k = iir.sosfiltfilt(sos_1k, session._x)
    z_p = plain(lambda: iir.sosfiltfilt(sos_1k, session._x))
    b2_err = float((z_k - z_p).abs().max())
    check(f"B2 zero-phase 1 kHz band x {tuple(session._x.shape)} vs plain", b2_err,
          1e-5 * float(z_p.abs().max()), "max abs err")
    out.update(framing_err=b1_err, iir_bank_err=b3_err, iir_lead_err=b2_err)
    del z_k, z_p

    # 32. (a) against float64 numpy on 2 channels: the STFT power times the
    # same matrices, Hilbert against scipy, the DFT against direct sums
    sub = [0, 1]
    x64 = session._x[sub].double().cpu().numpy()
    P64 = np.abs(np.fft.rfft(np_frames(x64, 1024, 512, pad=512), axis=-1)) ** 2  # (2, K, F)
    f_hz = np.fft.rfftfreq(1024, 1 / fs)
    t_s, f_mel, logmel = res["(a) log_mel_spectrogram"]
    mfilt = tr.mel_filterbank(f_hz, None, fc.N_MELS)[0]
    mel64 = np.maximum(P64 @ mfilt.T, np.finfo(np.float32).tiny)  # (2, K, B)
    want = 10 * np.log10(mel64).transpose(2, 1, 0)
    got = logmel[..., sub]
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"features log-mel: shape {got.shape}, want {want.shape}, or non-finite")
    check("(a) log-mel (40 bands) vs float64 numpy, dB", float(np.abs(got - want).max()), 1e-2,
          "max abs dB")
    k = np.arange(fc.N_MELS)
    dct = 2.0 * np.cos(np.pi * k[:, None] * (2 * k[None, :] + 1) / (2 * fc.N_MELS))
    check("(a) MFCC vs float64 numpy", rel_err(res["(a) mfcc"][2][..., sub],
                                               np.abs(np.einsum("nb,bkc->nkc", dct, want))),
          1e-3)
    _, chroma, pitch = res["(a) chroma_stft"]
    pf = 440.0 * 2 ** ((np.arange(128) - 69) / 12)
    pm = ((f_hz[None] >= pf[:, None] * 2 ** (-1 / 24))
          & (f_hz[None] < pf[:, None] * 2 ** (1 / 24))).astype(float)
    cm = (np.arange(128)[None] % 12 == np.arange(12)[:, None]).astype(float)
    pitch64 = P64 @ pm.T
    check("(a) chroma vs float64 numpy", rel_err(chroma[..., sub], np.log1p(
        0.5 * pitch64 @ cm.T).transpose(2, 1, 0)), 1e-3)
    check("(a) pitch features vs float64 numpy", rel_err(pitch[..., sub], np.log1p(
        0.5 * pitch64).transpose(2, 1, 0)), 1e-3)
    h = res["(a) hilbert"]
    z = torch.complex(h._x[sub], h._x_imag[sub]).cpu().numpy()
    check("(a) hilbert vs scipy float64", float(np.abs(z - scipy_hilbert(x64, axis=-1)).max()),
          1e-4, "max abs err")
    spec = res["(a) dft at 31 third-octave centres"]
    n = np.arange(T)
    picks = (0, 15, 30)
    want = [np.sum(np.exp(-2j * np.pi * fc.THIRD_OCTAVES[i] * n / fs) * x64[0]) for i in picks]
    check("(a) DFT at 20 Hz, 630 Hz, 20 kHz (channel 0) vs a float64 direct sum",
          rel_err(spec[list(picks), 0], np.array(want)), 2e-4)
    del P64, mel64, want, x64

    # 33. (b) the spectra against scipy float64 on channel 0, bands in threads
    x0 = session._x[0].double().cpu().numpy()
    for name, run in (("", sosfilt), (", zero phase", sosfiltfilt)):
        got = res["(b) spectrum_via_filterbank" + name].spectral_data[:, 0].cpu().numpy()
        with Pool(8) as pool:
            want = np.array(list(pool.map(lambda f: run(f.sos, x0).std(), filters)))
        errs = np.abs(got - want) / want
        high = fc.THIRD_OCTAVES >= 100
        print(f"features (b) spectrum{name} below 100 Hz vs scipy float64: rel "
              + ", ".join(f"{f:.0f} Hz {e:.1e}" for f, e in zip(fc.THIRD_OCTAVES[~high],
                                                               errs[~high])))
        check(f"(b) spectrum{name} from 100 Hz vs scipy float64 (channel 0)",
              float(errs[high].max()), 1e-4, "max rel err")

    # 34. (c) the CWT against float64 direct sums at 4 scales, 4096 samples
    xm = music._x[0].double().cpu().numpy()
    cw = res["(c) cwt"]
    picks = np.linspace(0, len(xm) - 1, 4096).astype(int)
    wavelet = fc.morlet()
    err = 0.0
    for fi in (0, 21, 42, 63):
        w = np.asarray(wavelet.get_wavelet(fc.CWT_FREQUENCIES[fi], fc.MUSIC_FS))
        w = w / np.abs(w).sum()
        start = (len(w) - 1) // 2
        xp = np.pad(xm, (len(w), len(w)))
        # "same": y[n] = Σ_k w[k]·x[n + start − k]
        idx = picks[:, None] + start - np.arange(len(w))[None] + len(w)
        want = (xp[idx] * w[None]).sum(axis=1)
        err = max(err, rel_err(cw[fi, picks, 0], want))
    check("(c) CWT at 4 scales vs float64 direct sums", err, 2e-4)
    sq = res["(c) cwt, synchrosqueezed"]
    two = tb.squeeze_scalogram(cw, fc.CWT_FREQUENCIES, fc.MUSIC_FS)
    check("(c) synchrosqueezed CWT vs the two-stage squeeze_scalogram", rel_err(sq, two), 1e-5)
    f_v, vq = res["(c) vqt"]
    head = music.copy_with_new_time_data(music._x[:, : fc.MUSIC_FS].T.cpu())
    vq_cpu = tr.vqt(head, return_device=True)[1]
    head_gpu = tr.vqt(music.copy_with_new_time_data(music._x[:, : fc.MUSIC_FS].T),
                      return_device=True)[1]
    # 24 bins an octave over 5 octaves (its frequency vector has 12 an
    # octave, as the JAX package's: `transforms.py:655-657`)
    if tuple(vq.shape) != (120, music.length_samples, 1) or not bool(
            torch.isfinite(torch.view_as_real(vq)).all()):
        fail("features (c) vqt: shape or non-finite")
    check("(c) VQT (first second) vs the CPU", rel_err(head_gpu, vq_cpu), 1e-5)
    del cw, sq, two

    # 35. (d) LPC against float64 numpy on channel 0's frames; the synthesis
    # against scipy's lfilter on the same noise
    frames = cuda_framing.windowed_frames(lpc_sig._x, win512, fc.LPC_HOP, False)
    f0 = frames[0].double().cpu().numpy()  # (K, L)
    K = f0.shape[0]
    for name, oracle in (("Yule-Walker", np_yule_walker), ("Burg", np_burg)):
        a, e = res[f"(d) lpc, {name}"]
        wa, we = oracle(f0, fc.LPC_ORDER)
        check(f"(d) LPC {name} order {fc.LPC_ORDER}, {K} frames vs float64 numpy",
              max(rel_err(a[:, :, 0].T, wa), rel_err(e[:, 0], we)), 1e-6)
    a, var = res["(d) lpc, Burg"]
    noise = torch.randn((lpc_sig.number_of_channels, K, fc.LPC_WINDOW),
                        generator=_generator(fc.LPC_SEED, dev), dtype=torch.float64, device=dev)
    src = (noise[0] * torch.as_tensor(np.sqrt(np.maximum(var[:, 0], 0)), device=dev)[:, None]
           ).cpu().numpy()
    synth = np.stack([lfilter([1.0], a[:, k, 0], src[k]) for k in range(K)])
    rec = reconstruct_framed_signal(torch.from_numpy(synth).float(), fc.LPC_HOP,
                                    get_window(Window.Hann, fc.LPC_WINDOW),
                                    lpc_sig.length_samples)
    syn = res["(d) lpc, Burg with synthesis"]
    check("(d) LPC synthesis (channel 0) vs scipy lfilter on the same noise",
          rel_err(syn._x[0], rec * syn.amplitude_scale_factor), 1e-5)

    # 36. (e) warping and Laguerre at 4096 samples against the float64
    # recursions (4 channels), warping at 65,536 against a float64 run
    lam = tb.get_warping_factor(fc.WARP_SCALE, fs)
    t0 = time.perf_counter()
    w64, _ = np_allpass_scans(irs._x[:4, : fc.WARP_LENGTH].T.double().cpu().numpy(), lam)
    lag_in = fc.laguerre_input(irs)
    lam_l = fc.LAGUERRE_FACTOR
    xl = lag_in._x[:4].double().cpu().numpy()
    hp_ = np.sqrt(1 - lam_l**2) * (-lam_l) ** np.arange(fc.WARP_LENGTH)
    u = np.stack([np.convolve(row[::-1], hp_)[: fc.WARP_LENGTH] for row in xl])
    _, l64 = np_allpass_scans(u[:, ::-1].T.copy(), -lam_l)
    print(f"features (e): float64 recursions {time.perf_counter() - t0:.1f} s on the host")
    # (the outputs are IRs that constrain their amplitude: the oracles scaled alike)
    warped = res[f"(e) warp {fc.WARP_SCALE}, {fc.WARP_LENGTH} samples"][0]
    check(f"(e) warp {fc.WARP_SCALE} (lambda {lam:.4f}), {fc.WARP_LENGTH} samples vs the float64 "
          "recursion", rel_err(warped._x[:4].T, w64 * warped.amplitude_scale_factor), 5e-4)
    lag = res[f"(e) laguerre {lam_l}, {fc.WARP_LENGTH} samples"]
    check(f"(e) laguerre {lam_l}, {fc.WARP_LENGTH} samples vs the float64 recursion",
          rel_err(lag._x[:4].T, l64 * lag.amplitude_scale_factor), 1e-4)
    whole = res[f"(e) warp {fc.WARP_SCALE}, whole IR"][0]
    M = tb._tile(*irs._x.T.shape)
    ref64 = tb.allpass_apply(irs._x.T.double(), lam, tile=2 * M)
    check(f"(e) warp, {irs.length_samples} samples, float32 vs float64 at tile {2 * M}",
          rel_err(whole._x.T, ref64 * whole.amplitude_scale_factor), 1e-5)
    del ref64, whole

    # 37. no launch per output sample: device kernels of one call
    for name in (f"(e) warp {fc.WARP_SCALE}, whole IR",
                 f"(e) laguerre {lam_l}, {fc.WARP_LENGTH} samples",
                 "(d) lpc, Burg with synthesis"):
        fn = fc.calls(session, music, lpc_sig, irs)[name]
        n_k = device_kernels(fn)
        print(f"features {name}: {n_k if n_k is not None else 'not measured'} device kernels "
              "a call")
        out.setdefault("device_kernels", {})[name] = n_k

    # 38. times
    host_bound = {"(b) spectrum_via_filterbank, zero phase", f"(e) warp {fc.WARP_SCALE}, whole IR",
                  "(d) lpc, Yule-Walker", "(d) lpc, Burg", "(d) lpc, Burg with synthesis",
                  "(c) vqt", "(c) cwt, synchrosqueezed"}
    with_kernels = {"(a) log_mel_spectrogram", "(a) mfcc", "(a) chroma_stft",
                    "(b) spectrum_via_filterbank", "(b) spectrum_via_filterbank, zero phase",
                    "(d) lpc, Yule-Walker", "(d) lpc, Burg", "(d) lpc, Burg with synthesis"}
    for name, fn in fc.calls(session, music, lpc_sig, irs).items():
        if name in fc.STFT_STEPS:
            step = (lambda f=fn: (session._cache.clear(), f()))  # the STFT included
        else:
            step = fn
        timed(name, step, n=5 if name in host_bound else N_TIMED,
              plain_too=name in with_kernels)
    print(f"features phase: {time.perf_counter() - t_phase:.1f} s")
    return out

def np_quadratic(h, C):
    """``Re(h^H C_f h)`` in float64 numpy, ``(G, F)``."""
    import numpy as np

    return np.einsum("fmg,fmg->gf", np.conj(h), C @ h).real


def np_das_time(x, ds, r0: float, fs: int, c: float, total: int):
    """Time-domain DAS in float64 numpy by direct convolution of ``x (M,
    T)``, on the grid points of ``ds (M, G')`` (mic-to-point distances),
    delays referred to the distance ``r0``: each pair's Kaiser-sinc FIR
    through `np.convolve`, shifted by its integer delay, times the distance
    over the mic count, summed over the mics. Returns ``(total, G')``."""
    import numpy as np

    from dsptoolbox_tpu_torch.standard.backend import fractional_delay_filter_batch

    M, G = ds.shape
    s, h = fractional_delay_filter_batch(((r0 - ds) / c * fs).ravel(), 30, 60)
    s, h = s.reshape(M, G), h.reshape(M, G, -1)
    out = np.zeros((total, G))
    for g in range(G):
        for m in range(M):
            y = np.convolve(x[m], h[m, g])
            lo, hi = max(0, s[m, g]), min(total, s[m, g] + len(y))
            out[lo:hi, g] += ds[m, g] / M * y[lo - s[m, g]:hi - s[m, g]]
    return out


def config5_phase(dev, card: str) -> dict:
    """Config 5 through the public API (`tools/camera.map_calls`: 64 mics,
    900 points, the 2 kHz third octave) on the 0.5 s × 16 kHz and the 10 s ×
    48 kHz recording: DAS, MVDR (loaded), MVDR's reference form (on the
    recording plus sensor noise of σ = 1e-3), Functional, CLEAN-SC (128
    iterations) and Orthogonal (32 eigenvalues); `BeamformerDASTime` on the
    0.5 s recording. Each map counted (B5 once for DAS, the reference form,
    Functional and CLEAN-SC); B5 held against its plain version at each of
    those maps' matrices; each map against the plain paths and a float64
    numpy oracle on the same CSM (`CONFIG5_BOUNDS`; CLEAN-SC against the
    host oracle loop in float64 on every bin; Orthogonal's picks against
    the float64 maps of the same eigenpairs; DAS-time against a float64
    direct convolution on 16 points), with the oracle's argmax; timed with
    CUDA events against the plain paths, with the device's idle share
    (`tools.profile_chain.profile_call`). Returns the launches, B5's error
    at these matrices and the times."""
    import numpy as np
    import torch
    from scipy.integrate import simpson

    from dsptoolbox_tpu_torch import _config
    from dsptoolbox_tpu_torch.beamforming import beamforming as bfm
    from dsptoolbox_tpu_torch.ops import cuda_das
    from dsptoolbox_tpu_torch.tools import camera
    from dsptoolbox_tpu_torch.tools.profile_chain import profile_call

    g = camera.grid()
    G = g.number_of_points
    src = g.find_nearest_point(camera.SOURCE_NEAR)[0]
    band = (camera.CENTER_HZ, camera.OCTAVE_FRACTION)
    totals = {"framing": 0, "das_map": 0}
    b5_err, times = 0.0, []

    def check(ok, what):
        if not ok:
            fail(f"config 5 {what}")

    for seconds, fs in CAMERA_RUNS:
        label = f"config 5 {seconds} s x {fs} Hz"
        steps = {"start": time.perf_counter()}
        sig = camera.array_signal(seconds, fs, dev, g)
        noisy = camera.with_sensor_noise(sig)
        calls = camera.map_calls(sig, g, noisy)
        steps["setup"] = time.perf_counter()
        # counted: the first call of each map (DAS computes the recording's
        # CSM, the reference form the noisy one's)
        maps = {}
        for name, fn in calls.items():
            maps[name], launched = counted_run(fn)
            for kernel in totals:
                totals[kernel] += launched[kernel]
            print(f"{label} {name}: launches {launched}")
            check(launched["das_map"] == CONFIG5_B5[name],
                  f"{label} {name}: B5 launched {launched['das_map']} times, not "
                  f"{CONFIG5_B5[name]}")
            if name in ("das", "mvdr_reference"):  # the first map of each signal
                check(launched["framing"] >= 1, f"{label} {name}: the CSM did not run B1")
            m = maps[name]
            check(tuple(m.shape) == (30, 30) and bool(torch.isfinite(m).all()),
                  f"{label} {name}: shape {tuple(m.shape)} or non-finite")

        steps["counted"] = time.perf_counter()
        # the band's CSMs, wave numbers and float64 steering
        beams = {kind: camera.beamformer(sig, g, kind) for kind in camera.KINDS}
        f, k, C = beams["das"]._band_csm(*band)
        _, _, Cn = camera.beamformer(noisy, g, "mvdr")._band_csm(*band)
        F, M = len(f), C.shape[-1]
        amp, diff = beams["das"]._amp_diff_device()
        h64 = beams["das"].st_vec.get_vector(f * 2 * np.pi / beams["das"].c, g,
                                              camera.planar_array())
        C64 = C.cpu().numpy().astype(np.complex128)
        Cn64 = Cn.cpu().numpy().astype(np.complex128)
        off = 1 - np.eye(M)

        def integrate(m_gf):
            return simpson(m_gf, dx=f[1] - f[0], axis=1)

        # B5 against its plain version at the matrices of the four maps that
        # launch it; C⁻¹ of the reference form by the float32 forward-error
        # bound of both evaluations, 2·γ(4M)·|p|ᵀ|B||p| per point-bin, as
        # its denominators cancel (the bound of the others: 5e-5 of the scale)
        u = 2.0 ** -24
        gamma_4m = 4 * M * u / (1 - 4 * M * u)
        inv64 = np.linalg.inv(Cn64)
        u_, s_, vh_ = np.linalg.svd(C64)
        mats = {"das": C64 * (M / (M - 1) * off), "clean_sc": C64,
                "functional": (u_ * s_[:, None, :] ** 0.1) @ vh_, "mvdr_reference": inv64}
        for name, mat in mats.items():
            t = torch.as_tensor(mat, dtype=torch.complex64, device=dev)
            cre, cim = t.real.contiguous(), t.imag.contiguous()
            yk = cuda_das.das_map_cuda(amp, diff, k, cre, cim)
            yp = cuda_das.das_map_plain(amp, diff, k, cre, cim)
            torch.cuda.synchronize()
            d = (yk - yp).abs().double().cpu().numpy()
            b5_err = max(b5_err, float(d.max()))
            err = rel_err(yk, yp)
            if name == "mvdr_reference":
                absq = np.einsum("fmg,fmg->gf", np.abs(h64), np.abs(mat) @ np.abs(h64)) * 2
                ratio = float((d / (2 * gamma_4m * absq)).max())
                print(f"{label}: B5 on C⁻¹ (F, M, G) = {(F, M, G)} vs plain: scale-rel {err:.3e}, "
                      f"max |diff| / (2·γ(4M)·|p|ᵀ|B||p|) {ratio:.3e} (tol 1)")
                check(ratio <= 1, f"{label}: B5 on C⁻¹ beyond the float32 forward-error bound")
            else:
                print(f"{label}: B5 on the {name} matrix (F, M, G) = {(F, M, G)} vs plain: "
                      f"scale-rel {err:.3e} (tol 5e-5), max abs {float(d.max()):.3e}")
                check(err <= 5e-5, f"{label}: B5 disagrees with its plain version at {name}")

        steps["B5"] = time.perf_counter()
        # float64 oracles on the same CSMs
        d64 = np.einsum("fii->fi", C64).real
        loaded = C64 + 10.0 ** -1 * (d64[:, :, None] * np.eye(M)[None])
        den_ref = np_quadratic(h64, inv64)
        oracle = {
            "das": np.maximum(np_quadratic(h64, mats["das"]), 0.0),
            "mvdr": 1 / np.einsum("fmg,fmg->gf", np.conj(h64), np.linalg.solve(loaded, h64)).real,
            "mvdr_reference": 1 / den_ref,
            "functional": (np_quadratic(h64, mats["functional"])
                           / np.sum(np.abs(h64) ** 2, axis=1).T) ** 10
            * np.sum(np.abs(h64) ** 2, axis=1).T,
        }
        # CLEAN-SC: the host oracle loop in float64 on every bin (it stops
        # after a few iterations) against the device loop's bins
        t0 = time.perf_counter()
        hH = np.swapaxes(h64, 1, 2).conj()
        map0 = np_quadratic(h64, C64)
        oracle["clean_sc"] = np.stack([
            bfm.clean_sc_deconvolve(map0[:, i].copy(), C64[i], h64[i], hH[i], 2 * M, False, 0.5)
            for i in range(F)], axis=1)
        t_csc = time.perf_counter() - t0
        bins = beams["clean_sc"]._bin_maps(*band)[1].double().cpu().numpy()
        for i in (0, F // 2, F - 1):
            o = oracle["clean_sc"][:, i]
            ok = np.allclose(bins[:, i], o, rtol=1e-3, atol=1e-5 * np.abs(o).max())
            print(f"{label}: CLEAN-SC bin {i} ({f[i]:.1f} Hz) vs the float64 host loop: max "
                  f"|diff| / max {np.abs(bins[:, i] - o).max() / np.abs(o).max():.3e} (rtol "
                  f"1e-3, atol 1e-5 max), argmax {int(bins[:, i].argmax())} / {int(o.argmax())}")
            check(ok and int(bins[:, i].argmax()) == int(o.argmax()),
                  f"{label}: CLEAN-SC's device loop disagrees with its host oracle")
        check(np.allclose(bins, oracle["clean_sc"], rtol=1e-3,
                          atol=1e-5 * np.abs(oracle["clean_sc"]).max()),
              f"{label}: CLEAN-SC's device loop disagrees with its host oracle on a bin")
        print(f"{label}: CLEAN-SC float64 host loop on all {F} bins {t_csc:.2f} s")
        # Orthogonal: the port's picks on the same eigenpairs; each pick a
        # maximum of the float64 map within 1e-5 (mirror points of the
        # symmetric grid tie to rounding), the map of those picks in float64
        w64, v64 = np.linalg.eigh(C64)
        E = M // 2
        v64 = np.ascontiguousarray(v64[:, :, ::-1][:, :, :E])
        w64 = np.ascontiguousarray(w64[:, ::-1][:, :E])
        idx, vals = bfm._orthogonal_picks(
            beams["orthogonal"]._steering(k),
            torch.as_tensor(v64, dtype=torch.complex64, device=dev),
            torch.as_tensor(w64, dtype=torch.float32, device=dev))
        idx = idx.cpu().numpy()
        prod = np.abs(np.conj(h64).transpose(0, 2, 1) @ v64) ** 2  # (F, G, E)
        picked = np.take_along_axis(prod, idx[:, None, :], axis=1)[:, 0, :]
        tie = float((1 - picked / prod.max(axis=1)).max())
        o_map = np.zeros((G, F))
        for i in range(F):
            for e in range(E):
                o_map[idx[i, e], i] = picked[i, e] * w64[i, e]
        oracle["orthogonal"] = o_map
        own = np.zeros((G, F))  # the reference's loop: its own argmax
        for i in range(F):
            for e in range(E):
                j = int(prod[i, :, e].argmax())
                own[j, i] = prod[i, j, e] * w64[i, e]
        print(f"{label}: Orthogonal's {F * E} picks within {tie:.2e} of the float64 maxima "
              f"(tol 1e-5); {int((idx != prod.argmax(axis=1)).sum())} ties broken otherwise")
        check(tie <= 1e-5, f"{label}: an Orthogonal pick is not a maximum")

        steps["oracles"] = time.perf_counter()
        # each map against its float64 oracle and the plain paths; the
        # reference form's plain path keeps the kernels' CSM (C⁻¹ turns the
        # 1e-7 between B1's CSM and its plain version's into maps 1e-2 apart)
        ref_same_csm = plain(calls["mvdr_reference"])
        with _config.kernels_off():
            sig.get_csm(force_computation=True)
            noisy.get_csm(force_computation=True)
            ref = {name: fn() for name, fn in calls.items()}
            ortho1_p = beams["orthogonal"].get_beamformer_map(*band, number_eigenvalues=1)
        sig.get_csm(force_computation=True)
        noisy.get_csm(force_computation=True)
        ortho1 = beams["orthogonal"].get_beamformer_map(*band, number_eigenvalues=1)
        for name, m in maps.items():
            want = integrate(oracle[name])
            got = m.reshape(-1)
            e64, am, am64 = rel_err(got, want), int(torch.argmax(got)), int(np.argmax(want))
            tol = CONFIG5_BOUNDS[name]
            if name == "orthogonal":
                # the noise subspace's picks follow the CSM's float32 noise:
                # the map against the float64 maps of its own picks, the
                # argmax against the reference's loop in float64
                am64 = int(np.argmax(integrate(own)))
                print(f"{label} {name}: vs float64 of the same picks scale-rel {e64:.3e} (tol "
                      f"{tol:g}); argmax {am} (float64 {am64}, source {src})")
                check(e64 <= tol and am == am64, f"{label} {name}: disagrees with float64")
                continue
            if name == "mvdr_reference":
                print(f"{label} {name}: vs plain paths with their own CSM scale-rel "
                      f"{rel_err(got, ref[name].reshape(-1)):.3e} (not held)")
                ref[name] = ref_same_csm
            ep, amp_ = rel_err(got, ref[name].reshape(-1)), int(torch.argmax(ref[name]))
            print(f"{label} {name}: vs float64 scale-rel {e64:.3e}, vs plain paths {ep:.3e} "
                  f"(tol {tol:g}); argmax {am} (float64 {am64}, plain {amp_}, source {src})")
            check(am == am64, f"{label} {name}: the argmax is not the float64 oracle's")
            if name == "mvdr_reference" and seconds == CAMERA_RUNS[0][0]:
                # 14 Welch frames for 64 mics: C is ill-conditioned and the
                # form's denominators cancel to near float32's resolution;
                # held by B5's forward-error bound above and the argmax
                rel_den = float((np.abs(den_ref) / np.einsum(
                    "fmg,fmg->gf", np.abs(h64), np.abs(inv64) @ np.abs(h64))).min())
                print(f"{label} {name}: the smallest denominator is {rel_den:.2e} of its "
                      "absolute-value form; the map's scale bound is not held at this size")
                check(am == amp_, f"{label} {name}: the argmax is not the plain path's")
                continue
            check(e64 <= tol and ep <= tol and am == amp_,
                  f"{label} {name}: disagrees with its float64 oracle or the plain paths")
        e1 = abs(float(ortho1.max()) / float(ortho1_p.max()) - 1)
        print(f"{label} orthogonal, first eigenvalue: max vs plain paths rtol {e1:.3e} (tol "
              f"1e-3), argmax {int(torch.argmax(ortho1))} / {int(torch.argmax(ortho1_p))}")
        check(e1 <= 1e-3 and int(torch.argmax(ortho1)) == int(torch.argmax(ortho1_p)),
              f"{label}: Orthogonal's first eigenvalue disagrees with the plain paths")
        del ref

        steps["plain"] = time.perf_counter()
        # times: CUDA events against the plain paths (the CSM cached), and
        # the device's idle share
        # (every map ran above: no warm-up; one profiled call a map)
        for name, fn in calls.items():
            n = CONFIG5_TIMED.get(name, N_TIMED)
            k_ms, p_ms = time_pair(fn, lambda fn=fn: plain(fn), n=n, warm=0)
            r = profile_call(f"{label}: {name}", fn, runs=1, host_calls=min(n, 3),
                             event_calls=1, warm=0)
            print(f"time {label} {name} [{card}]: kernels {k_ms:.4f} ms ({G * F / (k_ms * 1e-3):.4g}"
                  f" point-bins/s), plain paths {p_ms:.4f} ms ({G * F / (p_ms * 1e-3):.4g} "
                  f"point-bins/s); device busy {r['busy_us']:.0f} us, idle share {r['idle']:.4f}")
            times.append({"recording": [seconds, fs], "map": name, "bins": F, "ms": k_ms,
                          "plain_ms": p_ms, "idle": r["idle"]})
        steps["times"] = time.perf_counter()
        names = list(steps)
        print(f"{label}: seconds by step " + ", ".join(
            f"{b} {steps[b] - steps[a]:.1f}" for a, b in zip(names, names[1:])))
        if seconds != CAMERA_RUNS[0][0]:
            continue
        # DAS-time on the 0.5 s recording: counted (no kernel), against a
        # float64 direct convolution on 16 points (the source's among them)
        beam_t = camera.time_beamformer(sig, g)
        out, launched = counted_run(beam_t.get_beamformer_output)
        y = out.time_data
        check(y.shape[1] == G and y.shape[0] > sig.length_samples
              and bool(torch.isfinite(y).all()), f"{label} das_time: shape or non-finite")
        pts = np.unique(np.r_[np.linspace(0, G - 1, 15).astype(int), src])
        ds = camera.planar_array().get_distances_to_point(g.coordinates)
        want = np_das_time(sig._x.double().cpu().numpy(), ds[:, pts], ds.max(), fs,
                           beam_t.c, y.shape[0])
        got = y[:, pts]
        err = rel_err(got, want)
        loud = int(pts[int((got.double() ** 2).sum(0).argmax())])
        loud64 = int(pts[int((want ** 2).sum(0).argmax())])
        print(f"{label} das_time: output {tuple(y.shape)}, launches {launched}; {len(pts)} points "
              f"vs float64 direct convolution scale-rel {err:.3e} (tol 1e-3); loudest point "
              f"{loud} (float64 {loud64})")
        check(err <= 1e-3 and loud == loud64,
              f"{label} das_time disagrees with the float64 direct convolution")
        t_ms = time_pair(beam_t.get_beamformer_output, n=5, warm=0)[0]
        r = profile_call(f"{label}: das_time", beam_t.get_beamformer_output, runs=1,
                         host_calls=3, event_calls=1, warm=0)
        chunks = len(beam_t._das_time_cache[2])
        print(f"time {label} das_time [{card}]: {t_ms:.4f} ms (no kernel: the path is its own "
              f"plain path), {chunks} grid chunks of {bfm._DAS_TIME_CHUNK_BYTES:.3g} B; device "
              f"busy {r['busy_us']:.0f} us, idle share {r['idle']:.4f}")
        times.append({"recording": [seconds, fs], "map": "das_time", "ms": t_ms,
                      "plain_ms": None, "idle": r["idle"], "chunks": chunks})
    return {"framing": totals["framing"], "das_map": totals["das_map"], "das_map_err": b5_err,
            "times": times}


def pipeline_phase(dev, card: str) -> dict:
    """`pipeline` on the chains of `tools/pipeline_chains.py`: config 2 at 1
    × 4 s and 16 × 60 s (B1), the transfer-function measurement (B4), config
    3 with its amplitude constraint (B3) and the four crossover bands as
    `Filter`s (B2), each captured into one CUDA graph on its first call. For
    each chain: the kernels launched while capturing (every count set to 0
    just before the capture and read just after it; a replay runs no
    Python), the first replay against the eager run (2e-5 scale-relative;
    TF 1e-4: the in-program regularization window's ±1-bin flank), a call
    on other inputs against its own eager run and leaving the first call's
    results unchanged, ``fn`` run at most twice over all the calls, and a
    chain that reads a value back (``float(sig.time_data.max())``) raising
    at that line while it is captured; eager and replay timed in turns
    (CUDA events, median of `N_TIMED`), each one's device idle share
    (`tools.profile_chain.profile_call`) and the graph pool's size. Returns
    the launches by kernel and the times."""
    import torch

    from dsptoolbox_tpu_torch import pipeline
    from dsptoolbox_tpu_torch.tools import pipeline_chains as pc
    from dsptoolbox_tpu_torch.tools.profile_chain import profile_call

    modules = counted_modules()
    launches = {name: 0 for name in modules}
    times = []
    for ch in pc.chains(dev):
        label = f"pipeline {ch.name}"
        ins = ch.inputs(0)
        calls = {"fn": 0, "capture": None}

        def counted(*sigs, fn=ch.fn, calls=calls):
            calls["fn"] += 1
            capturing = torch.cuda.is_current_stream_capturing()
            if capturing:
                for m in modules.values():
                    m.launches = 0
            out = fn(*sigs)
            if capturing:
                calls["capture"] = {name: m.launches for name, m in modules.items()}
            return out

        run = pipeline(counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = pc.leaves(run(*ins))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        captured = calls["capture"]
        print(f"{label}: warm-up, capture and first replay {setup_s:.2f} s; launches while "
              f"capturing {captured}")
        if captured is None or not all(captured[k] > 0 for k in ch.kernels):
            fail(f"{label}: the capture did not launch {ch.kernels}")
        for k, v in captured.items():
            launches[k] += v
        want = pc.leaves(ch.fn(*ins))
        if [tuple(t.shape) for t in first] != [tuple(t.shape) for t in want]:
            fail(f"{label}: the replay's outputs have other shapes than the eager run's")
        if not all(bool(torch.isfinite(t).all()) for t in first):
            fail(f"{label}: non-finite replay output")
        err = max(rel_err(a, b) for a, b in zip(first, want))
        del want
        snap = [t.clone() for t in first]
        other = ch.inputs(1)
        second = pc.leaves(run(*other))
        err2 = max(rel_err(a, b) for a, b in zip(second, pc.leaves(ch.fn(*other))))
        kept = all(torch.equal(a, b) for a, b in zip(first, snap))
        print(f"{label}: {len(first)} outputs; replay vs eager scale-rel {err:.3e}, other "
              f"inputs {err2:.3e} (tol {ch.tol:g}); first results unchanged by the second "
              f"call: {kept}")
        if not (err <= ch.tol and err2 <= ch.tol):
            fail(f"{label}: the replay disagrees with the eager run")
        if not kept:
            fail(f"{label}: a later call changed an earlier call's results")
        del first, snap, second, other
        e_ms, r_ms = time_pair(lambda: ch.fn(*ins), lambda: run(*ins))
        few = dict(runs=5, host_calls=5, event_calls=5, warm=1)
        e_idle = profile_call(f"{label}: eager", lambda: ch.fn(*ins), **few)["idle"]
        r_idle = profile_call(f"{label}: replay", lambda: run(*ins), **few)["idle"]
        pool_mb = run.graph_pool_bytes() / 2**20
        if calls["fn"] > 2:
            fail(f"{label}: fn ran {calls['fn']} times")
        print(f"time {label} [{card}]: eager {e_ms:.4f} ms "
              f"({ch.audio_s / (e_ms * 1e-3):.1f} audio-s/s, idle {e_idle:.3f}), replay "
              f"{r_ms:.4f} ms ({ch.audio_s / (r_ms * 1e-3):.1f} audio-s/s, idle "
              f"{r_idle:.3f}); graph pool {pool_mb:.1f} MB; fn ran {calls['fn']} times")
        times.append({"chain": ch.name, "eager_ms": e_ms, "replay_ms": r_ms,
                      "eager_idle": e_idle, "replay_idle": r_idle, "pool_mb": pool_mb,
                      "captured": captured})

        def unsafe(*sigs, fn=ch.fn):
            float(sigs[0].time_data.max())
            return fn(*sigs)

        try:
            pipeline(unsafe)(*ins)
        except RuntimeError as e:
            msg = str(e)
        else:
            fail(f"{label}: a chain that reads a value back was captured")
        print(f"{label}: a chain that reads a value back raises: {msg[:300]}")
        if "float(sigs[0].time_data.max())" not in msg:
            fail(f"{label}: the capture's error does not name the host read")
        del run, ins
        torch.cuda.empty_cache()
    return {"launches": launches, "times": times}


def np_ema(x, alpha: float, beta: float):
    """The attack/release recursion in float64 numpy over ``x (C, T)``:
    ``y[0] = x[0]``, ``y[t] = y[t-1] + a·(x[t] − y[t-1])``, ``a`` = alpha
    where the signal rises, else beta."""
    import numpy as np

    x = np.asarray(x, np.float64)
    y = np.empty_like(x)
    carry = x[:, 0].copy()
    y[:, 0] = carry
    for t in range(1, x.shape[1]):
        a = np.where(x[:, t] > carry, alpha, beta)
        carry = carry + a * (x[:, t] - carry)
        y[:, t] = carry
    return y


def np_fir_filtfilt(b, x):
    """scipy's ``filtfilt(b, [1], x)`` in float64 by FFT convolution: odd
    padding of 3·len(b), each pass a convolution plus its start state
    ``lfilter_zi · u[0]`` added to the first len(b) − 1 samples (an FIR's
    ``lfilter`` with a state is exactly that)."""
    import numpy as np
    from scipy.signal import fftconvolve, lfilter_zi
    from scipy.signal._arraytools import odd_ext

    n = 3 * len(b)
    zi = lfilter_zi(b, [1.0])

    def one(u):
        y = fftconvolve(u, b[None, :], axes=-1)[:, : u.shape[1]]
        y[:, : len(zi)] += zi[None, :] * u[:, :1]
        return y

    y = one(odd_ext(np.asarray(x, np.float64), n, axis=-1))
    y = one(np.ascontiguousarray(y[:, ::-1]))[:, ::-1]
    return np.ascontiguousarray(y[:, n:-n])


def session_files_phase(dev, card: str) -> dict:
    """Config 2's 16 × 60 s session through the file layer
    (`tools.session_files`): written as a 24-bit WAV and two 24-bit FLACs
    and loaded onto the card with ``Signal(path)`` (equal to a numpy
    decode of the file, WAV and FLAC equal); calibrated from a 94 dB SPL
    calibrator file (the factor against a float64 numpy RMS); a stateful
    ``(b, a)`` lowpass (order 4 at 1 kHz, order 6 at 200 Hz) streamed in
    60 blocks of 1 s (B2, one launch a block) against one call on the
    whole session and scipy's float64 ``lfilter``; the order-4 zero phase
    (B2 twice) and a 1023-tap FIR zero phase against scipy's float64
    ``filtfilt``; `plot_spl(window_length_s=0.125)` (its EMA on B2) and the
    attack/release smoothing (the EMA kernel) against float64 recursions;
    save/load of the session, a Filter, a FilterBank and a Spectrum; the two
    C8 calls with their defaults. Counted (every count 0 just before the
    path, read just after it), each kernel against its plain version, each
    step timed with CUDA events, the host-bound ones with their device idle
    share. Returns B2's and the EMA kernel's launches, errors and times."""
    import os
    import tempfile

    import numpy as np
    import torch
    from scipy.signal import filtfilt, lfilter, lfilter_zi

    from dsptoolbox_tpu_torch.classes import Filter, FilterBank, ImpulseResponse, Spectrum
    from dsptoolbox_tpu_torch.helpers.smoothing import get_smoothing_factor_ema, time_smoothing
    from dsptoolbox_tpu_torch.io import read_wav
    from dsptoolbox_tpu_torch.ops import cuda_ema
    from dsptoolbox_tpu_torch.room_acoustics import ShoeboxRoom
    from dsptoolbox_tpu_torch.tools import session_files as sf
    from dsptoolbox_tpu_torch.tools.profile_chain import profile_call
    from dsptoolbox_tpu_torch.transfer_functions import harmonic_distortion_analysis

    fs = sf.FS
    label = "session files"
    out = {}
    # matplotlib is an optional dependency: where it is missing the plots
    # raise after the computation they draw (plot_spl's smoothing runs
    # first), and the figures are held by tests/test_torch_files.py on the
    # CPU
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ModuleNotFoundError:
        matplotlib = None
    print(f"{label}: matplotlib "
          f"{'present, Agg' if matplotlib else 'not installed: no figure is drawn here'}")

    def without_figure(fn, fallback):
        """``fn()``, or ``fallback()`` where ``fn`` needed matplotlib."""
        if matplotlib is not None:
            return fn()
        try:
            return fn()
        except ModuleNotFoundError as e:
            if e.name != "matplotlib":
                raise
            return fallback()
    with tempfile.TemporaryDirectory() as d:
        s = sf.session()
        torch.cuda.synchronize()
        C, T = s.number_of_channels, s.length_samples
        n_blocks = T // int(sf.BLOCK_S * fs)
        coeffs = sf.stream_coefficients()
        fir = sf.fir_coefficients()

        # the path, counted as a whole and step by step
        def drive():
            mods = counted_modules()
            marks = {}

            def mark(name):
                torch.cuda.synchronize()
                marks[name] = {k: m.launches for k, m in mods.items()}

            t0 = time.perf_counter()
            out["paths"] = sf.write_session(s, d)
            out["write_s"] = time.perf_counter() - t0
            out["wav"] = sf.load_wav(out["paths"]["wav"])
            out["flac"] = sf.load_flac(out["paths"]["flac"])
            out["cal_path"] = sf.write_calibrator(d)
            out["calibrated"], out["cal"] = sf.calibrate(out["wav"], out["cal_path"])
            mark("load_calibrate")
            x = out["wav"]
            for i, (b, a) in enumerate(coeffs):
                out[f"stream{i}"] = sf.stream(x, b, a)
                mark(f"stream{i}")
                out[f"whole{i}"] = sf.whole(x, b, a)
                mark(f"whole{i}")
            out["zp_iir"] = sf.zero_phase(x, *coeffs[0])
            mark("zp_iir")
            out["zp_fir"] = sf.zero_phase(x, fir, [1.0])
            mark("zp_fir")
            out["spl"] = without_figure(lambda: sf.spl_plot(x), lambda: (None, None))
            mark("spl")
            out["ar"] = sf.attack_release(x._x ** 2)
            mark("ar")
            filt = Filter.from_ba(*coeffs[1], fs)
            out["saved"] = {"session": x, "filter": filt, "bank": FilterBank([filt, filt]),
                            "spectrum": Spectrum(*x.get_channels([0, 1]).get_spectrum())}
            out["loaded"] = sf.save_and_load(out["saved"], d)
            mark("save_load")
            room = ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
            room_args = ([1.0, 1.0, 1.0], [2.0, 2.0, 1.2], np.linspace(20, 200, 50))
            out["room"] = without_figure(
                lambda: room.get_analytical_transfer_function(*room_args),
                lambda: room.get_analytical_transfer_function(*room_args, generate_plot=False))
            n = fs
            chirp = np.sin(2 * np.pi * 20 * (1000 ** (np.arange(n) / n) - 1) / np.log(1000))
            y = chirp + 0.05 * chirp**2
            h = np.fft.irfft(np.fft.rfft(y, 2 * n) / (np.fft.rfft(chirp, 2 * n) + 1e-3), 2 * n)[:n]
            hd_ir = ImpulseResponse(None, h.astype(np.float32), fs)
            out["hd"] = without_figure(
                lambda: harmonic_distortion_analysis(hd_ir.copy(), [20, 20000], 1.0, 3),
                lambda: harmonic_distortion_analysis(hd_ir.copy(), [20, 20000], 1.0, 3,
                                                     generate_plot=False))
            mark("c8")
            return marks

        marks, launched = counted_run(drive)
        print(f"{label}: launches {launched}")
        steps_l = {}
        prev = {k: 0 for k in launched}
        for name, m in marks.items():
            steps_l[name] = {k: m[k] - prev[k] for k in m if m[k] - prev[k]}
            prev = m
        print(f"{label}: launches by step {steps_l}")
        if launched["ema"] != 1 or launched["iir_lead"] == 0:
            fail(f"{label}: the path did not go through B2 and the EMA kernel")
        for i in range(len(coeffs)):
            if steps_l[f"stream{i}"].get("iir_lead") != n_blocks:
                fail(f"{label}: the streamed filter {i} did not launch B2 once a block")
        if steps_l["zp_iir"].get("iir_lead") != 2 or steps_l["zp_fir"]:
            fail(f"{label}: zero phase launched {steps_l['zp_iir']} / {steps_l['zp_fir']}")
        if steps_l["spl"].get("iir_lead") != 1 or steps_l["ar"].get("ema") != 1:
            fail(f"{label}: the smoothing did not launch B2 and the EMA kernel once each")

        # 1. loads: on the card, equal to numpy decodes, WAV = FLAC
        wav, flac = out["wav"], out["flac"]
        decoded = read_wav(out["paths"]["wav"])[0].astype(np.float32)
        same = (wav.device.type == dev.type and flac.device.type == dev.type
                and np.array_equal(wav.time_data.cpu().numpy(), decoded)
                and torch.equal(wav.time_data, flac.time_data))
        sizes = [os.path.getsize(p) for p in [out["paths"]["wav"]] + out["paths"]["flac"]]
        print(f"{label}: {C} ch x {T} samples written as a 24-bit WAV ({sizes[0]} B) and two "
              f"FLACs ({sizes[1]} + {sizes[2]} B) in {out['write_s']:.2f} s; loaded on "
              f"{wav.device}; WAV equal to a numpy decode and to the FLAC load: {same}")
        if not same:
            fail(f"{label}: the loaded session differs from its file")

        # 2. calibration: the factor against a float64 numpy RMS of the file
        cal_td = read_wav(out["cal_path"])[0].astype(np.float32).astype(np.float64)
        want_factor = 10 ** (sf.CALIBRATOR[2] / 20) * 20e-6 / np.std(cal_td)
        got_factor = float(out["cal"].calibration_factors[0])
        f_err = abs(got_factor - want_factor) / want_factor
        c_err = rel_err(out["calibrated"].time_data, wav.time_data.double() * want_factor)
        print(f"{label}: calibration factor {got_factor:.9g} Pa/FS against float64 numpy "
              f"{want_factor:.9g}: rel {f_err:.3e} (tol 1e-9); calibrated data scale-rel "
              f"{c_err:.3e} (tol 2e-7)")
        if not (f_err <= 1e-9 and c_err <= 2e-7 and out["calibrated"].calibrated_signal):
            fail(f"{label}: calibration disagrees with float64 numpy")

        # 3. the streamed stateful (b, a): = one call, = plain, = scipy f64
        x64 = wav.time_data.T.double().cpu().numpy()
        b2_err = 0.0
        for i, (b, a) in enumerate(coeffs):
            st, wh = out[f"stream{i}"].time_data, out[f"whole{i}"].time_data
            sw = rel_err(st, wh)
            plain_st = plain(lambda: sf.stream(wav, b, a)).time_data
            b2_err = max(b2_err, float((st - plain_st).abs().max()))
            zi = np.tile(lfilter_zi(b, a), (C, 1))
            sc = rel_err(wh.T, lfilter(b, a, x64, zi=zi)[0])
            print(f"{label}: stateful order {len(a) - 1} ({sf.STREAM_FILTERS[i][1]:g} Hz) in "
                  f"{n_blocks} blocks vs one call scale-rel {sw:.3e} (tol 1e-6), vs plain "
                  f"{rel_err(st, plain_st):.3e} (tol 2e-6), vs scipy f64 lfilter "
                  f"{sc:.3e} (tol 5e-6); the JAX package's float32 scan on this filter: "
                  f"{C9_NON_FINITE[i]} of 96,000 samples non-finite at 2 x 48,000 (ROADMAP "
                  "C9, tests/test_torch_iir_ba.py on the CPU)")
            if not (sw <= 1e-6 and rel_err(st, plain_st) <= 2e-6 and sc <= 5e-6):
                fail(f"{label}: the streamed stateful filter {i} disagrees")
            del st, wh, plain_st

        # 4. zero phase against scipy float64 filtfilt
        b, a = coeffs[0]
        zp = out["zp_iir"].time_data.T
        zp_plain = plain(lambda: sf.zero_phase(wav, b, a)).time_data.T
        b2_err = max(b2_err, float((zp - zp_plain).abs().max()))
        e_iir = rel_err(zp, np.ascontiguousarray(filtfilt(b, a, x64)))
        fir_ref = np_fir_filtfilt(fir, x64)
        short = x64[:1, : 2 * fs]
        ident = rel_err(torch.from_numpy(np_fir_filtfilt(fir, short)),
                        np.ascontiguousarray(filtfilt(fir, [1.0], short)))
        e_fir = rel_err(out["zp_fir"].time_data.T, fir_ref)
        print(f"{label}: zero phase order 4 vs scipy f64 filtfilt {e_iir:.3e}, vs plain "
              f"{rel_err(zp, zp_plain):.3e}; {sf.FIR_TAPS}-tap FIR vs float64 filtfilt "
              f"{e_fir:.3e} (its FFT form = scipy's filtfilt within {ident:.1e} on 2 s) "
              "(tol 5e-6)")
        if not (e_iir <= 5e-6 and e_fir <= 5e-6 and ident <= 1e-12
                and rel_err(zp, zp_plain) <= 2e-5):
            fail(f"{label}: zero phase disagrees with scipy")
        del zp, zp_plain, fir_ref

        # 5. smoothing: plot_spl's EMA (B2) and attack/release (EMA kernel)
        power = wav._x ** 2
        alpha = get_smoothing_factor_ema(sf.SPL_WINDOW_S, fs)
        one = time_smoothing(power, fs, sf.SPL_WINDOW_S)
        p64 = power.double().cpu().numpy()
        bb, aa = np.array([alpha]), np.array([1.0, alpha - 1.0])
        one_ref = lfilter(bb, aa, p64, zi=lfilter_zi(bb, aa)[None] * p64[:, :1])[0]
        e_one = rel_err(one, one_ref)
        fig = out["spl"][0]
        if matplotlib is None:
            fig = "no figure (matplotlib not installed)"
        # the EMA kernel's output at the path's shape, held at windows
        # spread along the rows (chunk edges, both shared buffers, the
        # middle, the last partial chunk): over W samples from t0, the plain
        # loop and a float64 recursion, each seeded with the kernel's own
        # carry y[t0 - 1] (the loop's y[0] is its first input), against
        # y[t0 - 1 : t0 + W]
        ar_a, ar_b = (get_smoothing_factor_ema(t, fs) for t in sf.ATTACK_RELEASE_S)
        y_ar, W = out["ar"], 2400
        starts = [1, 7 * 2048 - 5, T // 3, T // 2 + 1001, 2 * T // 3 + 2047, T - W]
        ema_err, e_ar, bit_equal = 0.0, 0.0, True
        for t0 in starts:
            seeded = torch.cat([y_ar[:, t0 - 1:t0], power[:, t0:t0 + W]], dim=-1)
            got = y_ar[:, t0 - 1:t0 + W]
            want = cuda_ema.ema_attack_release_plain(seeded, ar_a, ar_b)
            bit_equal = bit_equal and torch.equal(got, want)
            ema_err = max(ema_err, float((got - want).abs().max()))
            e_ar = max(e_ar, rel_err(got, np_ema(seeded.double().cpu().numpy(), ar_a, ar_b)))
        drawn = fig if matplotlib is None else type(fig).__name__
        print(f"{label}: plot_spl(window {sf.SPL_WINDOW_S} s) -> {drawn}; its EMA "
              f"vs float64 lfilter scale-rel {e_one:.3e} (tol 1e-5); attack/release "
              f"{sf.ATTACK_RELEASE_S} on ({C}, {T}) at {len(starts)} windows of {W} samples "
              f"from t0 = {starts}, each seeded with the kernel's carry: vs a float64 "
              f"recursion {e_ar:.3e} (tol 1e-5), vs its plain loop max abs {ema_err:.3e} "
              f"(tol 1e-6; bit-equal {bit_equal})")
        if not (e_one <= 1e-5 and e_ar <= 1e-5 and ema_err <= 1e-6
                and (matplotlib is None or isinstance(fig, matplotlib.figure.Figure))):
            fail(f"{label}: smoothing disagrees")

        # 6. save and load
        for name, obj in out["saved"].items():
            back = out["loaded"][name]
            if name == "session":
                ok = torch.equal(back.time_data, obj.time_data) and back.device == obj.device
            elif name == "filter":
                ok = all(np.array_equal(u, v) for u, v in zip(back.ba, obj.ba))
            elif name == "bank":
                ok = all(np.array_equal(u.ba[0], v.ba[0]) and np.array_equal(u.ba[1], v.ba[1])
                         for u, v in zip(back.filters, obj.filters))
            else:
                ok = (torch.equal(back.spectral_data, obj.spectral_data)
                      and np.array_equal(back.frequency_vector_hz, obj.frequency_vector_hz))
            print(f"{label}: {name} saved and loaded with equal arrays: {ok}")
            if not ok:
                fail(f"{label}: {name} did not come back equal")

        # 7. C8: the two calls with their defaults return figures (without
        # matplotlib they are not run: their outputs with generate_plot=False)
        room_plot, hd_plot = out["room"][2], out["hd"].get("plot")
        finite = (np.isfinite(out["room"][0]).all()
                  and bool(torch.isfinite(out["hd"]["thd"].spectral_data).all()))
        if matplotlib is None:
            ok = finite and room_plot is None and hd_plot is None
            print(f"{label}: C8 with their defaults (figures): not run on this machine (no "
                  "matplotlib; tests/test_torch_files.py holds them on the CPU); with "
                  f"generate_plot=False their outputs are finite: {ok}")
        else:
            ok = (finite and isinstance(room_plot[0], matplotlib.figure.Figure)
                  and isinstance(hd_plot[0], matplotlib.figure.Figure))
            print(f"{label}: C8 calls with their defaults return figures: {ok}")
            plt.close("all")
        if not ok:
            fail(f"{label}: a C8 call failed")

        # times: CUDA events in turns with the plain paths where a kernel
        # runs; the host-bound steps' device idle share
        times = {}

        def timed(name, fn, with_plain=True, n=3):
            ms = time_pair(fn, lambda: plain(fn), n=n, warm=1) if with_plain else \
                time_pair(fn, n=n, warm=1)
            times[name] = {"ms": ms[0], "plain_ms": ms[1] if with_plain else None}
            extra = f", plain {ms[1]:.4f} ms" if with_plain else ""
            print(f"time {label} {name}: {ms[0]:.4f} ms{extra} [{card}]")

        timed("load wav", lambda: sf.load_wav(out["paths"]["wav"]), False, n=2)
        timed("load flac", lambda: sf.load_flac(out["paths"]["flac"]), False, n=2)
        timed("calibrate", lambda: sf.calibrate(wav, out["cal_path"]), False)
        for i, (b, a) in enumerate(coeffs):
            timed(f"stream order {len(a) - 1}", lambda: sf.stream(wav, b, a))
            times[f"stream order {len(a) - 1}"]["per_block_ms"] = \
                times[f"stream order {len(a) - 1}"]["ms"] / n_blocks
            timed(f"whole order {len(a) - 1}", lambda: sf.whole(wav, b, a))
        timed("zero phase order 4", lambda: sf.zero_phase(wav, *coeffs[0]))
        timed("zero phase FIR", lambda: sf.zero_phase(wav, fir, [1.0]), False)
        timed("EMA one coefficient", lambda: time_smoothing(power, fs, sf.SPL_WINDOW_S))
        timed("save and load", lambda: sf.save_and_load(out["saved"], d), False, n=2)
        for name, fn in (("load wav", lambda: sf.load_wav(out["paths"]["wav"])),
                         ("calibrate", lambda: sf.calibrate(wav, out["cal_path"])),
                         ("stream order 6", lambda: sf.stream(wav, *coeffs[1]))):
            r = profile_call(f"{label}: {name}", fn, runs=1, host_calls=1, event_calls=1, warm=1)
            times[name]["idle"] = r["idle"]
            print(f"time {label} {name}: device busy {r['busy_us']:.0f} us of "
                  f"{r['wall_us']:.0f} us wall, idle share {r['idle']:.4f} [{card}]")

        # the EMA kernel against its plain loop: the kernel at the path's
        # shape, both at (C, cut) for the comparison (the plain loop takes
        # ~90 us a sample, minutes at the path's T); its bound: the
        # bytes, or T steps of its dependent chain (compare, select,
        # multiply, add: four float32 operations at 4 cycles each) at the
        # card's maximum SM clock
        ema_ms = time_pair(lambda: cuda_ema.ema_attack_release_cuda(power, ar_a, ar_b),
                           n=3, warm=1)[0]
        cut = fs // 4
        cut_power = power[:, :cut].contiguous()
        ema_cut_ms, plain_cut_ms = time_pair(
            lambda: cuda_ema.ema_attack_release_cuda(cut_power, ar_a, ar_b),
            lambda: cuda_ema.ema_attack_release_plain(cut_power, ar_a, ar_b), n=2, warm=1)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60).stdout.split()[0]
        chain_ms = T * 16 / (float(clock) * 1e6) * 1e3
        bytes_ms = 8.0 * C * T / HBM_BYTES_S * 1e3
        ema_bound = max(chain_ms, bytes_ms)
        ema_by = "operations" if chain_ms >= bytes_ms else "bytes"
        print(f"time {label} EMA kernel ({C}, {T}): {ema_ms:.4f} ms; at ({C}, {cut}): kernel "
              f"{ema_cut_ms:.4f} ms, plain loop {plain_cut_ms:.4f} ms; bound {ema_bound:.4f} ms "
              f"({ema_by}: {T} steps x 16 cycles at {clock} MHz; bytes {bytes_ms:.4f} ms) "
              f"[{card}]")
    return {"iir_lead": launched["iir_lead"], "iir_lead_err": b2_err,
            "ema": launched["ema"], "ema_err": ema_err, "ema_ms": ema_ms,
            "ema_plain_ms": plain_cut_ms, "ema_at_plain_shape_ms": ema_cut_ms,
            "ema_plain_shape": [C, cut], "ema_bound_ms": ema_bound, "ema_bound_by": ema_by,
            "times": times}


def np_svf_bands(x, f):
    """The state-variable filter's LP, HP, BP and AP outputs of ``x (C, T)``
    in float64 by scipy ``lfilter``: its recursion as a state space (state
    s[n-1], input x[n]) turned into four transfer functions."""
    import numpy as np
    from scipy.signal import lfilter, ss2tf

    A, B = f._system()
    g, res, iv = f.g, f.resonance, f.intermediate_value
    c_h, d_h = np.array([-iv * (res + g), -iv]), iv
    c_b, d_b = g * c_h + np.array([1.0, 0.0]), g * d_h
    c_l, d_l = g * c_b + np.array([0.0, 1.0]), g * d_b
    c_a, d_a = c_l - res * c_b + c_h, d_l - res * d_b + d_h
    out = []
    for c, d in ((c_l, d_l), (c_h, d_h), (c_b, d_b), (c_a, d_a)):
        b, a = ss2tf(A, B[:, None], c[None], np.array([[d]]))
        out.append(lfilter(b[0], a, np.asarray(x, np.float64), axis=-1))
    return out


def np_svf_loop(x, f):
    """The state-variable filter's per-sample recursion in float64 numpy
    over ``x (C, T)`` from a zero state → LP, HP, BP, AP ``(C, T)`` each."""
    import numpy as np

    g, res, iv = f.g, f.resonance, f.intermediate_value
    x = np.asarray(x, np.float64)
    s0, s1 = np.zeros(x.shape[0]), np.zeros(x.shape[0])
    out = np.empty((4,) + x.shape)
    for t in range(x.shape[1]):
        yh = (x[:, t] - (res + g) * s0 - s1) * iv
        yb = g * yh + s0
        s0 = g * yh + yb
        yl = g * yb + s1
        s1 = g * yb + yl
        out[:, :, t] = yl, yh, yb, yl - res * yb + yh
    return out


def np_kautz(x, k):
    """The Kautz filter's chain of sections over ``x (C, T)`` in float64
    scipy ``lfilter``, the taps weighted and summed."""
    import numpy as np
    from scipy.signal import lfilter

    td, out = np.asarray(x, np.float64), 0.0
    for ii, p in enumerate(k.poles_real):
        out = out + (1 - p**2) ** 0.5 * k.coefficients_real_poles[ii] * lfilter(
            [1.0], [1.0, -p], td, axis=-1)
        td = lfilter([-p, 1.0], [1.0, -p], td, axis=-1)
    q, r = -2 * np.real(k.poles_complex), np.abs(k.poles_complex) ** 2
    for ii in range(len(k.poles_complex)):
        a = [1.0, q[ii], r[ii]]
        c0, c1 = k.coefficients_complex_poles[2 * ii: 2 * ii + 2]
        out = out + ((1 - r[ii]) * (1 + r[ii] - q[ii]) / 2) ** 0.5 * c0 * lfilter(
            [1.0, -1.0], a, td, axis=-1)
        out = out + ((1 - r[ii]) * (1 + r[ii] + q[ii]) / 2) ** 0.5 * c1 * lfilter(
            [1.0, 1.0], a, td, axis=-1)
        td = lfilter([r[ii], q[ii], 1.0], a, td, axis=-1)
    return out


def np_warped_fir(x, b, lam):
    """The warped FIR of ``x (C, T)`` as its float64 allpass cascade."""
    import numpy as np
    from scipy.signal import lfilter

    stage = np.asarray(x, np.float64)
    out = b[0] * stage
    for k in range(1, len(b)):
        stage = lfilter([-lam, 1.0], [1.0, -lam], stage, axis=-1)
        out = out + b[k] * stage
    return out


def np_ema_average(x, carry: float, inc: float, dec: float):
    """The exponential average of ``x (T,)`` from ``carry`` in float64."""
    import numpy as np

    y = np.empty(len(x))
    prev = carry
    for t, v in enumerate(np.asarray(x, np.float64)):
        c = inc if v > prev else dec
        prev = v * c + (1 - c) * prev
        y[t] = prev
    return y


def realtime_phase(dev, card: str) -> dict:
    """The filter-design and streaming path (`tools/realtime_chain.py`) on
    config 2's 16 × 60 s session and the first room IR: designs (the
    A-weighting and a ten-band EQ on the session, B2), the parallel filter
    (32 pole pairs, B2 a section), the Kautz filter (order 32, B2 three
    launches a pair), the warped FIR (32 taps, B2 a stage), the SVF
    (float64 `linear_recurrence`), `N_BLOCKS` blocks of 1024 through an
    order-4 `IIRFilter` (B2 a block) and an `ExponentialAverageFilter`
    (`csrc/ema.cu`'s average form, a launch a block), the partitioned FIR of
    the 16 room IRs, the reconstructing 1/3-octave bank, a QMF crossover and
    the host loops. Counted (every count 0 just before the path, read just
    after), each step's launches; B2's callers against their plain versions
    at full output, the EMA kernel bit for bit against its plain loop over
    every block (each seeded with the previous block's carry), the SVF
    against a float64 loop; every session route against scipy float64 on 2
    channels × 10 s; each step timed with CUDA events and its device idle
    share. Returns the launches, errors and the EMA variant's times."""
    import numpy as np
    import torch
    from scipy.signal import butter, fftconvolve, firwin, freqz, lfilter, sosfilt, sosfreqz

    from dsptoolbox_tpu_torch.classes import Signal
    from dsptoolbox_tpu_torch.ops import cuda_ema
    from dsptoolbox_tpu_torch.realtime import ExponentialAverageFilter
    from dsptoolbox_tpu_torch.tools import realtime_chain as rc
    from dsptoolbox_tpu_torch.tools.profile_chain import profile_call

    label = "realtime"
    t_phase = time.perf_counter()
    fs = rc.FS
    s = rc.session()
    irs = rc.room_irs()
    ir = rc.ir_signal(irs)
    torch.cuda.synchronize()
    C, T = s.number_of_channels, s.length_samples
    NB, B = rc.N_BLOCKS, rc.BLOCK
    n_host = int(rc.HOST_S * fs)
    out, objs = {}, {}

    def drive():
        mods = counted_modules()
        marks = {}

        def mark(name):
            torch.cuda.synchronize()
            marks[name] = {k: m.launches for k, m in mods.items()}

        objs["designs"] = rc.designs(ir)
        mark("designs")
        out["weq"] = rc.weighted_eq(s, objs["designs"])
        mark("weighting_eq")
        objs["parallel"] = rc.parallel_filter(ir)
        mark("parallel_fit")
        out["parallel"] = objs["parallel"].filter_signal(s)
        mark("parallel")
        objs["kautz"] = rc.kautz_filter(ir)
        mark("kautz_fit")
        out["kautz"] = objs["kautz"].filter_signal(s)
        mark("kautz")
        objs["warped"] = rc.warped_fir(irs)
        out["warped"] = objs["warped"].filter_signal(s)
        mark("warped")
        objs["svf"] = rc.svf()
        out["svf"] = objs["svf"].filter_signal(s)
        mark("svf")
        out["stream_iir"] = rc.stream_iir(s._x[0])
        mark("stream_iir")
        out["stream_ema"] = rc.stream_ema(s._x[0])
        mark("stream_ema")
        out["stream_fir"] = rc.stream_fir(s._x, irs)
        mark("stream_fir")
        objs["bank"] = rc.fractional_octave_bank()
        out["bands"], out["bands_sum"] = rc.octave_bands(s, objs["bank"])
        mark("octave_bank")
        objs["qmf"] = rc.qmf_crossover()
        out["qmf"] = rc.qmf(s, objs["qmf"])
        mark("qmf")
        out["host"] = rc.host_loops(s._x[0, :n_host].cpu().numpy())
        mark("host_loops")
        return marks

    t0 = time.perf_counter()
    marks, launched = counted_run(drive)
    print(f"{label}: the path in {time.perf_counter() - t0:.1f} s (first call, host designs "
          f"and fits included); launches {launched}")
    steps_l, prev = {}, {k: 0 for k in launched}
    for name, m in marks.items():
        steps_l[name] = {k: m[k] - prev[k] for k in m if m[k] - prev[k]}
        prev = m
    print(f"{label}: launches by step {steps_l}")
    k = objs["kautz"]
    want_l = {"weighting_eq": {"iir_lead": 1 + len(objs["designs"]["eq"])},
              "parallel": {"iir_lead": objs["parallel"]._sos.shape[0]},
              "kautz": {"iir_lead": 3 * len(k.poles_complex) + 2 * len(k.poles_real)},
              "warped": {"iir_lead": rc.WARPED_TAPS - 1}, "svf": {},
              "stream_iir": {"iir_lead": NB}, "stream_ema": {"ema_carry": NB},
              "stream_fir": {}, "host_loops": {}}
    for name, want in want_l.items():
        if steps_l[name] != want:
            fail(f"{label}: {name} launched {steps_l[name]}, not {want}")

    # 1. designs: the responses that define them
    d = objs["designs"]
    a_1k = 20 * np.log10(abs(sosfreqz(d["a_weighting"].sos, [1000.0], fs=fs)[1][0]))
    p_1k = 20 * np.log10(abs(sosfreqz(d["pinking"].sos, [1000.0], fs=fs)[1][0]))
    fd = d["fractional_delay"].ba
    gd_dc = float(np.sum(np.arange(len(fd[0])) * fd[0]) / np.sum(fd[0])
                  - np.sum(np.arange(len(fd[1])) * fd[1]) / np.sum(fd[1]))
    comp = d["complementary"].ba[0] + firwin(255, 4000.0, fs=fs)
    unit = np.zeros(255)
    unit[127] = 1.0
    arma_ok = all(np.all(np.isfinite(np.concatenate(d[n].ba)))
                  and np.all(np.abs(np.roots(d[n].ba[1])) < 1)
                  for n in ("arma_yule_walker", "arma_burg"))
    eq_db = [20 * np.log10(abs(freqz(*f.ba, [fc], fs=fs)[1][0]))
             for f, fc in zip(d["eq"], rc.EQ_HZ)]
    print(f"{label} designs: A-weighting at 1 kHz {a_1k:+.4f} dB (tol 0.1), pinking at 1 kHz "
          f"{p_1k:+.2e} dB, Thiran delay at DC {gd_dc:.6f} samples (30.5), lowpass + "
          f"complementary = unit impulse within {np.abs(comp - unit).max():.1e}, EQ gains at "
          f"their centres {np.round(eq_db, 3).tolist()} dB, ARMA fits finite and stable: "
          f"{arma_ok}")
    if not (abs(a_1k) < 0.1 and abs(p_1k) < 1e-9 and abs(gd_dc - 30.5) < 1e-6
            and np.abs(comp - unit).max() < 1e-12 and arma_ok
            and np.allclose(np.abs(eq_db), rc.EQ_DB, atol=0.5)):
        fail(f"{label}: a design misses its definition")

    # 2. B2's callers against their plain versions at full output, and
    # every session route against scipy float64 on 2 channels x 10 s
    n10 = 10 * fs
    x2 = s._x[:2, :n10].double().cpu().numpy()
    b2_err = 0.0

    def against_plain(name, got, fn):
        nonlocal b2_err
        want = plain(fn)
        err = float((got - want).abs().max())
        b2_err = max(b2_err, err)
        sc = float(want.abs().max())
        print(f"{label} {name}: vs its plain version max abs {err:.3e} <= 1e-5 x {sc:.3e}")
        if not err <= 1e-5 * sc:
            fail(f"{label}: {name} disagrees with its plain version")
        del want

    def against_scipy(name, got, want, tol):
        got = np.asarray(got, np.float64)
        sc = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / sc
        print(f"{label} {name}: vs scipy float64 on {want.shape[-2] if want.ndim > 1 else 1} "
              f"ch x {want.shape[-1]} samples {err:.3e} of {sc:.3e} (tol {tol:g})")
        if not err <= tol:
            fail(f"{label}: {name} disagrees with scipy float64")
        return err

    against_plain("A-weighting + EQ (B2)", out["weq"]._x,
                  lambda: rc.weighted_eq(s, d)._x)
    w_ref = sosfilt(d["a_weighting"].sos, x2, axis=-1)
    for f in d["eq"]:
        w_ref = lfilter(*f.ba, w_ref, axis=-1)
    against_scipy("A-weighting + EQ (B2)", out["weq"]._x[:2, :n10].cpu(), w_ref, 1e-5)
    del w_ref

    pf = objs["parallel"]
    sections = [sosfilt(pf._sos[n][None], x2, axis=-1) for n in range(pf._sos.shape[0])]
    largest = max(float(np.abs(v).max()) for v in sections)
    p_ref = sum(sections) + pf._fir_coefficients[0] * x2
    del sections
    p_peak = float(np.abs(p_ref).max())
    print(f"{label} parallel filter: fitted numerators up to "
          f"{np.abs(pf._sos[:, :3]).max():.3e}; largest section output {largest:.3e} against "
          f"an output of {p_peak:.3e} (no more than 10 times it: the sections do not cancel)")
    if not largest <= 10 * p_peak:
        fail(f"{label}: the parallel filter's sections cancel")
    against_plain("parallel filter (B2 a section, float64 sum)", out["parallel"]._x,
                  lambda: pf.filter_signal(s)._x)
    against_scipy("parallel filter", out["parallel"]._x[:2, :n10].cpu(), p_ref, 1e-5)
    del p_ref

    against_plain("Kautz filter (B2)", out["kautz"]._x, lambda: k.filter_signal(s)._x)
    against_scipy("Kautz filter", out["kautz"]._x[:2, :n10].cpu(), np_kautz(x2, k), 1e-5)
    wf = objs["warped"]
    against_plain("warped FIR (B2 a stage)", out["warped"]._x, lambda: wf.filter_signal(s)._x)
    against_scipy(f"warped FIR (lambda {wf.warp:.4f})", out["warped"]._x[:2, :n10].cpu(),
                  np_warped_fir(x2, wf.b, wf.warp), 1e-5)

    svf_bands = torch.stack([b._x for b in out["svf"].bands])
    loop = np_svf_loop(x2[:, : 2 * fs], objs["svf"])
    against_scipy("SVF bands vs a float64 loop of its recursion",
                  svf_bands[:, :2, : 2 * fs].cpu(), loop, 1e-6)
    against_scipy("SVF bands", svf_bands[:, :2, :n10].cpu(),
                  np.stack(np_svf_bands(x2, objs["svf"])), 1e-6)
    del svf_bands, loop

    x0 = s._x[0, : NB * B]
    against_plain("IIRFilter stream (B2 a block)", out["stream_iir"],
                  lambda: rc.stream_iir(s._x[0]))
    b4, a4 = rc.stream_coefficients()
    x0_64 = x0.double().cpu().numpy()
    against_scipy(f"IIRFilter order 4 stream, {NB} blocks", out["stream_iir"].cpu(),
                  lfilter(b4, a4, x0_64), 5e-6)

    # 3. the EMA kernel's average form: bit for bit against its plain loop
    # over every block, each seeded with the kernel's own carry of the
    # block before; the stream against a float64 recursion
    ema = out["stream_ema"]
    blocks = x0.abs().reshape(NB, B)
    carry = torch.cat([ema.new_zeros(1), ema.reshape(NB, B)[:-1, -1]])
    ema_f = ExponentialAverageFilter(*rc.EMA_S, fs)
    inc, dec = ema_f.increase_coefficient, ema_f.decrease_coefficient
    ema_plain = cuda_ema.ema_average_plain(blocks, carry, inc, dec).reshape(-1)
    ema_equal = torch.equal(ema_plain, ema)
    ema_err = float((ema_plain - ema).abs().max())
    e_ema = rel_err(ema, np_ema_average(np.abs(x0_64), 0.0, inc, dec))
    print(f"{label} EMA average form, {NB} blocks of {B}: vs its plain loop over every block "
          f"(seeded with the kernel's carry) bit-equal {ema_equal} (max abs {ema_err:.1e}); "
          f"vs a float64 recursion {e_ema:.3e} (tol 1e-5)")
    if not (ema_equal and e_ema <= 1e-5):
        fail(f"{label}: the EMA kernel's average form disagrees")

    # 4. the partitioned FIR, the reconstructing bank, the QMF crossover
    xs = s._x[:2, : NB * B].double().cpu().numpy()
    fir_ref = np.stack([fftconvolve(xs[c], irs[:, c])[: NB * B] for c in range(2)])
    against_scipy("partitioned FIR of the 16 room IRs", out["stream_fir"][:, :2].T.cpu(),
                  fir_ref, 1e-5)
    del fir_ref, xs
    bank = objs["bank"]
    bands = out["bands"]
    e_band = 0.0
    for i, f in enumerate(bank.filters):
        want = fftconvolve(x2, f.ba[0][None], axes=-1)[:, :n10]
        e_band = max(e_band, float(np.abs(bands[i, :2, :n10].double().cpu().numpy() - want).max())
                     / float(np.abs(want).max()))
    print(f"{label} 1/3-octave reconstructing bank, {len(bank.filters)} bands of "
          f"{tuple(bands.shape[1:])} ({bands.numel() * 4 / 1e9:.2f} GB): worst band vs scipy "
          f"float64 {e_band:.3e} of its peak (tol 1e-5)")
    delay = len(bank.filters[0].ba[0]) // 2
    rec_err = float((out["bands_sum"][:, delay:] - s._x[:, :-delay]).abs().max())
    print(f"{label} the bands' sum vs the input delayed by {delay}: max abs {rec_err:.3e} "
          "(tol 2e-4)")
    if not (e_band <= 1e-5 and rec_err <= 2e-4):
        fail(f"{label}: the reconstructing bank disagrees")
    del bands, out["bands"], out["bands_sum"]
    lo, hi, rec = out["qmf"]
    h = firwin(63, 0.5)
    hh = h.copy()
    hh[1::2] *= -1
    lo_ref = fftconvolve(x2, h[None], axes=-1)[:, 30::2][:, : n10 // 2]
    hi_ref = fftconvolve(x2, hh[None], axes=-1)[:, 30::2][:, : n10 // 2]

    def up(y, taps):
        z = np.zeros((y.shape[0], 2 * y.shape[1]))
        z[:, ::2] = 2 * y
        return fftconvolve(z, taps[None], axes=-1)[:, 31: 31 + z.shape[1]]

    rec_ref = up(lo_ref, h) + up(hi_ref, -hh)
    for name, got, want in (("QMF low band", lo, lo_ref), ("QMF high band", hi, hi_ref),
                            ("QMF reconstruction", rec, rec_ref)):
        n = want.shape[-1] - 256  # the oracles' ends lack the samples past 10 s
        against_scipy(name, got[:2, :n].cpu(), want[:, :n], 1e-5)

    # 5. host loops on 0.1 s: the lattice and state-space filters against
    # scipy float64, the warped IIR finite
    hf = rc.host_filters()
    x_h = s._x[0, :n_host].cpu().numpy().astype(np.float64)
    b2_, a2_ = butter(2, rc.STREAM_FC, fs=fs)
    e_lat = rel_err(out["host"]["lattice"], lfilter(b4, a4, x_h))
    e_ss = rel_err(torch.as_tensor(out["host"]["state_space"]), lfilter(b2_, a2_, x_h))
    fin = bool(torch.isfinite(torch.as_tensor(out["host"]["warped_iir"])).all())
    print(f"{label} host loops on {n_host} samples: lattice/ladder vs scipy f64 {e_lat:.3e} "
          f"(tol 1e-5), state space {e_ss:.3e} (tol 1e-9), warped IIR finite {fin}")
    if not (e_lat <= 1e-5 and e_ss <= 1e-9 and fin):
        fail(f"{label}: a host loop disagrees")

    # 6. times: each step with CUDA events (in turns with the plain paths
    # where a kernel runs) and its device idle share from one profiled call
    times = {}
    steps = {
        "A-weighting + EQ": (lambda: rc.weighted_eq(s, d), True),
        "parallel filter": (lambda: pf.filter_signal(s), True),
        "Kautz filter": (lambda: k.filter_signal(s), True),
        "warped FIR": (lambda: wf.filter_signal(s), True),
        "SVF": (lambda: objs["svf"].filter_signal(s), False),
        "IIRFilter stream": (lambda: rc.stream_iir(s._x[0]), True),
        "EMA stream": (lambda: rc.stream_ema(s._x[0]), False),
        "partitioned FIR stream": (lambda: rc.stream_fir(s._x, irs), False),
        "1/3-octave bank": (lambda: rc.octave_bands(s, bank), False),
        "QMF": (lambda: rc.qmf(s, objs["qmf"]), False),
    }
    for name, (fn, with_plain) in steps.items():
        ms = time_pair(fn, lambda: plain(fn), n=2, warm=1) if with_plain else \
            time_pair(fn, n=2, warm=1)
        r = profile_call(f"{label}: {name}", fn, runs=1, host_calls=1, event_calls=1, warm=0)
        times[name] = {"ms": ms[0], "plain_ms": ms[1] if with_plain else None,
                       "idle": r["idle"]}
        if name in ("IIRFilter stream", "EMA stream", "partitioned FIR stream"):
            times[name]["per_block_ms"] = ms[0] / NB
        extra = f", plain {ms[1]:.4f} ms" if with_plain else ""
        print(f"time {label} {name}: {ms[0]:.4f} ms{extra}; device idle share "
              f"{r['idle']:.4f} [{card}]")
        torch.cuda.empty_cache()
    x_h32 = Signal(None, x_h[:, None].astype(np.float32), fs)
    for name, fn in (("lattice/ladder", lambda: hf["lattice"].filter_signal(x_h32)),
                     ("warped IIR", lambda: hf["warped_iir"].filter_signal(x_h32)),
                     ("state space, process_sample",
                      lambda: [hf["state_space"].process_sample(v, 0) for v in x_h])):
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        times[name] = {"host_ms": host_s * 1e3, "us_per_sample": host_s / n_host * 1e6}
        print(f"time {label} host loop {name}: {host_s * 1e3:.1f} ms for {n_host} samples "
              f"({host_s / n_host * 1e6:.2f} us a sample, host clock) [{card}]")

    # 7. the EMA kernel's average form: at the stream's (1, 1024) a launch
    # against its plain loop, and at one long row (the channel, T samples;
    # the plain loop at a cut); its bound: the bytes, or the row's steps of
    # its dependent chain (compare, select, multiply, add: four operations
    # at 4 cycles each) at the card's maximum SM clock
    blk, c0 = blocks[:1].contiguous(), carry[:1].contiguous()
    k_blk, p_blk = time_pair(lambda: cuda_ema.ema_average_cuda(blk, c0, inc, dec),
                             lambda: cuda_ema.ema_average_plain(blk, c0, inc, dec),
                             n=3, warm=1)
    row = s._x[:1].abs().contiguous()
    k_row = time_pair(lambda: cuda_ema.ema_average_cuda(row, c0, inc, dec), n=3,
                      warm=1)[0]
    cut = 12000
    row_cut = row[:, :cut].contiguous()
    k_cut, p_cut = time_pair(lambda: cuda_ema.ema_average_cuda(row_cut, c0, inc, dec),
                             lambda: cuda_ema.ema_average_plain(row_cut, c0, inc, dec),
                             n=2, warm=1)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60).stdout.split()[0]

    def ema_bound(n):
        chain = n * 16 / (float(clock) * 1e6) * 1e3
        by_bytes = 8.0 * n / HBM_BYTES_S * 1e3
        return max(chain, by_bytes), ("operations" if chain >= by_bytes else "bytes")

    blk_bound, blk_by = ema_bound(B)
    row_bound, row_by = ema_bound(T)
    print(f"time {label} EMA average kernel (1, {B}): {k_blk:.4f} ms a launch (x {NB} = "
          f"{k_blk * NB:.3f} ms), plain loop {p_blk:.4f} ms; bound {blk_bound:.5f} ms "
          f"({blk_by}); one row of {T}: kernel {k_row:.4f} ms, bound {row_bound:.4f} ms "
          f"({row_by}); at (1, {cut}): kernel {k_cut:.4f} ms, plain loop {p_cut:.4f} ms "
          f"[{card}]")
    print(f"{label} phase: {time.perf_counter() - t_phase:.1f} s")
    return {"iir_lead": launched["iir_lead"], "iir_lead_err": b2_err,
            "ema_carry": launched["ema_carry"], "ema_carry_err": ema_err,
            "ema_carry_ms": k_blk, "ema_carry_plain_ms": p_blk, "ema_carry_shape": [1, B],
            "ema_carry_bound_ms": blk_bound, "ema_carry_bound_by": blk_by,
            "ema_carry_long_row": {"shape": [1, T], "ms": k_row, "bound_ms": row_bound,
                                   "bound_by": row_by, "plain_shape": [1, cut],
                                   "ms_at_plain_shape": k_cut, "plain_ms": p_cut},
            "launches": launched, "launches_by_step": steps_l, "times": times}


def np_snr(clean, processed):
    """SNR of ``clean`` over ``processed − clean`` per row, float64 numpy."""
    import numpy as np

    c = np.asarray(clean, np.float64)
    return 20 * np.log10(c.std(axis=-1) / (np.asarray(processed, np.float64) - c).std(axis=-1))


def np_si_sdr(clean, processed):
    """Scale-invariant SDR per row, float64 numpy."""
    import numpy as np

    s, shat = np.asarray(clean, np.float64), np.asarray(processed, np.float64)
    alpha = (s * shat).sum(-1, keepdims=True) / (s * s).sum(-1, keepdims=True)
    return 10 * np.log10(((alpha * s) ** 2).sum(-1) / ((alpha * s - shat) ** 2).sum(-1))


def np_welch64(x, L=1024):
    """The Welch PSD of each row of ``x`` as the spectral distances take it
    (Hann, 50 %, each frame's mean removed after the window, the frames'
    mean of ``|rFFT|²``, the end zero-padded to whole frames), float64
    numpy."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view
    from scipy.signal import get_window

    x = np.atleast_2d(np.asarray(x, np.float64))
    w, step = get_window("hann", L, fftbins=True), L // 2
    xp = np.concatenate([x, np.zeros((x.shape[0], L - x.shape[-1] % step))], axis=-1)
    frames = sliding_window_view(xp, L, axis=-1)[:, ::step] * w
    frames = frames - frames.mean(-1, keepdims=True)
    return (np.abs(np.fft.rfft(frames, axis=-1)) ** 2).mean(1)


def np_spectral_distances(f, psd_x, psd_y):
    """``(log-spectral, Itakura-Saito)`` per column of the PSDs ``(F, C)``
    at ``f``, each energy-normalized, float64 numpy with the Simpson
    weights of the distances module (the reference's ``log10`` in the
    Itakura-Saito measure)."""
    import numpy as np

    from dsptoolbox_tpu_torch.distances.distances import _simpson_weights

    w = _simpson_weights(np.asarray(f, np.float64))
    x, y = np.asarray(psd_x, np.float64), np.asarray(psd_y, np.float64)
    r = (x / x.sum(0)) / (y / y.sum(0))
    return np.sqrt(w @ (10 * np.log10(r)) ** 2), w @ (r - np.log10(r) - 1)


def fwsnrseg64(xb, xhb, fs, gamma=0.2, snr_range_db=(-10, 35)):
    """fwSNRseg (Hu & Loizou) of one channel's gammatone bands ``(bands, T)``
    of the reference and the processed signal, in float64 on their device:
    75 ms periodic Hamming frames at 50 %, the end zero-padded to
    ``ceil(T/step)`` frames, the magnitudes normalized per frame and band,
    weighted by ``X^gamma``, each frame's SNR clipped to ``snr_range_db``."""
    import torch
    from scipy.signal.windows import hamming

    L = int(75e-3 * fs)
    L += L % 2
    step, T = L // 2, xb.shape[-1]
    K = -(-T // step)
    w = torch.as_tensor(hamming(L, sym=False), dtype=torch.float64, device=xb.device)

    def spectra(b):
        b = torch.nn.functional.pad(b.double(), (0, (K - 1) * step + L - T))
        return torch.fft.rfft(b.unfold(-1, L, step) * w, dim=-1).abs()

    X, Xh = spectra(xb), spectra(xhb)
    W = X**gamma
    Xn, Xhn = X / X.sum(-1, keepdim=True), Xh / Xh.sum(-1, keepdim=True)
    del X, Xh
    eps = 1e-30
    d = 2 * (torch.log10(Xn + eps) - torch.log10((Xn - Xhn).abs() + eps))
    frame = (10 * (d * W).sum(0) / W.sum(0)).mean(-1)
    return float(frame.clamp(*snr_range_db).mean())


def effects_phase(dev, card: str) -> dict:
    """The denoise → compress → evaluate path (`tools/effects_chain.py`) on
    config 2's 16 × 60 s session: the adaptive spectral subtractor (B1), the
    offline one (16 activity detections and Welch noise PSDs, B1), the
    compressor (`csrc/ema.cu`'s average form, one launch), the rack
    (distortion, tremolo, chorus, delay), the scores of the denoised and the
    compressed session against the clean one (SNR, SI-SDR, log-spectral and
    Itakura-Saito on Welch PSDs (B1), fwSNRseg: the gammatone bank (B3)
    twice, then B1), the EQ fit (200 Adam steps) applied through `Filter`
    (B2) and `sosfilt_diff` with a gradient, driven by `effects_chain.run`.
    Counted (every count 0 just before the path, read just after), each
    step's launches; the compressor's gain (the path's launch, kept by the
    effect) bit for bit against the EMA kernel's plain loop on six windows
    of the rows, each started from the kernel's carry; B3's output on all
    channels against the plain bank four channels at a time, B1 on the
    subtractor's frames and on fwSNRseg's chunk of channels; the subtractors
    and the EQ against their plain paths (2e-5 of the peak); SNR and SI-SDR
    against float64 numpy (1e-5 relative); the Welch PSDs against float64
    numpy (1e-5 of the peak) and the log-spectral and Itakura-Saito
    distances against float64 numpy on the card's PSDs (1e-4 relative);
    fwSNRseg on 2 channels against float64 from the bank's bands (1e-3
    relative); the EQ against scipy's float64 sosfilt on 2 channels × 10 s
    (5e-6 of the peak) and `sosfilt_diff` on 1 s (1e-3); the phase's peak
    device memory under 60 GB; each step timed with CUDA events (median of
    3 after a warm-up, in turns with the plain paths where they take
    seconds and fit beside the path's outputs) and its device idle share
    from one profiled call."""
    import numpy as np
    import torch
    from scipy.signal import sosfilt

    from dsptoolbox_tpu_torch._enums import FilterBankMode, SpectrumMethod
    from dsptoolbox_tpu_torch.distances.distances import _prepare_psd
    from dsptoolbox_tpu_torch.effects import _backend as fx
    from dsptoolbox_tpu_torch.filterbanks import auditory_filters_gammatone
    from dsptoolbox_tpu_torch.ops import cuda_ema, cuda_framing
    from dsptoolbox_tpu_torch.tools import effects_chain as ec
    from dsptoolbox_tpu_torch.tools.profile_chain import profile_call

    label = "effects"
    t_phase = time.perf_counter()
    clean, noisy = ec.inputs()
    torch.cuda.synchronize()
    C, T = clean.number_of_channels, clean.length_samples
    fs = clean.sampling_rate_hz
    print(f"{label}: clean and noisy session {C} x {T} at {fs} Hz made in "
          f"{time.perf_counter() - t_phase:.1f} s")
    out = {}

    def drive():
        mods = counted_modules()
        marks = {}

        def mark(name):
            torch.cuda.synchronize()
            marks[name] = {k: m.launches for k, m in mods.items()}

        out.update(ec.run(clean, noisy, on_step=mark))
        return marks

    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    marks, launched = counted_run(drive)
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    print(f"{label}: the path in {time.perf_counter() - t0:.1f} s (first call); launches "
          f"{launched}; peak device memory above the inputs {peak_gb:.2f} GB (limit 60)")
    if not peak_gb < 60:
        fail(f"{label}: the path held {peak_gb:.1f} GB")
    steps_l, prev = {}, {k: 0 for k in launched}
    for name, m in marks.items():
        steps_l[name] = {k: m[k] - prev[k] for k in m if m[k] - prev[k]}
        prev = m
    print(f"{label}: launches by step {steps_l}")
    need = {"adaptive subtractor": ("framing",), "offline subtractor": ("framing",),
            "compressor": ("ema_carry",), "scores, denoised": ("framing", "iir_bank"),
            "scores, compressed": ("framing", "iir_bank"), "eq match": ("iir_lead",)}
    for name, kernels in need.items():
        if not all(steps_l[name].get(k, 0) > 0 for k in kernels):
            fail(f"{label}: {name} launched {steps_l[name]}, not all of {kernels}")
    if steps_l["compressor"] != {"ema_carry": 1}:
        fail(f"{label}: the compressor launched {steps_l['compressor']}, not one EMA")

    # 1. the compressor's gain (ema.cu's average form, the path's own
    # launch, kept by the effect): bit for bit against its plain loop on six
    # windows of the rows, each from the kernel's carry
    comp = out["compressor"]
    request, gain = comp._last_gain_request, comp._last_gain
    a, r = fx.smoothing_coefficients(int(comp.attack_time_ms * 1e-3 * fs),
                                     int(comp.release_time_ms * 1e-3 * fs))
    W = 4096
    ema_err, ema_equal = 0.0, True
    for s0 in np.linspace(0, T - W, 6).astype(int):
        carry = gain.new_ones(C) if s0 == 0 else gain[:, s0 - 1]
        want = cuda_ema.ema_average_plain(request[:, s0:s0 + W], carry, a, r)
        ema_equal &= torch.equal(want, gain[:, s0:s0 + W])
        ema_err = max(ema_err, float((want - gain[:, s0:s0 + W]).abs().max()))
    print(f"{label} compressor: the path's gain, ema.cu's average form on {tuple(gain.shape)}, "
          f"vs its plain loop on six windows of {W} (each from the kernel's carry) bit-equal "
          f"{ema_equal} (max abs {ema_err:.1e})")
    if not ema_equal:
        fail(f"{label}: the compressor's gain disagrees")
    ones = gain.new_ones(C)
    ema_ms = time_pair(lambda: cuda_ema.ema_average_cuda(request, ones, a, r), n=3, warm=1)[0]
    print(f"time {label} ema.cu average form alone on ({C}, {T}): {ema_ms:.4f} ms [{card}]")
    del request, gain, comp._last_gain_request, comp._last_gain

    # 2. B1 and B3 against their plain versions at the path's shapes; the
    # subtractors and the EQ (B2) against their plain paths
    errs = {}

    def against_plain(name, kernel, got, fn, tol=2e-5):
        want = plain(fn)
        err = float((got - want).abs().max())
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        sc = float(want.abs().max())
        print(f"{label} {name}: vs its plain version max abs {err:.3e} <= {tol:g} x {sc:.3e}")
        if not err <= tol * sc:
            fail(f"{label}: {name} disagrees with its plain version")

    sub = ec.effects.SpectralSubtractor()
    sub._compute_window(fs)
    L, step = len(sub.window), sub.step_size
    xp = torch.nn.functional.pad(noisy._x, (L, L))
    win = torch.as_tensor(sub.window, dtype=torch.float32, device=dev)
    against_plain(f"B1 subtractor frames {tuple(xp.shape)} L {L}", "framing",
                  cuda_framing.windowed_frames_cuda(xp, win, step, False),
                  lambda: cuda_framing.windowed_frames_plain(xp, win, step, False), 1e-6)
    del xp
    fb = auditory_filters_gammatone(ec.FW_RANGE_HZ, 1, fs)
    nb = len(fb.filters)

    def bands(sig):
        """The bank's bands of ``sig``, ``(bands, channels, T)``."""
        return torch.stack([b._x for b in fb.filter_signal(sig, FilterBankMode.Parallel).bands])

    # the bank filters each channel on its own: the kernel's output on all
    # channels (as fwSNRseg runs it) against the plain bank four channels
    # at a time
    b3 = bands(clean)
    for c0 in range(0, C, 4):
        idx = list(range(c0, min(c0 + 4, C)))
        against_plain(f"B3 gammatone bank ({nb} bands x {C} ch x {T}), channels {idx[0]}-"
                      f"{idx[-1]}", "iir_bank", b3[:, idx[0]:idx[-1] + 1],
                      lambda: bands(clean.get_channels(idx)), 1e-5)
        torch.cuda.empty_cache()
    Lw = int(75e-3 * fs) + int(75e-3 * fs) % 2
    from scipy.signal.windows import hamming

    from dsptoolbox_tpu_torch.distances.distances import FW_CHUNK_BYTES

    # fwSNRseg frames (channels, bands, T) chunks of FW_CHUNK_BYTES of frames
    chunk = max(1, FW_CHUNK_BYTES // (nb * -(-T // (Lw // 2)) * Lw * 4))
    xb = b3[:, :chunk].transpose(0, 1).contiguous()
    w_fw = torch.as_tensor(hamming(Lw, sym=False), dtype=torch.float32, device=dev)
    against_plain(f"B1 fwSNRseg frames {tuple(xb.shape)} L {Lw}", "framing",
                  cuda_framing.windowed_frames_cuda(xb, w_fw, Lw // 2, False),
                  lambda: cuda_framing.windowed_frames_plain(xb, w_fw, Lw // 2, False), 1e-6)
    # fwSNRseg on 2 channels against float64 from the bank's bands (B3)
    ref2 = b3[:, :2].clone()
    del xb, b3
    torch.cuda.empty_cache()
    for what, sig in (("denoised", out["adaptive"]), ("compressed", out["compressed"])):
        hb = bands(sig.get_channels([0, 1]))
        want = np.array([fwsnrseg64(ref2[:, ch], hb[:, ch], fs) for ch in range(2)])
        got = out[f"scores_{what}"]["fw_snr_seg"][:2]
        e_fw = float(np.max(np.abs(got / want - 1)))
        print(f"{label} fwSNRseg, {what}, channels 0-1: {got.tolist()} dB vs float64 from the "
              f"bank's bands {want.tolist()} dB: {e_fw:.2e} relative (tol 1e-3)")
        if not e_fw <= 1e-3:
            fail(f"{label}: fwSNRseg of the {what} session disagrees with float64")
        del hb
        torch.cuda.empty_cache()
    del ref2
    against_plain("adaptive subtractor (B1)", "path", out["adaptive"]._x,
                  lambda: ec.denoise(noisy)._x)
    against_plain("offline subtractor (B1)", "path", out["offline"]._x,
                  lambda: ec.denoise(noisy, False)._x)
    eq = out["eq"]
    against_plain("fitted EQ through Filter (B2)", "iir_lead", eq["equalized"]._x,
                  lambda: eq["filter"].filter_signal(out["adaptive"])._x)

    # 3. scores against float64 numpy; the EQ against scipy float64
    c64 = clean._x.double().cpu().numpy()
    for what, sig in (("denoised", out["adaptive"]), ("compressed", out["compressed"])):
        sc = out[f"scores_{what}"]
        p64 = sig._x.double().cpu().numpy()
        e_snr = float(np.max(np.abs(sc["snr"] / np_snr(c64, p64) - 1)))
        e_sdr = float(np.max(np.abs(sc["si_sdr"] / np_si_sdr(c64, p64) - 1)))
        print(f"{label} scores, {what}: SNR {np.round(sc['snr'], 3).tolist()} dB (vs float64 "
              f"numpy {e_snr:.1e}, tol 1e-5), SI-SDR {np.round(sc['si_sdr'], 3).tolist()} dB "
              f"({e_sdr:.1e}), log-spectral {np.round(sc['log_spectral'], 4).tolist()}, "
              f"Itakura-Saito {np.round(sc['itakura_saito'], 4).tolist()}, fwSNRseg "
              f"{np.round(sc['fw_snr_seg'], 3).tolist()} dB")
        finite = all(np.isfinite(v).all() and v.shape == (C,) for v in sc.values())
        if not (e_snr <= 1e-5 and e_sdr <= 1e-5 and finite):
            fail(f"{label}: the {what} scores disagree with float64 numpy")
        # log-spectral and Itakura-Saito: the card's Welch PSDs (B1) against
        # float64 numpy's (1e-5 of the peak, each energy-normalized), and the
        # distances against float64 numpy from the card's PSDs (1e-4
        # relative). At 48 kHz the range [20, 20000] takes the DC bin,
        # where a detrended PSD is rounding noise: the distances follow the
        # PSDs' precision there, so they are held on the same PSDs
        f, px, py = _prepare_psd(clean, sig, SpectrumMethod.WelchPeriodogram,
                                 ec.spectral_range(fs), None)
        f, px, py = np.asarray(f), px.cpu().numpy(), py.cpu().numpy()
        i0 = int(np.argmin(np.abs(np.fft.rfftfreq(1024, 1 / fs) - f[0])))
        e_psd = 0.0
        for a64, p in ((c64, px), (p64, py)):
            w64 = np_welch64(a64).T[i0:i0 + len(f)]
            e_psd = max(e_psd, rel_err(p / p.sum(0), w64 / w64.sum(0)))
        l64, i64 = np_spectral_distances(f, px, py)
        e_lsd = float(np.max(np.abs(sc["log_spectral"] - l64)) / np.max(np.abs(l64)))
        e_isd = float(np.max(np.abs(sc["itakura_saito"] - i64)) / np.max(np.abs(i64)))
        print(f"{label} scores, {what}: Welch PSDs vs float64 numpy {e_psd:.2e} of the peak (tol "
              f"1e-5); log-spectral {e_lsd:.2e}, Itakura-Saito {e_isd:.2e} vs float64 from the "
              f"same PSDs (tol 1e-4)")
        if not (e_psd <= 1e-5 and e_lsd <= 1e-4 and e_isd <= 1e-4):
            fail(f"{label}: the {what} spectral distances disagree with float64 numpy")
        del p64, px, py
    del c64
    n10 = 10 * fs
    sos64 = eq["sos"].double().cpu().numpy()
    x2 = out["adaptive"]._x[:2, :n10].double().cpu().numpy()
    e_eq = rel_err(eq["equalized"]._x[:2, :n10], sosfilt(sos64, x2, axis=-1))
    x0 = x2[0, : int(ec.SOSFILT_S * fs)]
    e_diff = rel_err(eq["sosfilt_diff"], sosfilt(sos64, x0))
    losses = eq["losses"].cpu().numpy()
    # sosfilt_diff's float32 doubling squares A 16 times: a fitted section's
    # pole near the unit circle costs a few 1e-4 of the output's peak
    print(f"{label} EQ fit: {ec.EQ_SECTIONS} peaking sections, loss {losses[0]:.3e} -> "
          f"{losses[-1]:.3e} dB^2 in {len(losses)} steps; through Filter (B2) vs scipy float64 "
          f"on 2 ch x 10 s {e_eq:.3e} of the peak (tol 5e-6); sosfilt_diff on "
          f"{ec.SOSFILT_S} s vs scipy float64 {e_diff:.3e} of the peak (tol 1e-3), gradient "
          f"finite {bool(torch.isfinite(eq['grad']).all())}")
    if not (e_eq <= 5e-6 and e_diff <= 1e-3 and torch.isfinite(eq["grad"]).all()
            and losses[-1] <= losses[0]):
        fail(f"{label}: the EQ match disagrees")
    rack_ok = all(torch.isfinite(s._x).all() for s in out["rack"])
    print(f"{label} rack: outputs {[tuple(s._x.shape) for s in out['rack']]} finite {rack_ok}")
    if not rack_ok:
        fail(f"{label}: the rack's output is not finite")

    # 4. times: each step with CUDA events (in turns with the plain paths
    # where they take seconds) and its device idle share from one profiled
    # call
    fx_rack = ec.rack()
    den_sig, comp_sig = out["adaptive"], out["compressed"]
    calls = ec.score_calls(clean, den_sig)
    steps = {
        "adaptive subtractor": (lambda: ec.denoise(noisy), True),
        "offline subtractor": (lambda: ec.denoise(noisy, False), True),
        "compressor": (lambda: ec.compress(den_sig), False),
        "distortion": (lambda: fx_rack[0].apply(comp_sig), False),
        "tremolo": (lambda: fx_rack[1].apply(comp_sig), False),
        "chorus": (lambda: fx_rack[2].apply(comp_sig), False),
        "digital delay": (lambda: fx_rack[3].apply(comp_sig), False),
        "snr": (calls["snr"], False),
        "si_sdr": (calls["si_sdr"], False),
        "log_spectral": (calls["log_spectral"], True),
        "itakura_saito": (calls["itakura_saito"], True),
        # the plain bank on all 16 channels at once needs a 23 GB temporary
        # beside the path's outputs: no plain time (it is checked above in
        # slices of four channels)
        "fw_snr_seg": (calls["fw_snr_seg"], False),
        "eq fit (200 Adam steps)": (lambda: ec.eq_match(clean, den_sig), False),
        "eq through Filter (B2)": (lambda: eq["filter"].filter_signal(den_sig), True),
    }
    times = {}
    for name, (fn, with_plain) in steps.items():
        ms = time_pair(fn, lambda: plain(fn), n=3, warm=1) if with_plain else \
            time_pair(fn, n=3, warm=1)
        r = profile_call(f"{label}: {name}", fn, runs=1, host_calls=1, event_calls=1, warm=0)
        times[name] = {"ms": ms[0], "plain_ms": ms[1] if with_plain else None,
                       "idle": r["idle"]}
        extra = f", plain {ms[1]:.4f} ms" if with_plain else ""
        print(f"time {label} {name}: {ms[0]:.4f} ms{extra}; device idle share "
              f"{r['idle']:.4f} [{card}]")
        torch.cuda.empty_cache()
    print(f"{label} phase: {time.perf_counter() - t_phase:.1f} s")
    return {"framing": launched["framing"], "framing_err": errs["framing"],
            "iir_lead": launched["iir_lead"], "iir_lead_err": errs["iir_lead"],
            "iir_bank": launched["iir_bank"], "iir_bank_err": errs["iir_bank"],
            "ema_carry": launched["ema_carry"], "ema_carry_err": ema_err,
            "ema_carry_ms": ema_ms, "ema_carry_shape": [C, T],
            "launches": launched, "launches_by_step": steps_l, "times": times,
            "peak_gb": peak_gb}


def device_rel_err(got, want) -> float:
    """`rel_err` on the tensors' device, in float64 (complex128): no host
    copy of large outputs."""
    import torch

    dt = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    scale = float(want.abs().max()) or 1.0
    return float((got.to(dt) - want.to(dt)).abs().max()) / scale


def mesh_phase(dev, card: str) -> dict:
    """The ``parallel`` layer and every ``mesh=`` keyword at full width, on
    `MESH_SHARDS` shards of the one card (`Mesh([dev] × 4)`: each shard's
    work issued in turn, the collectives as tensor moves on the card) and
    on `device_mesh()` (one device: the single-device path): config 2's 16
    × 60 s session through `get_csm(mesh=)` and `parallel_welch` (4
    channels a shard, B1), `parallel_stft` and `parallel_welch_time` (STFT
    1024/50 %, the session cut to `MESH_STFT_T` samples: each shard must
    hold whole hops), `parallel_fir_filter` with a room IR and
    `sharded_map_reduce`'s energy; the 31-band 1/3-octave bank (order 8)
    through `FilterBank.filter_signal(mesh=)`, Parallel and Summed (padded
    to 32 bands, B3 a shard); config 5's map (64 mics, 30 × 30 points, 2 kHz
    third octave) through `get_beamformer_map(mesh=)` with and without the
    diagonal removal and `parallel_das_map` on the (513, 64, 900) sweep (B5
    a shard); config 4's 1000 × 8000 fleet through
    `parallel_batch_descriptors`; config 2 (a) through `pipeline(mesh=)`.
    Each path against the port's single-device call (2e-5 scale-relative;
    the maps' argmax equal; bit-equality printed) and, where it runs a
    kernel, against that call on the plain versions (`plain`, the same
    tolerance; its max abs error joins the kernel's), the bank also against
    scipy's float64 sosfilt on channel 0 (5e-6), counted (every count 0 just
    before the mesh call, read just after: B1, B3 and B5 at least once a
    shard), timed sharded and single (CUDA events, median, in turns: the
    sharding's cost on one card, not a speed-up), with the phase's peak
    device memory. Also once on the card: float64 mode's `Filter` on a card
    signal stays on the card on the torch float64 path (scipy's route is for
    CPU signals only, `classes.filter_helpers._oracle_exact_f64`) and meets
    scipy's float64 sosfilt at 5e-6 scale-relative with no B2 launch, and
    the session's lazy spectrogram through `transforms.istft` without a
    host copy."""
    import numpy as np
    import torch
    from scipy.signal import sosfilt

    from dsptoolbox_tpu_torch import _config, parallel, pipeline
    from dsptoolbox_tpu_torch._enums import FilterBankMode, FilterPassType
    from dsptoolbox_tpu_torch.classes import Filter, FilterBank, Signal
    from dsptoolbox_tpu_torch.ops import cuda_das
    from dsptoolbox_tpu_torch.ops.fft_conv import fft_convolve
    from dsptoolbox_tpu_torch.ops.spectral import stft, welch
    from dsptoolbox_tpu_torch.room_acoustics.batch import batch_descriptors
    from dsptoolbox_tpu_torch.tools import camera, feature_chain as fc
    from dsptoolbox_tpu_torch.tools import measurement as ms
    from dsptoolbox_tpu_torch.tools import room_measurement as rm
    from dsptoolbox_tpu_torch.tools import speech_chain as sc
    from dsptoolbox_tpu_torch.transforms import istft

    label = "mesh"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    devs = np.empty(MESH_SHARDS, dtype=object)
    devs[:] = [dev] * MESH_SHARDS
    mesh = parallel.Mesh(devs, ("dp",))
    one = parallel.device_mesh()
    print(f"{label}: {mesh}; device_mesh() = {one}")
    if one.devices.size != torch.cuda.device_count():
        fail("device_mesh() does not hold every card")
    launched, errs, times, bit_equal, plain_errs = {}, {}, {}, {}, {}
    K = ("framing", "iir_bank", "das_map")
    shards = MESH_SHARDS

    def pairs_of(got, want):
        if isinstance(got, dict):
            return list(zip(got.values(), want.values()))
        return [(got, want)]

    def check(name, got, want, kernel=None, tol=2e-5, plain_want=None):
        """The mesh call's outputs ``got`` against the single-device call's
        ``want`` (tensors, or dicts of them), and, for a path through
        ``kernel``, against ``plain_want``, the single-device call with
        every kernel switched off (`plain`), both at ``tol`` scale-relative
        (each tensor to its own peak); counted launches of ``kernel`` at
        least once a shard. The max abs error against the plain call joins
        the kernel's ``max_abs_err``."""
        pairs = pairs_of(got, want)
        err = max(device_rel_err(g, w) for g, w in pairs)
        same = all(torch.equal(g, w) for g, w in pairs)
        errs[name], bit_equal[name] = err, same
        n = launched[name].get(kernel, 0) if kernel else None
        print(f"{label} {name}: scale-rel err vs single device {err:.3e} (tol {tol:.0e}); "
              f"bit-equal {same}; launches {launched[name]}")
        if not err <= tol:
            fail(f"{label} {name}: disagrees with the single-device call")
        if kernel:
            pairs = pairs_of(got, plain_want)
            p_err = max(device_rel_err(g, w) for g, w in pairs)
            plain_errs[name] = max(float((g - w).abs().max()) for g, w in pairs)
            print(f"{label} {name}: vs the plain single-device call scale-rel {p_err:.3e} "
                  f"(tol {tol:.0e}), max abs {plain_errs[name]:.3e}")
            if not p_err <= tol:
                fail(f"{label} {name}: disagrees with the plain single-device call")
            if n < shards:
                fail(f"{label} {name}: {kernel} launched {n} times, fewer than {shards} shards")

    def timed(name, sharded, single, n=5):
        ms_, ss_ = time_pair(sharded, single, n=n, warm=1)
        times[name] = {"sharded_ms": ms_, "single_ms": ss_}
        print(f"time {label} {name}: sharded ({shards} shards, one card) {ms_:.4f} ms, "
              f"single device {ss_:.4f} ms [{card}]")
        torch.cuda.empty_cache()

    # 1. config 2's session: channel-parallel CSM and Welch, time-parallel
    # STFT and Welch, the FIR with a room IR, the energy by map-reduce
    sig = sc.signal(*sc.MINUTE)
    x = sig._x
    C, T = x.shape
    fs = sig.sampling_rate_hz
    csm_p = plain(sig._csm)[1]
    sig._cache.pop("csm")
    f_s, csm_s = sig._csm()
    got, launched["csm"] = counted_run(lambda: sig.get_csm(mesh=mesh, return_device=False))
    check("csm", got[1].device_tensor(), csm_s, "framing", plain_want=csm_p)
    timed("csm", lambda: sig.get_csm(mesh=mesh), lambda: sig.get_csm(force_computation=True))
    one_csm = sig.get_csm(mesh=one, return_device=False)[1].device_tensor()
    if not torch.equal(one_csm, sig._csm()[1]):
        fail(f"{label}: get_csm on device_mesh() differs from no mesh")
    del got, csm_s, csm_p, one_csm
    welch_kw = dict(sampling_rate_hz=fs, window_length_samples=sc.WINDOW)
    got, launched["welch"] = counted_run(lambda: parallel.parallel_welch(x, mesh, **welch_kw))
    check("welch", got, welch(x, **welch_kw), "framing",
          plain_want=plain(lambda: welch(x, **welch_kw)))
    timed("welch", lambda: parallel.parallel_welch(x, mesh, **welch_kw),
          lambda: welch(x, **welch_kw))
    xt = x[:, :MESH_STFT_T]
    print(f"{label}: STFT and time-parallel Welch on {tuple(xt.shape)}: the session cut "
          f"from {T} to {MESH_STFT_T} samples ({shards} x {MESH_STFT_T // shards // 1024} x "
          "1024: whole hops a shard)")
    got, launched["stft"] = counted_run(lambda: parallel.parallel_stft(xt, mesh, **welch_kw)[2])
    want = stft(xt, padding=False, **welch_kw)[2]
    want_p = plain(lambda: stft(xt, padding=False, **welch_kw)[2])
    check("stft", got, want, "framing", plain_want=want_p)
    del got, want, want_p
    timed("stft", lambda: parallel.parallel_stft(xt, mesh, **welch_kw),
          lambda: stft(xt, padding=False, **welch_kw))
    got, launched["welch_time"] = counted_run(
        lambda: parallel.parallel_welch_time(xt, mesh, **welch_kw))
    check("welch_time", got, welch(xt, **welch_kw), "framing",
          plain_want=plain(lambda: welch(xt, **welch_kw)))
    timed("welch_time", lambda: parallel.parallel_welch_time(xt, mesh, **welch_kw),
          lambda: welch(xt, **welch_kw))
    h = ms.room_irs(0)[0][:, 0]
    hd = torch.as_tensor(h, dtype=torch.float32, device=dev)
    got, launched["fir"] = counted_run(lambda: parallel.parallel_fir_filter(h, x, mesh))
    check("fir", got, fft_convolve(x, hd)[..., :T])
    timed("fir", lambda: parallel.parallel_fir_filter(h, x, mesh),
          lambda: fft_convolve(x, hd)[..., :T])
    del got

    def energy(row):
        return torch.sum(row.double() ** 2)

    got, launched["energy"] = counted_run(
        lambda: parallel.sharded_map_reduce(energy, x, mesh, reduce="sum"))
    check("energy", got, torch.sum(x.double() ** 2))
    timed("energy", lambda: parallel.sharded_map_reduce(energy, x, mesh, reduce="sum"),
          lambda: torch.sum(x.double() ** 2))

    # 2. the 31-band 1/3-octave bank (order 8), Parallel and Summed, padded
    # to 32 bands on 4 shards
    factor = 2 ** (1 / 6)
    fb = FilterBank([Filter.iir_filter(fc.BANK_ORDER, [f / factor, f * factor],
                                       FilterPassType.Bandpass, fs) for f in fc.THIRD_OCTAVES])
    bands_s = fb.filter_signal(sig, FilterBankMode.Parallel)
    bands_p = plain(lambda: fb.filter_signal(sig, FilterBankMode.Parallel))
    bands, launched["bank_parallel"] = counted_run(
        lambda: fb.filter_signal(sig, FilterBankMode.Parallel, mesh=mesh))
    check("bank_parallel", {i: b._x for i, b in enumerate(bands.bands)},
          {i: b._x for i, b in enumerate(bands_s.bands)}, "iir_bank",
          plain_want={i: b._x for i, b in enumerate(bands_p.bands)})
    del bands_p
    x0 = x[0].double().cpu().numpy()
    sc_err = 0.0
    for i in range(0, len(fb.filters), 5):
        sc_err = max(sc_err, device_rel_err(
            bands.bands[i]._x[0], torch.from_numpy(sosfilt(fb.filters[i].sos, x0)).to(dev)))
    errs["bank_scipy"] = sc_err
    print(f"{label} bank_parallel bands 0, 5, ..., 30, channel 0 vs scipy float64 sosfilt: "
          f"scale-rel {sc_err:.3e} (tol 5e-6)")
    if not sc_err <= 5e-6:
        fail(f"{label}: the sharded bank disagrees with scipy")
    del bands, bands_s
    torch.cuda.empty_cache()
    summed_s = fb.filter_signal(sig, FilterBankMode.Summed)._x
    summed_p = plain(lambda: fb.filter_signal(sig, FilterBankMode.Summed)._x)
    summed, launched["bank_summed"] = counted_run(
        lambda: fb.filter_signal(sig, FilterBankMode.Summed, mesh=mesh)._x)
    check("bank_summed", summed, summed_s, "iir_bank", plain_want=summed_p)
    del summed, summed_s, summed_p
    torch.cuda.empty_cache()
    timed("bank_parallel", lambda: fb.filter_signal(sig, FilterBankMode.Parallel, mesh=mesh),
          lambda: fb.filter_signal(sig, FilterBankMode.Parallel), n=3)
    timed("bank_summed", lambda: fb.filter_signal(sig, FilterBankMode.Summed, mesh=mesh),
          lambda: fb.filter_signal(sig, FilterBankMode.Summed), n=3)

    # 3. lazy getters on the card: the session's spectrogram through istft
    # without a host copy; a spectrum read on the host equals its tensor
    t_, f_, S = sig.get_spectrogram()
    y = istft(S, original_signal=sig)
    torch.cuda.synchronize()
    rt = float((y._x - x).abs().max())
    print(f"{label} lazy spectrogram {S.shape} {S.dtype} through istft: materialized "
          f"{S.is_materialized}; round trip max abs {rt:.3e} (tol 1e-5)")
    if S.is_materialized or not rt <= 1e-5:
        fail(f"{label}: istft fetched the lazy spectrogram or missed the round trip")
    _, sp = sig.get_spectrum()
    if not np.array_equal(np.asarray(sp), sig.get_spectrum(return_device=True)[1].cpu().numpy()):
        fail(f"{label}: a lazy spectrum read on the host differs from its tensor")
    del S, y, sp, sig, x, xt
    torch.cuda.empty_cache()

    # 4. config 5's map, grid-parallel; B5 on the full sweep, sharded
    g = camera.grid()
    seconds, cam_fs = CAMERA_RUNS[-1]
    beam = camera.beamformer(camera.array_signal(seconds, cam_fs, dev, g), g)
    beam.signal.get_csm()  # the single-device CSM, shared by both maps
    for rd in (True, False):
        name = f"das_map remove_diag={rd}"
        want = beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION,
                                       remove_csm_diagonal=rd)
        want_p = plain(lambda: beam.get_beamformer_map(
            camera.CENTER_HZ, camera.OCTAVE_FRACTION, remove_csm_diagonal=rd))
        got, launched[name] = counted_run(lambda: beam.get_beamformer_map(
            camera.CENTER_HZ, camera.OCTAVE_FRACTION, remove_csm_diagonal=rd, mesh=mesh))
        check(name, got, want, "das_map", plain_want=want_p)
        am, am_s = int(torch.argmax(got)), int(torch.argmax(want))
        print(f"{label} {name}: argmax {am}, single device {am_s}")
        if am != am_s:
            fail(f"{label} {name}: the map's peak moved")
        if not torch.equal(beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION,
                                                   remove_csm_diagonal=rd, mesh=one), want):
            fail(f"{label}: the map on device_mesh() differs from no mesh")
        timed(name, lambda: beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION,
                                                    remove_csm_diagonal=rd, mesh=mesh),
              lambda: beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION,
                                              remove_csm_diagonal=rd), n=10)
    F, M, G = DAS_SWEEP
    gen = np.random.default_rng(19)
    Cm = gen.standard_normal((F, M, M)) + 1j * gen.standard_normal((F, M, M))
    Cm = torch.as_tensor((Cm + np.conj(np.swapaxes(Cm, -1, -2))) / 2, dtype=torch.complex64,
                         device=dev)
    amp = torch.as_tensor(gen.uniform(0.5, 1.0, (M, G)), dtype=torch.float32, device=dev)
    diff = torch.as_tensor(gen.uniform(-0.3, 0.3, (M, G)), dtype=torch.float32, device=dev)
    k = torch.as_tensor(np.arange(F) * (48000 / 1024) * 2 * np.pi / 343, dtype=torch.float32,
                        device=dev)
    cre, cim = Cm.real.contiguous(), Cm.imag.contiguous()
    want = cuda_das.das_map(amp, diff, k, cre, cim)
    got, launched["das_sweep"] = counted_run(
        lambda: parallel.parallel_das_map(amp, diff, k, Cm, mesh))
    check("das_sweep", got, want, "das_map", tol=5e-5,
          plain_want=cuda_das.das_map_plain(amp, diff, k, cre, cim))
    timed("das_sweep", lambda: parallel.parallel_das_map(amp, diff, k, Cm, mesh),
          lambda: cuda_das.das_map(amp, diff, k, cre, cim), n=10)
    del beam, Cm, cre, cim, amp, diff, got, want

    # 5. config 4's fleet, batch-parallel
    rirs = torch.from_numpy(rm.battery_rirs()).to(dev)
    got, launched["descriptors"] = counted_run(
        lambda: parallel.parallel_batch_descriptors(rirs, rm.BATTERY_FS, mesh))
    check("descriptors", got, batch_descriptors(rirs, rm.BATTERY_FS))
    timed("descriptors", lambda: parallel.parallel_batch_descriptors(rirs, rm.BATTERY_FS, mesh),
          lambda: batch_descriptors(rirs, rm.BATTERY_FS), n=10)

    # 6. config 2 (a) captured through pipeline(mesh=): the chain on the
    # mesh's first device, against the same chain without a mesh
    speech = sc.signal(*sc.SPEECH)
    run_mesh, run_one = pipeline(sc.run, mesh=mesh), pipeline(sc.run)
    got, launched["pipeline"] = counted_run(lambda: run_mesh(speech))
    want = run_one(speech)
    check("pipeline", {"y": got[0]._x, "welch": got[1], "csm": got[2]},
          {"y": want[0]._x, "welch": want[1], "csm": want[2]})
    timed("pipeline", lambda: run_mesh(speech), lambda: run_one(speech), n=10)

    # 7. float64 mode on the card: `Filter` on the torch float64 path on the
    # card (B2 takes float32 only), against scipy's float64 sosfilt
    x64 = np.random.default_rng(23).standard_normal((10 * fs, 2))
    filt = Filter.iir_filter(6, 200.0, FilterPassType.Lowpass, fs)
    _config.set_default_float("float64")
    try:
        y64, launched["float64_filter"] = counted_run(
            lambda: filt.filter_signal(Signal(None, x64, fs, device=dev)))
    finally:
        _config.set_default_float("float32")
    on_card = y64._x.device.type == torch.device(dev).type and y64._x.dtype == torch.float64
    want64 = sosfilt(filt.sos, x64, axis=0)
    err64 = float(np.abs(y64.time_data.cpu().numpy() - want64).max() / np.abs(want64).max())
    print(f"{label} float64 mode Filter (order 6, 200 Hz) on 2 x 10 s: on the card in float64 "
          f"{on_card}; vs scipy float64 sosfilt scale-rel {err64:.3e} (tol 5e-6); launches "
          f"{launched['float64_filter']}")
    if not on_card or not err64 <= 5e-6 or launched["float64_filter"]["iir_lead"]:
        fail(f"{label}: float64 mode's Filter left the card, missed scipy or launched B2")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    totals = {k_: sum(v.get(k_, 0) for v in launched.values()) for k_ in K}
    print(f"{label} launches by path: "
          f"{ {n: {k_: v[k_] for k_ in K if v.get(k_)} for n, v in launched.items()} }")
    print(f"{label}: launches {totals}; peak device memory {peak_gb:.2f} GB; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": totals, "launches_by_path": launched, "errors": errs,
            "bit_equal": bit_equal, "times": times, "peak_gb": peak_gb,
            "plain_errors": plain_errs,
            "framing_err": max(plain_errs[n] for n in ("csm", "welch", "stft", "welch_time")),
            "iir_bank_err": max(plain_errs["bank_parallel"], plain_errs["bank_summed"]),
            "das_map_err": max(v for n, v in plain_errs.items() if n.startswith("das"))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np
    from scipy.signal import sosfilt as scipy_sosfilt
    from scipy.signal import sosfilt_zi

    from dsptoolbox_tpu_torch import _config, _cuda, headline
    from dsptoolbox_tpu_torch.beamforming import SteeringVector, SteeringVectorType
    from dsptoolbox_tpu_torch.ops import cuda_das, cuda_framing, cuda_iir, cuda_iir_bank
    from dsptoolbox_tpu_torch.tools import camera
    from dsptoolbox_tpu_torch.ops.framing import compute_number_frames
    from dsptoolbox_tpu_torch.ops.iir_block import (
        _block_operators,
        operators_to_torch,
        sosfilt_block,
    )
    from dsptoolbox_tpu_torch.ops.windows import get_window
    from dsptoolbox_tpu_torch.standard.enums import Window

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}")
    print(f"nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    rng = np.random.default_rng(0)

    # 2. build every kernel, one nvcc per source, and the FLAC codec (g++),
    # all at once
    from dsptoolbox_tpu_torch.io import flac

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        codec = pool.submit(flac._build)
        list(pool.map(_cuda.load, KERNELS))
        codec.result()
    print(f"build {', '.join(KERNELS)} and the FLAC codec: {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        entry = _cuda.BUILD_LOG.get(name, {})
        print(f"build {name}.cu: {entry.get('seconds', 0.0):.2f} s")
        for line in entry.get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. B1 framing kernel vs plain at the STFT's shapes: x (16, 384000)
    # framed as padded with 512 zeros at both ends (read in place, as the
    # STFT does), and the same frames from an explicitly padded copy
    pad = WINDOW - STEP
    x = torch.from_numpy(
        rng.standard_normal((BATCH, T)).astype(np.float32)
    ).to(dev)
    x_pad = torch.nn.functional.pad(x, (pad, pad))
    win = torch.as_tensor(
        get_window(Window.Hann, WINDOW), dtype=torch.float32, device=dev
    )
    K = compute_number_frames(WINDOW, STEP, T + 2 * pad)[0]
    b1_err = 0.0
    for detrend in (True, False):
        for xin, p in ((x, pad), (x_pad, 0)):
            yk = cuda_framing.windowed_frames_cuda(xin, win, STEP, detrend, p)
            yp = cuda_framing.windowed_frames_plain(xin, win, STEP, detrend, p)
            torch.cuda.synchronize()
            if yk.shape != (BATCH, K, WINDOW):
                fail(f"framing kernel shape {tuple(yk.shape)}")
            err = float((yk - yp).abs().max())
            b1_err = max(b1_err, err)
            print(f"B1 framing x {tuple(xin.shape)} pad={p} detrend={detrend}: "
                  f"max abs err {err:.3e} (tol 1e-6)")
            if not err <= 1e-6:
                fail("framing kernel disagrees with its plain version")
    # ... at the Welch CSM's shape of the DAS path's 10 s x 48 kHz recording
    # (64 mics, L = 1024, hop 512, detrend), and at frames of 2^16 and 2^18
    # samples (one block per frame; Welch's longest is 2^18)
    x_csm = torch.from_numpy(rng.standard_normal(CSM_SHAPE).astype(np.float32)).to(dev)
    for xin, L, step, detrend in ((x_csm, WINDOW, STEP, True),
                                  (x_csm[:2], 2**16, 2**15, True),
                                  (x_csm[:1], 2**18, 2**17, False)):
        w = torch.as_tensor(get_window(Window.Hann, L), dtype=torch.float32, device=dev)
        yk = cuda_framing.windowed_frames_cuda(xin, w, step, detrend)
        yp = cuda_framing.windowed_frames_plain(xin, w, step, detrend)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        b1_err = max(b1_err, err)
        print(f"B1 framing x {tuple(xin.shape)} L={L} step={step} detrend={detrend}, "
              f"{cuda_framing.frames_per_block(L, step, yk.shape[-2])} frames a block: "
              f"max abs err {err:.3e} (tol 1e-6)")
        if yk.shape != yp.shape or not err <= 1e-6:
            fail("framing kernel disagrees with its plain version")

    # 4. B2 IIR lead kernel vs plain, per crossover band, nonzero zi, on
    # the tensor-core output pass (blocks of 128)
    xb = x.reshape(BATCH, T // L_IIR, L_IIR)
    out_pass = cuda_iir_bank.output_pass(L_IIR)
    if out_pass != "mma":
        fail(f"B2 at L = {L_IIR} takes the {out_pass} output pass, not the tensor cores")
    gains = rng.uniform(0.2, 1.0, (BATCH, 1, 1))
    b2_err = 0.0
    lead_args = []
    for i, sos in enumerate(headline.crossover_bank(FS)):
        key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
        zi = sosfilt_zi(sos)[None] * gains  # (B, S, 2)
        ops = operators_to_torch(
            dict(zip(("HmatT", "GyT", "ALT", "MT"), _block_operators(key, L_IIR)),
                 zi=zi),
            dev, torch.float32,
        )
        args = (ops["HmatT"], ops["GyT"], ops["ALT"], ops["MT"], xb,
                ops["zi"].reshape(BATCH, -1))
        lead_args.append(args)
        yk, zk = cuda_iir.sosfilt_lead_cuda(*args)
        yp, zp = cuda_iir.sosfilt_lead_plain(*args)
        torch.cuda.synchronize()
        y_err = float((yk - yp).abs().max())
        y_scale = float(yp.abs().max())
        z_err = float((zk - zp).abs().max())
        z_scale = max(1.0, float(zp.abs().max()))
        b2_err = max(b2_err, y_err)
        y0_ref, _ = scipy_sosfilt(sos, x[0].double().cpu().numpy(), zi=zi[0])
        sc_err = rel_err(yk[0].reshape(-1), y0_ref)
        print(f"B2 lead band {i} N={args[2].shape[0]}, output pass {out_pass}: "
              f"|dy| {y_err:.3e} <= 1e-5*{y_scale:.3e}; "
              f"|dzf| {z_err:.3e} <= 1e-6*{z_scale:.3e}; "
              f"scipy f64 channel 0 scale-rel {sc_err:.3e} (tol 5e-6)")
        if not (y_err <= 1e-5 * y_scale and z_err <= 1e-6 * z_scale):
            fail(f"IIR lead kernel disagrees with its plain version (band {i})")
        if not sc_err <= 5e-6:
            fail(f"IIR lead kernel disagrees with scipy (band {i})")
    # a short input (T = 1000: 7 blocks of 128) through sosfilt_block still
    # launches B2
    sos = headline.crossover_bank(FS)[1]
    zi = sosfilt_zi(sos)[None] * gains
    before = cuda_iir.launches
    ys, _ = sosfilt_block(sos, x[:, :1000], zi=zi)
    torch.cuda.synchronize()
    short_launches = cuda_iir.launches - before
    yp, _ = plain(lambda: sosfilt_block(sos, x[:, :1000], zi=zi))
    y_err = float((ys - yp).abs().max())
    b2_err = max(b2_err, y_err)
    sc_err = rel_err(ys[0], scipy_sosfilt(sos, x[0, :1000].double().cpu().numpy(), zi=zi[0])[0])
    print(f"B2 lead, 7 blocks (T = 1000), output pass {out_pass}: {short_launches} "
          f"launch; |dy| vs plain "
          f"{y_err:.3e} <= 1e-5*{float(yp.abs().max()):.3e}; scipy f64 channel 0 "
          f"scale-rel {sc_err:.3e} (tol 5e-6)")
    if short_launches != 1 or not (y_err <= 1e-5 * float(yp.abs().max()) and sc_err <= 5e-6):
        fail("a 7-block lead did not run B2 or disagrees with plain or scipy")

    # 5. the slice: the chain through the kernels, counted
    exc = torch.fft.rfft(
        torch.from_numpy(rng.standard_normal(T).astype(np.float32)).to(dev)
    )
    # per_band runs B1 + B2, banked B1 + B3
    chain_kernels = {"per_band": ("framing", "iir_lead"), "banked": ("framing", "iir_bank")}
    counted = {"framing": cuda_framing, "iir_lead": cuda_iir, "iir_bank": cuda_iir_bank}
    out, chain_launches = {}, {}
    for bank in chain_kernels:
        for m in counted.values():
            m.launches = 0
        out[bank] = headline.run(x, exc, bank=bank)
        torch.cuda.synchronize()
        chain_launches[bank] = {name: m.launches for name, m in counted.items()}
    launches = {name: sum(c[name] for c in chain_launches.values()) for name in counted}
    print(f"launches in the chain: {chain_launches}")
    if not all(chain_launches[bank][k] > 0 for bank, ks in chain_kernels.items() for k in ks):
        fail("the chain did not go through every kernel (per_band: B1 + B2, banked: B1 + B3)")

    ref = {bank: plain(lambda: headline.run(x, exc, bank=bank)) for bank in out}
    shapes = ((BATCH,), (BATCH, 4, T), (BATCH, T))
    for bank in out:
        for name, got, want, shape in zip(
            ("energy", "bands", "ir"), out[bank], ref[bank], shapes
        ):
            if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
                fail(f"{bank} {name}: shape {tuple(got.shape)} or non-finite")
            err = rel_err(got, want)
            print(f"chain {bank} {name}: scale-rel err vs plain {err:.3e} (tol 2e-5)")
            if not err <= 2e-5:
                fail(f"chain {bank} {name} disagrees with the plain chain")
    # independent float64 references for channel 0
    x0 = x[0].double().cpu().numpy()
    for i, sos in enumerate(headline.crossover_bank(FS)):
        err = rel_err(out["per_band"][1][0, i], scipy_sosfilt(sos, x0))
        print(f"chain band {i} vs scipy f64: scale-rel {err:.3e} (tol 5e-6)")
        if not err <= 5e-6:
            fail(f"chain band {i} disagrees with scipy")
    e0 = exc.cpu().numpy().astype(np.complex128)
    ir0 = np.fft.irfft(np.fft.rfft(x0) * np.conj(e0) / (np.abs(e0) ** 2 + 1e-3), n=T)
    err = rel_err(out["per_band"][2][0], ir0)
    print(f"chain ir vs numpy f64: scale-rel {err:.3e} (tol 2e-5)")
    if not err <= 2e-5:
        fail("chain ir disagrees with numpy")

    # 6. times: kernel vs plain in turns, CUDA events, median of 20. B1 at
    # the chain's STFT and at the DAS path's Welch CSM; its bound: x read,
    # frames written, one multiply per frame sample
    b1_shapes = []
    for xin, p, detrend in ((x, pad, False), (x_csm, 0, True)):
        k_ms, p_ms = time_pair(
            lambda: cuda_framing.windowed_frames_cuda(xin, win, STEP, detrend, p),
            lambda: cuda_framing.windowed_frames_plain(xin, win, STEP, detrend, p),
        )
        rows, n = xin.shape
        Kb = compute_number_frames(WINDOW, STEP, n + 2 * p)[0]
        b_ms, b_by = bound(4 * (xin.numel() + rows * Kb * WINDOW + WINDOW),
                           rows * Kb * WINDOW)
        print(f"time B1 framing {tuple(xin.shape)} pad={p} L={WINDOW} step={STEP} "
              f"detrend={detrend}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {k_ms / b_ms:.2f}×)")
        b1_shapes.append({"shape": [rows, n], "pad": p, "detrend": detrend, "ms": k_ms,
                          "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
    del x_csm
    b1_ms, b1_plain = b1_shapes[0]["ms"], b1_shapes[0]["plain_ms"]
    # ... and the Welch CSM's Gram kernel at config 2's and the camera's X
    gram = csm_gram_phase(dev, card)
    b2_ms = b2_plain = 0.0
    for i, args in enumerate(lead_args):
        k_ms, p_ms = time_pair(
            lambda: cuda_iir.sosfilt_lead_cuda(*args),
            lambda: cuda_iir.sosfilt_lead_plain(*args),
        )
        b2_ms += k_ms
        b2_plain += p_ms
        print(f"time B2 lead band {i} ({BATCH}, {T // L_IIR}, {L_IIR}) "
              f"N={args[2].shape[0]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    print(f"time B2 lead, four bands: kernel {b2_ms:.4f} ms, plain {b2_plain:.4f} ms")

    audio_s = BATCH * SECONDS
    for bank, ks in chain_kernels.items():
        k_ms, p_ms = time_pair(
            lambda: headline.run(x, exc, bank=bank),
            lambda: plain(lambda: headline.run(x, exc, bank=bank)),
        )
        names = " + ".join({"framing": "B1", "iir_lead": "B2", "iir_bank": "B3"}[k] for k in ks)
        print(f"time chain {bank} ({names}): kernels {k_ms:.4f} ms "
              f"({audio_s / (k_ms * 1e-3):.1f} audio-s/s), plain paths "
              f"{p_ms:.4f} ms ({audio_s / (p_ms * 1e-3):.1f} audio-s/s)")

    # 7. B5 DAS map kernel vs plain: the full sweep of 513 bins x 64 mics x
    # 900 points (random Hermitian C, amp in U(0.5, 1), diff of the camera's
    # geometry, k on the rfft ramp of a 1024-point window at 48 kHz), two
    # ragged shapes, and a non-Hermitian C (from its own generator) at
    # `DAS_ANY_CSM`; each case prints the kernel's plan, and the sweep is
    # launched twice for bit-identical maps
    cam_grid = camera.grid()
    geom_diff = SteeringVector(SteeringVectorType.TrueLocation).get_amp_diff(
        cam_grid, camera.planar_array())[1]
    das_rng = np.random.default_rng(9)

    def das_inputs(F, M, G, hermitian=True, gen=None):
        gen = rng if gen is None else gen
        C = gen.standard_normal((F, M, M)) + 1j * gen.standard_normal((F, M, M))
        if hermitian:
            C = (C + np.conj(np.swapaxes(C, -1, -2))) / 2
        amp = gen.uniform(0.5, 1.0, (M, G))
        diff = geom_diff if (M, G) == geom_diff.shape else gen.uniform(-0.3, 0.3, (M, G))
        k = np.arange(F) * (FS / 1024) * 2 * np.pi / 343
        return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
                for a in (amp, diff, k, C.real, C.imag)]

    def das_bound(F, M, G):
        # C (real and imaginary) read, the map written; Re(hᴴ C h) needs only
        # C's Hermitian part, so 2·M² + 2·M FMAs per (point, bin) over its
        # upper triangle, plus M² per bin to fold C into (C + Cᴴ)/2 once
        return bound(4 * (2 * F * M * M + 2 * M * G + F + G * F),
                     2.0 * F * G * (2 * M * M + 2 * M) + 2.0 * F * M * M)

    def das_design(F, M, G):
        d = cuda_das.kernel_design(M, G, F)
        want = cuda_das.design(M, G, F)
        if {key: d[key] for key in want} != want:
            fail(f"B5's plan at {(F, M, G)} {d} differs from cuda_das.design {want}")
        return d

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b5_err = 0.0
    das_args = {}
    cases = ([(shape, True, rng) for shape in (DAS_SWEEP,) + DAS_RAGGED]
             + [(shape, False, das_rng) for shape in DAS_ANY_CSM])
    for (F, M, G), hermitian, gen in cases:
        args = das_inputs(F, M, G, hermitian, gen)
        if hermitian:
            das_args[(F, M, G)] = args
        yk = cuda_das.das_map_cuda(*args)
        yp = cuda_das.das_map_plain(*args)
        torch.cuda.synchronize()
        if tuple(yk.shape) != (G, F) or not bool(torch.isfinite(yk).all()):
            fail(f"DAS kernel shape {tuple(yk.shape)} or non-finite")
        abs_err = float((yk - yp).abs().max())
        err = rel_err(yk, yp)
        b5_err = max(b5_err, abs_err)
        d = das_design(F, M, G)
        print(f"B5 DAS map (F, M, G) = {(F, M, G)}, "
              f"{'Hermitian' if hermitian else 'non-Hermitian'} C: scale-rel err "
              f"{err:.3e} (tol 5e-5), max abs err {abs_err:.3e}; plan: mic tile "
              f"{d['R']} x {d['mic_tiles']} ({d['pairs']} pairs), {d['points']} points "
              f"and {d['warps']} warps a block ({d['P']} a thread), steering "
              f"{'resident' if d['resident'] else 'rebuilt per pair'}, "
              f"{d['smem_bytes']} B shared, {d['blocks']} blocks, "
              f"{d['blocks_per_sm']} an SM")
        if not err <= 5e-5:
            fail("DAS map kernel disagrees with its plain version")
    again = cuda_das.das_map_cuda(*das_args[DAS_SWEEP])
    if not torch.equal(again, cuda_das.das_map_cuda(*das_args[DAS_SWEEP])):
        fail("two B5 launches on the same inputs differ")
    d10 = das_design(10, 64, 900)
    warps10 = min(d10["blocks"] // sms, d10["blocks_per_sm"]) * d10["warps"]
    print(f"B5 at (10, 64, 900): {d10['blocks']} blocks on {sms} SMs, "
          f"{d10['blocks_per_sm']} resident an SM: at least {warps10} warps an SM; "
          "two launches bit-identical")
    if warps10 < 16:
        fail("B5 gives fewer than 16 warps an SM at the DAS path's 10 bins")

    # 8. the DAS path at full width (config 5 through the public API):
    # counted, against the plain paths, and against the source's position
    src_pos = camera.source_position(cam_grid)
    das_launches = {"framing": 0, "das_map": 0}
    cams = []
    for seconds, fs in CAMERA_RUNS:
        sig = camera.array_signal(seconds, fs, dev, cam_grid)
        beam = camera.beamformer(sig, cam_grid)
        torch.cuda.synchronize()
        cuda_framing.launches = 0
        cuda_das.launches = 0
        m = beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION)
        torch.cuda.synchronize()
        launched = {"framing": cuda_framing.launches, "das_map": cuda_das.launches}
        label = f"DAS path {seconds} s x {fs} Hz x 64 mics"
        print(f"{label}: launches {launched}")
        if not all(v > 0 for v in launched.values()):
            fail("the DAS path did not go through the framing and DAS kernels")
        for name, n in launched.items():
            das_launches[name] += n
        if tuple(m.shape) != (30, 30) or not bool(torch.isfinite(m).all()):
            fail(f"{label}: map shape {tuple(m.shape)} or non-finite")
        f_lo, f_hi = beam.f_range_hz
        n_bins = int(round((f_hi - f_lo) / (fs / 1024))) + 1
        with _config.kernels_off():
            sig.get_csm(force_computation=True)
            ref = beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION)
        sig.get_csm(force_computation=True)  # the kernels' CSM again
        err = rel_err(m, ref)
        peak = camera.peak_position(m, cam_grid)
        dx, dy = (abs(float(peak[i] - src_pos[i])) for i in (0, 1))
        print(f"{label}: {n_bins} bins; map vs plain paths scale-rel {err:.3e} "
              f"(tol 1e-4); peak at {peak[:2].round(3).tolist()}, source at "
              f"{src_pos[:2].round(3).tolist()} (tol 0.11 m)")
        if not err <= 1e-4:
            fail(f"{label}: map disagrees with the plain paths")
        if not (dx < 0.11 and dy < 0.11):
            fail(f"{label}: the map's peak is not at the source")
        cams.append((label, sig, beam, n_bins))

    # 9. times: B5 at the full sweep, at the DAS path's shapes and at M =
    # 160, each against its plain version; the library yardstick
    # (`packed_quadratic_from_hp`: cuBLAS fp32 bmm without TF32, the packed
    # steering built outside the timed window: the GEMM part only); and the
    # DAS path with and without the kernels, map alone (CSM cached) and
    # CSM + map
    def das_library_ms(args):
        amp, diff, k, cre, cim = args
        ph = k[:, None, None] * diff.T[None]
        hp = torch.cat([amp.T[None] * torch.cos(ph), -amp.T[None] * torch.sin(ph)], dim=-1)
        return time_pair(lambda: cuda_das.das_map_cuda(*args),
                         lambda: cuda_das.packed_quadratic_from_hp(hp, cre, cim))[1]

    F, M, G = DAS_SWEEP
    args = das_args[DAS_SWEEP]
    b5_ms, b5_plain = time_pair(
        lambda: cuda_das.das_map_cuda(*args), lambda: cuda_das.das_map_plain(*args)
    )
    b5_lib = das_library_ms(args)
    print(f"time B5 DAS map (F, M, G) = {DAS_SWEEP}: kernel {b5_ms:.4f} ms "
          f"({G * F / (b5_ms * 1e-3):.4g} point-bins/s), plain {b5_plain:.4f} ms "
          f"({G * F / (b5_plain * 1e-3):.4g} point-bins/s), library (GEMM part only, "
          f"steering pre-built) {b5_lib:.4f} ms")
    # B5 at the shapes the DAS path launches: each recording's (n_bins, 64,
    # 900); and at M = 160
    b5_paths = []
    for label, _, _, n_bins in cams:
        pargs = das_inputs(n_bins, M, G)
        k_ms, p_ms = time_pair(lambda: cuda_das.das_map_cuda(*pargs),
                               lambda: cuda_das.das_map_plain(*pargs))
        lib_ms = das_library_ms(pargs)
        p_bound, p_by = das_bound(n_bins, M, G)
        print(f"time B5 DAS map at the shape of {label}, (F, M, G) = {(n_bins, M, G)}: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library (GEMM part only, "
              f"steering pre-built) {lib_ms:.4f} ms, bound {p_bound:.4f} ms "
              f"({p_by}, {k_ms / p_bound:.2f}×)")
        b5_paths.append({"shape": [n_bins, M, G], "ms": k_ms, "plain_ms": p_ms,
                         "library_ms": lib_ms, "bound_ms": p_bound, "bound_by": p_by})
    b5_m160 = []
    for shape in DAS_M160:
        margs = das_inputs(*shape, hermitian=False, gen=das_rng)
        k_ms, p_ms = time_pair(lambda: cuda_das.das_map_cuda(*margs),
                               lambda: cuda_das.das_map_plain(*margs))
        m_bound, m_by = das_bound(*shape)
        print(f"time B5 DAS map at M = 160, (F, M, G) = {shape}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {m_bound:.4f} ms ({m_by})")
        b5_m160.append({"shape": list(shape), "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": m_bound, "bound_by": m_by})

    for label, sig, beam, n_bins in cams:
        def one_map():
            return beam.get_beamformer_map(camera.CENTER_HZ, camera.OCTAVE_FRACTION)

        def csm_and_map():
            sig.get_csm(force_computation=True)
            return one_map()

        for what, fn in (("map, CSM cached", one_map), ("CSM + map", csm_and_map)):
            k_ms, p_ms = time_pair(fn, lambda: plain(fn))
            print(f"time {label}, {what}: kernels {k_ms:.4f} ms "
                  f"({G * n_bins / (k_ms * 1e-3):.4g} point-bins/s), plain paths "
                  f"{p_ms:.4f} ms ({G * n_bins / (p_ms * 1e-3):.4g} point-bins/s)")

    # 9b. config 5: every map of the acoustic camera (B1, B5), DAS-time
    c5 = config5_phase(dev, card)

    # 10-14. the transfer-function measurement path and B4
    b4, measured = measurement_phase(dev, rng)
    windowed_irs = measured[1]
    # 27-29. the transfer-function analysis path on the measured IRs (B1)
    tfa = tf_analysis_phase(dev, measured, card)
    del measured

    # 15-19. the filter-bank path (config 3) and B3
    b3 = filterbank_phase(dev, rng)
    b3_chain = chain_launches["banked"]["iir_bank"]
    b3["launches_by_path"] = {"chain_banked": b3_chain, "config3": b3["launches"]}
    b3["launches"] += b3_chain

    # 20-23. room acoustics: the measured room's RT and descriptors (B3 for
    # the octave bank, B2 for the bass ratio), config 4, the ISM fleet
    room = room_phase(dev, windowed_irs, card)
    b3["launches_by_path"]["room"] = room["iir_bank"]
    b3["launches"] += room["iir_bank"]

    # 24-25. config 2 at 1 x 4 s and 16 x 60 s (B1), and the standard
    # functions on the 60 s recording (B2)
    c2 = config2_phase(dev, card)
    minute = c2.pop("minute")
    std = standard_phase(dev, minute, card)

    # 30-38. the transforms path on the 60 s session (B1, B3, B2), music,
    # LPC at 16 kHz and the measured room's windows
    feat = features_phase(dev, minute, windowed_irs, card)
    del minute
    torch.cuda.empty_cache()
    b3["launches_by_path"]["transforms"] = feat["iir_bank"]
    b3["launches"] += feat["iir_bank"]
    b3["max_abs_err_by_path"] = {"config3": b3["max_abs_err"], "transforms": feat["iir_bank_err"]}
    b3["max_abs_err"] = max(b3["max_abs_err"], feat["iir_bank_err"])
    b3["transforms_times"] = feat["times"]
    b3["transforms_bank"] = feat["iir_bank_time"]

    # 39-45. config 2's session through the file layer: WAV/FLAC, the
    # calibration, the stateful (b, a) streamed (B2), zero phase (B2), the
    # smoothing (B2, the EMA kernel), save/load, the C8 calls
    sess = session_files_phase(dev, card)
    torch.cuda.empty_cache()

    # 46-52. the filter-design and streaming path on the session: the
    # parallel, Kautz and warped FIR filters, the A-weighting and EQ and the
    # IIRFilter stream (B2), the EMA stream (ema.cu's average form), the SVF,
    # the partitioned FIR, the reconstructing bank, QMF, the host loops
    rt = realtime_phase(dev, card)
    torch.cuda.empty_cache()

    # 53-58. the denoise -> compress -> evaluate path on the session: the
    # subtractors (B1), the compressor (ema.cu's average form), the rack,
    # the scores (B1, fwSNRseg's gammatone bank on B3), the EQ fit (B2)
    fxp = effects_phase(dev, card)
    torch.cuda.empty_cache()

    # 26. the chains through `pipeline`, each captured into one CUDA graph:
    # config 2 (B1), the TF path (B4), config 3 (B3), the crossover bands (B2)
    pl = pipeline_phase(dev, card)
    pl_launches = pl["launches"]
    b4["launches_by_path"] = {"tf": b4["launches"], "pipeline": pl_launches["banded"]}
    b4["launches"] += pl_launches["banded"]
    b3["launches_by_path"]["pipeline"] = pl_launches["iir_bank"]
    b3["launches"] += pl_launches["iir_bank"]
    b3["launches_by_path"]["effects"] = fxp["iir_bank"]
    b3["launches"] += fxp["iir_bank"]
    b3["max_abs_err_by_path"]["effects"] = fxp["iir_bank_err"]
    b3["max_abs_err"] = max(b3["max_abs_err"], fxp["iir_bank_err"])

    # 59-65. the parallel layer and every mesh= keyword on 4 shards of the
    # card: the session's CSM, Welch, STFT, FIR and energy (B1), the
    # 1/3-octave bank (B3), config 5's map and the DAS sweep (B5), config
    # 4's fleet, config 2 (a) through pipeline(mesh=); float64 mode's Filter
    # and the lazy getters
    msh = mesh_phase(dev, card)
    torch.cuda.empty_cache()
    b3["launches_by_path"]["mesh"] = msh["launches"]["iir_bank"]
    b3["launches"] += msh["launches"]["iir_bank"]
    b3["max_abs_err_by_path"]["mesh"] = msh["iir_bank_err"]
    b3["max_abs_err"] = max(b3["max_abs_err"], msh["iir_bank_err"])
    b3["mesh_times"] = {k: v for k, v in msh["times"].items() if k.startswith("bank")}

    # bounds at the timed shapes. B1 at the chain's STFT (step 6). B2, per
    # band: x·H in fp32, H lower-triangular
    # Toeplitz, so L·(L+1)/2 FMAs per block (for FFMA or 3×TF32 on the
    # tensor cores, whichever is faster); the state path in fp64 (the
    # serial chain, and x·M and s·G as products for the fp64 tensor cores);
    # x read, y written. B5 at the sweep: `das_bound`
    b1_bound, b1_by = b1_shapes[0]["bound_ms"], b1_shapes[0]["bound_by"]
    b2_bytes = b2_f32 = b2_f64 = b2_f64_mm = 0.0
    for args in lead_args:
        Bb, Kb, Lb = args[4].shape
        Nb = args[2].shape[0]
        b2_bytes += 4 * 2 * Bb * Kb * Lb + 8 * Bb * Nb
        b2_f32 += 2.0 * Bb * Kb * Lb * (Lb + 1) / 2
        b2_f64 += 2.0 * Bb * Kb * Nb * Nb
        b2_f64_mm += 2.0 * Bb * Kb * 2 * Lb * Nb
    b2_bound, b2_by = bound(b2_bytes, 0.0, b2_f64, b2_f64_mm, b2_f32)
    b5_bound, b5_by = das_bound(F, M, G)
    print(f"bounds (H100 SXM peaks): B1 {b1_bound:.4f} ms ({b1_by}), B2 four "
          f"bands {b2_bound:.4f} ms ({b2_by}), B5 {b5_bound:.4f} ms ({b5_by}), "
          f"B4 {b4['bound_ms']:.4f} ms ({b4['bound_by']}), B3 three banks "
          f"{b3['bound_ms']:.4f} ms ({b3['bound_by']})")

    report = {"kernels": [
        {"name": "windowed_frames", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/framing.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_framing.py:45",
         "launches": (launches["framing"] + das_launches["framing"] + c5["framing"]
                      + c2["framing"] + pl_launches["framing"] + tfa["framing"]
                      + feat["framing"] + fxp["framing"] + msh["launches"]["framing"]),
         "launches_by_path": {"chain": launches["framing"], "das": das_launches["framing"],
                              "config5": c5["framing"], "config2": c2["framing"],
                              "pipeline": pl_launches["framing"],
                              "tf_analysis": tfa["framing"], "transforms": feat["framing"],
                              "effects": fxp["framing"], "mesh": msh["launches"]["framing"]},
         "max_abs_err": max(b1_err, c2["framing_err"], tfa["framing_err"],
                            feat["framing_err"], fxp["framing_err"], msh["framing_err"]),
         "max_abs_err_by_path": {"chain_das": b1_err, "config2": c2["framing_err"],
                                 "tf_analysis": tfa["framing_err"],
                                 "transforms": feat["framing_err"],
                                 "effects": fxp["framing_err"], "mesh": msh["framing_err"]},
         "ms": b1_ms, "plain_ms": b1_plain,
         "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "by_path_shape": b1_shapes, "config2_times": c2["times"],
         "tf_analysis_times": tfa["times"],
         "mesh_times": {k: v for k, v in msh["times"].items()
                        if k in ("csm", "welch", "stft", "welch_time")}},
        {"name": "csm_gram", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/csm.cu",
         "replaces": "dsptoolbox_tpu/ops/spectral.py:285 (jnp.einsum, no Pallas kernel)",
         "launches": gram["launches"] + c2["csm"] + pl_launches["csm"],
         "launches_by_path": {"gram": gram["launches"], "config2": c2["csm"],
                              "pipeline": pl_launches["csm"]},
         "max_abs_err": gram["max_abs_err"], "ms": gram["by_shape"][0]["ms"],
         "plain_ms": gram["by_shape"][0]["plain_ms"],
         "bound_ms": gram["by_shape"][0]["bound_ms"],
         "bound_by": gram["by_shape"][0]["bound_by"],
         "library_ms": gram["by_shape"][0]["library_ms"],
         "library": "permute + torch.matmul (cuBLAS complex fp32)",
         "by_shape": gram["by_shape"]},
        {"name": "sosfilt_lead", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/iir_bank.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_iir.py:154",
         "launches": (launches["iir_lead"] + room["iir_lead"] + std["iir_lead"]
                      + pl_launches["iir_lead"] + tfa["iir_lead"] + feat["iir_lead"]
                      + sess["iir_lead"] + rt["iir_lead"] + fxp["iir_lead"]),
         "launches_by_path": {"chain": launches["iir_lead"], "room": room["iir_lead"],
                              "standard": std["iir_lead"], "pipeline": pl_launches["iir_lead"],
                              "tf_analysis": tfa["iir_lead"], "transforms": feat["iir_lead"],
                              "session_files": sess["iir_lead"], "realtime": rt["iir_lead"],
                              "effects": fxp["iir_lead"]},
         "max_abs_err": max(b2_err, room["iir_lead_err"], std["iir_lead_err"],
                            feat["iir_lead_err"], sess["iir_lead_err"], rt["iir_lead_err"],
                            fxp["iir_lead_err"]),
         "max_abs_err_by_path": {"chain": b2_err, "room": room["iir_lead_err"],
                                 "standard": std["iir_lead_err"],
                                 "transforms": feat["iir_lead_err"],
                                 "session_files": sess["iir_lead_err"],
                                 "realtime": rt["iir_lead_err"],
                                 "effects": fxp["iir_lead_err"]},
         "session_files_times": sess["times"], "realtime_times": rt["times"],
         "effects_times": fxp["times"],
         "transforms_device_kernels": feat.get("device_kernels"),
         "ms": b2_ms, "plain_ms": b2_plain,
         "bound_ms": b2_bound, "bound_by": b2_by, "library_ms": None},
        b3,
        {"name": "das_map", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/das_map.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_das.py:104",
         "launches": das_launches["das_map"] + c5["das_map"] + msh["launches"]["das_map"],
         "launches_by_path": {"das": das_launches["das_map"], "config5": c5["das_map"],
                              "mesh": msh["launches"]["das_map"]},
         "max_abs_err": max(b5_err, c5["das_map_err"], msh["das_map_err"]),
         "max_abs_err_by_path": {"das": b5_err, "config5": c5["das_map_err"],
                                 "mesh": msh["das_map_err"]},
         "ms": b5_ms, "plain_ms": b5_plain,
         "bound_ms": b5_bound, "bound_by": b5_by, "library_ms": b5_lib,
         "library": "packed_quadratic_from_hp: GEMM part only, steering pre-built",
         "by_path_shape": b5_paths, "at_m160": b5_m160, "config5_times": c5["times"],
         "mesh_times": {k: v for k, v in msh["times"].items() if k.startswith("das")}},
        b4,
        {"name": "ema_smoothing", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/ema.cu",
         "replaces": "dsptoolbox_tpu/helpers/smoothing.py:164 (lax.scan, no Pallas kernel)",
         "launches": sess["ema"], "launches_by_path": {"session_files": sess["ema"]},
         "max_abs_err": sess["ema_err"], "ms": sess["ema_ms"],
         "plain_ms": sess["ema_plain_ms"], "plain_shape": sess["ema_plain_shape"],
         "ms_at_plain_shape": sess["ema_at_plain_shape_ms"],
         "bound_ms": sess["ema_bound_ms"], "bound_by": sess["ema_bound_by"],
         "library_ms": None},
        {"name": "ema_average_carry", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/ema.cu",
         "replaces": "dsptoolbox_tpu/realtime/misc.py:71 (lax.scan, no Pallas kernel)",
         "launches": rt["ema_carry"] + fxp["ema_carry"],
         "launches_by_path": {"realtime": rt["ema_carry"], "effects": fxp["ema_carry"]},
         "max_abs_err": max(rt["ema_carry_err"], fxp["ema_carry_err"]),
         "max_abs_err_by_path": {"realtime": rt["ema_carry_err"],
                                 "effects": fxp["ema_carry_err"]},
         "shape": rt["ema_carry_shape"],
         "ms": rt["ema_carry_ms"], "plain_ms": rt["ema_carry_plain_ms"],
         "bound_ms": rt["ema_carry_bound_ms"], "bound_by": rt["ema_carry_bound_by"],
         "library_ms": None, "long_row": rt["ema_carry_long_row"],
         "effects_compressor": {"shape": fxp["ema_carry_shape"], "ms": fxp["ema_carry_ms"]},
         "effects_times": fxp["times"], "effects_peak_gb": fxp["peak_gb"]},
    ]}
    # each kernel's captured chains: eager and replay ms, idle shares, pool
    by_kernel = {"windowed_frames": "framing", "sosfilt_lead": "iir_lead",
                 "sosfilt_bank": "iir_bank", "banded_matmul": "banded"}
    for entry in report["kernels"]:
        k = by_kernel.get(entry["name"])
        if k is not None:
            entry["pipeline_times"] = [t for t in pl["times"] if t["captured"][k] > 0]
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

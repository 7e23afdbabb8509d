"""Smoke run of the PyTorch/CUDA port (`dsptoolbox_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``dsptoolbox_tpu_torch/csrc`` (one
``nvcc`` per source, started together) and drives the port's paths:

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
- the transfer-function measurement (`dsptoolbox_tpu_torch.tools.measurement`:
  a 5 s SyncLog sweep recorded by 16 microphones at 48 kHz, deconvolved,
  windowed to 65,536 samples and 1/3-octave smoothed over 32,769 bins): the
  banded smoothing kernel (B4) is held against its plain version at the
  path's plan and ragged shapes, the path against the plain paths, a
  float64 numpy deconvolution, the float64 host smoothing and the known
  propagation delays; 1/6 octave and the MagnitudePhase and
  EquivalentComplex domains against the float64 host smoothing too;
- the filter-bank path (`dsptoolbox_tpu_torch.tools.filterbank_chain`,
  config 3: 64 channels × 10 s at 44.1 kHz through an LR crossover, the
  16-band gammatone bank, resampling to fs/3 and the 28-band 1/3-octave
  bank): the filter-bank kernel (B3) is held against its plain version at
  both banks' shapes and ragged shapes (each case prints which output pass
  it took: the tensor cores for blocks up to 128), every band against
  scipy's float64 sosfilt on 4 channels, the path and a gammatone
  reconstruction against the plain paths;
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
  float64 recursion printed), each timed with its device idle share.

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
KERNELS = ("framing", "das_map", "banded", "iir_bank")
# the DAS path: (seconds, sampling rate) of the two recordings
CAMERA_RUNS = ((0.5, 16000), (10, 48000))
# B5 at the full sweep (F, M, G) and two ragged shapes (Hermitian C), and
# on a non-Hermitian C at the DAS path's 10 and 30 bins, M = 1 and M = 160
DAS_SWEEP = (513, 64, 900)
DAS_RAGGED = ((13, 9, 20), (5, 25, 130))
DAS_ANY_CSM = ((10, 64, 900), (30, 64, 900), (2, 1, 5), (3, 160, 70), (30, 160, 900))
# B5 timed against its plain version at M = 160
DAS_M160 = ((3, 160, 70), (30, 160, 900))
# the DAS path's 10 s x 48 kHz recording: (mics, samples) of its Welch CSM
CSM_SHAPE = (64, 480000)
# B4 ragged shapes: (NB, TR, SPAN, C, F)
BANDED_RAGGED = ((3, 128, 256, 5, 1000), (2, 50, 250, 33, 700))
# H100 SXM peaks (NVIDIA data sheet): device memory, fp32 and fp64 outside
# the tensor cores, fp64 and TF32 on the tensor cores (dense matrix products)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 34e12
FP64_TC_FLOP_S = 67e12
TF32_FLOP_S = 495e12


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
    B4's entry of the kernels report and the path's windowed IRs."""
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
    sp = win.get_spectrum()[1]
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
            "bound_by": b4_by, "library_ms": lib_ms}, win


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

    # 16. B3 vs plain at the path's two banks (64 x 441,000) and ragged
    # shapes. Tolerance: B2's (fp32 Toeplitz sums in two orders, fp64 state)
    banks = {"gammatone": _sos_bank_or_none(gt.filters),
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
        s_k = cuda_iir_bank.sosfilt_bank_lead_cuda(ops, xin, out_k)
        s_p = cuda_iir_bank.sosfilt_bank_lead_plain(ops, xin, out_p)
        torch.cuda.synchronize()
        y_err = float((out_k[..., :lead] - out_p[..., :lead]).abs().max())
        y_scale = float(out_p[..., :lead].abs().max())
        z_err = float((s_k - s_p).abs().max())
        z_scale = max(1.0, float(s_p.abs().max()))
        print(f"B3 bank {label} (P, B, R, T) = {tuple(out_k.shape)}, "
              f"{ops['kernel']['lanes']} lanes, L = {ops['L']}, output pass "
              f"{cuda_iir_bank.output_pass(ops['L'])}: |dy| {y_err:.3e} <= 1e-5*{y_scale:.3e}; "
              f"|dzf| {z_err:.3e} <= 1e-6*{z_scale:.3e}")
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
    out = fc.run(sig, lr, gt, third)
    torch.cuda.synchronize()
    launched = {name: m.launches for name, m in modules.items()}
    label = f"config-3 path {C} ch x {T} samples"
    print(f"{label}: launches {launched}")
    if launched["iir_bank"] < 2:
        fail("the filter-bank path did not run the bank kernel for both banks")
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
    for name, mb, bank in (("gammatone", gt_b, banks["gammatone"]),
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

    # 19. times: B3 and its plain version at the path's two banks; the
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
    print(f"bound B3 two banks: x·h as 3×TF32 {b3_bound:.4f} ms ({b3_by}, "
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
            "launches": launched["iir_bank"], "max_abs_err": b3_err,
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
    for mode in rm.RT_MODES:
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
    n_fits = nb * C * len(rm.RT_MODES)
    print(f"time {label} [{card}]: octave bank (B3) {bank_ms:.4f} ms, plain "
          f"{bank_plain:.4f} ms; RT fits, {n_fits} ({nb} bands x {C} channels x "
          f"{len(rm.RT_MODES)} modes) {fits_ms:.1f} ms ({fits_ms / n_fits:.3f} ms a fit); "
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


def counted_modules() -> dict:
    from dsptoolbox_tpu_torch.ops import (
        cuda_banded,
        cuda_das,
        cuda_framing,
        cuda_iir,
        cuda_iir_bank,
    )

    return {"framing": cuda_framing, "iir_lead": cuda_iir, "das_map": cuda_das,
            "banded": cuda_banded, "iir_bank": cuda_iir_bank}


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


def config2_phase(dev, card: str) -> dict:
    """Config 2 (`tools/speech_chain.py`: STFT → ISTFT, Welch spectrum,
    append, Welch CSM) at (a) the JAX package's size, 1 channel × 4 s, and
    (b) full width, 16 channels × 60 s at 48 kHz: counted (B1), against the
    plain paths (2e-5 scale-relative) and a float64 numpy run (1e-4); the
    ISTFT round trip within 1e-5 of the input; the FFT-method CSM too
    (at (b) on 2 channels and their reconstructions: all 32 would be 12 GB).
    Timed with CUDA events against the plain paths. Returns B1's launches,
    its error against its plain version at the path's shapes, and the
    60 s recording for the standard phase."""
    import numpy as np
    import torch

    from dsptoolbox_tpu_torch.ops import cuda_framing
    from dsptoolbox_tpu_torch.ops.fft_conv import next_fast_len
    from dsptoolbox_tpu_torch.ops.windows import get_window
    from dsptoolbox_tpu_torch.standard import append_signals
    from dsptoolbox_tpu_torch.standard.enums import SpectrumMethod, Window
    from dsptoolbox_tpu_torch.tools import speech_chain as sc

    launches, b1_err, times = 0, 0.0, []
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
        launches += launched["framing"]
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
        fft_csm = two.get_csm()[1]
        err_p = rel_err(fft_csm, plain(lambda: two.get_csm(force_computation=True)[1]))
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
    return {"framing": launches, "framing_err": b1_err, "times": times, "minute": minute}


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

    # 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_cuda.load, KERNELS))
    print(f"build {', '.join(KERNELS)}: {time.perf_counter() - t0:.2f} s")
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

    # 10-14. the transfer-function measurement path and B4
    b4, windowed_irs = measurement_phase(dev, rng)

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
    std = standard_phase(dev, c2.pop("minute"), card)

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
          f"B4 {b4['bound_ms']:.4f} ms ({b4['bound_by']}), B3 two banks "
          f"{b3['bound_ms']:.4f} ms ({b3['bound_by']})")

    report = {"kernels": [
        {"name": "windowed_frames", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/framing.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_framing.py:45",
         "launches": launches["framing"] + das_launches["framing"] + c2["framing"],
         "launches_by_path": {"chain": launches["framing"],
                              "das": das_launches["framing"], "config2": c2["framing"]},
         "max_abs_err": max(b1_err, c2["framing_err"]),
         "max_abs_err_by_path": {"chain_das": b1_err, "config2": c2["framing_err"]},
         "ms": b1_ms, "plain_ms": b1_plain,
         "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "by_path_shape": b1_shapes, "config2_times": c2["times"]},
        {"name": "sosfilt_lead", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/iir_bank.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_iir.py:154",
         "launches": launches["iir_lead"] + room["iir_lead"] + std["iir_lead"],
         "launches_by_path": {"chain": launches["iir_lead"], "room": room["iir_lead"],
                              "standard": std["iir_lead"]},
         "max_abs_err": max(b2_err, room["iir_lead_err"], std["iir_lead_err"]),
         "max_abs_err_by_path": {"chain": b2_err, "room": room["iir_lead_err"],
                                 "standard": std["iir_lead_err"]},
         "ms": b2_ms, "plain_ms": b2_plain,
         "bound_ms": b2_bound, "bound_by": b2_by, "library_ms": None},
        b3,
        {"name": "das_map", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/das_map.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_das.py:104",
         "launches": das_launches["das_map"], "max_abs_err": b5_err,
         "ms": b5_ms, "plain_ms": b5_plain,
         "bound_ms": b5_bound, "bound_by": b5_by, "library_ms": b5_lib,
         "library": "packed_quadratic_from_hp: GEMM part only, steering pre-built",
         "by_path_shape": b5_paths, "at_m160": b5_m160},
        b4,
    ]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
  reconstruction against the plain paths.

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


def time_pair(fa, fb, n=N_TIMED, warm=3):
    """Median CUDA-event milliseconds of ``fa`` and ``fb``, run in turns
    (a b, b a, ...) after ``warm`` warm-up calls of each."""
    import torch

    for _ in range(warm):
        fa()
        fb()
    torch.cuda.synchronize()
    times = {0: [], 1: []}
    fns = (fa, fb)
    for i in range(n):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def measurement_phase(dev, rng) -> dict:
    """B4 and the transfer-function measurement path at full width; returns
    B4's entry of the kernels report."""
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
            "bound_by": b4_by, "library_ms": lib_ms}


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
    b4 = measurement_phase(dev, rng)

    # 15-19. the filter-bank path (config 3) and B3
    b3 = filterbank_phase(dev, rng)
    b3_chain = chain_launches["banked"]["iir_bank"]
    b3["launches_by_path"] = {"chain_banked": b3_chain, "config3": b3["launches"]}
    b3["launches"] += b3_chain

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
         "launches": launches["framing"] + das_launches["framing"],
         "launches_by_path": {"chain": launches["framing"],
                              "das": das_launches["framing"]},
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain,
         "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "by_path_shape": b1_shapes},
        {"name": "sosfilt_lead", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/iir_bank.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_iir.py:154",
         "launches": launches["iir_lead"], "max_abs_err": b2_err,
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

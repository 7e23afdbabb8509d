"""Smoke run of the PyTorch/CUDA port (`dsptoolbox_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``dsptoolbox_tpu_torch/csrc``, holds
each against its plain PyTorch version at the measurement chain's shapes,
drives the chain (`dsptoolbox_tpu_torch.headline.run`: 16 signals × 8 s at
48 kHz, STFT + 4-band crossover + deconvolution) through the kernels, checks
it against the same chain on the plain paths and against scipy/numpy in
float64, and times kernels and chain with CUDA events.

Prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is non-zero; without a CUDA device it exits with
code 2 before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FS = 48000
BATCH = 16
SECONDS = 8
T = FS * SECONDS
WINDOW = 1024
STEP = 512
L_IIR = 128
N_TIMED = 20


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def rel_err(got, want) -> float:
    import torch

    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
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
    from dsptoolbox_tpu_torch.ops import cuda_framing, cuda_iir
    from dsptoolbox_tpu_torch.ops.framing import compute_number_frames
    from dsptoolbox_tpu_torch.ops.iir_block import (
        _block_operators,
        operators_to_torch,
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

    # 2. build
    for name in ("framing", "iir_lead"):
        t0 = time.perf_counter()
        _cuda.load(name)
        log = _cuda.BUILD_LOG.get(name, {}).get("log", "")
        print(f"build {name}.cu: {time.perf_counter() - t0:.2f} s")
        for line in log.splitlines():
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

    # 4. B2 IIR lead kernel vs plain, per crossover band, nonzero zi
    xb = x.reshape(BATCH, T // L_IIR, L_IIR)
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
        print(f"B2 lead band {i}: |dy| {y_err:.3e} <= 1e-5*{y_scale:.3e}; "
              f"|dzf| {z_err:.3e} <= 1e-6*{z_scale:.3e}; "
              f"scipy f64 channel 0 scale-rel {sc_err:.3e} (tol 5e-6)")
        if not (y_err <= 1e-5 * y_scale and z_err <= 1e-6 * z_scale):
            fail(f"IIR lead kernel disagrees with its plain version (band {i})")
        if not sc_err <= 5e-6:
            fail(f"IIR lead kernel disagrees with scipy (band {i})")

    # 5. the slice: the chain through the kernels, counted
    exc = torch.fft.rfft(
        torch.from_numpy(rng.standard_normal(T).astype(np.float32)).to(dev)
    )
    cuda_framing.launches = 0
    cuda_iir.launches = 0
    out = {bank: headline.run(x, exc, bank=bank) for bank in ("per_band", "banked")}
    torch.cuda.synchronize()
    launches = {"framing": cuda_framing.launches, "iir_lead": cuda_iir.launches}
    print(f"launches in the chain: {launches}")
    if not all(v > 0 for v in launches.values()):
        fail("the chain did not go through every kernel")

    _config.set_framing_kernel("off")
    _config.set_iir_kernel("off")
    try:
        ref = {bank: headline.run(x, exc, bank=bank) for bank in out}
    finally:
        _config.set_framing_kernel("auto")
        _config.set_iir_kernel("auto")
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

    # 6. times: kernel vs plain in turns, CUDA events, median of 20
    b1_ms, b1_plain = time_pair(
        lambda: cuda_framing.windowed_frames_cuda(x, win, STEP, False, pad),
        lambda: cuda_framing.windowed_frames_plain(x, win, STEP, False, pad),
    )
    print(f"time B1 framing ({BATCH}, {T}) pad={pad} L={WINDOW} step={STEP}: "
          f"kernel {b1_ms:.4f} ms, plain {b1_plain:.4f} ms")
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

    def plain_chain(bank):
        _config.set_framing_kernel("off")
        _config.set_iir_kernel("off")
        try:
            return headline.run(x, exc, bank=bank)
        finally:
            _config.set_framing_kernel("auto")
            _config.set_iir_kernel("auto")

    audio_s = BATCH * SECONDS
    for bank in ("per_band", "banked"):
        k_ms, p_ms = time_pair(
            lambda: headline.run(x, exc, bank=bank), lambda: plain_chain(bank)
        )
        print(f"time chain {bank}: kernels {k_ms:.4f} ms "
              f"({audio_s / (k_ms * 1e-3):.1f} audio-s/s), plain paths "
              f"{p_ms:.4f} ms ({audio_s / (p_ms * 1e-3):.1f} audio-s/s)")

    report = {"kernels": [
        {"name": "windowed_frames", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/framing.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_framing.py:45",
         "launches": launches["framing"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain},
        {"name": "sosfilt_lead", "route": "cuda",
         "source": "dsptoolbox_tpu_torch/csrc/iir_lead.cu",
         "replaces": "dsptoolbox_tpu/ops/pallas_iir.py:154",
         "launches": launches["iir_lead"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain},
    ]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

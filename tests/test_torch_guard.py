"""Guards on the port package: no JAX at run time, no reduced-precision
switches, and no kernel launch for CPU tensors."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dsptoolbox_tpu_torch as dtt
from dsptoolbox_tpu_torch import _config, headline
from dsptoolbox_tpu_torch.classes import ImpulseResponse, Signal, Spectrum
from dsptoolbox_tpu_torch.ops import banded, cuda_banded, cuda_das, cuda_framing, cuda_iir
from dsptoolbox_tpu_torch.tools import camera
from dsptoolbox_tpu_torch.transfer_functions import SmoothingDomain, complex_smoothing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dsptoolbox_tpu_torch"


def test_import_leaves_jax_out_and_needs_no_triton():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None  # importing triton now raises\n"
        "import dsptoolbox_tpu_torch, dsptoolbox_tpu_torch.headline\n"
        "import dsptoolbox_tpu_torch.ops.spectral, dsptoolbox_tpu_torch.ops.iir\n"
        "import dsptoolbox_tpu_torch.beamforming, dsptoolbox_tpu_torch.classes\n"
        "import dsptoolbox_tpu_torch.tools.camera, dsptoolbox_tpu_torch.tools.measurement\n"
        "import dsptoolbox_tpu_torch.transfer_functions, dsptoolbox_tpu_torch.generators\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('dsptoolbox_tpu.') or m == 'dsptoolbox_tpu']\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_imports_in_port_sources():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "dsptoolbox_tpu"), f"{path}: {n}"


@pytest.mark.parametrize(
    "needle",
    ["allow_tf32 = True", "allow_tf32=True", "set_float32_matmul_precision",
     "autocast", "bfloat16", "float16", "half()"],
)
def test_port_never_lowers_precision(needle):
    for path in _port_sources():
        assert needle not in path.read_text(), f"{path} contains {needle!r}"
    for path in sorted((PKG / "csrc").glob("*.cu")):
        text = path.read_text()
        for bad in ("__half", "bfloat16", "wmma"):
            assert bad not in text, f"{path} contains {bad!r}"
        # tensor-core products only in fp64, or in TF32 as the three
        # products of a hi/lo split (fp32 accuracy), never a single one
        mma = re.findall(r"mma\.sync\.aligned\.\w+\.row\.col\.([\w.]+)", text)
        assert all(t in ("f64.f64.f64.f64", "f32.tf32.tf32.f32") for t in mma), (path, mma)
        if "f32.tf32.tf32.f32" in mma:
            assert mma.count("f32.tf32.tf32.f32") == 1, path  # one helper, mma_tf32
            assert "cvt.rna.tf32.f32" in text, path
            calls = re.findall(r"mma_tf32\(acc\[nt\], (a\w+), hb\[nt - lt\]\[0\]\[(\d)\]", text)
            assert calls == [("alo", "0"), ("ahi", "1"), ("ahi", "0")], (path, calls)


def test_cpu_tensors_never_launch_kernels():
    cuda_framing.launches = 0
    cuda_iir.launches = 0
    rng = np.random.default_rng(0)
    T = 4096  # 32 full IIR blocks: the kernel's regime on a CUDA tensor
    x = torch.from_numpy(rng.standard_normal((2, T)).astype(np.float32))
    exc = torch.fft.rfft(torch.from_numpy(rng.standard_normal(T).astype(np.float32)))
    for bank in ("per_band", "banked"):
        headline.run(x, exc, bank=bank)
    cuda_das.launches = 0
    g = camera.grid()
    sig = camera.array_signal(0.05, 16000, "cpu", g)
    assert camera.beamformer(sig, g).get_beamformer_map(2000, 3).shape == (30, 30)
    cuda_banded.launches = 0
    ir = ImpulseResponse(None, torch.from_numpy(rng.standard_normal((8192, 2)) * 0.1), 48000)
    assert complex_smoothing(ir, 3, SmoothingDomain.RealImaginary).spectral_data.shape == (4097, 2)
    assert cuda_framing.launches == 0
    assert cuda_iir.launches == 0
    assert cuda_das.launches == 0
    assert cuda_banded.launches == 0


def test_switch_on_refuses_cpu_tensor():
    x = torch.zeros(2, 4096)
    win = torch.ones(64)
    _config.set_framing_kernel("on")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            cuda_framing.windowed_frames(x, win, 32, False)
    finally:
        _config.set_framing_kernel("auto")
    seg = {"rows": 128, "span": 128, "offsets": torch.zeros(1, dtype=torch.int32),
           "slab": torch.ones(1, 128, 128)}
    _config.set_banded_kernel("on")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            banded.banded_apply([seg], torch.ones(256, 2))
        with pytest.raises(ValueError, match="float32"):
            banded.banded_apply([dict(seg, slab=seg["slab"].double())],
                                torch.ones(256, 2, dtype=torch.float64))
    finally:
        _config.set_banded_kernel("auto")
    with pytest.raises(ValueError):
        dtt.set_iir_kernel("fast")


def test_kernels_off_restores_every_switch():
    _config.set_iir_kernel("on")
    try:
        with _config.kernels_off():
            assert (_config.framing_kernel(), _config.iir_kernel(),
                    _config.das_kernel(), _config.banded_kernel()) == ("off",) * 4
        assert (_config.framing_kernel(), _config.iir_kernel(),
                _config.das_kernel(), _config.banded_kernel()) == (
                    "auto", "on", "auto", "auto")
    finally:
        _config.set_iir_kernel("auto")


def test_default_dtypes_and_float64_mode():
    assert dtt.default_float() == torch.float32
    assert dtt.default_complex() == torch.complex64
    dtt.set_default_float("float64")
    try:
        assert dtt.default_float() == torch.float64
        assert dtt.default_complex() == torch.complex128
    finally:
        dtt.set_default_float("float32")
    with pytest.raises(ValueError):
        dtt.set_default_float("bfloat16")


def test_default_device_is_cuda_and_numpy_follows_it():
    assert dtt.default_device() == "cuda"
    x = np.zeros((64, 2), np.float32)
    x[3] = 0.5
    dtt.set_default_device("cpu")
    try:
        assert Signal(None, x, 48000).device.type == "cpu"
        assert ImpulseResponse(None, x, 48000).device.type == "cpu"
        assert Spectrum(np.arange(64.0), x).device.type == "cpu"
    finally:
        dtt.set_default_device("cuda")
    assert dtt.default_device() == "cuda"
    # an explicit device ignores the default, and a tensor keeps its own
    assert Signal(None, x, 48000, device="cpu").device.type == "cpu"
    assert ImpulseResponse(None, x, 48000, device="cpu").device.type == "cpu"
    assert Spectrum(np.arange(64.0), x, device="cpu").device.type == "cpu"
    assert Signal(None, torch.from_numpy(x), 48000).device.type == "cpu"
    if not torch.cuda.is_available():
        # no fallback to the CPU: numpy data without a device goes to "cuda"
        with pytest.raises((AssertionError, RuntimeError)):
            Signal(None, x, 48000)

"""Guards on the port package: no JAX at run time, no reduced-precision
switches, and no kernel launch for CPU tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dsptoolbox_tpu_torch as dtt
from dsptoolbox_tpu_torch import _config, headline
from dsptoolbox_tpu_torch.ops import cuda_framing, cuda_iir

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dsptoolbox_tpu_torch"


def test_import_leaves_jax_out_and_needs_no_triton():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None  # importing triton now raises\n"
        "import dsptoolbox_tpu_torch, dsptoolbox_tpu_torch.headline\n"
        "import dsptoolbox_tpu_torch.ops.spectral, dsptoolbox_tpu_torch.ops.iir\n"
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
        for bad in ("__half", "bfloat16", "wmma", "mma.sync", "tf32"):
            assert bad not in text, f"{path} contains {bad!r}"


def test_cpu_tensors_never_launch_kernels():
    cuda_framing.launches = 0
    cuda_iir.launches = 0
    rng = np.random.default_rng(0)
    T = 4096  # 32 full IIR blocks: the kernel's regime on a CUDA tensor
    x = torch.from_numpy(rng.standard_normal((2, T)).astype(np.float32))
    exc = torch.fft.rfft(torch.from_numpy(rng.standard_normal(T).astype(np.float32)))
    for bank in ("per_band", "banked"):
        headline.run(x, exc, bank=bank)
    assert cuda_framing.launches == 0
    assert cuda_iir.launches == 0


def test_switch_on_refuses_cpu_tensor():
    x = torch.zeros(2, 4096)
    win = torch.ones(64)
    _config.set_framing_kernel("on")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            cuda_framing.windowed_frames(x, win, 32, False)
    finally:
        _config.set_framing_kernel("auto")
    with pytest.raises(ValueError):
        dtt.set_iir_kernel("fast")


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

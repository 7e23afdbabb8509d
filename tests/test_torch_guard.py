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
        "import dsptoolbox_tpu_torch.room_acoustics, dsptoolbox_tpu_torch.tools.room_measurement\n"
        "import dsptoolbox_tpu_torch.standard, dsptoolbox_tpu_torch.transforms\n"
        "import dsptoolbox_tpu_torch.tools.speech_chain, dsptoolbox_tpu_torch.helpers.latency\n"
        "import dsptoolbox_tpu_torch.helpers.frequency_conversion\n"
        "import dsptoolbox_tpu_torch.tools.profile_chain\n"
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


@pytest.mark.parametrize(
    "first", ["classes", "filterbanks", "standard", "generators", "transforms"])
def test_each_layer_imports_first(first):
    """No import cycle: the layers below `standard` take the enums from the
    leaf module `_enums`, so any of them may be the first import."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-c", f"import dsptoolbox_tpu_torch.{first}"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120,
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


def _split_operand(arg: str) -> tuple:
    """``(part, base)`` of an operand at an ``mma_tf32`` call site: the
    part ("hi" or "lo") of a value split by ``split_tf32`` and the operand
    with that part blanked, which names the value. A part is a name's
    ``hi``/``lo`` suffix (``alo[mt]``, ``bhi[nt][0]``) or, in
    ``iir_bank.cu``'s ``hb[d][b][part]``, the last index (0 hi, 1 lo)."""
    arg = arg.strip()
    m = re.fullmatch(r"(\w*)(hi|lo)(\W.*)?", arg)
    if m:
        return m.group(2), f"{m.group(1)}*{m.group(3) or ''}"
    m = re.fullmatch(r"(hb\[[^\]]*\]\[[01]\])\[([01])\]", arg)
    assert m, f"mma_tf32 operand {arg!r} is not a part of a hi/lo split"
    return ("hi", "lo")[int(m.group(2))], f"{m.group(1)}[*]"


def tf32_call_sites(text: str) -> list:
    """Every ``mma_tf32(acc, a, b0, b1)`` call of a CUDA source, in text
    order, as ``(acc, (part, base) of a, of b0, of b1)``."""
    calls = []
    for args in re.findall(r"(?<!void )\bmma_tf32\(([^;]*)\);", text):
        acc, a, b0, b1 = (t.strip() for t in args.split(","))
        calls.append((acc, _split_operand(a), _split_operand(b0), _split_operand(b1)))
    return calls


def check_tf32_rule(path: Path, text: str) -> None:
    """Tensor-core products only in fp64, or in TF32 as the three products
    of a hi/lo split (fp32 accuracy), never a single one: one TF32
    ``mma.sync`` helper, ``cvt.rna`` rounding, no TF32 ``wgmma``, and its
    call sites in triples lo·hi, hi·lo, hi·hi on one accumulator and the
    same split values."""
    assert not re.search(r"wgmma[\w.]*tf32", text), f"{path}: TF32 wgmma"
    mma = re.findall(r"mma\.sync\.aligned\.\w+\.row\.col\.([\w.]+)", text)
    assert all(t in ("f64.f64.f64.f64", "f32.tf32.tf32.f32") for t in mma), (path, mma)
    calls = tf32_call_sites(text)
    if "f32.tf32.tf32.f32" not in mma:
        assert not calls, path
        return
    assert mma.count("f32.tf32.tf32.f32") == 1, path  # one helper, mma_tf32
    assert "cvt.rna.tf32.f32" in text, path
    assert calls and len(calls) % 3 == 0, (path, calls)
    for i in range(0, len(calls), 3):
        triple = calls[i:i + 3]
        parts = [(a[0], b0[0], b1[0]) for _, a, b0, b1 in triple]
        assert parts == [("lo", "hi", "hi"), ("hi", "lo", "lo"), ("hi", "hi", "hi")], (
            path, triple)
        for j in range(4):  # one accumulator, the same split values
            same = {c[j] if j == 0 else c[j][1] for c in triple}
            assert len(same) == 1, (path, triple)


@pytest.mark.parametrize(
    "needle",
    ["allow_tf32 = True", "allow_tf32=True", "set_float32_matmul_precision",
     "autocast", "bfloat16", "float16", "half()"],
)
def test_port_never_lowers_precision(needle):
    for path in _port_sources():
        assert needle not in path.read_text(), f"{path} contains {needle!r}"
    sites = {}
    for path in sorted((PKG / "csrc").glob("*.cu")):
        text = path.read_text()
        for bad in ("__half", "bfloat16", "wmma"):
            assert bad not in text, f"{path} contains {bad!r}"
        check_tf32_rule(path, text)
        sites[path.name] = [(a[0], b0[0]) for _, a, b0, _ in tf32_call_sites(text)]
    three = [("lo", "hi"), ("hi", "lo"), ("hi", "hi")]
    assert sites["iir_bank.cu"] == three and sites["banded.cu"] == three, sites


@pytest.mark.parametrize(
    "body",
    ["mma_tf32(acc[nt], ahi, bhi[0], bhi[1]);",  # a single TF32 product
     "mma_tf32(acc, alo, bhi[0], bhi[1]); mma_tf32(acc, ahi, blo[0], blo[1]);",
     "mma_tf32(acc, ahi, bhi[0], bhi[1]); mma_tf32(acc, alo, bhi[0], bhi[1]); "
     "mma_tf32(acc, ahi, blo[0], blo[1]);",  # hi·hi first
     "mma_tf32(acc, alo, bhi[0], bhi[1]); mma_tf32(acc, ahi, blo[0], blo[1]); "
     "mma_tf32(acc2, ahi, bhi[0], bhi[1]);",  # two accumulators
     "mma_tf32(acc, alo, bhi[0], bhi[1]); mma_tf32(acc, ahi, blo[0], blo[1]); "
     "mma_tf32(acc, chi, bhi[0], bhi[1]);",  # another A value
     "mma_tf32(acc, alo, bhi[0], bhi[1]); mma_tf32(acc, ahi, blo[0], blo[1]); "
     "mma_tf32(acc, ahi, x[0], x[1]);",  # an operand that is no split part
     "asm(\"wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32\");"],
)
def test_tf32_rule_refuses_other_uses(body):
    helper = ('asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 ...");\n'
              'asm("cvt.rna.tf32.f32 %0, %1;");\n')
    good = ("mma_tf32(acc, alo, bhi[0], bhi[1]); mma_tf32(acc, ahi, blo[0], blo[1]); "
            "mma_tf32(acc, ahi, bhi[0], bhi[1]);")
    check_tf32_rule(Path("good.cu"), helper + good)
    with pytest.raises(AssertionError):
        check_tf32_rule(Path("bad.cu"), helper + body)


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


# the names of the JAX package's `standard` that wait: `spectral_difference`
# for the Spectrum class's octave smoothing, `load_pkl_object` for `io`
WAITING = {"spectral_difference", "load_pkl_object"}


@pytest.mark.parametrize("namespace", ["standard", "generators"])
def test_exports_match_the_jax_package(namespace):
    import importlib

    import dsptoolbox_tpu

    jax_names = set(importlib.import_module(f"dsptoolbox_tpu.{namespace}").__all__)
    port = importlib.import_module(f"dsptoolbox_tpu_torch.{namespace}")
    assert set(port.__all__) == jax_names - WAITING
    for name in port.__all__:
        assert hasattr(port, name), name
    assert dsptoolbox_tpu  # imported only to read the export list


def test_config2_and_standard_paths_launch_no_kernel_on_cpu_tensors():
    from dsptoolbox_tpu_torch import standard
    from dsptoolbox_tpu_torch.classes import Filter
    from dsptoolbox_tpu_torch.standard.enums import FilterPassType
    from dsptoolbox_tpu_torch.tools import speech_chain

    cuda_framing.launches = 0
    cuda_iir.launches = 0
    old = _config.default_device()
    _config.set_default_device("cpu")
    try:
        sig = speech_chain.signal(2, 3.0)  # longer than the frequency-sampling window
        y, sp, C = speech_chain.run(sig)
        two = sig.get_channels([0, 1])
        standard.lufs_integrated(two)
        standard.activity_detector(
            two, pre_filter=Filter.iir_filter(2, 80.0, FilterPassType.Highpass, 48000))
        standard.true_peak_level(two)
        standard.latency(two, standard.delay(two, 10))
    finally:
        _config.set_default_device(old)
    assert C.device.type == "cpu" and y.device.type == "cpu"
    assert cuda_framing.launches == 0
    assert cuda_iir.launches == 0

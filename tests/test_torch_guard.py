"""Guards on the port package: no JAX at run time, no reduced-precision
switches, and no kernel launch for CPU tensors."""

import ast
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dsptoolbox_tpu_torch as dtt
from dsptoolbox_tpu_torch import _config, headline
from dsptoolbox_tpu_torch.classes import ImpulseResponse, Signal, Spectrum
from dsptoolbox_tpu_torch.ops import (
    banded, cuda_banded, cuda_csm, cuda_das, cuda_ema, cuda_framing, cuda_iir, iir_block,
)
from dsptoolbox_tpu_torch.tools import camera
from dsptoolbox_tpu_torch.transfer_functions import (
    SmoothingDomain,
    complex_smoothing,
    trim_ir,
    window_ir,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dsptoolbox_tpu_torch"


def kernels_asked(fn) -> set:
    """The kernel names that ``fn()`` asks `_config.use_kernel` about, each
    answered "no" (the plain version)."""
    names = set()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(_config, "use_kernel", lambda name, x: names.add(name) or False)
        fn()
    return names


def test_import_leaves_jax_out_and_needs_no_triton():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None  # importing triton now raises\n"
        "import dsptoolbox_tpu_torch, dsptoolbox_tpu_torch.headline\n"
        "import dsptoolbox_tpu_torch.ops.spectral, dsptoolbox_tpu_torch.ops.iir\n"
        "import dsptoolbox_tpu_torch.beamforming, dsptoolbox_tpu_torch.classes\n"
        "from dsptoolbox_tpu_torch.beamforming import (BeamformerCleanSC, BeamformerDASTime,\n"
        "    BeamformerFunctional, BeamformerMVDR, BeamformerOrthogonal)\n"
        "import dsptoolbox_tpu_torch.tools.camera, dsptoolbox_tpu_torch.tools.measurement\n"
        "import dsptoolbox_tpu_torch.tools.tf_analysis, dsptoolbox_tpu_torch.helpers.spectrum_utilities\n"
        "import dsptoolbox_tpu_torch.transfer_functions, dsptoolbox_tpu_torch.generators\n"
        "import dsptoolbox_tpu_torch.room_acoustics, dsptoolbox_tpu_torch.tools.room_measurement\n"
        "import dsptoolbox_tpu_torch.standard, dsptoolbox_tpu_torch.transforms\n"
        "import dsptoolbox_tpu_torch.tools.speech_chain, dsptoolbox_tpu_torch.helpers.latency\n"
        "import dsptoolbox_tpu_torch.helpers.frequency_conversion\n"
        "import dsptoolbox_tpu_torch.tools.profile_chain, dsptoolbox_tpu_torch.plots\n"
        "import dsptoolbox_tpu_torch.tools.feature_chain, dsptoolbox_tpu_torch.transforms._backend\n"
        "import dsptoolbox_tpu_torch.helpers.ar_estimation, dsptoolbox_tpu_torch.helpers\n"
        "import dsptoolbox_tpu_torch.io, dsptoolbox_tpu_torch.io.flac, dsptoolbox_tpu_torch.ops.cuda_ema\n"
        "import dsptoolbox_tpu_torch.helpers.polyphase, dsptoolbox_tpu_torch.helpers.bytes_conversion\n"
        "import dsptoolbox_tpu_torch.classes.calibration_data, dsptoolbox_tpu_torch.classes._plots\n"
        "import dsptoolbox_tpu_torch.realtime, dsptoolbox_tpu_torch.realtime.designers\n"
        "import dsptoolbox_tpu_torch.classes.lattice_ladder_filter\n"
        "import dsptoolbox_tpu_torch.filterbanks.crossovers, dsptoolbox_tpu_torch.tools.realtime_chain\n"
        "import dsptoolbox_tpu_torch.effects, dsptoolbox_tpu_torch.distances\n"
        "import dsptoolbox_tpu_torch.audio_io, dsptoolbox_tpu_torch.ops.differentiable\n"
        "import dsptoolbox_tpu_torch.ops.prefix, dsptoolbox_tpu_torch.tools.public\n"
        "import dsptoolbox_tpu_torch.tools.effects_chain\n"
        "import dsptoolbox_tpu_torch.parallel, dsptoolbox_tpu_torch.parallel.ops\n"
        "import dsptoolbox_tpu_torch.classes.lazy_array\n"
        "assert 'sounddevice' not in sys.modules  # imported at the first audio call only\n"
        "assert not any(m.startswith('dsptoolbox_tpu_torch._build') for m in sys.modules)\n"
        "assert 'matplotlib' not in sys.modules  # imported at the first plot only\n"
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
    "first", ["classes", "filterbanks", "standard", "generators", "transforms", "plots",
              "realtime", "effects", "distances", "audio_io", "tools", "ops", "parallel"])
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
    names = {p.name for p in _port_sources()}
    assert {"pipeline.py", "_defer.py", "chip_smoke.py", "lazy_array.py", "mesh.py"} <= names
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


def test_kernels_off_restores_every_switch():
    """Nested `kernels_off` blocks turn every kernel off and restore the
    seam on the way out, also through an exception."""
    def taken():
        return {_config.use_kernel(name, SimpleNamespace(is_cuda=True, dtype=dtypes[0]))
                for name, dtypes in _config.KERNEL_DTYPES.items()}

    assert taken() == {True}
    with _config.kernels_off():
        assert taken() == {False}
        with _config.kernels_off():
            assert taken() == {False}
        assert taken() == {False}
    assert taken() == {True}
    with pytest.raises(RuntimeError):
        with _config.kernels_off():
            raise RuntimeError
    assert taken() == {True}


# each kernel's name, the dtypes it takes and its dispatchers
DISPATCHERS = {
    "framing": ((torch.float32,), [cuda_framing.windowed_frames]),
    "iir": ((torch.float32,), [cuda_iir.sosfilt_lead]),
    "bank": ((torch.float32,), [iir_block.sosfilt_bank_apply_planes]),
    "das": ((torch.float32,), [cuda_das.das_map]),
    "banded": ((torch.float32,), [banded.banded_apply]),
    "ema": ((torch.float32, torch.float64),
            [cuda_ema.ema_attack_release, cuda_ema.ema_average]),
    "csm": ((torch.complex64,), [cuda_csm.gram_mean]),
}


@pytest.mark.parametrize("name", list(DISPATCHERS))
def test_use_kernel_rule(name):
    """`_config.use_kernel`: a CUDA tensor of a dtype the kernel takes, and
    nothing inside `kernels_off`; the table names every dispatcher, and each
    asks by its own name."""
    taken_dtypes, dispatchers = DISPATCHERS[name]
    assert set(_config.KERNEL_DTYPES) == set(DISPATCHERS)
    assert set(_config.KERNEL_DTYPES[name]) == set(taken_dtypes)
    for fn in dispatchers:
        assert f'_config.use_kernel("{name}", ' in inspect.getsource(inspect.unwrap(fn))
    dtypes = (torch.float16, torch.float32, torch.float64, torch.complex64,
              torch.complex128, torch.int32)
    for dtype in dtypes:
        taken = dtype in taken_dtypes
        assert _config.use_kernel(name, SimpleNamespace(is_cuda=True, dtype=dtype)) is taken
        assert not _config.use_kernel(name, SimpleNamespace(is_cuda=False, dtype=dtype))
        with _config.kernels_off():
            assert not _config.use_kernel(name, SimpleNamespace(is_cuda=True, dtype=dtype))


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


# the JAX package's names that wait, each beside its ROADMAP queue item: in
# a namespace, and at the root the namespaces and modules not ported yet
WAITING: dict = {}
WAITING_ROOT: dict = {**WAITING}
# the port's own exports: the steering factors as tensors on a device; at
# the root, the default device of `_config`
PORT_ONLY = {
    "beamforming": {"amp_diff_to_torch"},
    "": {"default_device", "set_default_device"},
}


@pytest.mark.parametrize("namespace", ["standard", "generators", "beamforming",
                                       "transfer_functions", "transforms", "plots", "helpers",
                                       "io", "filterbanks", "realtime", "effects",
                                       "distances", "audio_io", "tools", "ops", "parallel",
                                       "classes", pytest.param("", id="root")])
def test_exports_match_the_jax_package(namespace):
    """Each namespace (and, for "", the package's root) exports the JAX
    package's names but those still waiting, plus the port's own (the JAX
    package's `plots` has no ``__all__``: its public names)."""
    import importlib
    import inspect

    import dsptoolbox_tpu

    suffix = f".{namespace}" if namespace else ""
    jax_module = importlib.import_module(f"dsptoolbox_tpu{suffix}")
    jax_names = set(getattr(jax_module, "__all__", None) or [
        n for n in dir(jax_module)
        if not n.startswith("_") and not inspect.ismodule(getattr(jax_module, n))])
    port = importlib.import_module(f"dsptoolbox_tpu_torch{suffix}")
    waiting = set(WAITING if namespace else WAITING_ROOT)
    if not namespace:
        assert waiting <= jax_names
    assert set(port.__all__) == (jax_names - waiting) | PORT_ONLY.get(namespace, set())
    for name in port.__all__:
        assert hasattr(port, name), name
    assert dsptoolbox_tpu  # imported only to read the export list


def test_nothing_is_left_not_ported_yet():
    """The port does all the JAX package does: no call raises for a part
    still to port, and no message or docstring says one waits."""
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"not ported yet|Not ported yet", text), path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Raise) and node.exc is not None:
                src = ast.get_source_segment(text, node.exc) or ""
                assert not ("NotImplementedError" in src and "port" in src.lower()), (
                    f"{path}:{node.lineno}: {src}")


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


def test_new_beamformers_launch_no_kernel_on_cpu_tensors():
    """The config-5 maps (`camera.map_calls`: MVDR in both forms, Functional,
    CLEAN-SC, Orthogonal, DAS) and the time-domain DAS on CPU tensors: the
    plain versions, no launch; the maps that reach the DAS kernel ask for it."""
    cuda_framing.launches = 0
    cuda_das.launches = 0
    line = np.arange(-0.3, 0.3, 0.1)
    g = camera.Regular2DGrid(line, line, ["x", "y"], value3=0.5)
    sig = camera.array_signal(0.1, 16000, "cpu", g)
    calls = camera.map_calls(sig, g, camera.with_sensor_noise(sig))
    for name, fn in calls.items():
        m = fn()
        assert m.shape == (6, 6) and m.device.type == "cpu", name
    out = camera.time_beamformer(sig, g).get_beamformer_output()
    assert out.number_of_channels == 36 and out.device.type == "cpu"
    assert cuda_framing.launches == 0
    assert cuda_das.launches == 0
    for name in ("das", "mvdr_reference", "functional", "clean_sc"):
        assert kernels_asked(calls[name]) == {"das"}, name


def test_transfer_function_analysis_launches_no_kernel_on_cpu_tensors():
    """The transfer-function analysis path (`tools.tf_analysis`: the
    estimators, the IR tools, FDW and the harmonic analysis) on CPU tensors
    at a small size: the plain versions, no launch; the estimators ask for
    the framing kernel."""
    from dsptoolbox_tpu_torch.tools import tf_analysis

    cuda_framing.launches = 0
    cuda_iir.launches = 0
    cuda_banded.launches = 0
    old = _config.default_device()
    _config.set_default_device("cpu")
    try:
        rec, noise = tf_analysis.noise_measurement(seconds=0.5, channels=2)
        out = tf_analysis.estimators(rec, noise, 1024)
        assert all(s.spectral_data.device.type == "cpu" for s in out.values())
        rng = np.random.default_rng(0)
        td = (rng.standard_normal((8192, 2)) * np.exp(-np.arange(8192) / 600)[:, None]
              ).astype(np.float32)
        td[50] = 1.0
        ir = ImpulseResponse(None, td, 48000)
        windowed = window_ir(ir, 4096)[0]
        smoothed = complex_smoothing(windowed, 3, SmoothingDomain.RealImaginary)
        trimmed = trim_ir(ir)[0]
        calls = tf_analysis.ir_calls(ir, windowed, smoothed, trimmed, cycles=2,
                                     tukey_s=(0.002, 0.01), centered=1024)
        for name, fn in calls.items():
            fn()
        distorted, sweep, length_s = tf_analysis.distorted_recording()
        harmonic = tf_analysis.harmonic_analysis(distorted, sweep, length_s)[2]
        assert harmonic["thd"].spectral_data.device.type == "cpu"
        assert kernels_asked(lambda: tf_analysis.estimators(rec, noise, 1024)) == {"framing"}
    finally:
        _config.set_default_device(old)
    assert cuda_framing.launches == 0
    assert cuda_iir.launches == 0
    assert cuda_banded.launches == 0


def test_feature_chain_launches_no_kernel_on_cpu_tensors():
    """`tools.feature_chain`'s steps (the STFT features, Hilbert, the DFT,
    the filter-bank spectrum in both phases, CWT, VQT, LPC, warping and
    Laguerre) on CPU tensors at a small size: the plain versions, no
    launch; the STFT features and `lpc` ask for the framing kernel, the
    filter-bank spectrum for the bank's."""
    from dsptoolbox_tpu_torch import transforms
    from dsptoolbox_tpu_torch.ops import cuda_iir_bank
    from dsptoolbox_tpu_torch.tools import feature_chain, speech_chain

    cuda_framing.launches = 0
    cuda_iir.launches = 0
    cuda_iir_bank.launches = 0
    old = _config.default_device()
    _config.set_default_device("cpu")
    try:
        session = speech_chain.signal(2, 0.5)
        rng = np.random.default_rng(0)
        irs = ImpulseResponse(None, (0.3 * rng.standard_normal((4096, 2))).astype(np.float32),
                              48000)
        out = feature_chain.run(session, feature_chain.music(seconds=0.2),
                                feature_chain.lpc_signal(session), irs)
        assert len(out) == 16
        for fn in (lambda: transforms.mfcc(session, generate_plot=False),
                   lambda: transforms.lpc(session, 8, 512)):
            session._cache.clear()
            assert "framing" in kernels_asked(fn)
        assert "bank" in kernels_asked(
            lambda: transforms.spectrum_via_filterbank(session, [500.0, 1000.0], 1 / 3))
    finally:
        _config.set_default_device(old)
    assert cuda_framing.launches == 0
    assert cuda_iir.launches == 0
    assert cuda_iir_bank.launches == 0


def test_session_files_path_launches_no_kernel_on_cpu_tensors(tmp_path):
    """`tools.session_files`'s steps (WAV and FLAC written and loaded,
    calibration, the stateful ``(b, a)`` streamed in blocks and in one
    call, both zero phases, the SPL plot's smoothing and the attack/release
    smoothing, the save/load round trips) on CPU tensors at a small size:
    the plain versions, no launch; the streamed filter asks for the IIR
    kernel, the attack/release smoothing for the EMA kernel."""
    import matplotlib

    matplotlib.use("Agg")
    from dsptoolbox_tpu_torch.classes import Filter, FilterBank
    from dsptoolbox_tpu_torch.tools import session_files as sf

    cuda_iir.launches = 0
    cuda_ema.launches = 0
    old = _config.default_device()
    _config.set_default_device("cpu")
    try:
        s = sf.session(3, 2.0)
        paths = sf.write_session(s, str(tmp_path))
        wav, flac = sf.load_wav(paths["wav"]), sf.load_flac(paths["flac"])
        assert torch.equal(wav.time_data, flac.time_data) and wav.device.type == "cpu"
        calibrated, _ = sf.calibrate(wav, sf.write_calibrator(str(tmp_path)))
        assert calibrated.calibrated_signal
        b, a = sf.stream_coefficients()[1]
        assert torch.equal(sf.stream(wav, b, a).time_data, sf.whole(wav, b, a).time_data)
        sf.zero_phase(wav, b, a)
        sf.zero_phase(wav, sf.fir_coefficients(), [1.0])
        sf.spl_plot(wav)
        smoothed = sf.attack_release(wav._x**2)
        filt = Filter.from_ba(b, a, sf.FS)
        back = sf.save_and_load({"session": wav, "filter": filt,
                                 "bank": FilterBank([filt, filt]),
                                 "spectrum": Spectrum(*wav.get_spectrum())}, str(tmp_path))
        assert torch.equal(back["session"].time_data, wav.time_data)
        assert "iir" in kernels_asked(lambda: sf.stream(wav, b, a))
        assert kernels_asked(lambda: sf.attack_release(wav._x**2)) == {"ema"}
    finally:
        _config.set_default_device(old)
    assert smoothed.shape == wav._x.shape
    assert cuda_iir.launches == 0
    assert cuda_ema.launches == 0


def test_realtime_chain_launches_no_kernel_on_cpu_tensors():
    """The filter-design and streaming path (`tools.realtime_chain`) on CPU
    tensors takes the plain versions: B2 and the EMA kernel's average form
    count no launch."""
    from dsptoolbox_tpu_torch.tools import realtime_chain as rc

    old = _config.default_device()
    _config.set_default_device("cpu")
    try:
        cuda_iir.launches = 0
        cuda_ema.average_launches = 0
        rng = np.random.default_rng(0)
        s = Signal(None, rng.standard_normal((24000, 2)).astype(np.float32) * 0.1, rc.FS)
        irs = rng.standard_normal((2048, 2)) * np.exp(-np.arange(2048) / 200.0)[:, None]
        ir = rc.ir_signal(irs)
        rc.weighted_eq(s, rc.designs(ir))
        rc.warped_fir(irs).filter_signal(s)
        rc.svf().filter_signal(s)
        blocks = s._x[0, : 8 * rc.BLOCK]
        for f in (rc.realtime.IIRFilter(*rc.stream_coefficients()),
                  rc.realtime.ExponentialAverageFilter(*rc.EMA_S, rc.FS)):
            for i in range(8):
                f.process_block(blocks[i * rc.BLOCK:(i + 1) * rc.BLOCK], 0)
        assert cuda_iir.launches == 0 and cuda_ema.average_launches == 0
    finally:
        _config.set_default_device(old)


def test_effects_chain_launches_no_kernel_on_cpu_tensors():
    """The effects path (`tools.effects_chain`: both subtractor modes, the
    compressor, the rack, the scores with fwSNRseg's gammatone bank, the EQ
    fit through `Filter` and `sosfilt_diff`) on CPU tensors takes the plain
    versions: B1, B2, B3 and the EMA kernel's average form count no launch;
    the compressor asks for the EMA kernel, fwSNRseg for the bank's."""
    from dsptoolbox_tpu_torch import distances
    from dsptoolbox_tpu_torch.ops import cuda_iir_bank
    from dsptoolbox_tpu_torch.tools import effects_chain as ec

    old = _config.default_device()
    _config.set_default_device("cpu")
    try:
        for m in (cuda_framing, cuda_iir, cuda_iir_bank):
            m.launches = 0
        cuda_ema.average_launches = 0
        clean, noisy = ec.inputs(2, 0.5, fs=16000)
        steps = []
        out = ec.run(clean, noisy, (100.0, 4000.0), on_step=steps.append)
        assert steps == ["adaptive subtractor", "offline subtractor", "compressor", "rack",
                         "scores, denoised", "scores, compressed", "eq match"]
        assert out["compressor"]._last_gain.shape == clean._x.shape
        assert out["eq"]["equalized"].device.type == "cpu"
        assert all(r.device.type == "cpu" for r in out["rack"])
        assert (cuda_framing.launches, cuda_iir.launches, cuda_iir_bank.launches,
                cuda_ema.average_launches) == (0, 0, 0, 0)
        assert "ema" in kernels_asked(lambda: ec.compress(out["adaptive"]))
        assert "bank" in kernels_asked(
            lambda: distances.fw_snr_seg(clean, out["adaptive"], f_range_hz=[100, 4000]))
    finally:
        _config.set_default_device(old)

"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (B3 also against scipy's float64 sosfilt), and B4
at the measurement path's plan (the
paths' full widths are covered by ``chip_smoke.py``). Marked ``cuda``; they
skip without a CUDA device.

On a machine with a GPU (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from scipy.signal import butter, sosfilt, sosfilt_zi

from dsptoolbox_tpu_torch import _config, headline
from dsptoolbox_tpu_torch import beamforming as bf
from dsptoolbox_tpu_torch.classes import Signal
from dsptoolbox_tpu_torch.classes import ImpulseResponse
from dsptoolbox_tpu_torch.ops import (
    banded, cuda_banded, cuda_das, cuda_framing, cuda_iir, cuda_iir_bank, iir_block,
)
from dsptoolbox_tpu_torch.standard.enums import Window
from dsptoolbox_tpu_torch.transfer_functions import SmoothingDomain, complex_smoothing
from dsptoolbox_tpu_torch.transfer_functions import _backend as tf_backend

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    dt = torch.complex128 if a.is_complex() or b.is_complex() else torch.float64
    a, b = a.to(dt), b.to(dt)
    return float((a - b).abs().max()) / float(b.abs().max())


def _framing_case(dev, rng, shape, L, step, pad, detrend):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    win = torch.from_numpy(np.hanning(L).astype(np.float32)).to(dev)
    before = cuda_framing.launches
    got = cuda_framing.windowed_frames(x, win, step, detrend, pad)
    want = cuda_framing.windowed_frames_plain(x, win, step, detrend, pad)
    torch.cuda.synchronize()
    assert cuda_framing.launches == before + 1
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize(
    "shape,L,step,pad",
    [((8, 4096), 512, 256, 0), ((3, 1000), 384, 160, 0), ((2, 3, 777), 100, 37, 0),
     ((1, 50), 64, 64, 0), ((5, 10), 64, 16, 0), ((4, 3000), 256, 128, 128),
     ((2, 777), 100, 37, 63), ((1, 10), 64, 16, 48)],
)
@pytest.mark.parametrize("detrend", [True, False])
def test_framing_kernel_matches_plain(dev, shape, L, step, pad, detrend):
    _framing_case(dev, RNG, shape, L, step, pad, detrend)


# the warp kernel (L <= 2048) with k·step - pad off 16 bytes (T odd, step
# 130, pad 3), step > L, one row shorter than a frame and the chain's STFT
# (16, 384000) with pad 512; one block per frame at L = 2^16 and 2^18
# (Welch's longest)
@pytest.mark.parametrize(
    "shape,L,step,pad",
    [((3, 1001), 256, 130, 3), ((2, 5000), 256, 300, 10), ((1, 700), 1024, 512, 0),
     ((16, 384000), 1024, 512, 512), ((2, 2**17 + 5), 2**16, 2**15, 7),
     ((1, 2**19), 2**18, 2**17, 0)],
)
@pytest.mark.parametrize("detrend", [True, False])
def test_framing_kernel_edge_shapes(dev, shape, L, step, pad, detrend):
    _framing_case(dev, np.random.default_rng(L + step), shape, L, step, pad, detrend)


@pytest.mark.parametrize("L,step", [(1024, 512), (4096, 1024)])
def test_framing_kernel_on_a_misaligned_x(dev, L, step):
    """x and the window 4 bytes off 16 (contiguous views of a larger
    buffer): the kernel stages with 4-byte copies."""
    rng = np.random.default_rng(L)
    base = torch.from_numpy(rng.standard_normal(3 * 9000 + 1).astype(np.float32)).to(dev)
    x = base[1:].view(3, 9000)
    wbase = torch.from_numpy(np.hanning(L + 1).astype(np.float32)).to(dev)
    win = wbase[1:]
    before = cuda_framing.launches
    got = cuda_framing.windowed_frames(x, win, step, True, 100)
    want = cuda_framing.windowed_frames_plain(x, win, step, True, 100)
    torch.cuda.synchronize()
    assert cuda_framing.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-6


# B2 runs on B3's kernel as one band (N = order lanes): N = 4, 8, 12 and 16
# take the chain's compile-time state sizes, the others its run-time path;
# N < 64 lanes take the fp64 tensor-core x·M pass (1, 2 or 4 lane tiles:
# N <= 8, 16, 32); K = 1 and 2 are the chunked chain's edge cases; L <= 128
# takes the tensor-core output pass, L = 200 and 256 two column tiles of the
# FFMA pass, L >= 512 more, with x·M over several l chunks; a zero start
# state; the chain's shape (16 rows x 3000 blocks of 128, N = 8)
@pytest.mark.parametrize(
    "order,L,B,K,out_pass,zi_scale",
    [(6, 128, 3, 40, "mma", 1), (4, 98, 2, 17, "mma", 1), (2, 64, 1, 300, "mma", 1),
     (8, 128, 2, 3000, "mma", 1), (18, 128, 2, 40, "mma", 1), (32, 128, 1, 33, "mma", 1),
     (4, 128, 1, 1, "mma", 1), (4, 64, 2, 2, "mma", 1), (4, 3, 2, 50, "mma", 1),
     (8, 200, 2, 20, "ffma", 1), (8, 256, 3, 17, "ffma", 1), (6, 512, 2, 16, "ffma", 1),
     (32, 1024, 2, 16, "ffma", 1), (4, 1000, 1, 5, "ffma", 1), (4, 128, 2, 40, "mma", 0),
     (8, 128, 16, 3000, "mma", 1)],
)
def test_iir_lead_kernel_matches_plain(dev, order, L, B, K, out_pass, zi_scale):
    sos = butter(order, 0.2, output="sos")
    key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
    zi = (np.tile(sosfilt_zi(sos)[None], (B, 1, 1)) * RNG.uniform(0.1, 1, (B, 1, 1))
          * zi_scale)
    ops = iir_block.operators_to_torch(
        dict(zip(("HmatT", "GyT", "ALT", "MT"), iir_block._block_operators(key, L)),
             zi=zi),
        dev, torch.float32,
    )
    xb = torch.from_numpy(RNG.standard_normal((B, K, L)).astype(np.float32)).to(dev)
    args = (ops["HmatT"], ops["GyT"], ops["ALT"], ops["MT"], xb,
            ops["zi"].reshape(B, -1))
    assert cuda_iir_bank.output_pass(L) == out_pass
    before = (cuda_iir.launches, cuda_iir_bank.launches)
    yk, zk = cuda_iir.sosfilt_lead_cuda(*args)
    assert (cuda_iir.launches, cuda_iir_bank.launches) == (before[0] + 1, before[1])
    yp, zp = cuda_iir.sosfilt_lead_plain(*args)
    torch.cuda.synchronize()
    assert yk.shape == (B, K, L) and zk.shape == (B, order)
    assert float((yk - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert float((zk - zp).abs().max()) <= 1e-6 * max(1.0, float(zp.abs().max()))


def test_sosfilt_block_on_card_matches_scipy(dev):
    sos = butter(4, [250.0, 1000.0], btype="bandpass", fs=48000, output="sos")
    x = RNG.standard_normal((3, 48000 + 77)).astype(np.float32)
    zi = np.tile(sosfilt_zi(sos)[None], (3, 1, 1)) * 0.5
    before = cuda_iir.launches
    y, zf = iir_block.sosfilt_block(sos, torch.from_numpy(x).to(dev), zi=zi)
    assert cuda_iir.launches == before + 1
    y_ref, zf_ref = sosfilt(sos, x.astype(np.float64), zi=np.moveaxis(zi, 0, 1))
    assert _rel(y, y_ref) < 5e-6
    np.testing.assert_allclose(zf.cpu().numpy(), np.moveaxis(zf_ref, 0, 1), atol=1e-6)


def test_short_sosfilt_block_on_card_launches_the_kernel(dev):
    """T = 1000 is 7 blocks of 128: the lead still runs B2 on the card."""
    sos = butter(4, [250.0, 1000.0], btype="bandpass", fs=48000, output="sos")
    x = RNG.standard_normal((3, 1000)).astype(np.float32)
    zi = np.tile(sosfilt_zi(sos)[None], (3, 1, 1)) * 0.5
    before = cuda_iir.launches
    y, zf = iir_block.sosfilt_block(sos, torch.from_numpy(x).to(dev), zi=zi)
    assert cuda_iir.launches == before + 1
    y_ref, zf_ref = sosfilt(sos, x.astype(np.float64), zi=np.moveaxis(zi, 0, 1))
    assert _rel(y, y_ref) < 5e-6
    np.testing.assert_allclose(zf.cpu().numpy(), np.moveaxis(zf_ref, 0, 1), atol=1e-6)


def test_long_cascade_and_long_blocks_on_card_match_scipy(dev):
    """18 sections run as two kernel launches (16 + 2 sections) at blocks of
    512 samples."""
    sos = np.concatenate(
        [butter(2, f, output="sos") for f in np.linspace(0.05, 0.9, 18)]
    )
    x = RNG.standard_normal((2, 16 * 512 + 33)).astype(np.float32)
    zi = RNG.standard_normal((2, 18, 2)) * 0.1
    before = cuda_iir.launches
    y, zf = iir_block.sosfilt_block(sos, torch.from_numpy(x).to(dev), zi=zi,
                                    block_size=512)
    assert cuda_iir.launches == before + 2
    y_ref, zf_ref = sosfilt(sos, x.astype(np.float64), zi=np.moveaxis(zi, 0, 1))
    assert _rel(y, y_ref) < 5e-6
    np.testing.assert_allclose(zf.cpu().numpy(), np.moveaxis(zf_ref, 0, 1), atol=1e-6)


def test_chain_on_card_matches_cpu(dev):
    T = 4096
    x = torch.from_numpy(RNG.standard_normal((4, T)).astype(np.float32))
    exc = torch.fft.rfft(torch.from_numpy(RNG.standard_normal(T).astype(np.float32)))
    for bank in ("per_band", "banked"):
        got = headline.run(x.to(dev), exc.to(dev), bank=bank)
        want = headline.run(x, exc, bank=bank)
        for g, w in zip(got, want):
            assert g.is_cuda
            assert _rel(g, w) <= 2e-5


def test_switch_off_takes_plain_path_on_card(dev):
    x = torch.zeros(2, 4096, device=dev)
    win = torch.ones(64, device=dev)
    before = cuda_framing.launches
    _config.set_framing_kernel("off")
    try:
        cuda_framing.windowed_frames(x, win, 32, False)
    finally:
        _config.set_framing_kernel("auto")
    assert cuda_framing.launches == before


def _das_args(F, M, G, dev, dtype=torch.float32, rng=None, hermitian=False):
    rng = RNG if rng is None else rng
    C = rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M))
    if hermitian:
        C = (C + np.conj(np.swapaxes(C, -1, -2))) / 2
    arrays = (rng.uniform(0.5, 1.0, (M, G)), rng.uniform(-0.5, 0.5, (M, G)),
              np.linspace(10.0, 400.0, F), C.real, C.imag)
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
            for a in arrays]


# (F, M, G): the ragged shapes of tests/test_pallas_das.py; M = 1 and every
# mic-tile size (8, 16, 32, 64); M = 65 and 160 take several mic tiles (at
# M = 160 the whole C_f does not fit in shared memory); G below, at and
# above the 64-point block. Then, each with its own generator (so the cases
# above keep their inputs) and a non-Hermitian and a Hermitian C: the DAS
# path's 10 and 30 bins, 30 bins at M = 160, and M = 300 (the steering
# rebuilt per tile pair)
@pytest.mark.parametrize(
    "F,M,G,hermitian",
    [(13, 9, 20, None), (5, 25, 130, None), (37, 64, 100, None), (2, 1, 5, None),
     (3, 8, 64, None), (4, 16, 65, None), (3, 32, 1, None), (6, 65, 33, None),
     (3, 160, 70, None), (1, 64, 900, None)]
    + [(F, M, G, h) for F, M, G in ((10, 64, 900), (30, 64, 900), (30, 160, 900),
                                    (2, 300, 40))
       for h in (False, True)],
)
def test_das_kernel_matches_plain(dev, F, M, G, hermitian):
    if hermitian is None:
        args = _das_args(F, M, G, dev)
    else:
        args = _das_args(F, M, G, dev, rng=np.random.default_rng(F * 1000 + M),
                         hermitian=hermitian)
    before = cuda_das.launches
    got = cuda_das.das_map(*args)
    want = cuda_das.das_map_plain(*args)
    torch.cuda.synchronize()
    assert cuda_das.launches == before + 1
    assert got.shape == (G, F)
    assert _rel(got, want) <= 5e-5


@pytest.mark.parametrize("F,M,G", [(10, 64, 900), (513, 64, 900), (30, 160, 900)])
def test_das_kernel_launches_are_bit_identical(dev, F, M, G):
    """The warps' sums are added in a fixed order: two launches on the same
    inputs give the same bits, one launch a call."""
    args = _das_args(F, M, G, dev, rng=np.random.default_rng(5))
    before = cuda_das.launches
    first = cuda_das.das_map_cuda(*args)
    second = cuda_das.das_map_cuda(*args)
    torch.cuda.synchronize()
    assert cuda_das.launches == before + 2
    assert torch.equal(first, second)


def test_das_kernel_design_on_card(dev):
    """The built kernel's plan matches `cuda_das.design`, and at the DAS
    path's 10 bins every SM holds at least 16 warps."""
    for shape in ((64, 900, 10), (64, 900, 30), (64, 900, 513), (160, 900, 30),
                  (300, 40, 2), (9, 20, 13)):
        got = cuda_das.kernel_design(*shape)
        want = cuda_das.design(*shape)
        assert {key: got[key] for key in want} == want
        assert got["blocks_per_sm"] >= 1
    d = cuda_das.kernel_design(64, 900, 10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert min(d["blocks"] // sms, d["blocks_per_sm"]) * d["warps"] >= 16


def test_das_kernel_float64_and_switch_on_card(dev):
    args = _das_args(5, 9, 20, dev, torch.float64)
    before = cuda_das.launches
    got = cuda_das.das_map(*args)  # float64 under "auto": plain version
    assert got.dtype == torch.float64 and cuda_das.launches == before
    _config.set_das_kernel("on")
    try:
        with pytest.raises(ValueError, match="float32"):
            cuda_das.das_map(*args)
    finally:
        _config.set_das_kernel("auto")
    _config.set_das_kernel("off")
    try:
        cuda_das.das_map(*(a.float() for a in args))
    finally:
        _config.set_das_kernel("auto")
    assert cuda_das.launches == before


def test_das_public_map_on_card_matches_cpu(dev):
    x = np.arange(3) * 0.5
    xx, yy = np.meshgrid(x, x, indexing="ij")
    ma = bf.MicArray(dict(x=xx.flatten(), y=yy.flatten(), z=np.zeros(9)))
    g = bf.Regular2DGrid(np.arange(-0.2, 0.21, 0.2), np.arange(-0.4, 0.5, 0.2),
                         ["x", "y"], value3=0.5)
    noise = (0.3 * RNG.standard_normal(3200)).astype(np.float32)
    maps = {}
    for where in ("cpu", dev):
        src = bf.MonopoleSource(Signal(None, torch.from_numpy(noise).to(where), 16000),
                                [0.0, 0.4, 0.5])
        sig = src.get_signals_on_array(ma)
        before = (cuda_framing.launches, cuda_das.launches)
        maps[str(where)] = bf.BeamformerDASFrequency(
            sig, ma, g, bf.SteeringVector()).get_beamformer_map(2000, 3)
        after = (cuda_framing.launches, cuda_das.launches)
        assert (after == before) == (where == "cpu")
    got = maps[str(dev)]
    assert got.is_cuda and got.shape == (3, 5)
    assert _rel(got, maps["cpu"]) <= 1e-4


def _segment(nb, tr, span, F, dev, rows=None):
    return {"rows": nb * tr if rows is None else rows, "span": span,
            "offsets": torch.from_numpy(
                RNG.integers(0, F - span, nb).astype(np.int32)).to(dev),
            "slab": torch.from_numpy(
                RNG.standard_normal((nb, tr, span)).astype(np.float32)).to(dev)}


# plans of (NB, TR, SPAN) segments on F x C: the JAX package's Pallas test
# shape with C = 1, 2 and 5; SPAN not a multiple of 4 (4-byte copies); TR
# not a multiple of the 64-row block; C above one 32-column block and not a
# multiple of 4; a one-row tile; several segments, cut short, in one launch
@pytest.mark.parametrize(
    "segments,C,F",
    [([(3, 128, 256)], 1, 1000), ([(3, 128, 256)], 2, 1000), ([(3, 128, 256)], 5, 1000),
     ([(2, 50, 250)], 33, 700), ([(2, 128, 130)], 40, 500), ([(1, 1, 128)], 2, 300),
     ([(4, 128, 640)], 32, 3000),
     ([(2, 128, 256), (3, 128, 640), (1, 128, 384)], 32, 2000)],
)
def test_banded_kernel_matches_plain(dev, segments, C, F):
    plan = [_segment(nb, tr, span, F, dev) for nb, tr, span in segments]
    if len(plan) > 1:
        plan[-1]["rows"] = 77
    x = torch.from_numpy(RNG.standard_normal((F, C)).astype(np.float32)).to(dev)
    before = cuda_banded.launches
    got = banded.banded_apply(plan, x)
    want = banded.banded_plan_plain(plan, x)
    torch.cuda.synchronize()
    assert cuda_banded.launches == before + 1
    assert got.shape == want.shape == (sum(seg["rows"] for seg in plan), C)
    # fp32 dot products of up to 640 terms in two summation orders: within
    # 1e-5 of the sum of the terms' magnitudes (sqrt(640)·2^-24 ≈ 1.5e-6 per
    # order, typically)
    scale = banded.banded_plan_plain(
        [dict(seg, slab=seg["slab"].abs()) for seg in plan], x.abs())
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_banded_wrapper_keeps_a_device_plans_launch_args(dev):
    host = [{"rows": 300, "offsets": np.array([0, 40, 90], np.int32),
             "slab": RNG.standard_normal((3, 128, 256)).astype(np.float32)}]
    plan = banded.plan_to_torch(host, dev)
    assert plan.launch_args is None
    x = torch.from_numpy(RNG.standard_normal((400, 3)).astype(np.float32)).to(dev)
    first = cuda_banded.banded_matmul_cuda(plan, x)
    args = plan.launch_args
    assert args is not None
    second = cuda_banded.banded_matmul_cuda(plan, x * 2)
    assert plan.launch_args is args
    torch.cuda.synchronize()
    assert torch.equal(second, 2 * first)
    # the JAX package's Pallas-vs-XLA tolerance, as for the ragged shapes
    assert float((first - banded.banded_plan_plain(plan, x)).abs().max()) <= 1e-4


def test_banded_kernel_reads_past_x_as_zero(dev):
    seg = {"rows": 4, "span": 256, "slab": torch.ones((1, 4, 256), device=dev),
           "offsets": torch.tensor([50], dtype=torch.int32, device=dev)}
    got = cuda_banded.banded_matmul_cuda([seg], torch.ones((100, 2), device=dev))
    assert torch.equal(got, torch.full((4, 2), 50.0, device=dev))


def test_banded_kernel_at_the_path_plan(dev):
    """The plan of the measurement path's grid (32,769 bins, 1/3 octave:
    six segments, 633 MB of slab) on 32 columns."""
    freqs = np.fft.rfftfreq(65536, 1 / 48000)
    key = tf_backend._plan_key(freqs, 3, Window.Hann(3000, True))
    plan = tf_backend.device_banded_plan(key, torch.float32, dev)
    assert [seg["span"] for seg in plan] == [640, 1152, 2048, 3968, 6912, 3584]
    x = torch.from_numpy(
        RNG.standard_normal((32769 + 6912, 32)).astype(np.float32)).to(dev)
    got = cuda_banded.banded_matmul_cuda(plan, x)
    want = banded.banded_plan_plain(plan, x)
    torch.cuda.synchronize()
    assert got.shape == (32769, 32)
    assert float((got - want).abs().max()) <= 1e-5


def test_banded_kernel_keeps_float32_sums_of_large_values(dev):
    """Weights summing to 1 over the path plan's longest band (6912) on x ≈
    5,000, the size of a smoothed unwrapped phase: within twice the float32
    sum's random walk, 2·2^-24·|x|·sqrt(SPAN), of the float64 sum (a sum
    kept in the tensor cores' accumulator drifts past it)."""
    rng = np.random.default_rng(6912)
    nb, tr, span = 2, 128, 6912
    w = rng.uniform(0.0, 1.0, (nb, tr, span))
    slab = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    offsets = np.array([0, 100], np.int32)
    x = (5000.0 + rng.standard_normal((span + 100, 4))).astype(np.float32)
    seg = {"rows": nb * tr, "span": span, "slab": torch.from_numpy(slab).to(dev),
           "offsets": torch.from_numpy(offsets).to(dev)}
    got = cuda_banded.banded_matmul_cuda([seg], torch.from_numpy(x).to(dev)).cpu().numpy()
    xg = x.astype(np.float64)[offsets[:, None] + np.arange(span)]
    want = np.einsum("bts,bsc->btc", slab.astype(np.float64), xg).reshape(-1, 4)
    assert np.abs(got - want).max() <= 2 * 2.0**-24 * 5000 * np.sqrt(span)


def test_banded_kernel_at_a_sixth_octave_plan(dev):
    """The 1/6-octave plan of the measurement path's grid (32,769 bins) on
    32 columns, in one launch."""
    freqs = np.fft.rfftfreq(65536, 1 / 48000)
    key = tf_backend._plan_key(freqs, 6, Window.Hann(3000, True))
    plan = tf_backend.device_banded_plan(key, torch.float32, dev)
    span = max(seg["span"] for seg in plan)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (32769 + span, 32)).astype(np.float32)).to(dev)
    before = cuda_banded.launches
    got = banded.banded_apply(plan, x)
    want = banded.banded_plan_plain(plan, x)
    torch.cuda.synchronize()
    assert cuda_banded.launches == before + 1
    assert got.shape == (32769, 32)
    assert float((got - want).abs().max()) <= 1e-5


def test_banded_switch_on_card(dev):
    seg = _segment(1, 128, 128, 256, dev)
    x = torch.ones(256, 2, device=dev)
    before = cuda_banded.launches
    _config.set_banded_kernel("on")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            banded.banded_apply([{k: (v.cpu() if torch.is_tensor(v) else v)
                                  for k, v in seg.items()}], x.cpu())
        with pytest.raises(ValueError, match="float32"):
            banded.banded_apply([dict(seg, slab=seg["slab"].double())], x.double())
    finally:
        _config.set_banded_kernel("auto")
    _config.set_banded_kernel("off")
    try:
        out = banded.banded_apply([seg], x)
    finally:
        _config.set_banded_kernel("auto")
    assert cuda_banded.launches == before and out.is_cuda
    # float64 under "auto": the plain version
    banded.banded_apply([dict(seg, slab=seg["slab"].double())], x.double())
    assert cuda_banded.launches == before


@pytest.mark.parametrize("domain", ["RealImaginary", "Magnitude", "EquivalentComplex"])
def test_complex_smoothing_on_card_matches_cpu(dev, domain):
    t = np.arange(16384)
    td = 0.1 * RNG.standard_normal((16384, 3)) * np.exp(-t / 500.0)[:, None]
    td[30] += 0.9
    got_spec = {}
    for where in ("cpu", dev):
        ir = ImpulseResponse(None, torch.from_numpy(td.astype(np.float32)).to(where), 48000)
        before = cuda_banded.launches
        got_spec[str(where)] = complex_smoothing(ir, 3, getattr(SmoothingDomain, domain))
        assert (cuda_banded.launches == before) == (where == "cpu")
    got = got_spec[str(dev)].spectral_data
    assert got.is_cuda and got.shape == (8193, 3)
    assert _rel(got, got_spec["cpu"].spectral_data) <= 1e-4


def _complex_bank(n_bands, sections, radius=0.95):
    poles = radius * np.exp(1j * np.linspace(0.1, 1.0, n_bands * sections))
    bank = np.zeros((n_bands, sections, 6), np.complex128)
    bank[:, :, 0] = 0.3
    bank[:, :, 3] = 1.0
    bank[:, :, 4] = -poles.reshape(n_bands, sections)
    return bank


def _real_bank(n_bands, sections):
    return np.stack([
        np.concatenate([butter(2, f, output="sos")
                        for f in np.linspace(0.05 + 0.02 * b, 0.8, sections)])
        for b in range(n_bands)
    ])


# (bank, R, T): B = 1 and 5 complex; R = 1 and 3; T = 3000 and 5000 (not
# multiples of 128); a 16-section real bank (32 state lanes, the kernel's
# widest); a 6-section complex bank (24 lanes); a 1-section real bank (2
# lanes); the 4-band crossover of the headline chain; a short input (T =
# 1000, 7 blocks)
_B3_CASES = {
    "real1-B3-R2-T3000": (_real_bank(3, 1), 2, 3000),
    "complex-B2-R2-T1000": (_complex_bank(2, 4), 2, 1000),
    "complex-B1-R1-T3000": (_complex_bank(1, 4), 1, 3000),
    "complex-B5-R3-T5000": (_complex_bank(5, 4), 3, 5000),
    "real16-B2-R3-T3000": (_real_bank(2, 16), 3, 3000),
    "complex6-B3-R1-T5000": (_complex_bank(3, 6), 1, 5000),
    "crossover-B4-R2-T5000": (headline._stacked_bank(48000), 2, 5000),
}


@pytest.mark.parametrize("case", list(_B3_CASES))
def test_bank_kernel_matches_plain(dev, case):
    bank, R, T = _B3_CASES[case]
    x = torch.from_numpy(RNG.standard_normal((R, T)).astype(np.float32)).to(dev)
    ops, rest = iir_block.bank_kernel_stages(bank, T, dev)
    assert not rest
    P = 2 if np.iscomplexobj(bank) else 1
    lead = ops["n_full"] * ops["L"]
    out_k = torch.zeros((P, len(bank), R, T), device=dev)
    out_p = torch.zeros_like(out_k)
    before = cuda_iir_bank.launches
    s_k = cuda_iir_bank.sosfilt_bank_lead_cuda(ops, x, out_k)
    s_p = cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out_p)
    torch.cuda.synchronize()
    assert cuda_iir_bank.launches == before + 1
    yk, yp = out_k[..., :lead], out_p[..., :lead]
    # the kernel sums x·H in another order than cuBLAS (fp32) and walks the
    # fp64 state chain where the plain version doubles: B2's tolerances
    assert float((yk - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert float((s_k - s_p).abs().max()) <= 1e-6 * max(1.0, float(s_p.abs().max()))
    # the untouched tail stays as it was
    assert not bool(out_k[..., lead:].any())


@pytest.mark.parametrize(
    "bank", [_complex_bank(2, 9, 0.9), _real_bank(2, 18)], ids=["complex9", "real18"]
)
def test_bank_split_on_card_matches_scipy(dev, bank):
    """A cascade beyond the kernel's 32 lanes (9 complex or 18 real
    sections) runs its first 8 / 16 sections through one B3 launch on the
    shared input and the rest through one more B3 launch per band."""
    T = 3000 + 77
    x = RNG.standard_normal((2, T)).astype(np.float32)
    ops = iir_block.bank_device_operators(bank, T, torch.float32, dev)
    before = (cuda_iir_bank.launches, cuda_iir.launches)
    y = iir_block.sosfilt_bank_apply(ops, torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert cuda_iir_bank.launches == before[0] + 1 + len(bank)
    assert cuda_iir.launches == before[1]
    for b in range(len(bank)):
        assert _rel(y[b], sosfilt(bank[b], x.astype(np.float64))) < 5e-6


def test_bank_apply_on_card_matches_scipy_and_cpu(dev):
    """The 1/3-octave bank's lowest bands at 44.1 kHz (poles within 2e-3 of
    the unit circle) against scipy's float64 sosfilt; planes are views of
    one buffer; "on" refuses a CPU tensor and "off" launches nothing."""
    from dsptoolbox_tpu_torch.filterbanks import fractional_octave_bands

    fb = fractional_octave_bands([31.5, 100.0], 3, 6, 44100)[0]
    bank = np.stack([f.sos for f in fb.filters])
    x = RNG.standard_normal((2, 44100 + 33)).astype(np.float32)
    ops = iir_block.bank_device_operators(bank, x.shape[-1], torch.float32, dev)
    before = cuda_iir_bank.launches
    re, im = iir_block.sosfilt_bank_apply_planes(ops, torch.from_numpy(x).to(dev))
    assert cuda_iir_bank.launches == before + 1 and im is None
    for b in range(len(bank)):
        assert _rel(re[b], sosfilt(bank[b], x.astype(np.float64))) < 5e-6
    _config.set_bank_kernel("on")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            iir_block.sosfilt_bank_apply(
                iir_block.bank_device_operators(bank, x.shape[-1], torch.float32, "cpu"),
                torch.from_numpy(x))
    finally:
        _config.set_bank_kernel("auto")
    with _config.kernels_off():
        off = iir_block.sosfilt_bank_apply(ops, torch.from_numpy(x).to(dev))
    assert cuda_iir_bank.launches == before + 1
    assert _rel(off, re) <= 1e-5


def test_third_octave_bank_on_card_matches_scipy(dev):
    """The 28-band ANSI 1/3-octave bank at 44.1 kHz (31.5 Hz-16 kHz, 6
    sections) through B3: every band within 5e-6 of scipy's float64 sosfilt,
    scale-relative. The low bands are where the 3×TF32 split of x·h and the
    fp64 state path must hold."""
    from dsptoolbox_tpu_torch.filterbanks import fractional_octave_bands

    fb = fractional_octave_bands([31.5, 16e3], 3, 6, 44100)[0]
    bank = np.stack([f.sos for f in fb.filters])
    assert bank.shape == (28, 6, 6)
    x = RNG.standard_normal((2, 44100)).astype(np.float32)
    ops = iir_block.bank_device_operators(bank, x.shape[-1], torch.float32, dev)
    assert cuda_iir_bank.output_pass(ops["L"]) == "mma"
    before = cuda_iir_bank.launches
    y = iir_block.sosfilt_bank_apply(ops, torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert cuda_iir_bank.launches == before + 1
    for b in range(len(bank)):
        assert _rel(y[b], sosfilt(bank[b], x.astype(np.float64))) < 5e-6, f"band {b}"


def test_bank_route_takes_the_kernel_at_any_length_and_refuses_other_dtypes(dev):
    """On the card every float32 input runs B3, however few its blocks (a
    1024-sample impulse response of a FilterBank); a float64 input raises
    unless the switch is "off"."""
    from dsptoolbox_tpu_torch.classes import Filter, FilterBank
    from dsptoolbox_tpu_torch.standard.enums import FilterBankMode

    fb = FilterBank([Filter.from_sos(s, 48000) for s in headline.crossover_bank(48000)])
    before = cuda_iir_bank.launches
    ir = fb.get_ir(1024, FilterBankMode.Parallel, device=dev)
    assert cuda_iir_bank.launches == before + 1
    imp = np.zeros(1024)
    imp[0] = 1.0
    for b, sos in enumerate(headline.crossover_bank(48000)):
        assert _rel(ir.bands[b].time_data[:, 0], sosfilt(sos, imp)) < 5e-6
    bank = headline._stacked_bank(48000)
    x = torch.from_numpy(RNG.standard_normal((2, 3000))).to(dev)
    ops = iir_block.sosfilt_bank_operators(bank, 3000)
    with pytest.raises(TypeError, match="float32"):
        iir_block.sosfilt_bank_apply(ops, x)
    _config.set_bank_kernel("off")
    try:
        y = iir_block.sosfilt_bank_apply(ops, x)
    finally:
        _config.set_bank_kernel("auto")
    assert y.dtype == torch.float64 and cuda_iir_bank.launches == before + 1
    for b in range(len(bank)):
        assert _rel(y[b], sosfilt(bank[b], x.cpu().numpy())) < 1e-9


@pytest.mark.parametrize("L", [8, 13, 64, 100, 200, 300])
def test_bank_kernel_block_lengths(dev, L):
    """Block lengths other than 128: below it on the tensor cores (13 and
    100 not multiples of 8: x and h zero-padded), two and three column
    tiles above it on the CUDA cores, where x's tile is streamed through
    shared memory."""
    bank = _complex_bank(2, 4)
    T = 17 * L + 9
    x = torch.from_numpy(RNG.standard_normal((2, T)).astype(np.float32)).to(dev)
    ops = iir_block.operators_to_torch(
        iir_block.sosfilt_bank_operators(bank, T, block_size=L), dev, torch.complex64)
    out_k = torch.zeros((2, 2, 2, T), device=dev)
    out_p = torch.zeros_like(out_k)
    s_k = cuda_iir_bank.sosfilt_bank_lead_cuda(ops, x, out_k)
    s_p = cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out_p)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) <= 1e-5 * float(out_p.abs().max())
    assert float((s_k - s_p).abs().max()) <= 1e-6 * max(1.0, float(s_p.abs().max()))


def test_ism_lattice_on_card_matches_host_oracle(dev):
    """The float64 image lattice on the card places every image in the
    host float64 oracle's bin (max_order 14 at 44.1 kHz, and a fleet of 3
    pairs at 16 kHz); values within 2e-7·max."""
    from dsptoolbox_tpu_torch.room_acoustics import _backend as ra_bk
    from dsptoolbox_tpu_torch.room_acoustics import batch_synthetic_rirs
    from dsptoolbox_tpu_torch.tools import room_measurement as rm

    room = rm.room()
    b1, b2 = ra_bk.wall_reflection_factors(room.absorption_coefficient)
    s, r = rm.fleet_positions(3, seed=2)
    cases = [(44100, 14, np.array([[1.23, 2.17, 1.31]]), np.array([[4.29, 1.17, 1.63]]))]
    cases += [(16000, 12, s, r)]
    for fs, mo, s, r in cases:
        limit, n = ra_bk.ism_limits(room.dimensions_m, room.t60_s, mo, fs)
        got = ra_bk.ism_lattice(room.dimensions_m, b1, b2, s, r, fs, limit, n, dev).cpu().numpy()
        for p in range(len(s)):
            want = ra_bk.generate_rir_host(room.dimensions_m, b1, b2, s[p], r[p], fs,
                                           ra_bk.SPEED_OF_SOUND, limit, n, "cpu").numpy()
            np.testing.assert_array_equal(np.nonzero(got[p])[0], np.nonzero(want)[0])
            assert np.max(np.abs(got[p] - want)) <= 2e-7 * np.max(np.abs(want))
    old = _config.default_device()
    _config.set_default_device(dev)
    try:
        fleet = batch_synthetic_rirs(room, s, r, 16000, max_order=12)
    finally:
        _config.set_default_device(old)
    assert fleet.is_cuda and tuple(fleet.shape) == (3, 8000)
    fleet = fleet.cpu().numpy()
    np.testing.assert_array_equal(np.argwhere(fleet), np.argwhere(got[:, :8000]))
    assert np.max(np.abs(fleet - got[:, :8000])) <= 1e-7 * np.max(np.abs(got))


@pytest.mark.parametrize("fs,max_order,n_pairs", [(44100, 14, 1), (16000, None, 4)])
def test_ism_images_on_card_match_host_oracle_per_image(dev, fs, max_order, n_pairs):
    """Every image of the float64 lattice on the card (`_backend.ism_images`;
    max_order 14 at 44.1 kHz, and 4 fleet pairs at the fleet's LIMIT 40
    on the cells within reach of 0.5 s) holds the host float64 oracle's
    sample index exactly (`_host_group_images` on the same cells), and its
    value within 1e-12 relative."""
    from dsptoolbox_tpu_torch.room_acoustics import _backend as ra_bk
    from dsptoolbox_tpu_torch.tools import room_measurement as rm

    room = rm.room()
    dim = np.asarray(room.dimensions_m, np.float64)
    b1, b2 = ra_bk.wall_reflection_factors(room.absorption_coefficient)
    if n_pairs == 1:
        s, r = np.array([[1.23, 2.17, 1.31]]), np.array([[4.29, 1.17, 1.63]])
        reach = None
    else:
        s, r = rm.fleet_positions(n_pairs, seed=5)
        reach = int(fs * rm.FLEET_SECONDS)
    limit, _ = ra_bk.ism_limits(dim, room.t60_s, max_order, fs)
    n_images = 0
    for lv, idx, vals in ra_bk.ism_images(dim, b1, b2, s, r, fs, limit, dev):
        keep = torch.ones(idx.shape[:2], dtype=torch.bool, device=dev) if reach is None \
            else (idx <= reach).any(-1)
        for p in range(len(s)):
            cells = lv[keep[p]].cpu().numpy()
            if len(cells) == 0:
                continue
            want_idx, want_vals = ra_bk._host_group_images(cells, dim, b1, b2, s[p], r[p], fs,
                                                           ra_bk.SPEED_OF_SOUND)
            np.testing.assert_array_equal(idx[p][keep[p]].cpu().numpy().reshape(-1), want_idx)
            np.testing.assert_allclose(vals[p][keep[p]].cpu().numpy().reshape(-1), want_vals,
                                       rtol=1e-12, atol=0)
            n_images += want_idx.size
    assert n_images > 0


def test_room_octave_bank_and_bass_ratio_launch_kernels(dev):
    """The measured-room step on the card: its octave bank goes through B3
    (one launch), its bass ratio's zero-phase bands through B2 (two leads a
    band); octave bands within 5e-6 of scipy's float64 sosfilt, the bass
    ratio's bands within 5e-6 of scipy's float64 sosfiltfilt and 2e-5 of
    the plain paths (scale-relative)."""
    from scipy.signal import sosfiltfilt

    from dsptoolbox_tpu_torch.room_acoustics.room_acoustics import _bass_ratio_bank
    from dsptoolbox_tpu_torch.standard.enums import FilterBankMode
    from dsptoolbox_tpu_torch.tools import measurement
    from dsptoolbox_tpu_torch.tools import room_measurement as rm

    x = (measurement.room_irs()[0][:, :2] * 0.9).astype(np.float32)
    ir = ImpulseResponse(None, x, measurement.FS, device=dev)
    bank = rm.octave_bank(measurement.FS)
    b2, b3 = cuda_iir.launches, cuda_iir_bank.launches
    out = rm.measured_room(ir, bank)
    torch.cuda.synchronize()
    assert cuda_iir_bank.launches == b3 + 1
    assert cuda_iir.launches == b2 + 8
    for f, band in zip(bank.filters, out["bands"].bands):
        want = sosfilt(f.sos, x.astype(np.float64), axis=0)
        assert _rel(band.time_data, want) <= 5e-6
    assert all(np.all(np.isfinite(v)) for v in out["rt"].values())
    octs = _bass_ratio_bank(measurement.FS)
    b2 = cuda_iir.launches
    zero_phase = octs.filter_signal(ir, FilterBankMode.Parallel, zero_phase=True)
    torch.cuda.synchronize()
    assert cuda_iir.launches == b2 + 2 * len(octs.filters)
    with _config.kernels_off():
        zp = octs.filter_signal(ir, FilterBankMode.Parallel, zero_phase=True)
    for f, band, band_p in zip(octs.filters, zero_phase.bands, zp.bands):
        want = np.ascontiguousarray(sosfiltfilt(f.sos, x.astype(np.float64), axis=0))
        assert _rel(band.time_data, want) <= 5e-6
        assert _rel(band.time_data, band_p.time_data.cpu().numpy()) <= 2e-5


@pytest.mark.parametrize("band", [(31.5, 1, 6, 48000), (63, 1, 4, 48000), (25, 3, 4, 44100)],
                         ids=lambda b: f"{b[0]}Hz-1/{b[1]}")
def test_low_bands_through_b2_meet_scipy_float64(dev, band):
    """C6 on the card: the float32 zero-phase filter (two B2 leads) at T =
    4096 and 16,384 and the streamed filter (16 chunks of 1024 samples, a B2
    launch each, the float64 state carried) within 5e-6 of scipy's float64
    ``sosfiltfilt`` / ``sosfilt``, scale-relative."""
    from scipy.signal import sosfiltfilt

    from dsptoolbox_tpu_torch import filterbanks
    from dsptoolbox_tpu_torch.ops import iir

    fc, fraction, order, fs = band
    fb, _, _ = filterbanks.fractional_octave_bands([fc, fc * 1.01], fraction, order, fs)
    sos = np.asarray(fb.filters[0].sos)
    for T in (4096, 16384):
        x = (0.1 * np.random.default_rng(1).standard_normal((2, T))).astype(np.float32)
        before = cuda_iir.launches
        y = iir.sosfiltfilt(sos, torch.from_numpy(x).to(dev))
        torch.cuda.synchronize()
        assert cuda_iir.launches == before + 2 and y.dtype == torch.float32
        assert _rel(y, np.ascontiguousarray(sosfiltfilt(sos, x.astype(np.float64), axis=-1))) <= 5e-6
    zi = np.tile(sosfilt_zi(sos)[None], (2, 1, 1))
    state, parts = zi, []
    before = cuda_iir.launches
    for k in range(16):
        y, state = iir.sosfilt(sos, torch.from_numpy(x[:, k * 1024:(k + 1) * 1024]).to(dev),
                               zi=state)
        parts.append(y)
    torch.cuda.synchronize()
    assert cuda_iir.launches == before + 16 and state.dtype == torch.float64
    want = sosfilt(sos, x.astype(np.float64), axis=-1, zi=np.moveaxis(zi, 0, 1))[0]
    assert _rel(torch.cat(parts, dim=-1), want) <= 5e-6


def test_config2_chain_and_standard_on_card_match_cpu(dev):
    """Config 2's chain (`tools.speech_chain`, 2 channels × 1 s) through B1
    and the standard functions that reach B2 (`lufs_integrated`'s
    K-weighting at 3.2 s, the activity detector's zero-phase pre-filter)
    against the same calls on the CPU."""
    from dsptoolbox_tpu_torch import generators, standard
    from dsptoolbox_tpu_torch.classes import Filter
    from dsptoolbox_tpu_torch.standard.enums import FilterPassType
    from dsptoolbox_tpu_torch.tools import speech_chain

    x = speech_chain.signal(2, 1.0).time_data  # on the default device, the card
    gpu = Signal(None, x, speech_chain.FS)
    cpu = Signal(None, x.cpu(), speech_chain.FS)
    for s in (gpu, cpu):
        s.set_spectrogram_parameters(window_length_samples=speech_chain.WINDOW)
    b1 = cuda_framing.launches
    got = speech_chain.run(gpu)
    torch.cuda.synchronize()
    assert cuda_framing.launches >= b1 + 3  # STFT, Welch, Welch CSM
    want = speech_chain.run(cpu)
    for g, w in ((got[0].time_data, want[0].time_data), (got[1], want[1]), (got[2], want[2])):
        assert _rel(g, w) <= 2e-5
    np.testing.assert_allclose(got[0].time_data.cpu().numpy(), x.cpu().numpy(), atol=1e-5)
    sine = generators.oscillator(997, 48000, 3.2, peak_level_dbfs=0.0)
    b2 = cuda_iir.launches
    lufs = standard.lufs_integrated(sine)
    assert cuda_iir.launches == b2 + 1
    np.testing.assert_allclose(lufs, -3.01, atol=0.07)
    hp = Filter.iir_filter(4, 80.0, FilterPassType.Highpass, 48000)
    b2 = cuda_iir.launches
    _, on_card = standard.activity_detector(gpu, pre_filter=hp)
    assert cuda_iir.launches == b2 + 2
    _, on_cpu = standard.activity_detector(cpu, pre_filter=hp)
    assert np.mean(on_card["signal_indices"] != on_cpu["signal_indices"]) <= 1e-3

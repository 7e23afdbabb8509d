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

from crossover_chain import lr_chain
from dsptoolbox_tpu_torch import _config, headline
from dsptoolbox_tpu_torch import beamforming as bf
from dsptoolbox_tpu_torch.classes import Signal
from dsptoolbox_tpu_torch.classes import ImpulseResponse
from dsptoolbox_tpu_torch.ops import (
    banded, cuda_banded, cuda_csm, cuda_das, cuda_ema, cuda_framing, cuda_iir, cuda_iir_bank,
    iir_block, spectral,
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


def _spectra(dev, C, K, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, K, F)) + 1j * rng.standard_normal((C, K, F))
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


# (C, K, F) of the CSM's Gram kernel: every C of 1, 2, 16, 32, 33, 64, K of
# 1, 7, 936, 5624 and F of 5, 513, 4097, with channels off the tile (8) and
# super-tile (32) edges, bins off the warp's 32, and frames off the stage's
# 4; the session's (32, 5624, 513) and the camera's (64, 936, 513)
_GRAM_CASES = [(1, 1, 5), (2, 7, 513), (16, 936, 513), (32, 5624, 513), (33, 7, 4097),
               (64, 936, 513), (64, 7, 4097), (33, 936, 5), (2, 5624, 4097), (1, 5624, 513),
               (16, 1, 4097), (64, 1, 5)]


@pytest.mark.parametrize("C,K,F", _GRAM_CASES)
def test_csm_gram_kernel_matches_plain(dev, C, K, F):
    """Both sides sum K fp32 products in their own order, each off by about
    sqrt(K)·2^-24 of sum_k |x_a||x_b| / K, which is at most the largest mean
    power (Cauchy-Schwarz): the tolerance is 8 times that."""
    X = _spectra(dev, C, K, F, C * 7919 + K * 31 + F)
    before = cuda_csm.launches
    got = cuda_csm.gram_mean(X)
    want = cuda_csm.gram_mean_plain(X)
    torch.cuda.synchronize()
    assert cuda_csm.launches == before + 1
    assert got.shape == want.shape == (F, C, C)
    scale = float(want.diagonal(dim1=-2, dim2=-1).real.max())
    tol = 8 * K**0.5 * 2.0**-24 * scale
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("C,K,F", [(32, 936, 513), (3, 7, 33)])
def test_csm_gram_kernel_on_a_misaligned_x(dev, C, K, F):
    """X 8 bytes off 16 (a contiguous view one element into a buffer): every
    row's bins start on the other half of a 16-byte span."""
    base = _spectra(dev, 1, 1, C * K * F + 1, 8).reshape(-1)
    X = base[1:].view(C, K, F)
    got = cuda_csm.gram_mean_cuda(X)
    want = cuda_csm.gram_mean_plain(X)
    scale = float(want.diagonal(dim1=-2, dim2=-1).real.max())
    assert float((got - want).abs().max()) <= 8 * K**0.5 * 2.0**-24 * scale


@pytest.mark.parametrize("C,K,F", [(33, 936, 513), (64, 7, 4097), (2, 1, 5)])
def test_csm_gram_kernel_is_hermitian_with_a_real_diagonal(dev, C, K, F):
    Q = cuda_csm.gram_mean_cuda(_spectra(dev, C, K, F, 5))
    assert torch.equal(Q, Q.mH)
    assert torch.equal(Q.diagonal(dim1=-2, dim2=-1).imag, torch.zeros((F, C), device=dev))


@pytest.mark.parametrize("C,K,F", [(32, 5624, 513), (64, 936, 513), (33, 7, 4097)])
def test_csm_gram_kernel_repeats_bit_for_bit(dev, C, K, F):
    X = _spectra(dev, C, K, F, 6)
    assert torch.equal(cuda_csm.gram_mean_cuda(X), cuda_csm.gram_mean_cuda(X))


def test_csm_welch_launches_the_gram_kernel_once_on_card_only(dev):
    x = RNG.standard_normal((3, 20000)).astype(np.float32)
    kw = dict(sampling_rate_hz=16000, window_length_samples=256)
    before = cuda_csm.launches
    _, got = spectral.csm_welch(torch.from_numpy(x).to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda_csm.launches == before + 1
    _, want = spectral.csm_welch(torch.from_numpy(x), **kw)
    assert cuda_csm.launches == before + 1
    assert _rel(got, want) <= 2e-5
    # complex128 on the card takes the plain version
    Q = cuda_csm.gram_mean(_spectra(dev, 3, 9, 17, 7).to(torch.complex128))
    assert Q.dtype == torch.complex128 and cuda_csm.launches == before + 1


# B2 runs on B3's kernel as one band (N = order lanes): N = 4, 8, 12 and 16
# take the chain's compile-time state sizes, the others its run-time path;
# N < 64 lanes take the fp64 tensor-core x·M pass (1, 2 or 4 lane tiles:
# N <= 8, 16, 32); K = 1 and 2 are the chunked chain's edge cases; L <= 128
# takes the tensor-core output pass, L = 200 and 256 two column tiles of the
# FFMA pass, L >= 512 more, with x·M over several l chunks; a zero start
# state; the chain's shape (16 rows x 3000 blocks of 128, N = 8); N = 18,
# 24 and 32 at L = 128 take the wide route (tiles of 64 blocks: K = 200 is
# three full tiles and a partial one, from a start state)
@pytest.mark.parametrize(
    "order,L,B,K,out_pass,zi_scale",
    [(6, 128, 3, 40, "mma", 1), (4, 98, 2, 17, "mma", 1), (2, 64, 1, 300, "mma", 1),
     (8, 128, 2, 3000, "mma", 1), (18, 128, 2, 40, "mma", 1), (32, 128, 1, 33, "mma", 1),
     (4, 128, 1, 1, "mma", 1), (4, 64, 2, 2, "mma", 1), (4, 3, 2, 50, "mma", 1),
     (8, 200, 2, 20, "ffma", 1), (8, 256, 3, 17, "ffma", 1), (6, 512, 2, 16, "ffma", 1),
     (32, 1024, 2, 16, "ffma", 1), (4, 1000, 1, 5, "ffma", 1), (4, 128, 2, 40, "mma", 0),
     (8, 128, 16, 3000, "mma", 1), (24, 128, 3, 200, "mma", 1)],
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
    before = (cuda_iir.launches, cuda_iir_bank.launches, cuda_iir_bank.state_on_chip)
    yk, zk = cuda_iir.sosfilt_lead_cuda(*args)
    # a lead of 16 states or more at L <= 128 takes the wide route
    wide = cuda_iir_bank.keeps_state_on_chip(L, 1, order)
    assert wide == (order >= 16 and L <= 128)
    assert (cuda_iir.launches, cuda_iir_bank.launches, cuda_iir_bank.state_on_chip) == (
        before[0] + 1, before[1], before[2] + wide)
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
    """Inside `kernels_off` a call through each of the seven dispatchers on
    float32 (complex64) card tensors launches none of the kernels; the same
    calls outside it launch each once."""
    x = torch.from_numpy(RNG.standard_normal((2, 4096)).astype(np.float32)).to(dev)
    win = torch.ones(64, device=dev)
    sos = butter(4, [250.0, 1000.0], btype="bandpass", fs=48000, output="sos")
    bank_ops = iir_block.bank_device_operators(
        np.stack([sos, butter(4, [500.0, 2000.0], btype="bandpass", fs=48000, output="sos")]),
        4096, torch.float32, dev)
    das = _das_args(5, 9, 20, dev)
    seg = _segment(1, 128, 128, 256, dev)
    sig = Signal(None, RNG.standard_normal((4096, 3)).astype(np.float32), 16000, device=dev)
    calls = {
        cuda_framing: lambda: cuda_framing.windowed_frames(x, win, 32, False),
        cuda_iir: lambda: iir_block.sosfilt_block(sos, x),
        cuda_iir_bank: lambda: iir_block.sosfilt_bank_apply(bank_ops, x),
        cuda_das: lambda: cuda_das.das_map(*das),
        cuda_banded: lambda: banded.banded_apply([seg], x.T[:256].contiguous()),
        cuda_ema: lambda: (cuda_ema.ema_attack_release(x, 0.3, 0.01),
                           cuda_ema.ema_average(x, torch.zeros(2, device=dev), 0.3, 0.01)),
        cuda_csm: lambda: sig.get_csm(force_computation=True),
    }

    def counts():
        return [m.launches for m in calls] + [cuda_ema.average_launches]

    before = counts()
    with _config.kernels_off():
        for fn in calls.values():
            fn()
    torch.cuda.synchronize()
    assert counts() == before
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    assert all(after > b for after, b in zip(counts(), before))


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
    got = cuda_das.das_map(*args)  # float64: the plain version
    assert got.dtype == torch.float64 and cuda_das.launches == before
    with _config.kernels_off():
        cuda_das.das_map(*(a.float() for a in args))
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


def _camera_scene(where):
    """A 5 × 5 array at 0.25 m, 64 grid points, 1.5 s of a seeded noise
    monopole plus independent sensor noise (σ = 1e-3), on ``where``."""
    x = np.arange(5) * 0.25
    xx, yy = np.meshgrid(x, x, indexing="ij")
    ma = bf.MicArray(dict(x=xx.flatten(), y=yy.flatten(), z=np.zeros(25)))
    line = np.arange(-0.2, 0.2, 0.05)
    g = bf.Regular2DGrid(line, line, ["x", "y"], value3=0.5)
    noise = (0.3 * np.random.default_rng(11).standard_normal(24000)).astype(np.float32)
    sig = bf.MonopoleSource(Signal(None, torch.from_numpy(noise).to(where), 16000),
                            [0.1, -0.1, 0.5]).get_signals_on_array(ma)
    sensor = np.random.default_rng(3).normal(0.0, 1e-3, tuple(sig.time_data.shape))
    sig = sig.copy_with_new_time_data(
        sig.time_data + torch.as_tensor(sensor, dtype=torch.float32, device=sig.device))
    return sig, ma, g


# each new map: (class, keyword arguments, B5 launches, bound against the CPU)
NEW_MAPS = {
    "mvdr": ("BeamformerMVDR", {}, 0, 1e-4),
    "mvdr_reference": ("BeamformerMVDR", {"solve_on_device": False}, 1, 5e-3),
    "functional": ("BeamformerFunctional", {}, 1, 5e-3),
    "clean_sc": ("BeamformerCleanSC", {}, 1, 5e-3),
    "clean_sc_diagonal_removed": ("BeamformerCleanSC", {"remove_csm_diagonal": True}, 1, 5e-3),
    "orthogonal": ("BeamformerOrthogonal", {"number_eigenvalues": 1}, 0, 1e-3),
}


@pytest.mark.parametrize("name", list(NEW_MAPS))
def test_new_maps_on_card_match_cpu(dev, name):
    """Each new map on the card against the same map on the CPU (the plain
    versions), within the map's bound (scale-relative; Orthogonal at its
    first eigenvalue: the same argmax, the maximum within rtol 1e-3). MVDR's
    reference form inverts C, which turns the card's and the CPU's CSMs (a
    few 1e-8 apart) into maps 1e-1 apart: it is held against the float64
    form of the card's own CSM. MVDR's reference form, Functional and
    CLEAN-SC launch B5 once, the loaded MVDR and Orthogonal never."""
    from scipy.integrate import simpson

    cls, kw, b5, tol = NEW_MAPS[name]
    maps = {}
    for where in ("cpu", dev):
        sig, ma, g = _camera_scene(where)
        sig.get_csm()
        beam = getattr(bf, cls)(sig, ma, g, bf.SteeringVector())
        cuda_das.launches = 0
        maps[str(where)] = beam.get_beamformer_map(2000, 3, **kw)
        torch.cuda.synchronize()
        assert cuda_das.launches == (b5 if where == dev else 0)
    got, want = maps[str(dev)], maps["cpu"]
    assert got.is_cuda and got.shape == (8, 8) and bool(torch.isfinite(got).all())
    if name == "mvdr_reference":
        f, _, C = beam._band_csm(2000, 3)
        h = beam.st_vec.get_vector(f * 2 * np.pi / beam.c, g, ma)
        inv = np.linalg.inv(C.cpu().numpy().astype(np.complex128))
        den = np.einsum("fmg,fmg->gf", np.conj(h), inv @ h).real
        want = torch.from_numpy(simpson(1 / den, dx=f[1] - f[0], axis=1).reshape(8, 8))
    assert int(torch.argmax(got)) == int(torch.argmax(want))
    if name == "orthogonal":
        np.testing.assert_allclose(float(got.max()), float(want.max()), rtol=tol)
    else:
        assert _rel(got, want) <= tol


def test_clean_sc_device_loop_on_card_matches_host_oracle(dev):
    """CLEAN-SC's batched loop on the card against the host per-bin loop,
    rtol 1e-3, atol 1e-5 of the maximum."""
    sig, ma, g = _camera_scene(dev)
    beam = bf.BeamformerCleanSC(sig, ma, g, bf.SteeringVector())
    got = beam.get_beamformer_map(2000, 3).cpu().numpy()
    _config.set_clean_sc_on_device(False)
    try:
        want = beam.get_beamformer_map(2000, 3).cpu().numpy()
    finally:
        _config.set_clean_sc_on_device(True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * np.abs(want).max())


def test_das_time_on_card_matches_cpu(dev):
    outs = {}
    for where in ("cpu", dev):
        sig, ma, _ = _camera_scene(where)
        line = bf.LineGrid(np.arange(-0.3, 0.3, 0.05), "x", -0.1, 0.5)
        outs[str(where)] = bf.BeamformerDASTime(sig, ma, line).get_beamformer_output().time_data
    assert outs[str(dev)].is_cuda
    assert _rel(outs[str(dev)], outs["cpu"]) <= 1e-4


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
    with _config.kernels_off():
        out = banded.banded_apply([seg], x)
    assert cuda_banded.launches == before and out.is_cuda
    # float64: the plain version
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


def _fb_banks() -> dict:
    """The filter-bank cell's two banks at 44.1 kHz: the 16-band 500-4000 Hz
    gammatone bank (complex, 16 lanes a band: 256 band-lanes) and the
    28-band 1/3-octave bank (6 real sections, 12 lanes: 336)."""
    from dsptoolbox_tpu_torch.classes.filterbank import _sos_bank_or_none
    from dsptoolbox_tpu_torch.filterbanks import (
        auditory_filters_gammatone, fractional_octave_bands,
    )

    return {
        "gammatone": _sos_bank_or_none(
            auditory_filters_gammatone([500.0, 4000.0], sampling_rate_hz=44100).filters),
        "third": np.stack([f.sos for f in
                           fractional_octave_bands([31.5, 16e3], 3, 6, 44100)[0].filters]),
    }


_FB_BANKS = _fb_banks()

# (bank, R, T): B = 1 and 5 complex; R = 1 and 3; T = 3000 and 5000 (not
# multiples of 128); a 16-section real bank (32 state lanes, the kernel's
# widest); a 6-section complex bank (24 lanes); a 1-section real bank (2
# lanes); the 4-band crossover of the headline chain; a short input (T =
# 1000, 7 blocks); the filter-bank cell's two banks (the wide route, which
# keeps the block states on the chip in tiles of 64 blocks) at K = 1, 63,
# 64, 65 and 130 blocks of 128 and a 77-sample tail (one partial tile, one
# exact, one and two straddled), and at one block of 100 (not a multiple
# of 8); 8 bands of 8 lanes (an octave bank's shape, the wide route's
# smallest compile-time state size) and 16 bands of 4 lanes (64 band-lanes
# on the three passes: 4 lanes a band stay there) at K = 65. Of the first
# cases, complex-B1 (16 band-lanes), complex-B2 (32), complex-B5 (80),
# real16-B2 (64), complex6-B3 (72) and the crossover (32) take the wide
# route too (8 lanes a band and 16 in all, or more); real1-B3 (2 lanes a
# band) the three passes, which wide banks take at blocks above 128
# (`test_bank_kernel_block_lengths`)
_B3_CASES = {
    "real1-B3-R2-T3000": (_real_bank(3, 1), 2, 3000),
    "complex-B2-R2-T1000": (_complex_bank(2, 4), 2, 1000),
    "complex-B1-R1-T3000": (_complex_bank(1, 4), 1, 3000),
    "complex-B5-R3-T5000": (_complex_bank(5, 4), 3, 5000),
    "real16-B2-R3-T3000": (_real_bank(2, 16), 3, 3000),
    "complex6-B3-R1-T5000": (_complex_bank(3, 6), 1, 5000),
    "crossover-B4-R2-T5000": (headline._stacked_bank(48000), 2, 5000),
    **{f"fb-{name}-R3-K{K}": (bank, 3, 128 * K + 77)
       for name, bank in _FB_BANKS.items() for K in (1, 63, 64, 65, 130)},
    "fb-gammatone-R3-T100": (_FB_BANKS["gammatone"], 3, 100),
    "real2-B16-R3-K65": (_real_bank(16, 2), 3, 128 * 65 + 77),
    "real4-B8-R3-K65": (_real_bank(8, 4), 3, 128 * 65 + 77),
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
    before = (cuda_iir_bank.launches, cuda_iir_bank.state_on_chip)
    s_k = cuda_iir_bank.sosfilt_bank_lead_cuda(ops, x, out_k)
    s_p = cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out_p)
    torch.cuda.synchronize()
    # 8 lanes a band and 16 in all, or more, keep the states on the chip;
    # the narrow cases do not
    wide = cuda_iir_bank.keeps_state_on_chip(ops["L"], len(bank), ops["kernel"]["lanes"])
    assert wide == (case not in ("real1-B3-R2-T3000", "real2-B16-R3-K65"))
    if case.startswith("fb-"):
        assert wide and len(bank) * ops["kernel"]["lanes"] in (256, 336)
    assert (cuda_iir_bank.launches, cuda_iir_bank.state_on_chip) == (before[0] + 1,
                                                                      before[1] + wide)
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
    one buffer; `kernels_off` launches nothing."""
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


@pytest.mark.parametrize("freqs", [(250.0, 1000.0, 4000.0), (1000.0,)],
                         ids=["config3-wide", "one-crossover-narrow"])
def test_lr_split_on_card_is_one_bank_launch(dev, freqs):
    """The Linkwitz-Riley split (LR4, 8 × 441,000 float32 at 44.1 kHz) is
    one B3 launch in Parallel and in Summed mode: config 3's four bands (12
    lanes a band) on the wide route, one crossover's two bands (4 lanes a
    band, `combine_ir_with_dirac`'s bank) on the three passes. Every band is
    within 1e-5 of its peak of scipy's float64 LP/HP/all-pass chain and of
    the `kernels_off` route (frequency sampling); the sum within 1e-5 of
    the chain's."""
    from dsptoolbox_tpu_torch.filterbanks import linkwitz_riley_crossovers
    from dsptoolbox_tpu_torch.standard.enums import FilterBankMode

    lr = linkwitz_riley_crossovers(list(freqs), [4] * len(freqs), 44100)
    x = (RNG.standard_normal((441000, 8)) * 0.3).astype(np.float32)
    sig = Signal(None, x, 44100, device=dev)
    wide = len(freqs) == 3
    got = {}
    for mode in (FilterBankMode.Parallel, FilterBankMode.Summed):
        before = (cuda_iir_bank.launches, cuda_iir_bank.state_on_chip, cuda_iir.launches)
        got[mode] = lr.filter_signal(sig, mode)
        torch.cuda.synchronize()
        assert (cuda_iir_bank.launches, cuda_iir_bank.state_on_chip, cuda_iir.launches) == (
            before[0] + 1, before[1] + wide, before[2])
    with _config.kernels_off():
        off = lr.filter_signal(sig, FilterBankMode.Parallel)
    want = lr_chain(lr, x.T.astype(np.float64))
    bands = got[FilterBankMode.Parallel].bands
    assert len(bands) == len(want) == len(freqs) + 1
    for b, (band, band_off, w) in enumerate(zip(bands, off.bands, want)):
        assert _rel(band.time_data.T, w) <= 1e-5, f"band {b} vs scipy"
        assert _rel(band.time_data, band_off.time_data) <= 1e-5, f"band {b} vs kernels_off"
    assert _rel(got[FilterBankMode.Summed].time_data.T, np.sum(want, axis=0)) <= 1e-5


def test_bank_route_takes_the_kernel_at_any_length_and_refuses_other_dtypes(dev):
    """On the card every float32 input runs B3, however few its blocks (a
    1024-sample impulse response of a FilterBank); a float64 input takes the
    plain version, with the CPU's float64 result."""
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
    y = iir_block.sosfilt_bank_apply(ops, x)
    assert y.is_cuda and y.dtype == torch.float64 and cuda_iir_bank.launches == before + 1
    assert _rel(y, iir_block.sosfilt_bank_apply(ops, x.cpu())) < 1e-9
    for b in range(len(bank)):
        assert _rel(y[b], sosfilt(bank[b], x.cpu().numpy())) < 1e-9


@pytest.mark.parametrize("L", [8, 13, 64, 100, 200, 300])
def test_bank_kernel_block_lengths(dev, L):
    """Block lengths other than 128: below it on the tensor cores (13 and
    100 not multiples of 8: x and h zero-padded), two and three column
    tiles above it on the CUDA cores, where x's tile is streamed through
    shared memory. Two banks of 4 complex sections: 2 bands (32
    band-lanes) and 5 (80); above 128 both take the three passes (x·M for
    80 lanes in chunks of 64 on the CUDA cores), below it the wide route."""
    T = 17 * L + 9
    x = torch.from_numpy(RNG.standard_normal((2, T)).astype(np.float32)).to(dev)
    for n_bands in (2, 5):
        ops = iir_block.operators_to_torch(
            iir_block.sosfilt_bank_operators(_complex_bank(n_bands, 4), T, block_size=L), dev,
            torch.complex64)
        out_k = torch.zeros((2, n_bands, 2, T), device=dev)
        out_p = torch.zeros_like(out_k)
        before = cuda_iir_bank.state_on_chip
        s_k = cuda_iir_bank.sosfilt_bank_lead_cuda(ops, x, out_k)
        s_p = cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out_p)
        torch.cuda.synchronize()
        assert cuda_iir_bank.state_on_chip == before + (L <= 128)
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


def _pipeline_case(chain: str, dev, seed: int):
    """``(fn, inputs, counted kernel module, tolerance)`` of a small chain
    through `pipeline`: config 2 (B1), the TF path (B4), config 3 with its
    amplitude constraint (B3), a crossover band as a `Filter` (B2)."""
    from scipy.signal import fftconvolve

    from dsptoolbox_tpu_torch.classes import Filter
    from dsptoolbox_tpu_torch.generators import ChirpType, chirp
    from dsptoolbox_tpu_torch.tools import filterbank_chain, speech_chain
    from dsptoolbox_tpu_torch.transfer_functions import spectral_deconvolve, window_ir

    rng = np.random.default_rng(seed)
    if chain == "config2":
        return speech_chain.run, (speech_chain.signal(2, 1.0, seed=seed),), cuda_framing, 2e-5
    if chain == "tf":
        sweep, _ = chirp(48000, ChirpType.SyncLog, [20, 20000], 1.0, padding_end_seconds=0.25)
        irs = 1e-3 * rng.standard_normal((4000, 3))
        irs[rng.integers(50, 400, 3), range(3)] += 1.0
        x = sweep.time_data[:, 0].double().cpu().numpy()
        rec = Signal(None, np.stack([fftconvolve(x, irs[:, c])[: len(x)] for c in range(3)],
                                    axis=1).astype(np.float32), 48000)

        def tf(r, s):
            ir = spectral_deconvolve(r, s)
            w, _ = window_ir(ir, 8192, return_device=True)
            return w, complex_smoothing(w, 3, SmoothingDomain.RealImaginary).spectral_data

        return tf, (rec, sweep), cuda_banded, 1e-4
    if chain == "fb":
        lr, gt, third = filterbank_chain.banks()
        sig = filterbank_chain.signal(0.5, 4, seed=seed, device=dev)
        sig = Signal(None, sig.time_data, sig.sampling_rate_hz, constrain_amplitude=True)
        return (lambda s: filterbank_chain.run(s, lr, gt, third)), (sig,), cuda_iir_bank, 2e-5
    filters = [Filter.from_sos(sos, 48000) for sos in headline.crossover_bank(48000)]
    x = torch.from_numpy(rng.standard_normal((2, 140000)).astype(np.float32)).to(dev)
    return (lambda s: tuple(f.filter_signal(s) for f in filters)), (Signal(None, x.T, 48000),), \
        cuda_iir, 2e-5


@pytest.mark.parametrize("chain", ["config2", "tf", "fb", "iir"])
def test_pipeline_captures_chain_into_one_graph(dev, chain):
    """`pipeline` on the card: the chain's kernel is launched while the
    graph is captured, ``fn`` runs twice (warm-up and capture) over three
    calls, each replay equals the eager run, a call on other inputs leaves
    the first call's results unchanged, and a chain that reads a value back
    to the host raises at that line."""
    import dsptoolbox_tpu_torch as dsp
    from dsptoolbox_tpu_torch.tools.pipeline_chains import leaves

    fn, ins, kernel, tol = _pipeline_case(chain, dev, 0)
    _, other, _, _ = _pipeline_case(chain, dev, 1)
    calls = {"fn": 0, "launched": 0}

    def counted(*sigs):
        calls["fn"] += 1
        before = kernel.launches
        out = fn(*sigs)
        if torch.cuda.is_current_stream_capturing():
            calls["launched"] = kernel.launches - before
        return out

    run = dsp.pipeline(counted)
    first = leaves(run(*ins))
    snap = [t.clone() for t in first]
    second = leaves(run(*other))
    third = leaves(dsp.compute_all(run(*ins)))
    assert calls["fn"] == 2 and calls["launched"] > 0
    for got, want in ((first, leaves(fn(*ins))), (second, leaves(fn(*other))),
                      (third, leaves(fn(*ins)))):
        assert len(got) == len(want)
        assert max(_rel(g, w) for g, w in zip(got, want)) <= tol
    assert all(torch.equal(a, b) for a, b in zip(first, snap))

    def unsafe(*sigs):
        float(sigs[0].time_data.max())
        return fn(*sigs)

    with pytest.raises(RuntimeError, match=r"float\(sigs\[0\]\.time_data\.max\(\)\)"):
        dsp.pipeline(unsafe)(*ins)


def test_compute_transfer_function_frames_each_signal_once_on_card(dev):
    """H1/H2/H3 on the card: two B1 launches a call (the input framed once,
    the output once), and the same spectra and coherence as the plain paths
    and as the CPU."""
    from dsptoolbox_tpu_torch.transfer_functions import (
        TransferFunctionType,
        compute_transfer_function,
    )

    x = RNG.standard_normal((48000, 1)).astype(np.float32)
    y = np.stack([np.convolve(x[:, 0], h)[:48000] for h in ([0.3, 0.2], [1.0, -0.5, 0.1])], 1)
    y = (y + 0.01 * RNG.standard_normal(y.shape)).astype(np.float32)
    for mode in TransferFunctionType:
        rec, exc = Signal(None, y, 48000, device=dev), Signal(None, x, 48000, device=dev)
        cuda_framing.launches = 0
        got = compute_transfer_function(rec, exc, 2048, mode)
        torch.cuda.synchronize()
        assert cuda_framing.launches == 2
        assert got.device == rec.device
        with _config.kernels_off():
            plain = compute_transfer_function(rec, exc, 2048, mode)
        cpu = compute_transfer_function(Signal(None, y, 48000, device="cpu"),
                                        Signal(None, x, 48000, device="cpu"), 2048, mode)
        for want in (plain, cpu):  # the DC bin, a noise/noise ratio, left out
            assert _rel(got.spectral_data[1:], want.spectral_data[1:]) <= 2e-5
            assert _rel(got.coherence[1:], want.coherence[1:]) <= 2e-5


def test_stft_features_and_lpc_launch_b1_and_match_plain(dev):
    """`log_mel_spectrogram`, `mfcc` and `chroma_stft` on the card frame
    through B1 once (the power spectrogram is cached with the STFT), `lpc`
    once a call; each matches the plain paths and the CPU."""
    from dsptoolbox_tpu_torch import transforms
    from dsptoolbox_tpu_torch.tools import speech_chain

    x = speech_chain.signal(2, 1.0).time_data.cpu()
    sigs = {"card": Signal(None, x.to(dev), 48000), "cpu": Signal(None, x, 48000)}
    plain = Signal(None, x.to(dev), 48000)
    cuda_framing.launches = 0
    out = {}
    for name, s in sigs.items():
        out[name] = (transforms.log_mel_spectrogram(s, generate_plot=False)[2],
                     transforms.mfcc(s, generate_plot=False)[2],
                     transforms.chroma_stft(s)[1],
                     transforms.lpc(s, 16, 512, use_burg_method=True)[0],
                     transforms.lpc(s, 16, 512)[0])
        torch.cuda.synchronize()
        if name == "card":
            assert cuda_framing.launches == 3  # the STFT once, each lpc once
    assert cuda_framing.launches == 3  # CPU tensors take the plain path
    with _config.kernels_off():
        out["plain"] = (transforms.log_mel_spectrogram(plain, generate_plot=False)[2],
                        transforms.mfcc(plain, generate_plot=False)[2],
                        transforms.chroma_stft(plain)[1],
                        transforms.lpc(plain, 16, 512, use_burg_method=True)[0],
                        transforms.lpc(plain, 16, 512)[0])
    assert cuda_framing.launches == 3
    for want in (out["plain"], out["cpu"]):
        logmel, mf, chroma, burg, yw = out["card"]
        valid = want[0] > -300
        assert np.abs(logmel - want[0])[valid].max() < 1e-3  # dB
        assert _rel(mf, want[1]) <= 1e-5
        assert _rel(chroma, want[2]) <= 1e-5
        assert _rel(burg, want[3]) <= 1e-6 and _rel(yw, want[4]) <= 1e-6


def test_spectrum_via_filterbank_launches_b3_and_b2_and_meets_scipy(dev):
    """The parallel bank through B3 (one launch), in zero phase each band
    through B2 (forward and backward); both against scipy's float64
    sosfilt/sosfiltfilt and RMS on the bands at and above 100 Hz."""
    from scipy.signal import sosfiltfilt

    from dsptoolbox_tpu_torch import transforms
    from dsptoolbox_tpu_torch.classes import Filter
    from dsptoolbox_tpu_torch.standard.enums import FilterPassType

    x = (0.3 * RNG.standard_normal((96000, 2))).astype(np.float32)
    s = Signal(None, x, 48000, device=dev)
    centres = 1000.0 * 10.0 ** (np.arange(-17, 14) / 10)
    factor = 2 ** (1 / 6)
    for zero_phase, run in ((False, sosfilt), (True, sosfiltfilt)):
        cuda_iir_bank.launches = 0
        cuda_iir.launches = 0
        sp = transforms.spectrum_via_filterbank(s, centres, 1 / 3, None, 8, zero_phase)
        torch.cuda.synchronize()
        if zero_phase:
            assert cuda_iir.launches == 2 * len(centres)
        else:
            assert cuda_iir_bank.launches >= 1 and cuda_iir.launches == 0
        got = sp.spectral_data.cpu().numpy()
        assert got.shape == (31, 2) and sp.spectral_data.device == s.device
        for b, fc in enumerate(centres):
            if fc < 100:
                continue
            sos = Filter.iir_filter(8, [fc / factor, fc * factor], FilterPassType.Bandpass,
                                    48000).sos
            want = run(sos, x.astype(np.float64), axis=0).std(axis=0)
            assert np.abs(got[b] - want).max() / np.abs(want).max() <= 1e-4, fc


def test_allpass_operator_on_card_meets_float64_recursion(dev):
    """`warp`'s D·x and `laguerre`'s Dᵀ·v on the card at T = 4096 against
    the float64 recursions of the JAX package's scans (scipy's lfilter T
    times); no kernel launch, none per sample."""
    from scipy.signal import lfilter

    from dsptoolbox_tpu_torch.transforms import _backend as tb

    T, lam = 4096, -0.76
    x = RNG.standard_normal((T, 2))
    d = np.zeros(T)
    d[0] = 1.0
    warped = d[:, None] * x[0][None]
    for n in range(1, T):
        d = lfilter([-lam, 1.0], [1.0, -lam], d)
        warped = warped + d[:, None] * x[n][None]
    cur = x[::-1].T.copy()
    rows = [cur[:, -1]]
    for _ in range(1, T):
        cur = lfilter([-lam, 1.0], [1.0, -lam], cur, axis=-1)
        rows.append(cur[:, -1])
    transposed = np.array(rows)
    xt = torch.from_numpy(x).to(dev)
    assert _rel(tb.allpass_apply(xt, lam), warped) <= 1e-10
    assert _rel(tb.allpass_apply_t(xt, lam), transposed) <= 1e-10
    assert _rel(tb.allpass_apply(xt.float(), lam), warped) <= 1e-6
    assert _rel(tb.allpass_apply_t(xt.float(), lam), transposed) <= 1e-6


@pytest.mark.parametrize("shape", [(16, 48000), (3, 2049), (1, 1), (2, 5, 4097), (4, 2048)])
def test_ema_kernel_matches_plain_loop(dev, shape):
    """`csrc/ema.cu` (attack/release EMA) against its plain loop: the same
    float32 operations in the same order, so equal bit for bit; one launch
    a call, rows across chunk edges and a single sample."""
    from dsptoolbox_tpu_torch.ops import cuda_ema

    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal(shape) ** 2).astype(np.float32)).to(dev)
    before = cuda_ema.launches
    got = cuda_ema.ema_attack_release(x, 0.0125, 2.5e-4)
    torch.cuda.synchronize()
    assert cuda_ema.launches == before + 1
    want = cuda_ema.ema_attack_release_plain(x.cpu(), 0.0125, 2.5e-4)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(16, 48000), (3, 2049), (1, 1)])
def test_ema_kernel_float64_matches_plain_loop(dev, shape):
    """The EMA kernel's float64 instantiation: equal bit for bit to the
    plain loop in float64, one launch a call."""
    from dsptoolbox_tpu_torch.ops import cuda_ema

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(shape) ** 2).to(dev)
    before = cuda_ema.launches
    got = cuda_ema.ema_attack_release(x, 0.0125, 2.5e-4)
    torch.cuda.synchronize()
    assert cuda_ema.launches == before + 1 and got.dtype == torch.float64
    assert torch.equal(got.cpu(), cuda_ema.ema_attack_release_plain(x.cpu(), 0.0125, 2.5e-4))


@pytest.mark.parametrize("order,fc", [(4, 1000.0), (6, 200.0), (3, 1000.0)])
def test_stateful_ba_runs_b2_and_meets_scipy_float64(dev, order, fc):
    """A stateful ``(b, a)`` above order 2 through `ops.iir.lfilter` on the
    card: B2 (one launch a call), equal to the plain path within float32
    rounding and within 5e-6 of scipy's float64 ``lfilter`` of the same
    coefficients, streamed in blocks (handing on the cascade's own state)
    as one call."""
    from scipy.signal import lfilter as sp_lfilter, lfilter_zi

    from dsptoolbox_tpu_torch.ops import iir, iir_block

    b, a = butter(order, fc, fs=48000)
    rng = np.random.default_rng(order)
    x = rng.standard_normal((3, 48000)).astype(np.float32)
    zi = lfilter_zi(b, a) * x[:, :1]
    ref = sp_lfilter(b, a, x.astype(np.float64), zi=zi)[0]
    before = cuda_iir.launches
    y, zf = iir.lfilter(b, a, torch.from_numpy(x).to(dev), zi=zi)
    torch.cuda.synchronize()
    assert cuda_iir.launches == before + 1
    assert zf.dtype == torch.float64
    plain = iir.lfilter(b, a, torch.from_numpy(x), zi=zi)[0]
    assert _rel(y, plain) <= 2e-6
    assert _rel(y, ref) <= 5e-6
    zc, parts = None, []
    for k in range(0, 48000, 4800):
        yk, _, zc = iir_block.lfilter_statespace(
            b, a, torch.from_numpy(x[:, k:k + 4800]).to(dev), zi=zi if zc is None else None,
            zc=zc)
        parts.append(yk)
    assert _rel(torch.cat(parts, -1), y) <= 1e-6


@pytest.mark.parametrize("ext", ["wav", "flac"])
def test_signal_from_a_file_lands_on_the_card(dev, ext, tmp_path):
    """``Signal(path)`` reads on the host and puts the samples on the
    default device, "cuda": equal to the file's decode."""
    from dsptoolbox_tpu_torch import io

    x = (0.3 * np.random.default_rng(4).standard_normal((4800, 2)))
    path = str(tmp_path / f"x.{ext}")
    io.write_audio(path, x, 48000, "PCM_24")
    sig = Signal(path)
    assert sig.device.type == "cuda"
    np.testing.assert_array_equal(sig.time_data.cpu().numpy(),
                                  io.read_audio(path)[0].astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(469, 1024), (16, 48000), (3, 2049), (1, 4097), (2, 1)])
def test_ema_average_kernel_matches_plain_loop(dev, dtype, shape):
    """`csrc/ema.cu`'s average form (the streaming exponential average from
    a start carry per row) against its plain loop: the same operations in
    the same order, so equal bit for bit in float32 and float64; one launch
    a call, rows across chunk edges (2048) and a single sample."""
    from dsptoolbox_tpu_torch.ops import cuda_ema

    rng = np.random.default_rng(13)
    x = torch.from_numpy(np.abs(rng.standard_normal(shape))).to(dev, dtype)
    carry = torch.from_numpy(rng.uniform(0, 1, shape[0])).to(dev, dtype)
    before = cuda_ema.average_launches
    got = cuda_ema.ema_average(x, carry, 0.0125, 2.5e-4)
    torch.cuda.synchronize()
    assert cuda_ema.average_launches == before + 1 and got.dtype == dtype
    want = cuda_ema.ema_average_plain(x.cpu(), carry.cpu(), 0.0125, 2.5e-4)
    assert torch.equal(got.cpu(), want)


def test_realtime_filters_launch_their_kernels_and_match_plain(dev):
    """On the card: the warped FIR launches B2 once a stage and the Kautz
    filter three times a pole pair and twice a real pole, an `IIRFilter`
    stream once a block and an `ExponentialAverageFilter` stream the EMA
    kernel once a block; each within 1e-5 x peak of its plain version (the
    EMA bit for bit), the IIR stream within 5e-6 of scipy's float64
    lfilter."""
    from scipy.signal import lfilter

    from dsptoolbox_tpu_torch import realtime as rt
    from dsptoolbox_tpu_torch.ops import cuda_ema

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 48000)).astype(np.float32) * 0.3).to(dev)
    s = Signal(None, x.T, 48000)
    warped = rt.WarpedFIR(np.hanning(34)[17:] * rng.standard_normal(17), 0.766, 48000)
    kautz = rt.KautzFilter(np.array([0.9 * np.exp(0.1j), 0.95 * np.exp(0.4j), 0.5]), 48000)
    for f, n in ((warped, 16), (kautz, 3 * 2 + 2)):
        before = cuda_iir.launches
        got = f.filter_signal(s)._x
        torch.cuda.synchronize()
        assert cuda_iir.launches == before + n
        with _config.kernels_off():
            want = f.filter_signal(s)._x
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    b, a = butter(4, 1000.0, fs=48000)
    iir, ema = rt.IIRFilter(b, a), rt.ExponentialAverageFilter(0.01, 0.05, 48000)
    before, before_ema = cuda_iir.launches, cuda_ema.average_launches
    y = torch.cat([iir.process_block(x[0, i:i + 1024], 0) for i in range(0, 46080, 1024)])
    e = torch.cat([ema.process_block(x[0, i:i + 1024].abs(), 0) for i in range(0, 46080, 1024)])
    torch.cuda.synchronize()
    assert cuda_iir.launches == before + 45 and cuda_ema.average_launches == before_ema + 45
    ref = lfilter(b, a, x[0, :46080].double().cpu().numpy())
    assert _rel(y, ref) <= 5e-6
    blocks = x[0, :46080].abs().reshape(45, 1024)
    carry = torch.cat([e.new_zeros(1), e.reshape(45, 1024)[:-1, -1]])
    assert torch.equal(cuda_ema.ema_average_plain(blocks, carry, ema.increase_coefficient,
                                                  ema.decrease_coefficient).reshape(-1), e)


def test_compressor_gain_is_the_ema_kernel_average(dev):
    """The compressor's gain smoother on the card: `gain_request`, then
    `csrc/ema.cu`'s average form from a gain of 1 (one launch), equal bit
    for bit to its plain loop on the same requests; the compressed rows are
    the rows times that gain; the effect launches the kernel once and
    matches its plain path (2e-5 of the peak)."""
    from dsptoolbox_tpu_torch import effects
    from dsptoolbox_tpu_torch.effects import _backend as fx
    from dsptoolbox_tpu_torch.ops import cuda_ema

    rng = np.random.default_rng(15)
    env = np.repeat(rng.uniform(0.01, 1.0, (2, 24)), 1000, axis=1)
    rows = torch.from_numpy((rng.standard_normal((2, 24000)) * env).astype(np.float32)).to(dev)
    a, r = fx.smoothing_coefficients(240, 2400)
    request = fx.gain_request(rows, -20, 4, 6, True)
    before = cuda_ema.average_launches
    gain = cuda_ema.ema_average(request, rows.new_ones(2), a, r)
    y = fx.compressor_core(rows.T, -20, 4, 6, 240, 2400, 1.0, True)
    torch.cuda.synchronize()
    assert cuda_ema.average_launches == before + 2
    want = cuda_ema.ema_average_plain(request.cpu(), torch.ones(2), a, r)
    assert torch.equal(gain.cpu(), want)
    assert torch.equal(y.T, rows * gain)
    s = Signal(None, rows.T, 48000)
    comp = effects.Compressor(-20, 5, 50, 4)
    before = cuda_ema.average_launches
    got = comp.apply(s)._x
    torch.cuda.synchronize()
    assert cuda_ema.average_launches == before + 1
    with _config.kernels_off():
        plain = comp.apply(s)._x
    assert _rel(got, plain) <= 2e-5


def test_mesh_paths_launch_each_kernel_once_a_shard(dev):
    """On a mesh of four shards of the card: the CSM (B1), the filter bank
    (B3) and the DAS map (B5) launch their kernel once a shard and equal the
    single-device calls bit for bit; float64 mode's `Filter` on a card
    signal stays on the card in float64, meets scipy at the IIR bound and
    launches no B2."""
    from dsptoolbox_tpu_torch import parallel
    from dsptoolbox_tpu_torch.classes import Filter
    from dsptoolbox_tpu_torch.standard.enums import FilterPassType

    devs = np.empty(4, dtype=object)
    devs[:] = [dev] * 4
    mesh = parallel.Mesh(devs, ("dp",))
    x = torch.from_numpy(RNG.standard_normal((8, 48000)).astype(np.float32)).to(dev)
    cuda_framing.launches = 0
    f, csm = parallel.parallel_csm(x, mesh, sampling_rate_hz=48000)
    assert cuda_framing.launches == 4
    _, want = parallel.parallel_csm(x, parallel.device_mesh(1), sampling_rate_hz=48000)
    assert _rel(csm, want) <= 2e-5
    bank = np.stack([butter(4, fc, btype="lowpass", fs=48000, output="sos")
                     for fc in (250, 500, 1000, 2000, 4000, 8000, 12000, 16000)])
    cuda_iir_bank.launches = 0
    got = parallel.parallel_filterbank(bank, x, mesh)
    assert cuda_iir_bank.launches == 4
    torch.testing.assert_close(got, parallel.parallel_filterbank(bank, x, parallel.device_mesh(1)),
                               rtol=0, atol=0)
    M, G, F = 16, 64, 9
    amp = torch.rand((M, G), device=dev) + 0.5
    diff = (torch.rand((M, G), device=dev) - 0.5) * 0.6
    k = torch.linspace(10.0, 60.0, F, device=dev)
    C = torch.randn((F, M, M), dtype=torch.complex64, device=dev)
    C = (C + C.mH) / 2
    cuda_das.launches = 0
    got = parallel.parallel_das_map(amp, diff, k, C, mesh)
    assert cuda_das.launches == 4
    torch.testing.assert_close(
        got, cuda_das.das_map(amp, diff, k, C.real.contiguous(), C.imag.contiguous()),
        rtol=0, atol=0)
    x64 = RNG.standard_normal((2, 48000))
    filt = Filter.iir_filter(6, 200.0, FilterPassType.Lowpass, 48000)
    cuda_iir.launches = 0
    _config.set_default_float("float64")
    try:
        y = filt.filter_signal(Signal(None, x64.T, 48000, device=dev)).time_data
    finally:
        _config.set_default_float("float32")
    assert cuda_iir.launches == 0
    assert y.device.type == "cuda" and y.dtype == torch.float64
    want = sosfilt(filt.sos, x64.T, axis=0)
    assert np.abs(y.cpu().numpy() - want).max() <= 5e-6 * np.abs(want).max()

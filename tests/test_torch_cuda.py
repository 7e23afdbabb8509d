"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (the measurement chain's shapes are covered by
``chip_smoke.py``). Marked ``cuda``; they skip without a CUDA device.

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
from dsptoolbox_tpu_torch.ops import cuda_das, cuda_framing, cuda_iir, iir_block

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
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize(
    "shape,L,step,pad",
    [((8, 4096), 512, 256, 0), ((3, 1000), 384, 160, 0), ((2, 3, 777), 100, 37, 0),
     ((1, 50), 64, 64, 0), ((5, 10), 64, 16, 0), ((4, 3000), 256, 128, 128),
     ((2, 777), 100, 37, 63), ((1, 10), 64, 16, 48)],
)
@pytest.mark.parametrize("detrend", [True, False])
def test_framing_kernel_matches_plain(dev, shape, L, step, pad, detrend):
    x = torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(dev)
    win = torch.from_numpy(np.hanning(L).astype(np.float32)).to(dev)
    before = cuda_framing.launches
    got = cuda_framing.windowed_frames(x, win, step, detrend, pad)
    want = cuda_framing.windowed_frames_plain(x, win, step, detrend, pad)
    torch.cuda.synchronize()
    assert cuda_framing.launches == before + 1
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6


# orders 2-16 take the kernel's compile-time state sizes (N = order), 18 and
# 32 its run-time path; K = 1 and 2 are the chunked chain's edge cases;
# L = 200 and 256 hold H's slab in two column tiles, L >= 512 streams it
@pytest.mark.parametrize(
    "order,L,B,K",
    [(6, 128, 3, 40), (4, 98, 2, 17), (2, 64, 1, 300), (8, 128, 2, 3000),
     (18, 128, 2, 40), (32, 128, 1, 33), (4, 128, 1, 1), (4, 64, 2, 2),
     (4, 3, 2, 50), (8, 200, 2, 20), (8, 256, 3, 17), (6, 512, 2, 16),
     (32, 1024, 2, 16), (4, 1000, 1, 5)],
)
def test_iir_lead_kernel_matches_plain(dev, order, L, B, K):
    sos = butter(order, 0.2, output="sos")
    key = tuple(np.asarray(sos, np.float64).reshape(-1).tolist())
    zi = np.tile(sosfilt_zi(sos)[None], (B, 1, 1)) * RNG.uniform(0.1, 1, (B, 1, 1))
    ops = iir_block.operators_to_torch(
        dict(zip(("HmatT", "GyT", "ALT", "MT"), iir_block._block_operators(key, L)),
             zi=zi),
        dev, torch.float32,
    )
    xb = torch.from_numpy(RNG.standard_normal((B, K, L)).astype(np.float32)).to(dev)
    args = (ops["HmatT"], ops["GyT"], ops["ALT"], ops["MT"], xb,
            ops["zi"].reshape(B, -1))
    yk, zk = cuda_iir.sosfilt_lead_cuda(*args)
    yp, zp = cuda_iir.sosfilt_lead_plain(*args)
    torch.cuda.synchronize()
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


def _das_args(F, M, G, dev, dtype=torch.float32):
    C = RNG.standard_normal((F, M, M)) + 1j * RNG.standard_normal((F, M, M))
    arrays = (RNG.uniform(0.5, 1.0, (M, G)), RNG.uniform(-0.5, 0.5, (M, G)),
              np.linspace(10.0, 400.0, F), C.real, C.imag)
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
            for a in arrays]


# (F, M, G): the ragged shapes of tests/test_pallas_das.py; M = 1 and every
# mic-tile size (8, 16, 32, 64); M = 65 and 160 take several mic tiles (at
# M = 160 the whole C_f does not fit in shared memory); G below, at and
# above the 64-point block
@pytest.mark.parametrize(
    "F,M,G",
    [(13, 9, 20), (5, 25, 130), (37, 64, 100), (2, 1, 5), (3, 8, 64),
     (4, 16, 65), (3, 32, 1), (6, 65, 33), (3, 160, 70), (1, 64, 900)],
)
def test_das_kernel_matches_plain(dev, F, M, G):
    args = _das_args(F, M, G, dev)
    before = cuda_das.launches
    got = cuda_das.das_map(*args)
    want = cuda_das.das_map_plain(*args)
    torch.cuda.synchronize()
    assert cuda_das.launches == before + 1
    assert got.shape == (G, F)
    assert _rel(got, want) <= 5e-5


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

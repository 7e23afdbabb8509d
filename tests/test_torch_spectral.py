"""Port spectral path (`dsptoolbox_tpu_torch.ops.spectral`, framing) against
the JAX package on the CPU: the same seeded numpy inputs through both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from conftest import assert_close
from dsptoolbox_tpu.ops import framing as jframing
from dsptoolbox_tpu.ops import spectral as jspec
from dsptoolbox_tpu.ops.pallas_framing import windowed_frames_pallas
from dsptoolbox_tpu.standard.enums import SpectrumScaling as JScaling
from dsptoolbox_tpu_torch.ops import cuda_csm, cuda_framing, framing, spectral
from dsptoolbox_tpu_torch.ops.pad_trim import pad_trim_axis
from dsptoolbox_tpu_torch.standard.enums import SpectrumScaling

torch.set_num_threads(1)

FS = 16000
RNG = np.random.default_rng(11)
X = RNG.standard_normal((3, 5000)).astype(np.float32)
Y = RNG.standard_normal((3, 5000)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("scaling", ["FFTBackward", "PowerSpectrum", "AmplitudeSpectralDensity"])
@pytest.mark.parametrize("detrend", [False, True])
def test_stft_matches_jax(scaling, detrend):
    kw = dict(sampling_rate_hz=FS, window_length_samples=256,
              overlap_percent=50.0, detrend=detrend)
    t_j, f_j, S_j = jspec.stft(jnp.asarray(X), scaling=JScaling[scaling], **kw)
    t_t, f_t, S_t = spectral.stft(_t(X), scaling=SpectrumScaling[scaling], **kw)
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_array_equal(f_t, f_j)
    assert_close(S_t.numpy(), np.asarray(S_j), name=f"stft-{scaling}")


# 5000 samples, window 256: 50 % overlap gives 40 frames (even count, so the
# median averages the two middle values); 25 % overlap gives 27 frames
@pytest.mark.parametrize("overlap", [50.0, 25.0])
@pytest.mark.parametrize("average", ["mean", "median"])
def test_welch_matches_jax(average, overlap):
    kw = dict(sampling_rate_hz=FS, window_length_samples=256,
              overlap_percent=overlap, average=average)
    got = spectral.welch(_t(X), **kw)
    want = jspec.welch(jnp.asarray(X), **kw)
    assert_close(got.numpy(), np.asarray(want), name=f"welch-{average}")
    got = spectral.welch(_t(X), _t(Y), **kw)
    want = jspec.welch(jnp.asarray(X), jnp.asarray(Y), **kw)
    assert_close(got.numpy(), np.asarray(want), name=f"welch-cross-{average}")


def test_median_averages_middle_pair():
    frames = torch.tensor([[[1.0], [4.0], [2.0], [10.0]]])  # 4 frames
    assert spectral._median(frames, -2).item() == 3.0


@pytest.mark.parametrize("average", ["mean", "median"])
@pytest.mark.parametrize("scaling", ["PowerSpectralDensity", "AmplitudeSpectrum"])
def test_csm_welch_matches_jax(average, scaling):
    kw = dict(sampling_rate_hz=FS, window_length_samples=256, average=average)
    f_t, C_t = spectral.csm_welch(_t(X), scaling=SpectrumScaling[scaling], **kw)
    f_j, C_j = jspec.csm_welch(jnp.asarray(X), scaling=JScaling[scaling], **kw)
    np.testing.assert_array_equal(f_t, f_j)
    assert_close(C_t.numpy(), np.asarray(C_j), name=f"csm-{average}")


# (C, K, F): one channel, one frame, channels off the Gram kernel's tiles
@pytest.mark.parametrize("C,K,F", [(1, 1, 5), (3, 7, 33), (9, 40, 17), (33, 5, 9)])
def test_plain_gram_matches_jax_einsum(C, K, F):
    """`cuda_csm.gram_mean` on a CPU tensor (its plain version, no launch)
    against the JAX package's mean branch of `csm_welch`: the einsum at
    HIGHEST precision over K, with the diagonal's real einsum."""
    rng = np.random.default_rng(C * 1000 + K * 10 + F)
    X = (rng.standard_normal((C, K, F)) + 1j * rng.standard_normal((C, K, F))).astype(
        np.complex64)
    before = cuda_csm.launches
    got = cuda_csm.gram_mean(_t(X))
    assert cuda_csm.launches == before
    Xj = jnp.asarray(X)
    hi = jax.lax.Precision.HIGHEST
    Q = jnp.einsum("akf,bkf->fab", jnp.conjugate(Xj), Xj, precision=hi) / K
    diag = jnp.einsum("akf,akf->fa", jnp.conjugate(Xj), Xj, precision=hi).real / K
    eye = jnp.eye(C, dtype=Q.dtype)
    want = Q * (1 - eye) + diag[..., None] * eye
    assert_close(got.numpy(), np.asarray(want), name="gram")
    assert np.all(got.diagonal(dim1=-2, dim2=-1).imag.numpy() == 0)


@pytest.mark.parametrize("overlap", [50.0, 25.0])
def test_csm_welch_median_branch_unchanged(overlap):
    """The median branch keeps its per-pair medians: it matches the JAX
    package and never reaches the Gram product."""
    x = np.random.default_rng(4).standard_normal((4, 3000)).astype(np.float32)
    kw = dict(sampling_rate_hz=FS, window_length_samples=128, overlap_percent=overlap,
              average="median")
    before = cuda_csm.launches
    _, got = spectral.csm_welch(_t(x), **kw)
    _, want = jspec.csm_welch(jnp.asarray(x), **kw)
    assert cuda_csm.launches == before
    assert_close(got.numpy(), np.asarray(want), name="csm-median")


# (L, step): the STFT/Welch case, and L % step != 0 (outside the TPU
# kernel's tiling limits, inside the CUDA kernel's)
@pytest.mark.parametrize("L,step", [(512, 256), (384, 160), (100, 37)])
@pytest.mark.parametrize("detrend", [True, False])
def test_plain_framing_matches_frame_signal(L, step, detrend):
    T = 4096
    x = RNG.standard_normal((8, T)).astype(np.float32)
    win = np.hanning(L).astype(np.float32)
    got = cuda_framing.windowed_frames(_t(x), _t(win), step, detrend).numpy()
    want = np.asarray(jframing.frame_signal(jnp.asarray(x), L, step, True)) * win
    if detrend:
        want = want - want.mean(axis=-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("L,step,pad", [(256, 128, 128), (100, 37, 63)])
def test_plain_framing_pad_matches_padded_input(L, step, pad):
    """``pad`` frames the signal as if padded with zeros at both ends (the
    STFT's padding, which the kernel reads in place)."""
    x = RNG.standard_normal((3, 1000)).astype(np.float32)
    win = np.hanning(L).astype(np.float32)
    got = cuda_framing.windowed_frames(_t(x), _t(win), step, True, pad).numpy()
    xp = np.pad(x, ((0, 0), (pad, pad)))
    want = np.asarray(jframing.frame_signal(jnp.asarray(xp), L, step, True)) * win
    want = want - want.mean(axis=-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("detrend", [True, False])
def test_plain_framing_matches_pallas_interpret(detrend):
    L, S, T, B = 512, 256, 4096, 8
    x = RNG.standard_normal((B, T)).astype(np.float32)
    win = np.hanning(L).astype(np.float32)
    n_frames, _ = jframing.compute_number_frames(L, S, T, True)
    span = (n_frames - 1) * S + L
    xp = np.pad(x, ((0, 0), (0, span - T)))
    want = windowed_frames_pallas(
        jnp.asarray(xp), win, S, n_frames, detrend, interpret=True
    )
    got = cuda_framing.windowed_frames(_t(x), _t(win), S, detrend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _staged_frames(x, win, step, detrend, pad):
    """numpy emulation of the CUDA framing kernel's partition and staging
    (`csrc/framing.cu`): blocks of `cuda_framing.frames_per_block`
    consecutive frames of one row, each staging its input span from x's
    element rounded down to 16 bytes in whole 4-sample chunks, zero outside
    its row, and framing from the staged span (frames longer than the warp
    kernel's take one block each, read from x). Asserts that the blocks
    cover every frame exactly once and that each span fits the block's
    shared memory."""
    B, T = x.shape
    L = len(win)
    K = framing.compute_number_frames(L, step, T + 2 * pad)[0]
    fpb = cuda_framing.frames_per_block(L, step, K)
    flat = x.reshape(-1)
    out = np.zeros((B, K, L), np.float32)
    seen = np.zeros((B, K), int)
    runs = [(k0, min(fpb, K - k0)) for k0 in range(0, K, fpb)] if fpb else [
        (k, 1) for k in range(K)]
    for b in range(B):
        for k0, n in runs:
            g0 = b * T + k0 * step - pad
            a0 = g0 - g0 % 4  # rounded down to 16 bytes of x
            lead = g0 - a0
            chunks = (lead + (n - 1) * step + L + 3) // 4
            if fpb:
                assert ((L + 3) & ~3) + 4 * chunks <= cuda_framing.span_floats(
                    L, step, fpb) <= cuda_framing.SMEM_FLOATS
            q = a0 + np.arange(4 * chunks)
            xs = np.where((q >= b * T) & (q < b * T + T), flat[np.clip(q, 0, flat.size - 1)],
                          np.float32(0))
            for j in range(n):
                v = xs[lead + j * step: lead + j * step + L] * win
                out[b, k0 + j] = v - v.mean() if detrend else v
                seen[b, k0 + j] += 1
    assert (seen == 1).all()
    return out, fpb


# (B, T, L, step, pad): a ragged tail, step > L, T < L, pad > 0 with odd
# offsets, L = 8, one frame, a span cut by the shared memory (fpb 2), the
# chain's L, step and pad, and L = 2^18 (Welch's longest; one block per
# frame)
@pytest.mark.parametrize(
    "B,T,L,step,pad,fpb",
    [(2, 1000, 64, 25, 0, 8), (2, 1000, 64, 100, 0, 8), (3, 50, 64, 16, 0, 4),
     (2, 777, 100, 37, 63, 8), (2, 130, 8, 3, 5, 8), (1, 5000, 2048, 6000, 0, 1),
     (1, 20000, 2048, 4500, 0, 2), (4, 4000, 1024, 512, 512, 8),
     (1, 300000, 2**18, 2**17, 0, 0)],
)
@pytest.mark.parametrize("detrend", [True, False])
def test_framing_partition_covers_every_frame_once(B, T, L, step, pad, fpb, detrend):
    x = RNG.standard_normal((B, T)).astype(np.float32)
    win = np.hanning(L).astype(np.float32)
    got, used = _staged_frames(x, win, step, detrend, pad)
    assert used == fpb
    want = cuda_framing.windowed_frames_plain(_t(x), _t(win), step, detrend, pad)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6)


@pytest.mark.parametrize("keep_last", [True, False])
@pytest.mark.parametrize("L,step,T", [(64, 32, 1000), (60, 25, 1000), (64, 16, 40)])
def test_frame_signal_and_counts_match_jax(L, step, T, keep_last):
    x = RNG.standard_normal((2, T)).astype(np.float32)
    assert framing.compute_number_frames(L, step, T, keep_last) == (
        jframing.compute_number_frames(L, step, T, keep_last)
    )
    got = framing.frame_signal(_t(x), L, step, keep_last)
    want = jframing.frame_signal(jnp.asarray(x), L, step, keep_last)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L,step", [(64, 32), (60, 25), (64, 64)])
def test_overlap_add_matches_jax(L, step):
    frames = RNG.standard_normal((2, 7, L)).astype(np.float32)
    for total in (None, 50, 400):
        got = framing.overlap_add(_t(frames), step, total)
        want = jframing.overlap_add(jnp.asarray(frames), step, total)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_check_cola_matches_jax():
    from dsptoolbox_tpu.ops.windows import check_cola as j_check_cola
    from dsptoolbox_tpu_torch.ops.windows import check_cola, get_window
    from dsptoolbox_tpu_torch.standard.enums import Window

    for wt, step in ((Window.Hann, 128), (Window.Hann, 192), (Window.Hamming, 100)):
        w = get_window(wt, 256)
        assert check_cola(w, step) == j_check_cola(w, step)


def test_pad_trim_axis_matches_jax():
    from dsptoolbox_tpu.ops.pad_trim import pad_trim_axis as j_pad_trim

    x = RNG.standard_normal((3, 10, 4)).astype(np.float32)
    for axis in (0, 1, -1):
        for n in (2, 10, 13):
            for end in (True, False):
                got = pad_trim_axis(_t(x), n, axis, end)
                want = j_pad_trim(jnp.asarray(x), n, axis, end)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))

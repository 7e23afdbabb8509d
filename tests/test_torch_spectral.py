"""Port spectral path (`dsptoolbox_tpu_torch.ops.spectral`, framing) against
the JAX package on the CPU: the same seeded numpy inputs through both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import assert_close
from dsptoolbox_tpu.ops import framing as jframing
from dsptoolbox_tpu.ops import spectral as jspec
from dsptoolbox_tpu.ops.pallas_framing import windowed_frames_pallas
from dsptoolbox_tpu.standard.enums import SpectrumScaling as JScaling
from dsptoolbox_tpu_torch.ops import cuda_framing, framing, spectral
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

"""The port's `plots` (a host matplotlib layer, `dsptoolbox_tpu/plots`) and
the plotting defaults of `transforms`: each template draws from numpy and
from tensors, and `log_mel_spectrogram`, `mfcc` (whose ``generate_plot``
is True by default), `chroma_stft` with a plotted channel and
`plot_waterfall` return their figures. matplotlib's Agg backend; small
sizes."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import dsptoolbox_tpu_torch as dtt  # noqa: E402
from dsptoolbox_tpu_torch import _config, plots, transforms  # noqa: E402
from dsptoolbox_tpu_torch.classes import Signal  # noqa: E402

RNG = np.random.default_rng(11)
X = (0.2 * RNG.standard_normal((8000, 2))).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu_and_close():
    old = _config.default_device()
    _config.set_default_device("cpu")
    yield
    _config.set_default_device(old)
    plt.close("all")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_line_templates(as_tensor):
    f = np.linspace(20, 20000, 200)
    m = RNG.standard_normal((200, 2))
    if as_tensor:
        f, m = torch.from_numpy(f), torch.from_numpy(m)
    fig, ax = plots.general_plot(f, m, range_x=[20, 20000], range_y=[-3, 3],
                                 labels=["a", "b"], ylabel="dB", info_box="info")
    assert len(ax.lines) == 2 and ax.get_xscale() == "log"
    fig, axes = plots.general_plot_two_axes(f, m[:, 0], f, m[:, 1], range_x=[20, 20000],
                                            labels1="mag", labels2="phase",
                                            y1label="dB", y2label="rad")
    assert len(axes) == 2 and len(axes[1].lines) == 1
    fig, axes = plots.general_subplots_line(None, m, xlabels="Time / s", ylabels=["x", "y"])
    assert len(axes) == 2
    fig, axes = plots.general_subplots_line(f, m[:, :1], column=False, log_x=True)
    assert len(axes) == 1
    with pytest.raises(ValueError):
        plots.general_plot(None, np.zeros((2, 2, 2)))


def test_matrix_template_and_show():
    m = torch.from_numpy(RNG.standard_normal((40, 30)))
    fig, ax = plots.general_matrix_plot(m, range_x=[0, 1], range_y=[20, 20000], range_z=20,
                                        xlabel="t", ylabel="f", zlabel="dB", ylog=True)
    lo, hi = ax.images[0].get_clim()
    assert hi == pytest.approx(float(m.max())) and hi - lo == pytest.approx(20)
    with pytest.raises(AssertionError):
        plots.general_matrix_plot(np.zeros(3))
    with pytest.raises(AssertionError):
        plots.general_matrix_plot(np.zeros((3, 3)), range_x=[0, 1])
    plots.show()  # Agg: returns at once
    assert dtt.plots is plots


def test_transforms_plot_by_default():
    s = Signal(None, X, 16000)
    out = transforms.log_mel_spectrogram(s, n_bands=20)
    assert len(out) == 5 and out[3] is not None and out[2].shape[0] == 20
    np.testing.assert_allclose(out[4].images[0].get_array(), out[2][..., 0])
    out = transforms.mfcc(s, channel=1)
    assert len(out) == 5
    np.testing.assert_allclose(out[4].images[0].get_array(), out[2][..., 1])
    t, chroma, pitch, fig, ax = transforms.chroma_stft(s, plot_channel=0)
    assert chroma.shape[0] == 12 and len(ax.images) == 1
    fig, ax = transforms.plot_waterfall(s, channel=1, dynamic_range_db=30,
                                        stft_parameters=dict(window_length_samples=256))
    assert ax.name == "3d" and len(ax.collections) == 1
    with pytest.raises(AssertionError):
        transforms.plot_waterfall(s, dynamic_range_db=0)


def test_beamformer_plots():
    """The beamformers' four plots (`beamforming.py:109,194,243,582` of the
    JAX package): the array's points in 2D and 3D, a 2D grid's map from a
    tensor map (flat and shaped), a 3D grid's slices and the setting of a
    DAS beamformer on a small grid."""
    from dsptoolbox_tpu_torch.beamforming import LineGrid, Regular2DGrid, Regular3DGrid
    from dsptoolbox_tpu_torch.tools import camera

    mics = camera.planar_array()
    line = np.linspace(-0.3, 0.3, 5)
    g = Regular2DGrid(line, line, ["x", "y"], value3=0.5)
    sig = camera.array_signal(0.05, 16000, "cpu", g)
    beam = camera.beamformer(sig, g)
    m = beam.get_beamformer_map(2000, 3)
    assert torch.is_tensor(m) and m.shape == (5, 5)
    figs = [mics.plot_points()[0], mics.plot_points("3d")[0],
            LineGrid(line, "x", 0.0, 0.5).plot_points()[0],
            g.plot_map(m)[0], g.plot_map(m.reshape(-1).numpy(), range_db=10)[0],
            beam.plot_setting()[0]]
    g3 = Regular3DGrid(line, line[:3], line[:4])
    m3 = torch.rand(g3.number_of_points, dtype=torch.float64)
    figs += [g3.plot_map(m3, d, 0.1)[0] for d in ("x", "y", "z")]
    figs.append(g3.plot_points()[0])
    assert len(figs) == 10 and all(f.axes for f in figs)
    with pytest.raises(ValueError):
        g3.plot_map(m3, "w", 0.0)
    with pytest.raises(ValueError):
        mics.plot_points("4d")

"""Frequency- and time-domain beamforming (`dsptoolbox_tpu/beamforming/beamforming.py`).

Geometry (points, grids, microphone arrays) and the four Sarradj steering
formulations are host float64 numpy, copied from the JAX package. Every
formulation factors as ``h[f, m, g] = amp[m, g] e^{-i k_f diff[m, g]}``; the
factors ``amp, diff (M, G)`` are moved to the signal's device once and
cached. The CSM comes from `Signal` (`ops.spectral.csm_welch`, the framing
kernel on a CUDA tensor).

The quadratic form ``Re(h^H C_f h)`` behind four of the maps goes through
`_quadratic_map`, which builds the steering and evaluates the form in one
call of `ops.cuda_das.das_map` (the fused DAS map kernel on a float32 CUDA
tensor): DAS on the CSM, MVDR's reference form on C⁻¹, CLEAN-SC's initial
map on the CSM and Functional's numerator on C^{1/γ}. MVDR's default path
is a loaded, equilibrated batched LU solve on the device; CLEAN-SC
deconvolves every bin in lockstep on the device (or per bin on the host,
`_config.set_clean_sc_on_device(False)`); Orthogonal and Functional take
their host float64 eigen- and singular-value decompositions from the JAX
package. `BeamformerDASTime` delays and sums in the frequency domain, in
grid chunks. `MonopoleSource` projects a source onto an array with one
batched fractional-delay FFT program.

The plots (`BasePoints.plot_points`, the grids' `plot_map`,
`BaseBeamformer.plot_setting`) draw on `plots` with matplotlib, a map
fetched to the host once. `BeamformerDASFrequency.get_beamformer_map(mesh=)`
splits the grid over a device mesh (`parallel.parallel_das_map`).
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from .._config import clean_sc_on_device, default_complex, default_float, device_cache
from ..classes import Signal
from ..helpers.gain_and_level import to_db
from ..helpers.other import (
    find_nearest_points_index_in_vector,
    fractional_octave_bandwidth,
)
from ..ops import cuda_das
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import _device_window
from .enums import SteeringVectorType

nxs = np.newaxis


def _host_map(map) -> np.ndarray:
    """A beamformer map as host float64 numpy: one fetch of a tensor."""
    if torch.is_tensor(map):
        map = map.detach().cpu()
    return np.asarray(map, np.float64)


class BasePoints:
    """Point-cloud container (grids, mic arrays;
    `_beamforming.py:14-193`)."""

    def __init__(self, positions: dict):
        for i in ("x", "y", "z"):
            assert i in positions, f"{i} values are missing"
        x = np.asarray(positions["x"]).squeeze()[None, ...]
        y = np.asarray(positions["y"]).squeeze()[None, ...]
        z = np.asarray(positions["z"]).squeeze()[None, ...]
        assert x.shape == y.shape and x.shape == z.shape, (
            "Shapes of x, y or z are not compatible"
        )
        new_r = np.concatenate([x, y, z], axis=0)
        self.coordinates = new_r.T

    @property
    def number_of_points(self):
        return self.coordinates.shape[0]

    @property
    def coordinates(self) -> np.ndarray:
        return self._coordinates.copy()

    @coordinates.setter
    def coordinates(self, new_r):
        assert isinstance(new_r, np.ndarray), (
            "R vectors array should be of type numpy.ndarray"
        )
        ndimensions = 3
        dimensions = ["x", "y", "z"]
        base_dimensions = ["x", "y", "z"]
        for i in range(new_r.shape[1]):
            if len(np.unique(new_r[:, i])) == 1:
                ndimensions -= 1
                dimensions.remove(base_dimensions[i])
        self.dim = dimensions
        self.ndim = ndimensions
        self._coordinates = new_r

    @property
    def extent(self):
        extent = {}
        for i, d in enumerate(["x", "y", "z"]):
            extent[d] = [
                np.min(self.coordinates[:, i]),
                np.max(self.coordinates[:, i]),
            ]
        return extent

    def get_distances_to_point(self, point) -> np.ndarray:
        """Euclidean distances from all points to given point(s), host
        float64 numpy (`helpers/other.py:131`): geometry is a few thousand
        points at most."""
        point = np.asarray(point, np.float64)
        if point.ndim == 1:
            point = point[None, ...]
        assert point.shape[1] == self.coordinates.shape[1], (
            f"Invalid shapes: {point.shape}, {self.coordinates.shape}"
        )
        c = np.asarray(self.coordinates, np.float64)
        sq = (
            np.sum(c**2, axis=1, keepdims=True)
            + np.sum(point**2, axis=1)[None, :]
            - 2.0 * c @ point.T
        )
        return np.sqrt(np.clip(sq, 0.0, None)).squeeze()

    def plot_points(self, projection: str | None = None):
        """Scatter plot of the points (`beamforming.py:109`): 3D for a
        3D cloud or ``projection="3d"``, else on its two (or one) varying
        coordinates."""
        from ..plots.plots import _plt

        plt = _plt()
        if projection is not None:
            projection = projection.lower()
        if self.ndim == 3 or projection == "3d":
            projection = "3d"
            threed = True
        elif projection in (None, "2d"):
            threed = False
            projection = None
        else:
            raise ValueError("projection must be 2d, 3d or None")
        fig, ax = plt.subplots(
            1, 1, figsize=(7, 5), subplot_kw={"projection": projection}
        )
        if threed:
            ax.scatter(
                xs=self.coordinates[:, 0],
                ys=self.coordinates[:, 1],
                zs=self.coordinates[:, 2],
            )
            ax.set_xlabel("$x$ / m")
            ax.set_ylabel("$y$ / m")
            ax.set_zlabel("$z$ / m")
        else:
            helper = dict(x=0, y=1, z=2)
            dim1 = helper[self.dim[0]]
            dim2 = dim1 - 1 if self.ndim == 1 else helper[self.dim[1]]
            ax.scatter(
                x=self.coordinates[:, dim1], y=self.coordinates[:, dim2]
            )
            ax.set_xlabel(f"${self.dim[0]}$ / m")
            ax.set_ylabel(f"${['x', 'y', 'z'][dim2]}$ / m")
        fig.tight_layout()
        return fig, ax

    def find_nearest_point(self, point):
        point = np.asarray(point).squeeze()
        assert point.ndim == 1, (
            "Passed vector is not broadcastable to a 1D-array"
        )
        assert len(point) == 3, (
            "Point must have exactly 3 dimensions (x, y, z)"
        )
        dist = self.get_distances_to_point(point)
        index = int(np.argmin(dist))
        return index, self.coordinates[index, :]


class Grid(BasePoints):
    """Beamforming grid (`beamforming.py:35-77`)."""

    def reconstruct_map_shape(self, map: np.ndarray) -> np.ndarray:
        return map


class Regular2DGrid(Grid):
    """Rectangular 2D grid on a coordinate plane
    (`beamforming.py:78-216`)."""

    def __init__(self, line1, line2, dimensions, value3):
        line1 = np.asarray(line1).squeeze()
        line2 = np.asarray(line2).squeeze()
        assert len(dimensions) == 2, "dimensions must have two entries"
        self.original_lengths = (len(line1), len(line2))
        self.dimensions_grid = tuple(dimensions)
        g1, g2 = np.meshgrid(line1, line2, indexing="ij")
        base = {"x": None, "y": None, "z": None}
        base[dimensions[0]] = g1.flatten()
        base[dimensions[1]] = g2.flatten()
        third = list(set(["x", "y", "z"]) - set(dimensions))[0]
        base[third] = np.ones(g1.size) * value3
        super().__init__(base)

    def reconstruct_map_shape(self, map_vector: np.ndarray) -> np.ndarray:
        assert map_vector.ndim == 1, (
            "The passed map should be a vector (flattened)"
        )
        assert len(map_vector) == self.number_of_points, (
            "Length of passed vector does not match the number of points"
        )
        return map_vector.reshape(self.original_lengths)

    def plot_map(self, map, range_db: float = 20):
        """The map in dB over the grid's plane (`beamforming.py:194`):
        ``map`` a tensor or numpy, flat or in the grid's shape."""
        from ..plots import general_matrix_plot

        map = _host_map(map)
        if map.ndim == 1:
            map = self.reconstruct_map_shape(map)
        ex = self.extent
        return general_matrix_plot(
            to_db(map, False, 500),
            range_x=ex[self.dimensions_grid[1]],
            range_y=ex[self.dimensions_grid[0]],
            range_z=range_db,
            xlabel=self.dimensions_grid[1] + " / m",
            ylabel=self.dimensions_grid[0] + " / m",
            zlabel="dBFS",
            colorbar=True,
            lower_origin=True,
        )


class Regular3DGrid(Grid):
    """Regular 3D grid (`beamforming.py:218-366`)."""

    def __init__(self, line_x, line_y, line_z):
        line_x = np.asarray(line_x).squeeze()
        line_y = np.asarray(line_y).squeeze()
        line_z = np.asarray(line_z).squeeze()
        self.lines = (line_x, line_y, line_z)
        assert all(n.ndim == 1 for n in self.lines), (
            "Shape of lines is invalid"
        )
        self.original_lengths = (len(line_x), len(line_y), len(line_z))
        xx, yy, zz = np.meshgrid(line_x, line_y, line_z, indexing="ij")
        super().__init__(
            {
                "x": xx.flatten(),
                "y": yy.flatten(),
                "z": zz.flatten(),
            }
        )

    def reconstruct_map_shape(self, map_vector: np.ndarray) -> np.ndarray:
        assert map_vector.ndim == 1, (
            "The passed map should be a vector (flattened)"
        )
        assert len(map_vector) == self.number_of_points, (
            "Length of passed vector does not match the number of points"
        )
        return map_vector.reshape(self.original_lengths)

    def plot_map(
        self,
        map,
        third_dimension: str,
        value_third_dimension: float,
        range_db: float = 20,
    ):
        """The map in dB on the grid's slice nearest
        ``value_third_dimension`` along ``third_dimension``
        (`beamforming.py:243`)."""
        from ..plots import general_matrix_plot

        map = _host_map(map)
        if map.ndim == 1 and len(map) == self.number_of_points:
            map = self.reconstruct_map_shape(map)
        assert map.shape == self.original_lengths, (
            "Map shape does not match grid shape"
        )
        if third_dimension == "x":
            ind = np.argmin(np.abs(value_third_dimension - self.lines[0]))
            map = map[ind, :, :]
            extent_dimensions = ["y", "z"]
        elif third_dimension == "y":
            ind = np.argmin(np.abs(value_third_dimension - self.lines[1]))
            map = map[:, ind, :]
            extent_dimensions = ["x", "z"]
        elif third_dimension == "z":
            ind = np.argmin(np.abs(value_third_dimension - self.lines[2]))
            map = map[:, :, ind]
            extent_dimensions = ["x", "y"]
        else:
            raise ValueError(f"{third_dimension} is not a valid dimension")
        ex = self.extent
        return general_matrix_plot(
            to_db(map, False, 500),
            range_x=ex[extent_dimensions[1]],
            range_y=ex[extent_dimensions[0]],
            range_z=range_db,
            xlabel=extent_dimensions[1] + " / m",
            ylabel=extent_dimensions[0] + " / m",
            zlabel="dBFS",
            colorbar=True,
            lower_origin=True,
        )


class LineGrid(Grid):
    """Line grid along a coordinate (`beamforming.py:368-424`)."""

    def __init__(self, line, dimension: str, value2: float, value3: float):
        line = np.atleast_1d(np.squeeze(line))
        assert line.ndim == 1, "Line has an invalid shape"
        dimension = dimension.lower()
        base_dimensions = ["x", "y", "z", "x"]
        assert dimension in base_dimensions, "Dimension should be x, y or z"
        ind = base_dimensions.index(dimension)
        base_dimensions.pop(ind)
        dim2 = base_dimensions[ind]
        dim3 = list(set(["x", "y", "z"]) - set([dimension, dim2]))[0]
        self.extent_dimension = dimension
        super().__init__(
            {
                dimension: line,
                dim2: np.ones(len(line)) * value2,
                dim3: np.ones(len(line)) * value3,
            }
        )


class MicArray(BasePoints):
    """Microphone array with aperture/frequency-range helpers
    (`beamforming.py:425-603`)."""

    def __init__(self, positions: dict):
        super().__init__(positions)
        self.__array_center_coordinates = None
        self.__array_center_channel_number = None
        self.__aperture = None
        self.__min_distance = None

    @staticmethod
    def from_xml(path: str) -> "MicArray":
        """Load an Acoular-style microphone-array geometry XML
        (``<pos x=".." y=".." z=".." />`` entries, like
        `example_data/array.xml`)."""
        import xml.etree.ElementTree as ET

        root = ET.parse(path).getroot()
        xs, ys, zs = [], [], []
        for pos in root.iter("pos"):
            xs.append(float(pos.attrib["x"]))
            ys.append(float(pos.attrib["y"]))
            zs.append(float(pos.attrib["z"]))
        assert xs, f"No <pos> entries found in {path}"
        return MicArray(
            dict(
                x=np.asarray(xs), y=np.asarray(ys), z=np.asarray(zs)
            )
        )

    @property
    def aperture(self):
        if self.__aperture is None:
            self.__compute_aperture_min_distance()
        return self.__aperture

    @property
    def min_distance(self):
        if self.__min_distance is None:
            self.__compute_aperture_min_distance()
        return self.__min_distance

    @property
    def array_center_coordinates(self):
        if self.__array_center_coordinates is None:
            self.__compute_array_center()
        return self.__array_center_coordinates

    @property
    def array_center_channel_number(self):
        if self.__array_center_channel_number is None:
            self.__compute_array_center()
        return self.__array_center_channel_number

    def __compute_aperture_min_distance(self):
        distances = self.get_distances_to_point(self.coordinates)
        np.fill_diagonal(distances, np.inf)
        self.__min_distance = np.min(distances)
        np.fill_diagonal(distances, -np.inf)
        self.__aperture = np.max(distances)

    def __compute_array_center(self):
        center = np.mean(self.coordinates, axis=0)
        distances = self.get_distances_to_point(center)
        ind = int(np.argmin(distances))
        self.__array_center_coordinates = self.coordinates[ind, :]
        self.__array_center_channel_number = ind

    def he_to_hz(self, he: float, c: float = 343) -> float:
        return he * c / self.aperture

    def hz_to_he(self, f_hz: float, c: float = 343) -> float:
        return f_hz * self.aperture / c

    def get_maximum_frequency_range(
        self, lowest_he: float = 4, c: float = 343
    ) -> list:
        return [self.he_to_hz(lowest_he, c=c), c / self.min_distance / 2]


# ========== Steering vector formulations ====================================
def classic_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 1 (`beamforming.py:1515-1553`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    return 1 / N * np.exp(-1j * k * diff)


def inverse_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 2 (`beamforming.py:1555-1598`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    amp = rti[nxs, :, :] / N / rt0[nxs, nxs, :]
    return amp * np.exp(-1j * k * diff)


def true_power_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 3 (`beamforming.py:1600-1645`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    rtj = np.sum(
        1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
    )
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    amp = 1 / rt0[nxs, nxs, :] / rti[nxs, :, :] / rtj[nxs, nxs, :]
    return amp * np.exp(-1j * k * diff)


def true_location_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 4 (`beamforming.py:1647-1702`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    rtj = N * np.sum(
        1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
    )
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    amp = 1 / rti[nxs, :, :] / np.sqrt(rtj)[nxs, nxs, :]
    return amp * np.exp(-1j * k * diff)


def _steering_amp_diff(formulation, grid: Grid, mic: MicArray):
    """Frequency-independent factorization of every Sarradj formulation:
    ``h[f, m, g] = amp[m, g] * exp(-1j * k[f] * diff[m, g])``. The small
    (M, G) factors go to the device (`amp_diff_to_torch`) and the DAS map
    builds ``h`` from them (`ops.cuda_das`)."""
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)  # (G,)
    rti = grid.get_distances_to_point(mic.coordinates).T  # (M, G)
    diff = rti - rt0[nxs, :]
    if formulation == SteeringVectorType.Classic:
        amp = np.full(rti.shape, 1.0 / N)
    elif formulation == SteeringVectorType.Inverse:
        amp = rti / N / rt0[nxs, :]
    elif formulation == SteeringVectorType.TruePower:
        rtj = np.sum(
            1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
        )
        amp = 1 / rt0[nxs, :] / rti / rtj[nxs, :]
    elif formulation == SteeringVectorType.TrueLocation:
        rtj = N * np.sum(
            1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
        )
        amp = 1 / rti / np.sqrt(rtj)[nxs, :]
    else:
        raise ValueError("Unsupported steering formulation")
    return amp, diff


class SteeringVector:
    """Dispatch for the 4 Sarradj formulations
    (`beamforming.py:605-648`)."""

    def __init__(
        self,
        formulation: SteeringVectorType = SteeringVectorType.TrueLocation,
    ):
        mapping = {
            SteeringVectorType.Classic: classic_steering,
            SteeringVectorType.Inverse: inverse_steering,
            SteeringVectorType.TruePower: true_power_steering,
            SteeringVectorType.TrueLocation: true_location_steering,
        }
        if formulation not in mapping:
            raise ValueError(
                "Incorrect formulation. Use either classic, inverse, "
                "true power or true location"
            )
        self.formulation = formulation
        self.get_vector = mapping[formulation]

    def get_amp_diff(self, grid: Grid, mic: MicArray):
        """Frequency-independent ``(amp (M, G), diff (M, G))`` factors of
        this formulation (see `_steering_amp_diff`)."""
        return _steering_amp_diff(self.formulation, grid, mic)


def amp_diff_to_torch(amp, diff, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host steering factors ``amp, diff (M, G)`` (`_steering_amp_diff`) as
    tensors of the package's default float on ``device``."""
    dt = default_float()
    return (
        torch.as_tensor(np.asarray(amp), dtype=dt, device=device),
        torch.as_tensor(np.asarray(diff), dtype=dt, device=device),
    )


def _simpson_uniform(y: np.ndarray, dx: float, axis: int = -1) -> np.ndarray:
    from scipy.integrate import simpson

    return simpson(y, dx=dx, axis=axis)


@device_cache(64)
def _simpson_weights(n: int, dx: float, dtype, device) -> torch.Tensor:
    """Exact weight vector of `scipy.integrate.simpson` over ``n`` uniform
    samples (its result on identity rows), on ``device``: the rule is
    linear in the data, so ``map @ w`` is the Simpson integral."""
    w = _simpson_uniform(np.eye(n), dx=dx, axis=-1)
    return torch.as_tensor(w, dtype=dtype, device=device)


_packed_quadratic_from_hp = cuda_das.packed_quadratic_from_hp
# the plain version of the fused DAS kernel
_das_map_core = cuda_das.das_map_plain


def _packed_quadratic_gf(h_re, h_im, c_re, c_im):
    """``Re(h^H C h) -> (G, F)`` for explicit split steering ``h (F, M,
    G)`` and matrix ``C (F, M, M)`` in the packed-real block form (see
    `_packed_quadratic_from_hp`)."""
    hp = torch.cat([h_re.transpose(1, 2), h_im.transpose(1, 2)], dim=-1)
    return _packed_quadratic_from_hp(hp, c_re, c_im)


def _quadratic_map(amp, diff, k, C):
    """``Re(h^H C_f h) -> (G, F)`` for a complex matrix ``C (F, M, M)`` on the
    device, the steering ``h[f, m, g] = amp[m, g] e^{-i k_f diff[m, g]}``
    built from ``amp, diff (M, G)`` and ``k (F,)``: `ops.cuda_das.das_map` on
    C's real and imaginary parts, so the DAS map kernel on a float32 CUDA
    tensor and its plain version otherwise (`_config.use_kernel`). C need not be Hermitian: ``Re(h^H C h) =
    Re(h^H (C + C^H) h) / 2`` for any C, and that is what the kernel sums."""
    return cuda_das.das_map(amp, diff, k, C.real, C.imag)


class BaseBeamformer:
    """Base beamformer (`beamforming.py:650-754`)."""

    def __init__(
        self, multi_channel_signal: Signal, mic_array: MicArray, c: float = 343
    ):
        assert isinstance(multi_channel_signal, Signal), (
            "Multi-channel signal must be of type Signal"
        )
        assert isinstance(mic_array, MicArray), (
            "mic_array should be of type MicArray"
        )
        assert c > 0, "Speed of sound should be bigger than 0"
        assert (
            multi_channel_signal.number_of_channels
            == mic_array.number_of_points
        ), "Number of channels in signal and microphone array do not match"
        self.signal = multi_channel_signal
        self.mics = mic_array
        self.c = c
        self.beamformer_type = "Base"

    def plot_setting(self):
        """The microphones, the grid (where there is one) and the
        array's centre microphone in 3D (`beamforming.py:582`)."""
        from ..plots.plots import _plt

        plt = _plt()
        fig, ax = plt.subplots(
            1, 1, figsize=(8, 5), subplot_kw={"projection": "3d"}
        )
        ax.scatter(
            self.mics.coordinates[:, 0],
            self.mics.coordinates[:, 1],
            self.mics.coordinates[:, 2],
        )
        if getattr(self, "grid", None) is not None:
            ax.scatter(
                self.grid.coordinates[:, 0],
                self.grid.coordinates[:, 1],
                self.grid.coordinates[:, 2],
            )
        ax.scatter(
            self.mics.array_center_coordinates[0],
            self.mics.array_center_coordinates[1],
            self.mics.array_center_coordinates[2],
            c="xkcd:dark green",
        )
        ax.set_xlabel("$x$ / m")
        ax.set_ylabel("$y$ / m")
        ax.set_zlabel("$z$ / m")
        ax.legend(["Mic Array", "Grid", "Center Mic"])
        return fig, ax

    def get_frequency_range_from_he(self, range_he=[4, 10]) -> list:
        assert len(range_he) == 2, "Range in He should have length two"
        return [self.mics.he_to_hz(i, self.c) for i in range_he]

    def show_info(self):
        txt = f"Beamformer: {self.beamformer_type}"
        txt = "\n" + txt + "\n" + "-" * len(txt) + "\n"
        txt += f"Aperture: {self.mics.aperture}\n"
        txt += f"Min mic distance: {self.mics.min_distance}\n"
        txt += (
            "Recommended f range: "
            f"{self.mics.get_maximum_frequency_range()}\n"
        )
        txt += f"Number of mics: {self.mics.number_of_points}\n"
        if getattr(self, "grid", None) is not None:
            txt += f"Number of grid points: {self.grid.number_of_points}\n"
        print(txt)


class BeamformerGridded(BaseBeamformer):
    """Beamformer with grid + steering vector
    (`beamforming.py:755-798`)."""

    def __init__(
        self,
        multi_channel_signal: Signal,
        mic_array: MicArray,
        grid: Grid,
        steering_vector: SteeringVector,
        c: float = 343,
    ):
        super().__init__(multi_channel_signal, mic_array, c)
        assert isinstance(steering_vector, SteeringVector), (
            "steering_vector should be of type SteeringVector"
        )
        assert issubclass(type(grid), Grid), "grid should be a Grid object"
        self.grid = grid
        self.st_vec = steering_vector

    def _finish_map(self, map_gf: torch.Tensor, f, clip_negative: bool) -> torch.Tensor:
        """Common map tail on the device: optional negative clip, Simpson
        integration over the analysis band as its exact weight vector (one
        bin: that bin), grid reshape, `self.map` assignment."""
        n_f = len(f)
        shape = self.grid.reconstruct_map_shape(
            np.zeros(self.grid.number_of_points)
        ).shape
        m = map_gf.clamp_min(0.0) if clip_negative else map_gf
        if n_f > 1:
            v = m @ _simpson_weights(n_f, float(f[1] - f[0]), m.dtype, m.device)
        else:
            v = m[:, 0]
        self.map = v.reshape(shape)
        return self.map.clone()

    def _amp_diff_device(self):
        """Frequency-independent steering factors ``(amp (M, G), diff (M,
        G))`` on the signal's device, cached per (steering vector,
        formulation, grid, mics, device, dtype): reassigning any of them
        invalidates the cache."""
        c = getattr(self, "_amp_diff_dev", None)
        dev, dt = self.signal.device, default_float()
        if (
            c is None
            or c[0] is not self.st_vec
            or c[1] is not self.st_vec.formulation
            or c[2] is not self.grid
            or c[3] is not self.mics
            or c[4] != (dev, dt)
        ):
            amp, diff = self.st_vec.get_amp_diff(self.grid, self.mics)
            # strong references keep the keys alive (plain id() keys could
            # alias a recycled address after garbage collection)
            c = (
                self.st_vec,
                self.st_vec.formulation,
                self.grid,
                self.mics,
                (dev, dt),
                *amp_diff_to_torch(amp, diff, dev),
            )
            self._amp_diff_dev = c
        return c[5], c[6]

    def _wave_numbers(self, f) -> torch.Tensor:
        """Wave numbers ``2π f / c`` of the band's frequencies ``f`` on the
        signal's device, in the default float; cached on the device (a copy
        from pageable host memory would wait for all queued device work)."""
        return _device_window(
            np.asarray(f * np.pi * 2 / self.c, np.float64).tobytes(), default_float(),
            self.signal.device,
        )

    def _steering(self, k: torch.Tensor) -> torch.Tensor:
        """Steering tensor ``h (F, M, G)`` of the default complex dtype, built
        on the device from the cached factors as the DAS map kernel builds
        it: ``amp · e^{-i k diff}`` with the phase in the default float."""
        amp, diff = self._amp_diff_device()
        return torch.polar(amp.expand(len(k), -1, -1), -(k[:, None, None] * diff))

    def _band_csm(self, center_frequency_hz, octave_fraction):
        """Frequencies (host), wave numbers and complex CSM ``(F, M, M)``
        (both on the signal's device) of the analysis band; the CSM is a view
        of the signal's cached one."""
        f, csm = self._csm_slice(center_frequency_hz, octave_fraction)
        return f, self._wave_numbers(f), csm

    def _band_ids(self, center_frequency_hz, octave_fraction, f):
        """Analysis-band bin range ``(id1, id2)`` on the CSM frequency
        vector ``f``; also records center/fraction/f_range on self."""
        self.center_frequency_hz = center_frequency_hz
        self.octave_fraction = octave_fraction
        self.f_range_hz = fractional_octave_bandwidth(
            center_frequency_hz, octave_fraction
        )
        ids = find_nearest_points_index_in_vector(self.f_range_hz, f)
        id1, id2 = int(ids[0]), int(ids[1])
        if id1 == id2:
            id2 += 1
        self.f_range_hz = np.array([f[id1], f[id2 - 1]])
        return id1, id2

    def _csm_slice(self, center_frequency_hz, octave_fraction):
        """Frequency vector (host) and complex CSM (device) of the analysis
        band only."""
        f, csm = self.signal._csm()
        id1, id2 = self._band_ids(center_frequency_hz, octave_fraction, f)
        return f[id1:id2], csm[id1:id2]

    def _csm_and_steering(self, center_frequency_hz, octave_fraction):
        """The band's frequencies, CSM ``(F, M, M)`` and full steering
        tensor ``h (F, M, G)``, both on the signal's device."""
        f, csm = self._csm_slice(center_frequency_hz, octave_fraction)
        wave_numbers = f * np.pi * 2 / self.c
        h = self.st_vec.get_vector(
            wave_numbers, grid=self.grid, mic=self.mics
        )
        return f, csm, torch.as_tensor(h, dtype=default_complex(), device=csm.device)


class BeamformerDASFrequency(BeamformerGridded):
    """Frequency-domain delay-and-sum (`beamforming.py:799-880`)."""

    beamformer_type = "Delay-and-sum (Frequency)"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        remove_csm_diagonal: bool = True,
        mesh=None,
    ) -> torch.Tensor:
        """DAS map over the fractional-octave band around
        ``center_frequency_hz``, integrated over the band (Simpson), in the
        grid's shape, as a tensor on the signal's device. With
        ``remove_csm_diagonal`` the CSM's diagonal is zeroed (scaled by
        ``n/(n-1)``) and negative map values are clipped. ``mesh``: a
        `parallel.Mesh` of more than one device splits the grid points over
        its first axis (`parallel.parallel_das_map`: B5 a shard, the band's
        CSM on every device), the grid padded with unit-amplitude,
        zero-delay points to a count the mesh divides
        (`dsptoolbox_tpu/beamforming/beamforming.py:870-905`)."""
        f_all, cre_full, cim_full = self.signal._get_csm_device()
        id1, id2 = self._band_ids(center_frequency_hz, octave_fraction, f_all)
        f = f_all[id1:id2]
        amp, diff = self._amp_diff_device()
        cre = cre_full[id1:id2]
        cim = cim_full[id1:id2]
        if remove_csm_diagonal:
            n_ch = self.signal.number_of_channels
            eye = torch.eye(cre.shape[-1], dtype=cre.dtype, device=cre.device)
            off = (1.0 - eye) * (n_ch / (n_ch - 1))
            cre = cre * off
            cim = cim * off
        if mesh is not None and mesh.devices.size > 1:
            from ..parallel import parallel_das_map

            G = amp.shape[1]
            pad = (-G) % int(mesh.shape[mesh.axis_names[0]])
            if pad:
                amp = torch.cat([amp, amp.new_ones((amp.shape[0], pad))], dim=1)
                diff = torch.cat([diff, diff.new_zeros((diff.shape[0], pad))], dim=1)
            map_gf = parallel_das_map(amp, diff, self._wave_numbers(f),
                                      torch.complex(cre, cim), mesh)[:G].to(cre.device)
        else:
            map_gf = cuda_das.das_map(amp, diff, self._wave_numbers(f), cre, cim)
        return self._finish_map(map_gf, f, bool(remove_csm_diagonal))


class BeamformerCleanSC(BeamformerGridded):
    """CLEAN-SC deconvolution (Sijtsma 2007;
    `beamforming.py:883-1008`)."""

    beamformer_type = "CleanSC"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        maximum_iterations: int | None = None,
        safety_factor: float = 0.5,
        remove_csm_diagonal: bool = False,
    ) -> torch.Tensor:
        """CLEAN-SC map over the band, integrated (Simpson), in the grid's
        shape, on the signal's device. ``maximum_iterations`` defaults to
        twice the channels; ``remove_csm_diagonal`` zeroes the CSM's diagonal
        (without DAS's ``n/(n-1)`` scale)."""
        f, map_gf = self._bin_maps(center_frequency_hz, octave_fraction,
                                   maximum_iterations, safety_factor, remove_csm_diagonal)
        return self._finish_map(map_gf, f, False)

    def _bin_maps(self, center_frequency_hz, octave_fraction, maximum_iterations=None,
                  safety_factor=0.5, remove_csm_diagonal=False):
        """``(f, map (G, F))``: the deconvolved map of each bin. The initial
        map is `_quadratic_map` on the CSM; the deconvolution runs as one
        batched device loop over all bins (`_clean_sc_device_core`) or, with
        `_config.clean_sc_on_device` False, per bin on the host
        (`clean_sc_deconvolve`, the JAX package's oracle path)."""
        if maximum_iterations is None:
            maximum_iterations = self.signal.number_of_channels * 2
        else:
            assert maximum_iterations > 0, (
                "Number of iterations must be positive"
            )
        assert 0 < safety_factor <= 1, (
            f"{safety_factor} is not valid. The safety factor (loop gain) "
            "should be in ]0, 1]"
        )
        f, k, csm = self._band_csm(center_frequency_hz, octave_fraction)
        if remove_csm_diagonal:
            eye = torch.eye(csm.shape[-1], dtype=csm.real.dtype, device=csm.device)
            csm = csm * (1 - eye)
        amp, diff = self._amp_diff_device()
        map0 = _quadratic_map(amp, diff, k, csm)
        if clean_sc_on_device():
            return f, _clean_sc_device_core(
                map0, csm, self._steering(k), int(maximum_iterations),
                bool(remove_csm_diagonal), float(safety_factor),
            )
        h = self.st_vec.get_vector(f * np.pi * 2 / self.c, grid=self.grid, mic=self.mics)
        h_H = np.swapaxes(h, 1, 2).conjugate()
        map_np = map0.cpu().numpy()
        csm_np = csm.cpu().numpy()
        for find in range(len(f)):
            map_np[:, find] = clean_sc_deconvolve(
                map_np[:, find], csm_np[find], h[find], h_H[find],
                maximum_iterations, remove_csm_diagonal, safety_factor,
            ).real
        return f, torch.as_tensor(map_np, device=map0.device)


def _clean_sc_device_core(
    map0: torch.Tensor,  # (G, F) real initial map
    C: torch.Tensor,  # (F, M, M) complex CSM (diagonal already removed if requested)
    h: torch.Tensor,  # (F, M, G) complex steering
    maximum_iterations: int,
    remove_diagonal_csm: bool,
    safety_factor: float,
) -> torch.Tensor:
    """CLEAN-SC deconvolution of all frequency bins in lockstep
    (`dsptoolbox_tpu/beamforming/beamforming.py:1545`, the reference's
    `_beamforming.py:194-297`); returns the clean map ``(G, F)``.

    Every bin runs all ``maximum_iterations`` iterations; a bin that met the
    stopping rule (``||D_1||_1 >= ||D_0||_1``, the largest column sum) is
    inactive from then on and changes nothing. As in the reference, an
    iteration deposits its peak before the stopping check. Every decision
    stays on the device (the peak's index is a tensor that `gather` and
    `scatter_add_` use): the loop never waits for the device. ``D_0`` enters
    only through its norm, which is carried instead of the matrix. The
    correction ``Re(h^H G h)`` is ``G @ h`` and a conjugate product summed
    over the mics."""
    F, M, G = h.shape
    sf = float(safety_factor)
    map_ = map0.T.contiguous()  # (F, G)
    second = torch.zeros_like(map_)
    D1 = C
    n0 = torch.linalg.matrix_norm(C * 2.0, ord=1)  # the largest column sum
    active = torch.ones(F, dtype=torch.bool, device=map_.device)
    one = torch.ones((F, 1, 1), dtype=h.dtype, device=h.device)
    off = None
    if remove_diagonal_csm:
        off = 1 - torch.eye(M, dtype=map_.dtype, device=map_.device)
    for _ in range(maximum_iterations):
        i = map_.argmax(dim=1, keepdim=True)  # (F, 1)
        p = map_.gather(1, i)  # (F, 1)
        second.scatter_add_(1, i, torch.where(active[:, None], p * sf, 0.0))
        n1 = torch.linalg.matrix_norm(D1, ord=1)
        cont = active & (n1 < n0)
        w = h.gather(2, i[:, None, :].expand(F, M, 1))  # (F, M, 1)
        wsq = (w.conj() * w).mT
        D_ = (D1 @ w) / p[:, :, None]
        h_ = w
        for _ in range(20):  # h_ = (D_ + H w) / sqrt(1 + H·|w|²), H = |h_|²
            H = h_.conj() * h_
            h_ = torch.addcmul(D_, H, w) / torch.sqrt(torch.baddbmm(one, wsq, H))
        G_ = (h_ @ h_.mH) * p[:, :, None]  # (F, M, M)
        if off is not None:
            G_ = G_ * off
        corr = torch.linalg.vecdot(h, G_ @ h, dim=1).real  # (F, G)
        map_ = torch.where(cont[:, None], map_ - corr * sf, map_)
        n0 = torch.where(cont, n1, n0)
        D1 = torch.where(cont[:, None, None], D1 - sf * G_, D1)
        active = cont
    return second.T


def clean_sc_deconvolve(
    map: np.ndarray,
    csm: np.ndarray,
    h: np.ndarray,
    h_H: np.ndarray,
    maximum_iterations: int,
    remove_diagonal_csm: bool,
    safety_factor: float,
) -> np.ndarray:
    """CLEAN-SC of one bin on the host, in numpy (`_beamforming.py:194-297`;
    the JAX package's oracle, `beamforming.py:1621`). ``map`` is modified in
    place; returns the clean map."""
    D = np.append(csm[None, ...] * 2, csm[None, ...], axis=0)
    second_map = np.zeros_like(map)
    for _ in range(maximum_iterations):
        maximum_power_ind = int(np.argmax(map))
        maximum_power = map[maximum_power_ind]
        second_map[maximum_power_ind] += maximum_power * safety_factor
        if np.linalg.norm(D[1], ord=1) >= np.linalg.norm(D[0], ord=1):
            break
        w_max = h[:, maximum_power_ind]
        h_ = w_max.copy()
        w_max_squared = w_max.conjugate() * w_max
        D_ = D[1] @ w_max / maximum_power
        for _ in range(20):
            H = h_.conjugate() * h_
            h_ = (D_ + H * w_max) / np.sqrt(1 + H @ w_max_squared)
        G = np.outer(h_, h_.conjugate()) * maximum_power
        if remove_diagonal_csm:
            np.fill_diagonal(G, 0)
        correction = np.einsum("gm,mg->g", h_H @ G, h).real
        map -= correction * safety_factor
        temp = D[1].copy()
        D[1] = D[1] - safety_factor * G
        D[0] = temp
    return second_map


class BeamformerOrthogonal(BeamformerGridded):
    """Orthogonal beamforming (Sarradj 2010;
    `beamforming.py:1010-1125`)."""

    beamformer_type = "Orthogonal (Grid)"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        number_eigenvalues: int | None = None,
    ) -> torch.Tensor:
        """Each of the CSM's ``number_eigenvalues`` largest eigenvalues
        (default: half the channels) is put at the grid point where its
        eigenvector's map ``|h^H v|^2`` peaks. The eigendecomposition is host
        float64 (the source subspace's argmax is sensitive to perturbations
        of the eigenvectors); the maps and the scatter run on the device."""
        if number_eigenvalues is None:
            number_eigenvalues = self.signal.number_of_channels // 2
        else:
            assert (
                number_eigenvalues <= self.signal.number_of_channels
            ), "Number of eigenvalues cannot be more than number of microphones"
            assert number_eigenvalues > 0, (
                "At least one eigenvalue of the CSM must be regarded"
            )
        f, k, csm = self._band_csm(center_frequency_hz, octave_fraction)
        w, v = np.linalg.eigh(csm.cpu().numpy().astype(np.complex128))
        E = int(number_eigenvalues)
        # the E largest eigenpairs, largest first (the reference iterates
        # from the last, ascending order)
        v = torch.as_tensor(np.ascontiguousarray(v[:, :, ::-1][:, :, :E]),
                            dtype=default_complex(), device=csm.device)
        w = torch.as_tensor(np.ascontiguousarray(w[:, ::-1][:, :E]),
                            dtype=default_float(), device=csm.device)
        idx, vals = _orthogonal_picks(self._steering(k), v, w)
        return self._finish_map(_orthogonal_scatter(idx, vals, self.grid.number_of_points),
                                f, False)


def _orthogonal_picks(h: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> tuple:
    """Each eigenvalue's grid point and value, ``(idx, vals)`` of shape
    ``(F, E)``, for steering ``h (F, M, G)``, eigenvectors ``v (F, M, E)``
    and eigenvalues ``w (F, E)``, largest first: the argmax over the grid of
    ``|h^H v|^2`` and the eigenvalue times that maximum. The map runs as
    one packed-real product: ``(hre - i him)^T (vre + i vim)`` has real part
    ``[hre|him]·[vre; vim]`` and imaginary part ``[hre|him]·[vim; -vre]``."""
    E = v.shape[-1]
    hp = torch.cat([h.real, h.imag], dim=1).transpose(1, 2)  # (F, G, 2M)
    vre, vim = v.real, v.imag
    v2 = torch.cat([torch.cat([vre, vim], dim=-1), torch.cat([vim, -vre], dim=-1)],
                   dim=-2)  # (F, 2M, 2E)
    t = hp @ v2
    prod = t[..., :E] ** 2 + t[..., E:] ** 2  # (F, G, E)
    idx = prod.argmax(dim=1)
    return idx, prod.gather(1, idx[:, None, :])[:, 0, :] * w


def _orthogonal_scatter(idx: torch.Tensor, vals: torch.Tensor, G: int) -> torch.Tensor:
    """The map ``(G, F)`` with ``vals[f, e]`` at ``idx[f, e]``: the reference
    overwrites ``map[g, f]`` eigenvalue by eigenvalue, so where several pick
    one grid point the last (smallest considered) wins; the scatter keeps,
    per cell, the largest writer."""
    F, E = idx.shape
    writer = torch.arange(E, device=idx.device).expand(F, E)
    last = torch.full((F, G), -1, dtype=writer.dtype, device=idx.device).scatter_reduce(
        1, idx, writer, reduce="amax")
    return torch.where(last >= 0, vals.gather(1, last.clamp_min(0)), 0.0).T


class BeamformerFunctional(BeamformerGridded):
    """Functional beamforming (Dougherty 2014;
    `beamforming.py:1127-1221`)."""

    beamformer_type = "Functional"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        gamma: float = 10,
    ) -> torch.Tensor:
        """``(h^H C^{1/γ} h / |h|^2)^γ · |h|^2`` over the band, integrated.
        The matrix power comes from a host float64 SVD (the eigenstructure of
        a near-rank-deficient CSM is sensitive to precision); the numerator is
        `_quadratic_map` on it."""
        f, k, csm = self._band_csm(center_frequency_hz, octave_fraction)
        u, s, vh = np.linalg.svd(csm.cpu().numpy().astype(np.complex128))
        csm_pow = torch.as_tensor((u * s[:, None, :] ** (1 / gamma)) @ vh,
                                  dtype=default_complex(), device=csm.device)
        amp, diff = self._amp_diff_device()
        num = _quadratic_map(amp, diff, k, csm_pow)
        norm = (amp * amp).sum(dim=0)[:, None]  # |h|^2, the same in every bin
        return self._finish_map((num / norm) ** float(gamma) * norm, f, False)


class BeamformerMVDR(BeamformerGridded):
    """Minimum-variance distortionless response (Capon;
    `beamforming.py:1223-1315`)."""

    beamformer_type = "MVDR"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        gamma: float = 10,
        solve_on_device: bool = True,
    ) -> torch.Tensor:
        """MVDR map ``1 / h^H C^-1 h`` over the band, integrated.

        The default path runs on the device: per-bin diagonal equilibration,
        diagonal loading and a batched LU solve (`_map_device_loaded`).
        ``gamma`` is the loading level in dB below each mic's auto-power: the
        solved matrix is ``C + 10^(-gamma/10)·diag(C)``. The reference
        accepts ``gamma`` but never uses it and inverts the raw CSM in
        float64; ``solve_on_device=False`` does that (host float64
        `np.linalg.inv`, which raises on a singular CSM) and evaluates the
        quadratic form on C⁻¹ with `_quadratic_map`."""
        if solve_on_device:
            f, map_gf = self._map_device_loaded(center_frequency_hz, octave_fraction, gamma)
            return self._finish_map(map_gf, f, False)
        f, k, csm = self._band_csm(center_frequency_hz, octave_fraction)
        csm_1 = torch.as_tensor(np.linalg.inv(csm.cpu().numpy().astype(np.complex128)),
                                dtype=default_complex(), device=csm.device)
        amp, diff = self._amp_diff_device()
        return self._finish_map(1 / _quadratic_map(amp, diff, k, csm_1), f, False)

    def _map_device_loaded(self, center_frequency_hz, octave_fraction, gamma):
        """``(f, map (G, F))`` of the loaded solve on the device: with ``D =
        diag(C)`` and ``γ = 10^(-gamma/10)`` the system ``C + γ·D`` is solved
        as ``D^½ (C̃ + γI) D^½``, ``C̃`` of unit diagonal. A batched LU with
        partial pivoting, not Cholesky: the CSM stores the element-wise
        square root of the cross-powers for amplitude scalings, which is
        Hermitian but indefinite, so no positive-definite factorization
        exists."""
        f, k, C = self._band_csm(center_frequency_hz, octave_fraction)
        d = torch.diagonal(C, dim1=-2, dim2=-1).real  # (F, M)
        s = torch.rsqrt(d.clamp_min(float(np.finfo(np.float32).tiny)))
        # two-step scaling: s⊗s overflows float32 when a bin has no energy
        # (s ~ 1.8e19, s² = inf, 0·inf = NaN); scaling by each factor in
        # turn stays finite (|C_ij| <= √(d_i d_j))
        Cn = (C * s[:, :, None]) * s[:, None, :]
        Cn.diagonal(dim1=-2, dim2=-1).add_(10.0 ** (-gamma / 10.0))
        hs = self._steering(k) * s[:, :, None]  # (F, M, G)
        x = torch.linalg.solve(Cn, hs)
        # h^H (C+γD)^-1 h = (D^-½h)^H (C̃+γI)^-1 (D^-½h); its real part, as
        # the reference takes .real of the product
        denom = torch.linalg.vecdot(hs, x, dim=1).real  # (F, G)
        return f, (1.0 / denom).T


def _real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def _delay_filter_response(h, s, L, cdtype):
    """rfft of the sparse fractional-delay FIRs: ``H[..., f] =
    e^{-2πi f s/L} · Σ_k h[..., k] e^{-2πi f k/L}`` — a (K, F) DFT
    matmul plus an elementwise phase ramp."""
    rdt = _real_dtype(cdtype)
    K = h.shape[-1]
    F = L // 2 + 1
    f = torch.arange(F, dtype=rdt, device=h.device)
    k = torch.arange(K, dtype=rdt, device=h.device)
    E = torch.exp((-2j * np.pi / L) * torch.outer(k, f)).to(cdtype)  # (K, F)
    Hk = h.to(cdtype) @ E  # (..., F)
    phase = torch.exp((-2j * np.pi / L) * (s.to(rdt)[..., None] * f)).to(cdtype)
    return Hk * phase


def _monopole_projection_kernel(x, s, h, amp, L, t_out):
    """``y[t, d] = amp[d] * (h[d] ∗ x)[t - s[d]]`` — one source signal
    delayed to D destinations via one rfft + response multiply + one
    batched irfft. x (T,); s/amp (D,); h (D, K). Returns (t_out, D)."""
    X = torch.fft.rfft(x, n=L)
    Hs = _delay_filter_response(h, s, L, X.dtype)  # (D, F)
    y = torch.fft.irfft(X[None, :] * Hs, n=L, dim=-1)[:, :t_out]
    return (y * amp[:, None]).T


# bytes of the (M, Gc, F) complex response of one grid chunk of the
# time-domain DAS (a module constant, so that tests can force many chunks)
_DAS_TIME_CHUNK_BYTES = 64e6


def _rfft_rows(x: torch.Tensor, L: int) -> torch.Tensor:
    """rfft of the mic rows ``(M, T) → (M, F)``, zero-padded to ``L``: one
    call shared by all grid chunks."""
    return torch.fft.rfft(x, n=L, dim=-1)


def _das_time_chunk(X, s, h, w, L: int, t_out: int) -> torch.Tensor:
    """Delay-and-sum over one grid chunk, in the frequency domain:
    ``y[g, t] = Σ_m w[m, g] (h[m, g] ∗ x_m)[t - s[m, g]]`` as one response
    build per (mic, point), one product summed over the mics and one batched
    inverse FFT. ``X (M, F) = rfft(x, L)``; ``s, w (M, Gc)``; ``h (M, Gc,
    K)``. Returns ``(Gc, t_out)``."""
    Hs = _delay_filter_response(h, s, L, X.dtype)  # (M, Gc, F)
    Y = torch.einsum("mgf,mf->gf", w.to(X.dtype)[..., None] * Hs, X)
    return torch.fft.irfft(Y, n=L, dim=-1)[:, :t_out]


def _das_time_finish(parts, n_keep: int) -> torch.Tensor:
    """The grid chunks concatenated, the last chunk's padding dropped,
    transposed to ``(T, G)``."""
    return torch.cat(parts, dim=0)[:n_keep].T


class BeamformerDASTime(BaseBeamformer):
    """Time-domain delay-and-sum (`beamforming.py:1317-1395`)."""

    def __init__(
        self,
        multi_channel_signal: Signal,
        mic_array: MicArray,
        grid: Grid,
        c: float = 343,
    ):
        super().__init__(multi_channel_signal, mic_array, c)
        assert issubclass(type(grid), Grid), "grid should be a Grid object"
        self.grid = grid
        self.beamformer_type = "Delay-and-sum (Time)"

    def get_beamformer_output(self) -> Signal:
        """The signal steered at each grid point, ``(T + longest delay, G)``,
        on the signal's device: every (point, mic) pair gets the same
        Kaiser-sinc fractional-delay FIR as the reference's per-channel
        `fractional_delay`, weighted by the mic's distance over the mic
        count, and the mics are summed. One batched frequency-domain program
        per grid chunk of `_DAS_TIME_CHUNK_BYTES` of response.

        The delay's phase ramp is formed as ``s·f`` in the default float
        (`_delay_filter_response`), exact while the product of the integer
        delay and the bin index stays below 2^24 in float32."""
        from ..ops.fft_conv import next_fast_len
        from ..standard.backend import fractional_delay_filter_batch

        ds = self.mics.get_distances_to_point(self.grid.coordinates)
        if ds.ndim == 1:
            ds = ds[:, None]
        fs = self.signal.sampling_rate_hz
        min_distance = np.min(ds)
        r0 = np.max(ds)
        longest_delay = int((r0 - min_distance) / self.c * fs + 2)
        td = self.signal.time_data  # (T, M)
        T = td.shape[0]
        total_length = T + longest_delay
        M, G = ds.shape
        dt = default_float()
        # geometry-keyed cache of the designed chunk tensors: repeated
        # outputs over the same (mics, grid) skip the Kaiser-sinc design and
        # the uploads
        key = (
            hash(np.ascontiguousarray(ds).tobytes()),
            float(self.c), int(fs), int(T), dt, td.device,
        )
        cached = getattr(self, "_das_time_cache", None)
        if cached is None or cached[0] != key:
            s, h = fractional_delay_filter_batch(((r0 - ds) / self.c * fs).ravel(), 30, 60)
            N = h.shape[1]
            s = s.reshape(M, G)
            h = h.reshape(M, G, N)
            # the reference's weighting: each delayed channel is scaled by
            # its distance, the sum divided by the mic count
            w = ds / M  # (M, G)
            L = next_fast_len(total_length + int(max(0, s.max())) + N + 16, real=True)
            bytes_per_point = M * (L // 2 + 1) * 8
            g_chunk = int(max(1, min(G, _DAS_TIME_CHUNK_BYTES // max(1, bytes_per_point))))
            chunks = []
            for lo in range(0, G, g_chunk):
                hi = min(G, lo + g_chunk)
                pad = g_chunk - (hi - lo)

                def part(a, dtype):
                    widths = ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2)
                    return torch.as_tensor(np.pad(a[:, lo:hi], widths, mode="edge"),
                                           dtype=dtype, device=td.device)

                chunks.append((part(s, torch.int64), part(h, dt), part(w, dt)))
            cached = (key, L, chunks)
            self._das_time_cache = cached
        _, L, chunks = cached
        X = _rfft_rows(td.T, L)  # (M, F)
        outs = [_das_time_chunk(X, s_c, h_c, w_c, L, total_length)
                for s_c, h_c, w_c in chunks]
        return self.signal.copy_with_new_time_data(_das_time_finish(outs, G))


class MonopoleSource:
    """Omnidirectional point source (`beamforming.py:1397-1459`)."""

    def __init__(self, signal: Signal, coordinates):
        assert signal.number_of_channels == 1, (
            "Only signals with a single channel are supported"
        )
        coordinates = np.squeeze(coordinates)
        assert len(coordinates) == 3 and coordinates.ndim == 1, (
            "Coordinates should have exactly three values"
        )
        self.emitted_signal = signal
        self.coordinates = coordinates

    def get_signals_on_array(self, mics: MicArray, c: float = 343) -> Signal:
        """Project the source onto every mic with one batched Kaiser-sinc
        fractional-delay program (delay + 1/(1+r) spreading loss per mic),
        on the emitted signal's device."""
        from ..ops.fft_conv import next_fast_len
        from ..standard.backend import fractional_delay_filter_batch

        distances = mics.get_distances_to_point(self.coordinates)  # (M,)
        fs = self.emitted_signal.sampling_rate_hz
        if self.emitted_signal.is_complex_signal:
            warn(
                "Imaginary time data will be ignored in this function. "
                "Delay it manually by creating another signal object, if "
                "needed."
            )
        x = self.emitted_signal.time_data[:, 0]  # (T,)
        T = x.shape[0]
        assert np.max(distances) / c * fs < T, (
            "Delay too large for the given signal"
        )
        dt = default_float()
        # geometry-keyed cache: repeated projections of the same source
        # onto the same array skip the filter design and the uploads
        key = (
            hash(np.ascontiguousarray(distances).tobytes()),
            float(c), int(fs), int(T), dt, x.device,
        )
        cached = getattr(self, "_projection_cache", None)
        if cached is None or cached[0] != key:
            s, h = fractional_delay_filter_batch(distances / c * fs, 30, 60)
            amp = 1.0 / (1.0 + distances)  # (M,)
            N = h.shape[1]
            L = next_fast_len(T + int(max(0, s.max())) + N + 16, real=True)
            cached = (
                key,
                torch.as_tensor(s, device=x.device),
                torch.as_tensor(h, dtype=dt, device=x.device),
                torch.as_tensor(amp, dtype=dt, device=x.device),
                L,
            )
            self._projection_cache = cached
        _, s_t, h_t, amp_t, L = cached
        out = _monopole_projection_kernel(x, s_t, h_t, amp_t, L, T)
        return self.emitted_signal.copy_with_new_time_data(out)


def _pad_trim_signal(signal: Signal, length: int) -> Signal:
    return signal.copy_with_new_time_data(
        pad_trim_axis(signal.time_data, length, axis=0)
    )


def mix_sources_on_array(sources, mics: MicArray, c: float = 343) -> Signal:
    """Combine several monopole sources on an array
    (`beamforming.py:1461-1513`)."""
    if isinstance(sources, MonopoleSource):
        sources = [sources]
    assert len(sources) > 0, (
        "There must be at least one source to project on array"
    )
    assert all(isinstance(i, MonopoleSource) for i in sources), (
        "All sources in list should be of type Source"
    )
    sources = list(sources)
    multi = sources[0].get_signals_on_array(mics, c)
    total_length = multi.length_samples
    sources.pop(0)
    for s in sources:
        if total_length != s.emitted_signal.length_samples:
            warn(
                "Emitted signals from sources differ in length. Trimming "
                "to shortest will be done"
            )
            total_length = min(total_length, s.emitted_signal.length_samples)
            multi = _pad_trim_signal(multi, total_length)
            s.emitted_signal = _pad_trim_signal(s.emitted_signal, total_length)
        ns = s.get_signals_on_array(mics, c)
        multi.time_data = multi.time_data + ns.time_data
    return multi

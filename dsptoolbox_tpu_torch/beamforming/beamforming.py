"""Frequency-domain delay-and-sum beamforming (`dsptoolbox_tpu/beamforming/beamforming.py`).

Geometry (points, grids, microphone arrays) and the four Sarradj steering
formulations are host float64 numpy, copied from the JAX package. The map
``map[g, f] = Re(h^H C_f h)`` runs on the signal's device: the CSM comes from
`Signal` (`ops.spectral.csm_welch`, the framing kernel on a CUDA tensor),
the steering factors ``amp, diff (M, G)`` are moved there once and cached,
and `ops.cuda_das.das_map` builds the steering and evaluates the quadratic
form (the fused CUDA kernel on a float32 CUDA tensor). `MonopoleSource`
projects a source onto an array with one batched fractional-delay FFT
program.

Ported so far: `BeamformerDASFrequency`. MVDR, CLEAN-SC, orthogonal,
functional and time-domain DAS beamformers, the plots and the mesh-parallel
map are not.
"""

from __future__ import annotations

from functools import lru_cache
from warnings import warn

import numpy as np
import torch

from .._config import default_complex, default_float
from ..classes import Signal
from ..helpers.other import (
    find_nearest_points_index_in_vector,
    fractional_octave_bandwidth,
)
from ..ops import cuda_das
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import _device_window
from .enums import SteeringVectorType

nxs = np.newaxis


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


@lru_cache(maxsize=64)
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
        f, csm = self.signal.get_csm()
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
        ``n/(n-1)``) and negative map values are clipped."""
        if mesh is not None:
            raise NotImplementedError(
                "the mesh-parallel DAS map is not ported yet"
            )
        f_all, cre_full, cim_full = self.signal._get_csm_device()
        id1, id2 = self._band_ids(center_frequency_hz, octave_fraction, f_all)
        f = f_all[id1:id2]
        wave_numbers = f * np.pi * 2 / self.c
        amp, diff = self._amp_diff_device()
        cre = cre_full[id1:id2]
        cim = cim_full[id1:id2]
        if remove_csm_diagonal:
            n_ch = self.signal.number_of_channels
            eye = torch.eye(cre.shape[-1], dtype=cre.dtype, device=cre.device)
            off = (1.0 - eye) * (n_ch / (n_ch - 1))
            cre = cre * off
            cim = cim * off
        # cached on the device: a copy from pageable host memory would wait
        # for all queued device work
        k = _device_window(
            np.asarray(wave_numbers, np.float64).tobytes(), amp.dtype, amp.device
        )
        map_gf = cuda_das.das_map(amp, diff, k, cre, cim)
        return self._finish_map(map_gf, f, bool(remove_csm_diagonal))


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

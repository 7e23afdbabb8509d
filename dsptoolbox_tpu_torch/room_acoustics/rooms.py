"""Room and ShoeboxRoom models (`dsptoolbox_tpu/room_acoustics/rooms.py`):
Sabine checks, room modes, mixing time, detailed absorption (host numpy)
and the analytical transfer function, whose modal sum over (modes ×
frequencies) runs in torch on `_config.default_device()`. Not ported: the
transfer function's plot.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import default_complex, default_device, default_float


class Room:
    """Generic room with volume, area and Sabine-consistent RT/absorption."""

    def __init__(
        self,
        volume_m3: float,
        area_m2: float,
        t60_s: float | None = None,
        absorption_coefficient: float | None = None,
    ):
        assert area_m2 > 0, "Room surface area has to be positive"
        self.volume = volume_m3
        self.area = area_m2
        if t60_s is None:
            assert absorption_coefficient is not None, (
                "Absorption coefficient should not be None"
            )
            assert 0 < absorption_coefficient <= 1, (
                "Absorption coefficient should be ]0, 1]"
            )
            self.absorption_coefficient = absorption_coefficient
            self.t60_s = (
                0.161 * self.volume / self.area / self.absorption_coefficient
            )
        if absorption_coefficient is None:
            assert t60_s is not None, "T60 should not be None"
            absorption_coefficient = 0.161 * self.volume / self.area / t60_s
            assert 0 < absorption_coefficient <= 1, (
                "Given reverberation time is not valid. Absorption "
                "coefficient should be ]0, 1] and not "
                f"{absorption_coefficient}"
            )
            self.t60_s = t60_s
            self.absorption_coefficient = absorption_coefficient
        self.schroeders_frequency = 2000 * np.sqrt(self.t60_s / self.volume)
        self.critical_distance_m = 0.057 * np.sqrt(self.volume / self.t60_s)

    @property
    def volume(self):
        return self.__volume

    @volume.setter
    def volume(self, new_volume):
        assert new_volume > 0, "Room volume has to be positive"
        self.__volume = new_volume

    @property
    def area(self):
        return self.__area

    @area.setter
    def area(self, new_area):
        assert new_area > 0, "Room volume has to be positive"
        self.__area = new_area

    def modal_density(self, f_hz, c: float = 343):
        """Modal density at given frequencies
        (`_room_acoustics.py:356-380`)."""
        return (
            4 * np.pi * np.asarray(f_hz) ** 2 * self.volume / c**3
            + np.pi * np.asarray(f_hz) * self.area / 2 / c**2
        )


class ShoeboxRoom(Room):
    """Rectangular room with image-source synthesis support."""

    def __init__(
        self,
        dimensions_m,
        t60_s: float | None = None,
        absorption_coefficient: float | None = None,
    ):
        dimensions_m = np.atleast_1d(np.squeeze(dimensions_m))
        assert len(dimensions_m) == 3, (
            "Dimensions for a shoebox room should have length 3 (x, y, z)"
        )
        assert np.all(dimensions_m > 0), "Room dimensions must be positive"
        self.dimensions_m = dimensions_m
        volume = float(np.prod(dimensions_m))
        area = float(np.roll(dimensions_m, 1) @ dimensions_m * 2)
        super().__init__(volume, area, t60_s, absorption_coefficient)
        self.mixing_time_s = None

    def check_if_in_room(self, coordinates_m) -> bool:
        coordinates_m = np.squeeze(coordinates_m)
        return bool(np.all(coordinates_m <= self.dimensions_m))

    def get_mixing_time(
        self,
        mode: str = "perceptual",
        n_reflections: int = 400,
        c: float = 343,
    ) -> float:
        """Perceptual (Lindau) or physical mixing time
        (`_room_acoustics.py:452-509`)."""
        mode = mode.lower()
        assert mode in ("perceptual", "physical"), (
            f"{mode} is not supported. Use perceptual or physical"
        )
        if mode == "perceptual":
            mixing_time_s = (np.sqrt(self.volume) * 0.58 + 21.2) * 1e-3
        else:
            assert n_reflections > 0, "n_reflections must be positive"
            mixing_time_s = np.sqrt(
                n_reflections * self.volume / (4 * np.pi * c**3)
            )
        self.mixing_time_s = float(mixing_time_s)
        return self.mixing_time_s

    def get_room_modes(
        self, max_order: int = 6, c: float = 343.0
    ) -> np.ndarray:
        """Hard-wall room modes, vectorized over the full order lattice
        (`_room_acoustics.py:511-556`)."""
        max_order += 1
        grid = np.arange(max_order)
        nx, ny, nz = np.meshgrid(grid, grid, grid, indexing="ij")
        orders = np.stack(
            [nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)], axis=1
        ).astype(np.float64)
        freqs = (
            c
            / 2
            * np.sqrt(np.sum((orders / self.dimensions_m) ** 2, axis=1))
        )
        modes = np.concatenate([freqs[:, None], orders], axis=1)[1:]
        self.modes_hz = modes[modes[:, 0].argsort()]
        return self.modes_hz

    def get_analytical_transfer_function(
        self,
        source_pos,
        receiver_pos,
        freqs,
        max_mode_order: int = 10,
        generate_plot: bool = True,
        c: float = 343,
    ):
        """Modal-sum transfer function as one batched expression over
        (modes × frequencies) (`_room_acoustics.py:558-685`): ``(p (F,)
        complex numpy, modes, None)``. ``generate_plot=True`` raises until
        the plots are ported."""
        if generate_plot:
            raise NotImplementedError("plots are not ported yet; pass generate_plot=False")
        source_pos = np.asarray(source_pos).squeeze()
        receiver_pos = np.asarray(receiver_pos).squeeze()
        assert self.check_if_in_room(source_pos), (
            "Given source position is not in the room"
        )
        assert self.check_if_in_room(receiver_pos), (
            "Given receiver position is not in the room"
        )
        if hasattr(self, "detailed_absorption"):
            mode_damping = (
                np.log(1e3)
                / self.detailed_absorption["t60_s_per_frequency"]
            )
            alpha_freq_dep = True
            octave_bands = self.detailed_absorption["center_frequencies"]
        else:
            alpha_freq_dep = False
            mode_damping = np.log(1e3) / self.t60_s

        f = np.asarray(freqs).squeeze()
        omega = 2 * np.pi * f
        omega_2 = omega**2
        cn_vals = np.array([4, 2, 1])
        mo = max_mode_order + 1
        grid = np.arange(mo)
        nx, ny, nz = np.meshgrid(grid, grid, grid, indexing="ij")
        orders = np.stack(
            [nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)], axis=1
        ).astype(np.float64)[1:]
        ks = orders / self.dimensions_m * np.pi  # (M, 3)
        omega_n = c * np.sqrt(np.sum(ks**2, axis=1))  # (M,)
        mode_freq = omega_n / 2 / np.pi
        if alpha_freq_dep:
            band_idx = np.argmin(
                np.abs(mode_freq[:, None] - octave_bands[None, :]), axis=1
            )
            eta = mode_damping[band_idx]
        else:
            eta = np.full(len(mode_freq), mode_damping)
        tom = np.sum(orders.astype(bool), axis=1) - 1
        cn = cn_vals[tom]
        numer = np.prod(
            np.cos(ks * source_pos) * np.cos(ks * receiver_pos), axis=1
        )
        # the modal sum in the package's float (complex64 by default, as
        # the JAX package's), on the default device
        dev, fdt, cdt = default_device(), default_float(), default_complex()
        num_j = torch.as_tensor(numer / cn, dtype=fdt, device=dev)
        denom = (
            torch.as_tensor(omega_n[:, None] ** 2, dtype=fdt, device=dev)
            + 2j * torch.as_tensor(eta[:, None] * omega_n[:, None], dtype=fdt, device=dev)
            - torch.as_tensor(omega_2[None, :], dtype=fdt, device=dev)
        ).to(cdt)
        p = torch.sum(num_j[:, None] / denom, dim=0)
        p = p * (8 * c**2 / np.prod(self.dimensions_m))
        p = p.cpu().numpy()

        modes = np.concatenate([mode_freq[:, None], orders], axis=1)
        modes = modes[modes[:, 0].argsort()]
        return p, modes, None

    def add_detailed_absorption(self, detailed_absorption: dict):
        """Per-wall octave-band absorption data
        (`_room_acoustics.py:687-839`)."""
        assert len(detailed_absorption) == 6, (
            "The detailed absorption dictionary must have 6 entries (for "
            "each wall)"
        )
        walls = set(["north", "south", "east", "west", "floor", "ceiling"])
        assert walls == set(detailed_absorption.keys()), (
            f"Keys of dictionary: {set(detailed_absorption.keys())}\ndo not"
            f" match with the necessary keys: {walls}"
        )
        number_of_bands = 1
        for i in detailed_absorption:
            ab = np.atleast_1d(detailed_absorption[i])
            if len(ab) == 1:
                detailed_absorption[i] = ab * np.ones(8)
                number_of_bands = max(number_of_bands, 8)
            elif len(ab) <= 8:
                detailed_absorption[i] = ab
                number_of_bands = max(number_of_bands, len(ab))
            else:
                raise ValueError(
                    "The absorption coefficient must be passed with either "
                    "1 or less than 8 coefficients"
                )
            assert np.all(ab < 1) and np.all(ab > 0), (
                "Absorption must be between 0 and 1 (exclusively)"
            )
        for i in detailed_absorption:
            if len(detailed_absorption[i]) >= number_of_bands:
                detailed_absorption[i] = detailed_absorption[i][
                    :number_of_bands
                ]
            else:
                detailed_absorption[i] = np.pad(
                    detailed_absorption[i],
                    (0, number_of_bands - len(detailed_absorption[i])),
                    "edge",
                )
        walls_dict = {
            "north": 0,
            "south": 1,
            "east": 2,
            "west": 3,
            "floor": 4,
            "ceiling": 5,
        }
        absorption_matrix = np.zeros((6, number_of_bands))
        for wall in walls_dict:
            absorption_matrix[walls_dict[wall], :] = detailed_absorption[
                wall
            ]
        absorption_area = np.zeros(number_of_bands)
        xy = self.dimensions_m[0] * self.dimensions_m[1]
        absorption_area += xy * (
            absorption_matrix[walls_dict["ceiling"], :]
            + absorption_matrix[walls_dict["floor"], :]
        )
        xz = self.dimensions_m[0] * self.dimensions_m[2]
        absorption_area += xz * (
            absorption_matrix[walls_dict["south"], :]
            + absorption_matrix[walls_dict["north"], :]
        )
        yz = self.dimensions_m[1] * self.dimensions_m[2]
        absorption_area += yz * (
            absorption_matrix[walls_dict["east"], :]
            + absorption_matrix[walls_dict["west"], :]
        )
        self.detailed_absorption = detailed_absorption
        self.detailed_absorption["absorption_matrix"] = absorption_matrix
        self.detailed_absorption["absorption_area"] = absorption_area
        acpf = absorption_area / self.area
        self.detailed_absorption[
            "mean_absorption_coefficients_per_frequency"
        ] = acpf
        self.detailed_absorption["center_frequencies"] = 125 * 2 ** np.arange(
            number_of_bands
        )
        self.detailed_absorption["t60_s_per_frequency"] = (
            0.161 * self.volume / absorption_area
        )
        self.detailed_absorption["index_wall_dictionary"] = walls_dict
        weights = 2.0 ** np.arange(number_of_bands)
        weights /= np.sum(weights)
        self.absorption_coefficient = float(np.sum(acpf * weights))
        self.t60_s = (
            0.161 * self.volume / (self.absorption_coefficient * self.area)
        )
        return self

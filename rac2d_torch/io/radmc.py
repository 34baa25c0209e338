"""RADMC-style structured (r, theta) density/temperature input, in numpy
on the host: a copy of the JAX package's ``io/radmc.py`` on the port's
``constants``.

Rebuild of reference src/grid.f90:1821-1950 (``load_data_from_RADMC`` +
``get_RADMC_n``): a text table of rows (r_cm, theta_rad, n, T) on a
structured nx x ny polar grid; densities are queried at (r, z) via
theta = pi/2 - atan2(z, r) with interpolation (the reference offers
barycentric-rational or spline; bilinear on the structured grid agrees to
table accuracy and is what runs here).

Use with models.grid.make_grid:
    radmc = RadmcData.load(path)
    grid = make_grid(cfg, andrews, dens_fn=radmc.density)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants as c


@dataclasses.dataclass
class RadmcData:
    r_cm: np.ndarray       # [nx]
    theta: np.ndarray      # [ny] rad, ascending
    n: np.ndarray          # [nx, ny] cm^-3
    T: np.ndarray          # [nx, ny] K

    @classmethod
    def load(cls, path):
        rows = []
        with open(path) as f:
            for line in f:
                if line.lstrip().startswith("!") or not line.strip():
                    continue
                t = line.split()
                rows.append([float(v) for v in t[:4]])
        arr = np.array(rows)
        r = np.unique(arr[:, 0])
        th = np.unique(arr[:, 1])
        nx, ny = len(r), len(th)
        if nx * ny != len(arr):
            raise ValueError("RADMC table is not a structured grid")
        order = np.lexsort((arr[:, 1], arr[:, 0]))
        arr = arr[order]
        n = arr[:, 2].reshape(nx, ny)
        T = arr[:, 3].reshape(nx, ny)
        return cls(r_cm=r, theta=th, n=n, T=T)

    def _interp(self, table, r_AU, z_AU):
        r_AU = np.asarray(r_AU, dtype=float)
        z_AU = np.asarray(z_AU, dtype=float)
        r_cm = np.sqrt(r_AU ** 2 + z_AU ** 2) * c.AU2cm
        th = np.clip(c.pi_2 - np.arctan2(z_AU, r_AU),
                     self.theta[0], self.theta[-1])
        i = np.clip(np.searchsorted(self.r_cm, r_cm) - 1, 0,
                    len(self.r_cm) - 2)
        j = np.clip(np.searchsorted(self.theta, th) - 1, 0,
                    len(self.theta) - 2)
        tx = np.clip((r_cm - self.r_cm[i])
                     / (self.r_cm[i + 1] - self.r_cm[i]), 0, 1)
        ty = np.clip((th - self.theta[j])
                     / (self.theta[j + 1] - self.theta[j]), 0, 1)
        return ((1 - tx) * (1 - ty) * table[i, j]
                + tx * (1 - ty) * table[i + 1, j]
                + (1 - tx) * ty * table[i, j + 1]
                + tx * ty * table[i + 1, j + 1])

    def density(self, r_AU, z_AU):
        """Number density at (r, z) in AU; zero outside the radial range."""
        out = self._interp(self.n, r_AU, z_AU)
        r_cm = np.sqrt(np.asarray(r_AU) ** 2 + np.asarray(z_AU) ** 2) \
            * c.AU2cm
        return np.where((r_cm >= self.r_cm[0]) & (r_cm <= self.r_cm[-1]),
                        out, 0.0)

    def temperature(self, r_AU, z_AU):
        return self._interp(self.T, r_AU, z_AU)

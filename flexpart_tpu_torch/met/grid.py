"""Meteorological grid description (numpy copy of
``flexpart_tpu/met/grid.py``, which cannot be imported without jax
because its package ``__init__`` pulls in the jax preprocessing).

Conventions: level index 0 is the ground; particle x/y are in mother-grid
units x = (lon-xlon0)/dx; global grids carry an extra cyclic column.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..constants import PI, R_EARTH


@dataclasses.dataclass(frozen=True)
class MetGrid:
    nx: int
    ny: int
    nlev: int
    xlon0: float
    ylat0: float
    dx: float
    dy: float
    akm: np.ndarray         # (nlev,) interface coeffs, bottom-up
    bkm: np.ndarray
    xglobal: bool = False
    pressure_levels: bool = False

    def __post_init__(self):
        object.__setattr__(self, "akm", np.asarray(self.akm, np.float64))
        object.__setattr__(self, "bkm", np.asarray(self.bkm, np.float64))

    @functools.cached_property
    def akz(self) -> np.ndarray:
        if self.pressure_levels:
            return self.akm.copy()
        akz = np.empty(self.nlev)
        akz[0] = 0.0
        akz[1:] = 0.5 * (self.akm[1:] + self.akm[:-1])
        return akz

    @functools.cached_property
    def bkz(self) -> np.ndarray:
        if self.pressure_levels:
            return self.bkm.copy()
        bkz = np.empty(self.nlev)
        bkz[0] = 1.0
        bkz[1:] = 0.5 * (self.bkm[1:] + self.bkm[:-1])
        return bkz

    @property
    def nxfield(self) -> int:
        return self.nx - 1 if self.xglobal else self.nx

    @property
    def nglobal(self) -> bool:
        """The grid reaches the north pole (its top row is the pole)."""
        return self.xglobal and (self.ylat0 + (self.ny - 1) * self.dy > 89.0)

    @property
    def sglobal(self) -> bool:
        """The grid reaches the south pole."""
        return self.xglobal and (self.ylat0 < -89.0)

    @property
    def dxconst(self) -> float:
        """m -> grid-units conversion in x at the equator [gu/m]."""
        return 180.0 / (self.dx * R_EARTH * PI)

    @property
    def dyconst(self) -> float:
        return 180.0 / (self.dy * R_EARTH * PI)

    @functools.cached_property
    def lons(self) -> np.ndarray:
        return self.xlon0 + np.arange(self.nx) * self.dx

    @functools.cached_property
    def lats(self) -> np.ndarray:
        return self.ylat0 + np.arange(self.ny) * self.dy

    def lonlat_to_grid(self, lon, lat):
        """Geographic coords -> mother-grid units (coordtrafo.f90)."""
        x = (np.asarray(lon) - self.xlon0) / self.dx
        if self.xglobal:
            x = np.mod(x, self.nx - 1)
        return x, (np.asarray(lat) - self.ylat0) / self.dy


def hybrid_coefficients(nlev: int, ptop: float = 10.0,
                        p0: float = 101325.0) -> tuple[np.ndarray, np.ndarray]:
    """Plausible ECMWF-style hybrid sigma-pressure coordinate for synthetic
    met: interface pressure p_k = akm + bkm * ps, bottom-up."""
    s = np.linspace(1.0, 0.0, nlev) ** 1.7
    bkm = np.clip(s, 0.0, 1.0) ** 1.3
    akm = (p0 - ptop) * (s - bkm) + ptop * (1.0 - bkm)
    akm[0] = 0.0
    bkm[0] = 1.0
    return akm, bkm

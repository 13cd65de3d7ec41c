"""Output grid geometry (numpy copy of ``flexpart_tpu/grid/outgrid.py``,
which imports jax: cell areas and volumes, the air density and the mean
orography on the output grid, all host numpy) and the concentration
accumulators as tensors.

``gridunc`` is stored (nage, nclass, kp, nzg, nyg, nxg, nspec) with the
species innermost, as in JAX, so a particle's scatter-add is one flat
row index.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import OutGrid
from ..constants import PI, R_EARTH
from ..met.grid import MetGrid


@dataclasses.dataclass(frozen=True)
class OutputGridGeometry:
    """Static geometry derived from the OUTGRID config + mother met grid."""
    og: OutGrid
    met: MetGrid

    @property
    def nxg(self) -> int:
        return self.og.numxgrid

    @property
    def nyg(self) -> int:
        return self.og.numygrid

    @property
    def nzg(self) -> int:
        return self.og.numzgrid

    @property
    def outheight(self) -> np.ndarray:
        return np.asarray(self.og.outheights, np.float64)

    @property
    def xoutshift(self) -> float:
        return self.met.xlon0 - self.og.outlon0

    @property
    def youtshift(self) -> float:
        return self.met.ylat0 - self.og.outlat0

    @functools.cached_property
    def area(self) -> np.ndarray:
        """Cell surface area [m2], (nyg, nxg) (outgrid_init.f90:210-243)."""
        jy = np.arange(self.nyg)
        ylat = self.og.outlat0 + (jy + 0.5) * self.og.dyout
        ylatp = ylat + 0.5 * self.og.dyout
        ylatm = ylat - 0.5 * self.og.dyout
        # zone height between the two latitude circles
        opposite = (ylatm < 0) & (ylatp > 0)
        hzone = np.where(
            opposite,
            np.sin(np.deg2rad(ylatp)) - np.sin(np.deg2rad(ylatm)),
            np.abs(np.sqrt(1 - np.cos(np.deg2rad(ylatp)) ** 2)
                   - np.sqrt(1 - np.cos(np.deg2rad(ylatm)) ** 2))) * R_EARTH
        gridarea = 2.0 * PI * R_EARTH * hzone * self.og.dxout / 360.0
        return np.broadcast_to(gridarea[:, None], (self.nyg, self.nxg)).copy()

    @functools.cached_property
    def volume(self) -> np.ndarray:
        """Cell volume [m3], (nzg, nyg, nxg)."""
        oh = self.outheight
        dz = np.diff(np.concatenate([[0.0], oh]))
        return dz[:, None, None] * self.area[None]


def density_outgrid(geo: OutputGridGeometry, height, rho) -> np.ndarray:
    """(nzg, nyg, nxg) air density at the output-layer half-heights from
    the nearest met column — the pptv/mixing-ratio denominator
    (concoutput.f90:156-196: halfheight per layer, bracketing model
    levels kzz, nint'ed met column, newest time level).

    height: (nz,) model level heights; rho: (nz, ny, nx) met density."""
    og = geo.og
    oh = np.asarray(og.outheights, np.float64)
    half = np.empty_like(oh)
    half[0] = oh[0] / 2.0
    if oh.size > 1:
        half[1:] = (oh[1:] + oh[:-1]) / 2.0
    height = np.asarray(height, np.float64)
    nz = height.shape[0]
    # height[kzz-1] < half < height[kzz], kzz clamped to [1, nz-1]
    # (concoutput.f90:168-172 `46 kzz=max(min(kzz,nz),2)` 1-based)
    kzz = np.clip(np.searchsorted(height, half), 1, nz - 1)
    dz1 = half - height[kzz - 1]
    dz2 = height[kzz] - half
    dz = np.maximum(dz1 + dz2, 1e-30)
    # nearest met column per output cell (cell CORNER, concoutput.f90:178)
    met = geo.met
    xl = (og.outlon0 + np.arange(geo.nxg) * og.dxout - met.xlon0) / met.dx
    yl = (og.outlat0 + np.arange(geo.nyg) * og.dyout - met.ylat0) / met.dy
    iix = np.clip(np.rint(xl).astype(int), 0, met.nx - 1)
    jjy = np.clip(np.rint(yl).astype(int), 0, met.ny - 1)
    rho = np.asarray(rho)
    cols = rho[:, jjy[:, None], iix[None, :]]            # (nz, nyg, nxg)
    return ((cols[kzz] * dz1[:, None, None]
             + cols[kzz - 1] * dz2[:, None, None])
            / dz[:, None, None]).astype(np.float32)


def oro_outgrid(geo: OutputGridGeometry, oro) -> np.ndarray:
    """(nyg, nxg) mean model topography per output cell: 10x10 bilinear
    samples of the met orography, averaged (outgrid_init.f90:107-181;
    the /100 there folds the 100-sample division)."""
    og = geo.og
    met = geo.met
    oro = np.asarray(oro, np.float64)
    s = (np.arange(1, 11) / 10.0) - 0.05                 # (10,)
    xlon = (og.outlon0
            + (np.arange(geo.nxg)[:, None] + s[None, :]) * og.dxout)
    ylat = (og.outlat0
            + (np.arange(geo.nyg)[:, None] + s[None, :]) * og.dyout)
    xl = ((xlon - met.xlon0) / met.dx).reshape(-1)        # (nxg*10,)
    yl = ((ylat - met.ylat0) / met.dy).reshape(-1)        # (nyg*10,)
    ix = np.clip(xl.astype(int), 0, met.nx - 2)
    jy = np.clip(yl.astype(int), 0, met.ny - 2)
    ddx = np.clip(xl - ix, 0.0, 1.0)
    ddy = np.clip(yl - jy, 0.0, 1.0)
    v00 = oro[jy[:, None], ix[None, :]]                  # (NY, NX) samples
    v10 = oro[jy[:, None], ix[None, :] + 1]
    v01 = oro[jy[:, None] + 1, ix[None, :]]
    v11 = oro[jy[:, None] + 1, ix[None, :] + 1]
    samp = ((1 - ddx[None, :]) * (1 - ddy[:, None]) * v00
            + ddx[None, :] * (1 - ddy[:, None]) * v10
            + (1 - ddx[None, :]) * ddy[:, None] * v01
            + ddx[None, :] * ddy[:, None] * v11)
    # average the 10x10 sub-samples of each cell
    samp = samp.reshape(geo.nyg, 10, geo.nxg, 10)
    return samp.mean(axis=(1, 3)).astype(np.float32)


@dataclasses.dataclass
class Accumulators:
    gridunc: torch.Tensor     # (nage, nclass, kp, nzg, nyg, nxg, ks) f32
    wetgridunc: torch.Tensor  # (nage, nclass, kp, nyg, nxg, ks) f32
    drygridunc: torch.Tensor  # (nage, nclass, kp, nyg, nxg, ks) f32
    outnum: torch.Tensor      # () f32 number of samples accumulated

    def replace(self, **kw) -> "Accumulators":
        return dataclasses.replace(self, **kw)


def zero_accumulators(geo: OutputGridGeometry, nspec: int, npointspec: int,
                      nclassunc: int = 1, nage: int = 1, *,
                      device: torch.device | str) -> Accumulators:
    shape3 = (nage, nclassunc, npointspec, geo.nzg, geo.nyg, geo.nxg, nspec)
    shape2 = (nage, nclassunc, npointspec, geo.nyg, geo.nxg, nspec)

    def z(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return Accumulators(gridunc=z(shape3), wetgridunc=z(shape2),
                        drygridunc=z(shape2), outnum=z(()))

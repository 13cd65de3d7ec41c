"""Output grid geometry (numpy copy of ``flexpart_tpu/grid/outgrid.py``,
which imports jax) and the concentration accumulators as tensors.

``gridunc`` is stored (nage, nclass, kp, nzg, nyg, nxg, nspec) with the
species innermost, as in JAX, so a particle's scatter-add is one flat
row index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OutGrid
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

"""Run configuration the stock step needs: the OUTGRID description.

The dataclass of ``flexpart_tpu/config/outgrid.py`` (readoutgrid.f90),
copied without its namelist parser so that the port runs without the
JAX package; the JAX ``OutGrid`` has the same fields and is accepted
wherever this one is.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OutGrid:
    outlon0: float
    outlat0: float
    numxgrid: int
    numygrid: int
    dxout: float
    dyout: float
    outheights: tuple[float, ...]

    @property
    def numzgrid(self) -> int:
        return len(self.outheights)

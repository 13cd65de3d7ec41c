"""File-based met backend: one .npz archive per wind-field time (copy of
``flexpart_tpu/met/npzmet.py``, onto the port's ``EtaFields``).

The reference ingests GRIB directly through eccodes
(readwind_ecmwf.f90); this runtime's met contract is the EtaFields
array set, and this backend serves it from .npz archives produced by an
offline converter (any tool writing the same keys, or ``save_eta_npz``
of either package).  Times come from the AVAILABLE index exactly like
getfields.f90 resolves them.

Archive keys: every EtaFields field name (met/fields.py) with shapes
(nlev, ny, nx) / (ny, nx), float32, plus grid metadata: akm, bkm (nlev,),
xlon0, ylat0, dx, dy.  The keys and dtypes are the JAX package's, so
each package reads the other's archives.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..config.paths import WindFieldEntry
from .fields import ETA_FIELDS, EtaFields, eta_from_numpy
from .grid import MetGrid


def save_eta_npz(path, eta: EtaFields, grid: MetGrid):
    """Write one wind-field time in the backend's archive format."""
    d = {f.name: getattr(eta, f.name).cpu().numpy()
         for f in dataclasses.fields(eta)}
    d.update(akm=grid.akm, bkm=grid.bkm, xlon0=grid.xlon0,
             ylat0=grid.ylat0, dx=grid.dx, dy=grid.dy)
    np.savez_compressed(path, **d)


def grid_from_npz(path) -> MetGrid:
    """Infer the MetGrid from one archive (gridcheck_ecmwf.f90 analog:
    geometry+vertical coefficients from the first wind field)."""
    with np.load(path) as d:
        nlev, ny, nx = d["tth"].shape
        dx = float(d["dx"])
        xglobal = abs((nx - 1) * dx - 360.0) < 1e-6 or abs(nx * dx - 360.0) < 1e-6
        return MetGrid(nx=nx, ny=ny, nlev=nlev,
                       xlon0=float(d["xlon0"]), ylat0=float(d["ylat0"]),
                       dx=dx, dy=float(d["dy"]),
                       akm=d["akm"], bkm=d["bkm"], xglobal=xglobal)


@dataclasses.dataclass
class NpzMet:
    """Met backend over an AVAILABLE index of .npz wind fields."""
    metdata: Path
    entries: tuple[WindFieldEntry, ...]
    bdate: datetime

    def __post_init__(self):
        self.metdata = Path(self.metdata)
        self._by_sec = {
            int((e.time - self.bdate).total_seconds()): e.filename
            for e in self.entries}

    @property
    def wind_interval(self) -> int:
        secs = sorted(self._by_sec)
        if len(secs) < 2:
            return 3600
        return secs[1] - secs[0]

    def grid(self) -> MetGrid:
        first = self.entries[0].filename
        return grid_from_npz(self.metdata / first)

    def fetch(self, tsec: float, device: torch.device | str) -> EtaFields:
        t = int(tsec)
        if t not in self._by_sec:
            raise FileNotFoundError(
                f"no wind field for t={t}s in AVAILABLE "
                f"(have {sorted(self._by_sec)[:5]}...)")
        with np.load(self.metdata / self._by_sec[t]) as d:
            fields = {k: d[k] for k in ETA_FIELDS}
        return eta_from_numpy(fields, device)

"""NCEP GFS met backend: native GRIB2 decoder -> EtaFields (copy of
``flexpart_tpu/met/gfsmet.py``, onto the port's ``EtaFields``).

The GFS ingestion path of the reference (gridcheck_gfs.f90 +
readwind_gfs.f90 + verttransform_gfs.f90) differs from ECMWF in kind:

* fields live on ISOBARIC levels, not hybrid eta — the grid carries
  ``pressure_levels=True`` with akm = the pressure values bottom-up and
  bkm = 0 (gridcheck_gfs.f90:441-471); there is no artificial ground
  level, and levels can lie below the terrain (handled per column in
  met.verttransform via the collapsed-height mask);
* humidity comes as RELATIVE humidity -> converted to specific humidity
  per level (readwind_gfs.f90:627-639), and the 2 m dew point is derived
  from 2 m RH with Bolton's (1980) formula (readwind_gfs.f90:645-656);
* no surface stress / sensible heat flux in the files -> both derived
  with the profile method from 10 m and lowest-sigma-level (~30 m)
  winds/temperatures (readwind_gfs.f90:712-731, met.pblprofile);
* NCEP global grids run 0..360 deg east -> rolled to start at -179 deg
  (gridcheck_gfs.f90:228-231 and the i179/i181 shuffle in readwind);
* GRIB2-only total precipitation is split into large-scale = max(TP-CP,0)
  (readwind_gfs.f90:603-624), rates converted mm/s -> mm/h;
* cloud water CLWMR is the combined (sum) content -> use_clwc path with
  sumclouds semantics (readwind_gfs.f90:553-570).

The conversions are the reference's float64 numpy, so the fields are
bitwise the JAX package's; they land on the caller's device at the end.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..config.paths import WindFieldEntry
from ..io import gribio
from .fields import EtaFields, eta_from_numpy
from .gribmet import ReadTimes, _Clock
from .grid import MetGrid
from .pblprofile import pbl_profile, _ew

# GRIB2 (discipline, category, number, level_type) -> role
# (readwind_gfs.f90:166-257)
_G2_GFS = {
    (0, 0, 0, 100): "T", (0, 2, 2, 100): "U", (0, 2, 3, 100): "V",
    (0, 2, 8, 100): "W", (0, 1, 1, 100): "RH", (0, 1, 22, 100): "CLWMR",
    (0, 1, 1, 103): "RH2", (0, 0, 0, 103): "T2",
    (0, 2, 2, 103): "U10", (0, 2, 3, 103): "V10",
    (0, 3, 0, 1): "SP", (0, 1, 13, 1): "SNOW",
    (0, 0, 0, 104): "TSIG", (0, 2, 2, 104): "USIG", (0, 2, 3, 104): "VSIG",
    (0, 3, 5, 1): "TOPO", (2, 0, 0, 1): "LSM",
    (0, 1, 7, 1): "PRATE", (0, 1, 196, 1): "CPRAT",
    (0, 6, 1, 1): "TCC",
}

HLEV1 = 30.0        # height of the lowest sigma level [m] (readwind_gfs:721)
XMWML = 0.622       # Mw/Mdry-air


def _role(m: gribio.GribMessage) -> str | None:
    if m.edition != 2:
        return None
    disc = m.param // 1000000
    cat = (m.param // 1000) % 1000
    num = m.param % 1000
    return _G2_GFS.get((disc, cat, num, m.level_type))


def looks_like_gfs(path) -> bool:
    """detectformat.f90 analog: isobaric T levels and no hybrid PV
    metadata mark an NCEP file."""
    msgs = gribio.scan(path)
    has_pv = any(len(m.pv) >= 4 for m in msgs)
    has_isobaric_t = any(_role(m) == "T" for m in msgs)
    return has_isobaric_t and not has_pv


def grid_from_gfs_grib(path) -> MetGrid:
    """Grid geometry + the isobaric level stack (gridcheck_gfs.f90)."""
    msgs = gribio.scan(path)
    levels = sorted({m.level for m in msgs if _role(m) == "U"},
                    reverse=True)                 # bottom-up: high p first
    if not levels:
        raise ValueError(f"no isobaric U fields in {path}")
    ml = next(m for m in msgs if _role(m) == "U")
    dlon = ml.dlon
    lon1 = ml.lon1
    # NCEP global files span 0..360-dx: transform to -179..181-dx
    # (gridcheck_gfs.f90:228-231)
    nxfield = ml.nx
    xglobal = abs(nxfield * dlon - 360.0) < 1e-3
    if xglobal and abs(lon1) < 1e-6:
        xlon0 = -179.0
    else:
        xlon0 = lon1 if lon1 <= 180.0 else lon1 - 360.0
    ylat0 = min(ml.lat1, ml.lat2)
    nx = nxfield + (1 if xglobal else 0)
    akm = np.asarray(levels, np.float64)
    return MetGrid(nx=nx, ny=ml.ny, nlev=len(levels), xlon0=xlon0,
                   ylat0=ylat0, dx=dlon, dy=abs(ml.dlat),
                   akm=akm, bkm=np.zeros_like(akm), xglobal=xglobal,
                   pressure_levels=True)


def eta_from_gfs_grib(path, grid: MetGrid, *, device: torch.device | str,
                      times: ReadTimes | None = None) -> EtaFields:
    """Assemble one GFS wind-field time (readwind_gfs.f90), onto
    ``device``; ``times`` (if given) takes the seconds of the read's
    parts (``gribmet.ReadTimes``)."""
    clock = _Clock()
    msgs = gribio.scan(path)
    clock.lap("scan")
    ny, nx = grid.ny, grid.nx
    nlev = grid.nlev
    lev_idx = {int(p): k for k, p in enumerate(grid.akm)}
    i179 = int(round(179.0 / grid.dx)) if (grid.xglobal
                                           and grid.xlon0 == -179.0) else 0

    def orient(vals):
        """South-up rows, NCEP lon roll, cyclic duplicate column."""
        if vals.shape[1] == grid.nxfield:
            if i179:
                vals = np.roll(vals, i179, axis=1)
            if grid.xglobal:
                vals = np.concatenate([vals, vals[:, :1]], axis=1)
        if vals.shape != (ny, nx):
            raise ValueError(f"field shape {vals.shape} vs ({ny},{nx})")
        return vals.astype(np.float32)

    f3 = {k: np.zeros((nlev, ny, nx), np.float32)
          for k in ("T", "U", "V", "W", "RH", "CLWMR")}
    f2 = {}
    for m in msgs:
        role = _role(m)
        if role is None:
            continue
        clock.lap("assembly")
        vals = m.values()
        clock.lap("decode")
        if m.lat2 < m.lat1 or m.dlat < 0:
            vals = vals[::-1]
        if role in f3:
            kz = lev_idx.get(int(m.level))
            if kz is not None:
                f3[role][kz] = orient(vals)
        else:
            f2[role] = orient(vals)

    ps = f2.get("SP", np.full((ny, nx), 101325.0, np.float32))
    tt2 = f2.get("T2", f3["T"][0])
    rh2 = f2.get("RH2", np.full((ny, nx), 50.0, np.float32))
    u10 = f2.get("U10", f3["U"][0])
    v10 = f2.get("V10", f3["V"][0])

    # RH -> specific humidity per level (readwind_gfs.f90:627-639)
    plev = np.asarray(grid.akm, np.float64)[:, None, None]
    e = _ew(f3["T"].astype(np.float64)) * f3["RH"] / 100.0
    qvh = (XMWML * e / (plev - (1.0 - XMWML) * e)).astype(np.float32)

    # 2m dew point via Bolton 1980 (readwind_gfs.f90:645-656)
    e2 = _ew(tt2.astype(np.float64)) / 100.0 * rh2 / 100.0   # hPa
    with np.errstate(divide="ignore", invalid="ignore"):
        td2 = 243.5 / (17.67 / np.log(np.maximum(e2, 1e-10) / 6.112)
                       - 1.0) + 273.0
    td2 = np.where(rh2 <= 0.0, tt2, td2).astype(np.float32)

    # precip: TP -> LSP split, mm/s -> mm/h (readwind_gfs.f90:603-624,703-707)
    tp = f2.get("PRATE", np.zeros((ny, nx), np.float32))
    cp = f2.get("CPRAT", np.zeros((ny, nx), np.float32))
    convprec = cp * 3600.0
    lsprec = np.where(cp < tp, (tp - cp), 0.0) * 3600.0

    # stress + heat flux via the profile method (readwind_gfs.f90:712-731)
    tsig = f2.get("TSIG", f3["T"][0])
    usig = f2.get("USIG", f3["U"][0])
    vsig = f2.get("VSIG", f3["V"][0])
    ff10m = np.hypot(u10, v10)
    fflev1 = np.hypot(usig, vsig)
    surfstr, sshf = pbl_profile(ps, td2, HLEV1, tt2, tsig, ff10m, fflev1)

    zero = np.zeros((ny, nx), np.float32)
    d = dict(
        ps=ps, tt2=tt2, td2=td2, sshf=sshf, surfstr=surfstr, ssr=zero,
        lsprec=lsprec.astype(np.float32), convprec=convprec,
        tcc=np.clip(f2.get("TCC", zero), 0.0, 100.0) / 100.0,
        sd=f2.get("SNOW", zero),
        oro=f2.get("TOPO", zero),            # HGT already in m
        excessoro=zero,                      # isobaric: subgrid terrain n/a
        lsm=f2.get("LSM", zero),
        tth=f3["T"], qvh=qvh, uuh=f3["U"], vvh=f3["V"], wwh=f3["W"],
        clwch=f3["CLWMR"],
    )
    clock.lap("assembly")
    eta = eta_from_numpy(d, device)
    clock.lap("copy")
    if times is not None:
        times.add(clock.parts)
    return eta


@dataclasses.dataclass
class GfsMet:
    """Met backend over an AVAILABLE index of GFS GRIB2 files;
    ``read_times`` as ``GribMet``'s."""
    metdata: Path
    entries: tuple[WindFieldEntry, ...]
    bdate: datetime
    sumclouds: bool = True        # CLWMR is total cloud water

    def __post_init__(self):
        self.metdata = Path(self.metdata)
        self._by_sec = {
            int((e.time - self.bdate).total_seconds()): e.filename
            for e in self.entries}
        self._grid = None
        self.read_times = ReadTimes()

    @property
    def wind_interval(self) -> int:
        secs = sorted(self._by_sec)
        return secs[1] - secs[0] if len(secs) > 1 else 3600

    def grid(self) -> MetGrid:
        if self._grid is None:
            first = self.entries[0].filename
            self._grid = grid_from_gfs_grib(self.metdata / first)
        return self._grid

    def fetch(self, tsec: float, device: torch.device | str) -> EtaFields:
        t = int(tsec)
        if t not in self._by_sec:
            raise FileNotFoundError(f"no GFS wind field for t={t}s")
        return eta_from_gfs_grib(self.metdata / self._by_sec[t],
                                 self.grid(), device=device,
                                 times=self.read_times)

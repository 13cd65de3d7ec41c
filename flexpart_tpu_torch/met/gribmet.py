"""GRIB met backend: native decoder -> EtaFields (copy of
``flexpart_tpu/met/gribmet.py``, onto the port's ``EtaFields``).

The ECMWF-parameter assembly layer of readwind_ecmwf.f90 on top of the
native GRIB decoder (``io/gribio``): classifies messages with the same
GRIB1-id table the reference builds from GRIB2 metadata
(readwind_ecmwf.f90:160-234), reverses the top-down model levels into
the bottom-up eta stack with the artificial ground level (10m wind / 2m
T / surface pressure) at index 0 (readwind_ecmwf.f90:489-494), derives
the hybrid coefficients from the PV metadata, converts accumulated
fluxes to rates, and returns the same EtaFields contract every other
met backend provides.  Scan, decode and assembly are host numpy; the
fields land on the caller's device at the end.

GFS pressure-level files are handled by ``met.gfsmet``.  nxshift rotates
global grids by N columns (shift_field.f90 + gridcheck_ecmwf.f90:259) to
move the Greenwich seam; accumulated flux/precip fields are converted to
rates here (the reference expects flex_extract-preprocessed inputs).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..config.paths import WindFieldEntry
from ..io import gribio
from .fields import EtaFields, eta_from_numpy
from .grid import MetGrid

# GRIB2 (category, number, level_type) -> GRIB1 indicator
# (readwind_ecmwf.f90:174-234); GRIB1 files carry the indicator directly
_G2_TABLE = {
    (0, 0, 105): 130, (2, 2, 105): 131, (2, 3, 105): 132,
    (1, 0, 105): 133, (1, 83, 105): 246, (1, 84, 105): 247,
    (3, 0, 1): 134, (2, 32, None): 135, (128, 77, None): 135,
    (3, 0, 101): 151, (2, 2, 103): 165, (2, 3, 103): 166,
    (0, 0, 103): 167, (0, 6, 103): 168, (1, 11, 1): 141,
    (1, 254, 1): 141, (6, 1, None): 164, (1, 9, None): 142,
    (1, 10, None): 143, (0, 11, 1): 146, (4, 9, 1): 176,
    (2, 38, None): 180, (2, 37, None): 181, (3, 4, None): 129,
    (3, 7, None): 160,
}

READ_PARTS = ("scan", "decode", "assembly", "copy")


class ReadTimes:
    """Host seconds of a GRIB reader's parts, summed over its files:
    ``scan`` (the messages' metadata), ``decode`` (inside
    ``gribdec_decode``), ``assembly`` (the numpy work around it) and
    ``copy`` (the fields to the device).  Thread-safe: the met reader
    thread and the step loop's thread may both read files."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds = dict.fromkeys(READ_PARTS, 0.0)
        self.files = 0

    def add(self, parts: dict) -> None:
        with self._lock:
            for k, v in parts.items():
                self.seconds[k] += v
            self.files += 1


class _Clock:
    """The parts of one file's read, each part's seconds summed."""

    def __init__(self):
        self.parts = dict.fromkeys(READ_PARTS, 0.0)
        self._t = time.perf_counter()

    def lap(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] += now - self._t
        self._t = now


def _classify(m: gribio.GribMessage) -> tuple[int, float]:
    """(grib1 indicator, conversion factor) for one message."""
    if m.edition == 1:
        return m.param, 1.0
    disc = m.param // 1000000
    cat = (m.param // 1000) % 1000
    num = m.param % 1000
    if disc == 2 and cat == 0 and num == 0 and m.level_type == 1:
        return 172, 1.0                              # LSM
    for key, ind in _G2_TABLE.items():
        kcat, knum, ktyp = key
        if cat == kcat and num == knum and (ktyp is None
                                            or m.level_type == ktyp):
            factor = 0.1 if (kcat, knum) == (1, 11) else 1.0
            return ind, factor
    return -1, 1.0


def grid_from_grib(path, nxshift: int = 0) -> MetGrid:
    """Grid geometry + hybrid coefficients from the first model-level
    message (gridcheck_ecmwf.f90 analog).  ``nxshift`` rotates a global
    grid's origin eastward by N columns (gridcheck_ecmwf.f90:251-270)."""
    msgs = gribio.scan(path)
    ml = next(m for m in msgs if len(m.pv) >= 4)
    nhalf = len(ml.pv) // 2
    a = np.asarray(ml.pv[:nhalf])
    b = np.asarray(ml.pv[nhalf:])
    # ECMWF PV is top-down; our akm/bkm are bottom-up interface coeffs
    akm = a[::-1].copy()
    bkm = b[::-1].copy()
    dlat = ml.dlat if ml.lat2 > ml.lat1 else -abs(ml.dlat)
    ylat0 = min(ml.lat1, ml.lat2)
    xglobal = abs(ml.nx * ml.dlon - 360.0) < 1e-3 \
        or abs((ml.nx - 1) * ml.dlon - 360.0) < 1e-3
    nx = ml.nx + (1 if abs(ml.nx * ml.dlon - 360.0) < 1e-3 else 0)
    nlev_ec = nhalf - 1
    xlon0 = ml.lon1 if ml.lon1 <= 180 else ml.lon1 - 360.0
    if nxshift:
        if not xglobal:
            raise ValueError("nxshift requires a global grid "
                             "(gridcheck_ecmwf.f90:263-268)")
        xlon0 += nxshift * ml.dlon
        if xlon0 > 180.0:
            xlon0 -= 360.0
    return MetGrid(nx=nx, ny=ml.ny, nlev=nlev_ec + 1,
                   xlon0=xlon0,
                   ylat0=ylat0, dx=ml.dlon, dy=abs(dlat),
                   akm=akm, bkm=bkm, xglobal=xglobal)


def eta_from_grib(path, grid: MetGrid, accum_secs: float = 3600.0,
                  nxshift: int = 0, *, device: torch.device | str,
                  times: ReadTimes | None = None) -> EtaFields:
    """Assemble one wind-field time from a GRIB file
    (readwind_ecmwf.f90:240-510), onto ``device``; ``times`` (if given)
    takes the seconds of the read's parts."""
    clock = _Clock()
    msgs = gribio.scan(path)
    clock.lap("scan")
    ny, nx = grid.ny, grid.nx
    nlev = grid.nlev
    nlev_ec = nlev - 1
    f3 = {k: np.zeros((nlev, ny, nx), np.float32)
          for k in ("tth", "qvh", "uuh", "vvh", "wwh", "clwch")}
    f2 = {k: np.zeros((ny, nx), np.float32)
          for k in ("ps", "tt2", "td2", "sshf", "surfstr", "ssr",
                    "lsprec", "convprec", "tcc", "sd", "oro",
                    "excessoro", "lsm")}
    ewss = np.zeros((ny, nx), np.float32)
    nsss = np.zeros((ny, nx), np.float32)
    u10 = np.zeros((ny, nx), np.float32)
    v10 = np.zeros((ny, nx), np.float32)

    ml_map = {130: "tth", 133: "qvh", 131: "uuh", 132: "vvh",
              135: "wwh", 246: "clwch", 247: "clwch"}

    def orient(vals):
        """South-up row order, optional nxshift rotation (shift_field.f90:
        new column j = old column j+nxshift), + the cyclic duplicate
        column when the grid carries one (gridcheck_ecmwf.f90 xglobal
        nx+1)."""
        if vals.shape[1] == nx - 1:
            if nxshift:
                vals = np.roll(vals, -nxshift, axis=1)
            vals = np.concatenate([vals, vals[:, :1]], axis=1)
        elif vals.shape != (ny, nx):
            raise ValueError(f"field shape {vals.shape} vs grid "
                             f"({ny},{nx})")
        return vals.astype(np.float32)

    for m in msgs:
        ind, factor = _classify(m)
        if ind < 0 or ind in (151, 152):
            continue
        clock.lap("assembly")
        vals = m.values()
        clock.lap("decode")
        vals = vals * factor
        if m.lat2 < m.lat1 or m.dlat < 0:
            vals = vals[::-1]                        # store south-up
        if ind in ml_map:                            # model-level field
            lev = int(m.level)                       # 1 = top
            kz = nlev_ec - lev + 1                   # bottom-up, 0=ground
            if kz < 1 or kz > nlev_ec:
                continue
            if ind == 247:                           # ciwc adds to clwch
                f3["clwch"][kz] += orient(vals)
            else:
                f3[ml_map[ind]][kz] = orient(vals)
        else:
            v = orient(vals)
            if ind == 134:
                f2["ps"] = v
            elif ind == 167:
                f2["tt2"] = v
            elif ind == 168:
                f2["td2"] = v
            elif ind == 146:
                f2["sshf"] = v / accum_secs          # J/m2 -> W/m2
            elif ind == 176:
                f2["ssr"] = np.maximum(v / accum_secs, 0.0)
            elif ind == 142:
                f2["lsprec"] = np.maximum(v * 1000.0
                                          / (accum_secs / 3600.0), 0.0)
            elif ind == 143:
                f2["convprec"] = np.maximum(v * 1000.0
                                            / (accum_secs / 3600.0), 0.0)
            elif ind == 164:
                f2["tcc"] = np.clip(v, 0.0, 1.0)
            elif ind == 141:
                f2["sd"] = v
            elif ind == 129:
                f2["oro"] = v / 9.80665              # geopotential -> m
            elif ind == 160:
                f2["excessoro"] = v
            elif ind == 172:
                f2["lsm"] = v
            elif ind == 180:
                ewss = v / accum_secs
            elif ind == 165:
                u10 = v
            elif ind == 166:
                v10 = v
            elif ind == 181:
                nsss = v / accum_secs

    f2["surfstr"] = np.sqrt(ewss ** 2 + nsss ** 2)
    # artificial ground level: 10m winds, 2m T/q (readwind:489-494)
    f3["uuh"][0] = u10
    f3["vvh"][0] = v10
    f3["tth"][0] = f2["tt2"]
    f3["qvh"][0] = f3["qvh"][1]
    f3["wwh"][0] = 0.0
    d = dict(f2)
    d.update(f3)
    clock.lap("assembly")
    eta = eta_from_numpy(d, device)
    clock.lap("copy")
    if times is not None:
        times.add(clock.parts)
    return eta


@dataclasses.dataclass
class GribMet:
    """Met backend over an AVAILABLE index of GRIB files — the
    getfields.f90 read path with the native decoder.  ``read_times``
    sums the host seconds of every file's scan, decode, assembly and
    copy to the device."""
    metdata: Path
    entries: tuple[WindFieldEntry, ...]
    bdate: datetime
    accum_secs: float = 3600.0
    nxshift: int = 0

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
            self._grid = grid_from_grib(self.metdata / first,
                                        nxshift=self.nxshift)
        return self._grid

    def fetch(self, tsec: float, device: torch.device | str) -> EtaFields:
        t = int(tsec)
        if t not in self._by_sec:
            raise FileNotFoundError(f"no GRIB wind field for t={t}s")
        return eta_from_grib(self.metdata / self._by_sec[t],
                             self.grid(), self.accum_secs,
                             nxshift=self.nxshift, device=device,
                             times=self.read_times)

"""Landuse inventory + Wesely resistance tables (host-side parsing).

A copy of ``flexpart_tpu/physics/landuse.py`` (numpy only; the port imports
nothing of the JAX package).  It re-implements the reference's input layer
for dry deposition:
  * IGBP landuse inventory, 1200x600 cells at 0.3 deg, 3 bytes/cell packing
    (category high nibble, percentage/6.25 low nibble)
    — readlanduse.f90:60-110;
  * per-class roughness length z0 from surfdata.t — readlanduse.f90:115-125;
  * per-grid-cell fractional cover of the 13 classes with 10x10
    supersampling and sea/land fallback — assignland.f90:60-135;
  * Wesely seasonal resistance tables from surfdepo.t (5 seasons x
    13 classes x 7 rows, '9999.' = infinite) — readdepo.f90:40-100;
  * per-species gas resistance tables rlu/rgs/rcl and mesophyll rm
    — readdepo.f90:105-118, readreleases.f90:323.

All numpy, runs once at setup; outputs feed the vdep field of
physics/drydepo.py.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

NUMCLASS = 13
LU_NX, LU_NY = 1200, 600
LU_LON0, LU_LAT0, LU_D = -180.0, -90.0, 0.3

# default roughness per class (surfdata.t); overridable by read_surfdata
Z0_DEFAULT = np.array([0.7, 0.1, 0.1, 1.0, 1.0, 0.7, 0.001, 0.01, 0.1,
                       0.1, 0.05, 0.001, 1.0], np.float64)


def read_landuse_inventory(path: str | Path) -> np.ndarray:
    """IGBP_int1.dat -> fractional cover (LU_NX, LU_NY, 13).

    Each cell stores its 3 most abundant classes as nibble pairs
    (readlanduse.f90:62-110); fractions are normalized over the 3 entries
    (assignland.f90:22-45)."""
    raw = np.fromfile(path, dtype=np.uint8, count=LU_NX * LU_NY * 3)
    raw = raw.reshape(LU_NX, LU_NY, 3)
    cat = (raw >> 4).astype(np.int32)          # 1..13 (0 = none)
    perc = (raw & 0x0F).astype(np.float64)     # units of 6.25%
    sumperc = perc.sum(axis=2)
    frac = np.zeros((LU_NX, LU_NY, NUMCLASS), np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(sumperc[..., None] > 0, perc / sumperc[..., None], 0.0)
    for li in range(3):
        k = cat[..., li]
        valid = (k >= 1) & (k <= NUMCLASS)
        np.add.at(frac.reshape(-1, NUMCLASS),
                  (np.arange(LU_NX * LU_NY)[valid.ravel()],
                   (k.ravel()[valid.ravel()] - 1)),
                  p[..., li].ravel()[valid.ravel()])
    return frac


def read_surfdata(path: str | Path) -> np.ndarray:
    """surfdata.t -> z0 per class (13,)."""
    z0 = []
    for line in Path(path).read_text().splitlines()[4:4 + NUMCLASS]:
        z0.append(float(line[45:].strip()))
    return np.asarray(z0, np.float64)


def assign_landuse(nx: int, ny: int, dx: float, dy: float,
                   xlon0: float, ylat0: float, lsm: np.ndarray,
                   xlandusep: np.ndarray, nrefine: int = 10) -> np.ndarray:
    """Fractional landuse (ny, nx, 13) on the met grid by supersampling the
    0.3-deg inventory nrefine x nrefine per cell (assignland.f90:80-135);
    cells without inventory fall back to ocean (class 7) / rangeland
    (class 3) by land-sea mask."""
    ix = np.arange(nx)
    jy = np.arange(ny)
    sub = np.arange(nrefine) / nrefine
    xlon = (ix[:, None] + sub[None, :]) * dx + xlon0        # (nx, r)
    ylat = (jy[:, None] + sub[None, :]) * dy + ylat0        # (ny, r)
    xlon = np.where(xlon >= LU_LON0 + LU_NX * LU_D, xlon - LU_NX * LU_D, xlon)
    xi = ((xlon - LU_LON0) / LU_D).astype(np.int64) % LU_NX  # (nx, r)
    yj = ((ylat - LU_LAT0) / LU_D).astype(np.int64) % LU_NY  # (ny, r)
    # gather and average over the refinement samples
    # samples: (ny, r, nx, r, 13) -> mean over both r axes
    samp = xlandusep[xi[None, None, :, :], yj[:, :, None, None]]
    xlanduse = samp.mean(axis=(1, 3))                        # (ny, nx, 13)
    s = xlanduse.sum(axis=-1)
    # normalize where detailed landuse exists (assignland.f90:111-119)
    has = s > 0
    norm = np.where(s < 1 - 1e-5, np.maximum(s, 1e-30), 1.0)
    xlanduse = np.where(has[..., None], xlanduse / norm[..., None], 0.0)
    # fallback (assignland.f90:121-127)
    sea = (~has) & (lsm < 0.1)
    land = (~has) & (lsm >= 0.1)
    xlanduse[..., 6] += sea.astype(np.float64)   # class 7: water
    xlanduse[..., 2] += land.astype(np.float64)  # class 3: rangeland
    return xlanduse


@dataclasses.dataclass(frozen=True)
class WeselyTables:
    """(5 seasons, 13 classes) base resistances from surfdepo.t."""
    ri: np.ndarray
    rluh: np.ndarray
    rac: np.ndarray
    rgssh: np.ndarray
    rgsoh: np.ndarray
    rclsh: np.ndarray
    rcloh: np.ndarray


def read_surfdepo(path: str | Path) -> WeselyTables:
    """Parse surfdepo.t: after 16 header lines, 5 blocks of (separator +
    7 rows of '8x,13f8.0') (readdepo.f90:46-60); 9999 -> 1e25; floor 1e-3."""
    lines = Path(path).read_text().splitlines()
    rows = {k: np.zeros((5, NUMCLASS)) for k in
            ("ri", "rluh", "rac", "rgssh", "rgsoh", "rclsh", "rcloh")}
    order = ("ri", "rluh", "rac", "rgssh", "rgsoh", "rclsh", "rcloh")
    pos = 16
    for season in range(5):
        pos += 1  # separator line
        for name in order:
            toks = lines[pos].split()
            assert toks[0].lower().startswith(name[:3].lower()) or True
            vals = [float(t) for t in toks[1:1 + NUMCLASS]]
            rows[name][season] = vals
            pos += 1
    for name in order:
        a = rows[name]
        a[a == 9999.0] = 1.0e25
        np.maximum(a, 0.001, out=a)
    return WeselyTables(**rows)


def species_gas_tables(tables: WeselyTables, henry: float, f0: float):
    """Per-species rlu/rgs/rcl (5, 13) + mesophyll rm (readdepo.f90:105-118,
    readreleases.f90:323)."""
    rlu = tables.rluh / (1.0e-5 * henry + f0)
    rgs = 1.0 / (henry / (10.0e5 * tables.rgssh) + f0 / tables.rgsoh)
    rcl = 1.0 / (henry / (10.0e5 * tables.rclsh) + f0 / tables.rcloh)
    rm = 1.0 / (henry / 3000.0 + 100.0 * f0)
    return rlu, rgs, rcl, rm


def seasonal_category(mmdd: int, ylat: np.ndarray) -> np.ndarray:
    """Wesely seasonal category 1..5 per latitude row (getvdep.f90:60-85):
    southern hemisphere shifts half a year; tropics always midsummer."""
    south = ylat < 0.0
    # adding ~half a year to the julian date flips the month by 6
    mm, dd = mmdd // 100, mmdd % 100
    mm_s = (mm + 6 - 1) % 12 + 1
    eff = np.where(south, mm_s * 100 + dd, mmdd)

    season = np.full(ylat.shape, 2, np.int32)
    season = np.where((eff >= 1101) | (eff <= 331), 3, season)
    season = np.where((eff >= 1201) | (eff <= 301), 4, season)
    season = np.where((eff >= 401) & (eff <= 515), 5, season)
    season = np.where((eff >= 516) & (eff <= 915), 1, season)
    season = np.where((ylat > -20) & (ylat < 20), 1, season)  # mmdd=600
    return season

"""OH-radical chemistry: first-order mass loss against an OH climatology.

Port of ``flexpart_tpu/physics/ohchem.py`` (readOHfield.f90,
gethourlyOH.f90, zenithangle.f90, photo_O1D.f90 and ohreaction.f90 of the
reference).  The host part is a copy, numpy on the host: the solar zenith
angle, the J(O1D) lookup, the monthly climatology and its reader, the
synthetic stand-in climatology and the hourly correction of the whole OH
grid (``HourlyOH``, whose two fields are float32 tensors on the run's
device).  The per-particle reaction has two versions:

* ``ohreaction_plain``, plain PyTorch, which runs for CPU tensors;
* kernel K12 (``csrc/ohreaction.cu``: per particle the cell-centre
  temperature of the nearer wind field, the nearest OH cell, the hourly
  interpolation, the Arrhenius rate and the mass decay of every
  OH-reactive species, in one launch), which runs for CUDA tensors.  It
  blends the two hourly fields once per OH cell and finds the nearest
  cell by binary search where every axis is finite and nondecreasing
  (``sorted_axis``, checked once per grid: ``OHGrid.scan`` is False), by a
  scan of every entry otherwise; ``nearest_sorted`` is the search in plain
  torch, which the tests hold equal to ``_nearest``.

``make_ohreaction`` returns the function that picks by device and never
falls from one to the other.

Rounding, as in ``physics/wetdepo.py``: ``T ** n`` is ``torch.pow`` of two
tensors (the kernel's ``powf``), ``-d / T`` and the hourly weight are true
divisions, products are taken left to right as the reference writes them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from datetime import datetime, timedelta

import numpy as np
import torch

from .. import _build
from ..core.interp import vert_weights
from ..core.state import Particles
from .massupdate import MAX_SPECIES

PI = np.pi
TINY = float(np.finfo(np.float32).tiny)

# J(O1D) photolysis lookup (photo_O1D.f90)
ZANGLE = np.array([0., 10., 20., 30., 40., 50., 60., 70., 78., 86.,
                   90.0001], np.float64)
FACT_PHOTO = np.array([0.4616e-2, 0.4478e-2, 0.4131e-2, 0.3583e-2,
                       0.2867e-2, 0.2081e-2, 0.1235e-2, 0.5392e-3,
                       0.2200e-3, 0.1302e-3, 0.0902e-3], np.float64)


def zenith_angle(ylat, xlon, when: datetime):
    """Solar zenith angle [deg] (zenithangle.f90), vectorized over
    lat/lon arrays."""
    mm, dd = when.month, when.day
    ndaynum = 31 * (mm - 1) + dd
    if mm > 2:
        ndaynum -= int(0.4 * mm + 2.3)
        if when.year % 4 == 0:
            ndaynum += 1
    rnum = 2.0 * PI * ndaynum / 365.0
    rylat = PI * ylat / 180.0
    ttime = when.hour + when.minute / 60.0
    dekl = (0.396 + 3.631 * np.sin(rnum) + 0.038 * np.sin(2 * rnum)
            + 0.077 * np.sin(3 * rnum) - 22.97 * np.cos(rnum)
            - 0.389 * np.cos(2 * rnum) - 0.158 * np.cos(3 * rnum))
    rdekl = PI * dekl / 180.0
    eq = (0.003 - 7.343 * np.sin(rnum) - 9.47 * np.sin(2 * rnum)
          - 0.329 * np.sin(3 * rnum) - 0.196 * np.sin(4 * rnum)
          + 0.552 * np.cos(rnum) - 3.020 * np.cos(2 * rnum)
          - 0.076 * np.cos(3 * rnum) - 0.125 * np.cos(4 * rnum)) / 60.0
    sinsol = np.sin(rylat) * np.sin(rdekl) + np.cos(rylat) * np.cos(rdekl) \
        * np.cos((ttime - 12.0 + xlon / 15.0 + eq) * PI / 12.0)
    return 90.0 - np.degrees(np.arcsin(np.clip(sinsol, -1.0, 1.0)))


def photo_o1d(sza):
    """J(O1D) photolysis rate from zenith angle [deg] (photo_O1D.f90),
    vectorized: log-interpolation in secant of the zenith angle."""
    sza = np.asarray(sza, np.float64)
    szac = np.clip(sza, 0.0, 89.9999)
    ik = np.clip(np.searchsorted(ZANGLE, szac, side="right") - 1, 0,
                 len(ZANGLE) - 2)
    z1 = 1.0 / np.cos(np.deg2rad(ZANGLE[ik]))
    z2 = 1.0 / np.cos(np.deg2rad(ZANGLE[ik + 1]))
    zg = 1.0 / np.cos(np.deg2rad(szac))
    frac = (zg - z1) / (z2 - z1)
    f1 = np.log(FACT_PHOTO[ik])
    f2 = np.log(FACT_PHOTO[ik + 1])
    photo_no2 = 1.45e-2 * np.exp(-0.4 / np.cos(np.deg2rad(szac)))
    out = photo_no2 * np.exp(f1 + (f2 - f1) * frac)
    return np.where(sza < 90.0, out, 0.0)


@dataclasses.dataclass
class OHField:
    """Monthly OH climatology + monthly-mean J(O1D) (oh_mod.f90)."""
    lon: np.ndarray          # (nxOH,)
    lat: np.ndarray          # (nyOH,)
    alt: np.ndarray          # (nzOH,) level-center heights [m]
    oh: np.ndarray           # (nxOH, nyOH, nzOH, 12) [molecule/cm3]
    lonjr: np.ndarray        # (360,)
    latjr: np.ndarray        # (180,)
    jrate_avg: np.ndarray    # (360, 180, 12)

    @property
    def alt_top(self) -> np.ndarray:
        """Upper boundary of each layer (ohreaction.f90:117-121)."""
        a = self.alt
        top = np.empty_like(a)
        top[:-1] = a[1:] + 0.5 * (a[1:] - a[:-1])
        top[-1] = a[-1] + 0.5 * (a[-1] - a[-2])
        return top


def _fortran_records(fh):
    """Yield payloads of little-endian Fortran sequential records."""
    while True:
        head = fh.read(4)
        if len(head) < 4:
            return
        (n,) = np.frombuffer(head, "<i4")
        payload = fh.read(int(n))
        fh.read(4)
        yield payload


def read_oh_field(path) -> OHField:
    """Parse OH_variables.bin (readOHfield.f90:43-77)."""
    with open(path, "rb") as fh:
        rec = _fortran_records(fh)
        nx = int(np.frombuffer(next(rec), "<i4")[0])
        ny = int(np.frombuffer(next(rec), "<i4")[0])
        nz = int(np.frombuffer(next(rec), "<i4")[0])
        lonjr = np.frombuffer(next(rec), "<f4")
        latjr = np.frombuffer(next(rec), "<f4")
        jrate = np.frombuffer(next(rec), "<f4").reshape(12, 180, 360).T
        lon = np.frombuffer(next(rec), "<f4")
        lat = np.frombuffer(next(rec), "<f4")
        next(rec)                                  # lonOH repeated
        alt = np.frombuffer(next(rec), "<f4")
        oh = np.frombuffer(next(rec), "<f4").reshape(12, nz, ny, nx).T
    return OHField(lon=lon, lat=lat, alt=alt, oh=oh,
                   lonjr=lonjr, latjr=latjr, jrate_avg=jrate)


def synthetic_oh_field(nx=72, ny=46, nz=7) -> OHField:
    """Plausible stand-in climatology when OH_variables.bin is absent:
    tropical maximum ~2e6 molecule/cm3, decaying with altitude and
    latitude, seasonal shift following the sun."""
    lon = -180.0 + 360.0 * np.arange(nx) / nx + 180.0 / nx
    lat = -90.0 + 180.0 * np.arange(ny) / ny + 90.0 / ny
    alt = np.array([500.0, 1500.0, 3000.0, 5000.0, 7500.0, 10500.0,
                    14000.0][:nz])
    months = np.arange(12)
    sun_lat = -23.4 * np.cos(2 * PI * (months + 0.5) / 12.0)
    oh = (2.0e6
          * np.exp(-((lat[None, :, None, None]
                      - sun_lat[None, None, None, :]) / 35.0) ** 2)
          * np.exp(-alt[None, None, :, None] / 8000.0)
          * np.ones((nx, 1, 1, 1)))
    lonjr = -179.5 + np.arange(360)
    latjr = -89.5 + np.arange(180)
    jr = np.zeros((360, 180, 12))
    for m in range(12):
        # monthly-mean J(O1D): daytime average approximation
        szas = zenith_angle(latjr[None, :], lonjr[:, None],
                            datetime(2020, m + 1, 15, 12))
        jr[:, :, m] = 0.35 * photo_o1d(szas)
    jr = np.maximum(jr, 1e-12)
    return OHField(lon=lon, lat=lat, alt=alt, oh=oh.astype(np.float32),
                   lonjr=lonjr, latjr=latjr, jrate_avg=jr)


class HourlyOH:
    """Maintains the two hourly-corrected OH fields around current time
    (gethourlyOH.f90 double buffer), as float32 tensors on ``device``."""

    def __init__(self, field: OHField, bdate: datetime, ldirect: int = 1,
                 device="cpu"):
        self.f = field
        self.bdate = bdate
        self.ldirect = ldirect
        self.device = torch.device(device)
        # nearest jrate cell for every OH cell (precomputed)
        self.ijx = np.abs(field.lonjr[None, :]
                          - field.lon[:, None]).argmin(axis=1)
        self.jjy = np.abs(field.latjr[None, :]
                          - field.lat[:, None]).argmin(axis=1)
        self.t = [None, None]
        self.oh = [None, None]

    def _field_at(self, tsec: float) -> torch.Tensor:
        when = self.bdate + timedelta(seconds=float(tsec))
        m = when.month - 1
        sza = zenith_angle(self.f.lat[None, :], self.f.lon[:, None], when)
        jrate = photo_o1d(sza)                       # (nx, ny)
        javg = self.f.jrate_avg[self.ijx[:, None], self.jjy[None, :], m]
        corr = np.where(javg > 0.0, jrate / javg, 0.0)
        oh = (self.f.oh[:, :, :, m] * corr[:, :, None]).astype(np.float32)
        return torch.as_tensor(oh, device=self.device)

    def fields_for(self, itime: int):
        """Returns (oh0, oh1, t0, t1) hourly bracket of itime."""
        t0 = (itime // 3600) * 3600
        if self.ldirect < 0 and itime % 3600 == 0:
            t0 = itime - 3600
        t1 = t0 + 3600
        if self.t[0] != t0:
            self.t[0] = t0
            self.oh[0] = self._field_at(t0)
        if self.t[1] != t1:
            self.t[1] = t1
            self.oh[1] = self._field_at(t1)
        return self.oh[0], self.oh[1], t0, t1


@dataclasses.dataclass(frozen=True)
class OHGrid:
    """What the per-particle reaction reads besides the particles: the OH
    grid's axes (float32; ``axes`` the three concatenated on the run's
    device, made once), the met grid's origin and spacing, the constants
    (c, d, n) of every species, None where it does not react, and ``scan``:
    an axis is not finite and nondecreasing, so K12 takes its SCAN
    instantiation."""
    lon: np.ndarray
    lat: np.ndarray
    alt_top: np.ndarray
    axes: torch.Tensor
    xlon0: float
    ylat0: float
    dx: float
    dy: float
    nx: int
    ny: int
    consts: tuple
    scan: bool = False


def hourly_weight(itime: int, t0: int, t1: int) -> float:
    """(itime - t0) / (t1 - t0) in float32, one rounding."""
    return float(np.float32(itime - t0) / np.float32(t1 - t0))


def cell_temps_plain(p: Particles, tt: torch.Tensor, height: torch.Tensor,
                     nx: int, ny: int) -> torch.Tensor:
    """The temperature of the cell centre at each particle
    (ohreaction.f90:139; the reference's ``Simulation._cell_temps``): the
    truncated column, the level below the particle."""
    ix = torch.clamp(p.x.to(torch.int32), 0, nx - 1).long()
    jy = torch.clamp(p.y.to(torch.int32), 0, ny - 1).long()
    indz, _ = vert_weights(p.z, height)
    return tt[indz, jy, ix]


def _nearest(axis: torch.Tensor, v: torch.Tensor,
             chunk: int = 1 << 20) -> torch.Tensor:
    """argmin |axis - v| per particle, the first of equal distances (a NaN
    distance counts as the least, as in jnp.argmin), in chunks of
    particles so that the (chunk, len(axis)) distances stay small."""
    out = torch.empty(v.shape[0], dtype=torch.int64, device=v.device)
    for a in range(0, v.shape[0], chunk):
        d = torch.abs(axis[None, :] - v[a:a + chunk, None])
        out[a:a + chunk] = torch.argmin(d, dim=1)
    return out


def sorted_axis(axis: np.ndarray) -> bool:
    """The axis is finite and nondecreasing in float32: the condition under
    which K12's search finds ``_nearest``'s index."""
    a = np.asarray(axis, np.float32)
    return bool(np.all(np.isfinite(a)) and np.all(a[1:] >= a[:-1]))


def _first_at_least(axis: torch.Tensor, lo, hi, v, t):
    """Per element the first i in [lo, hi) with fl(axis[i] - v) >= t, hi
    where none: K12's binary search (``first_at_least``), every step on
    every element (an element whose range is empty stays)."""
    last = axis.shape[0] - 1
    n = hi - lo
    for _ in range(axis.shape[0].bit_length()):
        half = n >> 1
        probe = axis[torch.clamp(lo + half, 0, last)] - v
        live = n > 0
        up = live & ~(probe >= t)
        lo = torch.where(up, lo + half + 1, lo)
        n = torch.where(up, n - half - 1, torch.where(live, half, n))
    return lo


def nearest_sorted(axis: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_nearest`` on a finite nondecreasing axis by K12's search
    (``nearest_sorted`` of csrc/ohreaction.cu), in plain torch for the
    tests: fl(axis[i] - v) is nondecreasing in i, so the least distance
    lies at j, the first i with a difference >= 0, or at j - 1 (a tie to
    j - 1), and where j - 1 wins, at the first index of its difference; v
    NaN gives 0."""
    size = axis.shape[0]
    zero = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    j = _first_at_least(axis, zero, torch.full_like(zero, size), v,
                        torch.zeros_like(v))
    below = axis[torch.clamp(j - 1, 0, size - 1)] - v
    above = axis[torch.clamp(j, 0, size - 1)] - v
    take_j = (j < size) & (above < -below)
    plateau = (j >= 2) & (axis[torch.clamp(j - 2, 0, size - 1)] - v == below)
    first = _first_at_least(axis, zero, torch.clamp(j - 1, 0, size), v,
                            below)
    out = torch.where(take_j, j, torch.where(plateau, first, j - 1))
    return torch.where((j == 0) | torch.isnan(v), zero, out)


def ohreaction_plain(p: Particles, g: OHGrid, oh0, oh1, t0: int, t1: int,
                     itime: int, tt, height, ltsample: int) -> Particles:
    """The per-particle OH loss (ohreaction.f90:100-160, the reference's
    ``make_ohreaction`` body fed ``_cell_temps``): nearest OH cell, hourly
    interpolation, Arrhenius rate, mass decay."""
    dev = p.device
    temps = cell_temps_plain(p, tt, height, g.nx, g.ny)
    xlon = p.x * g.dx + g.xlon0
    xlon = torch.where(xlon > 180.0, xlon - 360.0, xlon)
    ylat = p.y * g.dy + g.ylat0
    ix = _nearest(torch.as_tensor(g.lon, device=dev), xlon)
    jy = _nearest(torch.as_tensor(g.lat, device=dev), ylat)
    kz = _nearest(torch.as_tensor(g.alt_top, device=dev), p.z)
    w = hourly_weight(itime, t0, t1)
    wt = torch.full_like(temps, w)
    oh_avg = oh0[ix, jy, kz] * (1.0 - wt) + oh1[ix, jy, kz] * wt
    oh_avg = torch.where((oh_avg > 0.0) | torch.isnan(oh_avg), oh_avg,
                         torch.zeros_like(oh_avg))
    keep = ~(p.active & (oh_avg > 0.0))
    dt = float(abs(ltsample))
    cols = []
    for k in range(p.nspec):
        m = p.mass[:, k]
        if g.consts[k] is None:
            cols.append(m)
            continue
        c, d, n = g.consts[k]
        rate = c * torch.pow(temps, torch.full_like(temps, n)) \
            * torch.exp(torch.full_like(temps, -d) / temps) * oh_avg
        newm = m * torch.exp(-rate * dt)
        newm = torch.where(newm > TINY, newm, torch.zeros_like(newm))
        cols.append(torch.where(keep, m, newm))
    return p.replace(mass=torch.stack(cols, dim=1))


class OHSpec(ctypes.Structure):
    """One species' constants for K12 (``OHSpec`` of csrc/ohreaction.cu)."""
    _fields_ = [("c", ctypes.c_float), ("d", ctypes.c_float),
                ("n", ctypes.c_float), ("on", ctypes.c_int)]


def k12_arguments(p: Particles, g: OHGrid, oh0, oh1, t0: int, t1: int,
                  itime: int, tt, height, ltsample: int):
    """K12's checks and its C arguments up to ``|ltsample|`` (the scan
    flag, the output and the stream follow): (the arguments, the OHSpec
    array they point into, which must live through the launch)."""
    n, nspec, dev = p.capacity, p.nspec, p.device
    if nspec > MAX_SPECIES:
        raise ValueError(f"K12 takes at most {MAX_SPECIES} species")
    if n >= 2 ** 31:
        raise ValueError("K12 indexes particles with int32")
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "active"):
        t = getattr(p, name)
        want = torch.bool if name == "active" else torch.float32
        if t.device != dev or t.dtype != want or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"K12: particle field {name} must be contiguous "
                             f"{want} ({n},) on {dev}")
    if p.mass.device != dev or p.mass.dtype != torch.float32 \
            or tuple(p.mass.shape) != (n, nspec) \
            or not p.mass.is_contiguous():
        raise ValueError(f"K12: mass must be contiguous float32 "
                         f"({n}, {nspec}) on {dev}")
    noh = (len(g.lon), len(g.lat), len(g.alt_top))
    for name, f in (("oh0", oh0), ("oh1", oh1)):
        if f.device != dev or f.dtype != torch.float32 \
                or tuple(f.shape) != noh or not f.is_contiguous():
            raise ValueError(f"K12: {name} must be contiguous float32 "
                             f"{noh} on {dev}")
    if tt.device != dev or tt.dtype != torch.float32 or tt.dim() != 3 \
            or tuple(tt.shape[1:]) != (g.ny, g.nx) or not tt.is_contiguous():
        raise ValueError(f"K12: the temperature must be contiguous float32 "
                         f"(nz, {g.ny}, {g.nx}) on {dev}")
    nz = tt.shape[0]
    if height.device != dev or height.dtype != torch.float32 \
            or tuple(height.shape) != (nz,) or nz < 2 \
            or not height.is_contiguous():
        raise ValueError(f"K12: height must be contiguous float32 ({nz},) "
                         f"on {dev}")
    if g.axes.device != dev:
        raise ValueError(f"K12: the OH axes must be on {dev}")
    if t1 == t0:
        raise ValueError("K12: the hourly bracket is empty")
    specs = (OHSpec * MAX_SPECIES)()
    for k, cst in enumerate(g.consts):
        if cst is not None:
            specs[k].c, specs[k].d, specs[k].n = (float(v) for v in cst)
            specs[k].on = 1
    args = (p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), p.active.data_ptr(),
            p.mass.data_ptr(), tt.data_ptr(), height.data_ptr(), nz, g.ny,
            g.nx, float(np.float32(g.xlon0)), float(np.float32(g.ylat0)),
            float(np.float32(g.dx)), float(np.float32(g.dy)),
            g.axes.data_ptr(), *noh, oh0.data_ptr(), oh1.data_ptr(),
            int(itime), int(t0), int(t1), ctypes.addressof(specs), n, nspec,
            abs(int(ltsample)))
    return args, specs


def ohreaction_cuda(p: Particles, g: OHGrid, oh0, oh1, t0: int, t1: int,
                    itime: int, tt, height, ltsample: int) -> Particles:
    """K12 launch: one thread per particle, the mass written out of place;
    its search instantiation, or SCAN where ``g.scan``."""
    # _specs: the OHSpec array the arguments point into, alive to the call
    args, _specs = k12_arguments(p, g, oh0, oh1, t0, t1, itime, tt, height,
                                 ltsample)
    mass = torch.empty_like(p.mass)
    if p.capacity == 0:
        return p.replace(mass=mass)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        _build.OHREACTION(*args, int(g.scan), mass.data_ptr(), stream)
    return p.replace(mass=mass)


def make_ohreaction(field: OHField, grid, species, device):
    """The per-particle OH loss of a run (ohreaction.f90:100-160):
    ``ohreaction(p, oh0, oh1, t0, t1, itime, tt, height, ltsample)`` with
    ``tt`` the (nz, ny, nx) temperature of the nearer wind field and
    ``height`` its levels.  K12 on a CUDA device, the plain version on the
    CPU.  The axes are checked here, once: K12 searches them where all
    three are finite and nondecreasing (``sorted_axis``) and scans them
    otherwise."""
    lon = np.array(field.lon, np.float32)
    lat = np.array(field.lat, np.float32)
    alt_top = np.array(field.alt_top, np.float32)
    g = OHGrid(
        lon=lon, lat=lat, alt_top=alt_top,
        axes=torch.as_tensor(np.concatenate([lon, lat, alt_top]),
                             device=device),
        xlon0=grid.xlon0, ylat0=grid.ylat0, dx=grid.dx, dy=grid.dy,
        nx=grid.nx, ny=grid.ny,
        consts=tuple((s.ohcconst, s.ohdconst, s.ohnconst)
                     if s.ohcconst > 0 else None for s in species),
        scan=not all(sorted_axis(a) for a in (lon, lat, alt_top)))
    run = {"cuda": ohreaction_cuda,
           "cpu": ohreaction_plain}.get(torch.device(device).type)
    if run is None:
        raise ValueError(f"no OH-reaction backend for device {device}")

    def ohreaction(p, oh0, oh1, t0, t1, itime, tt, height, ltsample):
        return run(p, g, oh0, oh1, t0, t1, itime, tt, height, ltsample)

    ohreaction.grid = g
    return ohreaction

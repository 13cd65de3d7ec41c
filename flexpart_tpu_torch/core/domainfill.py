"""Domain-filling mode (MDOMAINFILL=1/2) with its regional boundary.

Port of ``flexpart_tpu/core/domainfill.py`` (init_domainfill.f90,
boundcond_domainfill.f90).  ``init_domainfill`` and ``_init_boundary`` are
the JAX package's numpy code, copied (``_init_boundary`` vectorised over
each boundary column, the same values; the loop took half a minute at
10**7 particles): the (global or windowed) domain is
filled with particles of equal air mass, spread horizontally by the air
column's mass and vertically uniformly in pressure; MDOMAINFILL=2 keeps
the stratospheric particles only (z > 3 km, |PV| > pvcrit) and weights
their mass by the PV-based ozone proxy.  With the same ``seed`` the fill
is the JAX package's bit for bit.

A regional window adds the boundary condition: particles that left the
window are destroyed, the air mass that flows in through every boundary
site (one layer of one boundary column; its geometry fixed at the fill,
``BoundaryState``) is accumulated each step, and whenever a site has
gathered one particle mass, a particle is created on its face, at most
``KMAX_EMIT`` a site and step (the rest stays in the accumulator).  The
step is kernel K14 (``csrc/domainfill.cu``) on CUDA tensors and
``boundcond_plain``, its twin, on CPU tensors; ``boundcond`` picks by
device and never falls from one to the other.  Both update the particles
in place and return the new accumulator.

Which free slot a new particle takes must match the reference: the k-th
wanting (round, site) takes the k-th free slot in the reference's slot
order.  The port keeps its particles in met-cell order, so it ranks the
free slots by their schedule origin (``Simulation._origin``), as K13 does;
a new particle fills a port slot in place, so ``_origin`` stays a
permutation.  The reference emits in up to four rounds, each over the
free slots that the earlier rounds left; as a round only takes the first
free slots and a site's wish in a round depends on nothing taken before,
one ranking of the wishes in (round, site) order gives the same slots.

The reference's draws come from ``jax.random``, which the port cannot
reproduce.  The port draws from its Philox: for round r and site s, the
words of counter (s, r, 0, 0) under ``Key(seed, 3000000 + istep)``'s key
of tag ``BOUNDARY_TAG``: word 0 the position along the face, word 1 the
height, word 2 the uncertainty class.  ``draws`` injects other numbers
(the tests pass JAX's own).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..constants import GA, PI, PI180, R_AIR, R_EARTH
from ..met.fields import F3_PV, F3_RHO, F3_TT, F3_U, F3_V
from . import rng
from .interp import true_div
from .state import FIELDS, ITRA_INACTIVE, Particles, empty_particles

PVCRIT = 2.0           # par_mod pvcrit [pvu]
OZONESCALE = 60.0      # ng O3 / m3 / pvu (par_mod)
M_PER_DEG = 111198.5   # metres per degree latitude (boundcond:77-81)
KMAX_EMIT = 4          # max particles emitted per site per step
BOUNDARY_TAG = 14      # the Philox tag of the boundary's draws
# K14's scratch (csrc/domainfill.cu): origins per tile of its free scan
TILE = 4096


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _gridarea(grid) -> np.ndarray:
    """Cell areas per latitude row (init_domainfill.f90:44-85), with the
    pole-cap rows treated as spherical caps."""
    jy = np.arange(grid.ny)
    ylat = grid.ylat0 + jy * grid.dy
    ylatp = np.minimum(ylat + 0.5 * grid.dy, 90.0)
    ylatm = np.maximum(ylat - 0.5 * grid.dy, -90.0)
    cosp = np.cos(np.deg2rad(ylatp)) * R_EARTH
    cosm = np.cos(np.deg2rad(ylatm)) * R_EARTH
    opposite = (ylatm < 0.0) & (ylatp > 0.0)
    hzone = np.where(
        opposite,
        R_EARTH * np.deg2rad(grid.dy),
        np.abs(np.sqrt(np.maximum(R_EARTH ** 2 - cosp ** 2, 0.0))
               - np.sqrt(np.maximum(R_EARTH ** 2 - cosm ** 2, 0.0))))
    return 2.0 * PI * R_EARTH * hzone * grid.dx / 360.0


def init_domainfill(grid, zf, npart: int, mdomainfill: int = 1,
                    nclassunc: int = 1, seed: int = 17,
                    capacity: int | None = None, window=None):
    """Build the filled-domain particle population from the first wind
    field (ZFields; its arrays on any device).  Returns (the particles as
    a dict of numpy arrays, FIELDS, the total air mass [kg], the boundary
    table as a dict of numpy arrays (``BoundaryState``'s fields) or
    None).

    ``window`` = (x1, x2, y1, y2) in mother-grid units (the release box,
    init_domainfill.f90:54-57).  When it covers the whole domain the run
    is global (gdomainfill) and no boundary state is needed; otherwise
    the fill is restricted to the window and its boundary table is
    returned too."""
    rho = _np(zf.f3d[F3_RHO])                 # (nz, ny, nx)
    tt = _np(zf.f3d[F3_TT])
    pv = _np(zf.f3d[F3_PV])
    height = _np(zf.height)
    nz, ny, nx = rho.shape
    nxm = nx - 1 if grid.xglobal else nx      # skip duplicated column
    rng = np.random.default_rng(seed)

    # regional window (init_domainfill.f90:54-78)
    nx_we = [0, nxm - 1]
    ny_sn = [0, ny - 1]
    gdomainfill = True
    if window is not None:
        x1, x2, y1, y2 = window
        nx_we = [max(int(x1), 0), min(int(x2) + 1, nx - 1)]
        ny_sn = [max(int(y1), 0), min(int(y2) + 1, ny - 1)]
        if grid.xglobal:
            nx_we[1] = min(nx_we[1], nx - 2)
        gdomainfill = (nx_we == [0, nx - 2 if grid.xglobal else nx - 1]
                       and ny_sn == [0, ny - 1])
        if gdomainfill:
            nx_we = [0, nxm - 1]

    # pseudo-pressure profile p(kz) = rho*R*T (init_domainfill.f90:92-98)
    pp = rho * R_AIR * tt                      # (nz, ny, nx)
    area = _gridarea(grid)                     # (ny,)
    colmass = (pp[0] - pp[-1]) / GA * area[:, None]      # (ny, nx)
    colmass = colmass[:, :nxm]
    if not gdomainfill:
        inwin = np.zeros((ny, nxm), bool)
        inwin[ny_sn[0]:ny_sn[1] + 1, nx_we[0]:nx_we[1] + 1] = True
        colmass = np.where(inwin, colmass, 0.0)
    total = float(colmass.sum())

    ncolumn = np.rint(0.999 * npart * colmass / total).astype(np.int64)
    n_total = int(ncolumn.sum())

    # expand to per-particle column indices
    flat_cols = np.nonzero(ncolumn.ravel())[0]
    counts = ncolumn.ravel()[flat_cols]
    col_of = np.repeat(flat_cols, counts)              # (N,)
    jy = (col_of // nxm).astype(np.int64)
    ix = (col_of % nxm).astype(np.int64)
    # index-within-column 0..ncolumn-1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j_in = np.arange(n_total) - np.repeat(starts, counts)

    pp1 = pp[0, jy, ix]
    ppn = pp[-1, jy, ix]
    ncol_p = np.repeat(counts, counts).astype(np.float64)
    deltacol = (pp1 - ppn) / ncol_p
    # regular pressure spacing for populous columns, random for sparse
    # ones (init_domainfill.f90:120-128)
    pnew_reg = pp1 - (j_in + 0.5) * deltacol
    pnew_rnd = pp1 - rng.random(n_total) * (pp1 - ppn)
    pnew = np.where(ncol_p > 20, pnew_reg, pnew_rnd)

    # vertical interpolation of pnew in the column profile
    prof = pp[:, jy, ix]                               # (nz, N)
    kz = np.clip((prof >= pnew[None, :]).sum(axis=0) - 1, 0, nz - 2)
    idx = np.arange(n_total)
    dz1 = prof[kz, idx] - pnew
    dz2 = pnew - prof[kz + 1, idx]
    dz = 1.0 / np.maximum(dz1 + dz2, 1e-10)
    z = (height[kz] * dz2 + height[kz + 1] * dz1) * dz
    z = np.minimum(z, height[-1] - 0.5)

    x = ix - 0.5 + rng.random(n_total)
    x = np.where(ix == 0, rng.random(n_total), x)
    x = np.where(ix == nxm - 1, nxm - 1 - rng.random(n_total), x)
    y = jy - 0.5 + rng.random(n_total)
    y = np.clip(y, 0.0, ny - 1 - 1e-4)

    mass = (colmass[jy, ix] / ncol_p).astype(np.float32)

    keep = np.ones(n_total, bool)
    if mdomainfill == 2:
        # stratospheric ozone proxy (init_domainfill.f90:186-203)
        pvf = pv[:, jy, ix]
        pvpart = (pvf[kz, idx] * dz2 + pvf[kz + 1, idx] * dz1) * dz
        ylat = grid.ylat0 + y * grid.dy
        pvpart = np.where(ylat < 0.0, -pvpart, pvpart)
        keep = (z > 3000.0) & (pvpart > PVCRIT)
        mass = mass * pvpart * 48.0 / 29.0 * OZONESCALE / 1.0e9

    n_keep = int(keep.sum())
    if capacity is None:
        capacity = n_keep
    # the empty state's arrays (torch's, as numpy views)
    empty = empty_particles(capacity, 1, device="cpu")
    parts = {f: getattr(empty, f).numpy() for f in FIELDS}
    sl = np.nonzero(keep)[0]
    out = np.arange(n_keep)
    m2 = mass[sl][:, None]
    parts["x_hi"][out] = x[sl].astype(np.float32)
    parts["y_hi"][out] = y[sl].astype(np.float32)
    parts["z"][out] = z[sl].astype(np.float32)
    parts["itra"][out] = 0
    parts["itramem"][out] = 0
    parts["npoint"][out] = 0
    parts["nclass"][out] = rng.integers(0, nclassunc,
                                        size=n_keep).astype(np.int32)
    parts["mass"][out] = m2
    parts["mass0"][out] = m2
    parts["active"][out] = False          # activated at itime=0
    boundary = None
    if not gdomainfill:
        xmassperparticle = total / max(n_total, 1)
        boundary = _init_boundary(grid, height, nx_we, ny_sn, ncolumn,
                                  jy, ix, j_in, z, xmassperparticle)
    return parts, total, boundary


def _init_boundary(grid, height, nx_we, ny_sn, ncolumn, jy, ix, j_in, z,
                   xmassperparticle) -> dict:
    """Build the flattened site table from the initialized particle
    population (init_domainfill.f90:324-372 records zcolumn_we/sn).

    The JAX package's loop, vectorized: the boundary columns' particles
    are put in (column, height) order once, and each column's rows are
    computed as arrays with the loop's operations in its order (float64,
    then float32), so that the table is the JAX package's bit for bit."""
    nx = grid.nx
    nz = height.shape[0]
    nxm = nx - 1 if grid.xglobal else nx

    # the boundary columns, in the reference's site order: (strip, k, ii,
    # jj, corner)
    cols = []
    for k, ixb in enumerate(nx_we):
        for jj in range(ny_sn[0], ny_sn[1] + 1):
            cols.append(("we", k, ixb, jj, jj in (ny_sn[0], ny_sn[1])))
    for k, jjb in enumerate(ny_sn):
        for ii in range(nx_we[0], nx_we[1] + 1):
            cols.append(("sn", k, ii, jjb, ii in (nx_we[0], nx_we[1])))
    # per boundary column its particles' heights, sorted (= zcolumn)
    ids = np.unique([jj * nxm + ii for _, _, ii, jj, _ in cols])
    colid = jy * nxm + ix
    on = np.isin(colid, ids)
    cz, zz = colid[on], z[on]
    order = np.lexsort((zz, cz))
    cz, zz = cz[order], zz[order]

    def column_z(jj, ii):
        c = jj * nxm + ii
        return zz[np.searchsorted(cz, c, "left"):
                  np.searchsorted(cz, c, "right")]

    ztop = float(height[-1])
    parts = []
    for strip, k, ii, jj, corner in cols:
        zc = column_z(jj, ii)
        J = len(zc)
        if J == 0:
            continue
        deltaz = np.empty(J)
        z_base = np.empty(J)
        z_span = np.zeros(J)
        if J > 2:
            deltaz[1:-1] = (zc[2:] - zc[:-2]) / 2.0
            z_base[1:-1] = zc[:-2]
            z_span[1:-1] = zc[2:] - zc[:-2]
        if J > 1:
            deltaz[-1] = ((zc[J - 1] - zc[J - 3]) / 2.0 if J >= 3
                          else zc[1] - zc[0])
            z_base[-1] = (2.0 * zc[J - 1] + zc[J - 2] + ztop) / 4.0
            deltaz[0] = (zc[1] + zc[0]) / 2.0
            z_base[0] = zc[0] + (zc[1] - zc[0]) / 4.0
        else:
            deltaz[0] = 2.0 * zc[0]
            z_base[0] = zc[0] + 0.0
        if strip == "we":
            lat_fact = 1.0
            width_deg = grid.dy
        else:
            lat_fact = float(np.cos((grid.ylat0 + jj * grid.dy) * PI180))
            width_deg = grid.dx
        area = np.maximum(deltaz, 0.0) * M_PER_DEG * width_deg * lat_fact
        if corner:
            area = area * 0.5
        # emission position (boundcond_domainfill.f90:150-167)
        if strip == "we":
            x_base, x_span = float(ii), 0.0
            if jj == ny_sn[0]:
                y_base, y_span = float(jj), 0.5
            elif jj == ny_sn[1]:
                y_base, y_span = float(jj), -0.5
            else:
                y_base, y_span = jj - 0.5, 1.0
        else:
            y_base, y_span = float(jj), 0.0
            if ii == nx_we[0]:
                x_base, x_span = float(ii), 0.5
            elif ii == nx_we[1]:
                x_base, x_span = float(ii), -0.5
            else:
                x_base, x_span = ii - 0.5, 1.0
        kz = np.clip(np.searchsorted(height, zc), 1, nz - 1)
        dz1 = zc - height[kz - 1]
        dz2 = height[kz] - zc
        dzi = 1.0 / np.maximum(dz1 + dz2, 1e-6)

        def const(v):
            return np.full(J, v)

        parts.append(dict(
            col_flat=const(jj * nx + ii), is_we=const(strip == "we"),
            # inflow: u > 0 at the west face, v > 0 at the south face
            sgn=const(1.0 if k == 0 else -1.0), area=area, kz=kz - 1,
            wlo=dz2 * dzi, whi=dz1 * dzi, x_base=const(x_base),
            x_span=const(x_span), y_base=const(y_base),
            y_span=const(y_span), z_base=z_base, z_span=z_span,
            valid=const(True)))
    if not parts:
        parts = [dict(col_flat=[0], is_we=[True], sgn=[1.0], area=[0.0],
                      kz=[0], wlo=[0.5], whi=[0.5], x_base=[0.0],
                      x_span=[0.0], y_base=[0.0], y_span=[0.0],
                      z_base=[0.0], z_span=[0.0], valid=[False])]

    def cat(name, dt):
        return np.concatenate([np.asarray(q[name]) for q in parts]) \
            .astype(dt)

    f32 = np.float32
    out = {name: cat(name, dt) for name, dt in (
        ("col_flat", np.int32), ("is_we", bool), ("sgn", f32),
        ("area", f32), ("kz", np.int32), ("wlo", f32), ("whi", f32),
        ("x_base", f32), ("x_span", f32), ("y_base", f32), ("y_span", f32),
        ("z_base", f32), ("z_span", f32), ("valid", bool))}
    out["acc"] = np.zeros(len(out["valid"]), f32)
    out["xpp"] = np.float32(xmassperparticle)
    out["xlim"] = np.asarray([nx_we[0], nx_we[1]], f32)
    out["ylim"] = np.asarray([ny_sn[0], ny_sn[1]], f32)
    return out


BOUNDARY_FIELDS = ("acc", "col_flat", "is_we", "sgn", "area", "kz", "wlo",
                   "whi", "x_base", "x_span", "y_base", "y_span", "z_base",
                   "z_span", "valid", "xpp", "xlim", "ylim")


@dataclasses.dataclass
class BoundaryState:
    """The site table and flux accumulator of a regional domain fill
    (boundcond_domainfill.f90), tensors on one device: one site is one
    layer of one boundary column; all its geometry is fixed at the fill
    and only ``acc`` changes."""
    acc: torch.Tensor       # (S,) f32 accumulated inflow air mass [kg]
    col_flat: torch.Tensor  # (S,) i32 jy * nx + ix of the boundary column
    is_we: torch.Tensor     # (S,) bool: west/east face (u) or south/north (v)
    sgn: torch.Tensor       # (S,) f32 +1 where inflow is a positive wind
    area: torch.Tensor      # (S,) f32 face area [m2]
    kz: torch.Tensor        # (S,) i32 lower height level at the site
    wlo: torch.Tensor       # (S,) f32 weight of level kz
    whi: torch.Tensor       # (S,) f32 weight of level kz + 1
    x_base: torch.Tensor    # (S,) f32 emission position: base + u * span
    x_span: torch.Tensor
    y_base: torch.Tensor
    y_span: torch.Tensor
    z_base: torch.Tensor
    z_span: torch.Tensor
    valid: torch.Tensor     # (S,) bool
    xpp: torch.Tensor       # () f32 air mass per particle [kg]
    xlim: torch.Tensor      # (2,) f32 window [lo, hi] in grid units
    ylim: torch.Tensor      # (2,) f32

    @staticmethod
    def from_numpy(d, device) -> "BoundaryState":
        out = {}
        for f in BOUNDARY_FIELDS:
            a = np.asarray(d[f] if isinstance(d, dict) else getattr(d, f))
            dt = (np.int32 if f in ("col_flat", "kz") else
                  bool if f in ("is_we", "valid") else np.float32)
            out[f] = torch.as_tensor(np.array(a, dt), device=device)
        return BoundaryState(**out)

    def to_numpy(self) -> dict:
        return {f: _np(getattr(self, f)) for f in BOUNDARY_FIELDS}

    def replace(self, **kw) -> "BoundaryState":
        return dataclasses.replace(self, **kw)

    @property
    def sites(self) -> int:
        return self.acc.shape[0]

    def limits(self) -> tuple:
        """(xpp, x_lo, x_hi, y_lo, y_hi) as host floats (read once: they
        never change)."""
        if not hasattr(self, "_limits"):
            xl, yl = _np(self.xlim), _np(self.ylim)
            self._limits = (float(_np(self.xpp)), float(xl[0]),
                            float(xl[1]), float(yl[0]), float(yl[1]))
        return self._limits


def time_weights(itime: int, mt0: int, mt1: int):
    """(w0, w1), the float32 weights of the two met times at ``itime``
    (boundcond_domainfill.f90:49-56)."""
    dt1 = np.float32(itime - mt0)
    dt2 = np.float32(mt1 - itime)
    return float(dt2 / (dt1 + dt2)), float(dt1 / (dt1 + dt2))


def philox_draws(key: "rng.Key", sites: int, nclassunc: int, device):
    """The port's draws of a step: (u1, u2, nclass), each (KMAX_EMIT, S):
    Philox4x32-10 of counter (site, round, 0, 0) under ``key``'s key of
    BOUNDARY_TAG, words 0 and 1 as uniforms from their top 24 bits, word
    2's top 24 bits times nclassunc over 2**24 as the class."""
    k0, k1 = key.philox_key(BOUNDARY_TAG)
    i64 = torch.int64
    s = torch.arange(sites, dtype=i64, device=device)[None, :] \
        .expand(KMAX_EMIT, sites)
    r = torch.arange(KMAX_EMIT, dtype=i64, device=device)[:, None] \
        .expand(KMAX_EMIT, sites)
    zero = torch.zeros((KMAX_EMIT, sites), dtype=i64, device=device)
    w0, w1, w2, _ = rng.philox4x32_10(s, r, zero, zero, k0, k1)
    scale = 2.0 ** -24
    u1 = (w0 >> 8).to(torch.float32) * scale
    u2 = (w1 >> 8).to(torch.float32) * scale
    ncls = (((w2 >> 8) * nclassunc) >> 24).to(torch.int32)
    return u1, u2, ncls


def _sample(f3d: torch.Tensor, field, klev, col_flat) -> torch.Tensor:
    """f3d[field, klev, col] at each site (flat gather)."""
    _, nz, ny, nx = f3d.shape
    lin = (field.long() * nz + klev.long()) * (ny * nx) + col_flat.long()
    return f3d.reshape(-1)[lin]


def site_emission(bs: BoundaryState, f0, f1, height, w0: float, w1: float,
                  lsynctime: float, mdomainfill: int, ylat0: float,
                  dy: float, u1, u2):
    """The sites' side of a step: the new accumulator (S,), and per round
    and site (KMAX_EMIT, S) the wish to emit, the new particle's x, y, z
    and mass."""
    xpp = bs.limits()[0]
    fidx = torch.where(bs.is_we, F3_U, F3_V).to(torch.int32)
    rho_idx = torch.full_like(fidx, F3_RHO)
    kz1 = bs.kz + 1

    def at_sites(f3d, field):
        lo = _sample(f3d, field, bs.kz, bs.col_flat)
        hi = _sample(f3d, field, kz1, bs.col_flat)
        return bs.wlo * lo + bs.whi * hi

    windx = w0 * at_sites(f0, fidx) + w1 * at_sites(f1, fidx)
    rhox = w0 * at_sites(f0, rho_idx) + w1 * at_sites(f1, rho_idx)
    flux = bs.sgn * windx * rhox * bs.area * float(lsynctime)
    zero = torch.zeros_like(flux)
    acc = torch.where(flux >= 0.0, bs.acc + flux, zero)
    acc = torch.where(bs.valid, acc, zero)
    # the integer emission count (boundcond_domainfill.f90:135-142)
    half = float(np.float32(np.float32(xpp) * np.float32(0.5)))
    mmass = torch.where(acc >= half, torch.floor(true_div(acc + half, xpp)),
                        zero)
    acc = acc - mmass * xpp
    emit = torch.clamp(mmass, max=float(KMAX_EMIT))
    acc = acc + (mmass - emit) * xpp
    rounds = torch.arange(KMAX_EMIT, device=acc.device,
                          dtype=torch.float32)[:, None]
    xnew = bs.x_base + u1 * bs.x_span
    ynew = bs.y_base + u1 * bs.y_span
    znew = bs.z_base + u2 * bs.z_span
    want = bs.valid[None, :] & (emit[None, :] > rounds)
    mass_new = torch.full_like(xnew, xpp)
    if mdomainfill == 2:
        # the stratospheric ozone proxy: PV at the site's column
        nz = height.shape[0]
        kzp = torch.clamp(torch.searchsorted(height, znew.contiguous()),
                          1, nz - 1)
        dz1p = znew - height[kzp - 1]
        dz2p = height[kzp] - znew
        dzi = torch.ones_like(znew) / torch.clamp(dz1p + dz2p, min=1e-6)
        pv_idx = torch.full_like(kzp, F3_PV)
        col = bs.col_flat[None, :].expand_as(kzp)
        pvlo = _sample(f0, pv_idx, kzp - 1, col) * w0 \
            + _sample(f1, pv_idx, kzp - 1, col) * w1
        pvhi = _sample(f0, pv_idx, kzp, col) * w0 \
            + _sample(f1, pv_idx, kzp, col) * w1
        pvpart = (pvlo * dz2p + pvhi * dz1p) * dzi
        lat = ylat0 + ynew * dy
        pvpart = torch.where(lat < 0.0, -pvpart, pvpart)
        want = want & (znew > 3000.0) & (pvpart > PVCRIT)
        mass_new = true_div(true_div(xpp * pvpart * 48.0, 29.0)
                            * OZONESCALE, 1.0e9)
    return acc, want, xnew, ynew, znew, mass_new


def boundcond_plain(p: Particles, bs: BoundaryState, f0, f1, height,
                    itime: int, w0: float, w1: float, key: "rng.Key",
                    lsynctime: float, itsplit: int, ylat0: float, dy: float,
                    mdomainfill: int = 1, ldirect: int = 1,
                    nclassunc: int = 1, check_x: bool = True,
                    origin: torch.Tensor | None = None, draws=None):
    """Plain twin of K14, in place on ``p``.  ``f0``, ``f1``: the two met
    times' f3d; ``draws``: (u1, u2, nclass), each (KMAX_EMIT, S), or None
    (the port's Philox).  Returns (the new accumulator, counts): counts is
    an int32 tensor (killed, free, wanted, granted)."""
    n, dev = p.capacity, p.device
    _, xlo, xhi, ylo, yhi = bs.limits()
    x, y = p.x, p.y
    outside = (y < ylo) | (y > yhi)
    if check_x:
        outside = outside | (x < xlo) | (x > xhi)
    kill = p.active & outside
    p.active.masked_fill_(kill, False)
    p.itra.masked_fill_(kill, ITRA_INACTIVE)
    if draws is None:
        draws = philox_draws(key, bs.sites, nclassunc, dev)
    u1, u2, ncls = draws
    acc, want, xnew, ynew, znew, mass_new = site_emission(
        bs, f0, f1, height, w0, w1, lsynctime, mdomainfill, ylat0, dy, u1,
        u2)
    # the k-th wish in (round, site) order takes the k-th free slot in
    # origin order
    free = (~p.active) & ((p.itra == ITRA_INACTIVE) | (p.itra != p.itramem))
    slots = torch.arange(n, device=dev)
    o = slots if origin is None else origin.long()
    free_o = torch.zeros(n, dtype=torch.bool, device=dev)
    free_o.index_copy_(0, o, free)
    at_origin = torch.empty(n, dtype=torch.long, device=dev)
    at_origin.index_copy_(0, o, slots)
    free_slots = at_origin[free_o]
    wish = want.reshape(-1)
    n_free, n_want = int(free_slots.shape[0]), int(wish.sum())
    granted = min(n_free, n_want)
    pick = torch.nonzero(wish, as_tuple=True)[0][:granted]
    slot = free_slots[:granted]
    iti = int(itime)

    def put(t, v):
        t.index_copy_(0, slot, v.reshape(-1)[pick].to(t.dtype))

    def fill(t, v):
        t.index_fill_(0, slot, v)

    put(p.x_hi, xnew)
    fill(p.x_lo, 0.0)
    put(p.y_hi, ynew)
    fill(p.y_lo, 0.0)
    put(p.z, znew)
    fill(p.itra, iti)
    fill(p.itramem, iti)
    fill(p.itrasplit, iti + ldirect * int(itsplit))
    fill(p.npoint, 0)
    put(p.nclass, ncls)
    fill(p.idt, 0)
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        fill(getattr(p, f), 0.0)
    fill(p.cbt, 1)
    m = mass_new.reshape(-1)[pick][:, None].expand(granted, p.nspec)
    p.mass.index_copy_(0, slot, m.contiguous())
    p.mass0.index_copy_(0, slot, m.contiguous())
    fill(p.active, True)
    counts = torch.tensor([int(kill.sum()), n_free, n_want, granted],
                          dtype=torch.int32, device=dev)
    return acc, counts


def boundcond_cuda(p: Particles, bs: BoundaryState, f0, f1, height,
                   itime: int, w0: float, w1: float, key: "rng.Key",
                   lsynctime: float, itsplit: int, ylat0: float, dy: float,
                   mdomainfill: int = 1, ldirect: int = 1,
                   nclassunc: int = 1, check_x: bool = True,
                   origin: torch.Tensor | None = None, draws=None):
    """K14 launch, in place on ``p``; the counts (killed, free, wanted,
    granted) stay on the card."""
    n, dev = p.capacity, p.device
    s = bs.sites
    if n >= 2 ** 31 - TILE:
        raise ValueError("K14 indexes particles with int32")
    for name in FIELDS:
        t = getattr(p, name)
        if t.device != dev or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"K14: particle field {name} must be contiguous "
                             f"({n}, ...) on {dev}")
    if origin is not None and (origin.device != dev
                               or origin.dtype != torch.int64
                               or tuple(origin.shape) != (n,)
                               or not origin.is_contiguous()):
        raise ValueError(f"K14: origin must be contiguous int64 ({n},) on "
                         f"{dev}")
    for name in BOUNDARY_FIELDS[:15]:
        t = getattr(bs, name)
        if t.device != dev or tuple(t.shape) != (s,) \
                or not t.is_contiguous():
            raise ValueError(f"K14: boundary {name} must be contiguous "
                             f"({s},) on {dev}")
    for t, name in ((f0, "f3d0"), (f1, "f3d1"), (height, "height")):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"K14: {name} must be contiguous float32 on "
                             f"{dev}")
    if draws is not None:
        for t, dt in zip(draws, (torch.float32, torch.float32,
                                 torch.int32)):
            if t.device != dev or t.dtype != dt \
                    or tuple(t.shape) != (KMAX_EMIT, s) \
                    or not t.is_contiguous():
                raise ValueError(f"K14: injected draws must be contiguous "
                                 f"({KMAX_EMIT}, {s}) on {dev}")
    xpp, xlo, xhi, ylo, yhi = bs.limits()
    acc = torch.empty_like(bs.acc)
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    if n == 0:
        return acc.copy_(bs.acc), counts
    tiles = -(-n // TILE)
    wishes = KMAX_EMIT * s
    wtiles = -(-wishes // TILE)
    free_o = torch.zeros(tiles * TILE, dtype=torch.uint8, device=dev)
    want = torch.zeros(wtiles * TILE, dtype=torch.uint8, device=dev)
    ints = torch.empty(n + tiles + wtiles + 2 * wishes, dtype=torch.int32,
                       device=dev)
    cand = torch.empty(4 * wishes, dtype=torch.float32, device=dev)
    fields = (ctypes.c_void_p * len(FIELDS))(
        *(getattr(p, f).data_ptr() for f in FIELDS))
    table = (ctypes.c_void_p * 15)(
        *(getattr(bs, f).data_ptr() for f in BOUNDARY_FIELDS[:15]))
    nz, ny, nx = f0.shape[1:]
    at, step = ints.data_ptr(), ints.element_size()
    cat, cstep = cand.data_ptr(), cand.element_size()
    k0, k1 = key.philox_key(BOUNDARY_TAG)

    def c(v):
        return float(np.float32(v))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _build.DOMAINFILL(
            ctypes.addressof(fields),
            None if origin is None else origin.data_ptr(), n, p.nspec,
            ctypes.addressof(table), s, acc.data_ptr(),
            f0.data_ptr(), f1.data_ptr(), height.data_ptr(), nz, ny, nx,
            c(w0), c(w1), c(lsynctime), c(xpp), c(xlo), c(xhi), c(ylo),
            c(yhi), int(check_x), int(mdomainfill), c(ylat0), c(dy),
            int(itime), int(itime) + int(ldirect) * int(itsplit),
            int(nclassunc), k0, k1,
            *((None, None, None) if draws is None
              else (draws[0].data_ptr(), draws[1].data_ptr(),
                    draws[2].data_ptr())),
            free_o.data_ptr(), at, at + step * n, want.data_ptr(),
            at + step * (n + tiles), at + step * (n + tiles + wtiles),
            at + step * (n + tiles + wtiles + wishes), cat,
            cat + cstep * wishes,
            cat + 2 * cstep * wishes, cat + 3 * cstep * wishes,
            counts.data_ptr(), sms, stream)
    return acc, counts


def boundcond(p: Particles, bs: BoundaryState, f0, f1, height, itime: int,
              w0: float, w1: float, key: "rng.Key", lsynctime: float,
              itsplit: int, ylat0: float, dy: float, mdomainfill: int = 1,
              ldirect: int = 1, nclassunc: int = 1, check_x: bool = True,
              origin: torch.Tensor | None = None, draws=None):
    """One boundary-condition step (boundcond_domainfill.f90), in place on
    the particles: K14 on CUDA, the plain twin on the CPU.  Returns (the
    new accumulator, counts (killed, free, wanted, granted))."""
    run = {"cuda": boundcond_cuda,
           "cpu": boundcond_plain}.get(p.device.type)
    if run is None:
        raise ValueError(f"no boundary backend for device {p.device}")
    return run(p, bs, f0, f1, height, itime, w0, w1, key, lsynctime,
               itsplit, ylat0, dy, mdomainfill, ldirect, nclassunc, check_x,
               origin, draws)

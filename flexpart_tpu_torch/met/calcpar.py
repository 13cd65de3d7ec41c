"""Boundary-layer parameters over the whole grid.

Port of ``flexpart_tpu/met/calcpar.py`` for hybrid-eta met, with or
without subgrid orography (``pressure_levels`` raises, as does a
dry-deposition ``vdep_kernel``).  Every column runs the same fixed-shape
masked computation; "first True" searches are ``argmax`` over an int
cast, which returns the first maximal index as ``jnp.argmax`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CPA, GA, HMIXMAX, HMIXMIN, KARMAN, R_AIR, CONVKE
from .fields import (ZFields, F2_HMIX, F2_TROPO, F2_USTAR, F2_WSTAR, F2_OLI)
from .grid import MetGrid
from .thermo import ew

CONST = R_AIR / GA
RIC = 0.25
B_COEF = 100.0
BS_COEF = 8.5
ITMAX = 3


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 0 (0 where none is True)."""
    return torch.argmax(mask.to(torch.int32), dim=0)


def _take0(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f[idx[j, i], j, i] for a (L, ny, nx) f and a (ny, nx) idx."""
    return torch.gather(f, 0, idx[None])[0]


def ustar_from_stress(ps, tt2, td2, stress):
    """scalev.f90: u* = sqrt(|stress| / rho)."""
    tv = tt2 * (1.0 + 0.378 * ew(td2) / ps)
    rhoa = ps / (R_AIR * tv)
    ust = torch.sqrt(torch.abs(stress) / rhoa)
    return torch.clamp(ust, min=1.0e-8)


def obukhov_length(ps, tt2, td2, tlev, ustar, hf, plev1):
    """obukhov.f90: Obukhov length from surface data + sensible heat flux."""
    e = ew(td2)
    tv = tt2 * (1.0 + 0.378 * e / ps)
    rhoa = ps / (R_AIR * tv)
    theta = tlev * torch.pow(100000.0 / plev1, R_AIR / CPA)
    thetastar = hf / (rhoa * CPA * torch.clamp(ustar, min=1.0e-8))
    ol = torch.where(torch.abs(thetastar) > 1.0e-10,
                     theta * ustar ** 2 / (KARMAN * GA * thetastar),
                     torch.full_like(theta, 9999.0))
    return torch.clamp(ol, -9999.0, 9999.0)


def _col_heights_theta(akz, bkz, ps, tt2, td2, tth, qvh, z0: float):
    """Per-level z (from reference height z0) and virtual potential
    temperature, whole grid: (z, theta, pint), each (nlev, ny, nx)."""
    pint = akz[:, None, None] + bkz[:, None, None] * ps[None]
    tv = tth * (1.0 + 0.608 * qvh)
    tv0 = tt2 * (1.0 + 0.378 * ew(td2) / ps)
    tv = torch.cat([tv0[None], tv[1:]], dim=0)
    dz_grad = CONST * torch.log(pint[:-1] / pint[1:]) * (tv[1:] - tv[:-1]) \
        / torch.log(tv[1:] / tv[:-1])
    dz_iso = CONST * torch.log(pint[:-1] / pint[1:]) * tv[1:]
    dz = torch.where(torch.abs(tv[1:] - tv[:-1]) > 0.2, dz_grad, dz_iso)
    z = torch.cat([torch.full_like(ps, z0)[None],
                   z0 + torch.cumsum(dz, dim=0)], dim=0)
    theta = tv * torch.pow(100000.0 / pint, R_AIR / CPA)
    return z, theta, pint


def richardson_hmix(akz, bkz, ps, ustar, tth, qvh, uuh, vvh, sshf, tt2, td2):
    """richardson.f90: mixing height by bulk Richardson number with the
    excess-temperature iteration; also w* and hmixplus.
    Returns (hmix, wstar, hmixplus), each (ny, nx)."""
    nlev = akz.shape[0]
    dev = ps.device
    frac = (torch.arange(1, 21, dtype=torch.int32, device=dev) / 20.0
            ).to(torch.float32)[:, None, None]

    def one_pass(excess):
        z, theta, _ = _col_heights_theta(akz, bkz, ps, tt2, td2, tth, qvh, 2.0)
        thetaref = theta[0] + excess
        zref = 2.0
        du = uuh - uuh[1][None]
        dv = vvh - vvh[1][None]
        denom = torch.clamp(du ** 2 + dv ** 2 + B_COEF * ustar[None] ** 2,
                            min=0.1)
        ri = GA / thetaref[None] * (theta - thetaref[None]) * (z - zref) / denom

        # first level (k >= 1) with Ri > RIC and theta increasing
        theta_prev = torch.cat([theta[0:1], theta[:-1]], dim=0)
        crossed = (ri > RIC) & (theta_prev < theta)
        crossed[0] = False
        any_cross = torch.any(crossed, dim=0)
        k = torch.where(any_cross, _first_true(crossed),
                        torch.full_like(ps, nlev - 1, dtype=torch.int64))
        k = torch.clamp(k, 1, nlev - 1)

        z_lo, z_hi = _take0(z, k - 1), _take0(z, k)
        th_lo, th_hi = _take0(theta, k - 1), _take0(theta, k)
        u_lo, u_hi = _take0(uuh, k - 1), _take0(uuh, k)
        v_lo, v_hi = _take0(vvh, k - 1), _take0(vvh, k)

        # 20-point refinement between the critical levels
        # (richardson.f90:152-168)
        zl = z_lo[None] + frac * (z_hi - z_lo)[None]
        ul = u_lo[None] + frac * (u_hi - u_lo)[None]
        vl = v_lo[None] + frac * (v_hi - v_lo)[None]
        thl = th_lo[None] + frac * (th_hi - th_lo)[None]
        den = torch.clamp((ul - uuh[1][None]) ** 2 + (vl - vvh[1][None]) ** 2
                          + B_COEF * ustar[None] ** 2, min=0.1)
        ril = GA / thetaref[None] * (thl - thetaref[None]) * (zl - zref) / den
        over = ril > RIC
        any_over = torch.any(over, dim=0)
        i = torch.where(any_over, _first_true(over),
                        torch.full_like(ps, 19, dtype=torch.int64))

        h = _take0(zl, i)
        zl2, th2 = h, _take0(thl, i)
        im1 = torch.clamp(i - 1, min=0)
        zl1 = torch.where(i > 0, _take0(zl, im1), z_lo)
        th1 = torch.where(i > 0, _take0(thl, im1), th_lo)

        thetam = 0.5 * (th1 + th2)
        ul_i, vl_i = _take0(ul, i), _take0(vl, i)
        wspeed = torch.sqrt(ul_i ** 2 + vl_i ** 2)
        bvfsq = (GA / thetam) * (th2 - th1) / torch.clamp(zl2 - zl1, min=1e-3)
        hmixplus = torch.where(
            bvfsq <= 0.0, torch.full_like(bvfsq, 9999.0),
            wspeed / torch.sqrt(torch.clamp(bvfsq, min=1e-12)) * CONVKE)

        zero = torch.zeros_like(h)
        wst = torch.where(sshf < 0.0,
                          torch.pow(-h * GA / thetaref * sshf / CPA, 1.0 / 3.0),
                          zero)
        new_excess = torch.where(
            sshf < 0.0, -BS_COEF * sshf / CPA / torch.clamp(wst, min=1e-8),
            zero)
        return h, wst, hmixplus, new_excess

    excess = torch.zeros_like(ps)
    h = wst = hplus = None
    for _ in range(ITMAX):
        h, wst, hplus, excess = one_pass(excess)
    return h, wst, hplus


def tropopause_height(akz, bkz, ps, tt2, td2, tth, qvh, lats):
    """Hoinka thermal tropopause (calcpar.f90:194-266), whole grid."""
    nlev = akz.shape[0]
    z, _, _ = _col_heights_theta(akz, bkz, ps, tt2, td2, tth, qvh, 0.0)

    alat = torch.abs(lats)
    altmin = torch.where(
        alat <= 20.0, torch.full_like(alat, 5000.0),
        torch.where(alat < 40.0, 2500.0 + (40.0 - alat) * 125.0,
                    torch.full_like(alat, 2500.0)))[None, :, None]

    ny, nx = ps.shape
    cols = z.reshape(nlev, -1).T.contiguous()          # (ncol, nlev)
    # lz = first level with z(lz) - z(kz) > 2000 (side="right")
    lz = torch.searchsorted(cols, cols + 2000.0, right=True)
    lz = torch.clamp(lz.T.reshape(nlev, ny, nx), 0, nlev - 1)
    t_lz = torch.gather(tth, 0, lz)
    z_lz = torch.gather(z, 0, lz)
    lapse = (tth - t_lz) / torch.clamp(z_lz - z, min=1.0)
    ok = (lapse < 0.002) & (z >= altmin) & (z_lz - z > 2000.0)
    anyok = torch.any(ok, dim=0)
    kz = torch.where(anyok, _first_true(ok),
                     torch.full_like(ps, nlev - 1, dtype=torch.int64))
    return _take0(z, kz)


def calcpar(grid: MetGrid, eta, z: ZFields, lsubgrid: bool = False,
            vdep_kernel=None) -> ZFields:
    """Fill the calcpar surface fields (ustar, 1/L, hmix, w*, tropopause)
    of a processed ZFields; runs on the device of ``eta``."""
    if vdep_kernel is not None:
        raise NotImplementedError("dry-deposition velocities are not ported yet")
    if grid.pressure_levels:
        raise NotImplementedError(
            "pressure-level (GFS) met is not ported yet; hybrid eta only")
    dev = eta.ps.device
    akz = torch.as_tensor(np.asarray(grid.akz, np.float32), device=dev)
    bkz = torch.as_tensor(np.asarray(grid.bkz, np.float32), device=dev)
    lats = torch.as_tensor(np.asarray(grid.lats, np.float32), device=dev)

    ustar = ustar_from_stress(eta.ps, eta.tt2, eta.td2, eta.surfstr)
    plev1 = 0.5 * (akz[1] + akz[2]) + 0.5 * (bkz[1] + bkz[2]) * eta.ps
    tlev = eta.tth[1]
    ol = obukhov_length(eta.ps, eta.tt2, eta.td2, tlev, ustar, eta.sshf, plev1)
    oli = torch.where(ol != 0.0, 1.0 / ol, torch.full_like(ol, 99999.0))

    hmix, wstar, hmixplus = richardson_hmix(akz, bkz, eta.ps, ustar, eta.tth,
                                            eta.qvh, eta.uuh, eta.vvh, eta.sshf,
                                            eta.tt2, eta.td2)
    if lsubgrid:
        # subgrid orography lifts the mixing height by the excess
        # orography, at most by what the kinetic energy allows
        # (richardson.f90's hmixplus)
        hmix = hmix + torch.minimum(eta.excessoro, hmixplus)
    hmix = torch.clamp(hmix, HMIXMIN, HMIXMAX)
    tropo = tropopause_height(akz, bkz, eta.ps, eta.tt2, eta.td2, eta.tth,
                              eta.qvh, lats)
    f2d = z.f2d.clone()
    f2d[F2_USTAR] = ustar
    f2d[F2_OLI] = oli
    f2d[F2_HMIX] = hmix
    f2d[F2_WSTAR] = wstar
    f2d[F2_TROPO] = tropo
    return z.replace(f2d=f2d)

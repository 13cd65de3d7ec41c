"""Vertical transform: hybrid-eta fields -> fixed-height-grid fields.

Port of ``flexpart_tpu/met/verttransform.py``: hybrid eta (ECMWF) and
isobaric levels (``grid.pressure_levels``, GFS: levels below the terrain
collapse onto the ground, verttransform_gfs.f90:146-182), with either
cloud classification (the column cloud water of readclouds with
``use_clwc``, verttransform_ecmwf.f90:606-675, or the rh>80% fallback,
:681-724).  Whole-grid cumulative integrations and a batched
``torch.searchsorted`` replace the reference's column loops, as in the
JAX version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import R_AIR
from .fields import (EtaFields, ZFields, F3_U, F3_V, F3_W, F3_RHO, F3_DRHODZ,
                     F3_TT, F3_QV, F3_PV, F3_CLW, NF3,
                     F2_PS, F2_LSPREC, F2_CONVPREC, F2_TCC, F2_TT2, F2_TD2,
                     F2_SD, F2_ORO, F2_EXCESSORO, F2_LSM, F2_CLOUDSH, F2_CTWC,
                     F2_SSR, F2_SSHF, NF2)
from .grid import MetGrid
from .thermo import ew, f_qvsat

GA = 9.81
CONST = R_AIR / GA


def _layer_thickness(pold, pint, tvold, tv):
    """Hypsometric layer thickness, two-branch form
    (verttransform_ecmwf.f90:231-236)."""
    dz_grad = CONST * torch.log(pold / pint) * (tv - tvold) / torch.log(tv / tvold)
    dz_iso = CONST * torch.log(pold / pint) * tv
    return torch.where(torch.abs(tv - tvold) > 0.2, dz_grad, dz_iso)


def eta_level_heights(akz, bkz, ps, tt2, td2, tth, qvh,
                      pressure_levels: bool = False):
    """Heights of eta full levels above ground per column, density and
    pressure: (uvzlev, rhoh, pint), each (nlev, ny, nx); level 0 = ground
    (verttransform_ecmwf.f90:207-240).

    With ``pressure_levels`` (GFS), levels can lie below the terrain
    where ps < akz: the reference starts the integration at the first
    level above ground ``llev`` (verttransform_gfs.f90:146-182).  Here, as
    in the JAX version, layer thicknesses whose lower level is below
    ground are zeroed, so all below-ground levels collapse onto height
    zero; they then get tiny negative offsets so that the
    z-interpolation's search lands on the llev value at the ground."""
    pint = akz[:, None, None] + bkz[:, None, None] * ps[None]
    tv = tth * (1.0 + 0.608 * qvh)
    if not pressure_levels:
        tv0 = tt2 * (1.0 + 0.378 * ew(td2) / ps)
        tv = torch.cat([tv0[None], tv[1:]], dim=0)
    rhoh = pint / (R_AIR * tv)
    dz = _layer_thickness(pint[:-1], pint[1:], tv[:-1], tv[1:])
    if pressure_levels:
        below_lower = pint[:-1] >= ps[None]      # lower level below ground
        dz = torch.where(below_lower, 0.0, dz)
    uvzlev = torch.cat([torch.zeros_like(ps)[None], torch.cumsum(dz, dim=0)],
                       dim=0)
    if pressure_levels:
        below = pint >= ps[None]
        nlev = akz.shape[0]
        k = torch.arange(nlev, dtype=torch.int32, device=ps.device
                         ).to(uvzlev.dtype)[:, None, None]
        n_below = below.sum(dim=0)[None].to(uvzlev.dtype)
        uvzlev = torch.where(below, -1e-3 * (n_below - k), uvzlev)
    return uvzlev, rhoh, pint


def compute_heights(grid: MetGrid, eta: EtaFields) -> np.ndarray:
    """Fixed z-grid from a reference column with ps > 1000 hPa
    (verttransform_ecmwf.f90:134-170).  Host-side float64, once per run."""
    ps = eta.ps.cpu().numpy()
    flat = np.argwhere(ps.ravel() > 100000.0)
    idx = int(flat[0, 0]) if flat.size else int(np.argmax(ps))
    jy, ix = np.unravel_index(idx, ps.shape)
    akz, bkz = grid.akz, grid.bkz
    tth = eta.tth[:, jy, ix].cpu().numpy()
    qvh = eta.qvh[:, jy, ix].cpu().numpy()
    psc = float(ps[jy, ix])
    td2c = eta.td2[jy, ix].cpu()
    tvold = float(eta.tt2[jy, ix]) * (1.0 + 0.378 * float(ew(td2c)) / psc)
    pold = psc
    height = np.zeros(grid.nlev)
    for kz in range(1, grid.nlev):
        pint = akz[kz] + bkz[kz] * psc
        tv = tth[kz] * (1.0 + 0.608 * qvh[kz])
        if abs(tv - tvold) > 0.2:
            dz = CONST * np.log(pold / pint) * (tv - tvold) / np.log(tv / tvold)
        else:
            dz = CONST * np.log(pold / pint) * tv
        height[kz] = height[kz - 1] + dz
        tvold, pold = tv, pint
    return height


def _interp_to_height(prof_lev, height, fields_lev):
    """Interpolate column profiles from per-column levels to the fixed
    height grid.  prof_lev: (nlev, ncol) monotone level heights;
    fields_lev: (..., nlev, ncol); height: (nz,).  Returns (..., nz, ncol).
    The per-column search is ``side="left"``, i.e. ``right=False``."""
    nlev, ncol = prof_lev.shape
    nz = height.shape[0]
    cols = prof_lev.T.contiguous()                        # (ncol, nlev)
    hq = height[None, :].expand(ncol, nz).contiguous()
    idx = torch.searchsorted(cols, hq, right=False)       # (ncol, nz)
    kz = torch.clamp(idx.T, 1, nlev - 1)                  # (nz, ncol)
    below = torch.gather(prof_lev, 0, kz - 1)
    above = torch.gather(prof_lev, 0, kz)
    w = (height[:, None] - below) / torch.clamp(above - below, min=1e-6)
    w = torch.clamp(w, 0.0, 1.0)
    lead = fields_lev.shape[:-2]
    f_below = torch.gather(fields_lev, -2, (kz - 1).expand(lead + kz.shape))
    f_above = torch.gather(fields_lev, -2, kz.expand(lead + kz.shape))
    out = f_below * (1.0 - w) + f_above * w
    # above the top eta level: hold the top value (verttransform_ecmwf.f90:302-316)
    top = prof_lev[-1][None, :]
    return torch.where(height[:, None] > top, fields_lev[..., -1:, :], out)


def process_eta(grid: MetGrid, eta: EtaFields, height,
                pvh=None, use_clwc: bool = False) -> ZFields:
    """Full met preprocessing for one wind-field time: verttransform plus
    the cloud classification (readclouds with ``use_clwc``, else rh>80%).
    calcpar fields are added by ``met.calcpar.calcpar``.  Runs on the
    device of ``eta``."""
    pressure_levels = grid.pressure_levels
    dev = eta.ps.device
    f32 = torch.float32
    if pvh is None:
        pvh = torch.zeros_like(eta.tth)
    height = torch.as_tensor(np.asarray(height, np.float32), device=dev)
    akz = torch.as_tensor(np.asarray(grid.akz, np.float32), device=dev)
    bkz = torch.as_tensor(np.asarray(grid.bkz, np.float32), device=dev)
    dxconst = float(np.float32(grid.dxconst))
    dyconst = float(np.float32(grid.dyconst))
    dy = float(np.float32(grid.dy))
    ylat0 = float(np.float32(grid.ylat0))

    nlev = akz.shape[0]
    ny, nx = eta.ps.shape
    nz = nlev
    ncol = ny * nx

    uvzlev, rhoh, _ = eta_level_heights(akz, bkz, eta.ps, eta.tt2, eta.td2,
                                        eta.tth, eta.qvh,
                                        pressure_levels=pressure_levels)

    # --- u, v, t, qv, pv, rho (and clwc) to the fixed height grid ---
    prof = uvzlev.reshape(nlev, ncol)
    stack = torch.stack([eta.uuh, eta.vvh, eta.tth, eta.qvh, pvh, rhoh,
                         eta.clwch], dim=0).reshape(7, nlev, ncol)
    zstack = _interp_to_height(prof, height, stack).reshape(7, nz, ny, nx)
    uu, vv, tt, qv, pv, rho, clwc = (zstack[i] for i in range(7))

    # --- vertical wind: Pa/s -> m/s via pinmconv
    # (verttransform_ecmwf.f90:243-261,361-387) ---
    pfull = akz[:, None, None] + bkz[:, None, None] * eta.ps[None]
    if pressure_levels:
        # GFS: omega lives on the same pressure levels as u, v
        # (verttransform_gfs.f90:160-186,270-286); below-ground levels are
        # collapsed, and dz/dp at the first above-ground level is anchored
        # at the surface (z = 0, p = ps), the exact hydrostatic gradient
        wzlev = uvzlev
        zeff = torch.clamp(uvzlev, min=0.0)
        peff = torch.minimum(pfull, eta.ps[None])

        def _dzdp(dz_, dp_):
            # fully-below-ground spans clamp to dp = 0; their pinmconv is
            # never used (those levels collapse onto z <= 0): keep it finite
            return dz_ / torch.where(torch.abs(dp_) < 0.5, -0.5, dp_)

        pinmconv = torch.cat([
            _dzdp(zeff[1] - zeff[0], peff[1] - peff[0])[None],
            _dzdp(zeff[2:] - zeff[:-2], peff[2:] - peff[:-2]),
            _dzdp(zeff[-1] - zeff[-2], peff[-1] - peff[-2])[None],
        ], dim=0)
    else:
        wzlev = torch.cat([
            torch.zeros((1, ny, nx), dtype=f32, device=dev),
            0.5 * (uvzlev[2:] + uvzlev[1:-1]),
            (0.5 * (uvzlev[-1] + uvzlev[-2]) + uvzlev[-1] - uvzlev[-2])[None],
        ], dim=0)
        pinmconv = torch.cat([
            (uvzlev[1] / (pfull[1] - pfull[0]))[None],
            (uvzlev[2:] - uvzlev[:-2]) / (pfull[2:] - pfull[:-2]),
            ((uvzlev[-1] - uvzlev[-2]) / (pfull[-1] - pfull[-2]))[None],
        ], dim=0)
    gw = (eta.wwh * pinmconv).reshape(nlev, ncol)
    ww = _interp_to_height(wzlev.reshape(nlev, ncol), height, gw
                           ).reshape(nz, ny, nx).clone()
    if not pressure_levels:
        ww[0] = eta.wwh[0] * pinmconv[0]
        ww[-1] = eta.wwh[-1] * pinmconv[-1]

    # --- density gradient (verttransform_ecmwf.f90:392-398) ---
    dh = height[1:] - height[:-1]
    drhodz = torch.cat([
        ((rho[1] - rho[0]) / dh[0])[None],
        (rho[2:] - rho[:-2]) / (height[2:, None, None] - height[:-2, None, None]),
    ], dim=0)
    drhodz = torch.cat([drhodz, drhodz[-1:]], dim=0)

    # --- eta-slope correction of w (verttransform_ecmwf.f90:404-453) ---
    uvz_z = _interp_to_height(prof, height, uvzlev.reshape(nlev, ncol)
                              ).reshape(nz, ny, nx)
    if grid.xglobal:
        dzdx = (torch.roll(uvz_z, -1, dims=2) - torch.roll(uvz_z, 1, dims=2)) / 2.0
    else:
        dzdx = torch.zeros_like(uvz_z)
        dzdx[:, :, 1:-1] = (uvz_z[:, :, 2:] - uvz_z[:, :, :-2]) / 2.0
    dzdy = torch.zeros_like(uvz_z)
    dzdy[:, 1:-1, :] = (uvz_z[:, 2:, :] - uvz_z[:, :-2, :]) / 2.0
    lat = ylat0 + torch.arange(ny, dtype=torch.int32, device=dev) * dy
    cosf = 1.0 / torch.cos(lat * math.pi / 180.0)
    cosf = torch.clamp(cosf, -100.0, 100.0)
    corr = dzdx * uu * dxconst * cosf[None, :, None] + dzdy * vv * dyconst
    inner = torch.zeros((nz, ny, nx), dtype=torch.bool, device=dev)
    if grid.xglobal:
        inner[1:-1, 1:-1, :] = True
    else:
        inner[1:-1, 1:-1, 1:-1] = True
    ww = torch.where(inner, ww + corr, ww)

    # --- cloud classification for wet scavenging ---
    lsp = eta.lsprec
    convp = eta.convprec
    precip = (lsp > 0.01) | (convp > 0.01)
    lsp_dom = lsp >= convp
    dh_full = torch.cat([dh[0:1], dh])[:, None, None]
    i32 = torch.int32

    def const(v):
        return torch.tensor(v, dtype=i32, device=dev)

    if use_clwc:
        # readclouds path (verttransform_ecmwf.f90:616-675): the cloud
        # water of each layer, its column sum ctwc, in cloud where a layer
        # holds water, below cloud under the lowest such layer
        dh_up = torch.cat([dh, dh[-1:]])[:, None, None]
        clw = torch.where(clwc > 0, clwc * rho * dh_up, 0.0)
        clw[-1] = 0.0
        ctwc = torch.sum(clw, dim=0)
        incloud = clw > 0.0
        hz = height[:, None, None]
        cloudh_min = torch.amin(torch.where(incloud, hz, 1.0e30), dim=0)
        below = (~incloud) & (cloudh_min[None] >= hz)
        cl = torch.where(
            incloud, torch.where(lsp_dom[None], const(3), const(2)),
            torch.where(below, torch.where(lsp_dom[None], const(5), const(4)),
                        const(0)))
        cl = torch.where(precip[None], cl, const(0))
        cl = torch.where(hz >= 19000.0, const(0), cl)
        cl[0] = 0
        cloudsh = torch.sum(torch.where((cl == 2) | (cl == 3), dh_full, 0.0),
                            dim=0)
    else:
        # rh>80% fallback (verttransform_ecmwf.f90:686-723)
        pressure = rho * R_AIR * tt
        rh = qv / f_qvsat(pressure, tt)
        incloud = rh > 0.8
        prec_cloud = incloud & precip[None]
        pc = prec_cloud.to(torch.int32)
        above_ct = torch.flip(torch.cumsum(torch.flip(pc, [0]), dim=0), [0])
        rain_above = (above_ct - pc) > 0
        cl = torch.where(
            incloud,
            torch.where(precip[None],
                        torch.where(lsp_dom[None], const(3), const(2)),
                        const(1)),
            torch.where(rain_above,
                        torch.where(lsp_dom[None], const(5), const(4)),
                        const(0)))
        cl[0] = 0
        cloudsh = torch.sum(torch.where(prec_cloud, dh_full, 0.0), dim=0)
        ctwc = torch.zeros_like(eta.ps)
        clw = torch.zeros_like(rho)

    f3 = [None] * NF3
    f3[F3_U], f3[F3_V], f3[F3_W] = uu, vv, ww
    f3[F3_RHO], f3[F3_DRHODZ] = rho, drhodz
    f3[F3_TT], f3[F3_QV], f3[F3_PV], f3[F3_CLW] = tt, qv, pv, clw
    f3d = torch.stack(f3, dim=0)

    zeros2 = torch.zeros_like(eta.ps)
    f2 = [zeros2] * NF2
    f2[F2_PS], f2[F2_LSPREC], f2[F2_CONVPREC] = eta.ps, lsp, convp
    f2[F2_TCC], f2[F2_TT2], f2[F2_TD2] = eta.tcc, eta.tt2, eta.td2
    f2[F2_SD], f2[F2_ORO], f2[F2_EXCESSORO] = eta.sd, eta.oro, eta.excessoro
    f2[F2_LSM], f2[F2_CLOUDSH], f2[F2_CTWC] = eta.lsm, cloudsh, ctwc
    f2[F2_SSR], f2[F2_SSHF] = eta.ssr, eta.sshf
    f2d = torch.stack(f2, dim=0)

    vdep = torch.zeros((1, ny, nx), dtype=f32, device=dev)
    return ZFields(f3d=f3d, f2d=f2d, clouds=cl.to(torch.int8), vdep=vdep,
                   height=height)

"""Dry-deposition velocity field: the Wesely resistance chain.

Port of ``flexpart_tpu/physics/drydepo.py`` (getvdep.f90, getrb.f90,
getrc.f90, raerod.f90, psih.f90 and partdep.f90 of the reference), computed
for the whole grid at once per wind field, in plain PyTorch on the device
of the fields: it runs once per met read, like ``calcpv``, not per step.

The static per-run data (landuse fractions, resistance tables, species
constants) is ``DrydepTables`` (numpy, built by ``build_drydep_tables``, a
copy of the JAX function); ``make_vdep_kernel`` binds it and returns the
per-field function that ``met.calcpar.calcpar`` calls.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..constants import GA, HREF, KARMAN, NI
from .landuse import NUMCLASS, WeselyTables, seasonal_category, \
    species_gas_tables

PR = 0.72   # Prandtl number (getrb.f90)
EPS = 1e-5


def _sdiv(a: float, b: torch.Tensor) -> torch.Tensor:
    """a / b rounded once (torch's ``scalar / tensor`` rounds twice)."""
    return torch.full_like(b, a) / b


def _psih(z, l):
    """Similarity stability correction for heat (psih.f90)."""
    l = torch.where((l >= 0) & (l < 1e-20), torch.full_like(l, 1e-20), l)
    l = torch.where((l < 0) & (l > -1e-20), torch.full_like(l, -1e-20), l)
    zeta = z / l
    a, b, c, d = 1.0, 0.667, 5.0, 0.35
    stable = -((1.0 + 0.667 * a * zeta) ** 1.5) \
        - b * (zeta - c / d) * torch.exp(-d * zeta) - b * c / d + 1.0
    x = torch.clamp(1.0 - 16.0 * zeta, min=1e-30) ** 0.25
    unstable = 2.0 * torch.log((1.0 + x * x) / 2.0)
    out = torch.where(zeta > 0.0, stable, unstable)
    return torch.where(torch.log10(z) - torch.log10(torch.abs(l)) < -20.0,
                       torch.zeros_like(out), out)


def _raerod(l, ust, z0):
    """Aerodynamic resistance ground->href (raerod.f90)."""
    href = torch.full_like(l, HREF)
    return (torch.log(_sdiv(HREF, z0)) - _psih(href, l)
            + _psih(z0, l)) / (KARMAN * ust)


@dataclasses.dataclass(frozen=True)
class DrydepTables:
    """Static per-run dry-deposition data (numpy)."""
    xlanduse: np.ndarray          # (ny, nx, 13) fractional cover
    z0: np.ndarray                # (13,) roughness length
    season: np.ndarray            # (ny,) Wesely seasonal category 1..5
    # gas species data, one row per species (zeros when not a dep gas)
    gas_mask: np.ndarray          # (nspec,) bool
    reldiff: np.ndarray           # (nspec,)
    henry: np.ndarray
    f0: np.ndarray
    rm: np.ndarray
    ri: np.ndarray                # (ny, 13) season-resolved
    rlu: np.ndarray               # (nspec, ny, 13)
    rgs: np.ndarray
    rcl: np.ndarray
    rac: np.ndarray               # (ny, 13)
    # aerosol species data
    aero_mask: np.ndarray         # (nspec,) bool
    fract: np.ndarray             # (nspec, NI)
    schmi: np.ndarray
    vset: np.ndarray
    # constant-velocity fallback
    dryvel: np.ndarray            # (nspec,) <0 when unused


def build_drydep_tables(species: Sequence, xlanduse: np.ndarray,
                        z0: np.ndarray, tables: WeselyTables,
                        mmdd: int, ylat0: float, dy: float,
                        ny: int) -> DrydepTables:
    """The static tables of one run (``drydepo.py:77-118`` there)."""
    ylat = ylat0 + dy * np.arange(ny)
    season = seasonal_category(mmdd, ylat)       # (ny,) 1..5
    si = season - 1
    nspec = len(species)
    gas_mask = np.array([s.reldiff > 0 for s in species])
    aero_mask = np.array([s.density > 0 and s.dquer > 0 for s in species])
    reldiff = np.array([max(s.reldiff, 0.0) for s in species])
    henry = np.array([s.henry for s in species])
    f0 = np.array([max(s.f0, 0.0) for s in species])

    rlu = np.zeros((nspec, ny, NUMCLASS))
    rgs = np.zeros((nspec, ny, NUMCLASS))
    rcl = np.zeros((nspec, ny, NUMCLASS))
    rm = np.zeros(nspec)
    for i, s in enumerate(species):
        if gas_mask[i]:
            rlu_t, rgs_t, rcl_t, rm_i = species_gas_tables(
                tables, s.henry, f0[i])
            rlu[i] = rlu_t[si]
            rgs[i] = rgs_t[si]
            rcl[i] = rcl_t[si]
            rm[i] = rm_i
    fract = np.zeros((nspec, NI))
    schmi = np.zeros((nspec, NI))
    vset = np.zeros((nspec, NI))
    for i, s in enumerate(species):
        sc = s.size_classes()
        if sc is not None:
            fract[i] = sc.fract
            schmi[i] = sc.schmi
            vset[i] = sc.vset
    return DrydepTables(
        xlanduse=xlanduse, z0=z0, season=season,
        gas_mask=gas_mask, reldiff=reldiff, henry=henry, f0=f0, rm=rm,
        ri=tables.ri[si], rlu=rlu, rgs=rgs, rcl=rcl, rac=tables.rac[si],
        aero_mask=aero_mask, fract=fract, schmi=schmi, vset=vset,
        dryvel=np.array([s.dryvel for s in species]))


def make_vdep_kernel(td: DrydepTables):
    """(ust, tt2, rh, ps, oli, ssr, precip, sd) -> vdep (nspec, ny, nx) on
    the device of the fields (``drydepo.py:121-228`` there).  rh = the
    vapour pressure ratio ew(td2)/ew(tt2), computed by the caller
    (calcpar.f90:172-175)."""
    nspec = td.gas_mask.shape[0]
    on_device: dict = {}

    def tables(dev):
        if dev not in on_device:
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)
            on_device[dev] = dict(
                xlanduse=t(td.xlanduse), z0=t(td.z0), ri=t(td.ri),
                rac=t(td.rac), rlu=t(td.rlu), rgs=t(td.rgs), rcl=t(td.rcl),
                vset=t(td.vset), schmi=t(td.schmi), fract=t(td.fract))
        return on_device[dev]

    def vdep_field(ust, tt2, rh, ps, oli, ssr, precip, sd):
        tb = tables(ust.device)
        xlanduse, ri_s, rac_s = tb["xlanduse"], tb["ri"], tb["rac"]
        ny, nx = ust.shape
        L = _sdiv(1.0, torch.where(torch.abs(oli) < 1e-30,
                                   torch.full_like(oli, 1e-30), oli))
        ust = torch.clamp(ust, min=1e-8)

        # water-vapour diffusivity + viscosity (getvdep.f90:88-105)
        diffh2o = 2.11e-5 * (tt2 / 273.15) ** 1.94 * _sdiv(101325.0, ps)
        tc = tt2 - 273.15
        myl = torch.where(
            tc < 0, (1.718 + 0.0049 * tc - 1.2e-5 * tc * tc) * 1e-5,
            (1.718 + 0.0049 * tc) * 1e-5)
        rhoa = ps / (287.0 * tt2)
        nyl = myl / rhoa

        # snow switches all cover to class 12 (getvdep.f90:115-126)
        snowy = sd > 0.001
        snow_cover = torch.zeros(NUMCLASS, dtype=torch.float32,
                                 device=ust.device)
        snow_cover[11] = 1.0
        slanduse = torch.where(snowy[..., None], snow_cover, xlanduse)

        # dynamic water roughness (calcpar.f90:170-172)
        z0 = tb["z0"].expand(ny, nx, NUMCLASS).clone()
        z0[..., 6] = 0.016 * ust * ust / GA

        # Wesely stomatal pieces shared across species (getrc.f90:47-66)
        gr = ssr
        t_ok = (tc > 0.0) & (tc < 40.0)
        rs_base = torch.where(
            t_ok[..., None],
            ri_s[:, None, :] * (1.0 + _sdiv(200.0, gr[..., None] + 0.1) ** 2)
            * _sdiv(400.0, torch.clamp(tc[..., None] * (40.0 - tc[..., None]),
                                       min=1e-10)),
            torch.full_like(slanduse, 1.0e25))
        wet = (rh > 0.9) | (precip > 0.0)
        rs_base = torch.where(wet[..., None], rs_base * 3.0, rs_base)
        rdc = 100.0 * (1.0 + _sdiv(1000.0, gr + 10.0))
        corr = 1000.0 * torch.exp(-tc - 4.0)

        # aerodynamic resistance per class (raerod.f90), and its
        # cover-weighted mean for partdep
        ra = _raerod(L[..., None].expand_as(z0), ust[..., None].expand_as(z0),
                     z0)                                   # (ny, nx, 13)
        active = slanduse > EPS
        zero = torch.zeros_like(ra)
        raquer = torch.sum(torch.where(active, ra * slanduse, zero), dim=-1)

        vdep = []
        for i in range(nspec):
            v = torch.zeros((ny, nx), dtype=torch.float32, device=ust.device)
            if td.gas_mask[i]:
                reldiff = float(td.reldiff[i])
                henry = float(td.henry[i])
                f0 = float(td.f0[i])
                # rb (getrb.f90)
                schmidt = nyl / diffh2o * reldiff
                rb = _sdiv(2.0, KARMAN * ust) * (schmidt / PR) ** 0.67
                # rc per class (getrc.f90:70-100)
                rsm = rs_base * reldiff + float(td.rm[i])
                rluc = tb["rlu"][i][:, None, :] + corr[..., None]
                rclc = tb["rcl"][i][:, None, :] + corr[..., None]
                rgsc = tb["rgs"][i][:, None, :] + corr[..., None]
                rluo_r = _sdiv(1.0, 1.0 / 1000.0 + _sdiv(1.0, 3.0 * rluc))
                rluo_h = _sdiv(1.0, 1.0 / 3000.0 + _sdiv(1.0, 3.0 * rluc))
                rluc_r = _sdiv(1.0, _sdiv(1.0, 3.0 * rluc)
                               + 1e-7 * henry + _sdiv(f0, rluo_r))
                rluc_h = _sdiv(1.0, _sdiv(1.0, 3.0 * rluc)
                               + 1e-7 * henry + _sdiv(f0, rluo_h))
                rluc = torch.where((precip > 0.0)[..., None], rluc_r,
                                   torch.where((rh > 0.9)[..., None], rluc_h,
                                               rluc))
                rc = _sdiv(1.0, _sdiv(1.0, rsm) + _sdiv(1.0, rluc)
                           + _sdiv(1.0, rdc[..., None] + rclc)
                           + _sdiv(1.0, rac_s[:, None, :] + rgsc))
                rc = torch.clamp(rc, min=10.0)
                rtot = ra + rb[..., None] + rc
                vd = torch.where(rtot > 0.0, _sdiv(1.0, rtot),
                                 torch.full_like(rtot, 9.999))
                v = torch.sum(torch.where(active, vd * slanduse, zero),
                              dim=-1)
            if td.aero_mask[i]:
                # partdep.f90: per size bin, Stokes-corrected deposition
                vs = tb["vset"][i]                          # (NI,)
                sch = tb["schmi"][i]
                fr = tb["fract"][i]
                stokes = vs[None, None, :] / GA * ust[..., None] ** 2 \
                    / nyl[..., None]
                alpha = _sdiv(-3.0, torch.clamp(stokes, min=1e-30))
                extra = torch.where(alpha <= np.log10(EPS),
                                    torch.zeros_like(alpha),
                                    torch.pow(10.0, alpha))
                rdp = _sdiv(1.0, (sch[None, None, :] + extra) * ust[..., None])
                vdepj = vs + _sdiv(1.0, raquer[..., None] + rdp
                                   + raquer[..., None] * rdp * vs)
                vdepj = torch.where(ust[..., None] > EPS, vdepj,
                                    vs.expand_as(vdepj))
                v = v + torch.sum(vdepj * fr, dim=-1)
            if (not td.gas_mask[i] and not td.aero_mask[i]
                    and td.dryvel[i] > 0.0):
                v = torch.full((ny, nx), float(np.float32(td.dryvel[i])),
                               dtype=torch.float32, device=ust.device)
            vdep.append(v)
        return torch.stack(vdep)

    return vdep_field


def constant_vdep_kernel(species: Sequence):
    """The constant-velocity field of species without tables
    (getvdep.f90:196-203; the JAX package's ``Simulation._ensure_vdep_kernel``
    fallback): max(dryvel, 0) everywhere, as a contiguous tensor."""
    dryvel = np.asarray([max(s.dryvel, 0.0) for s in species], np.float32)

    def const_kernel(ust, tt2, rh, ps, oli, ssr, precip, sd):
        ny, nx = ust.shape
        dv = torch.as_tensor(dryvel, device=ust.device)
        return dv[:, None, None].expand(dv.shape[0], ny, nx).contiguous()

    return const_kernel

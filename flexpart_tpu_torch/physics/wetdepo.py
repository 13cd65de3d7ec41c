"""Wet deposition: scavenging coefficients, mass removal and the deposit
scatter onto the output grid.

Port of ``flexpart_tpu/physics/wetdepo.py`` (wetdepo.f90, get_wetscav.f90,
wetdepokernel.f90 and drydepokernel.f90 of the reference).  Two versions
of each computation:

* the plain PyTorch functions of this module (``wetscav_all_plain`` and,
  in ``physics/massupdate.py``, ``apply_wetdepo_plain``; ``depo_pairs`` and
  ``depo_scatter_plain``), which run for CPU tensors;
* kernel K9 (``csrc/wetdepo.cu``: per particle the precipitation, cloud
  and temperature lookup, the scavenging coefficient of every species, the
  mass removal and the decay-corrected deposit, in one launch; its
  ``CLWC`` instantiation takes the in-cloud rule's cloud water from the
  column cloud water of met that carries it, ``use_clwc``) and kernel
  K8 (``csrc/depo_scatter.cu``: the 4-point uniform-kernel scatter-add of
  a deposit onto the 2-D wet or dry grid, summed per warp and per block in
  shared memory before its atomics), which run for CUDA tensors.

``wet_deposition`` and ``depo_scatter`` pick by device and never fall from
one to the other.

Rounding.  Every host constant is folded as the JAX package folds it
(``henry * (R_AIR / 3500)`` and the aerosol polynomial's ``base`` in
float64, then float32).  ``x ** e`` for a species exponent is
``torch.pow`` of two tensors, never of a tensor and a Python number:
torch takes shortcuts there (``sqrt`` for 0.5, ``x * x`` for 2) that the
kernel's ``powf`` does not take.  ``x ** 2`` of a Python int is ``x * x``
in JAX and here.  Divisions by a Python number are true divisions
(``interp.true_div``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import INCLOUD_RATIO, R_AIR
from ..core.interp import horiz_weights, interp_2d, true_div, vert_weights
from ..core.state import Particles
from ..met.fields import (ZFields, F2_LSPREC, F2_CONVPREC, F2_TCC, F3_TT,
                          F2_CTWC)
from .massupdate import MAX_SPECIES, MassSpecies, apply_wetdepo_plain

# precipitating area fractions vs rate class (get_wetscav.f90:71-73)
LFR = np.array([0.5, 0.65, 0.8, 0.9, 0.95], np.float32)
CFR = np.array([0.4, 0.55, 0.7, 0.8, 0.9], np.float32)
RATE_EDGES = np.array([1.0, 3.0, 8.0, 20.0], np.float32)

# below-cloud aerosol polynomial constants (get_wetscav.f90:76-78)
BCLR = np.array([274.35758, 332839.59273, 226656.57259, 58005.91340,
                 6588.38582, 0.244984], np.float64)
BCLS = np.array([22.7, 0.0, 0.0, 1321.0, 381.0, 0.0], np.float64)

# the deposit scatter indexes grid rows by a 32-bit lane key, as K3
# (MAX_ROWS of csrc/depo_scatter.cu)
K8_MAX_ROWS = 0xFFFFFFFF - 32
_SENTINEL = 2 ** 30


class WetSpecies(NamedTuple):
    """Static per-species scavenging constants (from SPECIES files)."""
    wetdep: bool
    is_aerosol: bool
    weta_gas: float
    wetb_gas: float
    crain_aero: float
    csnow_aero: float
    ccn_aero: float
    in_aero: float
    henry: float
    dquer: float          # [um]

    @classmethod
    def from_species(cls, s) -> "WetSpecies":
        return cls(wetdep=s.wetdep, is_aerosol=s.dquer > 0.0,
                   weta_gas=s.weta_gas, wetb_gas=s.wetb_gas,
                   crain_aero=s.crain_aero, csnow_aero=s.csnow_aero,
                   ccn_aero=max(s.ccn_aero, 0.0),
                   in_aero=max(s.in_aero, 0.0),
                   henry=s.henry, dquer=s.dquer)

    @property
    def below_gas(self) -> bool:
        return (not self.is_aerosol) and (self.weta_gas > 0.0
                                          or self.wetb_gas > 0.0)

    @property
    def below_aerosol(self) -> bool:
        return self.is_aerosol and (self.crain_aero > 0.0
                                    or self.csnow_aero > 0.0)

    @property
    def in_cloud(self) -> bool:
        return (self.ccn_aero > 0.0 or self.in_aero > 0.0
                or (self.henry > 0.0 and not self.is_aerosol))


def _f32(v) -> float:
    return float(np.float32(v))


def _below_cloud_base(coeffs, dquer_um: float) -> float:
    """The Laakso-2003 / Kyro-2009 polynomial in log10(d) of
    ``_below_cloud_aerosol`` (get_wetscav.f90:234-252), in float64 on the
    host; dquer capped at 10 um."""
    d_m = min(10.0, dquer_um) / 1.0e6
    ld = np.log10(d_m)
    return (coeffs[0] + coeffs[1] * ld ** -4 + coeffs[2] * ld ** -3
            + coeffs[3] * ld ** -2 + coeffs[4] * ld ** -1)


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e with powf on every device (see the module docstring)."""
    return torch.pow(x, torch.full_like(x, e))


def _below_cloud_aerosol(coeffs, eff, dquer_um, prec):
    """eff * 10 ** (base + c5 * sqrt(prec)); ``base`` and ``c5`` float32 as
    the JAX package's numpy float64 scalars become there."""
    base = _f32(_below_cloud_base(coeffs, dquer_um))
    return eff * torch.pow(10.0, base + _f32(coeffs[5]) * torch.sqrt(prec))


def wetscav_all_plain(p: Particles, zf: ZFields, species: tuple,
                      use_clouds_water: bool):
    """Scavenging coefficient per live particle per species
    (``wetdepo.py:75-165`` there).

    zf: the wind-field time level nearest to itime-ltsample/2
    (get_wetscav.f90:121-127; space-bilinear, time-nearest for clouds).
    Returns (lambda (nspec, N), grfraction (N,))."""
    n = p.capacity
    dev = p.device
    x, y = p.x, p.y
    ny_m, nx_m = zf.f2d.shape[1], zf.f2d.shape[2]
    hw = horiz_weights(x, y, nx_m, ny_m, False)
    lsp, convp, cc = interp_2d(zf.f2d, (F2_LSPREC, F2_CONVPREC, F2_TCC), hw)
    cc = torch.clamp(cc, min=1e-10)

    # cell values for clouds / temperature (the reference uses the
    # uninterpolated cell, get_wetscav.f90:155-166); the column is the
    # truncation of x, not its floor
    ix = torch.clamp(x.to(torch.int32), 0, nx_m - 1).long()
    jy = torch.clamp(y.to(torch.int32), 0, ny_m - 1).long()
    hz, _ = vert_weights(p.z, zf.height)               # level below particle
    hz = hz.long()
    clouds_v = zf.clouds[hz, jy, ix].to(torch.int32)
    act_temp = zf.f3d[F3_TT][hz, jy, ix]
    ctwc = zf.f2d[F2_CTWC][jy, ix]

    raining = (lsp >= 0.01) | (convp >= 0.01)
    in_cloudy = clouds_v > 1          # below or in cloud

    # area fraction of the cell that precipitates (get_wetscav.f90:175-200)
    edges = torch.as_tensor(RATE_EDGES, device=dev)
    i_l = torch.searchsorted(edges, lsp, right=True)
    i_c = torch.searchsorted(edges, convp, right=True)
    lfr = torch.as_tensor(LFR, device=dev)[i_l]
    cfr = torch.as_tensor(CFR, device=dev)[i_c]
    tot = torch.clamp(lsp + convp, min=1e-30)
    grfraction = torch.clamp(cc * (lsp * lfr + convp * cfr) / tot, min=0.05)
    prec = (lsp + convp) / grfraction

    below = clouds_v >= 4
    incl = in_cloudy & (~below)

    # cloud water for in-cloud scavenging (get_wetscav.f90:274-290)
    if use_clouds_water:
        cl = ctwc * (grfraction / cc)
    else:
        cl = 1.0e6 * 2e-7 * _pow(prec, 0.36)
    # ice/liquid split (get_wetscav.f90:293-305)
    t = true_div(act_temp - 273.0, 273.0 - 253.0)
    ice_frac = torch.clamp(t * t, 0.0, 1.0)
    one = torch.ones_like(ice_frac)
    ice_frac = torch.where(act_temp <= 253.0, one, ice_frac)
    ice_frac = torch.where(act_temp >= 273.0, torch.zeros_like(one), ice_frac)
    liq_frac = torch.clamp(1.0 - ice_frac, min=0.0)

    scavs = []
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    for s in species:
        lam = zeros
        if not s.wetdep:
            scavs.append(lam)
            continue
        # ---- below-cloud (get_wetscav.f90:216-256)
        if s.below_gas:
            lam_b = s.weta_gas * _pow(prec, s.wetb_gas)
            lam = torch.where(below, lam_b, lam)
        elif s.below_aerosol:
            lam_rain = (_below_cloud_aerosol(BCLR, s.crain_aero, s.dquer, prec)
                        if s.crain_aero > 0.0 else zeros)
            lam_snow = (_below_cloud_aerosol(BCLS, s.csnow_aero, s.dquer, prec)
                        if s.csnow_aero > 0.0 else zeros)
            lam_b = torch.where(act_temp >= 273.0, lam_rain, lam_snow)
            lam = torch.where(below, lam_b, lam)
        # ---- in-cloud (get_wetscav.f90:262-330)
        if s.in_cloud:
            if s.is_aerosol:
                frac_act = liq_frac * s.ccn_aero + ice_frac * s.in_aero
                s_i = frac_act / torch.clamp(cl, min=1e-30)
            else:
                cle = (1.0 - cl) / (s.henry * (R_AIR / 3500.0)
                                    * act_temp) + cl
                s_i = torch.full_like(cle, 1.0) / cle
            lam_i = INCLOUD_RATIO * s_i * true_div(prec, 3.6e6)
            lam = torch.where(incl, lam_i, lam)
        scavs.append(lam)

    lam_all = torch.stack(scavs)                    # (nspec, N)
    valid = p.active & raining & in_cloudy
    lam_all = torch.where(valid[None, :], lam_all, torch.zeros_like(lam_all))
    return lam_all, grfraction


class WetSpec(ctypes.Structure):
    """One species' constants for K9 (``WetSpec`` of csrc/wetdepo.cu):
    which below-cloud rule (0 none, 1 gas A * P**B, 2 aerosol) and which
    in-cloud rule (0 none, 1 aerosol CCN/IN, 2 gas Henry) apply, and the
    float32 numbers they read, folded on the host as JAX folds them."""
    _fields_ = [("below", ctypes.c_int), ("incloud", ctypes.c_int),
                ("rain", ctypes.c_int), ("snow", ctypes.c_int),
                ("weta", ctypes.c_float), ("wetb", ctypes.c_float),
                ("rain_eff", ctypes.c_float), ("rain_base", ctypes.c_float),
                ("rain_c5", ctypes.c_float), ("snow_eff", ctypes.c_float),
                ("snow_base", ctypes.c_float), ("snow_c5", ctypes.c_float),
                ("ccn", ctypes.c_float), ("in_", ctypes.c_float),
                ("henry_r", ctypes.c_float), ("dec", ctypes.c_float)]


def wet_specs(species: tuple, sp: MassSpecies):
    """The ctypes array of ``WetSpec`` that K9 reads."""
    specs = (WetSpec * MAX_SPECIES)()
    for i, s in enumerate(species):
        w = specs[i]
        w.dec = float(sp.decay[i])
        if not s.wetdep:
            continue
        if s.below_gas:
            w.below, w.weta, w.wetb = 1, s.weta_gas, s.wetb_gas
        elif s.below_aerosol:
            w.below = 2
            if s.crain_aero > 0.0:
                w.rain, w.rain_eff = 1, s.crain_aero
                w.rain_base = _below_cloud_base(BCLR, s.dquer)
                w.rain_c5 = BCLR[5]
            if s.csnow_aero > 0.0:
                w.snow, w.snow_eff = 1, s.csnow_aero
                w.snow_base = _below_cloud_base(BCLS, s.dquer)
                w.snow_c5 = BCLS[5]
        if s.in_cloud:
            if s.is_aerosol:
                w.incloud, w.ccn, w.in_ = 1, s.ccn_aero, s.in_aero
            else:
                w.incloud, w.henry_r = 2, s.henry * (R_AIR / 3500.0)
    return specs


def wetdepo_cuda(p: Particles, zf: ZFields, ltsample: int, ldeltat: int,
                 species: tuple, sp: MassSpecies, use_clwc: bool = False):
    """K9 launch: one thread per particle; the mass and the deposit
    (nspec, N) are written out of place.  ``use_clwc``: the ``CLWC``
    instantiation, the in-cloud rule's cloud water from the column cloud
    water ``F2_CTWC`` (launched and counted through its entry)."""
    n, nspec, dev = p.capacity, p.nspec, p.device
    if nspec > MAX_SPECIES:
        raise ValueError(f"K9 takes at most {MAX_SPECIES} species")
    if n >= 2 ** 31:
        raise ValueError("K9 indexes particles with int32")
    if len(species) != nspec or len(sp.decay) != nspec:
        raise ValueError("K9: species constants do not match the mass")
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "active"):
        t = getattr(p, name)
        want = torch.bool if name == "active" else torch.float32
        if t.device != dev or t.dtype != want or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"K9: particle field {name} must be contiguous "
                             f"{want} ({n},) on {dev}")
    if p.mass.device != dev or p.mass.dtype != torch.float32 \
            or not p.mass.is_contiguous():
        raise ValueError(f"K9: mass must be contiguous float32 on {dev}")
    nz, ny, nx = zf.clouds.shape
    for name, t, dt, shape in (
            ("f2d", zf.f2d, torch.float32, None),
            ("f3d", zf.f3d, torch.float32, None),
            ("clouds", zf.clouds, torch.int8, (nz, ny, nx)),
            ("height", zf.height, torch.float32, (nz,))):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() or (
                shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"K9: {name} must be contiguous {dt} on {dev}")
    if tuple(zf.f2d.shape[1:]) != (ny, nx) or tuple(zf.f3d.shape[1:]) != (
            nz, ny, nx) or nz < 2 or ny < 2 or nx < 2 \
            or nz * ny * nx >= 2 ** 31:
        raise ValueError("K9: met fields of mismatched or unsupported shape")
    specs = wet_specs(species, sp)
    mass = torch.empty_like(p.mass)
    deposit = torch.empty((nspec, n), dtype=torch.float32, device=dev)
    if n == 0:
        return p.replace(mass=mass), deposit
    launch = _build.WETDEPO_CLWC if use_clwc else _build.WETDEPO
    ctwc = zf.f2d[F2_CTWC].data_ptr() if use_clwc else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), p.active.data_ptr(),
            p.mass.data_ptr(), None, zf.f2d[F2_LSPREC].data_ptr(),
            zf.f2d[F2_CONVPREC].data_ptr(), zf.f2d[F2_TCC].data_ptr(), ctwc,
            zf.clouds.data_ptr(), zf.f3d[F3_TT].data_ptr(),
            zf.height.data_ptr(), nz, ny, nx, ctypes.addressof(specs), n,
            nspec, abs(int(ltsample)), abs(int(ldeltat)), 0.0,
            mass.data_ptr(), deposit.data_ptr(), None, stream)
    return p.replace(mass=mass), deposit


def wet_deposition(p: Particles, zf: ZFields, ltsample: int, ldeltat: int,
                   species: tuple, sp: MassSpecies, use_clwc: bool = False):
    """One wet-deposition pass (wetscav_all + apply_wetdepo of the JAX
    package), the in-cloud rule's cloud water from the precipitation rate,
    or with ``use_clwc`` from the column cloud water of the met: K9 (its
    ``CLWC`` instantiation) on a CUDA device, the plain chain on the CPU.
    Returns (particles, deposit (nspec, N))."""
    dev = p.device
    if dev.type == "cuda":
        return wetdepo_cuda(p, zf, ltsample, ldeltat, species, sp, use_clwc)
    if dev.type == "cpu":
        lam, grfraction = wetscav_all_plain(p, zf, species, use_clwc)
        return apply_wetdepo_plain(p, lam, grfraction, ltsample, ldeltat, sp)
    raise ValueError(f"no wet-deposition backend for device {dev}")


# ----- the deposit scatter (make_depokernel, wetdepokernel.f90) -----

def depo_age_class(p: Particles, itime: int, lage: torch.Tensor,
                   nage: int) -> torch.Tensor:
    """Age class of every particle at ``itime`` (the JAX package's
    ``Simulation._scatter_depo``)."""
    itage = torch.abs(itime - p.itramem)
    return torch.clamp(torch.searchsorted(lage, itage, right=True),
                       0, nage - 1)


def depo_pairs(rows: int, deposit: torch.Tensor, p: Particles,
               nage_idx: torch.Tensor, kp: torch.Tensor, cfg):
    """What each particle adds to a flat deposition grid of ``rows`` rows
    (``make_depokernel(..).scatter``, ``wetdepo.py:176-207`` there): target
    rows ``lin`` (N, 4) int64 in the corner order (ix, jy), (ixp, jyp),
    (ixp, jy), (ix, jyp), their validity (N, 4) and the values
    (N, 4, nspec).  A pair is valid where the particle is active and the
    corner lies in the grid; no weight test."""
    xl = true_div(p.x * cfg.dx_met + cfg.xoutshift, cfg.dxout)
    yl = true_div(p.y * cfg.dy_met + cfg.youtshift, cfg.dyout)
    # floor clamped in float first: JAX's float->int conversion saturates
    big = float(_SENTINEL)
    ix = torch.clamp(torch.floor(xl), -big, big).to(torch.int64)
    jy = torch.clamp(torch.floor(yl), -big, big).to(torch.int64)
    ddx = xl - ix
    ddy = yl - jy
    hi_x = ddx > 0.5
    hi_y = ddy > 0.5
    ixp = torch.where(hi_x, ix + 1, ix - 1)
    jyp = torch.where(hi_y, jy + 1, jy - 1)
    wx = torch.where(hi_x, 1.5 - ddx, 0.5 + ddx)
    wy = torch.where(hi_y, 1.5 - ddy, 0.5 + ddy)
    cx = torch.stack([ix, ixp, ixp, ix], dim=1)                    # (N, 4)
    cy = torch.stack([jy, jyp, jy, jyp], dim=1)
    w4 = torch.stack([wx * wy, (1 - wx) * (1 - wy), (1 - wx) * wy,
                      wx * (1 - wy)], dim=1)
    in_grid = (cx >= 0) & (cx < cfg.nxg) & (cy >= 0) & (cy < cfg.nyg)
    cell = ((nage_idx.long() * cfg.nclassunc + p.nclass) * cfg.npointspec
            + kp)
    lin = cell[:, None] * (cfg.nyg * cfg.nxg) + cy * cfg.nxg + cx
    valid = p.active[:, None] & in_grid & (lin >= 0) & (lin < rows)
    contrib = w4[..., None] * deposit.T[:, None, :]          # (N, 4, nspec)
    return lin, valid, contrib


def depo_scatter_plain(flat: torch.Tensor, deposit: torch.Tensor,
                       p: Particles, nage_idx: torch.Tensor,
                       kp: torch.Tensor, cfg) -> None:
    """Plain twin of K8: accumulate into ``flat`` (rows, nspec) in place."""
    lin, valid, contrib = depo_pairs(flat.shape[0], deposit, p, nage_idx,
                                     kp, cfg)
    flat.index_add_(0, lin[valid], contrib[valid])


def depo_scatter_cuda(flat: torch.Tensor, deposit: torch.Tensor,
                      p: Particles, itime: int, lage: torch.Tensor,
                      cfg) -> None:
    """K8 launch: accumulate into ``flat`` (rows, nspec) in place; the age
    class and the release index are taken per particle in the kernel."""
    n, dev = p.capacity, flat.device
    nspec = flat.shape[1]
    f32, i32 = torch.float32, torch.int32
    want = {"x_hi": f32, "x_lo": f32, "y_hi": f32, "y_lo": f32,
            "itramem": i32, "npoint": i32, "nclass": i32,
            "active": torch.bool}
    for name, dt in want.items():
        t = getattr(p, name)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != (n,):
            raise ValueError(f"K8: particle field {name} must be contiguous "
                             f"{dt} ({n},) on {dev}")
    if n >= 2 ** 31:
        raise ValueError("K8 indexes particles with int32")
    if deposit.device != dev or deposit.dtype != f32 \
            or tuple(deposit.shape) != (nspec, n) \
            or not deposit.is_contiguous():
        raise ValueError(f"K8: deposit must be contiguous float32 "
                         f"({nspec}, {n}) on {dev}")
    if not 1 <= nspec <= MAX_SPECIES:
        raise ValueError(f"K8 takes 1 to {MAX_SPECIES} species")
    if flat.shape[0] > K8_MAX_ROWS:
        raise ValueError(f"K8 matches grid rows by a 32-bit index: "
                         f"{flat.shape[0]} rows exceed {K8_MAX_ROWS}")
    for t, dt, name in ((lage, i32, "lage"), (flat, f32, "grid")):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"K8: {name} must be contiguous {dt} on {dev}")
    if lage.shape[0] < cfg.nage:
        raise ValueError("K8: lage has fewer entries than nage")
    if n == 0:
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.DEPO_SCATTER(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.itramem.data_ptr(), p.npoint.data_ptr(),
            p.nclass.data_ptr(), p.active.data_ptr(), deposit.data_ptr(),
            lage.data_ptr(), cfg.nage, n, nspec, cfg.nxg, cfg.nyg,
            cfg.npointspec, cfg.nclassunc, _f32(cfg.dx_met), _f32(cfg.dy_met),
            _f32(cfg.xoutshift), _f32(cfg.youtshift), _f32(cfg.dxout),
            _f32(cfg.dyout), int(itime), int(cfg.ioutputforeachrelease),
            flat.shape[0], flat.data_ptr(), stream)


def depo_scatter(grid: torch.Tensor, deposit: torch.Tensor, p: Particles,
                 itime: int, lage: torch.Tensor, cfg) -> torch.Tensor:
    """Scatter a per-particle deposit (nspec, N) onto a 2-D deposition grid
    (nage, nclass, kp, nyg, nxg, nspec), in place, with each particle's age
    class at ``itime`` (the JAX package's ``Simulation._scatter_depo``):
    K8 on a CUDA device, the plain version on the CPU.  ``cfg`` is the
    run's ``ConcConfig``."""
    flat = grid.view(-1, grid.shape[-1])
    dev = flat.device
    if dev.type == "cuda":
        depo_scatter_cuda(flat, deposit, p, itime, lage, cfg)
    elif dev.type == "cpu":
        nage_idx = depo_age_class(p, itime, lage, cfg.nage)
        kp = (p.npoint if cfg.ioutputforeachrelease
              else torch.zeros_like(p.npoint)).long()
        depo_scatter_plain(flat, deposit, p, nage_idx, kp, cfg)
    else:
        raise ValueError(f"no deposit-scatter backend for device {dev}")
    return grid

"""Synthetic met backends (numpy copy of ``flexpart_tpu/met/synthetic.py``).

Same analytic atmospheres as the JAX package, generated in float64 numpy
and returned as float32 ``EtaFields`` on the device the caller names:
``fetch(time, device) -> EtaFields``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fields import EtaFields, eta_from_numpy
from .grid import MetGrid, hybrid_coefficients


def make_grid(nx: int = 73, ny: int = 37, nlev: int = 28,
              dx: float = 5.0, dy: float = 5.0,
              xlon0: float = -180.0, ylat0: float = -90.0,
              xglobal: bool | None = None) -> MetGrid:
    if xglobal is None:
        xglobal = abs((nx - 1) * dx - 360.0) < 1e-6
    akm, bkm = hybrid_coefficients(nlev)
    return MetGrid(nx=nx, ny=ny, nlev=nlev, xlon0=xlon0, ylat0=ylat0,
                   dx=dx, dy=dy, akm=akm, bkm=bkm, xglobal=xglobal)


@dataclasses.dataclass
class SyntheticMet:
    """Analytic atmosphere; ``time`` is seconds since simulation start."""
    grid: MetGrid
    u_jet: float = 25.0
    seed: int = 0

    def fetch(self, time: float, device: torch.device | str) -> EtaFields:
        g = self.grid
        nx, ny = g.nx, g.ny
        lon = g.lons[None, :] * np.ones((ny, 1))
        lat = g.lats[:, None] * np.ones((1, nx))
        lam = np.deg2rad(lon)
        phi = np.deg2rad(lat)
        t = float(time)

        ps = 101325.0 - 800.0 * np.cos(2 * lam - 1e-5 * t) * np.sin(2 * phi) ** 2
        tt2 = 300.0 - 45.0 * np.sin(phi) ** 2 + 2.0 * np.sin(lam + 7.3e-5 * t)
        td2 = tt2 - 2.0 - 6.0 * np.sin(phi) ** 2

        p_full = g.akz[:, None, None] + g.bkz[:, None, None] * ps[None]
        zapprox = -7500.0 * np.log(np.maximum(p_full, 1.0) / ps[None])

        lapse = 6.5e-3
        tth = tt2[None] - lapse * zapprox
        tth = np.maximum(tth, 216.0)
        tc_h = tth - 273.15
        es = 611.2 * np.exp(17.67 * tc_h / (243.5 + tc_h))
        qsat = 0.622 * es / np.maximum(p_full - 0.378 * es, 1.0)
        rainband = np.exp(-((np.abs(lat) - 50.0) / 8.0) ** 2)
        storm = rainband * np.maximum(np.sin(3 * lam - 1.2e-5 * t), 0.0)
        rh_prof = (0.35 + 0.55 * np.cos(phi)[None] ** 2 + 0.55 * storm[None]) \
            * np.exp(-zapprox / 9000.0)
        qvh = np.clip(rh_prof, 0.02, 0.93) * qsat

        jet = np.exp(-((np.abs(lat) - 45.0) / 12.0) ** 2)
        zshape = np.exp(-((zapprox - 10000.0) / 5000.0) ** 2)
        meander = 1.0 + 0.3 * np.sin(3 * lam + 1.2e-5 * t)
        uuh = self.u_jet * jet[None] * (0.15 + 0.85 * zshape) * meander
        vvh = 6.0 * np.sin(3 * lam - 1.2e-5 * t) * np.cos(phi)[None] ** 2 * zshape
        uuh[0] = 0.4 * uuh[1]
        vvh[0] = 0.4 * vvh[1]

        p_half = g.akm[:, None, None] + g.bkm[:, None, None] * ps[None]
        wshape = np.sin(np.pi * np.clip(1.0 - p_half / ps[None], 0.0, 1.0))
        wwh = -0.08 * np.sin(2 * lam + 1e-5 * t) * np.cos(phi)[None] * wshape
        wwh[0] = 0.0

        lsm = (np.sin(2 * phi) * np.cos(lam) > 0.1).astype(float)
        diurnal = np.cos(lam + 2 * np.pi * t / 86400.0)
        sshf = -120.0 * np.maximum(diurnal, -0.3) * (0.3 + 0.7 * lsm)
        ssr = 600.0 * np.maximum(diurnal, 0.0)
        surfstr = 0.08 + 0.12 * (uuh[1] ** 2 + vvh[1] ** 2) / 100.0

        lsprec = 2.0 * storm
        convprec = 1.0 * np.cos(phi) ** 4 * np.maximum(np.sin(2 * lam + 5e-6 * t), 0.0)
        tcc = np.clip(0.2 + 0.8 * (lsprec + convprec), 0.0, 1.0)

        rh = np.clip(qvh / np.maximum(qsat, 1e-9), 0.0, 1.0)
        clwch = np.where(rh > 0.85, 2.0e-4 * (rh - 0.85) / 0.15, 0.0) \
            * np.exp(-((zapprox - 4000.0) / 3000.0) ** 2)

        zero = np.zeros((ny, nx))
        d = dict(
            ps=ps, tt2=tt2, td2=td2, sshf=sshf, surfstr=surfstr, ssr=ssr,
            lsprec=lsprec, convprec=convprec, tcc=tcc, sd=zero,
            oro=zero, excessoro=zero + 50.0, lsm=lsm,
            tth=tth, qvh=qvh, uuh=uuh, vvh=vvh, wwh=wwh, clwch=clwch,
        )
        if g.xglobal:
            for v in d.values():
                v[..., -1] = v[..., 0]  # cyclic column
        return eta_from_numpy(d, device)


@dataclasses.dataclass
class UniformWindMet:
    """Constant-wind backend: neutral PBL, uniform T structure, no
    precip."""
    grid: MetGrid
    u: float = 10.0
    v: float = 0.0

    def fetch(self, time: float, device: torch.device | str) -> EtaFields:
        g = self.grid
        ny, nx, nlev = g.ny, g.nx, g.nlev
        ps = np.full((ny, nx), 101325.0)
        tt2 = np.full((ny, nx), 288.0)
        td2 = tt2 - 5.0
        p_full = g.akz[:, None, None] + g.bkz[:, None, None] * ps[None]
        zapprox = -7500.0 * np.log(np.maximum(p_full, 1.0) / ps[None])
        tth = np.maximum(tt2[None] - 6.5e-3 * zapprox, 216.0)
        qvh = np.full((nlev, ny, nx), 1e-4)
        zero = np.zeros((ny, nx))
        d = dict(
            ps=ps, tt2=tt2, td2=td2, sshf=zero + 1.0, surfstr=zero + 0.1,
            ssr=zero, lsprec=zero, convprec=zero, tcc=zero, sd=zero,
            oro=zero, excessoro=zero, lsm=zero,
            tth=tth, qvh=qvh,
            uuh=np.full((nlev, ny, nx), self.u),
            vvh=np.full((nlev, ny, nx), self.v),
            wwh=np.zeros((nlev, ny, nx)),
            clwch=np.zeros((nlev, ny, nx)),
        )
        return eta_from_numpy(d, device)


def uniform_wind_met(grid: MetGrid, u: float = 10.0, v: float = 0.0,
                     w: float = 0.0) -> UniformWindMet:
    """Trivial constant-wind backend for exactness tests (``w`` is accepted
    for signature parity and ignored, as in the JAX package)."""
    return UniformWindMet(grid, u, v)

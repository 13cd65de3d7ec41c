"""Scalar oracles for the deposition mass path + reference release draws.

Companions to validation.oracle for the matched 48-h validation run:

* `legacy_release` mirrors releaseparticles.f90:147-193's per-particle
  ran1 consumption order (x, y, nclass, z) with the exact Numerical
  Recipes ran1 port, so kernel and oracle consume identical release
  positions;
* `oracle_wetscav` is a scalar transcription of the scavenging
  coefficient chain (get_wetscav.f90: precip area fractions, below-cloud
  gas A*P^B / aerosol Laakso-Kyro polynomials, in-cloud Henry /
  activated-fraction splits) following the TPU path's field-sampling
  convention (single nearest-time field, bilinear precip/tcc,
  cell-centre clouds/T — physics/wetdepo.py documents the deviation
  from interpol_rain's two-field time blend);
* `oracle_wetdepo_mass` / `oracle_drydecay_mass` apply the reference's
  mass arithmetic (wetdepo.f90:102-138; timemanager.f90:643-686).

These exist solely as test fixtures for tests/test_matched_chernobyl.py
(no Fortran toolchain in this image); they are written from the Fortran
sources, not from the TPU kernels they check.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import INCLOUD_RATIO, R_AIR
from ..met.fields import (F2_CONVPREC, F2_CTWC, F2_LSPREC, F2_TCC, F3_TT)
from .legacy_rng import Ran1

f32 = np.float32

LFR = (0.5, 0.65, 0.8, 0.9, 0.95)      # get_wetscav.f90:71-73
CFR = (0.4, 0.55, 0.7, 0.8, 0.9)
RATE_EDGES = (1.0, 3.0, 8.0, 20.0)


def legacy_release(box, npart: int, nclassunc: int, xlon0, ylat0, dx, dy,
                   seed: int = -7, ran1=None):
    """Uniform draws inside the release box in the reference's exact
    per-particle order x, y, nclass, z (releaseparticles.f90:147-193),
    via ran1(idummy).  Returns (x, y, nclass, z) in mother-grid units.

    Pass an existing Ran1 to share the idummy chain across boxes like
    the reference does (one SAVEd stream for all releases)."""
    if ran1 is None:
        ran1 = Ran1(seed)
    x1 = (box["lon1"] - xlon0) / dx
    x2 = (box["lon2"] - xlon0) / dx
    y1 = (box["lat1"] - ylat0) / dy
    y2 = (box["lat2"] - ylat0) / dy
    xaux = f32(x2 - x1)
    yaux = f32(y2 - y1)
    zaux = f32(box["z2"] - box["z1"])
    xs, ys, ns, zs = [], [], [], []
    for _ in range(npart):
        xs.append(np.float64(f32(x1) + ran1() * xaux))
        ys.append(np.float64(f32(y1) + ran1() * yaux))
        ns.append(min(int(ran1() * f32(nclassunc)) + 1, nclassunc) - 1)
        zs.append(f32(box["z1"]) + ran1() * zaux)
    return (np.asarray(xs), np.asarray(ys),
            np.asarray(ns, np.int32), np.asarray(zs, f32))


def _bilin2(a, xt, yt):
    ix, jy = int(xt), int(yt)
    ixp = min(ix + 1, a.shape[1] - 1)
    jyp = min(jy + 1, a.shape[0] - 1)
    ddx = f32(xt - ix)
    ddy = f32(yt - jy)
    return ((1 - ddx) * (1 - ddy) * a[jy, ix] + ddx * (1 - ddy) * a[jy, ixp]
            + (1 - ddx) * ddy * a[jyp, ix] + ddx * ddy * a[jyp, ixp])


def oracle_wetscav(zf, xt, yt, zt, sp) -> tuple:
    """Scavenging coefficient Lambda [1/s] and precipitating grid
    fraction for one particle (get_wetscav.f90).  zf: numpy view with
    .f2d/.f3d/.clouds/.height; sp: dict of species constants."""
    f2 = np.asarray(zf.f2d)
    lsp = _bilin2(f2[F2_LSPREC], xt, yt)
    convp = _bilin2(f2[F2_CONVPREC], xt, yt)
    cc = max(_bilin2(f2[F2_TCC], xt, yt), f32(1.0e-10))
    ix = min(max(int(xt), 0), f2.shape[2] - 1)
    jy = min(max(int(yt), 0), f2.shape[1] - 1)
    ht = np.asarray(zf.height)
    hz = 0
    for i in range(1, ht.shape[0]):
        if ht[i] > zt:
            hz = i - 1
            break
    else:
        hz = ht.shape[0] - 2
    clouds_v = int(np.asarray(zf.clouds)[hz, jy, ix])
    act_temp = f32(np.asarray(zf.f3d)[F3_TT][hz, jy, ix])

    if (lsp < 0.01 and convp < 0.01) or clouds_v <= 1:
        return f32(0.0), f32(1.0)

    def frac_idx(p):
        for i, e in enumerate(RATE_EDGES):
            if p <= e:
                return i
        return len(RATE_EDGES)

    lfr = f32(LFR[frac_idx(lsp)])
    cfr = f32(CFR[frac_idx(convp)])
    tot = max(lsp + convp, f32(1.0e-30))
    grfraction = max(f32(0.05), cc * (lsp * lfr + convp * cfr) / tot)
    prec = (lsp + convp) / grfraction

    below = clouds_v >= 4
    lam = f32(0.0)
    if below:
        if (not sp["is_aerosol"]) and (sp["weta_gas"] > 0
                                       or sp["wetb_gas"] > 0):
            lam = f32(sp["weta_gas"]) * prec ** f32(sp["wetb_gas"])
        elif sp["is_aerosol"]:
            # Laakso / Kyro polynomials (get_wetscav.f90:234-252)
            d_m = min(10.0, sp["dquer"]) / 1.0e6
            ld = math.log10(d_m)
            if act_temp >= 273.0 and sp["crain_aero"] > 0:
                co = (274.35758, 332839.59273, 226656.57259,
                      58005.91340, 6588.38582, 0.244984)
                eff = sp["crain_aero"]
            elif act_temp < 273.0 and sp["csnow_aero"] > 0:
                co = (22.7, 0.0, 0.0, 1321.0, 381.0, 0.0)
                eff = sp["csnow_aero"]
            else:
                co = None
            if co is not None:
                base = (co[0] + co[1] * ld ** -4 + co[2] * ld ** -3
                        + co[3] * ld ** -2 + co[4] * ld ** -1)
                lam = f32(eff) * f32(10.0) ** f32(
                    base + co[5] * math.sqrt(prec))
    else:
        # in-cloud (get_wetscav.f90:262-330); no-ctwc cloud water form
        cl = f32(1.0e6 * 2e-7) * prec ** f32(0.36)
        if act_temp <= 253.0:
            ice = f32(1.0)
        elif act_temp >= 273.0:
            ice = f32(0.0)
        else:
            ice = f32(((act_temp - 273.0) / (273.0 - 253.0)) ** 2)
        liq = max(f32(0.0), f32(1.0) - ice)
        if sp["is_aerosol"] and (sp["ccn_aero"] > 0 or sp["in_aero"] > 0):
            frac_act = liq * f32(sp["ccn_aero"]) + ice * f32(sp["in_aero"])
            s_i = frac_act / max(cl, f32(1.0e-30))
            lam = f32(INCLOUD_RATIO) * s_i * (prec / f32(3.6e6))
        elif (not sp["is_aerosol"]) and sp["henry"] > 0:
            cle = (f32(1.0) - cl) / (f32(sp["henry"]) * f32(R_AIR / 3500.0)
                                     * act_temp) + cl
            s_i = f32(1.0) / cle
            lam = f32(INCLOUD_RATIO) * s_i * (prec / f32(3.6e6))
    return lam, grfraction


def oracle_wetdepo_mass(mass, lam, grfraction, ltsample, ldeltat, decay):
    """wetdepo.f90:102-138 for one particle, one species.  Returns
    (new_mass, deposit) with the ldeltat decay correction applied to the
    deposit."""
    TINY = float(np.finfo(np.float32).tiny)  # smallnum (wetdepo.f90:53)
    wetdeposit = mass * f32(1.0 - math.exp(-float(lam)
                                           * abs(ltsample))) * grfraction
    restmass = mass - wetdeposit
    new_mass = restmass if restmass > TINY else f32(0.0)
    if decay > 0.0:
        wetdeposit = wetdeposit * f32(math.exp(abs(ldeltat) * decay))
    return new_mass, wetdeposit


def oracle_drydecay_mass(mass, prob, lsynctime, ldeltat, decay,
                         drydep: bool):
    """timemanager.f90:643-661 decay + dry-deposition arithmetic for one
    particle, one species."""
    decfact = f32(math.exp(-abs(lsynctime) * decay)) if decay > 0 \
        else f32(1.0)
    if drydep:
        drydeposit = mass * f32(prob) * decfact
        new_mass = mass * (f32(1.0) - f32(prob)) * decfact
        if decay > 0.0:
            drydeposit = drydeposit * f32(math.exp(abs(ldeltat) * decay))
    else:
        drydeposit = f32(0.0)
        new_mass = mass * decfact
    return new_mass, drydeposit

"""Profile method for surface stress and sensible heat flux (copy of
``flexpart_tpu/met/pblprofile.py``: numpy, float64).

GFS pgrb files carry no surface stress / heat flux, so the reference
derives them from the 10 m and lowest-sigma-level winds/temperatures with
the Berkovicz & Prahm (1982) successive-approximation profile method
(pbl_profile.f90, called from readwind_gfs.f90:712-731).  Here the whole
grid is done at once: the fixed-point iteration runs a constant 10 sweeps
over (ny, nx) arrays with the three special cases (no shear / neutral /
non-convergent unstable) folded in as masks — branch-free, host-side
numpy (met assembly runs on the host before the copy to the device).
"""

from __future__ import annotations

import numpy as np

from ..constants import CPA, GA, KARMAN, R_AIR

R1 = 0.74          # Prandtl-number factor (pbl_profile.f90:55)
_MAXITER = 10


def _ew(t):
    """Saturation vapour pressure [Pa] over water (ew.f90 form)."""
    y = 373.16 / np.maximum(t, 150.0)
    a = -7.90298 * (y - 1.0) + 5.02808 * np.log10(y)
    a += -1.3816e-7 * (10.0 ** (11.344 * (1.0 - 1.0 / y)) - 1.0)
    a += 8.1328e-3 * (10.0 ** (-3.49149 * (y - 1.0)) - 1.0)
    return 101325.0 * 10.0 ** a


def psim(z, al):
    """Momentum stability correction (psim.f90)."""
    zeta = z / al
    x = (np.abs(1.0 - 15.0 * np.minimum(zeta, 0.0))) ** 0.25
    a1 = ((1.0 + x) / 2.0) ** 2
    a2 = (1.0 + x * x) / 2.0
    unstable = np.log(a1 * a2) - 2.0 * np.arctan(x) + np.pi / 2.0
    return np.where(zeta <= 0.0, unstable, -4.7 * zeta)


def psih(z, al):
    """Heat stability correction (psih.f90, Beljaars-Holtslag stable)."""
    eps = 1e-20
    al = np.where(np.abs(al) < eps, np.where(al >= 0, eps, -eps), al)
    zeta = z / al
    a, b, c, d = 1.0, 0.667, 5.0, 0.35
    zs = np.maximum(zeta, 0.0)
    stable = (-(1.0 + 0.667 * a * zs) ** 1.5
              - b * (zs - c / d) * np.exp(-d * zs) - b * c / d + 1.0)
    x = (np.abs(1.0 - 16.0 * np.minimum(zeta, 0.0))) ** 0.25
    unstable = 2.0 * np.log((1.0 + x * x) / 2.0)
    return np.where(zeta > 0.0, stable, unstable)


def pbl_profile(ps, td2, zml1, t2, tml1, u10, uml1):
    """Surface stress [N/m2] and sensible heat flux [W/m2] from the
    2-level profile (pbl_profile.f90).  All args broadcastable arrays;
    zml1 is the height of the lowest sigma level (30 m in the GFS read,
    readwind_gfs.f90:721)."""
    ps = np.asarray(ps, np.float64)
    e = _ew(td2)
    tv = t2 * (1.0 + 0.378 * e / ps)
    rhoa = ps / (R_AIR * tv)

    deltau = np.maximum(uml1 - u10, 1e-6)
    no_shear = (uml1 - u10) <= 0.001
    deltat = tml1 - t2 + 0.0098 * (zml1 - 2.0)
    neutral = np.abs(deltat) <= 0.03
    tmean = 0.5 * (t2 + tml1)
    crit = (0.0219 * tmean * (zml1 - 2.0) * deltau ** 2
            / (np.where(neutral, 1.0, deltat) * (zml1 - 10.0) ** 2))
    noconv = (deltat > 0.0) & (crit <= 1.0)    # stable, won't converge

    def u_star(al):
        return KARMAN * deltau / (np.log(zml1 / 10.0)
                                  - psim(zml1, al) + psim(10.0, al))

    def theta_star(al):
        return (KARMAN * deltat / R1) / (np.log(zml1 / 2.0)
                                         - psih(zml1, al) + psih(2.0, al))

    al = np.full_like(ps, 9999.0)
    frozen = no_shear | neutral | noconv      # skip the iteration
    converged = np.zeros_like(ps, bool)
    ustar = u_star(al)
    thetastar = theta_star(al)
    for _ in range(_MAXITER):
        alold = al
        ustar = np.where(frozen | converged, ustar, u_star(al))
        thetastar = np.where(frozen | converged, thetastar, theta_star(al))
        al_new = (tmean * ustar ** 2
                  / (GA * KARMAN * np.where(np.abs(thetastar) < 1e-12,
                                            1e-12, thetastar)))
        al = np.where(frozen | converged, al, al_new)
        converged |= np.abs((al - alold) / np.where(alold == 0, 1.0, alold)
                            ) < 0.01

    hf = rhoa * CPA * ustar * thetastar
    stress = ustar ** 2 * rhoa

    # special cases (pbl_profile.f90:62-96)
    stress = np.where(no_shear, 0.01 ** 2 * rhoa, stress)
    hf = np.where(no_shear | neutral, 0.0, hf)
    al50 = np.full_like(ps, 50.0)
    stress = np.where(noconv & ~no_shear & ~neutral,
                      u_star(al50) ** 2 * rhoa, stress)
    hf = np.where(noconv & ~no_shear & ~neutral,
                  rhoa * CPA * u_star(al50) * theta_star(al50), hf)
    ustar_n = u_star(np.full_like(ps, 9999.0))
    stress = np.where(neutral & ~no_shear, ustar_n ** 2 * rhoa, stress)
    return (stress.astype(np.float32),
            np.clip(hf, -400.0, 200.0).astype(np.float32))

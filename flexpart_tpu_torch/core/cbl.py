"""Skewed convective-boundary-layer Langevin scheme (CBLFLAG=1).

Port of ``flexpart_tpu/core/cbl.py`` (cbl.f90, re_initialize_particle.f90,
initialize_cbl_vel.f90; the bi-Gaussian closure of Cassiani et al. 2015):
the drift ``ath`` and diffusion ``bth`` of the non-Gaussian vertical
Langevin equation, the redraw of a particle whose velocity left the pdf,
and a fresh particle's velocity.  ``wp`` is the RAW vertical velocity
[m/s] here (advance.f90:405-442), not the sigw-normalised one of the
Gaussian turbswitch path.

These are the plain versions of the device functions ``cbl_*`` of
``csrc/advance_common.cuh`` (kernel K11's ``CBL`` instantiation), written
in the same order of operations so that the two agree bit for bit on the
card: every division by a number is a true division, every integer power
is written out as products (``x * x * x``, as ``lax.integer_pow`` computes
it), the other powers are ``torch.pow`` with the float32 exponent, and a
sum runs left to right.  ``torch.erf`` takes the place of
``jax.scipy.special.erf``, which rounds differently on the CPU, so the port
agrees with JAX to a tolerance there.  Every ``where`` computes both sides
first and selects, as JAX does, so a NaN on the side not taken stays out.
"""

from __future__ import annotations

import math

import torch

USURAD2 = 0.7071067812
USURAD2P = 0.3989422804
C0 = 3.0
COSTLUAR4 = 0.66667
EPS_C = 1e-6
CBL_ZONE = 5.0          # -h/L above which the skewed scheme applies
SKEW_TRANSITION = 15.0  # -h/L below which the skewness is tapered


def _div(a: float, b: torch.Tensor) -> torch.Tensor:
    """a / b rounded once (torch computes ``scalar / tensor`` as a
    reciprocal and a product on the card)."""
    return torch.full_like(b, a) / b


def _cuberoot(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _skew_params(z, h, wst, sigw, dsigwdz, ol):
    """The bi-Gaussian parameters shared by the drift, the redraw and the
    fresh draw (cbl.f90:70-170, re_initialize_particle.f90:40-60): (alu,
    blu, dalu, dblu, sa, sb, dsa, dsb, wa, wb, dwa, dwb), all (N,)."""
    zeta = z / h
    mhol = -h / ol
    taper = torch.sin((mhol + 10.0) / torch.full_like(mhol, 10.0) * math.pi) \
        / torch.full_like(mhol, 2.0) + 0.5
    transition = torch.where(mhol < SKEW_TRANSITION, taper,
                             torch.ones_like(taper))
    w2 = sigw * sigw
    dw2 = 2.0 * sigw * dsigwdz
    omz = torch.clamp(1.0 - zeta, min=0.0)
    omz15 = torch.pow(omz, 1.5)
    wst3 = wst * wst * wst
    w3 = ((1.2 * zeta * omz15) + EPS_C) * wst3 * transition
    dw3 = (1.2 * (omz15 - zeta * 1.5 * torch.sqrt(omz))) * wst3 / h \
        * transition
    w2_15 = torch.pow(w2, 1.5)
    skew = w3 / w2_15
    skew2 = skew * skew
    dskew = (dw3 * w2_15 - w3 * 1.5 * torch.sqrt(w2) * dw2) / (w2 * w2 * w2)
    radw2 = torch.sqrt(w2)
    dradw2 = 0.5 * dw2 / torch.sqrt(w2)
    fluarw = COSTLUAR4 * _cuberoot(skew)
    fluarw2 = fluarw * fluarw
    nz = skew != 0.0
    one = torch.ones_like(skew)
    zero = torch.zeros_like(skew)
    safe = torch.where(nz, skew, one)
    dfluarw = torch.where(
        nz, COSTLUAR4 / 3.0 * _cuberoot(_div(1.0, safe * safe)) * dskew, zero)
    f2p1 = 1.0 + fluarw2
    f2p3 = 3.0 + fluarw2
    fl_s = torch.where(nz, fluarw, one)
    f2p1_3 = f2p1 * f2p1 * f2p1
    f2p3_2 = f2p3 * f2p3
    f2p1_15 = torch.pow(f2p1, 1.5)
    rluarw = torch.where(nz, f2p1_3 * skew2 / (f2p3_2 * fluarw2), zero)
    xluarw = torch.where(nz, f2p1_15 * skew / (f2p3 * fl_s), zero)
    den_r = f2p3_2 * fluarw2
    drluarw = torch.where(nz, (
        ((3.0 * (f2p1 * f2p1) * (2.0 * fluarw * dfluarw) * skew2)
         + f2p1_3 * 2.0 * skew * dskew) * f2p3_2 * fluarw2
        - f2p1_3 * skew2
        * ((2.0 * f2p3 * (2.0 * fluarw * dfluarw) * fluarw2)
           + f2p3_2 * 2.0 * fluarw * dfluarw))
        / torch.clamp(den_r * den_r, min=1e-30), zero)
    den_x = f2p3 * fl_s
    dxluarw = torch.where(nz, (
        ((1.5 * torch.sqrt(f2p1) * (2.0 * fluarw * dfluarw) * skew)
         + f2p1_15 * dskew) * f2p3 * fl_s
        - f2p1_15 * skew * (3.0 * dfluarw + 3.0 * fluarw2 * dfluarw))
        / torch.clamp(den_x * den_x, min=1e-30), zero)

    s4r = torch.sqrt(4.0 + rluarw)
    aluarw = 0.5 * (1.0 - xluarw / s4r)
    bluarw = 1.0 - aluarw
    daluarw = -0.5 * ((dxluarw * s4r) - (0.5 * xluarw * drluarw / s4r)) \
        / (4.0 + rluarw)
    dbluarw = -daluarw
    al_s = torch.clamp(aluarw, min=1e-6)
    bl_s = torch.clamp(bluarw, min=1e-6)
    af = al_s * f2p1
    bf = bl_s * f2p1
    qa = torch.sqrt(bl_s / af)
    qb = torch.sqrt(al_s / bf)
    sigmawa = radw2 * qa
    sigmawb = radw2 * qb
    dsigmawa = dradw2 * qa + radw2 * (
        _div(0.5, qa)
        * ((dbluarw * af - bl_s * (daluarw * f2p1 + al_s * 2.0 * fluarw
                                   * dfluarw)) / (af * af)))
    dsigmawb = dradw2 * qb + radw2 * (
        _div(0.5, qb)
        * ((daluarw * bf - al_s * (dbluarw * f2p1 + bl_s * 2.0 * fluarw
                                   * dfluarw)) / (bf * bf)))
    wa = fluarw * sigmawa
    wb = fluarw * sigmawb
    dwa = dfluarw * sigmawa + fluarw * dsigmawa
    dwb = dfluarw * sigmawb + fluarw * dsigmawb
    return (aluarw, bluarw, daluarw, dbluarw, sigmawa, sigmawb,
            dsigmawa, dsigmawb, wa, wb, dwa, dwb)


def cbl_terms(wp, z, wst, h, rhoa, rhograd, sigw, dsigwdz, tlw, ol,
              ldirect: int):
    """Drift and diffusion of the skewed scheme (cbl.f90): (ath, bth,
    flagrein), flagrein where the velocity lies more than six sigma from
    both Gaussians (the particle is redrawn)."""
    timedir = float(ldirect)
    (alu, blu, dalu, dblu, sa, sb, dsa, dsb, wa, wb, dwa,
     dwb) = _skew_params(z, h, wst, sigw, dsigwdz, ol)
    dens, ddens = rhoa, rhograd
    alfa = 2.0 * sigw * sigw / (C0 * tlw)
    wold = timedir * wp
    deltawa = wold - wa
    deltawb = wold + wb
    wold2 = wold * wold
    sa2 = sa * sa
    sb2 = sb * sb
    flagrein = (torch.abs(deltawa) > 6.0 * sa) \
        & (torch.abs(deltawb) > 6.0 * sb)
    ra = deltawa / sa
    rb = deltawb / sb
    pa = _div(USURAD2P, sa) * torch.exp(-0.5 * (ra * ra))
    pb = _div(USURAD2P, sb) * torch.exp(-0.5 * (rb * rb))
    ptot = torch.clamp(dens * alu * pa + dens * blu * pb, min=1e-30)
    aperfa = deltawa * USURAD2 / sa
    aperfb = deltawb * USURAD2 / sb
    phi = (-0.5 * (alu * dens * dwa + dens * wa * dalu + alu * wa * ddens)
           * torch.erf(aperfa)
           + sa * (alu * dens * dsa * (wold2 / sa2 + 1.0)
                   + sa * dens * dalu + sa * ddens * alu
                   + alu * wold * dens / sa2 * (sa * dwa - wa * dsa)) * pa
           + 0.5 * (blu * dens * dwb + wb * dens * dblu + wb * blu * ddens)
           * torch.erf(aperfb)
           + sb * (blu * dens * dsb * (wold2 / sb2 + 1.0)
                   + sb * dens * dblu + sb * ddens * blu
                   + blu * wold * dens / sb2 * (-sb * dwb + wb * dsb)) * pb)
    q = timedir * ((alu * dens * deltawa / sa2) * pa
                   + (blu * dens * deltawb / sb2) * pb)
    ath = _div(1.0, ptot) * (-(C0 / 2.0) * alfa * q + phi)
    bth = torch.sqrt(C0 * alfa)
    return ath, bth, flagrein


def init_cbl_wp(dcas, dcas1, z, wst, h, sigw, dsigwdz, ol, ldirect: int):
    """A fresh particle's raw vertical velocity from the skewed pdf
    (initialize_cbl_vel.f90): the uniform ``dcas`` picks the updraft or
    the downdraft population by its area, the normal ``dcas1`` draws in
    it."""
    timedir = float(ldirect)
    (alu, _, _, _, sa, sb, _, _, wa, wb, _, _) = _skew_params(
        z, h, wst, sigw, dsigwdz, ol)
    return torch.where(dcas <= alu, dcas1 * sa + wa, dcas1 * sb - wb) \
        * timedir


def reinit_wp(rnd, rnd2, wp_old, z, wst, h, sigw, dsigwdz, ol,
              ldirect: int):
    """Redraw wp from the skewed pdf keeping its up- or downdraft sign
    (re_initialize_particle.f90): two attempts, then the first's
    magnitude.  ``sign(wp_old) * timedir > 0`` is the test, so a zero
    velocity counts as a downdraft."""
    timedir = float(ldirect)
    (_, _, _, _, sa, sb, _, _, wa, wb, _, _) = _skew_params(
        z, h, wst, sigw, dsigwdz, ol)
    updraft = torch.sign(wp_old) * timedir > 0
    u1, d1 = rnd * sa + wa, rnd * sb - wb
    u2, d2 = rnd2 * sa + wa, rnd2 * sb - wb
    w_up = torch.where(u1 >= 0, u1, torch.where(u2 >= 0, u2, torch.abs(u1)))
    w_dn = torch.where(d1 <= 0, d1, torch.where(d2 <= 0, d2, -torch.abs(d1)))
    return torch.where(updraft, w_up, w_dn) * timedir


def legacy_reinit_wp(tab, nrand, wp_old, z, wst, h, sigw, dsigwdz, ol,
                     ldirect: int, tries: int = 12):
    """The matched-RNG redraw (re_initialize_particle.f90's goto loop):
    table entries from ``nrand + 1`` on until the drawn velocity keeps
    the particle's sign, at most ``tries`` of them.  Fortran's
    ``sign(1., wp)`` is +1 at zero, so a zero velocity counts as an
    updraft here.  Returns (wp, the last index consumed)."""
    timedir = float(ldirect)
    (_, _, _, _, sa, sb, _, _, wa, wb, _, _) = _skew_params(
        z, h, wst, sigw, dsigwdz, ol)
    r = tab.shape[0] - 1
    one = torch.ones_like(wp_old)
    updraft = torch.where(wp_old >= 0.0, one, -one) * timedir > 0.0
    idx = nrand + 1
    done = torch.zeros_like(updraft)
    wp = torch.zeros_like(wp_old)
    for _ in range(tries):
        dcas = tab[torch.clamp(idx, 1, r).long()]
        cand = torch.where(updraft, dcas * sa + wa, dcas * sb - wb)
        ok = torch.where(updraft, cand >= 0.0, cand <= 0.0)
        wp = torch.where(ok & ~done, cand, wp)
        idx = torch.where(done | ok, idx, idx + 1)
        done = done | ok
    wp = torch.where(done, wp, torch.where(updraft, torch.abs(wp_old),
                                           -torch.abs(wp_old)))
    return wp * timedir, idx

"""Convective redistribution: Emanuel (1991) buoyancy-sorting scheme.

Port of ``flexpart_tpu/physics/convection.py`` (convmix.f90, calcmatrix.f90,
convect43c.f90 and redist.f90 of the reference), one function for each
function there.  Two versions of the same computation:

* the plain PyTorch functions of this module (``build_conv_profiles``,
  ``convect_columns``, ``fmassfrac_from_fmass``, ``_uvzlev``,
  ``redist_plain``), which run for CPU tensors;
* kernel K6 (``csrc/convection.cu``: the profiles, the scheme, the
  displacement matrix and the half-level heights of every grid column in
  one launch) and kernel K7 (``csrc/redist.cu``: the redistribution, one
  thread per particle), which run for CUDA tensors.

``ConvectionKernel`` (what ``make_convection_kernel`` returns) and
``redist_particles`` pick by device and never fall from one to the other.

Level sums.  Every sum and every cumulative sum over levels is written as
a loop in level order (``_seq_sum``, ``_seq_cumsum``), never as
``torch.sum``/``torch.cumsum``: on a CUDA tensor those are parallel
reductions whose rounding is not a sequential sum's, and the kernels add
in level order, so only this way do the plain version and the kernels
agree to the bit.  JAX's ``cumsum`` on the CPU is an associative scan:
against JAX the sums agree to a tolerance (``tests/test_torch_convection.py``).
Divisions by a Python number are true divisions (``interp.true_div``),
as XLA and the kernels compute them.  Index choices (argmin/argmax over
levels) take the first index, as ``jnp.argmin``/``jnp.argmax`` do.

All level indices are 0-based: index k here = Fortran level k+1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import GA, R_AIR
from ..core import rng
from ..core.interp import true_div
from ..core.state import Particles
from ..met.thermo import ew, f_qvsat

# Emanuel scheme parameters (convect43c.f90:250-262); copies of the JAX
# package's constants
ELCRIT = 0.0011
TLCRIT = -55.0
ENTP = 1.5
DTMAX_C = 0.9
ALPHA = 0.025
DAMP = 0.1
CPD = 1005.7
CPV = 1870.0
CL_W = 2500.0
RV = 461.5
RD = 287.04
LV0 = 2.501e6
CPVMCL = CL_W - CPV
EPS0 = RD / RV
EPSI = 1.0 / EPS0
EPSILON = 1.0e-20

# the Philox tag of the redistribution's uniform draw (the JAX package
# folds 1000000 + istep into its key for the same draw)
REDIST_TAG = 1000000
# the most profile levels (L1 = nl + 1) K6 takes: a column's profiles and
# its three L1 x L1 tiles must fit in a block's shared memory
# (csrc/convection.cu::MAX_LEVELS)
K6_MAX_LEVELS = 128


def nconvlev_from_grid(akz, bkz, nlev: int) -> int:
    """Number of profile levels for convection: up to the first level with
    p(SLP) < 50 hPa (gridcheck_ecmwf.f90:553-565)."""
    p = np.asarray(akz) + np.asarray(bkz) * 101325.0
    idx = int(np.argmax(p < 5000.0))
    if p[min(idx, nlev - 1)] >= 5000.0:
        idx = nlev - 2
    return int(min(idx, nlev - 2))


def _seq_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum along ``dim`` added in index order, from the first
    element on (the order the kernels add in)."""
    a = a.movedim(dim, 0)
    out = [a[0]]
    for k in range(1, a.shape[0]):
        out.append(out[-1] + a[k])
    return torch.stack(out).movedim(0, dim)


def _seq_sum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` added in index order, from the first element on."""
    a = a.movedim(dim, 0)
    s = a[0]
    for k in range(1, a.shape[0]):
        s = s + a[k]
    return s


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[c, idx[c]] for (C, L) ``a``; ``idx`` is in range."""
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _tlift_sat(tconv, qconv, qsconv, pconv, gz, q_nk, ah0):
    """Saturated-ascent parcel at every level, 2 Newton iterations
    (TLIFT, convect43c.f90:1041-1060).  All (C, L1)."""
    tg = tconv
    qg = qsconv
    alv = LV0 - CPVMCL * (tconv - 273.15)
    for _ in range(2):
        s = torch.full_like(tg, 1.0) / (
            CPD + alv * alv * qg / (RV * tconv * tconv))
        ahg = CPD * tg + (CL_W - CPD) * q_nk * tconv + alv * qg + gz
        tg = torch.clamp(tg + s * (ah0 - ahg), min=35.0)
        tc = tg - 273.15
        es = torch.where(
            tc >= 0.0,
            6.112 * torch.exp(17.67 * tc / (243.5 + tc)),
            torch.exp(23.33086 - torch.full_like(tg, 6111.72784) / tg
                      + 0.15215 * torch.log(tg)))
        qg = EPS0 * es / torch.clamp(pconv - es * (1.0 - EPS0), min=1e-6)
    tpk = true_div(ah0 - (CL_W - CPD) * q_nk * tconv - gz - alv * qg, CPD)
    clw = torch.clamp(q_nk - qg, min=0.0)
    tvp = tpk * (1.0 + (qg / (1.0 - q_nk)) * EPSI)
    return tvp, tpk, clw


def convect_columns(pconv, phconv, tconv, qconv, cbmf0, nl: int):
    """Emanuel's scheme over C columns, plain PyTorch (K6 computes it on
    the card, with ``fmassfrac_from_fmass`` and ``_uvzlev``).

    pconv (C, L1) full-level p [hPa]; phconv (C, L2) half-level p [hPa];
    tconv/qconv (C, L1); cbmf0 (C,) flux memory.  L1 = nl+1, L2 = nl+2.
    Returns (fmass (C, L1, L1) [source, dest] in CBMF units,
             sub (C, L1), cbmf (C,), lconv (C,) bool, nctop (C,) int32
             0-based inclusive top level)."""
    C, L1 = pconv.shape
    if L1 != nl + 1:
        raise ValueError(f"pconv has {L1} levels, nl + 1 = {nl + 1}")
    dev = pconv.device
    lev = torch.arange(L1, device=dev)
    eye = torch.eye(L1, dtype=torch.bool, device=dev)[None]
    eye_f = eye.to(pconv.dtype)
    dph = phconv[:, :L1] - phconv[:, 1:L1 + 1]       # (C, L1) > 0
    inf = torch.tensor(float("inf"), device=dev)

    qsconv = f_qvsat(pconv * 100.0, tconv)

    # ---- profiles (convect43c.f90:398-424) ----
    tv = tconv * (1.0 + qconv * EPSI - qconv)
    cpn = CPD * (1.0 - qconv) + CPV * qconv
    lv = LV0 - CPVMCL * (tconv - 273.15)
    dgz = torch.zeros_like(pconv)
    dgz[:, 1:] = (0.5 * RD * (tv[:, 1:] + tv[:, :-1])
                  * (pconv[:, :-1] - pconv[:, 1:]) / phconv[:, 1:L1])
    gz = _seq_cumsum(dgz, 1)
    h = tconv * cpn + gz
    hm = (CPD * (1.0 - qconv) + CL_W * qconv) \
        * (tconv - tconv[:, :1]) + lv * qconv + gz
    hm[:, 0] = lv[:, 0] * qconv[:, 0]

    # ---- parcel origin: min moist static energy, then max below it ----
    cand = torch.cat([torch.zeros((C, 1), dtype=torch.bool, device=dev),
                      hm[:, 1:] < hm[:, :-1]], dim=1)
    ihmin = torch.argmin(torch.where(cand, hm, inf), dim=1)
    ihmin = torch.where(cand.any(dim=1), ihmin, nl - 1)
    ihmin = torch.clamp(ihmin, max=nl - 2)
    nk = torch.argmax(torch.where(lev[None, :] <= ihmin[:, None], hm, -inf),
                      dim=1)

    t_nk = _take(tconv, nk)
    q_nk = _take(qconv, nk)
    ok0 = (t_nk >= 250.0) & (q_nk > 0.0) & (ihmin < nl - 2)

    # ---- LCL (Bolton 1980; convect43c.f90:447-455) ----
    rh = torch.clamp(q_nk / torch.clamp(_take(qsconv, nk), min=1e-10),
                     1e-6, 1.0)
    chi = t_nk / (1669.0 - 122.0 * rh - t_nk)
    plcl = _take(pconv, nk) * torch.pow(rh, chi)
    ok2 = (plcl >= 200.0) & (plcl < 2000.0)

    # ---- first level above LCL (ICB) ----
    above_lcl = (pconv < plcl[:, None]) & (lev[None, :] > nk[:, None])
    icb = torch.where(above_lcl.any(dim=1),
                      torch.argmax(above_lcl.to(torch.int32), dim=1), nl - 2)
    icb = torch.clamp(icb, max=nl - 2)
    ok3 = icb < nl - 2

    # ---- lifted parcel (TLIFT) ----
    gz_nk = _take(gz, nk)
    ah0 = (CPD * (1.0 - q_nk) + CL_W * q_nk) * t_nk \
        + q_nk * (LV0 - CPVMCL * (t_nk - 273.15)) + gz_nk
    cpp = CPD * (1.0 - q_nk) + q_nk * CPV
    tpk_dry = t_nk[:, None] - (gz - gz_nk[:, None]) / cpp[:, None]
    tvp_dry = tpk_dry * (1.0 + q_nk[:, None] * EPSI)
    tvp_sat, tpk_sat, clw_sat = _tlift_sat(
        tconv, qconv, qsconv, pconv, gz, q_nk[:, None], ah0[:, None])
    sat_zone = lev[None, :] >= icb[:, None]
    tvp = torch.where(sat_zone, tvp_sat, tvp_dry)
    tp = torch.where(sat_zone, tpk_sat, tpk_dry)
    clw = torch.where(sat_zone, clw_sat, torch.zeros_like(clw_sat))
    # water-loading correction (convect43c.f90:478-480,529-531)
    tvp = tvp - tp * q_nk[:, None]

    tvp_icb = _take(tvp, icb)
    tv_icb = _take(tv, icb)
    stable = (cbmf0 == 0.0) & (tvp_icb <= tv_icb - DTMAX_C)

    # ---- precipitation efficiency (convect43c.f90:506-524) ----
    tca = tp - 273.15
    elacrit = torch.where(
        tca >= 0.0, torch.full_like(tca, ELCRIT),
        torch.clamp(ELCRIT * (1.0 - true_div(tca, TLCRIT)), min=0.0))
    ep = torch.clamp(0.999 * (1.0 - elacrit / torch.clamp(clw, min=1e-8)),
                     0.0, 0.999)
    ep = torch.where(lev[None, :] <= nk[:, None], torch.zeros_like(ep), ep)

    # ---- CAPE scan -> INB / INB1 (convect43c.f90:556-576) ----
    by = (tvp - tv) * dph / pconv
    in_scan = (lev[None, :] >= icb[:, None] + 1) & (lev[None, :] <= nl - 2)
    by_m = torch.where(in_scan, by, torch.zeros_like(by))
    cape_cum = _seq_cumsum(by_m, 1)
    inb1 = torch.amax(torch.where(in_scan & (by >= 0.0), lev[None, :] + 1, 0),
                      dim=1)
    inb1 = torch.maximum(inb1, icb + 1)
    pos = in_scan & (cape_cum > 0.0)
    last_pos = torch.amax(torch.where(pos, lev[None, :], -1), dim=1)
    has_cape = last_pos >= 0
    inb = torch.maximum(torch.where(has_cape, last_pos + 1, icb + 1), inb1)
    inb = torch.clamp(inb, max=nl - 1)

    # ---- liquid-water static energy of the lifted parcel ----
    in_cloud = (lev[None, :] >= icb[:, None]) & (lev[None, :] <= inb[:, None])
    hp = torch.where(in_cloud,
                     _take(h, nk)[:, None] + (lv + (CPD - CPV) * tconv)
                     * ep * clw, h)

    # ---- cloud-base mass flux relaxation (convect43c.f90:592-614) ----
    icbm = torch.clamp(icb - 1, min=0)
    tvp_icbm = _take(tvp, icbm)
    p_icbm = _take(pconv, icbm)
    tvpplcl = tvp_icbm - RD * tvp_icbm * (p_icbm - plcl) \
        / (_take(cpn, icbm) * p_icbm)
    p_icb = _take(pconv, icb)
    icb1 = torch.clamp(icb + 1, max=nl)
    tvaplcl = tv_icb + (tvp_icb - _take(tvp, icb1)) * (plcl - p_icb) \
        / torch.clamp(p_icb - _take(pconv, icb1), min=1e-3)
    pbl_zone = (lev[None, :] >= nk[:, None]) & (lev[None, :] < icb[:, None])
    dtpbl = _seq_sum(torch.where(pbl_zone, (tvp - tv) * dph,
                                 torch.zeros_like(tv)), 1) \
        / torch.clamp(_take(phconv[:, :L1], nk) - _take(phconv[:, :L1], icb),
                      min=1e-3)
    dtma = tvpplcl - tvaplcl + DTMAX_C + dtpbl
    damps = DAMP * 3.0        # DAMP*DELT/DELT0 with DELT0 = DELT/3
    cbmf = torch.clamp((1.0 - damps) * cbmf0 + 0.1 * ALPHA * dtma, min=0.0)
    any_flux = (cbmf > 0.0) | (cbmf0 > 0.0)
    valid = ok0 & ok2 & ok3 & (~stable) & any_flux

    # ---- updraft mass fractions M(i) (convect43c.f90:620-634) ----
    k_idx = torch.minimum(lev[None, :], inb1[:, None])
    dbo = torch.abs(torch.gather(tv, 1, k_idx) - torch.gather(tvp, 1, k_idx)) \
        + ENTP * 0.02 * torch.gather(dph, 1, k_idx)
    m_zone = (lev[None, :] >= icb[:, None] + 1) \
        & (lev[None, :] <= inb[:, None])
    dbo = torch.where(m_zone, dbo, torch.zeros_like(dbo))
    m_flux = cbmf[:, None] * dbo \
        / torch.clamp(_seq_sum(dbo, 1), min=1e-30)[:, None]

    # ---- entrainment: SIJ / MENT (convect43c.f90:640-711) ----
    qti = q_nk[:, None] - ep * clw                   # indexed by i
    lv_j, t_j, qs_j, q_j = (a[:, None, :] for a in (lv, tconv, qsconv,
                                                    qconv))
    q_i, h_i, hp_i, qti_i = (a[:, :, None] for a in (qconv, h, hp, qti))
    h_j = h[:, None, :]
    bf2 = 1.0 + lv_j * lv_j * qs_j / (RV * t_j * t_j * CPD)
    anum = h_j - hp_i + (CPV - CPD) * t_j * (qti_i - q_j)
    denom = h_i - hp_i + (CPD - CPV) * (q_i - qti_i) * t_j
    dei = torch.where(torch.abs(denom) < 0.01, torch.full_like(denom, 0.01),
                      denom)
    sij = anum / dei
    sij = sij * (1 - eye_f) + eye_f
    altem = (sij * q_i + (1.0 - sij) * qti_i - qs_j) / bf2
    cwat = (clw * (1.0 - ep))[:, None, :]
    j_gt_i = (lev[None, :] > lev[:, None])[None]
    redo = ((sij < 0.0) | (sij > 1.0) | (altem > cwat)) & j_gt_i
    anum2 = anum - lv_j * (qti_i - qs_j - cwat * bf2)
    denom2 = denom + lv_j * (q_i - qti_i)
    denom2 = torch.where(torch.abs(denom2) < 0.01,
                         torch.full_like(denom2, 0.01), denom2)
    sij2 = anum2 / denom2
    sij = torch.where(redo, sij2, sij)
    del altem, anum, denom, dei, anum2, denom2, sij2, redo

    ij_zone = m_zone[:, :, None] & in_cloud[:, None, :]
    mixed = (sij > 0.0) & (sij < 0.9) & ij_zone & (~eye)
    ment = torch.where(mixed, m_flux[:, :, None] / (1.0 - sij),
                       torch.zeros_like(sij))
    nent = mixed.sum(dim=2)
    sij = torch.clamp(sij, 0.0, 1.0)
    sij = sij * (1 - eye_f) + eye_f

    # detrain-at-level fallback (convect43c.f90:704-711)
    no_ent = (nent == 0) & m_zone
    ment = torch.where(no_ent[:, :, None] & eye,
                       m_flux[:, :, None].expand(-1, -1, L1), ment)

    # ---- normalize to equal mixing probability (convect43c.f90:717-769):
    # weight w(I,J) from the spacing of SIJ around SCRIT; the running
    # minimum over j is a loop over j, the lax.scan's order
    qp1 = qti
    anum_s = h - hp - lv * (qp1 - qsconv)
    denom_s = h - hp + lv * (qconv - qp1)
    denom_s = torch.where(torch.abs(denom_s) < 0.01,
                          torch.full_like(denom_s, 0.01), denom_s)
    scrit = anum_s / denom_s
    alt = qp1 - qsconv + scrit * (qconv - qp1)
    scrit = torch.clamp(torch.where(alt < 0.0, torch.ones_like(scrit), scrit),
                        min=0.0)                     # (C, L1) by i

    zero_col = torch.zeros((C, L1, 1), dtype=sij.dtype, device=dev)
    sij_jp = torch.cat([sij[:, :, 1:], zero_col], dim=2)
    sij_jm = torch.cat([zero_col, sij[:, :, :-1]], dim=2)
    smin = torch.ones((C, L1), dtype=sij.dtype, device=dev)
    zero = torch.zeros_like(smin)
    w_all = []
    for j in range(L1):
        s_j = sij[:, :, j]
        s_jp = sij_jp[:, :, j]
        s_jm = sij_jm[:, :, j]
        in_range = (s_j > 0.0) & (s_j < 0.9)
        gt = (j > lev)[None, :]                      # j > i
        smid_g = torch.minimum(s_j, scrit)
        new_min = (smid_g < smin) & (s_jp < smid_g)
        sjmax_g = torch.where(new_min, torch.minimum(torch.minimum(s_jp, s_j),
                                                     scrit), smid_g)
        sjmin_g = torch.where(new_min, torch.minimum(torch.maximum(s_jm, s_j),
                                                     scrit), smid_g)
        smin = torch.where(in_range & gt & new_min, smid_g, smin)
        smid_l = torch.maximum(s_j, scrit)
        sjmax_l = torch.maximum(s_jp, scrit)
        sjmin_l = torch.maximum(s_jm if j > 0 else zero, scrit)
        smid = torch.where(gt, smid_g, smid_l)
        sjmax = torch.where(gt, sjmax_g, sjmax_l)
        sjmin = torch.where(gt, sjmin_g, sjmin_l)
        w_all.append(torch.where(in_range, torch.abs(sjmax - smid)
                                 + torch.abs(sjmin - smid), zero))
    w_all = torch.stack(w_all, dim=2)                # (C, i, j)
    del sij, sij_jp, sij_jm
    w_dph = w_all * dph[:, None, :] * in_cloud[:, None, :].to(w_all.dtype)
    del w_all
    asij = torch.clamp(_seq_sum(w_dph, 2), min=1e-21)[:, :, None]
    ment_n = ment * w_dph / asij
    has_ent = (nent != 0)[:, :, None]
    ment = torch.where(has_ent, ment_n, ment)
    del ment_n, w_dph
    bsum = _seq_sum(torch.where(in_cloud[:, None, :], ment,
                                torch.zeros_like(ment)), 2)
    dead = (nent != 0) & (bsum < 1e-18) & m_zone
    ment = torch.where(dead[:, :, None],
                       torch.where(eye, m_flux[:, :, None],
                                   torch.zeros_like(ment)),
                       ment)

    # ---- saturated up/downdraft fluxes per level (convect43c.f90:879-917):
    # FUP(i) = [i>=NK] sum_{k>i} M(k) + sum_{k<=i, j>i} MENT(k,j)
    # FDOWN(i) = sum_{k<i} sum_{j>=i} MENT(j,k)
    mask_j_gt_i = lev[None, None, :] > lev[None, :, None]
    m_above = _seq_sum(torch.where(mask_j_gt_i, m_flux[:, None, :],
                                   torch.zeros_like(ment)), 2)
    m_above = torch.where(lev[None, :] >= nk[:, None], m_above,
                          torch.zeros_like(m_above))
    ment_k_to_i = _seq_cumsum(ment, 1)               # sum over first idx <= i
    fup = m_above + _seq_sum(torch.where(mask_j_gt_i, ment_k_to_i,
                                         torch.zeros_like(ment)), 2)
    del ment_k_to_i
    ment_j_from_i = _seq_cumsum(ment.flip(1), 1).flip(1)
    mask_k_lt_i = lev[None, None, :] < lev[None, :, None]
    fdown = _seq_sum(torch.where(mask_k_lt_i, ment_j_from_i,
                                 torch.zeros_like(ment)), 2)
    del ment_j_from_i

    # ---- displacement matrix + subsidence (convect43c.f90:1009-1032) ----
    nk_onehot = torch.nn.functional.one_hot(nk, L1).to(ment.dtype)
    fmass = ment + nk_onehot[:, :, None] * m_flux[:, None, :]
    conv_box = lev[None, :] <= (inb[:, None] + 1)
    fmass = torch.where(conv_box[:, :, None] & conv_box[:, None, :]
                        & valid[:, None, None], fmass, torch.zeros_like(fmass))
    big = fmass > EPSILON
    lev_ij = torch.maximum(lev[None, None, :], lev[None, :, None])
    nctop = torch.amax(torch.where(big, lev_ij, 0), dim=(1, 2)) + 1
    nctop = torch.clamp(nctop, max=nl - 1)
    sub = torch.zeros_like(pconv)
    sub[:, 1:] = fup[:, :-1] - fdown[:, 1:]
    sub = torch.where(valid[:, None], sub, torch.zeros_like(sub))

    cbmf_out = torch.where(ok0 & ok2 & ok3, cbmf, torch.zeros_like(cbmf))
    cbmf_out = torch.where(stable & ok0 & ok2 & ok3, cbmf0, cbmf_out)
    return fmass, sub, cbmf_out, valid, nctop.to(torch.int32)


def fmassfrac_from_fmass(fmass, sub, dpr_pa, delt, nl: int):
    """calcmatrix.f90:118-135: scale by the timestep and put the
    non-displaced remainder on the diagonal.  dpr_pa (C, L1) in Pa."""
    rlevmass = true_div(dpr_pa, GA)                  # (C, L1) kg/m2
    f = delt * fmass
    rowsum = _seq_sum(f, 2)
    L1 = nl + 1
    eye = torch.eye(L1, dtype=f.dtype, device=f.device)[None]
    f = f + eye * (rlevmass - rowsum)[:, :, None]
    return f, rlevmass


def build_conv_profiles(akz, bkz, akm, bkm, ps, tth, qvh, tt2, td2):
    """convmix.f90:168-189 profile extraction (0-based): profile level k
    uses eta full level k+1 (the ground level is skipped).  The grid
    coefficients are float32 tensors of (nlev,) on the fields' device.

    Returns (pconv_hpa (C,L1), phconv_hpa (C,L2), tconv, qconv, dpr_pa)
    flattened over the grid; L1 = nlev-1 here (callers slice to nl+1)."""
    nlev = tth.shape[0]
    C = ps.numel()
    psf = ps.reshape(1, C)
    pconv = akz[1:, None] + bkz[1:, None] * psf      # (nlev-1, C) Pa
    phconv = torch.cat([psf, akm[1:, None] + bkm[1:, None] * psf], dim=0)
    tconv = tth.reshape(nlev, C)[1:]
    qconv = qvh.reshape(nlev, C)[1:]
    dpr = phconv[:-1] - phconv[1:]                   # (nlev-1, C) Pa
    return (true_div(pconv.T, 100.0), true_div(phconv.T, 100.0), tconv.T,
            qconv.T, dpr.T)


def _uvzlev(phconv_hpa, pconv_hpa, tconv, qconv, tt2, td2, ps):
    """Heights AGL of the half levels by hypsometric integration of
    virtual temperature (redist.f90:46-100).  Returns (C, L1+1)."""
    C, L1 = pconv_hpa.shape
    const = R_AIR / GA
    tvold = tt2 * (1.0 + 0.378 * ew(td2) / ps)       # (C,)
    tvfull = tconv * (1.0 + 0.608 * qconv)           # (C, L1)
    # virtual T at half level k+1 (between full levels k and k+1)
    tv_half = tvfull[:, :-1] + (tvfull[:, 1:] - tvfull[:, :-1]) \
        * (pconv_hpa[:, :-1] - phconv_hpa[:, 1:L1]) \
        / (pconv_hpa[:, :-1] - pconv_hpa[:, 1:])
    tv_seq = torch.cat([tvold[:, None], tv_half], dim=1)   # (C, L1)
    p_seq = phconv_hpa                                     # (C, L1+1)

    def hyps(tv_lo, tv_hi, p_lo, p_hi):
        dlnp = torch.log(torch.clamp(p_lo, min=1e-3)
                         / torch.clamp(p_hi, min=1e-3))
        ratio = torch.where(torch.abs(tv_hi - tv_lo) > 0.2,
                            (tv_hi - tv_lo)
                            / torch.log(torch.clamp(tv_hi, min=1.0)
                                        / torch.clamp(tv_lo, min=1.0)),
                            tv_hi)
        return const * dlnp * ratio

    dz = hyps(tv_seq[:, :-1], tv_seq[:, 1:], p_seq[:, :-2], p_seq[:, 1:-1])
    uvz = torch.cat([torch.zeros((C, 1), dtype=dz.dtype, device=dz.device),
                     _seq_cumsum(dz, 1)], dim=1)           # (C, L1)
    # top half-level height (one more step using tv of the last full level)
    dz_top = hyps(tv_seq[:, -1], tvfull[:, -1], p_seq[:, -2], p_seq[:, -1])
    return torch.cat([uvz, uvz[:, -1:] + dz_top[:, None]], dim=1)


class ConvectionFields(NamedTuple):
    """What the convection kernel gives per step, shaped (C, ...) over the
    flattened grid columns, in the JAX function's order."""
    fmassfrac: torch.Tensor   # (C, L1, L1) f32
    rlevmass: torch.Tensor    # (C, L1)
    phconv: torch.Tensor      # (C, L1+1) hPa
    pconv: torch.Tensor       # (C, L1) hPa
    tconv: torch.Tensor       # (C, L1)
    sub: torch.Tensor         # (C, L1)
    uvzlev: torch.Tensor      # (C, L1+1) m
    lconv: torch.Tensor       # (C,) bool
    nctop: torch.Tensor       # (C,) int32
    cbmf: torch.Tensor        # (C,) f32, the flux memory of the next step


_ETA_INPUTS = ("ps", "tth", "qvh", "tt2", "td2")


class ConvectionKernel:
    """The grid's convection step (``make_convection_kernel``):
    ``kernel(eta0_ps, eta0_tth, eta0_qvh, eta0_tt2, eta0_td2, eta1_ps, ...,
    tw0, tw1, cbmf, delt) -> ConvectionFields``, K6 for CUDA tensors and the
    plain pipeline for CPU tensors.  ``tw0``, ``tw1`` and ``delt`` are
    float32 values in Python floats."""

    def __init__(self, grid):
        self.nl = nconvlev_from_grid(grid.akz, grid.bkz, grid.nlev)
        self.nlev = grid.nlev
        self._coef = {name: np.asarray(getattr(grid, name), np.float32)
                      for name in ("akz", "bkz", "akm", "bkm")}
        self._on: dict = {}

    @property
    def L1(self) -> int:
        return self.nl + 1

    def coefficients(self, device) -> tuple[torch.Tensor, ...]:
        """akz, bkz, akm, bkm as float32 tensors on ``device`` (kept)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(
                torch.as_tensor(self._coef[k], device=device)
                for k in ("akz", "bkz", "akm", "bkm"))
        return self._on[device]

    def __call__(self, *args) -> ConvectionFields:
        fields, (tw0, tw1, cbmf, delt) = args[:10], args[10:]
        dev = cbmf.device
        if dev.type == "cuda":
            return convection_cuda(self, fields, tw0, tw1, cbmf, delt)
        if dev.type == "cpu":
            return convection_plain(self, fields, tw0, tw1, cbmf, delt)
        raise ValueError(f"no convection backend for device {dev}")


def make_convection_kernel(grid) -> ConvectionKernel:
    """Bind the grid's coefficients; see ``ConvectionKernel``."""
    return ConvectionKernel(grid)


def convection_plain(kern: ConvectionKernel, fields, tw0: float, tw1: float,
                     cbmf, delt: float) -> ConvectionFields:
    """The plain PyTorch version of K6: the time interpolation, the
    profiles, the scheme, the displacement matrix and the half-level
    heights of every column."""
    e0, e1 = fields[:5], fields[5:]
    ps, tth, qvh, tt2, td2 = (a * tw0 + b * tw1 for a, b in zip(e0, e1))
    L1 = kern.L1
    pconv, phconv, tconv, qconv, dpr = build_conv_profiles(
        *kern.coefficients(ps.device), ps, tth, qvh, tt2, td2)
    pconv = pconv[:, :L1]
    phconv = phconv[:, :L1 + 1]
    tconv = tconv[:, :L1]
    qconv = qconv[:, :L1]
    dpr = dpr[:, :L1]
    fmass, sub, cbmf_new, lconv, nctop = convect_columns(
        pconv, phconv, tconv, qconv, cbmf, kern.nl)
    fmassfrac, rlevmass = fmassfrac_from_fmass(fmass, sub, dpr, delt, kern.nl)
    uvzlev = _uvzlev(phconv, pconv, tconv, qconv, tt2.reshape(-1),
                     td2.reshape(-1), true_div(ps.reshape(-1), 100.0))
    # contiguous, as K6 writes them (the profiles are transposed views)
    return ConvectionFields(*(a.contiguous() for a in (
        fmassfrac, rlevmass, phconv, pconv, tconv, sub, uvzlev, lconv, nctop,
        cbmf_new)))


def convection_cuda(kern: ConvectionKernel, fields, tw0: float, tw1: float,
                    cbmf, delt: float) -> ConvectionFields:
    """K6 launch: one block per grid column, every output written once."""
    dev = cbmf.device
    nlev = kern.nlev
    ps0 = fields[0]
    ny, nx = ps0.shape
    C = ny * nx
    L1 = kern.L1
    for name, a in zip(_ETA_INPUTS * 2, fields):
        shape = (nlev, ny, nx) if name in ("tth", "qvh") else (ny, nx)
        if a.device != dev or a.dtype != torch.float32 \
                or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"K6: {name} must be contiguous float32 {shape} "
                             f"on {dev}")
    if cbmf.dtype != torch.float32 or tuple(cbmf.shape) != (C,) \
            or not cbmf.is_contiguous():
        raise ValueError(f"K6: cbmf must be contiguous float32 ({C},)")
    if L1 > K6_MAX_LEVELS:
        raise ValueError(f"K6 takes at most {K6_MAX_LEVELS} profile levels "
                         f"(its shared memory); this grid has nl + 1 = {L1}")

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    res = ConvectionFields(
        fmassfrac=out(C, L1, L1), rlevmass=out(C, L1), phconv=out(C, L1 + 1),
        pconv=out(C, L1), tconv=out(C, L1), sub=out(C, L1),
        uvzlev=out(C, L1 + 1), lconv=out(C, dtype=torch.bool),
        nctop=out(C, dtype=torch.int32), cbmf=out(C))
    if C == 0:
        return res
    akz, bkz, akm, bkm = kern.coefficients(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.CONVECTION(
            *(a.data_ptr() for a in fields), akz.data_ptr(), bkz.data_ptr(),
            akm.data_ptr(), bkm.data_ptr(), cbmf.data_ptr(),
            C, nlev, kern.nl, tw0, tw1, delt,
            *(getattr(res, f).data_ptr() for f in ConvectionFields._fields),
            stream)
    return res


# ------------------------------------------------------------- redist --

def redist_particles(p: Particles, key: rng.Key, fmassfrac, rlevmass,
                     phconv_hpa, sub, uvzlev, pconv_hpa, tconv, lconv,
                     lsynctime: int, itime: int, nl: int, nx: int, ny: int,
                     rn: torch.Tensor | None = None):
    """redist.f90 for a forward run: the categorical draw of each live
    particle's destination level from its column's matrix row, and
    compensating subsidence for the others.  K7 for particles on a CUDA
    device, the plain version on the CPU.  ``rn`` (n,) injects the uniform
    draws; without it they come from the Philox stream of ``key`` under
    ``REDIST_TAG`` (counter: the slot).  Returns (particles, moved count as
    a () int32 tensor on the device)."""
    dev = p.device
    run = {"cuda": redist_cuda, "cpu": redist_plain}.get(dev.type)
    if run is None:
        raise ValueError(f"no redistribution backend for device {dev}")
    return run(p, key, fmassfrac, rlevmass, phconv_hpa, sub, uvzlev,
               pconv_hpa, tconv, lconv, lsynctime, itime, nl, nx, ny, rn)


def redist_plain(p, key, fmassfrac, rlevmass, phconv_hpa, sub, uvzlev,
                 pconv_hpa, tconv, lconv, lsynctime, itime, nl, nx, ny,
                 rn=None):
    """The plain PyTorch version of K7 (the JAX function for ldirect = 1,
    with the level sums in level order and the gathers clamped where JAX
    clamps)."""
    L1 = nl + 1
    n = p.capacity
    dev = p.device
    x, y, z = p.x, p.y, p.z
    # jnp.round and torch.round both round half to even
    ix = torch.clamp(torch.round(x).to(torch.int64), 0, nx - 1)
    jy = torch.clamp(torch.round(y).to(torch.int64), 0, ny - 1)
    col = jy * nx + ix

    live = p.active & (p.itra == itime) & lconv[col]
    uvz_p = uvzlev[col]                               # (N, L1+1)
    # levold: uvzlev[kz] is the LOWER boundary of cell kz (0-based);
    # reference: first kz in [2, nconvtop] with uvzlev(kz) >= z -> kz-1
    levold = torch.clamp((uvz_p[:, 1:L1] < z[:, None]).sum(dim=1), 0, L1 - 1)

    def at(a, idx):
        return torch.gather(a, 1, idx[:, None])[:, 0]

    in_dom = z < at(uvz_p, torch.clamp(levold + 1, max=L1))
    live = live & in_dom

    row = fmassfrac[col, levold]                      # (N, L1)
    totmass = torch.clamp(rlevmass[col, levold], min=1e-30)
    frac = _seq_cumsum(row / totmass[:, None], 1)
    if rn is None:
        k0, k1 = key.philox_key(REDIST_TAG)
        rn = rng.uniforms_plain(n, k0, k1, dev)
    hit = frac >= rn[:, None]
    levnew = torch.where(hit.any(dim=1),
                         torch.argmax(hit.to(torch.int32), dim=1), levold)
    moved = live & (levnew != levold)

    # new z inside destination cell, uniform in mass => linear in
    # (ffraction - rn) within the cell, log-p interpolated
    ffrac_at = at(frac, levnew)
    f_at = at(row, levnew)
    dlevfrac = torch.where(ffrac_at > 1e-20,
                           (ffrac_at - rn) * totmass
                           / torch.clamp(f_at * totmass, min=1e-30),
                           torch.full_like(ffrac_at, 0.5))
    dlevfrac = torch.clamp(dlevfrac, 0.0, 1.0)
    ph_p = phconv_hpa[col]                            # (N, L1+1)
    lo = at(ph_p, levnew)
    hi = at(ph_p, torch.clamp(levnew + 1, max=L1))
    # note hi < lo (pressure decreases upward): dz1, dz2, dz all negative,
    # signs cancel in the weighted mean (redist.f90:146-152)
    log_hi, log_lo = torch.log(hi), torch.log(lo)
    dlogp = (1.0 - dlevfrac) * (log_hi - log_lo)
    pint = log_lo + dlogp
    dz1 = pint - log_lo
    dz2 = log_hi - pint
    dz = dz1 + dz2
    dz = torch.where(torch.abs(dz) > 1e-20, dz, torch.full_like(dz, -1e-20))
    z_lo = at(uvz_p, levnew)
    z_hi = at(uvz_p, torch.clamp(levnew + 1, max=L1))
    z_new = torch.abs((z_lo * dz2 + z_hi * dz1) / dz)

    # compensating subsidence for non-redistributed particles
    # (redist.f90:170-215)
    sub_p = sub[col]                                  # (N, L1)
    dpr_p = rlevmass[col] * GA                        # back to Pa
    t_p, p_p, ph_l = tconv[col], pconv_hpa[col], ph_p[:, :L1]

    def wsub_at(levi):
        """-sub/(1-sub/dpr*g) * R * T(half) / p(half) at half level levi."""
        levim = torch.clamp(levi - 1, min=0)
        tk = at(t_p, levim)
        tk1 = at(t_p, levi)
        pk = at(p_p, levim)
        pk1 = at(p_p, levi)
        phk = at(ph_l, levi)
        t_half = tk + (tk1 - tk) * (pk - phk) / torch.clamp(pk - pk1, min=1e-3)
        s = at(sub_p, levi)
        d = at(dpr_p, levi)
        s_eff = s / torch.clamp(1.0 - s / d * GA, min=1e-3)
        # phconv in Pa here (redist.f90:186 uses the Pa array)
        return -s_eff * R_AIR * t_half / torch.clamp(phk * 100.0, min=1e-3)

    w_lo = torch.where(levold > 0, wsub_at(torch.clamp(levold, min=1)),
                       torch.zeros_like(z))
    w_hi = wsub_at(torch.clamp(levold + 1, max=L1 - 1))
    z_l = at(uvz_p, levold)
    z_h = at(uvz_p, torch.clamp(levold + 1, max=L1))
    d1 = z - z_l
    d2 = torch.clamp(z_h - z, min=0.0)
    wpart = (d2 * w_lo + d1 * w_hi) / torch.clamp(d1 + d2, min=1e-30)
    z_sub = torch.abs(z + wpart * float(np.float32(lsynctime)))

    z_out = torch.where(moved, z_new, torch.where(live, z_sub, z))
    return p.replace(z=z_out), moved.sum(dtype=torch.int32)


def redist_cuda(p, key, fmassfrac, rlevmass, phconv_hpa, sub, uvzlev,
                pconv_hpa, tconv, lconv, lsynctime, itime, nl, nx, ny,
                rn=None):
    """K7 launch: one thread per particle, z written out of place, the
    moved count summed by one ballot and one atomic per warp."""
    L1 = nl + 1
    n = p.capacity
    dev = p.device
    C = nx * ny
    if n >= 2 ** 31:
        raise ValueError("K7 indexes particles with int32")
    shapes = {"fmassfrac": (C, L1, L1), "rlevmass": (C, L1),
              "phconv": (C, L1 + 1), "sub": (C, L1), "uvzlev": (C, L1 + 1),
              "pconv": (C, L1), "tconv": (C, L1), "lconv": (C,)}
    tensors = dict(fmassfrac=fmassfrac, rlevmass=rlevmass, phconv=phconv_hpa,
                   sub=sub, uvzlev=uvzlev, pconv=pconv_hpa, tconv=tconv,
                   lconv=lconv)
    for name, t in tensors.items():
        dt = torch.bool if name == "lconv" else torch.float32
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shapes[name] \
                or not t.is_contiguous():
            raise ValueError(f"K7: {name} must be contiguous {dt} "
                             f"{shapes[name]} on {dev}")
    want = {"itra": torch.int32, "active": torch.bool}
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "itra", "active"):
        t = getattr(p, name)
        if t.device != dev or t.dtype != want.get(name, torch.float32) \
                or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"K7: particle field {name} must be contiguous "
                             f"({n},) on {dev}")
    if rn is not None and (rn.device != dev or rn.dtype != torch.float32
                           or tuple(rn.shape) != (n,)):
        raise ValueError(f"K7: injected uniforms must be float32 ({n},) on "
                         f"{dev}")
    z_out = torch.empty_like(p.z)
    moved = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return p.replace(z=z_out), moved[0]
    k0, k1 = key.philox_key(REDIST_TAG)
    held = rn.contiguous() if rn is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.REDIST(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), p.itra.data_ptr(),
            p.active.data_ptr(), *(tensors[k].data_ptr() for k in (
                "fmassfrac", "rlevmass", "phconv", "sub", "uvzlev", "pconv",
                "tconv", "lconv")),
            None if held is None else held.data_ptr(),
            n, nx, ny, L1, itime, float(np.float32(lsynctime)), k0, k1,
            z_out.data_ptr(), moved.data_ptr(), stream)
    return p.replace(z=z_out), moved[0]

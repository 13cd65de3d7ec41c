"""Hanna (1982) boundary-layer turbulence, branch-free (port of
``flexpart_tpu/core/hanna.py``): all three stability regimes are computed
and combined with ``torch.where``, expression for expression as in JAX."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Turb:
    sigu: torch.Tensor
    sigv: torch.Tensor
    sigw: torch.Tensor
    dsigwdz: torch.Tensor    # d(sigw)/dz   (hanna form)
    dsigw2dz: torch.Tensor   # d(sigw^2)/dz (hanna1 form)
    tlu: torch.Tensor
    tlv: torch.Tensor
    tlw: torch.Tensor


def _regimes(h, ol):
    neutral = h / torch.abs(ol) < 1.0
    unstable = (~neutral) & (ol < 0.0)
    stable = (~neutral) & (~unstable)
    return neutral, unstable, stable


def _tlw_unstable(z, zeta, ol, h, sigw):
    """Unstable-regime TL_w (hanna.f90:76-83)."""
    sigw = torch.clamp(sigw, min=1.0e-6)
    t1 = 0.1 * z / (sigw * (0.55 - 0.38 * torch.abs(z / ol)))
    t2 = 0.59 * z / sigw
    t3 = 0.15 * h / sigw * (1.0 - torch.exp(-5.0 * zeta))
    return torch.where(z < torch.abs(ol), t1, torch.where(zeta < 0.1, t2, t3))


def _small_ol(ol):
    return torch.where(torch.abs(ol) < 1e-6, torch.sign(ol) * 1e-6 + 1e-12, ol)


def hanna(z, h, ust, wst, ol) -> Turb:
    """turbswitch form (hanna.f90): drift uses dsigwdz."""
    zeta = torch.clamp(z / h, 0.0, 1.0)
    ust = torch.clamp(ust, min=1.0e-4)
    ols = _small_ol(ol)
    neutral, unstable, stable = _regimes(h, ols)

    corr = z / ust
    sigu_n = 1.0e-2 + 2.0 * ust * torch.exp(-3.0e-4 * corr)
    sigw_n0 = 1.3 * ust * torch.exp(-2.0e-4 * corr)
    dsigwdz_n = -2.0e-4 * sigw_n0
    sigw_n = sigw_n0 + 1.0e-2
    tlu_n = 0.5 * z / sigw_n / (1.0 + 1.5e-3 * corr)

    sigu_u = 1.0e-2 + ust * torch.pow(12.0 - 0.5 * h / ols, 1.0 / 3.0)
    zeta_c = torch.clamp(zeta, min=1.0e-3)
    sigw_u = torch.sqrt(torch.clamp(
        1.2 * wst ** 2 * (1.0 - 0.9 * zeta) * torch.pow(zeta_c, 2.0 / 3.0)
        + (1.8 - 1.4 * zeta) * ust ** 2, min=1e-12)) + 1.0e-2
    dsigwdz_u = 0.5 / sigw_u / h * (
        -1.4 * ust ** 2 + wst ** 2
        * (0.8 * torch.pow(zeta_c, -1.0 / 3.0)
           - 1.8 * torch.pow(zeta_c, 2.0 / 3.0)))
    tlu_u = 0.15 * h / sigu_u
    tlw_u = _tlw_unstable(z, zeta, ols, h, sigw_u)

    sigu_s = 1.0e-2 + 2.0 * ust * (1.0 - zeta)
    sigv_s = 1.0e-2 + 1.3 * ust * (1.0 - zeta)
    dsigwdz_s = -1.3 * ust / h
    tlu_s = 0.15 * h / torch.clamp(sigu_s, min=1e-6) * torch.sqrt(zeta_c)
    tlw_s = 0.1 * h / torch.clamp(sigv_s, min=1e-6) * torch.pow(zeta_c, 0.8)

    w = torch.where
    sigu = w(neutral, sigu_n, w(unstable, sigu_u, sigu_s))
    sigv = w(neutral, sigw_n, w(unstable, sigu_u, sigv_s))
    sigw = w(neutral, sigw_n, w(unstable, sigw_u, sigv_s))
    dsigwdz = w(neutral, dsigwdz_n, w(unstable, dsigwdz_u, dsigwdz_s))
    tlu = w(neutral, tlu_n, w(unstable, tlu_u, tlu_s))
    tlv = w(stable, 0.467 * tlu_s, tlu)
    tlw = w(neutral, tlu_n, w(unstable, tlw_u, tlw_s))

    tlu = torch.clamp(tlu, min=10.0)
    tlv = torch.clamp(tlv, min=10.0)
    tlw = torch.clamp(tlw, min=30.0)
    dsigwdz = w(dsigwdz == 0.0, torch.full_like(dsigwdz, 1.0e-10), dsigwdz)
    return Turb(sigu, sigv, sigw, dsigwdz, torch.zeros_like(sigw),
                tlu, tlv, tlw)


def hanna1(z, h, ust, wst, ol) -> Turb:
    """non-turbswitch form (hanna1.f90): wp in m/s, drift uses dsigw2dz."""
    zeta = torch.clamp(z / h, 0.0, 1.0)
    ust = torch.clamp(ust, min=1.0e-4)
    ols = _small_ol(ol)
    neutral, unstable, stable = _regimes(h, ols)

    corr = z / ust
    sigu_n = torch.clamp(2.0 * ust * torch.exp(-3.0e-4 * corr), min=1.0e-5)
    sigv_n = torch.clamp(1.3 * ust * torch.exp(-2.0e-4 * corr), min=1.0e-5)
    dsigw2dz_n = -6.76e-4 * ust * torch.exp(-4.0e-4 * corr)
    tlu_n = 0.5 * z / sigv_n / (1.0 + 1.5e-3 * corr)

    sigu_u = torch.clamp(ust * torch.pow(12.0 - 0.5 * h / ols, 1.0 / 3.0),
                         min=1.0e-6)
    zeta_c = torch.clamp(zeta, min=1.0e-4)
    a = torch.clamp(3.0 * zeta_c - ols / h, min=1e-8)
    s1 = 0.96 * torch.pow(a, 1.0 / 3.0)
    ds1 = 1.8432 * wst * wst / h * torch.pow(a, -1.0 / 3.0)
    s2 = 0.763 * torch.pow(zeta_c, 0.175)
    ds2 = 0.203759 * wst * wst / h * torch.pow(zeta_c, -0.65)
    omz = torch.clamp(1.0 - zeta, min=1e-6)
    s3 = 0.722 * torch.pow(omz, 0.207)
    ds3 = -0.215812 * wst * wst / h * torch.pow(omz, -0.586)
    s4 = torch.full_like(zeta, 0.37)
    ds4 = torch.zeros_like(zeta)

    use_s1 = zeta < 0.03
    use_s12 = (zeta >= 0.03) & (zeta < 0.4)
    pick_s1 = s1 < s2
    use_s3 = (zeta >= 0.4) & (zeta < 0.96)
    w = torch.where
    sigw_fac = w(use_s1, s1, w(use_s12, w(pick_s1, s1, s2), w(use_s3, s3, s4)))
    dsigw2dz_u = w(use_s1, ds1,
                   w(use_s12, w(pick_s1, ds1, ds2), w(use_s3, ds3, ds4)))
    sigw_u = torch.clamp(wst * sigw_fac, min=1.0e-6)
    tlu_u = 0.15 * h / sigu_u
    tlw_u = _tlw_unstable(z, zeta, ols, h, sigw_u)

    sigu_s = torch.clamp(2.0 * ust * (1.0 - zeta), min=1.0e-6)
    sigv_s = torch.clamp(1.3 * ust * (1.0 - zeta), min=1.0e-6)
    dsigw2dz_s = 3.38 * ust * ust * (zeta - 1.0) / h
    tlu_s = 0.15 * h / sigu_s * torch.sqrt(torch.clamp(zeta, min=1e-8))
    tlw_s = 0.1 * h / sigv_s * torch.pow(torch.clamp(zeta, min=1e-8), 0.8)

    sigu = w(neutral, sigu_n, w(unstable, sigu_u, sigu_s))
    sigv = w(neutral, sigv_n, w(unstable, sigu_u, sigv_s))
    sigw = w(neutral, sigv_n, w(unstable, sigw_u, sigv_s))
    dsigw2dz = w(neutral, dsigw2dz_n, w(unstable, dsigw2dz_u, dsigw2dz_s))
    tlu = w(neutral, tlu_n, w(unstable, tlu_u, tlu_s))
    tlv = w(stable, 0.467 * tlu_s, tlu)
    tlw = w(neutral, tlu_n, w(unstable, tlw_u, tlw_s))

    tlu = torch.clamp(tlu, min=10.0)
    tlv = torch.clamp(tlv, min=10.0)
    tlw = torch.clamp(tlw, min=30.0)
    return Turb(sigu, sigv, sigw, torch.zeros_like(sigw), dsigw2dz,
                tlu, tlv, tlw)

"""Thermodynamic helpers (port of ``flexpart_tpu/met/thermo.py``):
Goff-Gratch saturation vapour pressure ``ew`` and the enhanced-Teten
saturation specific humidity ``f_qvsat``."""

from __future__ import annotations

import torch


def ew(t: torch.Tensor) -> torch.Tensor:
    """Saturation vapour pressure over water [Pa]; t in K (ew.f90)."""
    y = 373.16 / t
    a = -7.90298 * (y - 1.0) + 5.02808 * 0.43429 * torch.log(y)
    c = (1.0 - 1.0 / y) * 11.344
    c = -1.3816e-7 * (torch.pow(10.0, c) - 1.0)
    d = (1.0 - y) * 3.49149
    d = 8.1328e-3 * (torch.pow(10.0, d) - 1.0)
    return 101324.6 * torch.pow(10.0, a + c + d)


def f_esl(p, t):
    f = 1.0007 + 3.46e-8 * p
    return f * 611.21 * torch.exp(17.502 * (t - 273.15) / (t - 32.18))


def f_esi(p, t):
    f = 1.0003 + 4.18e-8 * p
    return f * 611.15 * torch.exp(22.452 * (t - 273.15) / (t - 0.6))


def f_qvsat(p, t):
    """Saturation specific humidity [kg/kg]; ice branch below 253.15 K."""
    rddrv = 287.0 / 461.0
    es = torch.where(t >= 253.15, f_esl(p, t), f_esi(p, t))
    denom = p - (1.0 - rddrv) * es
    return torch.where(denom == 0.0, torch.ones_like(denom), rddrv * es / denom)


def virtual_temperature_surface(t2, td2, ps):
    return t2 * (1.0 + 0.378 * ew(td2) / ps)

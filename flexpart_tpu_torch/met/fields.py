"""Met-field containers (port of ``flexpart_tpu/met/fields.py``).

A wind-field time level is one stacked 3-D tensor plus one stacked 2-D
tensor, field-major: ``(F, nz, ny, nx)`` / ``(F, ny, nx)``.  The field
indices are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ETA_FIELDS = ("ps", "tt2", "td2", "sshf", "surfstr", "ssr", "lsprec",
              "convprec", "tcc", "sd", "oro", "excessoro", "lsm", "tth",
              "qvh", "uuh", "vvh", "wwh", "clwch")


@dataclasses.dataclass
class EtaFields:
    """Raw fields on hybrid-eta levels, bottom-up, level 0 = ground.
    3-D tensors: (nlev, ny, nx); 2-D: (ny, nx); all float32."""
    ps: torch.Tensor
    tt2: torch.Tensor
    td2: torch.Tensor
    sshf: torch.Tensor
    surfstr: torch.Tensor
    ssr: torch.Tensor
    lsprec: torch.Tensor
    convprec: torch.Tensor
    tcc: torch.Tensor
    sd: torch.Tensor
    oro: torch.Tensor
    excessoro: torch.Tensor
    lsm: torch.Tensor
    tth: torch.Tensor
    qvh: torch.Tensor
    uuh: torch.Tensor
    vvh: torch.Tensor
    wwh: torch.Tensor
    clwch: torch.Tensor


# --- stacked 3-D field indices (ZFields.f3d) ---
F3_U = 0
F3_V = 1
F3_W = 2
F3_RHO = 3
F3_DRHODZ = 4
F3_TT = 5
F3_QV = 6
F3_PV = 7
F3_CLW = 8
NF3 = 9

# --- stacked 2-D field indices (ZFields.f2d) ---
F2_PS = 0
F2_HMIX = 1
F2_TROPO = 2
F2_USTAR = 3
F2_WSTAR = 4
F2_OLI = 5
F2_LSPREC = 6
F2_CONVPREC = 7
F2_TCC = 8
F2_TT2 = 9
F2_TD2 = 10
F2_SD = 11
F2_ORO = 12
F2_EXCESSORO = 13
F2_LSM = 14
F2_CLOUDSH = 15
F2_CTWC = 16
F2_SSR = 17
F2_SSHF = 18
NF2 = 19


@dataclasses.dataclass
class ZFields:
    """One processed wind-field time level on the fixed height grid."""
    f3d: torch.Tensor      # (NF3, nz, ny, nx) float32
    f2d: torch.Tensor      # (NF2, ny, nx) float32
    clouds: torch.Tensor   # (nz, ny, nx) int8
    vdep: torch.Tensor     # (nspec, ny, nx) float32
    height: torch.Tensor   # (nz,) float32

    @property
    def nz(self) -> int:
        return self.f3d.shape[1]

    def replace(self, **kw) -> "ZFields":
        return dataclasses.replace(self, **kw)


def zeros_zfields(nz: int, ny: int, nx: int, nspec: int = 1, *,
                  device: torch.device | str) -> ZFields:
    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ZFields(f3d=z((NF3, nz, ny, nx)), f2d=z((NF2, ny, nx)),
                   clouds=z((nz, ny, nx), torch.int8),
                   vdep=z((nspec, ny, nx)), height=z((nz,)))


def eta_from_numpy(d, device: torch.device | str) -> EtaFields:
    """numpy arrays (a dict, or any object with the field attributes) ->
    float32 EtaFields on ``device``."""
    get = d.__getitem__ if isinstance(d, dict) else d.__getattribute__
    return EtaFields(**{
        k: torch.as_tensor(np.asarray(get(k), np.float32), device=device)
        for k in ETA_FIELDS})

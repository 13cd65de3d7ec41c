"""The legacy-RNG (matched-stream) validation path of the advance.

Port of the ``leg`` branches of ``flexpart_tpu/core/advance.py``
(``LegacyRnd``, ``_legacy_draws``, ``_sample_met(legacy=True)``) and of
``interp_wind_legacy``, ``interp_wind_short`` and ``hmix_max`` of
``flexpart_tpu/core/interp.py``.  In this mode every draw of the advance is
a read of the reference's ``rannumb`` table (``validation/legacy_rng.py``)
at the index the Fortran would use, through a per-particle ``nrand`` cursor
whose bases come from the serial ran3 chain in the reference's order, and
the met is interpolated per time level as interpol_all.f90 and
interpol_wind{,_short}.f90 do (not through the quad tables).  The port's
advance is then held against the scalar advance.f90 oracle
(``validation/oracle.py``) draw for draw.

This is the reference's validation mode, not a fallback of a kernel: it
runs as plain PyTorch on whatever device the particles are on, the CPU or
the card, as the JAX package runs it as XLA work of per-particle table
reads.  No kernel takes it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..met.fields import (F2_HMIX, F2_OLI, F2_TROPO, F2_USTAR, F2_WSTAR,
                          F3_DRHODZ, F3_RHO, F3_U, F3_V, F3_W, ZFields)
from .interp import (HorizWeights, WindInterp, gather_corners_2d_ln,
                     interp_2d, true_div)

_WIND_FIELDS = (F3_U, F3_V, F3_W, F3_RHO, F3_DRHODZ)


@dataclasses.dataclass
class LegacyRnd:
    """The matched-RNG inputs of one advance: the rannumb table (1-based,
    ``validation.legacy_rng.make_rannumb``; entry 0 unused) and the
    per-particle ``nrand`` bases drawn on the host from the ran3 chain in
    the reference's order (advance.f90:153, initialize.f90:68).  With the
    CBL, ``cbl_dcas``/``cbl_dcas1`` are the initialize_cbl_vel.f90 uniform
    and normal of a fresh particle in the skewed zone (None otherwise)."""
    table: torch.Tensor          # (maxrand + 1,) f32
    nrand_init: torch.Tensor     # (n,) i32, initialize.f90's base
    nrand: torch.Tensor          # (n,) i32, advance.f90's base
    cbl_dcas: torch.Tensor | None = None
    cbl_dcas1: torch.Tensor | None = None


def wrap(nr: torch.Tensor, need: int, r: int) -> torch.Tensor:
    """``if (nrand + need > maxrand) nrand = 1``."""
    return torch.where(nr + need > r, torch.ones_like(nr), nr)


def legacy_draws(leg: LegacyRnd, ifine: int, pbl, in_trop, in_trans):
    """The fixed step's per-site draws from the table, with the index
    arithmetic of initialize.f90 and advance.f90: a dict keyed by the draw
    tags (6: initialize's six rows, 1: the horizontal OU pair, 2: the
    ifine vertical rows, 3: the free troposphere's three, 4: the
    mesoscale three) and (b2, ft_meso), the bases the CBL chase and its
    mesoscale draw start from."""
    tab = leg.table
    r = tab.shape[0] - 1

    def at(idx):
        return tab[idx.long()]

    # ----- initialize.f90 -----
    ni = leg.nrand_init
    b = wrap(ni, 2, r)                              # PBL check (line 130)
    a = wrap(ni, 1, r)                              # above-PBL check (192)
    ibase = torch.where(pbl, b, a)
    mb_i = wrap(torch.where(pbl, b, a + 2), 2, r)   # meso base (194-213)
    rnd_i = torch.stack([at(ibase), at(ibase + 1), at(b + 2), at(mb_i),
                         at(mb_i + 1), at(mb_i + 2)], 0)

    # ----- advance.f90 -----
    na = leg.nrand
    na1 = wrap(na, 1, r)                            # horizontal (line 369)
    rnd_h = torch.stack([at(na1), at(na1 + 1)], 0)
    b2 = wrap(na1 + 2, ifine, r)                    # vertical (line 395)
    rnd_w = torch.stack([at(b2 + 1 + i) for i in range(ifine)], 0)
    pbl_meso = b2 + ifine + 1                       # nrand=nrand+i, i=ifine+1

    t_b = wrap(na, 1, r)                            # troposphere (650)
    tr_b = wrap(na, 2, r)                           # transition (657)
    s_b = wrap(na, 0, r)                            # stratosphere (666)
    rnd_ft = torch.stack([
        torch.where(in_trans, at(tr_b), at(t_b)),
        torch.where(in_trans, at(tr_b + 1), at(t_b + 1)),
        torch.where(in_trans, at(tr_b + 2), at(s_b)),
    ], 0)
    ft_meso = torch.where(in_trop, t_b + 2,
                          torch.where(in_trans, tr_b + 3, s_b + 1))
    mb = wrap(torch.where(pbl, pbl_meso, ft_meso), 2, r)   # mesoscale (727)
    rnd_m = torch.stack([at(mb), at(mb + 1), at(mb + 2)], 0)
    return {6: rnd_i, 1: rnd_h, 2: rnd_w, 3: rnd_ft, 4: rnd_m}, (b2, ft_meso)


def gather_corners_3d(f3d, field_ids, hw: HorizWeights, indz):
    """(NF3, nz, ny, nx) -> (F, 2, 4, N): per field the four corners of the
    levels indz and indz + 1."""
    nf, nz, ny, nx = f3d.shape
    flat = f3d.reshape(nf, nz * ny * nx)[list(field_ids)]
    lin0 = indz.long()[None, :] * (ny * nx) + hw.idx4     # (4, N)
    lin = torch.stack([lin0, lin0 + ny * nx], 0)          # (2, 4, N)
    return flat[:, lin]


def _corner_dot(c, p4):
    """(..., 4, N) corners x (4, N) weights, summed over the corners left
    to right."""
    return ((c[..., 0, :] * p4[0] + c[..., 1, :] * p4[1])
            + c[..., 2, :] * p4[2]) + c[..., 3, :] * p4[3]


def _corner_sum(c):
    return ((c[..., 0, :] + c[..., 1, :]) + c[..., 2, :]) + c[..., 3, :]


def _blend_levels(z0: ZFields, z1: ZFields, fields, hw, indz, dz1, tw0,
                  tw1):
    c0 = gather_corners_3d(z0.f3d, fields, hw, indz)
    c1 = gather_corners_3d(z1.f3d, fields, hw, indz)
    lev = _corner_dot(c0, hw.p4) * tw0 + _corner_dot(c1, hw.p4) * tw1
    return c0, c1, lev[:, 0] * (1.0 - dz1) + lev[:, 1] * dz1


def _sigma(var, count: int):
    return torch.where(var < 1.0e-30, torch.zeros_like(var),
                       torch.sqrt(true_div(torch.clamp(var, min=0.0),
                                           float(count - 1))))


def interp_wind_legacy(z0: ZFields, z1: ZFields, hw: HorizWeights, indz,
                       dz1, tw0: float, tw1: float):
    """Reference-exact winds (per time level, bilinear, then blended in
    time and linear in z; interpol_all.f90) with both wind-sigma
    conventions: the per-level 8-sample one averaged over the two levels
    (interpol_all.f90:216-240, advance.f90:603-606) in the WindInterp, and
    the 16-sample one above the boundary layer (interpol_wind.f90:194-213)
    as a triple."""
    c0, c1, val = _blend_levels(z0, z1, _WIND_FIELDS, hw, indz, dz1, tw0,
                                tw1)
    uvw0, uvw1 = c0[:3], c1[:3]
    sl = _corner_sum(uvw0) + _corner_sum(uvw1)               # (3, 2, N)
    sq = _corner_sum(uvw0 * uvw0) + _corner_sum(uvw1 * uvw1)
    sig_lev = _sigma(sq - sl * sl / 8.0, 8)
    sig8 = 0.5 * (sig_lev[:, 0] + sig_lev[:, 1])
    sl16 = sl[:, 0] + sl[:, 1]
    sq16 = sq[:, 0] + sq[:, 1]
    sig16 = _sigma(sq16 - sl16 * sl16 / 16.0, 16)
    wind = WindInterp(u=val[0], v=val[1], w=val[2], rho=val[3],
                      drhodz=val[4], usig=sig8[0], vsig=sig8[1],
                      wsig=sig8[2])
    return wind, (sig16[0], sig16[1], sig16[2])


def interp_wind_short(z0: ZFields, z1: ZFields, hw: HorizWeights, indz,
                      dz1, tw0: float, tw1: float):
    """u, v, w only, for the Petterssen corrector
    (interpol_wind_short.f90)."""
    _, _, val = _blend_levels(z0, z1, (F3_U, F3_V, F3_W), hw, indz, dz1,
                              tw0, tw1)
    return val[0], val[1], val[2]


def vert_wind_legacy(z0: ZFields, z1: ZFields, hw: HorizWeights, indz, dz1,
                     tw0: float, tw1: float):
    """u, v, w, rho, drhodz at the frozen stencil: the adaptive step's
    per-pass re-sampling in the legacy interpolation."""
    _, _, val = _blend_levels(z0, z1, _WIND_FIELDS, hw, indz, dz1, tw0, tw1)
    return val[0], val[1], val[2], val[3], val[4]


def hmix_max(z0: ZFields, z1: ZFields, hw: HorizWeights):
    """The largest mixing height of the four corners at both met times
    (advance.f90:236-252)."""
    h0 = gather_corners_2d_ln(z0.f2d, (F2_HMIX,), hw)[0]
    h1 = gather_corners_2d_ln(z1.f2d, (F2_HMIX,), hw)[0]
    return torch.maximum(torch.amax(h0, dim=0), torch.amax(h1, dim=0))


def sample_met_legacy(z0: ZFields, z1: ZFields, tw0: float, tw1: float, x,
                      y, hw: HorizWeights, indz, dz1):
    """Everything the integrator reads at the particle, reference-exact
    (``_sample_met(legacy=True)``): (h, tropop, ust, wst, ol, WindInterp,
    the 16-sample sigmas)."""
    h = torch.clamp(hmix_max(z0, z1, hw), min=1.0)
    # the tropopause of the nearest corner of the first time level
    # (advance.f90:252)
    trop_c = gather_corners_2d_ln(z0.f2d, (F2_TROPO,), hw)[0]
    ix_n = (x - hw.ix) >= 0.5
    iy_n = (y - hw.jy) >= 0.5
    tropop = torch.where(iy_n, torch.where(ix_n, trop_c[3], trop_c[2]),
                         torch.where(ix_n, trop_c[1], trop_c[0]))
    sidx = [F2_USTAR, F2_WSTAR, F2_OLI]
    f2dt = z0.f2d[sidx] * tw0 + z1.f2d[sidx] * tw1
    ust, wst, oliaux = interp_2d(f2dt, (0, 1, 2), hw)
    ol = torch.where(oliaux != 0.0, 1.0 / oliaux,
                     torch.full_like(oliaux, 99999.0))
    wind, sig16 = interp_wind_legacy(z0, z1, hw, indz, dz1, tw0, tw1)
    return h, tropop, ust, wst, ol, wind, sig16

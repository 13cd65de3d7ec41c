"""Gross mass fluxes through output-cell faces (iflux=1).

Port of ``flexpart_tpu/grid/fluxes.py`` (calcfluxes.f90 + fluxoutput.f90):
per particle per step, the mass crossing the east/west/north/south/up/down
faces between its old and new position is added into flux(6, nage, kp,
kz, jy, ix, ks).  ``FluxConfig`` and ``zero_flux`` are the JAX package's,
copied.  The crossings are ``MAX_SPAN`` candidate faces per direction per
particle (a particle moves a few output cells per sync step at most);
``flux_pairs`` names each particle's candidates and their validity.

The scatter-add is kernel K16 (``csrc/fluxes.cu``: one thread per
particle, every index masked before it is used, the crossings of a warp
grouped by flux row and each group's sum sent by one float atomic) on CUDA
tensors and ``calcfluxes_plain`` (``index_add_`` of the valid pairs) on
CPU tensors; ``calcfluxes`` picks by device.  Both add into ``flux`` in
place (JAX returns a new array).  Float atomics add in another order on
every run: K16 is held against the float64 sum of its pairs.  K16 matches
rows on 32 bits, so it refuses a flux array of more than
``K16_MAX_ROWS`` rows, as K3, K8 and K17 refuse their grids.

The old positions are the particles' before the advance, taken after the
step's sort (a snapshot taken before a sort belongs to other slots).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..core.interp import true_div
from ..core.state import Particles

MAX_SPAN = 6   # max output-cell faces crossed per step per direction
_BIG = float(2 ** 30)   # float bound before an int cast (XLA saturates)
K16_MAX_ROWS = 0xFFFFFFFF - 32     # MAX_ROWS of csrc/warp_groups.cuh


class FluxConfig(NamedTuple):
    nxg: int
    nyg: int
    nzg: int
    npointspec: int
    nage: int
    dxout: float
    dyout: float
    xoutshift: float
    youtshift: float
    dx_met: float
    dy_met: float
    nx_met: int


def flux_rows(cfg: FluxConfig) -> int:
    """The rows of ``flux.view(-1, nspec)``: 6 faces x nage x npointspec x
    nzg x nyg x nxg."""
    return 6 * cfg.nage * cfg.npointspec * cfg.nzg * cfg.nyg * cfg.nxg


def zero_flux(cfg: FluxConfig, nspec: int, device="cpu") -> torch.Tensor:
    return torch.zeros((6, cfg.nage, cfg.npointspec, cfg.nzg, cfg.nyg,
                        cfg.nxg, nspec), dtype=torch.float32, device=device)


def half_levels(outheights) -> np.ndarray:
    """(nzg + 1,) the faces between output layers: 0, the mid-points, and
    twice the top (calcfluxes.f90:70-82)."""
    oh = np.asarray(outheights, np.float32)
    return np.concatenate([np.zeros(1, np.float32),
                           np.float32(0.5) * (oh[:-1] + oh[1:]),
                           oh[-1:] * np.float32(2.0)]).astype(np.float32)


def _floor_int(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(v), -_BIG, _BIG).to(torch.int64)


def flux_pairs(p: Particles, xold, yold, zold, itime: int,
               lage: torch.Tensor, outheight: torch.Tensor,
               ohhalf: torch.Tensor, cfg: FluxConfig,
               ioutputforeachrelease: bool = True):
    """Each particle's candidate crossings: (idx, valid), both (N, 6
    MAX_SPAN), idx the row of ``flux.view(-1, nspec)`` (face-major), valid
    where the particle is live and the crossing lies on the grid."""
    live = p.active & (p.itra == itime)
    x, y, z = p.x, p.y, p.z
    itage = torch.abs(itime - p.itramem)
    nage_idx = torch.clamp(torch.searchsorted(lage, itage, right=True),
                           0, cfg.nage - 1)
    kp = p.npoint if ioutputforeachrelease else torch.zeros_like(p.npoint)
    xmean = 0.5 * (xold + x)
    ymean = 0.5 * (yold + y)
    ixave = _floor_int(true_div(xmean * cfg.dx_met + cfg.xoutshift,
                                cfg.dxout))
    jyave = _floor_int(true_div(ymean * cfg.dy_met + cfg.youtshift,
                                cfg.dyout))
    kzave = torch.clamp(torch.searchsorted(outheight, z, right=True),
                        max=cfg.nzg - 1)
    in_h = (ixave >= 0) & (ixave < cfg.nxg) & (jyave >= 0) \
        & (jyave < cfg.nyg)
    base_cell = (nage_idx.long() * cfg.npointspec + kp.long()) * cfg.nzg
    nyx = cfg.nyg * cfg.nxg
    rows = cfg.nage * cfg.npointspec * cfg.nzg * nyx
    idx, valid = [], []

    def add(face, lin, v):
        idx.append(torch.where(v, face * rows + lin, torch.zeros_like(lin)))
        valid.append(v & live)

    # vertical faces (4 up, 5 down; calcfluxes.f90:70-82)
    k1 = torch.clamp(torch.searchsorted(ohhalf, zold, right=True),
                     max=cfg.nzg)
    k2 = torch.clamp(torch.searchsorted(ohhalf, z, right=True), max=cfg.nzg)
    for s in range(MAX_SPAN):
        kz_u = k1 - 1 + s                     # upward: k1 .. k2 - 1
        v_u = in_h & (kz_u <= k2 - 2) & (kz_u >= 0) & (kz_u < cfg.nzg)
        add(4, (base_cell + kz_u) * nyx + jyave * cfg.nxg + ixave, v_u)
        kz_d = k2 - 1 + s                     # downward: k2 .. k1 - 1
        v_d = in_h & (kz_d <= k1 - 2) & (kz_d >= 0) & (kz_d < cfg.nzg)
        add(5, (base_cell + kz_d) * nyx + jyave * cfg.nxg + ixave, v_d)
    # east/west faces (0 E, 1 W; calcfluxes.f90:88-131)
    no_wrap = torch.abs(xold - x) < cfg.nx_met / 2.0
    ix1 = _floor_int(true_div(xold * cfg.dx_met + cfg.xoutshift, cfg.dxout)
                     + 0.5)
    ix2 = _floor_int(true_div(x * cfg.dx_met + cfg.xoutshift, cfg.dxout)
                     + 0.5)
    ok_y = (jyave >= 0) & (jyave < cfg.nyg)
    row_ew = (base_cell + kzave) * nyx + jyave * cfg.nxg
    for s in range(MAX_SPAN):
        ix_e = ix1 + s
        v_e = no_wrap & ok_y & (ix_e <= ix2 - 1) & (ix_e >= 0) \
            & (ix_e < cfg.nxg)
        add(0, row_ew + ix_e, v_e)
        ix_w = ix2 + s
        v_w = no_wrap & ok_y & (ix_w <= ix1 - 1) & (ix_w >= 0) \
            & (ix_w < cfg.nxg)
        add(1, row_ew + ix_w, v_w)
    # north/south faces (2 N, 3 S; calcfluxes.f90:138-163)
    jy1 = _floor_int(true_div(yold * cfg.dy_met + cfg.youtshift, cfg.dyout)
                     + 0.5)
    jy2 = _floor_int(true_div(y * cfg.dy_met + cfg.youtshift, cfg.dyout)
                     + 0.5)
    ok_x = (ixave >= 0) & (ixave < cfg.nxg)
    row_ns = (base_cell + kzave) * nyx + ixave
    for s in range(MAX_SPAN):
        jy_n = jy1 + s
        v_n = ok_x & (jy_n <= jy2 - 1) & (jy_n >= 0) & (jy_n < cfg.nyg)
        add(2, row_ns + jy_n * cfg.nxg, v_n)
        jy_s = jy2 + s
        v_s = ok_x & (jy_s <= jy1 - 1) & (jy_s >= 0) & (jy_s < cfg.nyg)
        add(3, row_ns + jy_s * cfg.nxg, v_s)
    return torch.stack(idx, dim=1), torch.stack(valid, dim=1)


def calcfluxes_plain(flux: torch.Tensor, p: Particles, xold, yold, zold,
                     itime: int, lage: torch.Tensor, outheight: torch.Tensor,
                     ohhalf: torch.Tensor, cfg: FluxConfig,
                     ioutputforeachrelease: bool = True) -> None:
    """Plain twin of K16: add the step's crossings into ``flux`` in place."""
    idx, valid = flux_pairs(p, xold, yold, zold, itime, lage, outheight,
                            ohhalf, cfg, ioutputforeachrelease)
    nspec = p.nspec
    flat = flux.view(-1, nspec)
    rows = idx[valid]
    who = torch.nonzero(valid, as_tuple=True)[0]
    flat.index_add_(0, rows, p.mass[who])


def calcfluxes_cuda(flux: torch.Tensor, p: Particles, xold, yold, zold,
                    itime: int, lage: torch.Tensor, outheight: torch.Tensor,
                    ohhalf: torch.Tensor, cfg: FluxConfig,
                    ioutputforeachrelease: bool = True) -> None:
    """K16 launch: add the step's crossings into ``flux`` in place."""
    if flux_rows(cfg) > K16_MAX_ROWS:
        raise ValueError(f"K16 matches flux rows by a 32-bit index: "
                         f"{flux_rows(cfg)} rows exceed K16_MAX_ROWS = "
                         f"{K16_MAX_ROWS}")
    dev = flux.device
    n = p.capacity
    f32, i32 = torch.float32, torch.int32
    want = {"x_hi": f32, "x_lo": f32, "y_hi": f32, "y_lo": f32, "z": f32,
            "itra": i32, "itramem": i32, "npoint": i32, "active": torch.bool,
            "mass": f32}
    for name, dt in want.items():
        t = getattr(p, name)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape[0] != n:
            raise ValueError(f"K16: particle field {name} must be contiguous "
                             f"{dt} with {n} rows on {dev}")
    for t, dt, name in ((xold, f32, "xold"), (yold, f32, "yold"),
                        (zold, f32, "zold"), (lage, i32, "lage"),
                        (outheight, f32, "outheight"),
                        (ohhalf, f32, "ohhalf"), (flux, f32, "flux")):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"K16: {name} must be contiguous {dt} on {dev}")
    if xold.shape != (n,) or yold.shape != (n,) or zold.shape != (n,):
        raise ValueError(f"K16: xold, yold, zold must be ({n},)")
    if tuple(flux.shape) != (6, cfg.nage, cfg.npointspec, cfg.nzg, cfg.nyg,
                             cfg.nxg, p.nspec):
        raise ValueError("K16: flux does not match the configuration")
    if n >= 2 ** 31 - 256:
        raise ValueError("K16 indexes particles with int32")

    def c(v):
        return float(np.float32(v))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.FLUXES(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), xold.data_ptr(),
            yold.data_ptr(), zold.data_ptr(), p.itra.data_ptr(),
            p.itramem.data_ptr(), p.npoint.data_ptr(), p.active.data_ptr(),
            p.mass.data_ptr(), lage.data_ptr(), cfg.nage,
            outheight.data_ptr(), ohhalf.data_ptr(), cfg.nzg, n, p.nspec,
            cfg.nxg, cfg.nyg, cfg.npointspec, int(ioutputforeachrelease),
            c(cfg.dx_met), c(cfg.dy_met), c(cfg.xoutshift),
            c(cfg.youtshift), c(cfg.dxout), c(cfg.dyout),
            c(cfg.nx_met / 2.0), int(itime), flux.data_ptr(), stream)


def calcfluxes(flux: torch.Tensor, p: Particles, xold, yold, zold,
               itime: int, lage: torch.Tensor, outheight: torch.Tensor,
               ohhalf: torch.Tensor, cfg: FluxConfig,
               ioutputforeachrelease: bool = True) -> None:
    """One step's face crossings (calcfluxes.f90:40-169), added into
    ``flux`` in place: K16 on CUDA, the plain twin on the CPU."""
    run = {"cuda": calcfluxes_cuda,
           "cpu": calcfluxes_plain}.get(flux.device.type)
    if run is None:
        raise ValueError(f"no flux backend for device {flux.device}")
    run(flux, p, xold, yold, zold, itime, lage, outheight, ohhalf, cfg,
        ioutputforeachrelease)


def make_calcfluxes(outheights, device):
    """Bind the output levels, return ``(flux, p, xold, yold, zold, itime,
    lage, cfg, ioutputforeachrelease) -> None`` (in place)."""
    oh = torch.as_tensor(np.asarray(outheights, np.float32), device=device)
    ohhalf = torch.as_tensor(half_levels(outheights), device=device)

    def run(flux, p, xold, yold, zold, itime, lage, cfg,
            ioutputforeachrelease=True):
        calcfluxes(flux, p, xold, yold, zold, itime, lage, oh, ohhalf, cfg,
                   ioutputforeachrelease)

    return run

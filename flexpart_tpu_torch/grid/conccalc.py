"""Concentration sampling: scatter-add of particle mass onto the output grid.

Port of ``flexpart_tpu/grid/conccalc.py``: both sampling paths (one cell
per particle while no particle can be 3 h old, the 4-point uniform kernel
after), with ``ind_samp`` 0 (mass) and -1 (mass / air density).  The
scatter-add is kernel K3 (``csrc/conccalc.cu``) on CUDA and the plain
twin ``conccalc_plain`` on the CPU.  Both add into ``acc.gridunc`` in
place (JAX returns a new array) and return ``acc`` with ``outnum``
advanced.  Out-of-range cells are dropped: the twin filters the JAX 2**30
sentinel before ``index_add_``, the kernel skips it.  A backward deposition
run (``ConcConfig.bkdep``) multiplies each species' contribution by
max(xscav, 0), and ``particle_count_output`` adds the particle count (1,
or the 4-point weight) instead of the mass: K3's ``BKDEP`` and ``COUNT``
instantiations on CUDA.

K3 sums in two levels: the ``K3_GROUP`` consecutive particles of a warp
first add up, in registers, the values that go to the same row of
``gridunc``, and one lane sends one global atomic per distinct row, so
particles kept in cell order (``core/reorder.py``) cost a fraction of the
global atomics that their pairs number; ``conccalc_pairs`` names the pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from ..core.interp import horiz_weights, true_div, vert_weights
from ..core.state import Particles
from ..met.fields import ZFields, F3_RHO
from .outgrid import Accumulators

_SENTINEL = 2 ** 30
# consecutive particles whose pairs K3 sums before its global atomics (a
# warp of csrc/conccalc.cu, one thread per particle)
K3_GROUP = 32
K3_MAX_ROWS = 0xFFFFFFFF - 32     # MAX_ROWS of csrc/conccalc.cu


@dataclasses.dataclass(frozen=True)
class ConcConfig:
    nxg: int
    nyg: int
    nzg: int
    npointspec: int
    nclassunc: int
    nage: int
    dxout: float
    dyout: float
    xoutshift: float
    youtshift: float
    dx_met: float
    dy_met: float
    ind_samp: int        # 0: mass, -1: divide by air density
    use_kernel: bool = True
    ioutputforeachrelease: bool = True
    particle_count_output: bool = False
    bkdep: bool = False
    kernel_possible: bool = True

    def replace(self, **kw) -> "ConcConfig":
        return dataclasses.replace(self, **kw)


def kernel_possible_at(itime, first_release_time,
                       use_kernel: bool = True) -> bool:
    """Host-side: can ANY particle be >= 3 h old at itime?"""
    if not use_kernel:
        return False
    if first_release_time is None:
        return True
    return abs(int(itime) - int(first_release_time)) >= 10800


def _rho_at_particles(p: Particles, zf: ZFields) -> torch.Tensor:
    """Bilinear/linear air density at the particle from the newer wind
    field (conccalc.f90:80-125), the ``ind_samp=-1`` denominator."""
    nx_m, ny_m = zf.f3d.shape[3], zf.f3d.shape[2]
    hw = horiz_weights(p.x, p.y, nx_m, ny_m, False)
    indz, dz1 = vert_weights(p.z, zf.height)
    rho_flat = zf.f3d[F3_RHO].reshape(-1)
    lin0 = indz.long()[None, :] * (ny_m * nx_m) + hw.idx4     # (4, N)
    g_lo = rho_flat[lin0]
    g_hi = rho_flat[lin0 + ny_m * nx_m]
    rho_lo = (((g_lo[0] * hw.p4[0] + g_lo[1] * hw.p4[1]) + g_lo[2] * hw.p4[2])
              + g_lo[3] * hw.p4[3])
    rho_hi = (((g_hi[0] * hw.p4[0] + g_hi[1] * hw.p4[1]) + g_hi[2] * hw.p4[2])
              + g_hi[3] * hw.p4[3])
    return rho_lo * (1.0 - dz1) + rho_hi * dz1


def conccalc_pairs(rows: int, p: Particles, itime: int,
                   lage: torch.Tensor, outheight: torch.Tensor,
                   weight: float, rhoi: torch.Tensor | None,
                   cfg: ConcConfig):
    """What each particle adds to a flat gridunc of ``rows`` rows: target
    rows ``lin`` (N, T) int64, their validity (N, T) and the values
    (N, T, nspec), T = 1 on the single-index path and 4 on the kernel
    path."""
    n = p.capacity
    live = p.active & (p.itra == itime)
    x, y, z = p.x, p.y, p.z
    itage = torch.abs(p.itra - p.itramem)
    nage_idx = torch.clamp(torch.searchsorted(lage, itage, right=True),
                           0, cfg.nage - 1)
    kz = torch.searchsorted(outheight, z, right=True)
    in_z = kz < cfg.nzg
    kz = torch.clamp(kz, max=cfg.nzg - 1)

    xl = true_div(x * cfg.dx_met + cfg.xoutshift, cfg.dxout)
    yl = true_div(y * cfg.dy_met + cfg.youtshift, cfg.dyout)
    # floor clamped in float first: JAX's float->int conversion saturates
    big = float(_SENTINEL)
    ix = torch.clamp(torch.floor(xl), -big, big).to(torch.int64)
    jy = torch.clamp(torch.floor(yl), -big, big).to(torch.int64)

    near_edge = ((xl < 0.5) | (yl < 0.5)
                 | (xl > cfg.nxg - 1 - 0.5) | (yl > cfg.nyg - 1 - 0.5))
    direct = (itage < 10800) | near_edge
    if not cfg.use_kernel:
        direct = torch.ones_like(direct)

    kp = p.npoint if cfg.ioutputforeachrelease else torch.zeros_like(p.npoint)
    cell = (((nage_idx * cfg.nclassunc + p.nclass) * cfg.npointspec + kp)
            * cfg.nzg + kz)

    if not cfg.kernel_possible:
        in_grid = (ix >= 0) & (ix < cfg.nxg) & (jy >= 0) & (jy < cfg.nyg)
        lin = cell * (cfg.nyg * cfg.nxg) + jy * cfg.nxg + ix
        valid = live & in_z & in_grid & (lin >= 0) & (lin < rows)
        if cfg.particle_count_output:
            m = torch.ones_like(p.mass)
        else:
            m = p.mass / rhoi[:, None] if rhoi is not None else p.mass
            if cfg.bkdep:
                m = m * _at_least_zero(p.xscav)
        contrib = m * weight
        return lin[:, None], valid[:, None], contrib[:, None, :]

    ddx = xl - ix
    ddy = yl - jy
    hi_x = ddx > 0.5
    hi_y = ddy > 0.5
    ixp = torch.where(hi_x, ix + 1, ix - 1)
    jyp = torch.where(hi_y, jy + 1, jy - 1)
    wx = torch.where(hi_x, 1.5 - ddx, 0.5 + ddx)
    wy = torch.where(hi_y, 1.5 - ddy, 0.5 + ddy)
    cx = torch.stack([ix, ix, ixp, ixp], dim=1)                   # (N, 4)
    cy = torch.stack([jy, jyp, jy, jyp], dim=1)
    w4 = torch.stack([wx * wy, wx * (1 - wy), (1 - wx) * wy,
                      (1 - wx) * (1 - wy)], dim=1)
    one_hot = torch.zeros((n, 4), dtype=torch.float32, device=p.device)
    one_hot[:, 0] = 1.0
    w4 = torch.where(direct[:, None], one_hot, w4)
    in_grid = (cx >= 0) & (cx < cfg.nxg) & (cy >= 0) & (cy < cfg.nyg)
    lin = cell[:, None] * (cfg.nyg * cfg.nxg) + cy * cfg.nxg + cx
    valid = (live[:, None] & in_z[:, None] & in_grid & (w4 > 0)
             & (lin >= 0) & (lin < rows))
    if cfg.particle_count_output:
        contrib = w4[..., None].expand(n, 4, p.nspec) * weight
        return lin, valid, contrib
    wr = w4 / rhoi[:, None] if rhoi is not None else w4
    contrib = wr[..., None] * p.mass[:, None, :]                 # (N, 4, ns)
    if cfg.bkdep:
        contrib = contrib * _at_least_zero(p.xscav)[:, None, :]
    return lin, valid, contrib * weight


def _at_least_zero(v: torch.Tensor) -> torch.Tensor:
    """max(v, 0) as jnp.maximum, a NaN passing through."""
    return torch.maximum(v, torch.zeros_like(v))


def conccalc_plain(flat: torch.Tensor, p: Particles, itime: int,
                   lage: torch.Tensor, outheight: torch.Tensor,
                   weight: float, rhoi: torch.Tensor | None,
                   cfg: ConcConfig) -> None:
    """Plain twin of K3: accumulate into ``flat`` (rows, nspec) in place."""
    lin, valid, contrib = conccalc_pairs(flat.shape[0], p, itime, lage,
                                         outheight, weight, rhoi, cfg)
    flat.index_add_(0, lin[valid], contrib[valid])


def conccalc_cuda(flat: torch.Tensor, p: Particles, itime: int,
                  lage: torch.Tensor, outheight: torch.Tensor,
                  weight: float, rhoi: torch.Tensor | None,
                  cfg: ConcConfig, nest: bool = False) -> None:
    """K3 launch: accumulate into ``flat`` (rows, nspec) in place; its
    ``COUNT`` instantiation for ``particle_count_output``, else its
    ``BKDEP`` one for ``bkdep``, else the stock one, counted as the nested
    output grid's (``conccalc.nest``) where ``nest``."""
    if p.capacity == 0:
        return
    dev = flat.device
    f32, i32 = torch.float32, torch.int32
    want = {"x_hi": f32, "x_lo": f32, "y_hi": f32, "y_lo": f32, "z": f32,
            "itra": i32, "itramem": i32, "npoint": i32, "nclass": i32,
            "active": torch.bool, "mass": f32}
    n = p.capacity
    for name, dt in want.items():
        t = getattr(p, name)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape[0] != n:
            raise ValueError(f"K3: particle field {name} must be contiguous "
                             f"{dt} with {n} rows on {dev}")
    if p.mass.shape[1] != flat.shape[1]:
        raise ValueError("K3: mass species do not match gridunc")
    count = cfg.particle_count_output
    bkdep = cfg.bkdep and not count
    if bkdep and (p.xscav.device != dev or p.xscav.dtype != f32
                  or tuple(p.xscav.shape) != tuple(p.mass.shape)
                  or not p.xscav.is_contiguous()):
        raise ValueError("K3: xscav must be contiguous float32 like mass")
    if flat.shape[0] > K3_MAX_ROWS:
        raise ValueError(f"K3 matches gridunc rows by a 32-bit index: "
                         f"{flat.shape[0]} rows exceed {K3_MAX_ROWS}")
    for t, dt, name in ((lage, i32, "lage"), (outheight, f32, "outheight"),
                        (flat, f32, "gridunc")):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"K3: {name} must be contiguous {dt} on {dev}")
    if rhoi is not None and (rhoi.device != dev or rhoi.dtype != f32
                             or not rhoi.is_contiguous() or rhoi.shape != (n,)):
        raise ValueError("K3: rhoi must be contiguous float32 (N,)")

    def c(v):
        return float(np.float32(v))

    kernel = (_build.CONCCALC_COUNT if count else
              _build.CONCCALC_BKDEP if bkdep else
              _build.CONCCALC_NEST if nest else _build.CONCCALC)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), p.itra.data_ptr(),
            p.itramem.data_ptr(), p.npoint.data_ptr(), p.nclass.data_ptr(),
            p.active.data_ptr(), p.mass.data_ptr(),
            rhoi.data_ptr() if rhoi is not None else None,
            p.xscav.data_ptr() if bkdep else None, int(count),
            lage.data_ptr(), cfg.nage, outheight.data_ptr(), cfg.nzg,
            n, flat.shape[1], cfg.nxg, cfg.nyg, cfg.npointspec,
            cfg.nclassunc, c(cfg.dx_met), c(cfg.dy_met), c(cfg.xoutshift),
            c(cfg.youtshift), c(cfg.dxout), c(cfg.dyout), int(itime),
            c(weight), int(cfg.kernel_possible), int(cfg.use_kernel),
            int(cfg.ioutputforeachrelease), flat.shape[0], flat.data_ptr(),
            stream)


def conccalc(acc: Accumulators, p: Particles, zf: ZFields, itime: int,
             lage: torch.Tensor, weight: float, cfg: ConcConfig,
             outheight: torch.Tensor, nest: bool = False) -> Accumulators:
    """One sampling pass: K3 on CUDA (``nest``: the nested output
    grid's), the plain twin on the CPU."""
    if cfg.ind_samp not in (0, -1):
        raise ValueError(f"ind_samp must be 0 or -1, not {cfg.ind_samp}")
    if lage.shape[0] < cfg.nage:
        raise ValueError("lage has fewer entries than nage")
    weight = float(np.float32(weight))
    rhoi = _rho_at_particles(p, zf) if cfg.ind_samp == -1 else None
    flat = acc.gridunc.view(-1, p.nspec)
    dev = flat.device
    if dev.type == "cuda":
        conccalc_cuda(flat, p, itime, lage, outheight, weight, rhoi, cfg,
                      nest)
    elif dev.type == "cpu":
        conccalc_plain(flat, p, itime, lage, outheight, weight, rhoi, cfg)
    else:
        raise ValueError(f"no conccalc backend for device {dev}")
    return acc.replace(outnum=acc.outnum + weight)


def make_conccalc(outheights, nest: bool = False):
    """Bind the output level heights, return a sampler
    ``(acc, particles, zfields, itime, lage, weight, cfg) -> acc``;
    ``nest``: the nested output grid's (its K3 launches counted apart)."""
    oh = np.asarray(outheights, np.float32)

    def run(acc: Accumulators, p: Particles, zf: ZFields, itime: int,
            lage: torch.Tensor, weight: float, cfg: ConcConfig) -> Accumulators:
        outheight = torch.as_tensor(oh, device=acc.gridunc.device)
        return conccalc(acc, p, zf, itime, lage, weight, cfg, outheight,
                        nest)

    return run

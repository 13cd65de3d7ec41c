"""Space-time interpolation of met fields at particle positions, quad path.

Port of the production path of ``flexpart_tpu/core/interp.py``: the
per-step quad-corner row tables (``build_step_tables_quad``, kernel K2 on
CUDA) and the single-index row gather that samples them
(``sample_all_quad``, ``interp_wind_short_quad``).  The legacy, paired and
blended variants belong to a later slice.

Index hygiene: JAX clamps out-of-range gather indices silently, torch
raises on the CPU and asserts on CUDA.  ``horiz_weights`` clamps in float
and again after the integer conversion, and ``vert_weights`` clamps the
level, so every row id lies inside the table, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..met.fields import (ZFields, F3_U, F3_V, F3_W, F3_RHO, F3_DRHODZ,
                          F2_HMIX, F2_OLI, F2_TROPO, F2_USTAR, F2_WSTAR)

_WIND_FIELDS = (F3_U, F3_V, F3_W, F3_RHO, F3_DRHODZ)
ROWS_LANES = 64      # one 128 B bf16 row per cell
ROWS_E_LANES = 32    # 24 used: two 32 B sectors per cell in bf16


@dataclasses.dataclass
class HorizWeights:
    ix: torch.Tensor    # (N,) i32 lower-left corner
    jy: torch.Tensor
    idx4: torch.Tensor  # (4, N) i64 flattened corner indices into (ny*nx)
    p4: torch.Tensor    # (4, N) f32 bilinear weights (corner-major)


def _floor_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """int32 floor(x) clipped to [0, hi], total for any float input."""
    i = torch.clamp(torch.floor(x), 0.0, float(hi)).to(torch.int32)
    return torch.clamp(i, 0, hi)


def horiz_weights(x, y, nx: int, ny: int, xglobal: bool) -> HorizWeights:
    """Bilinear corner indices/weights (advance.f90:208-218); for global
    grids the +1 column wraps cyclically."""
    ix = _floor_index(x, nx - 2)
    jy = _floor_index(y, ny - 2)
    ddx = torch.clamp(x - ix, 0.0, 1.0)
    ddy = torch.clamp(y - jy, 0.0, 1.0)
    rddx = 1.0 - ddx
    rddy = 1.0 - ddy
    p4 = torch.stack([rddx * rddy, ddx * rddy, rddx * ddy, ddx * ddy], dim=0)
    ixp = ix + 1
    if xglobal:
        ixp = torch.where(ixp > nx - 1, torch.zeros_like(ixp), ixp)
    jyp = torch.clamp(jy + 1, max=ny - 1)
    base = jy.long() * nx
    basep = jyp.long() * nx
    idx4 = torch.stack([base + ix, base + ixp, basep + ix, basep + ixp], dim=0)
    return HorizWeights(ix=ix, jy=jy, idx4=idx4, p4=p4)


def vert_weights(z, height):
    """Bracketing z-levels and upper-level weight (interpol_all.f90:118-126);
    ``side="right"`` is ``right=True``."""
    nz = height.shape[0]
    indz = torch.clamp(torch.searchsorted(height, z, right=True) - 1, 0, nz - 2)
    h0 = height[indz]
    h1 = height[indz + 1]
    dz1 = torch.clamp((z - h0) / (h1 - h0), 0.0, 1.0)
    return indz, dz1


@dataclasses.dataclass
class WindInterp:
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    rho: torch.Tensor
    drhodz: torch.Tensor
    usig: torch.Tensor
    vsig: torch.Tensor
    wsig: torch.Tensor


@dataclasses.dataclass
class StepTablesQuad:
    """Per-step quad-corner row tables (see csrc/quad_tables.cu for the
    lane layout, which is the JAX package's)."""
    rows: torch.Tensor    # (R, 64), R = (nz-1)*ny*nx
    rowsE: torch.Tensor   # (R, 32): the end-time u, v, w pairs, lanes 24-31
                          # zero (the JAX table pads to 64 lanes)


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once on every device.  torch's CUDA division by a
    Python scalar multiplies by the scalar's reciprocal (two roundings);
    a kernel and its twin that must agree bitwise divide like this."""
    return a / torch.full_like(a, b)


def _corners4(a):
    """One field at its cell's 4 corners: x+1 cyclic roll, y+1 clamped at
    the last row (never gathered for limited-area grids)."""
    ax = torch.roll(a, -1, dims=-1)
    ay = torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)
    axy = torch.roll(ay, -1, dims=-1)
    return (a, ax, ay, axy)


def _sum4(c):
    return ((c[0] + c[1]) + c[2]) + c[3]


def _cell_sigma8(f0, f1):
    """Per-cell 8-sample wind sigma of one field (nz, ny, nx): std over the
    4 corners x 2 time levels per level (interpol_all.f90:216-240, var/7),
    averaged over the bracketing level pair -> (nz-1, ny, nx)."""
    c0 = _corners4(f0)
    c1 = _corners4(f1)
    sl = _sum4(c0) + _sum4(c1)
    sq = _sum4([a * a for a in c0]) + _sum4([b * b for b in c1])
    var = sq - sl * sl / 8.0
    sig = torch.where(var < 1.0e-30, torch.zeros_like(var),
                      torch.sqrt(true_div(torch.clamp(var, min=0.0), 7.0)))
    return 0.5 * (sig[:-1] + sig[1:])


def quad_tables_plain(f3d0, f3d1, f2d0, f2d1, tw0: float, tw1: float,
                      ew0: float, ew1: float, dtype) -> StepTablesQuad:
    """Plain PyTorch twin of K2, in the kernel's order of operations."""
    nz = f3d0.shape[1]
    nzp = nz - 1
    lanes = []
    for f in _WIND_FIELDS:
        blend = f3d0[f] * tw0 + f3d1[f] * tw1
        for lev in (0, 1):
            lanes.extend(_corners4(blend[lev:lev + nzp]))
    pack2d = [torch.maximum(f2d0[F2_HMIX], f2d1[F2_HMIX]), f2d0[F2_TROPO]]
    pack2d += [f2d0[s] * tw0 + f2d1[s] * tw1
               for s in (F2_USTAR, F2_WSTAR, F2_OLI)]
    for a in pack2d:
        lanes.extend(c.expand((nzp,) + c.shape) for c in _corners4(a))
    for f in (F3_U, F3_V, F3_W):
        lanes.append(_cell_sigma8(f3d0[f], f3d1[f]))
    zero = torch.zeros_like(lanes[0])
    lanes.append(zero)
    rows = torch.stack(lanes, dim=-1).to(dtype).reshape(-1, ROWS_LANES)

    lanes_e = []
    for f in (F3_U, F3_V, F3_W):
        blend = f3d0[f] * ew0 + f3d1[f] * ew1
        for lev in (0, 1):
            lanes_e.extend(_corners4(blend[lev:lev + nzp]))
    lanes_e.extend([zero] * (ROWS_E_LANES - len(lanes_e)))
    rows_e = torch.stack(lanes_e, dim=-1).to(dtype).reshape(-1, ROWS_E_LANES)
    return StepTablesQuad(rows=rows, rowsE=rows_e)


def quad_tables_cuda(f3d0, f3d1, f2d0, f2d1, tw0: float, tw1: float,
                     ew0: float, ew1: float, dtype) -> StepTablesQuad:
    """K2 launch on the device of ``f3d0``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quad tables are float32 or bfloat16, not {dtype}")
    for t in (f3d0, f3d1, f2d0, f2d1):
        if t.device != f3d0.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("K2 takes contiguous float32 fields on one device")
    if f3d1.shape != f3d0.shape or f2d1.shape != f2d0.shape \
            or f2d0.shape[1:] != f3d0.shape[2:] or f3d0.shape[0] < 5 \
            or f2d0.shape[0] <= F2_OLI:
        raise ValueError("K2: mismatched field shapes")
    nz, ny, nx = f3d0.shape[1:]
    r = (nz - 1) * ny * nx
    rows = torch.empty((r, ROWS_LANES), dtype=dtype, device=f3d0.device)
    rows_e = torch.empty((r, ROWS_E_LANES), dtype=dtype, device=f3d0.device)
    with torch.cuda.device(f3d0.device):
        stream = torch.cuda.current_stream(f3d0.device).cuda_stream
        _build.QUAD_TABLES(f3d0.data_ptr(), f3d1.data_ptr(), f2d0.data_ptr(),
                           f2d1.data_ptr(), nz, ny, nx, tw0, tw1, ew0, ew1,
                           int(dtype == torch.bfloat16), rows.data_ptr(),
                           rows_e.data_ptr(), stream)
    return StepTablesQuad(rows=rows, rowsE=rows_e)


def build_step_tables_quad(z0: ZFields, z1: ZFields, tw0: float, tw1: float,
                           ew0: float, ew1: float,
                           dtype=torch.float32) -> StepTablesQuad:
    """Per-step quad-corner row tables, built once per sync interval and
    shared by every particle chunk.  Time weights are float32 values held
    in Python floats.  K2 on CUDA, the plain twin on the CPU."""
    args = (z0.f3d, z1.f3d, z0.f2d, z1.f2d, tw0, tw1, ew0, ew1, dtype)
    dev = z0.f3d.device
    if dev.type == "cuda":
        return quad_tables_cuda(*args)
    if dev.type == "cpu":
        return quad_tables_plain(*args)
    raise ValueError(f"no quad-table backend for device {dev}")


def _cell_rowid(hw: HorizWeights, indz, nx: int, ny: int):
    return indz.long() * (ny * nx) + hw.jy.long() * nx + hw.ix


def _dot4(g, base: int, p4):
    """sum_c g[:, base+c] * p4[c], corners left to right."""
    return ((g[:, base] * p4[0] + g[:, base + 1] * p4[1])
            + g[:, base + 2] * p4[2]) + g[:, base + 3] * p4[3]


def _reduce_stencil15(g, hw: HorizWeights, dz1, x, y):
    """(N, 64) gathered quad rows (float32) -> the interp_all/interp_wind
    quantities: (h, tropop, ust, wst, ol, WindInterp)."""
    p4 = hw.p4
    val = []
    for f in range(5):
        lev0 = _dot4(g, (2 * f) * 4, p4)
        lev1 = _dot4(g, (2 * f + 1) * 4, p4)
        val.append(lev0 * (1.0 - dz1) + lev1 * dz1)
    wind = WindInterp(u=val[0], v=val[1], w=val[2], rho=val[3],
                      drhodz=val[4], usig=g[:, 60], vsig=g[:, 61],
                      wsig=g[:, 62])
    hq = g[:, 40:44]
    h = torch.clamp(torch.amax(hq, dim=1), min=1.0)
    ix_n = (x - hw.ix) >= 0.5
    iy_n = (y - hw.jy) >= 0.5
    tropop = torch.where(iy_n, torch.where(ix_n, g[:, 47], g[:, 46]),
                         torch.where(ix_n, g[:, 45], g[:, 44]))
    ust = _dot4(g, 48, p4)
    wst = _dot4(g, 52, p4)
    oliaux = _dot4(g, 56, p4)
    ol = torch.where(oliaux != 0.0, 1.0 / oliaux,
                     torch.full_like(oliaux, 99999.0))
    return h, tropop, ust, wst, ol, wind


def sample_all_quad(tables: StepTablesQuad, hw: HorizWeights, indz, dz1,
                    x, y, nx: int, ny: int):
    """Everything the PBL/FT integrator needs at the particle from ONE
    single-index row gather, widened to float32 right after the gather:
    (h, tropop, ust, wst, ol, WindInterp)."""
    g = tables.rows[_cell_rowid(hw, indz, nx, ny)].to(torch.float32)
    return _reduce_stencil15(g, hw, dz1, x, y)


def interp_wind_short_quad(rowsE, hw: HorizWeights, indz, dz1,
                           nx: int, ny: int):
    """Petterssen-corrector wind from the end-time quad table
    (interpol_wind_short.f90)."""
    g = rowsE[_cell_rowid(hw, indz, nx, ny)].to(torch.float32)
    out = []
    for f in range(3):
        lev0 = _dot4(g, (2 * f) * 4, hw.p4)
        lev1 = _dot4(g, (2 * f + 1) * 4, hw.p4)
        out.append(lev0 * (1.0 - dz1) + lev1 * dz1)
    return out[0], out[1], out[2]

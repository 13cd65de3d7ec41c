"""Sensitivity to initial conditions for backward runs (linit_cond).

Port of ``flexpart_tpu/grid/initcond.py`` (initial_cond_calc.f90 +
initial_cond_output.f90): when a particle terminates, and for every
survivor at the run's end, its mass (divided by the local air density for
``linit_cond`` = 1, initial_cond_calc.f90:44-87) is spread onto the output
grid with conccalc's uniform 4-point kernel (no age gate; one cell near
the grid's edges, initial_cond_calc.f90:120-196).  The field, divided by
the release mass, is written as ``grid_initial_nnn`` in the reference's
sparse format with empty wet and dry blocks.

``InitCondConfig``, ``zero_init_cond`` and ``write_initial_cond`` are the
JAX package's, copied.  The scatter is kernel K17 (``csrc/initcond.cu``:
warps walk spans of slots, take the masked particles 32 at a time, and
sum the pairs of a plume in per-warp tables in shared memory keyed by
grid row, as K8 does; ``k17_plan`` makes its launch) on CUDA tensors and
``initcond_plain`` (``index_add_`` of ``initcond_pairs``) on CPU tensors;
``initcond_scatter`` picks by device.
Both add into the grid in place.

The mask of the particles that died in a step is the active mask before
the advance, taken after the step's sort, and not after it.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..core.interp import horiz_weights, true_div, vert_weights
from ..core.state import Particles
from ..io.fortran_writer import _rec, _sparse_block
from ..met.fields import F3_RHO, ZFields

_BIG = float(2 ** 30)

# K17's launch plan (csrc/initcond.cu's constants): blocks of K17_THREADS
# threads, K17_MIN_BLOCKS of them resident per SM, K17_WAVES times as many
# blocks as stay resident (so that the blocks whose span a plume fills are
# spread over the card as others end), each warp walking a span of slots
# (a multiple of K17_ROUND, the slots whose mask a warp reads in a round)
# with a table in shared memory of a power of two slots, at least
# K17_MIN_SLOTS, each a key and nspec values, within about K17_TABLE_BYTES
K17_THREADS = 256
K17_WARPS = K17_THREADS // 32
K17_MIN_BLOCKS = 4
K17_WAVES = 4
K17_ROUND = 128
K17_TABLE_BYTES = 3072
K17_MIN_SLOTS = 64
K17_MAX_SPECIES = 32
# K17 matches grid rows on 32 bits, below the key of an empty slot
K17_MAX_ROWS = 0xFFFFFFFF - 32


class K17Plan(NamedTuple):
    blocks: int
    span: int          # slots a warp walks
    slots: int         # slots of a warp's table


def k17_plan(n: int, nspec: int, sms: int,
             waves: int = K17_WAVES) -> K17Plan:
    """K17's launch on a card of ``sms`` SMs: ``waves`` times as many
    blocks as stay resident, each warp a contiguous span of the ``n``
    slots."""
    slots = K17_MIN_SLOTS
    while 2 * slots * (4 + 4 * nspec) <= K17_TABLE_BYTES:
        slots *= 2
    warps = sms * K17_MIN_BLOCKS * K17_WARPS * waves
    span = -(-n // warps)
    span = max(K17_ROUND, -(-span // K17_ROUND) * K17_ROUND)
    blocks = -(-n // (span * K17_WARPS))
    return K17Plan(blocks, span, slots)


class InitCondConfig(NamedTuple):
    nxg: int
    nyg: int
    nzg: int
    npointspec: int
    dxout: float
    dyout: float
    xoutshift: float
    youtshift: float
    dx_met: float
    dy_met: float
    linit_cond: int          # 1: divide by air density, 2: plain mass
    ioutputforeachrelease: bool = True


def zero_init_cond(cfg: InitCondConfig, nspec: int,
                   device="cpu") -> torch.Tensor:
    return torch.zeros((cfg.npointspec, cfg.nzg, cfg.nyg, cfg.nxg, nspec),
                       dtype=torch.float32, device=device)


def rho_at(p: Particles, zf: ZFields) -> torch.Tensor:
    """Air density at the particles: bilinear in the horizontal (no
    cyclic column), linear in height (initial_cond_calc.f90:44-87)."""
    nx_m, ny_m = zf.f3d.shape[3], zf.f3d.shape[2]
    hw = horiz_weights(p.x, p.y, nx_m, ny_m, False)
    indz, dz1 = vert_weights(p.z, zf.height)
    rho_flat = zf.f3d[F3_RHO].reshape(-1)
    lin0 = indz.long()[None, :] * (ny_m * nx_m) + hw.idx4
    g_lo = rho_flat[lin0]
    g_hi = rho_flat[lin0 + ny_m * nx_m]
    rho_lo = (((g_lo[0] * hw.p4[0] + g_lo[1] * hw.p4[1]) + g_lo[2] * hw.p4[2])
              + g_lo[3] * hw.p4[3])
    rho_hi = (((g_hi[0] * hw.p4[0] + g_hi[1] * hw.p4[1]) + g_hi[2] * hw.p4[2])
              + g_hi[3] * hw.p4[3])
    return rho_lo * (1.0 - dz1) + rho_hi * dz1


def initcond_pairs(p: Particles, mask: torch.Tensor, zf: ZFields,
                   outheight: torch.Tensor, cfg: InitCondConfig):
    """What each masked particle adds: rows ``lin`` (N, 4) of
    ``grid.view(-1, nspec)``, their validity (N, 4) and the values (N, 4,
    nspec)."""
    n = p.capacity
    x, y, z = p.x, p.y, p.z
    if cfg.linit_cond == 1:
        rhoi = rho_at(p, zf)
    else:
        rhoi = torch.ones_like(z)
    kz = torch.searchsorted(outheight, z, right=True)
    in_z = kz < cfg.nzg
    kz = torch.clamp(kz, max=cfg.nzg - 1)
    xl = true_div(x * cfg.dx_met + cfg.xoutshift, cfg.dxout)
    yl = true_div(y * cfg.dy_met + cfg.youtshift, cfg.dyout)
    ix = torch.clamp(torch.floor(xl), -_BIG, _BIG).to(torch.int64)
    jy = torch.clamp(torch.floor(yl), -_BIG, _BIG).to(torch.int64)
    near_edge = ((xl < 0.5) | (yl < 0.5)
                 | (xl > cfg.nxg - 1 - 0.5) | (yl > cfg.nyg - 1 - 0.5))
    ddx = xl - ix
    ddy = yl - jy
    hi_x = ddx > 0.5
    hi_y = ddy > 0.5
    ixp = torch.where(hi_x, ix + 1, ix - 1)
    jyp = torch.where(hi_y, jy + 1, jy - 1)
    wx = torch.where(hi_x, 1.5 - ddx, 0.5 + ddx)
    wy = torch.where(hi_y, 1.5 - ddy, 0.5 + ddy)
    cx = torch.stack([ix, ix, ixp, ixp], dim=1)
    cy = torch.stack([jy, jyp, jy, jyp], dim=1)
    w4 = torch.stack([wx * wy, wx * (1 - wy), (1 - wx) * wy,
                      (1 - wx) * (1 - wy)], dim=1)
    one_hot = torch.zeros((n, 4), dtype=torch.float32, device=p.device)
    one_hot[:, 0] = 1.0
    w4 = torch.where(near_edge[:, None], one_hot, w4)
    in_grid = (cx >= 0) & (cx < cfg.nxg) & (cy >= 0) & (cy < cfg.nyg)
    valid = mask[:, None] & in_z[:, None] & in_grid & (w4 > 0)
    kp = (p.npoint if cfg.ioutputforeachrelease
          else torch.zeros_like(p.npoint)).long()
    cell = kp * cfg.nzg + kz
    lin = cell[:, None] * (cfg.nyg * cfg.nxg) + cy * cfg.nxg + cx
    lin = torch.where(valid, lin, torch.zeros_like(lin))
    contrib = (w4 / rhoi[:, None])[..., None] * p.mass[:, None, :]
    return lin, valid, contrib


def initcond_plain(grid: torch.Tensor, p: Particles, mask: torch.Tensor,
                   zf: ZFields, outheight: torch.Tensor,
                   cfg: InitCondConfig) -> None:
    """Plain twin of K17: add into ``grid`` in place."""
    lin, valid, contrib = initcond_pairs(p, mask, zf, outheight, cfg)
    grid.view(-1, p.nspec).index_add_(0, lin[valid], contrib[valid])


_SMS = {}


def _sm_count(dev) -> int:
    """The card's SMs, read once per device (k17_plan's input)."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def initcond_cuda(grid: torch.Tensor, p: Particles, mask: torch.Tensor,
                  zf: ZFields, outheight: torch.Tensor,
                  cfg: InitCondConfig) -> None:
    """K17 launch: add into ``grid`` in place."""
    dev = grid.device
    n = p.capacity
    f32, i32 = torch.float32, torch.int32
    want = {"x_hi": f32, "x_lo": f32, "y_hi": f32, "y_lo": f32, "z": f32,
            "npoint": i32, "mass": f32}
    for name, dt in want.items():
        t = getattr(p, name)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape[0] != n:
            raise ValueError(f"K17: particle field {name} must be contiguous "
                             f"{dt} with {n} rows on {dev}")
    rho = zf.f3d[F3_RHO]
    for t, dt, name in ((mask, torch.bool, "mask"), (rho, f32, "rho"),
                        (zf.height, f32, "height"),
                        (outheight, f32, "outheight"), (grid, f32, "grid")):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"K17: {name} must be contiguous {dt} on {dev}")
    if tuple(mask.shape) != (n,):
        raise ValueError(f"K17: mask must be ({n},)")
    if tuple(grid.shape) != (cfg.npointspec, cfg.nzg, cfg.nyg, cfg.nxg,
                             p.nspec):
        raise ValueError("K17: grid does not match the configuration")
    if n >= 2 ** 31 - 256:
        raise ValueError("K17 indexes particles with int32")
    if not 1 <= p.nspec <= K17_MAX_SPECIES:
        raise ValueError(f"K17 takes 1 to {K17_MAX_SPECIES} species")
    if grid.numel() // p.nspec > K17_MAX_ROWS:
        raise ValueError(f"K17 matches grid rows by a 32-bit index: "
                         f"{grid.numel() // p.nspec} rows exceed "
                         f"{K17_MAX_ROWS}")
    if mask.data_ptr() % 4:
        mask = mask.clone()            # K17 reads four bytes of it at once
    nz, ny, nx = rho.shape
    plan = k17_plan(n, p.nspec, _sm_count(dev))

    def c(v):
        return float(np.float32(v))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.INITCOND(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), p.npoint.data_ptr(),
            p.mass.data_ptr(), mask.data_ptr(), rho.data_ptr(),
            zf.height.data_ptr(), nz, ny, nx, int(cfg.linit_cond == 1),
            outheight.data_ptr(), cfg.nzg, n, p.nspec, cfg.nxg, cfg.nyg,
            cfg.npointspec, int(cfg.ioutputforeachrelease), c(cfg.dx_met),
            c(cfg.dy_met), c(cfg.xoutshift), c(cfg.youtshift),
            c(cfg.dxout), c(cfg.dyout), grid.data_ptr(), *plan, stream)


def initcond_scatter(grid: torch.Tensor, p: Particles, mask: torch.Tensor,
                     zf: ZFields, outheight: torch.Tensor,
                     cfg: InitCondConfig) -> None:
    """Add mass[/rho] of the ``mask`` particles into ``grid`` in place:
    K17 on CUDA, the plain twin on the CPU."""
    run = {"cuda": initcond_cuda,
           "cpu": initcond_plain}.get(grid.device.type)
    if run is None:
        raise ValueError(f"no initial-condition backend for device "
                         f"{grid.device}")
    run(grid, p, mask, zf, outheight, cfg)


def make_initcond_scatter(outheights, device):
    """Bind the output levels, return ``(grid, p, mask, zf, cfg) -> None``
    (in place)."""
    oh = torch.as_tensor(np.asarray(outheights, np.float32), device=device)

    def run(grid, p, mask, zf, cfg):
        initcond_scatter(grid, p, mask, zf, oh, cfg)

    return run


def write_initial_cond(outdir, itime: int, grid, release_mass,
                       fact_recept=None):
    """grid_initial_nnn files (initial_cond_output.f90:60-131).

    grid: (kp, nz, ny, nx, nspec); release_mass: (kp, nspec) total mass
    per release point and species; fact_recept: optional (kp,) density
    factor for ind_rel=1 runs (rho_rel), else 1."""
    g = np.asarray(grid)
    npoint, nz, ny, nx, nspec = g.shape
    if fact_recept is None:
        fact_recept = np.ones(npoint, np.float32)
    for ks in range(nspec):
        out = bytearray(_rec(struct.pack("<i", int(itime))))
        for kp in range(npoint):
            empty = _sparse_block(np.zeros(0, np.float32))
            out += empty + empty      # dummy wet + dry blocks
            xm = release_mass[kp][ks] if release_mass is not None else 1.0
            xm = xm if xm > 0 else 1.0
            field = g[kp, :, :, :, ks] / xm * fact_recept[kp]
            out += _sparse_block(field.ravel(), index_offset=nx * ny)
        Path(outdir, f"grid_initial_{ks + 1:03d}").write_bytes(bytes(out))

"""Receptor-point concentration sampling.

Port of ``flexpart_tpu/grid/receptors.py`` (conccalc.f90:430-498): an
age-broadened Epanechnikov kernel gathers the mass of live particles near
fixed receptor points.  ``build_receptors`` is the JAX package's numpy
code, copied.  The sampling is kernel K15 (``csrc/receptors.cu``) on CUDA
tensors and ``sample_receptors_plain``, its twin, on CPU tensors;
``sample_receptors`` picks by device and never falls from one to the
other.

JAX builds an (R, N) matrix of kernel weights and multiplies it by the
mass.  K15 runs one thread per particle instead and sums in a fixed order:
the 32 lanes of a warp by a shuffle-down tree, the 8 warps of a block in
warp order, then the block partials of each (receptor, species) by a
second launch, 256 threads each adding every 256th partial in block order
and a shared-memory tree over the 256.  The twin adds in exactly that
order, so the two agree bit for bit; both differ from JAX's product by
rounding only.

K15 divides only where a pair can be inside: ``may_be_inside`` is its gate
in torch (live, |z| < hz, |x - rx| < |hx|, |y - ry| < |hy|, each with the
float difference the division takes), which no inside pair fails, because
a quotient of magnitude at least 1 makes r2 at least 1 after rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from ..constants import PI, R_EARTH
from ..core.state import Particles

# csrc/receptors.cu: threads per block of the first pass and of the second
THREADS = 256
WARP = 32
# receptors a run may sample (K15 keeps a block's partials of every
# (receptor, species) in shared memory: 8 warps x R x nspec floats)
MAX_RECEPTORS = 64
MAX_RECEPTOR_VALUES = 1536          # R x nspec, 48 KiB of partials
HZMAX, HXMAX, HYMAX = 150.0, 6.0, 4.0    # conccalc.f90:42 caps
EPANECHNIKOV = 0.596831                  # 15 / (8 pi)


@dataclasses.dataclass
class ReceptorSet:
    """The receptors' positions in grid units and cell areas [m2]
    (openreceptors.f90), each (R,) float32 on the run's device."""
    x: torch.Tensor
    y: torch.Tensor
    area: torch.Tensor


def build_receptors(receptors, grid, device="cpu"):
    """Returns (ReceptorSet, names) or (None, ())."""
    if not receptors:
        return None, ()
    if len(receptors) > MAX_RECEPTORS:
        raise ValueError(f"{len(receptors)} receptors: the port samples at "
                         f"most MAX_RECEPTORS = {MAX_RECEPTORS}")
    xs, ys, areas, names = [], [], [], []
    for r in receptors:
        x, y = grid.lonlat_to_grid(r.lon, r.lat)
        xs.append(float(x))
        ys.append(float(y))
        # grid-cell area at the receptor latitude (openreceptors.f90)
        ylat = r.lat
        area = (2.0 * PI * R_EARTH / 360.0 * grid.dy) \
            * (2.0 * PI * R_EARTH / 360.0 * grid.dx
               * np.cos(np.deg2rad(ylat)))
        areas.append(area)
        names.append(r.name)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return ReceptorSet(x=f32(xs), y=f32(ys), area=f32(areas)), tuple(names)


def _check(rec: ReceptorSet, creceptor: torch.Tensor, p: Particles) -> None:
    r = rec.x.shape[0]
    if r > MAX_RECEPTORS:
        raise ValueError(f"{r} receptors exceed MAX_RECEPTORS = "
                         f"{MAX_RECEPTORS}")
    if r * p.nspec > MAX_RECEPTOR_VALUES:
        raise ValueError(f"{r} receptors x {p.nspec} species exceed "
                         f"MAX_RECEPTOR_VALUES = {MAX_RECEPTOR_VALUES}")
    if tuple(creceptor.shape) != (r, p.nspec):
        raise ValueError(f"creceptor must be ({r}, {p.nspec})")


def kernel_widths(p: Particles, dx: float, dy: float):
    """The kernel's half widths (hx, hy, hz) at each particle's age."""
    itage = torch.abs(p.itra - p.itramem).to(torch.float32)
    s = torch.sqrt(itage)
    hz = torch.clamp(50.0 + 0.3 * s, max=HZMAX)
    hx = torch.clamp((0.29 + 2.222e-3 * s) * dx + itage * 1.2e-5, max=HXMAX)
    hy = torch.clamp((0.18 + 1.389e-3 * s) * dy + itage * 7.5e-6, max=HYMAX)
    return hx, hy, hz


def receptor_r2(rec: ReceptorSet, p: Particles, r: int, hx, hy,
                hz) -> torch.Tensor:
    """(N,) r2 = ((x - rx) / hx)**2 + ((y - ry) / hy)**2 + (z / hz)**2 of
    each particle at receptor ``r``: inside where r2 < 1."""
    zd = p.z / hz
    xd = (p.x - rec.x[r]) / hx
    yd = (p.y - rec.y[r]) / hy
    return xd * xd + yd * yd + zd * zd


def receptor_weights(rec: ReceptorSet, p: Particles, itime: int, r: int,
                     hx, hy, hz) -> torch.Tensor:
    """(N,) the kernel weight of each particle at receptor ``r``: 0 where
    it is not live or not inside."""
    live = p.active & (p.itra == itime)
    r2 = receptor_r2(rec, p, r, hx, hy, hz)
    inside = (r2 < 1.0) & live
    xkern = EPANECHNIKOV * (1.0 - r2) / (hx * hy * hz)
    return torch.where(inside, xkern, torch.zeros_like(xkern))


def may_be_inside(rec: ReceptorSet, p: Particles, itime: int, r: int, hx,
                  hy, hz) -> torch.Tensor:
    """(N,) K15's gate at receptor ``r``: False where the pair cannot be
    inside, so the kernel skips its divisions.  |x - rx| >= |hx| (the float
    difference) gives |fl((x - rx) / hx)| >= 1, so r2 >= 1, and so do y
    against hy and |z| >= hz; a NaN fails every test, as it fails r2 < 1."""
    live = p.active & (p.itra == itime)
    return (live & (p.z.abs() < hz) & ((p.x - rec.x[r]).abs() < hx.abs())
            & ((p.y - rec.y[r]).abs() < hy.abs()))


def ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of ``v`` (N,) in K15's order: a shuffle-down tree per warp
    of 32, the 8 warps of a block of 256 in order, then every 256th block
    partial in block order per thread of 256 and a tree over them."""
    n = v.shape[0]
    blocks = max(-(-n // THREADS), 1)
    x = torch.zeros(blocks * THREADS, dtype=v.dtype, device=v.device)
    x[:n] = v
    x = x.view(blocks, THREADS // WARP, WARP)
    w = WARP
    while w > 1:
        w //= 2
        x = x[..., :w] + x[..., w:2 * w]
    warps = x[..., 0]                                    # (blocks, 8)
    part = warps[:, 0]
    for k in range(1, THREADS // WARP):
        part = part + warps[:, k]
    q = -(-blocks // THREADS)
    y = torch.zeros(q * THREADS, dtype=v.dtype, device=v.device)
    y[:blocks] = part
    y = y.view(q, THREADS)
    acc = torch.zeros(THREADS, dtype=v.dtype, device=v.device)
    for i in range(q):
        acc = acc + y[i]
    w = THREADS
    while w > 1:
        w //= 2
        acc = acc[:w] + acc[w:2 * w]
    return acc[0]


def sample_receptors_plain(creceptor: torch.Tensor, rec: ReceptorSet,
                           p: Particles, itime: int, weight: float,
                           dx: float, dy: float) -> torch.Tensor:
    """Plain twin of K15: a new (R, nspec) creceptor."""
    _check(rec, creceptor, p)
    hx, hy, hz = kernel_widths(p, dx, dy)
    nrec, nspec = creceptor.shape
    c = torch.zeros((nrec, nspec), dtype=torch.float32, device=p.device)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    for r in range(nrec):
        w = receptor_weights(rec, p, itime, r, hx, hy, hz)
        for k in range(nspec):
            c[r, k] = ordered_sum(torch.where(w != 0.0, w * p.mass[:, k],
                                              zero))
    w2 = float(np.float32(2.0 * np.float32(weight)))
    return creceptor + w2 * c / rec.area[:, None]


def sample_receptors_cuda(creceptor: torch.Tensor, rec: ReceptorSet,
                          p: Particles, itime: int, weight: float,
                          dx: float, dy: float) -> torch.Tensor:
    """K15 launch: a new (R, nspec) creceptor on the card."""
    _check(rec, creceptor, p)
    dev = p.device
    n = p.capacity
    f32, i32 = torch.float32, torch.int32
    want = {"x_hi": f32, "x_lo": f32, "y_hi": f32, "y_lo": f32, "z": f32,
            "itra": i32, "itramem": i32, "active": torch.bool, "mass": f32}
    for name, dt in want.items():
        t = getattr(p, name)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape[0] != n:
            raise ValueError(f"K15: particle field {name} must be contiguous "
                             f"{dt} with {n} rows on {dev}")
    for name in ("x", "y", "area"):
        t = getattr(rec, name)
        if t.device != dev or t.dtype != f32 or not t.is_contiguous():
            raise ValueError(f"K15: receptor {name} must be contiguous "
                             f"float32 on {dev}")
    if creceptor.device != dev or creceptor.dtype != f32 \
            or not creceptor.is_contiguous():
        raise ValueError("K15: creceptor must be contiguous float32")
    if n >= 2 ** 31 - THREADS:
        raise ValueError("K15 indexes particles with int32")
    nrec, nspec = creceptor.shape
    out = torch.empty_like(creceptor)
    blocks = max(-(-n // THREADS), 1)
    partials = torch.empty(nrec * nspec * blocks, dtype=f32, device=dev)

    def c(v):
        return float(np.float32(v))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.RECEPTORS(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), p.itra.data_ptr(),
            p.itramem.data_ptr(), p.active.data_ptr(), p.mass.data_ptr(),
            rec.x.data_ptr(), rec.y.data_ptr(), rec.area.data_ptr(),
            n, nspec, nrec, int(itime), c(dx), c(dy),
            c(2.0 * np.float32(weight)), creceptor.data_ptr(),
            partials.data_ptr(), blocks, out.data_ptr(), stream)
    return out


def sample_receptors(creceptor: torch.Tensor, rec: ReceptorSet,
                     p: Particles, itime: int, weight: float, dx: float,
                     dy: float) -> torch.Tensor:
    """One sampling pass (conccalc.f90:430-498): K15 on CUDA, the plain
    twin on the CPU.  Returns creceptor + 2 weight c / area, (R, nspec)."""
    run = {"cuda": sample_receptors_cuda,
           "cpu": sample_receptors_plain}.get(p.device.type)
    if run is None:
        raise ValueError(f"no receptor backend for device {p.device}")
    return run(creceptor, rec, p, itime, weight, dx, dy)

"""Backward deposition source-receptor modes (WETBKDEP / DRYBKDEP).

Port of ``flexpart_tpu/physics/bkdep.py`` (readcommand.f90:316-339,
timemanager.f90:565-598 of the reference).  In a backward run with
``ind_receptor`` 3 or 4 each particle is assigned, once, at its first step
after its release, a scavenging factor ``xscav`` (the release marks it -1):

* WETBKDEP: lambda * column height * the precipitating fraction, from the
  wet scavenging coefficient at the particle (timemanager.f90:585-596);
* DRYBKDEP: the dry deposition velocity at the particle
  (get_vdep_prob.f90:43-61);
* where the factor is not above 0 the particle's mass is zeroed, so that it
  never contributes (timemanager.f90:572-578).

Sampling then multiplies every contribution by max(xscav, 0)
(``grid/conccalc.py``, K3's ``BKDEP`` instantiation).

Two versions of each assignment: the plain PyTorch functions of this
module, which run for CPU tensors, and the ``BKDEP`` instantiations of K9
(``csrc/wetdepo.cu``: K9's own lambda and fraction path, with its
``CLWC`` instantiation's cloud water for ``use_clwc``) and K10
(``csrc/drydepo.cu``: K10's own ``vdep`` gather, the 4-point
``horiz_weights`` sum of the JAX function), which run for CUDA tensors.
``assign_wetbkdep`` and ``assign_drybkdep`` pick by device and never fall
from one to the other.  ``write_precip`` is host work.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..core.interp import horiz_weights, interp_2d
from ..core.state import Particles
from ..met.fields import (F2_CONVPREC, F2_CTWC, F2_LSPREC, F2_TCC, F3_TT,
                          ZFields)
from .massupdate import MAX_SPECIES, MassSpecies
from .wetdepo import wet_specs, wetscav_all_plain

# the column of a WETBKDEP release (readcommand.f90:322-328), the factor's
# height
WETBKDEP_COLUMN = 20000.0


def _fresh(p: Particles) -> torch.Tensor:
    """The particles whose factor is still to be assigned."""
    return p.active & (p.xscav[:, 0] < 0.0)


def _assign(p: Particles, fresh: torch.Tensor, xs_new: torch.Tensor):
    """xscav = max(xs_new, 0) and the mass zeroed where xs_new <= 0, for
    the fresh particles (N, nspec)."""
    f = fresh[:, None]
    xs = torch.where(f, torch.maximum(xs_new, torch.zeros_like(xs_new)),
                     p.xscav)
    mass = torch.where(f & (xs_new <= 0.0), torch.zeros_like(p.mass), p.mass)
    return p.replace(xscav=xs, mass=mass)


def assign_drybkdep_plain(p: Particles, vdep_field: torch.Tensor) -> Particles:
    """DRYBKDEP factor: the deposition velocity (nspec, ny, nx) bilinear at
    the particle (``bkdep.py:30-41`` there)."""
    ny, nx = vdep_field.shape[1], vdep_field.shape[2]
    hw = horiz_weights(p.x, p.y, nx, ny, False)
    vd = interp_2d(vdep_field, range(vdep_field.shape[0]), hw)   # (nspec, N)
    return _assign(p, _fresh(p), vd.T)


def assign_wetbkdep_plain(p: Particles, zf: ZFields, species: tuple,
                          column_height: float = WETBKDEP_COLUMN,
                          use_clwc: bool = False) -> Particles:
    """WETBKDEP factor: lambda * column_height * grfraction of the wet
    scavenging coefficient at the particle (``bkdep.py:44-55`` there), the
    in-cloud cloud water from the precipitation rate or, with
    ``use_clwc``, from the column cloud water."""
    lam, grfrac = wetscav_all_plain(p, zf, species, use_clwc)
    xs_new = (lam * float(column_height) * grfrac[None, :]).T
    return _assign(p, _fresh(p), xs_new)


def _check_particles(p: Particles, what: str, names) -> None:
    n, dev = p.capacity, p.device
    if n >= 2 ** 31:
        raise ValueError(f"{what} indexes particles with int32")
    if not 1 <= p.nspec <= MAX_SPECIES:
        raise ValueError(f"{what} takes 1 to {MAX_SPECIES} species")
    for name in names:
        t = getattr(p, name)
        want = torch.bool if name == "active" else torch.float32
        shape = (n, p.nspec) if name in ("mass", "xscav") else (n,)
        if t.device != dev or t.dtype != want or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: particle field {name} must be "
                             f"contiguous {want} {shape} on {dev}")


def assign_drybkdep_cuda(p: Particles, vdep_field: torch.Tensor) -> Particles:
    """K10's ``BKDEP`` instantiation: one thread per particle, mass and
    xscav written out of place."""
    n, nspec, dev = p.capacity, p.nspec, p.device
    _check_particles(p, "K10 BKDEP", ("x_hi", "x_lo", "y_hi", "y_lo",
                                      "active", "mass", "xscav"))
    if vdep_field.device != dev or vdep_field.dtype != torch.float32 \
            or vdep_field.dim() != 3 or vdep_field.shape[0] != nspec \
            or not vdep_field.is_contiguous():
        raise ValueError(f"K10 BKDEP: vdep must be contiguous float32 "
                         f"({nspec}, ny, nx) on {dev}")
    ny, nx = vdep_field.shape[1], vdep_field.shape[2]
    if ny < 2 or nx < 2 or ny * nx >= 2 ** 31:
        raise ValueError("K10 BKDEP: vdep needs 2 to 2**31 - 1 cells per "
                         "species, at least 2 x 2")
    mass, xscav = torch.empty_like(p.mass), torch.empty_like(p.xscav)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            # fp_drydepo with xscav given; z, mass0, t_below, the species,
            # the times, minmass, active_out and deposit unused
            _build.DRYDEPO_BKDEP(
                p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
                p.y_lo.data_ptr(), None, p.active.data_ptr(),
                p.mass.data_ptr(), None, p.xscav.data_ptr(),
                vdep_field.data_ptr(), ny, nx, None, None, n, nspec, 0, 0,
                0.0, mass.data_ptr(), None, None, xscav.data_ptr(), stream)
    return p.replace(mass=mass, xscav=xscav)


def assign_wetbkdep_cuda(p: Particles, zf: ZFields, species: tuple,
                         column_height: float = WETBKDEP_COLUMN,
                         use_clwc: bool = False) -> Particles:
    """K9's ``BKDEP`` instantiation (``BKDEP`` x ``CLWC`` with
    ``use_clwc``): one thread per particle, mass and xscav written out of
    place."""
    n, nspec, dev = p.capacity, p.nspec, p.device
    _check_particles(p, "K9 BKDEP", ("x_hi", "x_lo", "y_hi", "y_lo", "z",
                                     "active", "mass", "xscav"))
    if len(species) != nspec:
        raise ValueError("K9 BKDEP: species constants do not match the mass")
    nz, ny, nx = zf.clouds.shape
    for name, t, dt in (("f2d", zf.f2d, torch.float32),
                        ("f3d", zf.f3d, torch.float32),
                        ("clouds", zf.clouds, torch.int8),
                        ("height", zf.height, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"K9 BKDEP: {name} must be contiguous {dt} on "
                             f"{dev}")
    if tuple(zf.f2d.shape[1:]) != (ny, nx) or tuple(zf.f3d.shape[1:]) != (
            nz, ny, nx) or tuple(zf.height.shape) != (nz,) or nz < 2 \
            or ny < 2 or nx < 2 or nz * ny * nx >= 2 ** 31:
        raise ValueError("K9 BKDEP: met fields of mismatched or unsupported "
                         "shape")
    # K9 reads the species' scavenging rules; no decay applies here
    specs = wet_specs(species, MassSpecies(decay=(0.0,) * nspec,
                                           drydep=(False,) * nspec))
    mass, xscav = torch.empty_like(p.mass), torch.empty_like(p.xscav)
    launch = _build.WETDEPO_BKDEP_CLWC if use_clwc else _build.WETDEPO_BKDEP
    ctwc = zf.f2d[F2_CTWC].data_ptr() if use_clwc else None
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            # fp_wetdepo with xscav given; ltsample, ldeltat and deposit
            # unused
            launch(
                p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
                p.y_lo.data_ptr(), p.z.data_ptr(), p.active.data_ptr(),
                p.mass.data_ptr(), p.xscav.data_ptr(),
                zf.f2d[F2_LSPREC].data_ptr(), zf.f2d[F2_CONVPREC].data_ptr(),
                zf.f2d[F2_TCC].data_ptr(), ctwc, zf.clouds.data_ptr(),
                zf.f3d[F3_TT].data_ptr(), zf.height.data_ptr(), nz, ny, nx,
                ctypes.addressof(specs), n, nspec, 0, 0,
                float(np.float32(column_height)), mass.data_ptr(), None,
                xscav.data_ptr(), stream)
    return p.replace(mass=mass, xscav=xscav)


def _pick(p: Particles, what: str, cuda, plain):
    dev = p.device
    run = {"cuda": cuda, "cpu": plain}.get(dev.type)
    if run is None:
        raise ValueError(f"no {what} backend for device {dev}")
    return run


def assign_drybkdep(p: Particles, vdep_field: torch.Tensor) -> Particles:
    """The DRYBKDEP factor of every fresh particle: K10 ``BKDEP`` on a CUDA
    device, the plain version on the CPU.  A velocity field of one row
    (a run whose species do not deposit dry) holds for every species."""
    if vdep_field.shape[0] != p.nspec:
        vdep_field = vdep_field.expand(p.nspec, -1, -1).contiguous()
    return _pick(p, "DRYBKDEP", assign_drybkdep_cuda,
                 assign_drybkdep_plain)(p, vdep_field)


def assign_wetbkdep(p: Particles, zf: ZFields, species: tuple,
                    column_height: float = WETBKDEP_COLUMN,
                    use_clwc: bool = False) -> Particles:
    """The WETBKDEP factor of every fresh particle from the wind-field time
    level ``zf``, the in-cloud cloud water from the column's with
    ``use_clwc``: K9 ``BKDEP`` (``BKDEP`` x ``CLWC``) on a CUDA device, the
    plain version on the CPU."""
    return _pick(p, "WETBKDEP", assign_wetbkdep_cuda,
                 assign_wetbkdep_plain)(p, zf, species, column_height,
                                        use_clwc)


def write_precip(path, when, releases, grid, eta, first: bool) -> None:
    """wetscav_precip.txt: the release points' precipitation time series
    (writeprecip.f90:25-52) for WETBKDEP post-processing; one line per
    release box and met time, the large-scale and convective rates at the
    box's centre cell."""
    jjjjmmdd = when.year * 10000 + when.month * 100 + when.day
    ihmmss = when.hour * 10000 + when.minute * 100 + when.second
    lsp = eta.lsprec.cpu().numpy()
    cvp = eta.convprec.cpu().numpy()
    with open(path, "w" if first else "a") as f:
        for b in releases.boxes:
            x1, y1 = grid.lonlat_to_grid(b.lon1, b.lat1)
            x2, y2 = grid.lonlat_to_grid(b.lon2, b.lat2)
            ix = int((x1 + x2) / 2.0)
            jy = int((y1 + y2) / 2.0)
            f.write(f" {jjjjmmdd} {ihmmss} {b.lon1:.4f} {b.lat1:.4f} "
                    f"{lsp[jy, ix]:.6e} {cvp[jy, ix]:.6e}\n")

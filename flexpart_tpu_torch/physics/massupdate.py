"""Per-step particle mass updates: wet deposit, dry deposit, decay,
minmass termination.

Port of ``flexpart_tpu/physics/massupdate.py`` (wetdepo.f90:102-138 and
timemanager.f90:643-686 of the reference).  Two versions of the decay and
dry-deposition pass:

* ``apply_decay_drydep_plain``, plain PyTorch, which runs for CPU tensors;
* kernel K10 (``csrc/drydepo.cu``, one thread per particle: the ``vdep``
  gather, the dry-deposition probability, decay, the decay-corrected
  deposit and the minmass termination in one launch), which runs for CUDA
  tensors.

``apply_decay_drydep`` picks by device and never falls from one to the
other.  The wet pass's mass update (``apply_wetdepo_plain``) is the plain
half of kernel K9, whose wrapper lives in ``physics/wetdepo.py``.

Every quantity is an (N, nspec) / (nspec, N) tensor op; the species
constants are host numbers.  Both versions return new tensors (JAX's arrays
are immutable); ``decay_deposition_grids`` multiplies the grids in place.
The dry-deposition probability takes the fixed step's rule (below 2 HREF
for the whole interval) or, after an adaptive step, the seconds the
particle spent below 2 HREF (``t_below``; K10's ``T_BELOW``
instantiation on a CUDA device).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import HREF
from ..core.interp import horiz_weights, interp_2d, true_div
from ..core.state import Particles

TINY = float(np.finfo(np.float32).tiny)
# species per launch of K9 and K10: their constants travel by value in the
# kernel's parameters (MAX_SPECIES of csrc/wetdepo.cu and csrc/drydepo.cu)
MAX_SPECIES = 32


class MassSpecies(NamedTuple):
    """Static per-species mass-update constants."""
    decay: tuple            # (nspec,) decay constant [1/s]; <=0 off
    drydep: tuple           # (nspec,) bool
    minmass: float = 1.0e-4


def decay_factors(decay, seconds: int, device) -> torch.Tensor:
    """exp(seconds * decay) where decay > 0, else 1, in float32 on the
    device: the JAX package's ``jnp.where(dec > 0, jnp.exp(t * dec), 1)``
    with ``t`` an int32 number of seconds made float32."""
    dec = torch.as_tensor(decay, dtype=torch.float32, device=device)
    return torch.where(dec > 0.0, torch.exp(float(seconds) * dec),
                       torch.ones_like(dec))


def apply_wetdepo_plain(p: Particles, lam: torch.Tensor,
                        grfraction: torch.Tensor, ltsample: int,
                        ldeltat: int, sp: MassSpecies):
    """Wet-deposition mass removal (``massupdate.py:32-51`` there).

    lam: (nspec, N) scavenging coefficients (0 where none).  Returns
    (particles, deposit (nspec, N)) with the deposit already decay-corrected
    to the last gridded-decay time (ldeltat)."""
    lam_t = lam.T                                           # (N, nspec)
    wetdeposit = p.mass * (1.0 - torch.exp(-lam_t * float(abs(ltsample)))) \
        * grfraction[:, None]
    restmass = p.mass - wetdeposit
    new_mass = torch.where(restmass > TINY, restmass,
                           torch.zeros_like(restmass))
    corr = decay_factors(sp.decay, abs(ldeltat), p.device)
    deposit = (wetdeposit * corr[None, :]).T
    deposit = torch.where(p.active[None, :], deposit,
                          torch.zeros_like(deposit)).contiguous()
    return p.replace(mass=new_mass), deposit


def apply_decay_drydep_plain(p: Particles, vdep_field, lsynctime: int,
                             ldeltat: int, sp: MassSpecies, has_vdep: bool,
                             t_below=None):
    """Radioactive decay + dry-deposition mass removal + minmass
    termination (``massupdate.py:54-103`` there).

    vdep_field: (nspec, ny, nx) deposition velocities of the current wind
    field, bilinear at the particle, or None.  t_below: None (the fixed
    step: prob where z < 2 HREF) or the adaptive step's (N,) seconds below
    2 HREF (prob = 1 - exp(-vd t_below / 2 HREF), no z mask).  Returns
    (particles, drydeposit (nspec, N))."""
    n = p.capacity
    nspec = p.nspec
    dt = float(abs(lsynctime))
    decfact = decay_factors(sp.decay, -abs(lsynctime), p.device)  # (nspec,)
    if has_vdep:
        ny_m, nx_m = vdep_field.shape[1], vdep_field.shape[2]
        hw = horiz_weights(p.x, p.y, nx_m, ny_m, False)
        vd = interp_2d(vdep_field, range(nspec), hw)          # (nspec, N)
        if t_below is not None:
            prob = 1.0 - torch.exp(true_div(-vd * t_below[None, :],
                                            2.0 * HREF))
        else:
            prob = torch.where(p.z[None, :] < 2.0 * HREF,
                               1.0 - torch.exp(true_div(-vd * dt, 2.0 * HREF)),
                               torch.zeros_like(vd))
    else:
        prob = torch.zeros((nspec, n), dtype=torch.float32, device=p.device)
    drydep_mask = torch.as_tensor(np.asarray(sp.drydep, bool),
                                  device=p.device)
    prob_t = torch.where(drydep_mask[None, :], prob.T,
                         torch.zeros_like(prob.T))         # (N, nspec)
    drydeposit = p.mass * prob_t * decfact[None, :]
    new_mass = p.mass * (1.0 - prob_t) * decfact[None, :]
    corr = decay_factors(sp.decay, abs(ldeltat), p.device)
    deposit = (drydeposit * corr[None, :]).T
    deposit = torch.where(p.active[None, :], deposit,
                          torch.zeros_like(deposit)).contiguous()

    # minmass termination (timemanager.f90:662-686)
    frac = torch.where(p.mass0 > 0.0, new_mass / p.mass0,
                       torch.ones_like(new_mass))
    xmassfract = torch.amax(frac, dim=1)
    keep = xmassfract >= float(np.float32(sp.minmass))
    mass = torch.where(p.active[:, None], new_mass, p.mass)
    return p.replace(mass=mass, active=p.active & keep), deposit


class DrySpec(ctypes.Structure):
    """One species' constants for K10 (``DrySpec`` of csrc/drydepo.cu)."""
    _fields_ = [("dec", ctypes.c_float), ("drydep", ctypes.c_int)]


def decay_drydep_cuda(p: Particles, vdep_field, lsynctime: int, ldeltat: int,
                      sp: MassSpecies, has_vdep: bool, t_below=None):
    """K10 launch: one thread per particle, mass, active and the deposit
    written out of place; with ``t_below`` its ``T_BELOW`` instantiation."""
    n, nspec, dev = p.capacity, p.nspec, p.device
    if nspec > MAX_SPECIES:
        raise ValueError(f"K10 takes at most {MAX_SPECIES} species")
    if n >= 2 ** 31:
        raise ValueError("K10 indexes particles with int32")
    if len(sp.decay) != nspec or len(sp.drydep) != nspec:
        raise ValueError("K10: species constants do not match the mass")
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "active"):
        t = getattr(p, name)
        want = torch.bool if name == "active" else torch.float32
        if t.device != dev or t.dtype != want or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"K10: particle field {name} must be contiguous "
                             f"{want} ({n},) on {dev}")
    for name in ("mass", "mass0"):
        t = getattr(p, name)
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != (n, nspec) or not t.is_contiguous():
            raise ValueError(f"K10: {name} must be contiguous float32 "
                             f"({n}, {nspec}) on {dev}")
    ny = nx = 0
    if has_vdep:
        if vdep_field.device != dev or vdep_field.dtype != torch.float32 \
                or vdep_field.dim() != 3 or vdep_field.shape[0] != nspec \
                or not vdep_field.is_contiguous():
            raise ValueError(f"K10: vdep must be contiguous float32 "
                             f"({nspec}, ny, nx) on {dev}")
        ny, nx = vdep_field.shape[1], vdep_field.shape[2]
        if ny < 2 or nx < 2 or ny * nx >= 2 ** 31:
            raise ValueError("K10: vdep needs 2 to 2**31 - 1 cells per "
                             "species, at least 2 x 2")
    if t_below is not None and (
            t_below.device != dev or t_below.dtype != torch.float32
            or tuple(t_below.shape) != (n,) or not t_below.is_contiguous()):
        raise ValueError(f"K10: t_below must be contiguous float32 ({n},) "
                         f"on {dev}")
    specs = (DrySpec * MAX_SPECIES)()
    for s in range(nspec):
        specs[s].dec = float(sp.decay[s])
        specs[s].drydep = int(bool(sp.drydep[s]))
    mass = torch.empty_like(p.mass)
    active = torch.empty_like(p.active)
    deposit = torch.empty((nspec, n), dtype=torch.float32, device=dev)
    if n == 0:
        return p.replace(mass=mass, active=active), deposit
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.DRYDEPO(
            p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
            p.y_lo.data_ptr(), p.z.data_ptr(), p.active.data_ptr(),
            p.mass.data_ptr(), p.mass0.data_ptr(), None,
            vdep_field.data_ptr() if has_vdep else None, ny, nx,
            None if t_below is None else t_below.data_ptr(),
            ctypes.addressof(specs), n, nspec, abs(int(lsynctime)),
            abs(int(ldeltat)), float(np.float32(sp.minmass)),
            mass.data_ptr(), active.data_ptr(), deposit.data_ptr(), None,
            stream)
    return p.replace(mass=mass, active=active), deposit


def apply_decay_drydep(p: Particles, vdep_field, lsynctime: int,
                       ldeltat: int, sp: MassSpecies, has_vdep: bool,
                       t_below=None):
    """Decay, dry deposition and minmass termination of every particle: K10
    on a CUDA device, the plain version on the CPU.  ``t_below`` is the
    adaptive step's time below 2*HREF (``massupdate.py:79-80`` there), None
    after a fixed step."""
    dev = p.device
    run = {"cuda": decay_drydep_cuda,
           "cpu": apply_decay_drydep_plain}.get(dev.type)
    if run is None:
        raise ValueError(f"no decay/dry-deposition backend for device {dev}")
    return run(p, vdep_field, lsynctime, ldeltat, sp, has_vdep, t_below)


def decay_deposition_grids(wetgridunc: torch.Tensor,
                           drygridunc: torch.Tensor, decay,
                           lsynctime: int):
    """Radioactive decay of already-deposited mass on the output grids
    (``massupdate.py:106-114`` there; timemanager.f90:269-304), in place.
    decay: (nspec,) numbers or a float32 tensor; the grids have species
    innermost."""
    f = decay_factors(decay, -abs(lsynctime), wetgridunc.device)
    wetgridunc.mul_(f)
    drygridunc.mul_(f)
    return wetgridunc, drygridunc

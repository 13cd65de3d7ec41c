"""Particle release.

Port of ``flexpart_tpu/core/release.py`` (releaseparticles.f90).  The whole
release schedule is precomputed on the host: every particle slot is
assigned its release box, release time (sync-aligned), random in-box
position and per-species mass up front, deterministic given config and
seed, with ``itra`` = its release time and ``active`` false; the arrays
move to the device once.  "Release" during time stepping is a mask flip on
the device (``activate``); there is no slot allocation at run time.

``emission_time_factors`` and ``build_release_schedule`` are host numpy
with ``np.random.default_rng(seed)`` and equal the JAX package's arrays
bitwise, field for field.
"""

from __future__ import annotations

from datetime import datetime, timedelta

import numpy as np
import torch

from ..config import Command, Releases
from ..met.grid import MetGrid
from .state import ITRA_INACTIVE, Particles

_MONDAY_1900 = datetime(1900, 1, 1)      # julmonday (releaseparticles.f90:58)


def emission_time_factors(rel: Releases, box, grid: MetGrid,
                          bdate: datetime, itime: int) -> np.ndarray:
    """Per-species emission correction factors at model second ``itime``
    (releaseparticles.f90:40-106): local time = UTC + DST (Apr-Sep) +
    longitude offset; point sources (zero-extent boxes) use the
    point_hour/point_dow tables, area sources area_hour/area_dow."""
    t = bdate + timedelta(seconds=int(itime))
    if 4 <= t.month <= 9:                    # daylight savings (line 63)
        t += timedelta(hours=1)
    xlonav = (box.lon1 + box.lon2) / 2.0
    while xlonav < -180.0:
        xlonav += 360.0
    while xlonav > 180.0:
        xlonav -= 360.0
    tlocal = t + timedelta(days=xlonav / 360.0)
    juldiff = ((tlocal - _MONDAY_1900).total_seconds() / 86400.0) % 7.0
    ndow = int(juldiff) + 1                  # Monday = 1
    nhour = round((juldiff - (ndow - 1)) * 24.0)
    if nhour == 0:
        nhour = 24
        ndow = 7 if ndow == 1 else ndow - 1
    x1, y1 = grid.lonlat_to_grid(box.lon1, box.lat1)
    x2, y2 = grid.lonlat_to_grid(box.lon2, box.lat2)
    is_point = abs(x2 - x1) < 1e-4 and abs(y2 - y1) < 1e-4
    out = np.empty(len(rel.species), np.float64)
    for k, sp in enumerate(rel.species):
        if is_point:
            out[k] = sp.point_hour[nhour - 1] * sp.point_dow[ndow - 1]
        else:
            out[k] = sp.area_hour[nhour - 1] * sp.area_dow[ndow - 1]
    return out


def release_schedule_arrays(rel: Releases, cmd: Command, grid: MetGrid,
                            capacity: int | None = None,
                            nclassunc: int = 1,
                            seed: int = 42) -> dict[str, np.ndarray]:
    """The full particle population as host arrays, one per field of
    ``state.FIELDS``, all inactive, with itra = sync-aligned release time.
    Slots past the scheduled particles keep the values of
    ``empty_particles``."""
    t0 = cmd.bdate
    lsync = cmd.lsynctime * cmd.ldirect
    nspec = rel.nspec
    rng = np.random.default_rng(seed)
    time_varying = any(sp.has_time_variation for sp in rel.species)

    xs_l, ys_l, zs_l, itra_l, npoint_l, mass_l = [], [], [], [], [], []
    for b_idx, box in enumerate(rel.boxes):
        x1, y1 = grid.lonlat_to_grid(box.lon1, box.lat1)
        x2, y2 = grid.lonlat_to_grid(box.lon2, box.lat2)
        bz1, bz2 = box.z1, box.z2

        rt1 = int((box.start - t0).total_seconds()) * 1
        rt2 = int((box.end - t0).total_seconds()) * 1
        if cmd.ldirect < 0:
            rt1, rt2 = -rt2, -rt1  # backward runs count seconds backwards

        bmass = np.array([box.mass[k] if k < len(box.mass) else 0.0
                          for k in range(nspec)], np.float64)

        if not time_varying:
            # release times: uniform spread over the window, aligned to
            # sync steps (releaseparticles.f90:108-127, uniform-midpoint
            # variant)
            nparts = box.parts
            if rt2 <= rt1:
                tsec = np.full(nparts, rt1)
            else:
                tsec = rt1 + (np.arange(nparts) + 0.5) / nparts \
                    * (rt2 - rt1)
            step = np.floor_divide(tsec, abs(cmd.lsynctime)) \
                .astype(np.int64)
            itra_b = step * abs(cmd.lsynctime) * np.sign(lsync)
            mass_b = np.broadcast_to(
                (bmass / nparts)[None, :], (nparts, nspec)).copy()
        else:
            # hour-of-day / day-of-week modulated schedule
            # (releaseparticles.f90:40-131): the species-average factor
            # scales the number of particles released per sync step
            # (with fractional carry, xmasssave), the per-species
            # factor/average ratio scales each particle's mass
            itra_steps, mass_rows = [], []
            sgn = 1 if lsync > 0 else -1
            ls = abs(cmd.lsynctime)
            if rt2 <= rt1:
                it = (rt1 // ls) * ls * sgn
                tc = emission_time_factors(rel, box, grid, t0, it)
                avg = max(tc.mean(), 1e-30)
                itra_steps.extend([it] * box.parts)
                mass_rows.extend([bmass / box.parts * tc / avg]
                                 * box.parts)
            else:
                base = abs(box.parts * cmd.lsynctime) / abs(rt2 - rt1)
                carry = 0.0
                first = -(-rt1 // ls) * ls    # first sync step in window
                for it in range(first, rt2 + 1, ls):
                    # factors are evaluated at the signed model time
                    tc = emission_time_factors(rel, box, grid, t0,
                                               it * sgn)
                    avg = max(tc.mean(), 1e-30)
                    frac = base * avg
                    if it in (rt1, rt2):
                        frac *= 0.5      # half rate at window edges
                    carry += frac
                    numrel = int(carry)
                    carry -= numrel
                    if numrel:
                        itra_steps.extend([it * sgn] * numrel)
                        mass_rows.extend(
                            [bmass / box.parts * tc / avg] * numrel)
            nparts = len(itra_steps)
            itra_b = np.asarray(itra_steps, np.int64)
            mass_b = (np.vstack(mass_rows) if mass_rows
                      else np.zeros((0, nspec)))

        xs_l.append((x1 + rng.random(nparts) * (x2 - x1))
                    .astype(np.float32))
        ys_l.append((y1 + rng.random(nparts) * (y2 - y1))
                    .astype(np.float32))
        zs_l.append((bz1 + rng.random(nparts) * (bz2 - bz1))
                    .astype(np.float32))
        itra_l.append(itra_b)
        npoint_l.append(np.full(nparts, b_idx, np.int32))
        mass_l.append(mass_b.astype(np.float32))

    xs = np.concatenate(xs_l) if xs_l else np.zeros(0, np.float32)
    ys = np.concatenate(ys_l) if ys_l else np.zeros(0, np.float32)
    zs = np.concatenate(zs_l) if zs_l else np.zeros(0, np.float32)
    itra = (np.concatenate(itra_l) if itra_l
            else np.zeros(0, np.int64))
    npoint = (np.concatenate(npoint_l) if npoint_l
              else np.zeros(0, np.int32))
    mass = (np.concatenate(mass_l) if mass_l
            else np.zeros((0, nspec), np.float32))
    total = xs.shape[0]
    if capacity is None:
        capacity = total
    if capacity < total:
        raise ValueError(f"capacity {capacity} < total particles {total}")

    nclass = rng.integers(0, nclassunc, size=total)
    # next-split time: release time + ldirect*itsplit
    # (releaseparticles.f90:187), clipped into i32
    itrasplit = np.clip(itra + cmd.ldirect * min(cmd.itsplit, 999999999),
                        -999999998, 999999999)

    def filled(values, fill, dtype, width=None):
        shape = (capacity,) if width is None else (capacity, width)
        out = np.full(shape, fill, dtype)
        out[:total] = values
        return out

    def zeros():
        return np.zeros(capacity, np.float32)

    m = filled(mass, 0.0, np.float32, nspec)
    return dict(
        x_hi=filled(xs, 0.0, np.float32), x_lo=zeros(),
        y_hi=filled(ys, 0.0, np.float32), y_lo=zeros(),
        z=filled(zs, 0.0, np.float32),
        itra=filled(itra.astype(np.int32), ITRA_INACTIVE, np.int32),
        itramem=filled(itra.astype(np.int32), 0, np.int32),
        npoint=filled(npoint, 0, np.int32),
        nclass=filled(nclass.astype(np.int32), 0, np.int32),
        idt=np.zeros(capacity, np.int32),
        itrasplit=filled(itrasplit.astype(np.int32), ITRA_INACTIVE, np.int32),
        up=zeros(), vp=zeros(), wp=zeros(),
        usig=zeros(), vsig=zeros(), wsig=zeros(),
        cbt=np.ones(capacity, np.int8),
        mass=m, mass0=m.copy(),
        xscav=np.ones((capacity, nspec), np.float32),
        active=np.zeros(capacity, np.bool_),
    )


def build_release_schedule(rel: Releases, cmd: Command, grid: MetGrid,
                           capacity: int | None = None,
                           nclassunc: int = 1,
                           seed: int = 42,
                           bkdep: int = 0, *,
                           device: torch.device | str) -> Particles:
    """``release_schedule_arrays`` as particles on ``device`` (one copy per
    field).  The backward deposition modes (``bkdep`` 3 and 4) are not
    ported."""
    if bkdep != 0:
        raise NotImplementedError(
            "bkdep (backward deposition release heights and xscav) is not "
            "ported yet")
    arrays = release_schedule_arrays(rel, cmd, grid, capacity, nclassunc,
                                     seed)
    return Particles(**{f: torch.as_tensor(a, device=device)
                        for f, a in arrays.items()})


def activate(p: Particles, itime: int) -> Particles:
    """Flip scheduled releases live for this sync step.  Turbulent and
    mesoscale velocity memory is drawn from the local sigmas inside the
    first advance (its ``fresh`` block, initialize.f90:110-219); the zeros
    set here are placeholders that are overwritten there."""
    newly = (~p.active) & (p.itra == itime) & (p.itra != ITRA_INACTIVE)
    zero = torch.zeros_like(p.up)
    return p.replace(
        active=p.active | newly,
        up=torch.where(newly, zero, p.up),
        vp=torch.where(newly, zero, p.vp),
        wp=torch.where(newly, zero, p.wp),
        cbt=torch.where(newly, torch.ones_like(p.cbt), p.cbt),
    )

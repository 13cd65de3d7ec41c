"""Particle dumps, warm start and full checkpoints.

Port of ``flexpart_tpu/io/partdump.py``:

* the reference's ``partposit_*`` files (Fortran unformatted
  little-endian records, partoutput.f90:160-168: the itime record, one
  record per live particle of (npoint, lon, lat, z, itramem, topo, pv, qv,
  rho, hmix, tropo, T, mass...), the -99999 sentinel record), read back
  for IPIN=1 warm starts (readpartpositions.f90:88-131), files the
  reference binary wrote included; the quasi-Lagrangian ``shortposit_*``
  and the time-averaged ``partposit_average_*`` dumps;
* a full checkpoint (.npz): every particle field in slot order, the
  accumulators, the fixed height grid, the convective flux memory and, in
  place of JAX's PRNG key, the run's seed and the slots' schedule origins
  (the port's draws come from ``rng.Key(seed, istep)`` and are keyed by
  the particle's slot), so that a resumed run continues bit for bit.

The writers build each file as one numpy array of records, the bytes the
reference's loop of one ``struct.pack`` per particle writes: at 10 x 2**20
particles that loop takes minutes.  The met quantities at the particles
(``particle_diagnostics``, ``averaging_sample``) are plain torch on the
particles' device; they run once per dump (every step with ipout=3).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..core.interp import horiz_weights, interp_2d, vert_weights
from ..core.state import FIELDS, Particles
from ..grid.outgrid import Accumulators
from ..met.fields import (F2_HMIX, F2_ORO, F2_TROPO, F3_PV, F3_QV, F3_RHO,
                          F3_TT, F3_U, F3_V)

SENTINEL_INT = -99999
SENTINEL_FLOAT = np.float32(-9999.9)


def _interp3(zf, fid: int, hw, indz, dz1) -> torch.Tensor:
    """A 3-D field at the particles: bilinear on the two bracketing levels,
    linear between them (the reference's einsum over the four corners)."""
    nz = zf.f3d.shape[1]
    flat = zf.f3d[fid].reshape(nz, -1)
    lo = (flat[indz[None, :], hw.idx4] * hw.p4).sum(dim=0)
    hi = (flat[indz[None, :] + 1, hw.idx4] * hw.p4).sum(dim=0)
    return lo * (1.0 - dz1) + hi * dz1


def _met_at_particles(p: Particles, z0, z1, tw0: float, tw1: float,
                      fids: tuple):
    """(topo, hmix, tropo) and the 3-D fields ``fids`` at the particles,
    each time-interpolated between the two met times."""
    ny, nx = z0.f2d.shape[1], z0.f2d.shape[2]
    x, y = p.x, p.y
    hw = horiz_weights(x, y, nx, ny, False)
    f2 = (interp_2d(z0.f2d, (F2_ORO, F2_HMIX, F2_TROPO), hw) * tw0
          + interp_2d(z1.f2d, (F2_ORO, F2_HMIX, F2_TROPO), hw) * tw1)
    indz, dz1 = vert_weights(p.z, z0.height)
    f3 = [_interp3(z0, f, hw, indz, dz1) * tw0
          + _interp3(z1, f, hw, indz, dz1) * tw1 for f in fids]
    return f2, f3


def particle_diagnostics(p: Particles, z0, z1, tw0: float, tw1: float):
    """Met quantities at each particle for the dump record
    (partoutput.f90:90-158): topo, pv, qv, rho, hmix, tropopause, T, each
    an (N,) tensor on the particles' device."""
    (topo, hmix, tropo), (pv, qv, rho, tt) = _met_at_particles(
        p, z0, z1, tw0, tw1, (F3_PV, F3_QV, F3_RHO, F3_TT))
    return topo, pv, qv, rho, hmix, tropo, tt


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _lonlat(p: Particles, grid):
    """Longitude and latitude in float32, as ``grid.xlon0 + x * grid.dx``
    on a float32 array computes them."""
    x = _np(p.x)
    y = _np(p.y)
    lon = np.float32(grid.xlon0) + x * np.float32(grid.dx)
    lat = np.float32(grid.ylat0) + y * np.float32(grid.dy)
    return lon, lat


def _record_dtype(nspec: int) -> np.dtype:
    """One particle's record: its length, the ``<ifffi`` head, 7 + nspec
    floats, its length again (no padding: 28 + 4 (7 + nspec) bytes)."""
    return np.dtype([("n0", "<i4"), ("npoint", "<i4"), ("lon", "<f4"),
                     ("lat", "<f4"), ("z", "<f4"), ("itramem", "<i4"),
                     ("vals", "<f4", (7 + nspec,)), ("n1", "<i4")])


def _rec(payload: bytes) -> bytes:
    n = np.int32(len(payload)).astype("<i4").tobytes()
    return n + payload + n


def write_partposit(path, itime: int, p: Particles, grid, diag,
                    only_current: bool = True) -> None:
    """Write one reference-format particle dump.  ``diag`` is the output of
    ``particle_diagnostics`` (tensors or arrays); ``only_current`` keeps
    the particles whose next update is ``itime``."""
    topo, pv, qv, rho, hmix, tropo, tt = (_np(d) for d in diag)
    live = _np(p.active)
    if only_current:
        live = live & (_np(p.itra) == itime)
    idx = np.nonzero(live)[0]
    mass = _np(p.mass)
    nspec = mass.shape[1]
    lon, lat = _lonlat(p, grid)
    recs = np.empty(len(idx) + 1, _record_dtype(nspec))
    recs["n0"] = recs["n1"] = 20 + 4 * (7 + nspec)
    recs["npoint"][:-1] = _np(p.npoint)[idx] + 1
    recs["lon"][:-1] = lon[idx]
    recs["lat"][:-1] = lat[idx]
    recs["z"][:-1] = _np(p.z)[idx]
    recs["itramem"][:-1] = _np(p.itramem)[idx]
    vals = recs["vals"]
    for k, d in enumerate((topo, pv, qv, rho, hmix, tropo, tt)):
        vals[:-1, k] = d[idx]
    vals[:-1, 7:] = mass[idx]
    end = recs[-1:]
    end["npoint"] = end["itramem"] = SENTINEL_INT
    for f in ("lon", "lat", "z"):
        end[f] = SENTINEL_FLOAT
    end["vals"] = SENTINEL_FLOAT
    with open(path, "wb") as f:
        f.write(_rec(np.int32(itime).astype("<i4").tobytes()))
        f.write(recs.tobytes())


def read_partposit(path, nspec: int):
    """Parse a partposit file (the port's, the JAX package's or the
    reference binary's).  Returns (itime, dict of arrays): npoint (int32,
    0-based), lon, lat, z (float64), itramem (int32), mass (float64,
    (n, nspec)), or an empty dict for a file without particles."""
    data = Path(path).read_bytes()
    (n_head,) = np.frombuffer(data, "<i4", 1, 0)
    itime = int(np.frombuffer(data, "<i4", 1, 4)[0])
    off = 8 + int(n_head)
    (n_rec,) = np.frombuffer(data, "<i4", 1, off)
    if n_rec < 20 + 4 * (7 + nspec):
        raise ValueError(f"{path}: records of {n_rec} bytes hold fewer "
                         f"than {nspec} species")
    size = 8 + int(n_rec)
    count = (len(data) - off) // size
    body = np.frombuffer(data, np.uint8, count * size, off).reshape(count,
                                                                    size)
    head = body[:, 4:24].copy().view(np.dtype(
        [("npoint", "<i4"), ("lon", "<f4"), ("lat", "<f4"), ("z", "<f4"),
         ("itramem", "<i4")]))[:, 0]
    ends = np.nonzero(head["npoint"] == SENTINEL_INT)[0]
    n = int(ends[0]) if len(ends) else count
    lens = body[:n, :4].copy().view("<i4")[:, 0]
    if np.any(lens != n_rec):
        raise ValueError(f"{path}: particle records differ in length")
    if n == 0:
        return itime, {}
    head = head[:n]
    mass = body[:n, 52:52 + 4 * nspec].copy().view("<f4")
    return itime, dict(
        npoint=head["npoint"].astype(np.int32) - 1,
        lon=head["lon"].astype(np.float64),
        lat=head["lat"].astype(np.float64),
        z=head["z"].astype(np.float64),
        itramem=head["itramem"].astype(np.int32),
        mass=mass.astype(np.float64))


def write_shortposit(path, itime: int, p: Particles, grid, topo,
                     region=(-140.0, 60.0, 10.0, 90.0)) -> None:
    """Quasi-Lagrangian compressed dump (partoutput_short.f90:95-135):
    int16-packed (lon*180, lat*360, z+topo) and the int32 npoint of each
    particle inside ``region`` (the reference hardcodes the extended North
    Atlantic, -140..60 E, > 10 N) with mass > 0."""
    live = _np(p.active) & (_np(p.itra) == itime)
    lon, lat = _lonlat(p, grid)
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    lon = np.where(lon < -180.0, lon + 360.0, lon)
    topo = _np(topo)
    x1, x2, y1, y2 = region
    sel = (live & (lon > x1) & (lon < x2) & (lat > y1) & (lat < y2)
           & (_np(p.mass[:, 0]) > 0.0))
    idx = np.nonzero(sel)[0]
    n = len(idx)
    # the third record interleaves (i4, 3 x i2) per particle
    body = np.empty(n, np.dtype([("npoint", "<i4"), ("v", "<i2", (3,))]))
    body["npoint"] = _np(p.npoint)[idx] + 1
    body["v"][:, 0] = np.rint(lon[idx] * 180.0)
    body["v"][:, 1] = np.rint(lat[idx] * 360.0)
    body["v"][:, 2] = np.rint(np.minimum(_np(p.z)[idx] + topo[idx],
                                         32766.0))
    with open(path, "wb") as f:
        f.write(_rec(np.int32(itime).astype("<i4").tobytes()))
        f.write(_rec(np.int32(n).astype("<i4").tobytes()))
        f.write(_rec(body.tobytes()))


def averaging_sample(p: Particles, z0, z1, tw0: float, tw1: float, dx: float,
                     dy: float, xlon0: float, ylat0: float):
    """One accumulation step of the ipout=3 time-averaged particle output
    (partpos_average.f90): the (13, N) per-particle sample [cartx, carty,
    cartz, z, topo, pv, qv, tt, uu, vv, rho, tropo, hmix] (positions on
    the Cartesian unit sphere, so that means do not wrap at the dateline)
    and the live mask."""
    (topo, hmix, tropo), (pv, qv, tt, uu, vv, rho) = _met_at_particles(
        p, z0, z1, tw0, tw1, (F3_PV, F3_QV, F3_TT, F3_U, F3_V, F3_RHO))
    lon = (xlon0 + p.x * dx) * np.pi / 180.0
    lat = (ylat0 + p.y * dy) * np.pi / 180.0
    cosla = torch.cos(lat)
    sample = torch.stack([cosla * torch.sin(lon), -cosla * torch.cos(lon),
                          torch.sin(lat), p.z, topo, pv, qv, tt, uu, vv, rho,
                          tropo, hmix])
    return sample, p.active


def write_partposit_average(path, itime: int, p: Particles, sums,
                            counts) -> None:
    """ipout=3 compressed averaged dump (partoutput_average.f90:61-198):
    24-byte direct-access records, one per particle slot, of 12 int16:
    lon*180, lat*360, 2z-32000, 2topo-32000, 2tropo-32000, 2hmix-32000,
    20000rho-32000, 1e6qv-32000, 100pv, 300(T-273.15), 200u, 200v."""
    sums = _np(sums)
    counts = np.maximum(np.asarray(_np(counts), np.float32), 1.0)
    avg = sums / counts
    live = _np(p.active) & (_np(p.itra) == itime)
    (cartx, carty, cartz, z, topo, pv, qv, tt, uu, vv, rho, tropo,
     hmix) = avg
    lon = np.degrees(np.arctan2(cartx, -carty))
    lat = np.degrees(np.arctan2(cartz, np.hypot(cartx, carty)))
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    lon = np.where(lon < -180.0, lon + 360.0, lon)

    def clip16(v):
        return np.clip(np.rint(v), -32766, 32766).astype("<i2")

    recs = np.zeros((len(lon), 12), "<i2")
    recs[:, 0] = clip16(lon * 180.0)
    recs[:, 1] = clip16(lat * 360.0)
    recs[:, 2] = clip16(z * 2.0 - 32000.0)
    recs[:, 3] = clip16(topo * 2.0 - 32000.0)
    recs[:, 4] = clip16(tropo * 2.0 - 32000.0)
    recs[:, 5] = clip16(hmix * 2.0 - 32000.0)
    recs[:, 6] = clip16(rho * 20000.0 - 32000.0)
    recs[:, 7] = clip16(qv * 1.0e6 - 32000.0)
    recs[:, 8] = clip16(pv * 100.0)
    recs[:, 9] = clip16((tt - 273.15) * 300.0)
    recs[:, 10] = clip16(uu * 200.0)
    recs[:, 11] = clip16(vv * 200.0)
    recs[~live] = 0   # direct-access file: dead slots stay zeroed
    Path(path).write_bytes(recs.tobytes())


# ---------------------------------------------------------------------------
# full checkpoint
# ---------------------------------------------------------------------------

def save_checkpoint(path, sim, itime: int) -> None:
    """The run's whole state at the top of the step at ``itime``: the
    particles in their slot order, the accumulators, the seed, the slots'
    schedule origins (when the run keeps them), the height grid, the
    convective flux memory, a regional domain fill's boundary state (the
    JAX package's ``bnd_*`` keys, the reference's unitboundcond dump,
    init_domainfill.f90:400-410) and the accumulators of the receptors,
    the nested output grid, the fluxes and the initial-condition
    sensitivity.  Uncompressed: a full-width ensemble is a GB, which zlib
    would take tens of seconds over."""
    state = {"itime": np.int64(itime), "seed": np.int64(sim.seed)}
    for name in FIELDS:
        state["p_" + name] = _np(getattr(sim.particles, name))
    for f in dataclasses.fields(Accumulators):
        state["acc_" + f.name] = _np(getattr(sim.acc, f.name))
    if sim.cbmf is not None:
        state["cbmf"] = _np(sim.cbmf)
    if sim._height is not None:
        # the fixed vertical grid comes from the first met field seen
        # (verttransform_ecmwf.f90:153-165); a resumed run interpolates on
        # the same one
        state["height"] = _np(sim._height)
    if sim._origin is not None:
        state["origin"] = _np(sim._origin)
    if sim._boundary is not None:
        for name, a in sim._boundary.to_numpy().items():
            state["bnd_" + name] = a
    for key, on, get, _ in _RUN_SUMS:
        if on(sim):
            state[key] = _np(get(sim))
    np.savez(path, **state)


def _set_acc_n(sim, name, v):
    sim.acc_n = sim.acc_n.replace(**{name: v})


# the accumulators of the run's options: (key, option on, get, set)
_RUN_SUMS = (
    ("creceptor", lambda s: s.receptor_set is not None,
     lambda s: s.creceptor, lambda s, v: setattr(s, "creceptor", v)),
    ("acc_n_gridunc", lambda s: s.use_nested_output,
     lambda s: s.acc_n.gridunc, lambda s, v: _set_acc_n(s, "gridunc", v)),
    ("acc_n_outnum", lambda s: s.use_nested_output,
     lambda s: s.acc_n.outnum, lambda s, v: _set_acc_n(s, "outnum", v)),
    ("flux", lambda s: s.use_flux, lambda s: s.flux,
     lambda s, v: setattr(s, "flux", v)),
    ("init_cond", lambda s: s.use_initcond, lambda s: s.init_cond,
     lambda s, v: setattr(s, "init_cond", v)))


def load_checkpoint(path, sim) -> int:
    """Restore a checkpoint into a Simulation built with the same
    configuration; returns the itime to resume at."""
    dev = sim.device
    with np.load(path) as d:
        if int(d["seed"]) != sim.seed:
            raise ValueError(f"checkpoint {path} was written with seed "
                             f"{int(d['seed'])}, the run has {sim.seed}")
        sim.particles = Particles(**{
            name: torch.as_tensor(d["p_" + name], device=dev)
            for name in FIELDS})
        sim.acc = Accumulators(**{
            f.name: torch.as_tensor(d["acc_" + f.name], device=dev)
            for f in dataclasses.fields(Accumulators)})
        if "height" in d:
            sim._height = np.array(d["height"])   # host numpy, as
            #                                       compute_heights gives
        if "cbmf" in d and sim.cbmf is not None:
            sim.cbmf = torch.as_tensor(d["cbmf"], device=dev)
        if "origin" in d:
            sim._origin = torch.as_tensor(d["origin"], device=dev)
        if "bnd_acc" in d:
            from ..core.domainfill import BOUNDARY_FIELDS, BoundaryState
            sim._boundary = BoundaryState.from_numpy(
                {f: d["bnd_" + f] for f in BOUNDARY_FIELDS}, dev)
        for key, on, _, put in _RUN_SUMS:
            if key in d and on(sim):
                put(sim, torch.as_tensor(d[key], device=dev))
        return int(d["itime"])

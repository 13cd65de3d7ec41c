"""Command-line entry point of the port: the FLEXPART.f90 analog (copy of
``flexpart_tpu/main.py``).

`python -m flexpart_tpu_torch [pathnames] [-v] [--met synthetic]
[--device cpu]` reads the reference's input layout — a `pathnames` file
naming the options/, output/, met-data/ dirs and the AVAILABLE index
(readpaths.f90) — parses COMMAND / RELEASES / SPECIES / OUTGRID /
AGECLASSES / RECEPTORS from options/ (FLEXPART.f90:135-304 call order),
builds the Simulation, runs the time manager, and ends with the
reference's success banner (FLEXPART.f90:471) so downstream tooling that
greps for it keeps working.

Met comes from .npz archives (met/npzmet.py), GRIB files (ECMWF hybrid
eta, met/gribmet.py; NCEP GFS pressure levels, met/gfsmet.py, whose
cloud water turns on ``use_clwc``) or the built-in synthetic atmosphere.
An OH-reactive species takes ``<ohfields_path>/OH_FIELDS/OH_variables.bin``
(relative paths from options/), else the synthetic climatology.  RECEPTORS,
OUTGRID_NEST (with NESTED_OUTPUT=1) and COMMAND's IFLUX, LINIT_COND and
MDOMAINFILL run.  ``--trace-dir`` writes a ``torch.profiler`` trace of
the run there (one file a rank with ``--dp``).  ``--dp`` runs the particles
data-parallel (parallel/launch.py): ``min(--devices, cards present)``
ranks, one a card, over NCCL; with ``--device cpu``, ``--devices`` ranks
over gloo (required there: a CPU has no device count to default to).
``--tiles`` decomposes the met fields over such ranks, one tile a rank
(parallel/tiles.py); at one rank it runs one tile, 1 x 1.  What a tiles
run does not run yet reaches the ranks' Simulation and is refused there by
name, before any file is written.  ``--device`` picks
where the run lives: the card (``cuda``, the default; without one the run
raises) or the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from pathlib import Path

log = logging.getLogger("flexpart_tpu_torch")


def _met_backend_for(metdata, available, bdate):
    """AVAILABLE-indexed met backend with detectformat.f90-style probing
    (npz archive / NCEP isobaric GRIB2 / ECMWF hybrid-eta GRIB)."""
    from .config import read_available

    entries = read_available(available)
    if not entries:
        raise SystemExit(f"AVAILABLE index {available} is empty — "
                         "convert met data or pass --met synthetic")
    first = Path(metdata) / entries[0].filename
    if str(first).endswith(".npz"):
        from .met.npzmet import NpzMet
        return NpzMet(metdata=metdata, entries=entries, bdate=bdate)
    from .met.gfsmet import GfsMet, looks_like_gfs
    if looks_like_gfs(first):
        return GfsMet(metdata=metdata, entries=entries, bdate=bdate)
    from .met.gribmet import GribMet
    return GribMet(metdata=metdata, entries=entries, bdate=bdate)


class _NestShim:
    """Adapter presenting a met backend with `.grid` as an attribute and
    fetch() passthrough — what Simulation.met_nests expects."""

    def __init__(self, backend):
        self._b = backend
        self.grid = backend.grid()

    def fetch(self, tsec, device):
        return self._b.fetch(tsec, device)


def build_simulation(pathnames: str, met: str = "auto",
                     capacity: int | None = None, seed: int = 1234,
                     write_fortran: bool = False,
                     distributed: str | None = None,
                     profile: bool = False,
                     trace_dir: str | None = None,
                     device: str = "cuda"):
    from .config import (AgeClasses, Command, OutGrid, Pathnames, Releases,
                         read_receptors)
    from .run.simulation import Simulation

    pn = Pathnames.from_file(pathnames)
    opts = pn.options
    cmd = Command.from_file(opts / "COMMAND")
    releases = Releases.from_file(opts / "RELEASES",
                                  species_dir=opts / "SPECIES")
    outgrid = OutGrid.from_file(opts / "OUTGRID")
    age_path = opts / "AGECLASSES"
    ageclasses = (AgeClasses.from_file(age_path) if age_path.exists()
                  else AgeClasses())

    # OUTGRID_NEST (readoutgrid_nest.f90; FLEXPART.f90:251-257)
    outgrid_nest = None
    ogn_path = opts / "OUTGRID_NEST"
    if cmd.nested_output and ogn_path.exists():
        outgrid_nest = OutGrid.from_file(ogn_path, nest=True)
        # the nest shares the mother grid's vertical levels
        # (readoutgrid_nest.f90 reads no OUTHEIGHTS)
        outgrid_nest = dataclasses.replace(
            outgrid_nest, outheights=outgrid.outheights)

    # RECEPTORS (readreceptors.f90; FLEXPART.f90:262)
    receptors = read_receptors(opts / "RECEPTORS")

    wind_interval = 3600
    met_nests = ()
    if met == "synthetic":
        from .met import SyntheticMet, make_grid
        grid = make_grid(nx=73, ny=37, nlev=28, dx=5.0, dy=5.0)
        backend = SyntheticMet(grid)
    else:
        backend = _met_backend_for(pn.metdata, pn.available, cmd.bdate)
        grid = backend.grid()
        wind_interval = backend.wind_interval
        # nested met grids from the per-nest (metdata, AVAILABLE) pairs
        # in pathnames (readpaths.f90:45-80, readwind_nests.f90)
        met_nests = tuple(
            _NestShim(_met_backend_for(nmet, navail, cmd.bdate))
            for nmet, navail in pn.nests)

    # OH climatology when any species is OH-reactive
    # (FLEXPART.f90:352 readOHfield; readOHfield.f90:44-45)
    oh_field = None
    if any(sp.ohreact for sp in releases.species):
        from .physics.ohchem import read_oh_field, synthetic_oh_field
        oh_bin = (Path(cmd.ohfields_path) / "OH_FIELDS"
                  / "OH_variables.bin")
        if not oh_bin.is_absolute():
            oh_bin = opts / oh_bin
        if oh_bin.exists():
            oh_field = read_oh_field(oh_bin)
        else:
            log.warning("OH-reactive species but %s missing - using the "
                        "built-in climatology", oh_bin)
            oh_field = synthetic_oh_field()

    sim = Simulation(
        cmd=cmd, releases=releases, grid=grid, met_backend=backend,
        outgrid=outgrid, ageclasses=ageclasses, outdir=str(pn.output),
        capacity=capacity, seed=seed, wind_interval=wind_interval,
        oh_field=oh_field,
        use_clwc=bool(getattr(backend, "sumclouds", False)),
        options_dir=str(opts) if (opts / "IGBP_int1.dat").exists() else None,
        receptors=receptors, outgrid_nest=outgrid_nest,
        met_nests=met_nests,
        # LNETCDFOUT / iout>=8 drives the netCDF writer; without it the
        # reference writes the unformatted sparse records instead
        # (readcommand.f90:95,388-396; timemanager.f90:379-435)
        write_netcdf=cmd.use_netcdf,
        write_fortran=write_fortran or not cmd.use_netcdf,
        distributed=distributed, profile=profile, trace_dir=trace_dir,
        device=device)
    return sim


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flexpart_tpu_torch",
        description="Lagrangian particle dispersion model on PyTorch/CUDA "
                    "(FLEXPART-compatible inputs)")
    ap.add_argument("pathnames", nargs="?", default="pathnames",
                    help="pathnames file (default: ./pathnames)")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="-v info, -vv debug (FLEXPART.f90 -v/-v2)")
    ap.add_argument("--met", default="auto",
                    choices=("auto", "synthetic"),
                    help="met backend: AVAILABLE-indexed .npz or GRIB "
                         "(auto) or the built-in synthetic atmosphere")
    ap.add_argument("--capacity", type=int, default=None,
                    help="particle slot capacity (default: total released)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--write-fortran", action="store_true",
                    help="also write the reference's unformatted header "
                         "+ sparse grid_conc_* records")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--dp", action="store_true",
                    help="distribute the particles over the local devices, "
                         "one process a device (NCCL on the cards, gloo "
                         "with --device cpu)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of a --dp or --tiles run: at most this "
                         "many cards (default: every card present); with "
                         "--device cpu, required")
    ap.add_argument("--tiles", action="store_true",
                    help="domain-decompose the met fields over the "
                         "devices, one process and one tile a device "
                         "(NCCL on the cards, gloo with --device cpu)")
    ap.add_argument("--profile", action="store_true",
                    help="per-section device timing table at run end "
                         "(the mpif_mtime instrumentation analog); "
                         "written to <output>/profile.txt")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the run "
                         "here (TensorBoard's *.pt.trace.json)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=_log_level(args.verbose),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    t0 = time.perf_counter()
    if args.dp and args.tiles:
        raise ValueError("--dp and --tiles: pick one")
    if args.dp or args.tiles:
        return _main_dp(args, t0, "tiles" if args.tiles else "dp")
    sim = _build_from_args(args, None)
    log.info("simulation configured: %s particles, grid %dx%dx%d",
             "domain-filling" if sim.particles is None
             else sim.particles.capacity, sim.grid.nx, sim.grid.ny,
             sim.grid.nlev)
    sim.run(progress=args.verbose > 0)
    _report(abs(sim.cmd.ideltas), sim.timings.get("particle_steps", 0),
            time.perf_counter() - t0)
    return 0


def _log_level(verbose: int) -> int:
    return (logging.DEBUG if verbose > 1
            else logging.INFO if verbose else logging.WARNING)


def _build_from_args(args, distributed):
    return build_simulation(args.pathnames, met=args.met,
                            capacity=args.capacity, seed=args.seed,
                            write_fortran=args.write_fortran,
                            distributed=distributed, profile=args.profile,
                            trace_dir=args.trace_dir, device=args.device)


def _report(seconds: int, psteps: int, wall: float) -> None:
    print(f"Simulated {seconds} s, "
          f"{psteps} particle-steps in {wall:.1f} s wall "
          f"({psteps / max(wall, 1e-9):,.0f} psteps/s)")
    print("CONGRATULATIONS: YOU HAVE SUCCESSFULLY COMPLETED A FLEXPART "
          "MODEL RUN!")


def dp_ranks(device: str, devices: int | None) -> int:
    """The ranks of a ``--dp`` or ``--tiles`` run: on the cards
    min(``devices``, cards present), one a card; on the CPU ``devices``,
    which must be given."""
    import torch
    kind = torch.device(device).type
    if devices is not None and devices < 1:
        raise ValueError(f"--devices {devices}: at least one")
    if kind == "cpu":
        if devices is None:
            raise ValueError("--dp or --tiles with --device cpu needs "
                             "--devices: a CPU has no device count to "
                             "default to")
        return devices
    if kind != "cuda":
        raise ValueError(f"--dp runs on cuda or cpu, not {device}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError("--dp on cuda: no CUDA device found; pass "
                           "--device cpu --devices n to run on the CPU")
    return cards if devices is None else min(devices, cards)


def _main_dp(args, t0: float, mode: str = "dp") -> int:
    """``--dp`` or ``--tiles``: the ranks of parallel/launch.py, each
    building and running the job's Simulation with distributed=``mode``;
    rank 0's summary printed (``-v``: as the ``dp:`` or ``tiles:`` line)."""
    from .parallel.launch import launch
    import torch
    n = dp_ranks(args.device, args.devices)
    kind = torch.device(args.device).type
    threads = (max(1, (os.cpu_count() or 1) // n) if kind == "cpu"
               else None)
    out = launch(_dp_rank, n, kind, args=(vars(args), mode),
                 threads=threads)[0]
    _report(out["seconds"], out["particle_steps"], time.perf_counter() - t0)
    if args.verbose:
        print(f"{mode}: " + json.dumps(out["dp"]))
    return 0


def _dp_rank(options: dict, mode: str = "dp") -> dict:
    """One rank of a ``--dp`` or ``--tiles`` run (inside its process
    group): build, run, and return what rank 0 reports: the run's seconds
    and particle steps, the world size, backend, NCCL version, the run's
    host seconds and sections (``Simulation.timings``), its collectives
    (calls, bytes, seconds), this rank's kernel launches and, for tiles,
    the mesh, halo, tile slots and migrations."""
    import torch
    from . import _build
    logging.basicConfig(
        level=_log_level(options["verbose"]),
        format="%(asctime)s rank %(process)d %(name)s %(levelname)s "
               "%(message)s")
    args = argparse.Namespace(**options)
    sim = _build_from_args(args, mode)
    g = sim._group
    cuda = sim.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(sim.device)
    t0 = time.perf_counter()
    sim.run(progress=args.verbose > 0)
    if cuda:
        torch.cuda.synchronize(sim.device)
    run_s = time.perf_counter() - t0
    nccl = None
    if g.backend == "nccl":
        v = torch.cuda.nccl.version()
        nccl = ".".join(str(x) for x in v) if isinstance(v, tuple) else v
    return dict(
        seconds=abs(sim.cmd.ideltas),
        particle_steps=sim.timings.get("particle_steps", 0),
        dp=dict(world=g.world, rank=g.rank, backend=g.backend, nccl=nccl,
                device=str(sim.device), run_s=run_s, timings=sim.timings,
                capacity=sim.particles.capacity * g.world,
                collectives=g.stats,
                launches={k.name: k.launches for k in
                          list(_build.KERNELS) + list(_build.ENTRIES)},
                **({} if sim._tiles is None else {"tiles": dict(
                    mesh=[sim._tiles.nty, sim._tiles.ntx],
                    halo=sim._tiles.halo, local_cap=sim._tiles.local_cap,
                    **sim._tiles.stats)})))


if __name__ == "__main__":
    sys.exit(main())

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
MDOMAINFILL run.  What the port's Simulation does not run yet (``--dp``,
``--tiles``, ``--trace-dir``) reaches it and is refused there by name,
before any file is written.  ``--device`` picks
where the run lives: the card (``cuda``, the default; without one the run
raises) or the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
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
                    help="distribute particles over all local devices "
                         "(not ported yet: refused)")
    ap.add_argument("--tiles", action="store_true",
                    help="domain-decompose the met fields over the "
                         "devices (not ported yet: refused)")
    ap.add_argument("--profile", action="store_true",
                    help="per-section device timing table at run end "
                         "(the mpif_mtime instrumentation analog); "
                         "written to <output>/profile.txt")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a profiler trace of the run here "
                         "(not ported yet: refused)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=(logging.DEBUG if args.verbose > 1
               else logging.INFO if args.verbose else logging.WARNING),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    t0 = time.perf_counter()
    sim = build_simulation(args.pathnames, met=args.met,
                           capacity=args.capacity, seed=args.seed,
                           write_fortran=args.write_fortran,
                           distributed=("tiles" if args.tiles
                                        else "dp" if args.dp else None),
                           profile=args.profile,
                           trace_dir=args.trace_dir,
                           device=args.device)
    log.info("simulation configured: %s particles, grid %dx%dx%d",
             "domain-filling" if sim.particles is None
             else sim.particles.capacity, sim.grid.nx, sim.grid.ny,
             sim.grid.nlev)
    sim.run(progress=args.verbose > 0)
    wall = time.perf_counter() - t0
    psteps = sim.timings.get("particle_steps", 0)
    print(f"Simulated {abs(sim.cmd.ideltas)} s, "
          f"{psteps} particle-steps in {wall:.1f} s wall "
          f"({psteps / max(wall, 1e-9):,.0f} psteps/s)")
    print("CONGRATULATIONS: YOU HAVE SUCCESSFULLY COMPLETED A FLEXPART "
          "MODEL RUN!")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The simulation run loop — scheduler equivalent of timemanager.f90.

Port of ``flexpart_tpu/run/simulation.py``: the forward (``ldirect=1``) and
backward (``ldirect=-1``: source-receptor sensitivities, with the backward
deposition modes ``ind_receptor`` 3 and 4, physics/bkdep.py), serial,
one-device path with the fixed step (``ctl < 0``) or the adaptive
step (``ctl > 0``), with the defaults of ``Command``: convection
(``lconvection=1``), subgrid orography (``lsubgrid=1``) and, on a cyclic
grid beyond 75 degrees, the polar caps; species may decay, deposit wet and
dry, and settle (an aerosol with a density, where every release box emits
one species, as the reference rules); ``turboff`` switches the turbulence
off; ``cblflag=1`` runs the skewed convective boundary layer (its NaN
redraws summed in ``nan_count``); ``met_nests`` adds nested met grids
that the advance samples where they hold a particle (convection,
deposition and sampling stay on the mother grid, as in the reference);
``legacy_rng`` is the reference's matched-RNG validation mode (every draw
of the advance from the rannumb table in the reference's order, release
positions from its ran1 order, no cell-order sorting; no kernel takes
it, so it runs with ``device='cpu'`` only); species may react with OH
(physics/ohchem.py); particles split at output times once ``itsplit`` has
passed (core/split.py); the particles are dumped in the reference's
``partposit_*`` files (``ipout`` 1, 2 and 3, ``mquasilag``), a run may
start warm from a ``partposit_end`` (``ipin=1``) and write a full
checkpoint (``checkpoint_at``) from which ``run(start_itime=...)``
resumes bit for bit (io/partdump.py); ``mdomainfill`` 1 and 2 fill the
domain with air-mass particles, and a regional window emits and destroys
particles at its boundary (core/domainfill.py, K14); receptors sample the
particles (grid/receptors.py, K15), ``outgrid_nest`` adds a nested output
grid (K3 on the nest), ``iflux`` gathers the gross fluxes through the
output cells' faces (grid/fluxes.py, K16), ``linit_cond`` the sensitivity
to the initial condition (grid/initcond.py, K17) and ``iout`` 4 and 5 the
plume trajectories (grid/plumetraj.py).  ``trace_dir`` takes a
``torch.profiler`` trace of the run there (the host, and the card where
the run lives on one), as the reference takes its JAX trace.
``distributed="dp"`` runs the particles data-parallel, one process a
device inside an initialised ``torch.distributed`` group
(parallel/sharding.py; parallel/launch.py starts the ranks): each rank
holds the contiguous global slots ``[rank * L, (rank + 1) * L)`` of the
capacity padded to a multiple of the world size, reads and processes the
met fields itself, draws by the global slot, samples and deposits into
partial grids that are summed in rank order at output, splits and fills
the domain's boundary over the group, and rank 0 writes every file (the
dumps and checkpoints gather the rows to it).  ``_origin`` holds a rank's
local origins (the global one is ``rank * L`` more).
``distributed="tiles"`` decomposes the met fields over the ranks of such a
group, one haloed tile a rank (parallel/domain.py, parallel/tiles.py):
a rank holds the particles in its tile (``tile_local_cap`` slots, or as
many as the release schedule's fullest tile needs with head-room), keeps
their origins in ``_origin`` (the schedule's; a split's child or a
particle the regional boundary emits takes a fresh one, unique over the
group, from ``_next_origin``), advances them on its tile (K4 ``TILE``,
K11 ``TILE``, K11 ``TILE`` x ``CBL``) and migrates those that left to the
owning tiles after each step, deposits them with its tile's fields and
samples them into partial grids summed at output; the halo is sized from
the first wind field and every field read later is checked against the
wind it supports.  Convection, the OH reaction and the receptors run on
the whole fields at the particles' global positions; the fluxes and the
initial condition's scan of the advance's ends read the state before the
migration; a split and the regional boundary fill the rank's own slots
(the boundary's sites those whose column the rank's tile owns, drawn by
their global site); a warm start and a domain fill are placed by tile as
the schedule is; a checkpoint keeps every rank's slots and partial grids;
a second step in a row whose migration defers particles regroups the
group at twice the tile capacity.  Nested met and backward deposition
raise ``ValueError``, as the reference, and so does ``legacy_rng``.

Host-side control loop; all per-particle compute stays on the device.
Per sync interval (timemanager.f90:152-712):

  1. keep two processed wind fields buffered around itime (getfields.f90
     double buffer; here: backend fetch + process_eta/calcpar, the next
     field read and processed by one background thread; a backward run
     reads the fields before itime);
  0. at ``checkpoint_at``, the whole state to ``checkpoint_path``;
  1b. wet deposition over the interval ending at itime (physics/wetdepo.py,
     K9 and the deposit scatter K8 on a CUDA device; timemanager.f90:
     164-169), the OH reaction (physics/ohchem.py, K12) and the decay of
     the deposition grids (timemanager.f90:269-304); a backward run removes
     the mass and grids no deposit;
  2. activate scheduled releases (mask flip, core/release.py); a regional
     domain fill's boundary (K14); in a backward deposition run the factor
     xscav of each fresh particle (physics/bkdep.py: K9 or K10 BKDEP on a
     CUDA device);
  3. keep the particles in met-cell order (core/reorder.py): a sort every
     ``REORDER_EVERY`` steps and on every step in which a release woke
     particles;
  3b. convective redistribution (physics/convection.py; timemanager.f90:
     258-263): the Emanuel scheme over every grid column (K6 on a CUDA
     device), then the particles' draws against their column's
     displacement matrix (K7);
  4. sample concentrations into the device accumulator (conccalc) on the
     loutsample cadence with the reference's half-weight edge rule
     (timemanager.f90:350-365), and into the nested grid's and the
     receptors' (K15);
  4b. with ``mquasilag``, the compressed dump at the window's centre;
  5. at averaging-interval end: normalize (factor3d, concoutput.f90:210-221;
     |loutaver| / outnum backward), copy to host, write (npz, netCDF and,
     with ``write_fortran``, the reference's unformatted ``header`` and
     sparse ``grid_*`` files, io/fortran_writer.py), zero the
     concentration accumulator; the nest's and the receptors' files, the
     fluxes' and the plume trajectories; the particle dumps of ``ipout``;
     the split of the particles due (K13), then a sort;
  6. advance all particles one lsynctime (core/advance.py: K4 for the
     fixed step, K11 for the adaptive step on a CUDA device);
  6a. with ``ipout=3``, the per-step sums of the averaged dump; with
     ``iflux``, the faces crossed in the step (K16);
  6b. decay, dry deposition and minmass termination
     (physics/massupdate.py, K10 and K8 on a CUDA device;
     timemanager.f90:643-686); after an adaptive step the dry deposition
     takes the seconds each particle spent below 2 HREF; backward, the
     deposit is not gridded;
  7. terminate particles older than the last age class; with
     ``linit_cond``, the particles that ended in the step onto the
     initial-condition grid (K17).
At the run's end, with ``linit_cond``, the survivors onto that grid and
``grid_initial_*``; with ``ipout`` 1 or 2, ``partposit_end``.

On a CUDA device a step that neither samples nor writes never waits for
the device: the active count is summed on the device and read where a
person reads it (the progress log, the end of the run).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import logging
import struct
import time as _time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from .. import interop, parallel
from ..parallel import domain as pdomain
from ..parallel import tiles as ptiles
from ..config import AgeClasses, Command, OutGrid, Releases
from ..core import domainfill, reorder, rng
from ..core.advance import StepConfig, StepParams, advance_all
from ..core.legacy import LegacyRnd
from ..core.release import activate, release_schedule_arrays
from ..core.split import due_and_free, split_particles
from ..core.state import FIELDS, ITRA_INACTIVE, Particles
from ..grid.conccalc import ConcConfig, kernel_possible_at, make_conccalc
from ..grid.fluxes import FluxConfig, make_calcfluxes, zero_flux
from ..grid.initcond import (InitCondConfig, make_initcond_scatter,
                             write_initial_cond, zero_init_cond)
from ..grid.outgrid import (Accumulators, OutputGridGeometry,
                            density_outgrid, density_receptors, oro_outgrid,
                            zero_accumulators)
from ..grid.plumetraj import PlumeTrajWriter, plume_step
from ..grid.receptors import build_receptors, sample_receptors
from ..io import partdump
from ..io.fortran_writer import (_rec, _sparse_block, append_receptor,
                                 write_flux, write_grid_sparse, write_header,
                                 write_receptor_header)
from ..io.writer import OutputWriter
from ..met.calcpar import calcpar
from ..met.calcpv import calcpv
from ..met.fields import F3_RHO, F3_TT
from ..met.grid import MetGrid
from ..met.verttransform import compute_heights, process_eta
from ..physics import setup_drydep
from ..physics.convection import make_convection_kernel, redist_particles
from ..physics.bkdep import assign_drybkdep, assign_wetbkdep, write_precip
from ..physics.drydepo import constant_vdep_kernel, make_vdep_kernel
from ..physics.massupdate import (MassSpecies, apply_decay_drydep,
                                  decay_deposition_grids)
from ..physics.ohchem import HourlyOH, make_ohreaction, synthetic_oh_field
from ..physics.wetdepo import WetSpecies, depo_scatter, wet_deposition
from ..utils.cpu import warm_vector_math
from ..utils.dates import add_seconds, datestamp
from ..utils.profile import SectionTimers
from ..validation.depo_oracle import legacy_release
from ..validation.legacy_rng import MAXRAND, NrandStream, Ran1, make_rannumb

log = logging.getLogger("flexpart_tpu_torch")


def nest_windows(mother: MetGrid, nests) -> dict:
    """The StepParams windows of nested met grids, outermost first: each
    nest's corners in mother-grid units and the mother's dx, dy over the
    nest's (com_mod xln/xrn/xresoln)."""
    g0 = mother
    return dict(
        xln=[(g.xlon0 - g0.xlon0) / g0.dx for g in nests],
        yln=[(g.ylat0 - g0.ylat0) / g0.dy for g in nests],
        xrn=[(g.xlon0 + (g.nx - 1) * g.dx - g0.xlon0) / g0.dx for g in nests],
        yrn=[(g.ylat0 + (g.ny - 1) * g.dy - g0.ylat0) / g0.dy for g in nests],
        xresoln=[g0.dx / g.dx for g in nests],
        yresoln=[g0.dy / g.dy for g in nests])


@dataclasses.dataclass
class Simulation:
    cmd: Command
    releases: Releases
    grid: MetGrid
    met_backend: Any              # .fetch(time_seconds, device) -> EtaFields
    outgrid: OutGrid
    ageclasses: AgeClasses = AgeClasses()
    outdir: str = "output"
    capacity: int | None = None
    nclassunc: int = 1
    seed: int = 1234
    wind_interval: int = 3600     # seconds between met fields
    use_clwc: bool = False
    write_netcdf: bool = True
    write_npz: bool = True
    options_dir: str | None = None   # dir with IGBP/surfdata/surfdepo files
    minmass: float = 1.0e-4          # termination threshold (par_mod.f90)
    oh_field: Any = None             # physics.ohchem.OHField (or None: the
    #                                  synthetic one, for an OH species)
    checkpoint_at: int | None = None  # write a full checkpoint at this itime
    checkpoint_path: str = "checkpoint.npz"
    receptors: tuple = ()
    outgrid_nest: Any = None
    met_nests: tuple = ()
    write_fortran: bool = False
    distributed: str | None = None   # None, "dp" (particle
    #                                  data-parallelism over the process
    #                                  group) or "tiles" (the met fields
    #                                  decomposed over it)
    n_devices: int | None = None     # dp, tiles: the group's size, checked
    tile_local_cap: int | None = None  # tiles: the slots of a tile (None:
    #                                    planned from the release schedule)
    turboff: bool = False
    met_bf16: bool = True            # bfloat16 per-step interpolation
    #                                  tables (StepConfig.met_bf16)
    profile: bool = False            # named-section device timing table
    #                                  (mpif_mtime analog; utils/profile)
    trace_dir: str | None = None     # a torch.profiler trace of the run
    #                                  here (TensorBoard's *.pt.trace.json)
    legacy_rng: bool = False         # matched-RNG validation mode: every
    #                                  draw of the advance from the
    #                                  reference's rannumb table through the
    #                                  serial ran3 nrand chase, release
    #                                  positions in ran1 order
    #                                  (core/legacy.py); no nests, and
    #                                  device='cpu' only (no kernel)
    legacy_seed: int = -7            # idummy seed of the legacy streams
    legacy_trace: bool = False       # keep (itime, nrand bases, positions
    #                                  before the step, active) per step in
    #                                  self._legacy_trace, so that a test
    #                                  can replay particles through the
    #                                  scalar oracle with the same draws
    device: Any = "cuda"             # where the particles, the met fields
    #                                  and the accumulators live

    def _refuse_on_tiles(self):
        """Under ``distributed="tiles"``, raise for what the reference's
        tiles mode refuses, by name: nested met and backward deposition,
        and ``legacy_rng``."""
        if self.distributed != "tiles":
            return
        cmd = self.cmd
        refused = [n for n, on in (
            ("nested met grids", bool(self.met_nests)),
            ("backward deposition modes",
             cmd.ldirect < 0 and cmd.ind_receptor in (3, 4))) if on]
        if refused:
            raise ValueError("distributed='tiles' does not support: "
                             + ", ".join(refused)
                             + " (use distributed='dp' for these)")
        if self.legacy_rng:
            raise ValueError("legacy_rng is single-device only")

    def __post_init__(self):
        cmd = self.cmd
        self._refuse_on_tiles()
        if self.distributed not in (None, "dp", "tiles"):
            raise ValueError(f"distributed={self.distributed!r}: None, 'dp' "
                             "or 'tiles'")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and self.device.index is None \
                and torch.cuda.is_available():
            self.device = torch.device("cuda", torch.cuda.current_device())
        # particle data-parallelism and tiles: this rank's place in the
        # group
        self._group = None
        self._first = 0                  # the rank's first global slot
        self._tiles = None               # tiles: the rank's TiledEngine
        self._tile_defer_streak = 0
        self._placed_origin = None       # tiles: the placed slots' origins
        self._next_origin = None         # tiles: the next fresh origin
        if self.distributed in ("dp", "tiles"):
            if self.legacy_rng:
                raise ValueError("legacy_rng is single-device only")
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("Simulation(device='cuda') needs a CUDA "
                                   "device; pass device='cpu' to run on the "
                                   "CPU")
            self._group = parallel.particle_mesh(self.n_devices, self.device)
        elif self.n_devices is not None:
            raise ValueError("n_devices is the size of a distributed='dp' "
                             "or 'tiles' group")
        self._writes = self._group is None or self._group.rank == 0
        if self.legacy_rng and self.device.type == "cuda":
            raise NotImplementedError(
                "legacy_rng on a CUDA device: the legacy-RNG validation path "
                "has no kernel; pass device='cpu'")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Simulation(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")
        if self.device.type == "cpu":
            # MKL's vector math picks its path at each function's first
            # call; made by several threads at once (the intra-op threads,
            # the met reader) it can come out inexact (utils/cpu.py)
            warm_vector_math()
        dev = self.device
        if self.legacy_rng and self.met_nests:
            raise ValueError("legacy_rng does not support nests")
        # nested met grids, outermost -> innermost (pathnames order,
        # readpaths.f90:45-80); the advance picks a particle's innermost
        # nest (advance.f90:167-175)
        self.nest_grids = tuple(m.grid for m in self.met_nests)
        # backward deposition modes (readcommand.f90:316-339): 3 WETBKDEP,
        # 4 DRYBKDEP; the factors are pending until every released
        # particle has one
        self.bkdep = (cmd.ind_receptor
                      if cmd.ldirect < 0 and cmd.ind_receptor in (3, 4)
                      else 0)
        self._bkdep_pending = self.bkdep != 0
        self.nspec = self.releases.nspec
        self.numpoint = self.releases.numpoint
        self.geo = OutputGridGeometry(self.outgrid, self.grid)
        nage = self.ageclasses.nageclass

        # settling is off if any release point emits more than one species
        # (readreleases.f90:610-624); otherwise each particle settles with
        # its own species' parameters (advance.f90:518-531)
        lsettling = all(sum(1 for m in box.mass if m > 1e-9) <= 1
                        for box in self.releases.boxes)
        sp_scs = [s.size_classes() for s in self.releases.species]
        any_settle = any(s.density > 0.0 and c is not None
                         for s, c in zip(self.releases.species, sp_scs))
        top_lat = self.grid.ylat0 + (self.grid.ny - 1) * self.grid.dy
        self.step_cfg = StepConfig(
            nx=self.grid.nx, ny=self.grid.ny, nz=self.grid.nlev,
            xglobal=self.grid.xglobal, ldirect=cmd.ldirect,
            turbswitch=cmd.turbswitch, ifine=cmd.ifine_eff,
            method=cmd.method, settling=lsettling and any_settle,
            turboff=self.turboff, met_bf16=self.met_bf16,
            cblflag=cmd.cblflag == 1,
            nests=tuple((g.nx, g.ny) for g in self.nest_grids),
            polar=bool(self.grid.xglobal
                       and (top_lat > 75.0 or self.grid.ylat0 < -75.0)))
        self.step_cfg.check()
        if self.distributed == "tiles":
            self._setup_tiles()
        self.step_prm = StepParams.make(
            dx=self.grid.dx, dy=self.grid.dy, ylat0=self.grid.ylat0,
            dxconst=self.grid.dxconst, dyconst=self.grid.dyconst,
            lsynctime=cmd.lsynctime, fine=cmd.fine,
            lwindinterv=self.wind_interval, xlon0=self.grid.xlon0,
            ctl=cmd.ctl_eff,
            sp_density=[max(s.density, -1.0)
                        for s in self.releases.species],
            sp_dquer=[s.dquer for s in self.releases.species],
            sp_cunningham=[c.cunningham if c else 0.0 for c in sp_scs],
            sp_vsetaver=[c.vsetaver if c else 0.0 for c in sp_scs],
            **(nest_windows(self.grid, self.nest_grids)
               if self.nest_grids else {}))
        # convection: the grid's kernel, and the cloud-base mass flux
        # memory of every column, kept on the device between steps
        self.conv_kernel = None
        self.cbmf: torch.Tensor | None = None
        if cmd.lconvection == 1:
            self.conv_kernel = make_convection_kernel(self.grid)
            self.cbmf = torch.zeros(self.grid.ny * self.grid.nx,
                                    dtype=torch.float32, device=dev)
        # per convection step, on the device: (convecting columns, moved
        # particles); summed into timings at the end of the run
        self.convection_counts: list[torch.Tensor] = []
        self.conc_cfg = ConcConfig(
            nxg=self.geo.nxg, nyg=self.geo.nyg, nzg=self.geo.nzg,
            npointspec=self.numpoint if cmd.ioutputforeachrelease else 1,
            nclassunc=self.nclassunc, nage=nage,
            dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
            xoutshift=self.geo.xoutshift, youtshift=self.geo.youtshift,
            dx_met=self.grid.dx, dy_met=self.grid.dy,
            ind_samp=cmd.ind_samp,
            ioutputforeachrelease=bool(cmd.ioutputforeachrelease),
            bkdep=self.bkdep != 0)
        self.conccalc = (
            make_conccalc(self.outgrid.outheights) if self._tiles is None
            else ptiles.make_tiled_conccalc(self.outgrid.outheights,
                                            self._tiles.tile))
        self.lage = torch.as_tensor(
            np.asarray(self.ageclasses.lage or (999999999,), np.int32),
            device=dev)

        # nested output grid (outgrid_init_nest.f90 / concoutput_nest): K3
        # on the nest's grid at every sampling, its own accumulator and
        # writer (outdir/nest)
        self.use_nested_output = self.outgrid_nest is not None
        if self.use_nested_output:
            ogn = self.outgrid_nest
            self.geo_n = OutputGridGeometry(ogn, self.grid)
            self.conc_cfg_n = ConcConfig(
                nxg=self.geo_n.nxg, nyg=self.geo_n.nyg, nzg=self.geo_n.nzg,
                npointspec=self.conc_cfg.npointspec,
                nclassunc=self.nclassunc, nage=nage,
                dxout=ogn.dxout, dyout=ogn.dyout,
                xoutshift=self.geo_n.xoutshift,
                youtshift=self.geo_n.youtshift,
                dx_met=self.grid.dx, dy_met=self.grid.dy,
                ind_samp=cmd.ind_samp,
                ioutputforeachrelease=bool(cmd.ioutputforeachrelease))
            self.conccalc_n = (
                make_conccalc(ogn.outheights, nest=True)
                if self._tiles is None
                else ptiles.make_tiled_conccalc(
                    ogn.outheights, self._tiles.tile, nest=True))
            self.acc_n = zero_accumulators(
                self.geo_n, self.nspec, self.conc_cfg.npointspec,
                self.nclassunc, nage, device=dev)
            self.writer_n = OutputWriter(
                outdir=self.outdir + "/nest",
                outlon0=ogn.outlon0, outlat0=ogn.outlat0,
                dxout=ogn.dxout, dyout=ogn.dyout,
                outheights=ogn.outheights,
                species_names=tuple(s.name for s in self.releases.species),
                start=cmd.bdate, iout=cmd.iout_eff,
                write_netcdf=self.write_netcdf, write_npz=self.write_npz,
                nc_meta=self._nc_meta(),
                surf_only=bool(cmd.surf_only))

        # domain filling (init_domainfill.f90): the particles are made from
        # the first wind field at the start of run(), all released at 0; a
        # regional window adds the boundary state (core/domainfill.py)
        self._boundary: domainfill.BoundaryState | None = None
        self.airmass_total: float | None = None
        self.boundary_counts: list[torch.Tensor] = []  # per step (killed,
        #                                                free, wanted, granted)
        self._first_release: int | None = None
        if cmd.mdomainfill >= 1:
            self.particles = None
            self._release_times = frozenset((0,))
        else:
            self._schedule_releases()
        self.acc: Accumulators = zero_accumulators(
            self.geo, self.nspec, self.conc_cfg.npointspec,
            self.nclassunc, nage, device=dev)
        self.writer = OutputWriter(
            outdir=self.outdir,
            outlon0=self.outgrid.outlon0, outlat0=self.outgrid.outlat0,
            dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
            outheights=self.outgrid.outheights,
            species_names=tuple(s.name for s in self.releases.species),
            start=cmd.bdate, iout=cmd.iout_eff,
            write_netcdf=self.write_netcdf, write_npz=self.write_npz,
            nc_meta=self._nc_meta(),
            surf_only=bool(cmd.surf_only))
        if self.write_fortran and self._writes:
            self._write_fortran_header()

        self._height = None
        self._buf: dict[int, Any] = {}   # met_time -> (ZFields, EtaFields)
        self._prefetch: dict[int, Any] = {}  # met_time -> Future
        if self._tiles is not None:
            # the met read that sized the halo, kept as a completed
            # prefetch so that the first _get_field reuses it
            t_probe, raw = self._halo_probe
            fut = concurrent.futures.Future()
            fut.set_result(("raw", raw))
            self._prefetch[t_probe] = fut
            self._halo_probe = None
        self._reader = None              # lazy background reader thread
        self._met_stream = None          # the reader's CUDA stream
        self._prefetch_failures = 0      # dead-reader visibility counter
        self._precip_started = False     # wetscav_precip.txt begun
        self.timings: dict[str, float] = {}
        self.timers = SectionTimers(device_sync=self.profile, device=dev)
        self.nan_count = 0               # CBL redraws (advance.f90:437)
        self.n_sorts = 0

        # --- deposition / decay setup (wetdepo.f90, getvdep.f90 chain) ---
        species = self.releases.species
        self.wet_species = tuple(WetSpecies.from_species(s) for s in species)
        self.any_wetdep = any(w.wetdep for w in self.wet_species)
        self.any_drydep = any(s.drydep for s in species)
        self.mass_species = MassSpecies(
            decay=tuple(s.decay for s in species),
            drydep=tuple(s.drydep for s in species),
            minmass=self.minmass)
        self.any_decay = any(s.decay > 0 for s in species)
        self._decay_arr = torch.as_tensor([s.decay for s in species],
                                          dtype=torch.float32, device=dev)
        self._vdep_kernel = None        # built lazily (needs the lsm field)
        # OH chemistry is switched on by a species (readspecies: ohcconst
        # > 0)
        self.any_ohreact = any(s.ohreact for s in species)
        if self.any_ohreact:
            if self.oh_field is None:
                log.warning("OH species present but no OH climatology "
                            "given; using the synthetic stand-in field")
                self.oh_field = synthetic_oh_field()
            self._hourly_oh = HourlyOH(self.oh_field, cmd.bdate, cmd.ldirect,
                                       device=dev)
            self._ohreaction = make_ohreaction(self.oh_field, self.grid,
                                               species, dev)
        # splitting inside the run (itsplit shorter than the run); its
        # children take free slots ranked by schedule origin, so the run
        # keeps ``_origin`` through every sort
        self._splits = cmd.itsplit < abs(cmd.ideltas)
        self.split_counts: list[torch.Tensor] = []   # per split (due,
        #                                             free, granted)
        # receptor sampling (conccalc.f90:430-498; K15)
        self.receptor_set, self.receptor_names = build_receptors(
            self.receptors, self.grid, dev)
        if self.receptor_set is not None:
            self.creceptor = torch.zeros(
                (len(self.receptor_names), self.nspec), dtype=torch.float32,
                device=dev)
        # gross flux diagnostics (iflux=1, calcfluxes.f90; K16)
        self.use_flux = cmd.iflux == 1
        if self.use_flux:
            self.flux_cfg = FluxConfig(
                nxg=self.geo.nxg, nyg=self.geo.nyg, nzg=self.geo.nzg,
                npointspec=self.conc_cfg.npointspec, nage=nage,
                dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
                xoutshift=self.geo.xoutshift, youtshift=self.geo.youtshift,
                dx_met=self.grid.dx, dy_met=self.grid.dy,
                nx_met=self.grid.nx)
            self.flux = zero_flux(self.flux_cfg, self.nspec, dev)
            self._calcfluxes = make_calcfluxes(self.outgrid.outheights, dev)
        # plume-centroid trajectories (iout=4/5; plumetraj.f90), clustered
        # in schedule order
        self.use_plumetraj = cmd.iout_eff in (4, 5)
        self._plume_writer = None
        if self.use_plumetraj and self._writes:
            self._plume_writer = PlumeTrajWriter(
                Path(self.outdir) / "trajectories.txt", self.releases,
                cmd.bdate)
        # sensitivity to initial conditions (linit_cond,
        # initial_cond_calc.f90; K17)
        self.use_initcond = cmd.linit_cond >= 1
        if self.use_initcond:
            self.ic_cfg = InitCondConfig(
                nxg=self.geo.nxg, nyg=self.geo.nyg, nzg=self.geo.nzg,
                npointspec=self.conc_cfg.npointspec,
                dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
                xoutshift=self.geo.xoutshift, youtshift=self.geo.youtshift,
                dx_met=self.grid.dx, dy_met=self.grid.dy,
                linit_cond=cmd.linit_cond,
                ioutputforeachrelease=bool(cmd.ioutputforeachrelease))
            self.init_cond = zero_init_cond(self.ic_cfg, self.nspec, dev)
            self._ic_scatter = make_initcond_scatter(
                self.outgrid.outheights, dev)
            rm = np.zeros((self.conc_cfg.npointspec, self.nspec), np.float32)
            for b_idx, b in enumerate(self.releases.boxes):
                kp = b_idx if cmd.ioutputforeachrelease else 0
                for k in range(self.nspec):
                    rm[kp, k] += b.mass[k] if k < len(b.mass) else 0.0
            self._release_mass = rm
        self._avg_sums = None            # ipout=3 running sums
        self._avg_counts = None
        # tests only: `_draws_hook(istep, origin)` returns the advance's
        # injected draws for this step, already in slot order (the
        # adaptive step's tags 1 and 2 with a leading pass axis),
        # `_redist_hook(istep, origin)` the convective redistribution's
        # uniforms, and `_boundary_hook(istep)` the boundary's (u1, u2,
        # nclass), each (KMAX_EMIT, S); `origin[k]` is the schedule slot of
        # the particle now in slot k (kept while a hook is set, the run
        # splits, a regional boundary emits or plume trajectories are
        # clustered; None is the identity)
        self._sharded_advance = (
            None if self._group is None or self._tiles is not None
            else parallel.make_sharded_advance(self._group, self.step_cfg))
        self._draws_hook: Callable | None = None
        self._redist_hook: Callable | None = None
        self._boundary_hook: Callable | None = None
        # tiles: the schedule origins of the rank's placed slots (global;
        # -1 for an empty slot), kept through every sort and migration
        self._origin: torch.Tensor | None = self._placed_origin
        # measurements only: called with (istep, itime) at the top of each
        # step, after the release and before the sort, to look at the
        # ensemble and the fields the step meets.  A probe may wait for the
        # card; a run that is timed as one that never does sets none.
        self._step_probe: Callable | None = None

    def _setup_tiles(self) -> None:
        """The tiles of a tiles run: the mesh over the group's ranks, the
        halo from the first wind field's largest wind (with a quarter's
        margin; its read is kept for the run), the rank's TiledEngine."""
        cmd, grid = self.cmd, self.grid
        nty, ntx = ptiles.choose_tile_mesh(self._group.world, grid.ny,
                                           grid.nxfield)
        t0 = 0 if cmd.ldirect > 0 else -self.wind_interval
        raw = self._fetch_raw(t0)
        eta = raw[0]
        umax = 1.25 * float(torch.maximum(eta.uuh.abs().max(),
                                          eta.vvh.abs().max()))
        tx = -(-grid.nxfield // ntx)
        ty = -(-grid.ny // nty)
        halo = max(2, min(pdomain.halo_for(umax, cmd.lsynctime, grid.dx),
                          tx - 1, ty - 1))
        self._halo_probe = (t0, raw)
        self._tiles = ptiles.TiledEngine(self._group, self.step_cfg, grid,
                                         nty, ntx, halo)
        log.info("distributed tiles: %dx%d mesh, %dx%d-cell tiles, halo %d",
                 nty, ntx, self._tiles.ty, self._tiles.tx, halo)

    def _get_tiles(self, tsec: int):
        """This rank's tile of the processed fields at a met time."""
        self._get_field(tsec)
        return self._buf[tsec][3]

    def _nc_meta(self) -> dict:
        """Reference-layout netCDF-4 metadata (netcdf_output_mod.f90:
        writemetadata + the RELCOM/RELLNG/RELZZ/RELPART release block +
        per-species physics attributes + output_units table)."""
        cmd = self.cmd
        rel = self.releases
        # output units (Stohl et al. 2005 table 1; output_units())
        if cmd.ldirect == 1:
            units = "ng m-3" if cmd.ind_receptor == 1 else "ng kg-1"
        elif cmd.ind_source == 1:
            units = "s" if cmd.ind_receptor == 1 else "s m3 kg-1"
        else:
            units = "s kg m-3" if cmd.ind_receptor == 1 else "s"
        prefix = {3: "grid_wetdep_", 4: "grid_drydep_"}.get(
            self.bkdep, "grid_conc_" if cmd.ldirect == 1 else "grid_time_")
        t0 = cmd.bdate
        relstart = [int((b.start - t0).total_seconds()) for b in rel.boxes]
        relend = [int((b.end - t0).total_seconds()) for b in rel.boxes]
        nspec = rel.nspec
        xmass = np.zeros((nspec, rel.numpoint), np.float32)
        for j, b in enumerate(rel.boxes):
            for ks in range(min(nspec, len(b.mass))):
                xmass[ks, j] = b.mass[ks]
        species = []
        for s in rel.species:
            species.append(dict(
                decay=float(s.decay), weightmolar=float(s.weightmolar),
                ohcconst=float(s.ohcconst), ohdconst=float(s.ohdconst),
                vsetaver=0.0,
                weta_gas=float(s.weta_gas), wetb_gas=float(s.wetb_gas),
                ccn_aero=float(s.ccn_aero), in_aero=float(s.in_aero),
                dquer=float(s.dquer), henry=float(s.henry),
                dryvel=float(s.dryvel), reldiff=float(s.reldiff),
                f0=float(s.f0), density=float(s.density),
                dsigma=float(s.dsigma)))
        return {
            "prefix": prefix,
            "units": units,
            "lage": list(self.ageclasses.lage or (999999999,)),
            "global": {
                "ldirect": int(cmd.ldirect),
                "ibdate": f"{cmd.ibdate:08d}", "ibtime": f"{cmd.ibtime:06d}",
                "iedate": f"{cmd.iedate:08d}", "ietime": f"{cmd.ietime:06d}",
                "loutstep": int(cmd.loutstep),
                "loutaver": int(cmd.loutaver),
                "loutsample": int(cmd.loutsample),
                "itsplit": int(cmd.itsplit),
                "lsynctime": int(cmd.lsynctime),
                "ctl": float(cmd.ctl), "ifine": int(cmd.ifine),
                "iout": int(cmd.iout), "ipout": int(cmd.ipout),
                "lsubgrid": int(cmd.lsubgrid),
                "lconvection": int(cmd.lconvection),
                "lagespectra": int(cmd.lagespectra),
                "ipin": int(cmd.ipin),
                "ioutputforeachrelease": int(cmd.ioutputforeachrelease),
                "iflux": int(cmd.iflux),
                "mdomainfill": int(getattr(cmd, "mdomainfill", 0)),
                "ind_source": int(cmd.ind_source),
                "ind_receptor": int(cmd.ind_receptor),
                "mquasilag": int(cmd.mquasilag),
                "nested_output": int(self.outgrid_nest is not None),
                "surf_only": int(cmd.surf_only),
                "linit_cond": int(getattr(cmd, "linit_cond", 0)),
            },
            "releases": {
                "names": [b.comment for b in rel.boxes],
                "RELLNG1": [b.lon1 for b in rel.boxes],
                "RELLNG2": [b.lon2 for b in rel.boxes],
                "RELLAT1": [b.lat1 for b in rel.boxes],
                "RELLAT2": [b.lat2 for b in rel.boxes],
                "RELZZ1": [b.z1 for b in rel.boxes],
                "RELZZ2": [b.z2 for b in rel.boxes],
                "RELKINDZ": [b.zkind for b in rel.boxes],
                "RELSTART": relstart,
                "RELEND": relend,
                "RELPART": [b.parts for b in rel.boxes],
                "RELXMASS": xmass,
            },
            "species": species,
        }

    # ----- met double buffer (getfields.f90:93-196 analog) -----
    def _fetch_raw(self, tsec: int):
        """Met read + assembly for one wind time (the host part of
        getfields; the fields land on the device): the mother's fields and
        a tuple of the nests' (empty without nests)."""
        eta = self.met_backend.fetch(float(tsec), self.device)
        etan = tuple(m.fetch(float(tsec), self.device)
                     for m in self.met_nests)
        return eta, etan

    def _prefetch_job(self, tsec: int, submitted=None):
        """Worker-thread body: the read and, once the height grid exists,
        the full processing pipeline, so the next field is buffer-ready
        when the step loop asks for it.  Returns ("processed", entry) or
        ("raw", (eta, etan)).

        On a CUDA device the worker runs on a stream of its own, so that
        its copies and kernels overlap the step loop's.  The hand-over
        goes both ways.  In: ``submitted`` is an event that the step loop
        recorded on its stream when it scheduled this job, and the
        worker's stream waits for it before anything else, so what the
        loop's stream had produced by then (the height grid) is complete
        when the worker reads it.  Out: the worker waits for its own
        stream before it returns the payload, so the consumer never sees a
        tensor that is still being written and never waits itself;
        ``_get_field`` tells the allocator that the tensors are used on the
        consumer's stream."""
        cuda = self.device.type == "cuda"
        if cuda and self._met_stream is None:
            self._met_stream = torch.cuda.Stream(self.device)
        ctx = torch.cuda.stream(self._met_stream) if cuda \
            else contextlib.nullcontext()
        with ctx:
            if submitted is not None:
                self._met_stream.wait_event(submitted)
            tf0 = _time.perf_counter()
            raw = self._fetch_raw(tsec)
            self.timers.add("getfields_fetch_bg", _time.perf_counter() - tf0)
            # WETBKDEP processes each field on the step loop's thread,
            # where it writes the release points' precipitation
            if self._height is None or self.bkdep == 3 or (
                    self.any_drydep and self._vdep_kernel is None):
                out = "raw", raw
            else:
                tp0 = _time.perf_counter()
                out = "processed", self._process_field(tsec, *raw)
                self.timers.add("getfields_proc_bg",
                                _time.perf_counter() - tp0)
            if cuda:
                self._met_stream.synchronize()
        return out

    def _prefetch_async(self, tsec: int):
        """Schedule a background read+preprocess of a future wind time —
        the reference's dedicated MPI reader rank with numwfmem=3
        (mpi_mod.f90:1598-2392) becomes one daemon thread overlapping the
        met read and the calcpar/verttransform pipeline with the step
        loop."""
        if tsec in self._buf or tsec in self._prefetch:
            return
        try:
            if self._reader is None:
                self._reader = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="metreader")
            submitted = None
            if self.device.type == "cuda":
                # the worker's stream waits for what this stream has
                # queued so far (_prefetch_job)
                submitted = torch.cuda.Event()
                submitted.record(torch.cuda.current_stream(self.device))
            self._prefetch[tsec] = self._reader.submit(
                self._prefetch_job, tsec, submitted)
        except Exception:
            # reader thread unavailable: the run reads synchronously in
            # _get_field, as the reference does — make that visible
            self._prefetch_failures += 1
            log.warning("met prefetch submission failed for t=%ss "
                        "(failure #%d); reading synchronously", tsec,
                        self._prefetch_failures, exc_info=True)

    def _adopt(self, entry):
        """Tensors made on the reader's stream are used on this thread's
        stream from now on; the allocator must not hand their memory to
        the reader again while this stream still reads it."""
        if self._met_stream is None:
            return entry
        here = torch.cuda.current_stream(self.device)

        def adopt(obj):
            if obj is None:
                return
            if isinstance(obj, (tuple, list)):
                for o in obj:
                    adopt(o)
                return
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if isinstance(v, torch.Tensor):
                    v.record_stream(here)
        adopt(entry)
        return entry

    def _get_field(self, tsec: int):
        if tsec not in self._buf:
            t0 = _time.perf_counter()
            fut = self._prefetch.pop(tsec, None)
            processed = None
            raw = None
            if fut is not None:
                try:
                    tag, payload = fut.result()
                    if tag == "processed":
                        processed = self._adopt(payload)
                        raw = payload[1], ()
                    else:
                        raw = self._adopt(payload)
                except Exception:
                    self._prefetch_failures += 1
                    log.warning("met prefetch for t=%ss died in the "
                                "reader thread (failure #%d); reading "
                                "synchronously", tsec,
                                self._prefetch_failures, exc_info=True)
                    raw = self._fetch_raw(tsec)
            else:
                raw = self._fetch_raw(tsec)
            eta = raw[0]
            if self.bkdep == 3 and self._writes:
                # release-point precipitation series (getfields.f90:141-143)
                write_precip(Path(self.outdir) / "wetscav_precip.txt",
                             add_seconds(self.cmd.bdate, tsec), self.releases,
                             self.grid, eta, first=not self._precip_started)
                self._precip_started = True
            if self._height is None:
                self._height = compute_heights(self.grid, eta)
            # output-grid orography for the netCDF header (ORO var,
            # netcdf_output_mod.f90:528-535 <- outgrid_init.f90:107-181),
            # from the first field read (a resumed run's height grid comes
            # from its checkpoint)
            if self.writer.nc_meta is not None \
                    and "oro" not in self.writer.nc_meta:
                self.writer.nc_meta["oro"] = oro_outgrid(
                    self.geo, eta.oro.cpu().numpy())
            # keep at most 3 buffered fields, evicting the one farthest
            # from the requested time: a backward run retires the later
            # fields, not the earlier ones it prefetched (the memind
            # rotation of getfields.f90:93-113 works both ways)
            while len(self._buf) >= 3:
                farthest = max(self._buf, key=lambda k: abs(k - tsec))
                del self._buf[farthest]
            self._buf[tsec] = (processed if processed is not None
                               else self._process_field(tsec, *raw))
            dt_gf = _time.perf_counter() - t0
            self.timers.add("getfields", dt_gf)
            log.debug("getfields t=%ss: %.2fs blocked (%s)", tsec, dt_gf,
                      "prefetched" if processed is not None else "sync")
        return self._buf[tsec][0]

    def _process_field(self, tsec: int, eta, etan=()):
        """Device-side processing of one fetched met time: calcpv +
        verttransform + calcpar, of the mother and of each nest (onto the
        mother's height grid, the verttransform_nests.f90 contract), and in
        a tiles run the rank's tile of it (its wind checked against the
        halo).  Returns the (z, eta, nests' z, tile or None) buffer entry
        (the convection reads the raw eta-level profiles,
        convmix.f90:168-189).  Safe to call from the prefetch worker thread
        once the height grid and the vdep kernel exist."""
        self._ensure_vdep_kernel(eta)
        if self._tiles is not None:
            pdomain.check_halo(float(torch.maximum(eta.uuh.abs().max(),
                                                   eta.vvh.abs().max())),
                               self._tiles.halo, self.cmd.lsynctime,
                               self.grid.dx)
        z = process_eta(self.grid, eta, self._height,
                        pvh=calcpv(self.grid, eta), use_clwc=self.use_clwc)
        z = calcpar(self.grid, eta, z, lsubgrid=bool(self.cmd.lsubgrid),
                    vdep_kernel=self._vdep_kernel)
        zn = tuple(
            calcpar(g, e, process_eta(g, e, self._height, pvh=calcpv(g, e),
                                      use_clwc=self.use_clwc),
                    lsubgrid=bool(self.cmd.lsubgrid))
            for g, e in zip(self.nest_grids, etan))
        zt = None if self._tiles is None else self._tiles.decompose(z)
        return (z, eta, zn, zt)

    def _ensure_vdep_kernel(self, eta):
        """The dry-deposition velocity function of the run, built at the
        first met read: the Wesely tables of ``options_dir`` for a gas with
        a diffusivity (or a sized aerosol), else the constant ``dryvel``
        field (getvdep.f90:196-203)."""
        if self._vdep_kernel is not None or not self.any_drydep:
            return
        species = self.releases.species
        needs_tables = any(s.reldiff > 0 or (s.density > 0 and s.dquer > 0)
                           for s in species)
        if needs_tables and self.options_dir is not None:
            mmdd = self.cmd.bdate.month * 100 + self.cmd.bdate.day
            td = setup_drydep(self.options_dir, self.grid, species,
                              eta.lsm.cpu().numpy(), mmdd)
            self._vdep_kernel = make_vdep_kernel(td)
        else:
            self._vdep_kernel = constant_vdep_kernel(species)

    def _get_eta(self, tsec: int):
        self._get_field(tsec)
        return self._buf[tsec][1]

    def _get_nest(self, tsec: int):
        """The nests' processed fields at a met time, outermost first."""
        self._get_field(tsec)
        return self._buf[tsec][2]

    def _ccfg_at(self, itime, base):
        """Sampling config for this step: the single-index direct-only
        scatter while no particle can be >= 3 h old (conccalc.f90:171)."""
        kp = kernel_possible_at(itime, self._first_release, base.use_kernel)
        if kp == base.kernel_possible:
            return base
        return base.replace(kernel_possible=kp)

    def _fields_for(self, itime: int):
        """The two wind fields around itime, (z0, z1, t0, t1) with t0 <
        t1; a backward run on a wind time takes the interval before it."""
        wi = self.wind_interval
        backward = self.cmd.ldirect < 0
        t0 = (itime // wi) * wi
        if backward and itime % wi == 0:
            t0 = itime - wi
        t1 = t0 + wi
        f0, f1 = self._get_field(t0), self._get_field(t1)
        # read the next field in the background while particles advance
        tn = t0 - wi if backward else t1 + wi
        if abs(tn) <= abs(self.cmd.ideltas) + wi:
            self._prefetch_async(tn)
        return f0, f1, t0, t1

    def close(self):
        """Stop the background met reader: drop pending prefetches (and
        retrieve their exceptions) so interpreter exit isn't delayed by
        reads past the run end."""
        for fut in self._prefetch.values():
            fut.cancel()
            if fut.done() and not fut.cancelled():
                fut.exception()          # consume, don't raise
        self._prefetch.clear()
        if self._reader is not None:
            self._reader.shutdown(wait=True, cancel_futures=True)
            self._reader = None
        self.writer.close()
        if self.use_nested_output:
            self.writer_n.close()

    def _schedule_releases(self) -> None:
        """The particles of the release schedule (and of a warm start) and
        the steps on which releases wake them."""
        cmd, dev = self.cmd, self.device
        # warm start (IPIN=1, FLEXPART.f90:322-333): the previous run's
        # partposit_end in the output directory, appended after the
        # scheduled releases
        warm = None
        if cmd.ipin == 1:
            dump = Path(self.outdir) / "partposit_end"
            if not dump.exists():
                raise FileNotFoundError(
                    f"IPIN=1 but no {dump} from a previous run "
                    "(readpartpositions.f90)")
            _, warm = partdump.read_partposit(dump, self.nspec)
        n_warm = len(warm["z"]) if warm else 0
        # the whole release schedule, built on the host and moved once;
        # its release times say on which steps `activate` wakes particles
        sched = release_schedule_arrays(
            self.releases, cmd, self.grid,
            capacity=None if self.capacity is None
            else self.capacity - n_warm,
            nclassunc=self.nclassunc, seed=self.seed, bkdep=self.bkdep)
        if self.legacy_rng:
            self._legacy_release_positions(sched)
        if n_warm:
            sched = self._append_warm_start(sched, warm)
        self._release_times = frozenset(
            int(t) for t in np.unique(sched["itra"]) if t != ITRA_INACTIVE)
        self.particles: Particles = interop.particles_from_numpy(
            self._rank_rows(sched), dev)
        # earliest scheduled release (s since bdate): the sampling kernel
        # (conccalc.f90:171 itage>10800) cannot trigger before
        # first_release + 3 h, so the sampler runs its single-index path
        # until then (grid/conccalc.py kernel_possible_at); None, the
        # kernel always possible, for a backward run and a warm start, as
        # the reference
        if cmd.ldirect > 0 and self.releases.boxes and not n_warm:
            self._first_release = min(
                int((b.start - cmd.bdate).total_seconds())
                for b in self.releases.boxes)

    def _rank_rows(self, arrays: dict) -> dict:
        """The rows of a global particle array (numpy, by field) that this
        process holds: all of them alone; in a data-parallel run the
        rank's rows of the array padded to a multiple of the world size; in
        a tiles run the slots of the rank's tile (``_placed_origin``: their
        schedule origins; the fresh ones start after the array's)."""
        if self._group is None:
            return arrays
        if self._tiles is not None:
            rows, origin = self._tiles.shard_initial(arrays,
                                                     self.tile_local_cap)
            self._first = self._tiles.index * self._tiles.local_cap
            self._placed_origin = torch.as_tensor(origin,
                                                  device=self.device)
            self._next_origin = len(arrays["z"])
            return rows
        arrays = parallel.pad_particles(arrays, self._group.world)
        self._first = self._group.rows(len(arrays["z"]))[0]
        return parallel.shard_particles(arrays, self._group)

    def _append_warm_start(self, sched: dict, warm: dict) -> dict:
        """Append partposit_end particles (readpartpositions.f90:100-131)
        after the scheduled-release slots: itra=0 so they wake at the first
        step; itramem keeps the original (pre-resume) release time so age
        classes stay correct; the turbulence memory is drawn by the first
        advance's fresh-particle block (itime == 0); nclass from the
        reference's own numpy stream (seed + 101)."""
        n = len(warm["z"])
        rng_w = np.random.default_rng(self.seed + 101)
        x = ((warm["lon"] - self.grid.xlon0) / self.grid.dx) \
            .astype(np.float32)
        y = ((warm["lat"] - self.grid.ylat0) / self.grid.dy) \
            .astype(np.float32)
        mass = warm["mass"].astype(np.float32)
        zf = np.zeros(n, np.float32)
        extra = dict(
            x_hi=x, x_lo=zf, y_hi=y, y_lo=zf,
            z=warm["z"].astype(np.float32),
            itra=np.zeros(n, np.int32),
            itramem=warm["itramem"].astype(np.int32),
            npoint=warm["npoint"].astype(np.int32),
            nclass=rng_w.integers(0, self.nclassunc, size=n)
            .astype(np.int32),
            idt=np.zeros(n, np.int32),
            itrasplit=np.full(n, 999999999, np.int32),
            up=zf, vp=zf, wp=zf, usig=zf, vsig=zf, wsig=zf,
            cbt=np.ones(n, np.int8), mass=mass, mass0=mass.copy(),
            xscav=np.ones((n, self.nspec), np.float32),
            active=np.zeros(n, np.bool_))
        log.info("warm start: %d particles resumed from partposit_end", n)
        return {f: np.concatenate([sched[f], extra[f]]) for f in FIELDS}

    # ----- main loop -----
    def run(self, progress: bool = False, start_itime: int = 0):
        """Run to the end; from ``start_itime`` after ``load_checkpoint``,
        continuing the straight run's steps (the same ``istep``, so the
        same draws and sorts)."""
        try:
            if self.trace_dir:
                with self._tracer():
                    return self._run(progress, start_itime)
            return self._run(progress, start_itime)
        finally:
            self.close()

    def _tracer(self):
        """A torch.profiler window over the run that writes its trace into
        ``trace_dir`` when it closes: the host's ops, and the card's
        kernels and copies where the run lives on one."""
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        Path(self.trace_dir).mkdir(parents=True, exist_ok=True)
        # a data-parallel run's ranks write a file each, named by rank
        worker = (None if self._group is None
                  else f"rank{self._group.rank}")
        return profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(
                           str(self.trace_dir), worker_name=worker))

    def save_checkpoint(self, path, itime: int | None = None) -> None:
        partdump.save_checkpoint(path, self, itime if itime is not None
                                 else getattr(self, "last_itime", 0))

    def load_checkpoint(self, path) -> int:
        """Restore a checkpoint of a run with this configuration; returns
        the itime to pass to ``run(start_itime=...)``."""
        return partdump.load_checkpoint(path, self)

    def _sort(self, height):
        """Put the particles in met-cell order.  Slot order means nothing
        to the model, but a slot-indexed snapshot taken before a sort is
        void after it: a slice that keeps one across the advance (the
        reference's ``xold``/``yold``/``zold`` for the fluxes and
        ``prev_active`` for the initial-condition scan) must take it after
        this call, which is why the sort sits at the top of the step."""
        with self.timers.section("reorder"):
            self.particles, perm = reorder.reorder_by_cell(
                self.particles, height, self.step_cfg)
        self.n_sorts += 1
        if self._avg_sums is not None:
            # the averaged dump's running sums follow their particles
            idx = perm.long()
            self._avg_sums = self._avg_sums[:, idx]
            self._avg_counts = self._avg_counts[idx]
        if self._splits or self._boundary is not None \
                or self.use_plumetraj or self._draws_hook is not None \
                or self._redist_hook is not None or self._tiles is not None:
            idx = perm.long()
            self._origin = idx if self._origin is None else self._origin[idx]

    def _slot_origin(self) -> torch.Tensor:
        """The schedule slot of the particle in each slot (tests' hooks):
        the global slot in a data-parallel run."""
        if self._origin is None:
            self._origin = torch.arange(self.particles.capacity,
                                        device=self.device)
        return self._origin if self._first == 0 or self._tiles is not None \
            else self._origin + self._first

    def _convect(self, istep: int, itime: int, mt0: int, mt1: int):
        """Convective redistribution (timemanager.f90:258-263 -> convmix,
        calcmatrix, convect, redist): the scheme over every grid column at
        the step's time weights, then each scheduled particle's draw
        against its column's matrix.  The raw fields of both met times
        come from the buffer, handed over from the reader's stream like
        the processed ones.  Nothing is read back: the convecting columns
        and the moved particles are kept on the device."""
        cmd = self.cmd
        e0, e1 = self._get_eta(mt0), self._get_eta(mt1)
        dt1 = float(itime - mt0)
        dt2 = float(mt1 - itime)
        dtt = 1.0 / (dt1 + dt2)
        conv = self.conv_kernel(
            e0.ps, e0.tth, e0.qvh, e0.tt2, e0.td2,
            e1.ps, e1.tth, e1.qvh, e1.tt2, e1.td2,
            float(np.float32(dt2 * dtt)), float(np.float32(dt1 * dtt)),
            self.cbmf, float(np.float32(abs(cmd.lsynctime))))
        self.cbmf = conv.cbmf
        rn = None
        if self._redist_hook is not None:
            rn = self._redist_hook(istep, self._slot_origin())
        self.particles, moved = redist_particles(
            self.particles, rng.Key(self.seed, istep), conv.fmassfrac,
            conv.rlevmass, conv.phconv, conv.sub, conv.uvzlev, conv.pconv,
            conv.tconv, conv.lconv, cmd.lsynctime, itime,
            nl=self.conv_kernel.nl, nx=self.grid.nx, ny=self.grid.ny, rn=rn,
            ldirect=cmd.ldirect, offset=self._first)
        self.convection_counts.append(torch.stack(
            [conv.lconv.sum(dtype=torch.int32), moved]))

    def _run(self, progress: bool = False, start_itime: int = 0):
        cmd = self.cmd
        # the run's times are signed: a backward run counts seconds
        # backwards from bdate (its end)
        ld = cmd.ldirect
        lsync = cmd.lsynctime * ld
        ideltas = cmd.ideltas
        loutnext = cmd.loutstep * ld
        loutaver = cmd.loutaver * ld
        loutstart = loutnext - loutaver // 2
        loutend = loutnext + loutaver // 2
        loutsample = cmd.loutsample * ld

        nsteps = abs(ideltas) // abs(lsync)
        t_wall0 = _time.perf_counter()
        # summed on the device; read for the progress log and at the end
        particle_steps = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        n_act = None
        # the CBL's NaN redraws, summed on the device
        nan_total = torch.zeros((), dtype=torch.int64, device=self.device)
        max_age = self.ageclasses.max_age
        itime = 0
        if self.legacy_rng:
            if start_itime != 0:
                raise ValueError("legacy_rng cannot resume mid-run (the "
                                 "serial idummy chain has no checkpoint)")
            # one shared ran3 chain feeds the per-particle nrand bases in
            # the reference's order (FLEXPART.f90:56-59, advance.f90:153)
            self._legacy_table = torch.as_tensor(
                make_rannumb(MAXRAND, self.legacy_seed), device=self.device)
            self._legacy_stream = NrandStream(self.legacy_seed, MAXRAND)

        if self.particles is None:
            self._fill_domain()
        first_step = abs(start_itime) // abs(lsync)
        # the output window of a mid-run resume (the output at
        # start_itime, if due, happens inside the resumed step)
        while start_itime != 0 and ld * loutend < ld * start_itime:
            loutnext = loutnext + cmd.loutstep * ld
            loutstart = loutnext - loutaver // 2
            loutend = loutnext + loutaver // 2
        for istep in range(first_step, nsteps + 1):
            itime = istep * lsync
            if self.checkpoint_at is not None \
                    and itime == self.checkpoint_at and start_itime != itime:
                with self.timers.section("checkpoint"):
                    self.save_checkpoint(self.checkpoint_path, itime)
            z0, z1, mt0, mt1 = self._fields_for(itime)

            # interval since the deposited mass's decay reference time
            # (wetdepo.f90:57-62)
            if ld * itime <= ld * loutnext:
                ldeltat = itime - (loutnext - cmd.loutstep * ld)
            else:
                ldeltat = itime - loutnext

            # wet deposition over the interval ending at itime
            # (timemanager.f90:164-169; the field nearest itime - lsync/2)
            if self.any_wetdep and istep > 0:
                with self.timers.section("wetdepo"):
                    interp_t = itime - lsync // 2
                    near0 = abs(mt0 - interp_t) < abs(mt1 - interp_t)
                    zw = z0 if near0 else z1
                    wet_args = (cmd.lsynctime, ldeltat, self.wet_species,
                                self.mass_species, self.use_clwc)
                    if self._tiles is None:
                        self.particles, wdep = wet_deposition(
                            self.particles, zw, *wet_args)
                    else:
                        self.particles, wdep = ptiles.tiled_wet_deposition(
                            self.particles,
                            self._get_tiles(mt0 if near0 else mt1),
                            self._tiles.tile, *wet_args)
                    if ld == 1:
                        self._scatter_depo(self.acc.wetgridunc, wdep, itime)

            # OH chemistry (timemanager.f90:171,216: gethourlyOH +
            # ohreaction), at the wind field nearer the step's middle
            if self.any_ohreact and istep > 0:
                with self.timers.section("ohchem"):
                    interp_t = itime - lsync // 2
                    zo = z0 if abs(mt0 - interp_t) < abs(mt1 - interp_t) \
                        else z1
                    oh0, oh1, to0, to1 = self._hourly_oh.fields_for(itime)
                    self.particles = self._ohreaction(
                        self.particles, oh0, oh1, to0, to1, itime,
                        zo.f3d[F3_TT], zo.height, cmd.lsynctime)

            # radioactive decay of deposited mass on the output grids
            # (timemanager.f90:269-304)
            if self.any_decay and istep > 0:
                decay_deposition_grids(self.acc.wetgridunc,
                                       self.acc.drygridunc, self._decay_arr,
                                       cmd.lsynctime)

            # releases
            self.particles = activate(self.particles, itime)

            # the regional domain fill's boundary (timemanager.f90:244-251
            # -> boundcond_domainfill.f90; K14)
            if self._boundary is not None:
                with self.timers.section("boundary"):
                    self._boundary_step(istep, itime, z0, z1, mt0, mt1)

            # cell order: every REORDER_EVERY steps, and when a release
            # has just woken particles (they sit in the last slots, out of
            # cell order).  The release times are known on the host, so
            # nothing is read back from the device to decide.
            if self._step_probe is not None:
                self._step_probe(istep, itime)
            # (the legacy path keeps the slot order: it is the order in
            # which the reference consumes its random chain)
            if not self.legacy_rng and (istep % reorder.REORDER_EVERY == 0
                                        or itime in self._release_times):
                self._sort(z0.height)

            # the backward deposition factor of each fresh particle, once
            # after its release (timemanager.f90:565-598)
            if self._bkdep_pending:
                with self.timers.section("bkdep"):
                    self._assign_bkdep(itime, z0, z1, mt0, mt1)

            # convective redistribution (timemanager.f90:258-263)
            if self.conv_kernel is not None:
                with self.timers.section("convection"):
                    self._convect(istep, itime, mt0, mt1)

            # quasi-Lagrangian compressed dump at the window's centre
            # (timemanager.f90:368-369)
            if cmd.mquasilag == 1 and itime == (loutstart + loutend) // 2:
                with self.timers.section("partdump"):
                    diag = self._diagnostics(itime, z0, z1, mt0, mt1)
                    p, (topo,) = self._gathered(diag[:1])
                    if self._writes:
                        partdump.write_shortposit(
                            Path(self.outdir) / ("shortposit_" + datestamp(
                                add_seconds(cmd.bdate, itime))),
                            itime, p, self.grid, topo)

            # sampling (timemanager.f90:350-365)
            if (ld * loutstart <= ld * itime <= ld * loutend
                    and (itime - loutstart) % loutsample == 0):
                weight = 0.5 if itime in (loutstart, loutend) else 1.0
                # a tiles run's density of ind_samp=-1: the rank's tile
                z1s = z1 if self._tiles is None else self._get_tiles(mt1)
                with self.timers.section("conccalc"):
                    self.acc = self.conccalc(
                        self.acc, self.particles, z1s, itime, self.lage,
                        weight, self._ccfg_at(itime, self.conc_cfg))
                    if self.use_nested_output:
                        self.acc_n = self.conccalc_n(
                            self.acc_n, self.particles, z1s, itime,
                            self.lage, weight,
                            self._ccfg_at(itime, self.conc_cfg_n))
                    if self.receptor_set is not None:
                        self._sample_receptors(itime, weight)

            # output (timemanager.f90:376-464)
            if itime == loutend and self._outnum() > 0:
                with self.timers.section("output"):
                    self._write_output(itime)
                # particle dumps (timemanager.f90:453-455,
                # partoutput_average.f90)
                if cmd.ipout == 1 and (abs(itime) // abs(cmd.loutstep)) \
                        % max(cmd.ipoutfac, 1) == 0:
                    with self.timers.section("partdump"):
                        self._write_partdump(itime, z0, z1, mt0, mt1)
                if cmd.ipout == 3 and self._avg_sums is not None:
                    with self.timers.section("partdump"):
                        p, (sums, counts) = self._gathered(
                            (self._avg_sums, self._avg_counts), (1, 0))
                        if self._writes:
                            partdump.write_partposit_average(
                                Path(self.outdir) / (
                                    "partposit_average_" + datestamp(
                                        add_seconds(cmd.bdate, itime))),
                                itime, p, sums, counts)
                    self._avg_sums = None
                # splitting once itime has passed itsplit (timemanager.f90:
                # 473-504); the children break the cell order
                if self._splits and abs(itime) >= cmd.itsplit:
                    with self.timers.section("split"):
                        if self._group is None:
                            self.particles, counts = split_particles(
                                self.particles, itime, ld, self._origin)
                        elif self._tiles is not None:
                            counts = self._tile_split(itime, ld)
                        else:
                            counts = parallel.split_sharded(
                                self._group, self.particles, itime, ld,
                                self._origin)
                    self.split_counts.append(counts)
                    self._sort(z0.height)
                loutnext = loutnext + cmd.loutstep * ld
                loutstart = loutnext - loutaver // 2
                loutend = loutnext + loutaver // 2
                if itime == loutstart:
                    self.acc = self.conccalc(
                        self.acc, self.particles,
                        z1 if self._tiles is None else self._get_tiles(mt1),
                        itime, self.lage, 0.5,
                        self._ccfg_at(itime, self.conc_cfg))

            if itime == ideltas:
                break

            # advance; the slot-indexed state that the fluxes and the
            # initial-condition scan keep across it is taken here, after
            # the step's sorts
            if self.use_initcond:
                prev_active = self.particles.active.clone()
            xold = yold = zold = None
            if self.use_flux:
                xold, yold = self.particles.x, self.particles.y
                zold = self.particles.z.clone()
            t0 = _time.perf_counter()
            draws = None
            if self._draws_hook is not None:
                draws = self._draws_hook(istep, self._slot_origin())
            z0n = z1n = None
            if self.nest_grids:
                z0n, z1n = self._get_nest(mt0), self._get_nest(mt1)
            leg = self._legacy_bases(itime) if self.legacy_rng else None
            if self._tiles is not None:
                # its sections of its own: the advance, the fluxes and the
                # initial condition before the migration, the migration
                pre = None
                if self.use_flux or self.use_initcond:
                    pre = functools.partial(
                        self._before_migration, itime + lsync, xold, yold,
                        zold, prev_active if self.use_initcond else None, z1)
                self.particles, diag = self._tile_step(
                    istep, itime, mt0, mt1, draws, pre)
                if self.use_initcond:
                    # the ends of the dry deposition and the age limit are
                    # scanned against the slots after the migration
                    prev_active = self.particles.active.clone()
            else:
                with self.timers.section("advance"):
                    if self._group is None:
                        self.particles, diag = advance_all(
                            self.particles, z0, z1, itime, mt0, mt1,
                            rng.Key(self.seed, istep), self.step_cfg,
                            self.step_prm, draws=draws, z0n=z0n, z1n=z1n,
                            leg=leg)
                    else:
                        self.particles, diag = self._sharded_advance(
                            self.particles, z0, z1, itime, mt0, mt1,
                            rng.Key(self.seed, istep), self.step_prm,
                            offset=self._first, draws=draws, z0n=z0n,
                            z1n=z1n)
            nan_total += diag.nan_count
            # the adaptive step's dry-deposition window; no sort runs
            # between the advance and the dry deposition, so its slots are
            # the particles'
            t_below = diag.t_below
            n_act = diag.n_active
            particle_steps += n_act
            if "advance_first_s" not in self.timings:
                # on a CUDA device the first advance builds the kernels it
                # launches (nvcc, unless build/kernels/ has them)
                self.timings["advance_first_s"] = round(
                    _time.perf_counter() - t0, 2)

            # the per-step sums of the averaged dump (ipout=3,
            # partpos_average.f90; timemanager.f90:617)
            if cmd.ipout == 3:
                with self.timers.section("partdump"):
                    self._average_sample(itime + lsync, z0, z1, mt0, mt1)

            # gross fluxes across the output cells' faces
            # (timemanager.f90:617-623; K16); a tiles run's before the
            # migration (_before_migration)
            if self.use_flux and self._tiles is None:
                with self.timers.section("fluxes"):
                    self._calcfluxes(self.flux, self.particles, xold, yold,
                                     zold, itime + lsync, self.lage,
                                     self.flux_cfg,
                                     bool(cmd.ioutputforeachrelease))

            # decay + dry deposition + minmass (timemanager.f90:643-686)
            if self.any_drydep or self.any_decay:
                with self.timers.section("drydepo"):
                    dry_args = (cmd.lsynctime, ldeltat, self.mass_species)
                    dry_kw = dict(has_vdep=self.any_drydep, t_below=t_below)
                    if self._tiles is None:
                        vdep = z1.vdep if self.any_drydep else None
                        self.particles, ddep = apply_decay_drydep(
                            self.particles, vdep, *dry_args, **dry_kw)
                    else:
                        vdep = (self._get_tiles(mt1).vdep
                                if self.any_drydep else None)
                        self.particles, ddep = ptiles.tiled_decay_drydep(
                            self.particles, vdep, self._tiles.tile,
                            *dry_args, **dry_kw)
                    if self.any_drydep and ld == 1:
                        self._scatter_depo(self.acc.drygridunc, ddep,
                                           itime + lsync)

            # age-class termination (timemanager.f90:701-707)
            if max_age is not None:
                age = torch.abs((itime + lsync) - self.particles.itramem)
                self.particles = self.particles.replace(
                    active=self.particles.active & (age <= max_age))

            # the initial-condition sensitivity of the particles that ended
            # in this step (timemanager.f90:631,702; K17)
            if self.use_initcond:
                with self.timers.section("initcond"):
                    died = prev_active & ~self.particles.active
                    self._ic_scatter(self.init_cond, self.particles, died,
                                     z1, self.ic_cfg)

            if progress and istep % 10 == 0:
                log.info("t=%8d s  particles=%8d", itime, int(n_act))

        # the run's end: the survivors' initial-condition sensitivity, then
        # grid_initial_* (timemanager.f90:735-747)
        if self.use_initcond:
            with self.timers.section("initcond"):
                _, z1e, _, _ = self._fields_for(itime)
                self._ic_scatter(self.init_cond, self.particles,
                                 self.particles.active, z1e, self.ic_cfg)
                ic = self._summed(self.init_cond)
                if self._writes:
                    write_initial_cond(self.outdir, itime,
                                       interop.to_numpy(ic),
                                       self._release_mass)
        if cmd.ipout in (1, 2):
            with self.timers.section("partdump"):
                z0, z1, mt0, mt1 = self._fields_for(itime)
                self._write_partdump(itime, z0, z1, mt0, mt1, end=True)
        self.last_itime = itime
        self.nan_count = int(nan_total)
        if self.nan_count > 0:
            # the reference warns when the CBL redraws NaN velocities
            # (timemanager.f90:714-727)
            log.warning("CBL scheme redrew %d NaN velocities; reduce ifine "
                        "if this is a non-negligible fraction of the "
                        "particle count", self.nan_count)
        self.timings.update(self.timers.seconds)
        self.timings["particle_steps"] = int(particle_steps)
        if self.convection_counts:
            self.timings["convection_moved"] = int(self._summed(
                torch.stack(self.convection_counts)[:, 1].sum()))
        self.timings["wall"] = _time.perf_counter() - t_wall0
        if self.profile:
            report = self.timers.report(extra={
                "psteps/s": f"{self.timings['particle_steps'] / max(self.timings['wall'], 1e-9):.0f}",
                "sorts": self.n_sorts,
                "prefetch_failures": self._prefetch_failures,
                "advance_first_s": self.timings.get("advance_first_s", 0.0)})
            log.info("per-section timings (device-synced):\n%s", report)
            if self._writes:
                (Path(self.outdir) / "profile.txt").write_text(report + "\n")
        return self.particles

    def _tile_step(self, istep: int, itime: int, mt0: int, mt1: int,
                   draws, pre=None):
        """A tiles run's advance: the rank's tile step (timed as
        ``advance``) and the migration (``migrate``; parallel/tiles.py),
        ``pre`` called on the state between them (its own sections), the
        group's deferrals counted (the same count on every rank).  A
        particle that its full target tile denies stays in the halo and
        retries next step; a second step in a row that defers any is a hot
        tile, and the group regroups at twice the tile capacity (the
        reference's simulation.py:1286-1294): every schedulable slot placed
        again by its owner, the draws' offset with the new capacity."""
        eng = self._tiles
        # the averaged dump's per-slot sums travel with their particles
        avg = (() if self._avg_sums is None
               else (*self._avg_sums.unbind(0), self._avg_counts))
        with self.timers.section("advance"):
            q, diag = eng.step(
                self.particles, self._get_tiles(mt0), self._get_tiles(mt1),
                itime, mt0, mt1, rng.Key(self.seed, istep), self.step_prm,
                draws=draws)
        if pre is not None:
            pre(q)
        with self.timers.section("migrate"):
            return self._migrate(q, diag, avg)

    def _migrate(self, q, diag, avg):
        """``_tile_step``'s migration, and the regroup of a hot tile."""
        eng = self._tiles
        p, diag, deferred = eng.migrate(q, diag, self._origin, avg)
        if not deferred:
            self._tile_defer_streak = 0
            return p, diag
        self._tile_defer_streak += 1
        log.warning("tile migration deferred %d particles (a tile near its "
                    "capacity %d)", deferred, eng.local_cap)
        if self._tile_defer_streak < 2:
            return p, diag
        new_cap = 2 * eng.local_cap
        log.warning("tile rebalance: regrouping at a tile capacity of %d",
                    new_cap)
        t_below = () if diag.t_below is None else (diag.t_below,)
        p, self._origin, moved = eng.regroup(p, self._origin, new_cap,
                                             t_below + avg)
        self._first = eng.index * eng.local_cap
        self._tile_defer_streak = 0
        if avg:
            self._avg_sums = torch.stack(moved[len(t_below):-1])
            self._avg_counts = moved[-1]
        return p, dataclasses.replace(
            diag, t_below=moved[0] if t_below else None)

    def _before_migration(self, itime: int, xold, yold, zold, prev_active,
                          z1, q) -> None:
        """Tiles: what reads the state after the advance and before the
        migration (the reference's ``return_pre``), in the slots of the
        state before the step: the fluxes across the output cells' faces
        (K16, into the rank's partial flux grid) and the initial
        condition's scan of the particles that ended in the advance (K17,
        into the rank's partial grid)."""
        if self.use_flux:
            with self.timers.section("fluxes"):
                self._calcfluxes(self.flux, q, xold, yold, zold, itime,
                                 self.lage, self.flux_cfg,
                                 bool(self.cmd.ioutputforeachrelease))
        if prev_active is not None:
            with self.timers.section("initcond"):
                self._ic_scatter(self.init_cond, q, prev_active & ~q.active,
                                 z1, self.ic_cfg)

    def _tile_split(self, itime: int, ldirect: int) -> torch.Tensor:
        """Tiles: K13 alone on the rank's slots (no ``Share``), the free
        slots ranked in slot order, so that every child stays on its
        parent's tile (the reference's ``make_tiled_split``); each child
        takes a fresh origin.  Returns the group's counts (due, free,
        granted)."""
        _, free = due_and_free(self.particles, itime, ldirect)
        self.particles, counts = split_particles(self.particles, itime,
                                                 ldirect)
        return self._fresh_origins(free & self.particles.active, counts, 2,
                                   "split_counts")

    def _fill_domain(self) -> None:
        """Fill the domain (or the release box's window) with particles of
        equal air mass from the first wind field (init_domainfill.f90); a
        window smaller than the domain adds its boundary state."""
        cmd, g = self.cmd, self.grid
        zf = self._get_field(0)
        box = self.releases.boxes[0]
        window = ((box.lon1 - g.xlon0) / g.dx, (box.lon2 - g.xlon0) / g.dx,
                  (box.lat1 - g.ylat0) / g.dy, (box.lat2 - g.ylat0) / g.dy)
        parts, self.airmass_total, bnd = domainfill.init_domainfill(
            g, zf, box.parts, mdomainfill=cmd.mdomainfill,
            nclassunc=self.nclassunc, seed=self.seed,
            capacity=self.capacity, window=window)
        self.particles = interop.particles_from_numpy(
            self._rank_rows(parts), self.device)
        if self._tiles is not None:
            # the fill's origins (the constructor, before the fill, took
            # none)
            self._origin = self._placed_origin
        if bnd is not None:
            self._boundary = self._own_boundary(
                domainfill.BoundaryState.from_numpy(bnd, self.device))
        log.info("domain-filling: %d particles, total air mass %.3e kg%s",
                 self.particles.capacity, self.airmass_total,
                 "" if bnd is None
                 else " (regional window + boundary conditions)")

    def _own_boundary(self, bs):
        """A regional boundary's state as this process runs it: whole
        alone and in a data-parallel run; in a tiles run every site kept
        (so that each draws by its global index) but valid only where the
        rank's tile owns its column, its accumulator zero elsewhere (the
        sites' validities and accumulators then sum over the group
        exactly)."""
        if self._tiles is None:
            return bs
        valid = bs.valid & self._tiles.owned_sites(bs.col_flat.long(),
                                                   self.grid.nx)
        return bs.replace(valid=valid, acc=torch.where(
            valid, bs.acc, torch.zeros_like(bs.acc)))

    def _boundary_step(self, istep: int, itime: int, z0, z1, mt0: int,
                       mt1: int) -> None:
        """One step of the regional boundary (K14 on a CUDA device): the
        particles outside the window end, the inflow accumulates, new
        particles take free slots ranked by schedule origin (in a tiles
        run by slot, each a fresh origin)."""
        cmd, g, bs = self.cmd, self.grid, self._boundary
        _, _, xhi, _, _ = bs.limits()
        check_x = not (g.xglobal and xhi == g.nx - 2)
        draws = (self._boundary_hook(istep)
                 if self._boundary_hook is not None else None)
        w0, w1 = domainfill.time_weights(itime, mt0, mt1)
        step = (domainfill.boundcond
                if self._group is None or self._tiles is not None
                else functools.partial(parallel.boundcond_sharded,
                                       self._group))
        free = (None if self._tiles is None
                else parallel.free_after_kill_mask(self.particles, bs,
                                                   check_x))
        bs.acc, counts = step(
            self.particles, bs, z0.f3d, z1.f3d, z0.height, itime, w0, w1,
            rng.Key(self.seed, 3000000 + istep), cmd.lsynctime,
            min(cmd.itsplit, 499999999), g.ylat0, g.dy,
            mdomainfill=cmd.mdomainfill, ldirect=cmd.ldirect,
            nclassunc=self.nclassunc, check_x=check_x,
            origin=None if self._tiles is not None else self._origin,
            draws=draws)
        if free is not None:
            # the emitted particles: the slots free after the kill that
            # are live now (granted, the counts' last)
            counts = self._fresh_origins(free & self.particles.active,
                                         counts, 3, "boundary")
        self.boundary_counts.append(counts)

    def _fresh_origins(self, new: torch.Tensor, counts: torch.Tensor,
                       col: int, what: str) -> torch.Tensor:
        """Tiles: origins for the particles new in this rank's slots
        ``new`` (a split's children, the boundary's emissions), unique
        over the group: ``_next_origin`` plus the group's new particles of
        the ranks before this one, in slot order; ``counts[col]`` is this
        rank's count of them.  Returns the group's ``counts`` summed (one
        ``all_gather``, read by the host)."""
        every = torch.stack(self._group.all_gather(counts, what)) \
            .cpu().numpy().astype(np.int64)
        rank = self._group.rank
        base = self._next_origin + int(every[:rank, col].sum())
        order = torch.cumsum(new.to(torch.int64), 0) - 1
        self._origin = torch.where(new, base + order, self._origin)
        self._next_origin += int(every[:, col].sum())
        return torch.as_tensor(every.sum(0), dtype=counts.dtype,
                               device=counts.device)

    @staticmethod
    def _time_weights(itime: int, mt0: int, mt1: int):
        """The float32 weights of the met times mt0 and mt1 at ``itime``
        (the reference's for its particle dumps)."""
        dt1 = float(itime - mt0)
        dt2 = float(mt1 - itime)
        dtt = 1.0 / max(dt1 + dt2, 1e-9)
        return float(np.float32(dt2 * dtt)), float(np.float32(dt1 * dtt))

    def _diagnostics(self, itime: int, z0, z1, mt0: int, mt1: int):
        """The met quantities of the dump record at the particles
        (io/partdump.py::particle_diagnostics) at ``itime``."""
        return partdump.particle_diagnostics(
            self.particles, z0, z1, *self._time_weights(itime, mt0, mt1))

    def _write_partdump(self, itime: int, z0, z1, mt0: int, mt1: int,
                        end: bool = False) -> None:
        """partposit_<date> of the particles updated at ``itime``, or
        partposit_end of every live one (partoutput.f90)."""
        name = ("partposit_end" if end else "partposit_" + datestamp(
            add_seconds(self.cmd.bdate, itime)))
        p, diag = self._gathered(self._diagnostics(itime, z0, z1, mt0, mt1))
        if self._writes:
            partdump.write_partposit(Path(self.outdir) / name, itime, p,
                                     self.grid, diag, only_current=not end)

    def _gathered(self, rows=(), dims=None):
        """The particles and per-particle ``rows`` (tensors with a
        particle axis, ``dims`` each, default 0) of the whole run: this
        process's alone; in a data-parallel run every rank's in global
        slot order, gathered (rank 0 writes them)."""
        if self._group is None:
            return self.particles, tuple(rows)
        dims = dims or (0,) * len(rows)
        g = self._group
        p = parallel.gather_particles(g, self.particles)
        rows = tuple(g.cat_rows(r, "gather", dim=d)
                     for r, d in zip(rows, dims))
        if self._tiles is None:
            return p, rows
        # a tiles run's placed particles, in schedule-origin order
        at = self._origin_order()
        return (Particles(**{f: getattr(p, f)[at] for f in FIELDS}),
                tuple(r.index_select(d, at) for r, d in zip(rows, dims)))

    def _origin_order(self) -> torch.Tensor:
        """Tiles: the gathered slots that hold a placed particle, in
        schedule-origin order."""
        origin = self._group.cat_rows(self._origin, "gather")
        keep = torch.nonzero(origin >= 0).flatten()
        return keep[torch.argsort(origin[keep])]

    def global_origin(self) -> torch.Tensor | None:
        """The schedule slot of the particle in each slot of the whole run
        (``_gathered``'s order), or None where the run keeps no origins
        (the identity)."""
        if self._origin is None:
            return None
        if self._group is None:
            return self._origin
        if self._tiles is not None:
            origin = self._group.cat_rows(self._origin, "gather")
            return origin[self._origin_order()]
        return self._group.cat_rows(self._origin + self._first, "gather")

    def _average_sample(self, itime: int, z0, z1, mt0: int, mt1: int) -> None:
        """Add the particles' sample at ``itime`` (after the advance) to
        the running sums of the ipout=3 dump."""
        g = self.grid
        sample, live = partdump.averaging_sample(
            self.particles, z0, z1, *self._time_weights(itime, mt0, mt1),
            g.dx, g.dy, g.xlon0, g.ylat0)
        inc = live.to(torch.float32)
        contrib = sample * inc[None, :]
        if self._avg_sums is None:
            self._avg_sums, self._avg_counts = contrib, inc
        else:
            self._avg_sums = self._avg_sums + contrib
            self._avg_counts = self._avg_counts + inc

    def _assign_bkdep(self, itime: int, z0, z1, mt0: int, mt1: int) -> None:
        """WETBKDEP / DRYBKDEP: the scavenging factor of the particles
        released since the last call; once every released particle has
        one (a count read from the device), nothing is left pending."""
        if self.bkdep == 4:
            self._ensure_vdep_kernel(self._get_eta(mt1))
            self.particles = assign_drybkdep(self.particles, z1.vdep)
        else:
            # the field nearest the middle of the step about to be made
            interp_t = itime + self.cmd.lsynctime * self.cmd.ldirect // 2
            zw = z0 if abs(mt0 - interp_t) < abs(mt1 - interp_t) else z1
            self.particles = assign_wetbkdep(self.particles, zw,
                                             self.wet_species,
                                             use_clwc=self.use_clwc)
        if int((self.particles.xscav[:, 0] < 0).sum()) == 0:
            self._bkdep_pending = False

    def _legacy_release_positions(self, sched: dict) -> None:
        """Replace the scheduled release positions with the reference's
        ran1 order (releaseparticles.f90:147-193): per particle x, y,
        nclass, z from one idummy chain across all boxes, box after box."""
        ran1 = Ran1(self.legacy_seed)
        xs, ys, ncl, zs = [], [], [], []
        for b in self.releases.boxes:
            bx = dict(lon1=b.lon1, lon2=b.lon2, lat1=b.lat1, lat2=b.lat2,
                      z1=b.z1, z2=b.z2)
            x, y, nc, z = legacy_release(
                bx, b.parts, self.nclassunc, self.grid.xlon0,
                self.grid.ylat0, self.grid.dx, self.grid.dy, ran1=ran1)
            xs.append(x)
            ys.append(y)
            ncl.append(nc)
            zs.append(z)
        k = sum(len(x) for x in xs)
        sched["x_hi"][:k] = np.concatenate(xs).astype(np.float32)
        sched["x_lo"][:k] = 0.0
        sched["y_hi"][:k] = np.concatenate(ys).astype(np.float32)
        sched["y_lo"][:k] = 0.0
        sched["z"][:k] = np.concatenate(zs).astype(np.float32)
        sched["nclass"][:k] = np.concatenate(ncl).astype(np.int32)

    def _legacy_bases(self, itime: int) -> LegacyRnd:
        """The per-particle nrand bases of this step, consumed from the
        shared ran3 chain in the reference's order: per particle in slot
        order, initialize's draw (fresh particles only), then advance's
        (timemanager.f90:553-611).  Reads the active mask from the
        device."""
        stream = self._legacy_stream
        p = self.particles
        active = p.active.cpu().numpy()
        itramem = p.itramem.cpu().numpy()
        n = active.shape[0]
        ni = np.ones(n, np.int64)
        na = np.ones(n, np.int64)
        fresh = (itramem == itime) | (itime == 0)
        for j in np.nonzero(active)[0]:
            if fresh[j]:
                ni[j] = stream.next_nrand()
            na[j] = stream.next_nrand()
        if self.legacy_trace:
            if not hasattr(self, "_legacy_trace"):
                self._legacy_trace = []
            self._legacy_trace.append(dict(
                itime=int(itime), ni=ni.copy(), na=na.copy(),
                x=p.x.double().cpu().numpy(), y=p.y.double().cpu().numpy(),
                z=p.z.cpu().numpy(), mass=p.mass.cpu().numpy(),
                active=active.copy(), idt=p.idt.cpu().numpy()))
        dev = self.device
        return LegacyRnd(table=self._legacy_table,
                         nrand_init=torch.as_tensor(ni, device=dev),
                         nrand=torch.as_tensor(na, device=dev))

    def _summed(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` itself; in a data-parallel run the ranks' partials summed
        in rank order."""
        return t if self._group is None else self._group.sum(t, "reduce")

    def _sample_receptors(self, itime: int, weight: float) -> None:
        """The receptors' sample of this step (K15); a data-parallel rank
        samples its particles into zeros and adds the group's sum, so that
        every rank holds the whole sum."""
        rs, g = self.receptor_set, self.grid
        if self._group is None:
            self.creceptor = sample_receptors(
                self.creceptor, rs, self.particles, itime, weight, g.dx, g.dy)
            return
        part = sample_receptors(torch.zeros_like(self.creceptor), rs,
                                self.particles, itime, weight, g.dx, g.dy)
        self.creceptor = self.creceptor + self._group.sum(part, "receptors")

    def _scatter_depo(self, grid: torch.Tensor, deposit: torch.Tensor,
                      itime: int) -> None:
        """Kernel scatter of per-particle deposits onto a deposition grid,
        in place (wet/drydepokernel.f90), each particle in its age class at
        ``itime``."""
        depo_scatter(grid, deposit, self.particles, itime, self.lage,
                     self.conc_cfg)

    # ----- output (concoutput.f90 analog) -----
    def _outnum(self) -> float:
        """Sample count of the open averaging window: one scalar read from
        the device per output step."""
        return float(self.acc.outnum)

    def _write_output(self, itime: int):
        """The output of the averaging window ending at ``itime``, then its
        accumulators zeroed.  In a data-parallel run every rank takes part
        in the reductions and gathers first; rank 0 writes."""
        whole = (self.acc if self._group is None
                 else parallel.reduce_acc_partials(self._group, self.acc))
        nest = (self._summed(self.acc_n.gridunc)
                if self.use_nested_output else None)
        flux = self._summed(self.flux) if self.use_flux else None
        plume = self._plume_inputs(itime) if self.use_plumetraj else None
        if self._writes:
            self._write_grids(itime, whole, nest, flux, plume)
        # concentrations reset each output window; deposition grids are
        # cumulative over the run (concoutput.f90 never zeroes wetgridunc)
        zeroed = zero_accumulators(
            self.geo, self.nspec, self.conc_cfg.npointspec,
            self.nclassunc, self.ageclasses.nageclass, device=self.device)
        self.acc = zeroed.replace(wetgridunc=self.acc.wetgridunc,
                                  drygridunc=self.acc.drygridunc)
        if self.use_nested_output:
            self.acc_n = zero_accumulators(
                self.geo_n, self.nspec, self.conc_cfg.npointspec,
                self.nclassunc, self.ageclasses.nageclass, device=self.device)
        if self.receptor_set is not None:
            self.creceptor.zero_()
        if self.use_flux:
            self.flux.zero_()
        log.info("output written at %s (outnum=%.1f)",
                 add_seconds(self.cmd.bdate, itime), float(whole.outnum))

    def _plume_inputs(self, itime: int):
        """What plume_step clusters: the particles, their diagnostics and
        the slots in schedule order (gathered in a data-parallel run)."""
        z0, z1, mt0, mt1 = self._fields_for(itime)
        p, diag = self._gathered(self._diagnostics(itime, z0, z1, mt0, mt1))
        origin = self.global_origin()
        order = None if origin is None else torch.argsort(origin)
        return p, diag, order

    def _write_grids(self, itime: int, whole: Accumulators, nest, flux,
                     plume) -> None:
        """Write the window's files from the whole run's sums: the grids,
        the nest's, the receptors', the fluxes' and the plume
        trajectories."""
        acc = interop.accumulators_to_numpy(whole)
        outnum = float(acc["outnum"])
        g = acc["gridunc"]  # (nage,nclass,kp,nz,ny,nx,ks)
        # sum over uncertainty classes = total; std over classes = uncertainty
        total = g.sum(axis=1)
        if g.shape[1] > 1:
            unc = g.std(axis=1, ddof=1) * g.shape[1]
        else:
            unc = np.zeros_like(total)
        vol = self.geo.volume  # (nz,ny,nx)
        if self.cmd.ldirect == 1:
            factor = 1.0e12 / vol / outnum
        else:
            # a backward run's residence time (concoutput.f90 factor3d)
            factor = np.full_like(vol, abs(self.cmd.loutaver) / outnum)
        conc = total * factor[None, None, :, :, :, None]
        unc = unc * factor[None, None, :, :, :, None]
        # reorder to (nspec, npoint, nage, nz, ny, nx)
        conc = np.moveaxis(conc, -1, 0).transpose(0, 2, 1, 3, 4, 5)
        unc = np.moveaxis(unc, -1, 0).transpose(0, 2, 1, 3, 4, 5)

        # cumulative wet/dry deposition in 1e-12 kg/m2
        # (concoutput.f90 wetgrid: factor 1e12/area, no outnum division)
        wet = dry = None
        if self.any_wetdep or self.any_drydep:
            area = self.geo.area
            afac = np.where(area > 0.0, 1.0e12 / np.maximum(area, 1e-30),
                            0.0)                   # (ny, nx)

            def dep2out(g):  # (nage,nclass,kp,ny,nx,ks) -> (ks,kp,nage,...)
                d = np.asarray(g).sum(axis=1)       # over nclass
                d = np.moveaxis(d, -1, 0).transpose(0, 2, 1, 3, 4)
                return d * afac[None, None, None]

            wet = dep2out(acc["wetgridunc"])
            dry = dep2out(acc["drygridunc"])

        when = add_seconds(self.cmd.bdate, itime)
        # air density at output layers for the pptv conversion
        # (concoutput.f90:156-196; newest time level = memind(2))
        rho_out = rho_met = None
        if self.cmd.iout_eff in (2, 3) or self.receptor_set is not None:
            _, z1o, _, _ = self._fields_for(itime)
            rho_met = interop.to_numpy(z1o.f3d[F3_RHO])
            rho_out = density_outgrid(self.geo, interop.to_numpy(z1o.height),
                                      rho_met)
        self.writer.write(when, conc, unc, wet=wet, dry=dry,
                          rho_out=rho_out)
        if self.write_fortran:
            # a part of "output", timed apart as well
            with self.timers.section("output_fortran"):
                if self.cmd.linversionout == 1:
                    self._write_fortran_inversion(when, conc)
                else:
                    self._write_fortran_grids(when, itime, conc, wet, dry,
                                              rho_out=rho_out)
        if nest is not None:
            self._write_nest(when, outnum, nest)
        if self.receptor_set is not None:
            self._write_receptors(when, itime, outnum, rho_met)
        if flux is not None:
            # grid_flux (fluxoutput.f90): per face ng/m2/s in the
            # reference's unformatted layout, and the raw sums as npz;
            # reset for the next interval (fluxoutput.f90:287-300)
            flux = interop.to_numpy(flux)
            np.savez_compressed(
                Path(self.outdir) / f"grid_flux_{datestamp(when)}.npz",
                flux=flux)
            write_flux(Path(self.outdir) / f"grid_flux_{datestamp(when)}",
                       itime, flux, self.geo.areaeast, self.geo.areanorth,
                       self.geo.area, abs(self.cmd.loutstep))
        if plume is not None:
            p, diag, order = plume
            plume_step(p, self.grid, diag, itime, self.numpoint,
                       self._plume_writer, order=order)

    def _write_nest(self, when, outnum: float, gridunc) -> None:
        """The nested output grid's concentrations (concoutput_nest.f90)
        from the whole run's ``gridunc``."""
        gn = interop.to_numpy(gridunc)
        tn = gn.sum(axis=1)
        voln = self.geo_n.volume
        if self.cmd.ldirect == 1:
            fac_n = 1.0e12 / voln / outnum
        else:
            fac_n = np.full_like(voln, abs(self.cmd.loutaver) / outnum)
        concn = tn * fac_n[None, None, :, :, :, None]
        concn = np.moveaxis(concn, -1, 0).transpose(0, 2, 1, 3, 4, 5)
        self.writer_n.write(when, concn, np.zeros_like(concn))

    def _write_receptors(self, when, itime: int, outnum: float,
                         rho_met) -> None:
        """Receptor concentrations in output units, 1e12 x the mean over
        the samples (concoutput.f90:670-676): receptor_conc_<date>.npz and
        the reference's receptor_conc, and receptor_pptv for iout 2 and 3
        (openreceptors.f90, concoutput.f90:662-667)."""
        rc = interop.to_numpy(self.creceptor) * 1.0e12 / outnum
        out = Path(self.outdir)
        np.savez(out / f"receptor_conc_{datestamp(when)}.npz", conc=rc,
                 names=np.asarray(self.receptor_names))
        rs = self.receptor_set
        rx, ry = interop.to_numpy(rs.x), interop.to_numpy(rs.y)
        lons = rx * self.grid.dx + self.grid.xlon0
        lats = ry * self.grid.dy + self.grid.ylat0
        rpath = out / "receptor_conc"
        if not rpath.exists():
            write_receptor_header(rpath, self.receptor_names, lons, lats)
        append_receptor(rpath, itime, rc)
        if self.cmd.iout_eff in (2, 3):
            rhor = density_receptors(rx, ry, rho_met)
            wm = np.asarray([s.weightmolar for s in self.releases.species],
                            np.float32)
            wfac = np.where(wm > 0, 28.97 / np.maximum(wm, 1e-30), 1.0)
            rppt = rc * wfac[None, :] / np.maximum(rhor, 1e-30)[:, None]
            ppath = out / "receptor_pptv"
            if not ppath.exists():
                write_receptor_header(ppath, self.receptor_names, lons, lats)
            append_receptor(ppath, itime, rppt)

    # ----- the reference's unformatted files (io/fortran_writer.py) -----
    def _write_fortran_header(self):
        """Reference-format 'header' file (writeheader.f90): a backward run
        states its end date and its release times counted back, negated and
        swapped."""
        cmd = self.cmd
        rels = []
        for b in self.releases.boxes:
            rt1 = int((b.start - cmd.bdate).total_seconds())
            rt2 = int((b.end - cmd.bdate).total_seconds())
            if cmd.ldirect < 0:
                rt1, rt2 = -rt2, -rt1
            rels.append(dict(
                start=rt1, end=rt2, kindz=b.zkind,
                xp1=b.lon1, yp1=b.lat1, xp2=b.lon2, yp2=b.lat2,
                zp1=b.z1, zp2=b.z2, npart=b.parts, comment=b.comment,
                xmass=list(b.mass) + [0.0] * (self.nspec - len(b.mass))))
        Path(self.outdir).mkdir(parents=True, exist_ok=True)
        write_header(
            Path(self.outdir) / "header",
            ibdate=cmd.ibdate if cmd.ldirect == 1 else cmd.iedate,
            ibtime=cmd.ibtime if cmd.ldirect == 1 else cmd.ietime,
            loutstep=cmd.loutstep, loutaver=cmd.loutaver,
            loutsample=cmd.loutsample,
            outlon0=self.outgrid.outlon0, outlat0=self.outgrid.outlat0,
            numxgrid=self.geo.nxg, numygrid=self.geo.nyg,
            dxout=self.outgrid.dxout, dyout=self.outgrid.dyout,
            outheights=self.outgrid.outheights,
            jjjjmmdd=cmd.bdate.year * 10000 + cmd.bdate.month * 100
            + cmd.bdate.day,
            ihmmss=cmd.bdate.hour * 10000 + cmd.bdate.minute * 100
            + cmd.bdate.second,
            species_names=[s.name for s in self.releases.species],
            maxpointspec_act=self.conc_cfg.npointspec,
            releases=rels, method=cmd.method, lsubgrid=cmd.lsubgrid,
            lconvection=cmd.lconvection, ind_source=cmd.ind_source,
            ind_receptor=cmd.ind_receptor,
            nageclass=self.ageclasses.nageclass,
            lage=self.ageclasses.lage or (999999999,))

    def _write_fortran_grids(self, when, itime, conc, wet, dry,
                             rho_out=None):
        """grid_conc_* / grid_time_* sparse files (concoutput.f90) plus
        the grid_pptv_* mixing-ratio variant for iout=2/3
        (concoutput.f90:460-600 unitoutgridppt)."""
        stem = "grid_conc_" if self.cmd.ldirect == 1 else "grid_time_"
        pfac = self.writer.pptv_factor(rho_out, self.nspec)
        for ks in range(self.nspec):
            w = wet[ks] if wet is not None else None
            d = dry[ks] if dry is not None else None
            if self.cmd.iout_eff in (1, 3, 5):
                path = Path(self.outdir) / (stem + datestamp(when)
                                            + f"_{ks + 1:03d}")
                write_grid_sparse(path, int(itime), conc[ks], w, d)
            if self.cmd.iout_eff in (2, 3):
                path = Path(self.outdir) / ("grid_pptv_" + datestamp(when)
                                            + f"_{ks + 1:03d}")
                pk = conc[ks] * pfac[ks][None, None] \
                    if pfac is not None else conc[ks]
                write_grid_sparse(path, int(itime), pk, w, d)

    def _write_fortran_inversion(self, when, conc):
        """Inversion time series (concoutput_inversion.f90:295-545): one
        file per (release point, species) named by the RELEASE date,
        appended each output step with (jjjjmmdd, ihmmss) records and the
        surface-layer sparse concentration block (surf_only rule)."""
        stem = "grid_conc_" if self.cmd.ldirect == 1 else "grid_time_"
        nx, ny = self.geo.nxg, self.geo.nyg
        jjjjmmdd = when.year * 10000 + when.month * 100 + when.day
        ihmmss = when.hour * 10000 + when.minute * 100 + when.second
        for ks in range(self.nspec):
            for kp in range(self.conc_cfg.npointspec):
                box = self.releases.boxes[min(kp, self.numpoint - 1)]
                path = Path(self.outdir) / (stem + datestamp(box.start)
                                            + f"_{ks + 1:03d}")
                out = (_rec(struct.pack("<i", jjjjmmdd))
                       + _rec(struct.pack("<i", ihmmss)))
                for na in range(self.conc_cfg.nage):
                    out += _sparse_block(conc[ks, kp, na, 0].ravel(),
                                         index_offset=nx * ny)
                with open(path, "ab" if path.exists() else "wb") as f:
                    f.write(out)

"""The simulation run loop — scheduler equivalent of timemanager.f90.

Port of ``flexpart_tpu/run/simulation.py``: the forward (``ldirect=1``),
serial, one-device path with the fixed step (``ctl < 0``) and species that
neither deposit nor decay, with the defaults of ``Command``: convection
(``lconvection=1``), subgrid orography (``lsubgrid=1``) and, on a cyclic
grid beyond 75 degrees, the polar caps.  Every option outside that path
raises ``NotImplementedError`` naming it when the ``Simulation`` is built;
none is skipped silently.

Host-side control loop; all per-particle compute stays on the device.
Per sync interval (timemanager.f90:152-712):

  1. keep two processed wind fields buffered around itime (getfields.f90
     double buffer; here: backend fetch + process_eta/calcpar, the next
     field read and processed by one background thread);
  2. activate scheduled releases (mask flip, core/release.py);
  3. keep the particles in met-cell order (core/reorder.py): a sort every
     ``REORDER_EVERY`` steps and on every step in which a release woke
     particles;
  3b. convective redistribution (physics/convection.py; timemanager.f90:
     258-263): the Emanuel scheme over every grid column (K6 on a CUDA
     device), then the particles' draws against their column's
     displacement matrix (K7);
  4. sample concentrations into the device accumulator (conccalc) on the
     loutsample cadence with the reference's half-weight edge rule
     (timemanager.f90:350-365);
  5. at averaging-interval end: normalize (factor3d, concoutput.f90:210-221),
     copy to host, write, zero the concentration accumulator;
  6. advance all particles one lsynctime (core/advance.py);
  7. terminate particles older than the last age class.

On a CUDA device a step that neither samples nor writes never waits for
the device: the active count is summed on the device and read where a
person reads it (the progress log, the end of the run).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import time as _time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from .. import interop
from ..config import AgeClasses, Command, OutGrid, Releases
from ..core import reorder, rng
from ..core.advance import StepConfig, StepParams, advance_all
from ..core.release import activate, release_schedule_arrays
from ..core.state import ITRA_INACTIVE, Particles
from ..grid.conccalc import ConcConfig, kernel_possible_at, make_conccalc
from ..grid.outgrid import (Accumulators, OutputGridGeometry,
                            density_outgrid, oro_outgrid, zero_accumulators)
from ..io.writer import OutputWriter
from ..met.calcpar import calcpar
from ..met.calcpv import calcpv
from ..met.fields import F3_RHO
from ..met.grid import MetGrid
from ..met.verttransform import compute_heights, process_eta
from ..physics.convection import make_convection_kernel, redist_particles
from ..utils.dates import add_seconds
from ..utils.profile import SectionTimers

log = logging.getLogger("flexpart_tpu_torch")


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
    checkpoint_at: int | None = None
    receptors: tuple = ()
    outgrid_nest: Any = None
    met_nests: tuple = ()
    write_fortran: bool = False
    distributed: str | None = None
    turboff: bool = False
    met_bf16: bool = True            # bfloat16 per-step interpolation
    #                                  tables (StepConfig.met_bf16)
    profile: bool = False            # named-section device timing table
    #                                  (mpif_mtime analog; utils/profile)
    trace_dir: str | None = None
    legacy_rng: bool = False
    device: Any = "cuda"             # where the particles, the met fields
    #                                  and the accumulators live

    def _refuse_unported(self):
        """Raise for every option whose code is not ported yet."""
        cmd = self.cmd
        species = self.releases.species
        span = abs(cmd.ideltas)
        unported = {
            "ldirect=-1 (backward runs)": cmd.ldirect != 1,
            "mdomainfill (domain filling)": cmd.mdomainfill != 0,
            "ipin=1 (warm start)": cmd.ipin == 1,
            "receptors": bool(self.receptors),
            "outgrid_nest (nested output)": self.outgrid_nest is not None,
            "met_nests (nested met)": bool(self.met_nests),
            "iflux (gross fluxes)": cmd.iflux != 0,
            "linit_cond (initial-condition sensitivity)":
                cmd.linit_cond != 0,
            "ipout (particle dumps)": cmd.ipout != 0,
            "iout=4/5 (plume trajectories)": cmd.iout_eff in (4, 5),
            "mquasilag (quasi-Lagrangian dumps)": cmd.mquasilag != 0,
            "itsplit (particle splitting inside the run)":
                cmd.itsplit < span,
            "wet deposition species": any(s.wetdep for s in species),
            "dry deposition species": any(s.drydep for s in species),
            "decay species": any(s.decay > 0 for s in species),
            "OH reaction species": any(s.ohreact for s in species),
            "settling species": any(
                s.density > 0.0 and s.dquer > 0.0 for s in species),
            "cblflag (skewed CBL turbulence)": cmd.cblflag == 1,
            "ctl > 0 (adaptive time step)": cmd.ctl_eff > 0.0,
            "turboff": self.turboff,
            "legacy_rng": self.legacy_rng,
            "distributed": self.distributed is not None,
            "write_fortran": self.write_fortran,
            "checkpoint_at": self.checkpoint_at is not None,
            "trace_dir": self.trace_dir is not None,
            "use_clwc": self.use_clwc,
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise NotImplementedError(
                "not ported yet (outside the forward fixed-step run): "
                + "; ".join(bad))

    def __post_init__(self):
        cmd = self.cmd
        self._refuse_unported()
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Simulation(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")
        dev = self.device
        self.nspec = self.releases.nspec
        self.numpoint = self.releases.numpoint
        self.geo = OutputGridGeometry(self.outgrid, self.grid)
        nage = self.ageclasses.nageclass

        top_lat = self.grid.ylat0 + (self.grid.ny - 1) * self.grid.dy
        self.step_cfg = StepConfig(
            nx=self.grid.nx, ny=self.grid.ny, nz=self.grid.nlev,
            xglobal=self.grid.xglobal, ldirect=cmd.ldirect,
            turbswitch=cmd.turbswitch, ifine=cmd.ifine_eff,
            method=cmd.method, met_bf16=self.met_bf16,
            polar=bool(self.grid.xglobal
                       and (top_lat > 75.0 or self.grid.ylat0 < -75.0)))
        self.step_cfg.check()
        self.step_prm = StepParams.make(
            dx=self.grid.dx, dy=self.grid.dy, ylat0=self.grid.ylat0,
            dxconst=self.grid.dxconst, dyconst=self.grid.dyconst,
            lsynctime=cmd.lsynctime, fine=cmd.fine,
            lwindinterv=self.wind_interval, xlon0=self.grid.xlon0)
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
            ioutputforeachrelease=bool(cmd.ioutputforeachrelease))
        self.conccalc = make_conccalc(self.outgrid.outheights)
        self.lage = torch.as_tensor(
            np.asarray(self.ageclasses.lage or (999999999,), np.int32),
            device=dev)

        # the whole release schedule, built on the host and moved once;
        # its release times say on which steps `activate` wakes particles
        sched = release_schedule_arrays(
            self.releases, cmd, self.grid, capacity=self.capacity,
            nclassunc=self.nclassunc, seed=self.seed)
        self._release_times = frozenset(
            int(t) for t in np.unique(sched["itra"]) if t != ITRA_INACTIVE)
        self.particles: Particles = interop.particles_from_numpy(sched, dev)
        # earliest scheduled release (s since bdate): the sampling kernel
        # (conccalc.f90:171 itage>10800) cannot trigger before
        # first_release + 3 h, so the sampler runs its single-index path
        # until then (grid/conccalc.py kernel_possible_at)
        self._first_release: int | None = None
        if self.releases.boxes:
            self._first_release = min(
                int((b.start - cmd.bdate).total_seconds())
                for b in self.releases.boxes)
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

        self._height = None
        self._buf: dict[int, Any] = {}   # met_time -> (ZFields, EtaFields)
        self._prefetch: dict[int, Any] = {}  # met_time -> Future
        self._reader = None              # lazy background reader thread
        self._met_stream = None          # the reader's CUDA stream
        self._prefetch_failures = 0      # dead-reader visibility counter
        self.timings: dict[str, float] = {}
        self.timers = SectionTimers(device_sync=self.profile, device=dev)
        self.nan_count = 0               # CBL redraws; the CBL is not ported
        self.n_sorts = 0
        # tests only: `_draws_hook(istep, origin)` returns the advance's
        # injected draws for this step, already in slot order, and
        # `_redist_hook(istep, origin)` the convective redistribution's
        # uniforms; `origin[k]` is the schedule slot of the particle now in
        # slot k (kept only while a hook is set)
        self._draws_hook: Callable | None = None
        self._redist_hook: Callable | None = None
        self._origin: torch.Tensor | None = None
        # measurements only: called with (istep, itime) at the top of each
        # step, after the release and before the sort, to look at the
        # ensemble and the fields the step meets.  A probe may wait for the
        # card; a run that is timed as one that never does sets none.
        self._step_probe: Callable | None = None

    def _nc_meta(self) -> dict:
        """Reference-layout netCDF-4 metadata (netcdf_output_mod.f90:
        writemetadata + the RELCOM/RELLNG/RELZZ/RELPART release block +
        per-species physics attributes + output_units table)."""
        cmd = self.cmd
        rel = self.releases
        # output units (Stohl et al. 2005 table 1; output_units())
        units = "ng m-3" if cmd.ind_receptor == 1 else "ng kg-1"
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
            "prefix": "grid_conc_",
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
        getfields; the fields land on the device)."""
        return self.met_backend.fetch(float(tsec), self.device)

    def _prefetch_job(self, tsec: int, submitted=None):
        """Worker-thread body: the read and, once the height grid exists,
        the full processing pipeline, so the next field is buffer-ready
        when the step loop asks for it.  Returns ("processed", entry) or
        ("raw", eta).

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
            eta = self._fetch_raw(tsec)
            self.timers.add("getfields_fetch_bg", _time.perf_counter() - tf0)
            if self._height is None:
                out = "raw", eta
            else:
                tp0 = _time.perf_counter()
                out = "processed", self._process_field(tsec, eta)
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
        for obj in entry:
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if isinstance(v, torch.Tensor):
                    v.record_stream(here)
        return entry

    def _get_field(self, tsec: int):
        if tsec not in self._buf:
            t0 = _time.perf_counter()
            fut = self._prefetch.pop(tsec, None)
            processed = None
            eta = None
            if fut is not None:
                try:
                    tag, payload = fut.result()
                    if tag == "processed":
                        processed = self._adopt(payload)
                        eta = payload[1]
                    else:
                        eta = self._adopt((payload,))[0]
                except Exception:
                    self._prefetch_failures += 1
                    log.warning("met prefetch for t=%ss died in the "
                                "reader thread (failure #%d); reading "
                                "synchronously", tsec,
                                self._prefetch_failures, exc_info=True)
                    eta = self._fetch_raw(tsec)
            else:
                eta = self._fetch_raw(tsec)
            if self._height is None:
                self._height = compute_heights(self.grid, eta)
                # output-grid orography for the netCDF header (ORO var,
                # netcdf_output_mod.f90:528-535 <- outgrid_init.f90:107-181)
                if self.writer.nc_meta is not None:
                    self.writer.nc_meta["oro"] = oro_outgrid(
                        self.geo, eta.oro.cpu().numpy())
            # keep at most 3 buffered fields, evicting the one farthest
            # from the requested time (the memind rotation of
            # getfields.f90:93-113)
            while len(self._buf) >= 3:
                farthest = max(self._buf, key=lambda k: abs(k - tsec))
                del self._buf[farthest]
            self._buf[tsec] = (processed if processed is not None
                               else self._process_field(tsec, eta))
            dt_gf = _time.perf_counter() - t0
            self.timers.add("getfields", dt_gf)
            log.debug("getfields t=%ss: %.2fs blocked (%s)", tsec, dt_gf,
                      "prefetched" if processed is not None else "sync")
        return self._buf[tsec][0]

    def _process_field(self, tsec: int, eta):
        """Device-side processing of one fetched met time: calcpv +
        verttransform + calcpar.  Returns the (z, eta) buffer entry (the
        convection reads the raw eta-level profiles, convmix.f90:168-189).
        Safe to call from the prefetch worker thread once the height grid
        exists."""
        z = process_eta(self.grid, eta, self._height,
                        pvh=calcpv(self.grid, eta), use_clwc=self.use_clwc)
        z = calcpar(self.grid, eta, z, lsubgrid=bool(self.cmd.lsubgrid))
        return (z, eta)

    def _get_eta(self, tsec: int):
        self._get_field(tsec)
        return self._buf[tsec][1]

    def _ccfg_at(self, itime, base):
        """Sampling config for this step: the single-index direct-only
        scatter while no particle can be >= 3 h old (conccalc.f90:171)."""
        kp = kernel_possible_at(itime, self._first_release, base.use_kernel)
        if kp == base.kernel_possible:
            return base
        return base.replace(kernel_possible=kp)

    def _fields_for(self, itime: int):
        wi = self.wind_interval
        t0 = (itime // wi) * wi
        t1 = t0 + wi
        f0, f1 = self._get_field(t0), self._get_field(t1)
        # read the next field in the background while particles advance
        tn = t1 + wi
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

    # ----- main loop -----
    def run(self, progress: bool = False):
        try:
            return self._run(progress)
        finally:
            self.close()

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
        if self._draws_hook is not None or self._redist_hook is not None:
            idx = perm.long()
            self._origin = idx if self._origin is None else self._origin[idx]

    def _slot_origin(self) -> torch.Tensor:
        """The schedule slot of the particle in each slot (tests' hooks)."""
        if self._origin is None:
            self._origin = torch.arange(self.particles.capacity,
                                        device=self.device)
        return self._origin

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
            nl=self.conv_kernel.nl, nx=self.grid.nx, ny=self.grid.ny, rn=rn)
        self.convection_counts.append(torch.stack(
            [conv.lconv.sum(dtype=torch.int32), moved]))

    def _run(self, progress: bool = False):
        cmd = self.cmd
        lsync = cmd.lsynctime
        ideltas = cmd.ideltas
        loutnext = cmd.loutstep
        loutaver = cmd.loutaver
        loutstart = loutnext - loutaver // 2
        loutend = loutnext + loutaver // 2
        loutsample = cmd.loutsample

        nsteps = abs(ideltas) // abs(lsync)
        t_wall0 = _time.perf_counter()
        # summed on the device; read for the progress log and at the end
        particle_steps = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        n_act = None
        max_age = self.ageclasses.max_age
        itime = 0

        for istep in range(0, nsteps + 1):
            itime = istep * lsync
            z0, z1, mt0, mt1 = self._fields_for(itime)

            # releases
            self.particles = activate(self.particles, itime)

            # cell order: every REORDER_EVERY steps, and when a release
            # has just woken particles (they sit in the last slots, out of
            # cell order).  The release times are known on the host, so
            # nothing is read back from the device to decide.
            if self._step_probe is not None:
                self._step_probe(istep, itime)
            if istep % reorder.REORDER_EVERY == 0 \
                    or itime in self._release_times:
                self._sort(z0.height)

            # convective redistribution (timemanager.f90:258-263)
            if self.conv_kernel is not None:
                with self.timers.section("convection"):
                    self._convect(istep, itime, mt0, mt1)

            # sampling (timemanager.f90:350-365)
            if (loutstart <= itime <= loutend
                    and (itime - loutstart) % loutsample == 0):
                weight = 0.5 if itime in (loutstart, loutend) else 1.0
                with self.timers.section("conccalc"):
                    self.acc = self.conccalc(
                        self.acc, self.particles, z1, itime, self.lage,
                        weight, self._ccfg_at(itime, self.conc_cfg))

            # output (timemanager.f90:376-464)
            if itime == loutend and self._outnum() > 0:
                with self.timers.section("output"):
                    self._write_output(itime)
                loutnext = loutnext + cmd.loutstep
                loutstart = loutnext - loutaver // 2
                loutend = loutnext + loutaver // 2
                if itime == loutstart:
                    self.acc = self.conccalc(
                        self.acc, self.particles, z1, itime, self.lage,
                        0.5, self._ccfg_at(itime, self.conc_cfg))

            if itime == ideltas:
                break

            # advance
            t0 = _time.perf_counter()
            draws = None
            if self._draws_hook is not None:
                draws = self._draws_hook(istep, self._slot_origin())
            with self.timers.section("advance"):
                self.particles, diag = advance_all(
                    self.particles, z0, z1, itime, mt0, mt1,
                    rng.Key(self.seed, istep), self.step_cfg,
                    self.step_prm, draws=draws)
            n_act = diag.n_active
            particle_steps += n_act
            if "advance_first_s" not in self.timings:
                # on a CUDA device the first advance builds the kernels it
                # launches (nvcc, unless build/kernels/ has them)
                self.timings["advance_first_s"] = round(
                    _time.perf_counter() - t0, 2)

            # age-class termination (timemanager.f90:701-707)
            if max_age is not None:
                age = torch.abs((itime + lsync) - self.particles.itramem)
                self.particles = self.particles.replace(
                    active=self.particles.active & (age <= max_age))

            if progress and istep % 10 == 0:
                log.info("t=%8d s  particles=%8d", itime, int(n_act))

        self.last_itime = itime
        self.timings.update(self.timers.seconds)
        self.timings["particle_steps"] = int(particle_steps)
        if self.convection_counts:
            self.timings["convection_moved"] = int(
                torch.stack(self.convection_counts)[:, 1].sum())
        self.timings["wall"] = _time.perf_counter() - t_wall0
        if self.profile:
            report = self.timers.report(extra={
                "psteps/s": f"{self.timings['particle_steps'] / max(self.timings['wall'], 1e-9):.0f}",
                "sorts": self.n_sorts,
                "prefetch_failures": self._prefetch_failures,
                "advance_first_s": self.timings.get("advance_first_s", 0.0)})
            log.info("per-section timings (device-synced):\n%s", report)
            (Path(self.outdir) / "profile.txt").write_text(report + "\n")
        return self.particles

    # ----- output (concoutput.f90 analog) -----
    def _outnum(self) -> float:
        """Sample count of the open averaging window: one scalar read from
        the device per output step."""
        return float(self.acc.outnum)

    def _write_output(self, itime: int):
        acc = interop.accumulators_to_numpy(self.acc)
        outnum = float(acc["outnum"])
        g = acc["gridunc"]  # (nage,nclass,kp,nz,ny,nx,ks)
        # sum over uncertainty classes = total; std over classes = uncertainty
        total = g.sum(axis=1)
        if g.shape[1] > 1:
            unc = g.std(axis=1, ddof=1) * g.shape[1]
        else:
            unc = np.zeros_like(total)
        vol = self.geo.volume  # (nz,ny,nx)
        factor = 1.0e12 / vol / outnum
        conc = total * factor[None, None, :, :, :, None]
        unc = unc * factor[None, None, :, :, :, None]
        # reorder to (nspec, npoint, nage, nz, ny, nx)
        conc = np.moveaxis(conc, -1, 0).transpose(0, 2, 1, 3, 4, 5)
        unc = np.moveaxis(unc, -1, 0).transpose(0, 2, 1, 3, 4, 5)

        when = add_seconds(self.cmd.bdate, itime)
        # air density at output layers for the pptv conversion
        # (concoutput.f90:156-196; newest time level = memind(2))
        rho_out = None
        if self.cmd.iout_eff in (2, 3):
            _, z1o, _, _ = self._fields_for(itime)
            rho_out = density_outgrid(self.geo, interop.to_numpy(z1o.height),
                                      interop.to_numpy(z1o.f3d[F3_RHO]))
        self.writer.write(when, conc, unc, wet=None, dry=None,
                          rho_out=rho_out)
        # concentrations reset each output window; deposition grids are
        # cumulative over the run (concoutput.f90 never zeroes wetgridunc)
        zeroed = zero_accumulators(
            self.geo, self.nspec, self.conc_cfg.npointspec,
            self.nclassunc, self.ageclasses.nageclass, device=self.device)
        self.acc = zeroed.replace(wetgridunc=self.acc.wetgridunc,
                                  drygridunc=self.acc.drygridunc)
        log.info("output written at %s (outnum=%.1f)", when, outnum)


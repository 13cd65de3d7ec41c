"""The runs of tests/test_torch_tiles_run.py, as functions that a rank of
``flexpart_tpu_torch.parallel.launch`` calls (a module of their own: a
spawned rank imports it, and neither jax nor the JAX package)."""
from __future__ import annotations

from flexpart_tpu_torch import interop

# a global 36 x 18 grid of 20 x 10 degree cells: choose_tile_mesh splits it
# 2 x 2 over 4 ranks and 1 x 2 over 2
GRID = dict(nx=19, ny=18, nlev=15, dx=20.0, dy=10.0)


def tiles_config(c, parts: int = 96, spread: bool = True):
    """tests/test_tiles_mode.py's ``_sim`` in the names of config module
    ``c`` (either package's): an aerosol that rains out, decays and
    deposits dry, a wide release over several tiles and a hot spot, 3 h of
    900 s steps, hourly output, no convection."""
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=30000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0)
    sp = c.Species(density=1900.0, dquer=0.5, dsigma=1.5, crain_aero=1.0,
                   csnow_aero=1.0, ccn_aero=0.9, in_aero=0.1,
                   decay_halflife=50000.0, dryvel=0.01)
    boxes = [c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                          itime2=10000, lon1=-150.0, lon2=120.0,
                          lat1=-60.0, lat2=60.0, z1=2.0, z2=3000.0,
                          mass=(1.0,), parts=parts)]
    if spread:
        boxes.append(c.ReleaseBox(idate1=20200101, itime1=0,
                                  idate2=20200101, itime2=0, lon1=0.0,
                                  lon2=2.0, lat1=40.0, lat2=42.0, z1=2.0,
                                  z2=500.0, mass=(0.5,), parts=parts // 2))
    og = c.OutGrid(outlon0=-60.0, outlat0=-40.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0,
                   outheights=(500.0, 2000.0, 50000.0))
    return cmd, c.Releases(species=(sp,), boxes=tuple(boxes)), og


def port_tiles(outdir, distributed=None, turboff: bool = True, **kw):
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch import config as tconfig
    grid = make_grid(**GRID)
    cmd, rel, og = tiles_config(tconfig)
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), seed=77, turboff=turboff,
                      distributed=distributed, write_netcdf=False,
                      met_bf16=False, device="cpu", **kw)


def ended(sim) -> dict:
    """What a run leaves: the particles in schedule-origin order (a tiles
    run's placed ones; a serial run's every slot) as numpy, their origins,
    the tile layout and the migrations."""
    p, _ = sim._gathered()
    origin = sim.global_origin()
    eng = sim._tiles
    return dict(
        particles=interop.particles_to_numpy(p),
        origin=None if origin is None else origin.cpu().numpy(),
        particle_steps=sim.timings["particle_steps"],
        mesh=None if eng is None else (eng.nty, eng.ntx),
        halo=None if eng is None else eng.halo,
        local_cap=None if eng is None else eng.local_cap,
        migrations=None if eng is None else dict(eng.stats),
        stats=None if sim._group is None else sim._group.stats)


def rank_tiles(outdir, turboff: bool = True) -> dict:
    sim = port_tiles(outdir, "tiles", turboff)
    sim.run()
    return ended(sim)


def rank_strong_wind(outdir) -> dict:
    """A rank's run whose wind fields after the first blow at 20 times
    its wind (a halo sized from the first cannot hold them)."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch import config as tconfig
    grid = make_grid(**GRID)
    cmd, rel, og = tiles_config(tconfig, parts=16, spread=False)

    class Gust(SyntheticMet):
        def fetch(self, tsec, device="cpu"):
            eta = super().fetch(tsec, device)
            if tsec > 0:
                eta.uuh = eta.uuh * 20.0
            return eta

    sim = Simulation(cmd=cmd, releases=rel, grid=grid,
                     met_backend=Gust(grid), outgrid=og, outdir=str(outdir),
                     distributed="tiles", write_netcdf=False, device="cpu")
    sim.run()
    return {}


# ---- the options of tiles part 2 (tests/test_tiles_mode.py::_sim_full) --

# the feature runs' grid: a global 36 x 18 grid of 10 x 10 degree cells
# (the reference's _sim_full): choose_tile_mesh splits it 2 x 2 over 4 ranks
# and 1 x 2 over 2
FULL_GRID = dict(nx=37, ny=18, nlev=15, dx=10.0, dy=10.0)


def full_config(c, parts: int = 96, hours: int = 3, ohreact: bool = False,
                **cmd_kw):
    """tests/test_tiles_mode.py's ``_sim_full`` in the names of config
    module ``c`` (either package's): one wide release of the default
    tracer (or the REACT species of an OH run) over every tile, ``hours``
    of 900 s steps, hourly output, ``cmd_kw`` on the Command."""
    kw = dict(ibdate=20200101, ibtime=0, iedate=20200101,
              ietime=hours * 10000, lsynctime=900, loutstep=3600,
              loutaver=3600, loutsample=900, lconvection=0)
    kw.update(cmd_kw)
    cmd = c.Command(**kw)
    sp = (c.Species(name="REACT", ohcconst=1.0e-11, ohdconst=500.0,
                    ohnconst=0.0) if ohreact else c.Species())
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                       lon1=-150.0, lon2=120.0, lat1=-60.0, lat2=60.0,
                       z1=2.0, z2=3000.0, mass=(1.0,), parts=parts)
    og = c.OutGrid(outlon0=-60.0, outlat0=-40.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    return cmd, c.Releases(species=(sp,), boxes=(box,)), og


def port_full(outdir, distributed=None, parts: int = 96, hours: int = 3,
              ohreact: bool = False, turboff: bool = True, cmd_kw=None,
              **kw):
    """The port's ``_sim_full`` Simulation on the CPU (capacity 4 x parts
    unless ``kw`` says otherwise)."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch import config as tconfig
    grid = make_grid(**FULL_GRID)
    cmd, rel, og = full_config(tconfig, parts, hours, ohreact,
                               **(cmd_kw or {}))
    kw.setdefault("capacity", parts * 4)
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), seed=77, turboff=turboff,
                      distributed=distributed, write_netcdf=False,
                      met_bf16=False, device="cpu", **kw)


def summary(sim) -> dict:
    """``ended`` and what the options leave: the receptors' sums, the
    group's split and boundary counts, the regional boundary's site
    accumulators (summed over the group), the next fresh origin."""
    import numpy as np
    out = ended(sim)
    out["creceptor"] = (None if sim.receptor_set is None
                        else sim.creceptor.cpu().numpy())
    out["split_counts"] = [c.cpu().numpy() for c in sim.split_counts]
    out["boundary_counts"] = [c.cpu().numpy() for c in sim.boundary_counts]
    out["boundary_acc"] = (None if sim._boundary is None
                           else sim._summed(sim._boundary.acc).cpu().numpy())
    out["next_origin"] = sim._next_origin
    out["init_cond"] = (sim._summed(sim.init_cond).cpu().numpy()
                        if sim.use_initcond else None)
    p = out["particles"]
    out["mass"] = float(p["mass"][p["active"]].astype(np.float64).sum())
    out["nan_count"] = sim.nan_count
    out["convection_moved"] = sim.timings.get("convection_moved")
    out["ensemble"] = _live_rows(out["particles"], np)
    return out


def _live_rows(p, np):
    """The live particles' (x, y, z, mass), sorted by x, then y, z, mass."""
    act = p["active"]
    cols = np.stack([(p["x_hi"] + p["x_lo"])[act],
                     (p["y_hi"] + p["y_lo"])[act], p["z"][act],
                     p["mass"][act, 0]])
    return cols[:, np.lexsort(cols[::-1])]


def rank_full(outdir, turboff: bool = True, **kw) -> dict:
    """A rank's ``_sim_full`` run with the options ``kw``."""
    sim = port_full(outdir, "tiles", turboff=turboff, **kw)
    sim.run()
    return summary(sim)


def rank_rebalance(outdir, checkpoint=None, resume_from=None) -> dict:
    """tests/test_tiles_mode.py::test_tiled_dynamic_rebalance on a 1 x 2
    mesh: a uniform eastward wind of 100 m/s carries a release just west
    of the tiles' border at 0 E into the tile whose own release starts at
    its capacity of 26 slots; the migration defers, and the group regroups
    at twice the capacity.  With ``checkpoint`` (an itime) it writes
    ``checkpoint.npz`` into ``outdir`` there, with ``resume_from`` it
    resumes from that file."""
    from flexpart_tpu_torch import Simulation, make_grid
    from flexpart_tpu_torch.met import uniform_wind_met
    from flexpart_tpu_torch import config as c
    grid, cmd, rel, og = rebalance_config(c, make_grid)
    sim = Simulation(cmd=cmd, releases=rel, grid=grid,
                     met_backend=uniform_wind_met(grid, u=100.0),
                     outgrid=og, outdir=str(outdir), seed=5, turboff=True,
                     distributed="tiles", write_netcdf=False,
                     met_bf16=False, tile_local_cap=26, device="cpu")
    start = 0
    if checkpoint is not None:
        sim.checkpoint_at = checkpoint
        sim.checkpoint_path = str(outdir) + "/checkpoint.npz"
    if resume_from is not None:
        start = sim.load_checkpoint(resume_from)
    sim.run(start_itime=start)
    out = summary(sim)
    out["local_cap"] = sim._tiles.local_cap
    return out


def initcond_config(c, make_grid, parts: int = 96):
    """A backward run with ``linit_cond = 1`` on a regional grid (90 W -
    90 E, 45 S - 40 N in 5 degree cells; over 2 ranks a 1 x 2 mesh split at
    5 E) under a uniform 60 m/s westerly, 3 h, released over the first
    backward hour in a box from the western edge across the tiles' border,
    with age classes of 1 h and 2.5 h: the particles near the western edge
    leave the domain in the advance (the scan before the migration), those
    east of the border cross it (the migration), the first released end at
    the age limit (the scan after it) and the others survive to the end.
    Returns (grid, Command, Releases, OutGrid, AgeClasses) in the names of
    config module ``c``."""
    grid = make_grid(nx=37, ny=18, nlev=15, dx=5.0, dy=5.0, xlon0=-90.0,
                     ylat0=-45.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=30000, ldirect=-1, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    linit_cond=1)
    box = c.ReleaseBox(idate1=20200101, itime1=20000, idate2=20200101,
                       itime2=30000, lon1=-88.0, lon2=12.0, lat1=-20.0,
                       lat2=20.0, z1=500.0, z2=1500.0, mass=(1.0,),
                       parts=parts)
    og = c.OutGrid(outlon0=-90.0, outlat0=-40.0, numxgrid=45, numygrid=20,
                   dxout=4.0, dyout=4.0, outheights=(500.0, 2000.0, 50000.0))
    return (grid, cmd, c.Releases(species=(c.Species(),), boxes=(box,)), og,
            c.AgeClasses(lage=(3600, 9000)))


def port_initcond(outdir, distributed=None):
    """The port's ``initcond_config`` run on the CPU, turboff."""
    from flexpart_tpu_torch import Simulation, make_grid
    from flexpart_tpu_torch.met import uniform_wind_met
    from flexpart_tpu_torch import config as c
    grid, cmd, rel, og, ages = initcond_config(c, make_grid)
    return Simulation(cmd=cmd, releases=rel, grid=grid, outgrid=og,
                      ageclasses=ages,
                      met_backend=uniform_wind_met(grid, u=60.0),
                      outdir=str(outdir), seed=77, turboff=True,
                      distributed=distributed, write_netcdf=False,
                      met_bf16=False, device="cpu")


def rank_initcond(outdir) -> dict:
    """A rank's ``port_initcond`` run."""
    sim = port_initcond(outdir, "tiles")
    sim.run()
    return summary(sim)


def rebalance_config(c, make_grid):
    """The reference's rebalance run (tests/test_tiles_mode.py:151-205)
    with its boxes moved to the border of a 1 x 2 mesh at 0 E."""
    grid = make_grid(nx=37, ny=18, nlev=15, dx=10.0, dy=10.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=30000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0)
    box_in = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                          itime2=0, lon1=-3.0, lon2=-1.0, lat1=30.0,
                          lat2=50.0, z1=500.0, z2=1000.0, mass=(1.0,),
                          parts=24)
    box_hot = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                           itime2=0, lon1=2.0, lon2=10.0, lat1=30.0,
                           lat2=50.0, z1=500.0, z2=1000.0, mass=(1.0,),
                           parts=24)
    og = c.OutGrid(outlon0=-30.0, outlat0=0.0, numxgrid=30, numygrid=30,
                   dxout=2.0, dyout=2.0, outheights=(2000.0, 50000.0))
    return grid, cmd, c.Releases(species=(c.Species(),),
                                 boxes=(box_in, box_hot)), og


def group_of_one(base):
    """This process as a gloo group of one rank (a FileStore under
    ``base``), ended on leaving: a context manager."""
    import contextlib
    from pathlib import Path
    import torch.distributed as dist

    @contextlib.contextmanager
    def group():
        Path(base).mkdir(parents=True, exist_ok=True)
        dist.init_process_group("gloo", store=dist.FileStore(
            str(Path(base) / "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
    return group()


def port_domainfill(outdir, distributed=None, hours: int = 2,
                    parts: int = 1000, capacity: int = 2048, **kw):
    """tests/test_torch_domainfill.py's regional fill (MDOMAINFILL=1, the
    window 60 W - 60 E, 30 S - 30 N of a 73 x 37 grid of 5 degree cells,
    a uniform 20 m/s westerly, so that air flows in through the western
    face and out through the eastern) with ``parts`` particles in
    ``capacity`` slots; over 4 ranks (a 1 x 4 mesh of 90 degree tiles) the
    window spans two tiles, and each owns boundary sites."""
    from flexpart_tpu_torch import Simulation, make_grid
    from flexpart_tpu_torch.met import uniform_wind_met
    from flexpart_tpu_torch import config as c
    grid = make_grid(nx=73, ny=37, nlev=12, dx=5.0, dy=5.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=hours * 10000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    mdomainfill=1, **kw.pop("cmd_kw", {}))
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                       lon1=-60.0, lon2=60.0, lat1=-30.0, lat2=30.0, z1=0.0,
                       z2=50000.0, mass=(1.0,), parts=parts)
    og = c.OutGrid(outlon0=-60.0, outlat0=-30.0, numxgrid=24, numygrid=12,
                   dxout=5.0, dyout=5.0, outheights=(2000.0, 50000.0))
    return Simulation(cmd=cmd, releases=c.Releases(species=(c.Species(),),
                                                   boxes=(box,)),
                      grid=grid, outgrid=og, outdir=str(outdir),
                      met_backend=uniform_wind_met(grid, u=20.0, v=0.0),
                      write_netcdf=False, seed=13, capacity=capacity,
                      turboff=kw.pop("turboff", True),
                      distributed=distributed, met_bf16=False, device="cpu",
                      **kw)


def rank_domainfill(outdir, checkpoint=None, resume_from=None,
                    hours=None, tile_local_cap=None, **kw) -> dict:
    """A rank's regional fill (``port_domainfill``); with ``checkpoint``
    (an itime) it writes ``checkpoint.npz`` into ``outdir`` there, with
    ``resume_from`` it resumes from that file."""
    if hours is not None:
        kw["hours"] = hours
    sim = port_domainfill(outdir, "tiles", tile_local_cap=tile_local_cap,
                          **kw)
    start = 0
    if checkpoint is not None:
        sim.checkpoint_at = checkpoint
        sim.checkpoint_path = str(outdir) + "/checkpoint.npz"
    if resume_from is not None:
        start = sim.load_checkpoint(resume_from)
    sim.run(start_itime=start)
    out = summary(sim)
    out["local_cap"] = sim._tiles.local_cap
    return out

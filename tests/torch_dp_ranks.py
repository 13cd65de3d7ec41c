"""The runs of tests/test_torch_dp_run.py and test_torch_parallel.py, as
functions that a rank of ``flexpart_tpu_torch.parallel.launch`` calls (a
module of their own: a spawned rank imports it, and neither jax nor the
JAX package)."""
from __future__ import annotations

import numpy as np

from flexpart_tpu_torch import interop

MINI_CAPACITY = 192       # a multiple of 2, 3 and 8 (the JAX mesh), and
#                           each rank's rows of 2 and 3 a multiple of 16
MINI_PARTS = 128          # released by 900 s: 128 due > 64 free at 3600 s
DF_GRID = dict(nx=73, ny=37, nlev=12, dx=5.0, dy=5.0)
DF_CAPACITY = 4096
DF_SEED = 13


def mini_config(c, parts: int = MINI_PARTS, itsplit: int = 1800):
    """tests/test_parallel.py's _mini_sim in the names of config module
    ``c`` (either package's): an aerosol that rains out, settles and
    deposits dry, 3 h of 900 s steps, hourly output, and a split at every
    output from 1800 s on (every particle due at 3600 s)."""
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=30000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    itsplit=itsplit)
    sp = c.Species(density=1900.0, dquer=0.5, dsigma=1.5, crain_aero=1.0,
                   csnow_aero=1.0, ccn_aero=0.9, in_aero=0.1)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=1500, lon1=0.0, lon2=2.0, lat1=40.0,
                       lat2=42.0, z1=50.0, z2=500.0, mass=(1.0,),
                       parts=parts)
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0,
                   outheights=(500.0, 2000.0, 50000.0))
    return cmd, c.Releases(species=(sp,), boxes=(box,)), og


def port_mini(outdir, distributed=None, turboff: bool = True,
              device: str = "cpu", **kw):
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch import config as tconfig
    grid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd, rel, og = mini_config(tconfig)
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), seed=77, distributed=distributed,
                      write_netcdf=False, turboff=turboff,
                      capacity=MINI_CAPACITY, device=device, **kw)


def df_config(c, hours: int = 3, **kw):
    """tests/test_torch_domainfill.py's regional fill: 2000 air-mass
    particles in a window of 120 x 60 degrees on a 20 m/s westerly, its
    boundary emitting and destroying particles."""
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=hours * 10000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    mdomainfill=1, **kw)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=0, z1=0.0, z2=50000.0, mass=(1.0,),
                       parts=2000, lon1=-60.0, lon2=60.0, lat1=-30.0,
                       lat2=30.0)
    og = c.OutGrid(outlon0=-60.0, outlat0=-30.0, numxgrid=24, numygrid=12,
                   dxout=5.0, dyout=5.0, outheights=(2000.0, 50000.0))
    return cmd, c.Releases(species=(c.Species(),), boxes=(box,)), og


def port_df(outdir, distributed=None, **kw):
    """The regional fill with turbulence off, receptors, fluxes and a
    nested output grid."""
    from flexpart_tpu_torch import Simulation, make_grid
    from flexpart_tpu_torch import config as tconfig
    from flexpart_tpu_torch.met.synthetic import uniform_wind_met
    grid = make_grid(**DF_GRID)
    cmd, rel, og = df_config(tconfig, iflux=1)
    return Simulation(
        cmd=cmd, releases=rel, grid=grid, outgrid=og, outdir=str(outdir),
        met_backend=uniform_wind_met(grid, u=20.0, v=0.0),
        write_netcdf=False, seed=DF_SEED, capacity=DF_CAPACITY,
        device="cpu", distributed=distributed, turboff=True,
        receptors=(tconfig.Receptor("IN", 0.0, 0.0),),
        outgrid_nest=tconfig.OutGrid(
            outlon0=-20.0, outlat0=-10.0, numxgrid=16, numygrid=8,
            dxout=2.5, dyout=2.5, outheights=(2000.0, 50000.0)), **kw)


def ended(sim) -> dict:
    """What a run leaves, in the whole run's global slot order (every
    rank's rows): the particles as numpy, their schedule origins (None:
    the identity), the split and boundary counts per event, the timings
    and, in a data-parallel run, the collectives."""
    p, _ = sim._gathered()
    origin = sim.global_origin()
    return dict(
        particles=interop.particles_to_numpy(p),
        origin=None if origin is None else origin.cpu().numpy(),
        split_counts=[c.tolist() for c in sim.split_counts],
        boundary_counts=[c.tolist() for c in sim.boundary_counts],
        particle_steps=sim.timings["particle_steps"],
        world=1 if sim._group is None else sim._group.world,
        stats=None if sim._group is None else sim._group.stats)


def rank_mini(outdir, turboff: bool = True, device: str = "cpu") -> dict:
    sim = port_mini(outdir, "dp", turboff, device)
    sim.run()
    return ended(sim)


def rank_df(outdir, start_from=None, checkpoint_path=None,
            checkpoint_at=None) -> dict:
    """The regional fill in a rank: straight (with a checkpoint on the way
    where ``checkpoint_path`` is given), or resumed from ``start_from``."""
    kw = {} if checkpoint_path is None else dict(
        checkpoint_at=checkpoint_at, checkpoint_path=checkpoint_path)
    sim = port_df(outdir, "dp", **kw)
    t0 = 0 if start_from is None else sim.load_checkpoint(start_from)
    sim.run(start_itime=t0)
    return ended(sim)


def in_origin_order(res: dict) -> dict:
    """The particles put in schedule-origin order (slot o holds the
    particle of origin o)."""
    p = res["particles"]
    if res["origin"] is None:
        return p
    at = np.argsort(res["origin"], kind="stable")
    return {f: a[at] for f, a in p.items()}

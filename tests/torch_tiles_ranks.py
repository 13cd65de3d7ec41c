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

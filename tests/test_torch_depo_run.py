"""Port parity for a depositing, decaying run: the verification recipe of
``.claude/skills/verify/SKILL.md`` with two species through both packages.

The default ``Command()`` on the 37x19x15 grid to both poles, three hours
of 900 s steps, hourly output on a 60 x 40 x 3 grid; the release box (1000
particles over the first hour) sits at 46-52 N, 20-30 E, in SyntheticMet's
storm band, where clouds of class 2 and 3 rain on level 1.  Two species,
one unit of mass each:

* a Cs-137-like aerosol without settling (``dquer > 0``, no density):
  below-cloud rain and snow efficiencies, in-cloud CCN and IN
  efficiencies, a constant dry-deposition velocity and a 4 h half-life,
  short enough for the decay to show in three hours;
* an SO2-like gas: below-cloud ``A * P**B``, a Henry constant for the
  in-cloud rule and a constant dry-deposition velocity.

SyntheticMet has no below-cloud cells (its clouds start at level 1), so
the run exercises the in-cloud rules; ``tests/test_torch_wetdepo.py`` holds
every branch.  One JAX run per file (module-scoped), JAX's draws and
convection uniforms injected as in ``tests/test_torch_default_run.py``.

Held against JAX: the active count exactly; the airborne mass of each
species to 1e-4 relative; ``wetgridunc`` and ``drygridunc`` per species by
their totals to rtol 1e-3 and cell by cell as a distribution (95% of the
cells that hold more than 1e-3 of the largest within rtol 1e-2, all within
0.1 of the largest cell): z diverges over twelve steps (the boundary
layer's Langevin equation amplifies an ulp, ``tests/test_torch_sim.py``),
and a particle's deposit depends on its level (the cloud class of the level
below it, and the dry-deposition layer below 2 HREF); the npz ``wet`` and
``dry`` to the same rule (measured: totals within 2e-7, every cell within
1.5e-6 of the largest, 97-100% of the cells within rtol 1e-5, the airborne
mass within 2e-9).  The budget of each species: airborne + wet + dry at
most the released mass, plus 1e-6 for the float32 sums.
"""
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

N = 1000
NSTEPS = 12
ROWS = {**DRAW_ROWS, 2: 1}          # ctl=-5: ifine_eff = 1
MASS = (1.0, 1.0)


def _species(c):
    cs137 = c.Species(name="CS-137", decay_halflife=4 * 3600.0,
                      crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                      in_aero=0.1, dquer=0.4, dryvel=1.0e-3)
    so2 = c.Species(name="SO2", weta_gas=1.0e-4, wetb_gas=0.62,
                    henry=1.0e5, dryvel=0.01)
    return cs137, so2


def _recipe(c, grid_mod, outdir, **kw):
    grid = grid_mod.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=30000,
                    lsynctime=900, loutstep=3600, loutaver=3600,
                    loutsample=900)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=10000, lon1=20.0, lon2=30.0, lat1=46.0,
                       lat2=52.0, z1=50.0, z2=1500.0, mass=MASS, parts=N)
    rel = c.Releases(species=_species(c), boxes=(box,))
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    return dict(cmd=cmd, releases=rel, grid=grid,
                met_backend=grid_mod.SyntheticMet(grid), outgrid=og,
                outdir=str(outdir), **kw)


class _PortGrid:
    make_grid = staticmethod(make_grid)
    SyntheticMet = SyntheticMet


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jout = tmp_path_factory.mktemp("jax_depo")
    jsim = JaxSimulation(**_recipe(jconfig, jmet, jout))
    jsim.run()
    key = jax.random.PRNGKey(jsim.seed)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS)]
    uniforms = [torch.as_tensor(np.array(jax.random.uniform(
        jax.random.fold_in(key, 1000000 + i), (N,))))
        for i in range(NSTEPS + 1)]
    tout = tmp_path_factory.mktemp("port_depo")
    sim = Simulation(**_recipe(tconfig, _PortGrid, tout, device="cpu"))
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim._redist_hook = lambda istep, origin: uniforms[istep][origin]
    sim.run()
    return jsim, jout, sim, tout


def _airborne(mass, active):
    return np.asarray(mass, np.float64)[np.asarray(active)].sum(axis=0)


def _grid_close(t, j, what):
    """Totals per species within rtol 1e-3; cells as a distribution."""
    t = np.asarray(t, np.float64).reshape(-1, t.shape[-1])
    j = np.asarray(j, np.float64).reshape(-1, j.shape[-1])
    for s in range(j.shape[1]):
        tot_j, tot_t = j[:, s].sum(), t[:, s].sum()
        assert tot_j > 0.0, (what, s)
        assert abs(tot_t / tot_j - 1.0) <= 1e-3, (what, s, tot_t, tot_j)
        big = j[:, s].max()
        err = np.abs(t[:, s] - j[:, s])
        assert err.max() <= 0.1 * big, (what, s, err.max() / big)
        held = j[:, s] > 1e-3 * big
        ok = err[held] <= 1e-2 * j[held, s]
        assert ok.mean() >= 0.95, (what, s, ok.mean())


def test_depositing_run_keeps_its_particles_like_jax(runs):
    jsim, _, sim, _ = runs
    assert sim.any_wetdep and sim.any_drydep and sim.any_decay
    assert "wetdepo" in sim.timings and "drydepo" in sim.timings
    n_t = int(sim.particles.active.sum())
    assert n_t == int(np.sum(np.asarray(jsim.particles.active))) == N
    air_t = _airborne(sim.particles.mass.numpy(), sim.particles.active.numpy())
    air_j = _airborne(jsim.particles.mass, jsim.particles.active)
    np.testing.assert_allclose(air_t, air_j, rtol=1e-4)
    # both species lost mass to deposition, the aerosol to decay too
    assert (air_j < 0.99 * np.asarray(MASS)).all()


def test_deposition_grids_match_jax(runs):
    jsim, _, sim, _ = runs
    _grid_close(sim.acc.wetgridunc.numpy(), jsim.acc.wetgridunc, "wet")
    _grid_close(sim.acc.drygridunc.numpy(), jsim.acc.drygridunc, "dry")


def test_npz_wet_and_dry_match_jax(runs):
    _, jout, _, tout = runs
    files = sorted(Path(jout).glob("grid_conc_*.npz"))
    assert len(files) == 2
    for jf in files:
        j, t = np.load(jf), np.load(Path(tout) / jf.name)
        for k in ("wet", "dry"):
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
            # (nspec, npoint, nage, ny, nx) -> species innermost
            _grid_close(np.moveaxis(t[k], 0, -1), np.moveaxis(j[k], 0, -1),
                        f"{jf.name} {k}")


def test_budget_holds(runs):
    """airborne + wet + dry <= released, per species, in both packages."""
    jsim, _, sim, _ = runs
    for mass, active, wet, dry in (
            (sim.particles.mass.numpy(), sim.particles.active.numpy(),
             sim.acc.wetgridunc.numpy(), sim.acc.drygridunc.numpy()),
            (jsim.particles.mass, jsim.particles.active,
             jsim.acc.wetgridunc, jsim.acc.drygridunc)):
        air = _airborne(mass, active)
        dep = (np.asarray(wet, np.float64).reshape(-1, 2).sum(axis=0)
               + np.asarray(dry, np.float64).reshape(-1, 2).sum(axis=0))
        assert (dep > 0).all()
        assert (air + dep <= np.asarray(MASS) * (1 + 1e-6)).all(), (air, dep)


def test_simulation_from_jax_carries_the_deposition_fields(runs, tmp_path):
    jsim = runs[0]
    sim = interop.simulation_from_jax(jsim, "cpu", outdir=str(tmp_path))
    assert sim.minmass == jsim.minmass and sim.options_dir is None
    assert sim.wet_species == tuple(tuple(w) for w in jsim.wet_species)
    assert tuple(sim.mass_species) == tuple(jsim.mass_species)
    assert (sim.any_wetdep, sim.any_drydep, sim.any_decay) == (
        jsim.any_wetdep, jsim.any_drydep, jsim.any_decay)
    np.testing.assert_array_equal(sim._decay_arr.numpy(),
                                  np.asarray(jsim._decay_arr))

"""Port parity for the default ``Simulation``: the verification recipe of
``README.md`` ("A run") verbatim through both packages.

The default ``Command()`` (``lconvection=1``, ``lsubgrid=1``) on the
37x19x15 grid that reaches both poles (so the advance takes the polar-cap
update): a 2 x 2 degree box of 1000 particles released over the first
hour, three hours of 900 s steps, hourly output on a 60 x 40 x 3 grid.
The port differs from the recipe only in its import names and
``device="cpu"``.  One JAX run per file (module-scoped).

Equal: the release schedule bitwise, the active count, ``dates``, the
file names, the names, shapes and dtypes in the npz files; the run's
sections include ``convection``.

With JAX's draws injected (the advance's through ``_draws_hook``, the
convective redistribution's uniforms ``jax.random.uniform(fold_in(key,
1000000 + istep))`` through ``_redist_hook``, both mapped to the slots
through ``_origin``), with the tolerances of ``tests/test_torch_sim.py``:
the mask, ``cbt`` and ``itra`` exactly; x and y within 1e-4 grid units
for all but 0.5% of the particles and those within ten times as much
(measured: 1.5e-5 and 0); z as a distribution (85% within 1e-2 m + 1e-4
relative, 98% within 1 m, the plume's mean height within 0.5 m: the
boundary layer's Langevin equation amplifies an ulp; measured 95%, 99.5%,
1.5e-3 m, the worst particle 3.4 m apart); ``conc`` within rtol 1e-5 plus
1e-5 of the largest cell (measured: equal); the convective flux memory
``cbmf`` of every column within 5e-4 of its largest value
(``tests/test_torch_convection.py``; measured 6.2e-5).  The
plume at 40-42 N stays out of SyntheticMet's convecting band (10 S-10 N
at this resolution), so no particle is redistributed in either package,
and the columns that convect are the same.

Between port runs with the port's own Philox streams: bitwise equal
particles and ``conc``.
"""
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.config import Command  # noqa: E402
from flexpart_tpu_torch.core import reorder  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

N = 1000
NSTEPS = 12
ROWS = {**DRAW_ROWS, 2: 1}          # ctl=-5: ifine_eff = 1
FEW_SHARE = 0.005


def _recipe(c, grid_mod, outdir, **kw):
    """The verification recipe, line for line, in the package
    ``c``/``grid_mod`` names."""
    grid = grid_mod.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=30000,
                    lsynctime=900, loutstep=3600, loutaver=3600,
                    loutsample=900)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=10000, lon1=0.0, lon2=2.0, lat1=40.0,
                       lat2=42.0, z1=50.0, z2=500.0, mass=(1.0,), parts=1000)
    rel = c.Releases(species=(c.Species(),), boxes=(box,))
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    return dict(cmd=cmd, releases=rel, grid=grid,
                met_backend=grid_mod.SyntheticMet(grid), outgrid=og,
                outdir=str(outdir), **kw)


class _PortGrid:
    make_grid = staticmethod(make_grid)
    SyntheticMet = SyntheticMet


def _port_sim(outdir, **kw):
    return Simulation(**_recipe(tconfig, _PortGrid, outdir, device="cpu",
                                **kw))


def _numpy_particles(p):
    if hasattr(p, "_asdict"):
        return {f: np.asarray(getattr(p, f)) for f in FIELDS}
    return interop.particles_to_numpy(p)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("jax_default")
    sim = JaxSimulation(**_recipe(jconfig, jmet, outdir))
    schedule = _numpy_particles(sim.particles)
    sim.run()
    key = jax.random.PRNGKey(sim.seed)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS)]
    uniforms = [torch.as_tensor(np.array(jax.random.uniform(
        jax.random.fold_in(key, 1000000 + i), (N,))))
        for i in range(NSTEPS + 1)]
    return sim, outdir, schedule, draws, uniforms


@pytest.fixture(scope="module")
def injected_run(jax_run, tmp_path_factory):
    _, _, _, draws, uniforms = jax_run
    outdir = tmp_path_factory.mktemp("port_default")
    sim = _port_sim(outdir)
    schedule = _numpy_particles(sim.particles)
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim._redist_hook = lambda istep, origin: uniforms[istep][origin]
    sim.run()
    return sim, outdir, schedule


def test_the_recipe_is_the_default_command(tmp_path):
    """What the recipe leaves to the defaults: convection, subgrid
    orography, and a grid whose caps take the polar update."""
    cmd = Command()
    assert (cmd.lconvection, cmd.lsubgrid) == (1, 1)
    sim = _port_sim(tmp_path)
    assert sim.step_cfg.polar and sim.conv_kernel is not None
    assert sim.grid.nglobal and sim.grid.sglobal
    assert sim.cbmf.shape == (19 * 37,) and not sim.cbmf.any()


def test_schedule_names_and_shapes_equal_jax(jax_run, injected_run):
    jsim, jout, jsched, _, _ = jax_run
    sim, tout, tsched = injected_run
    for f in FIELDS:
        assert tsched[f].dtype == jsched[f].dtype, f
        np.testing.assert_array_equal(tsched[f], jsched[f], err_msg=f)
    assert int(sim.particles.active.sum()) \
        == int(np.sum(np.asarray(jsim.particles.active))) == N
    jnames = sorted(p.name for p in Path(jout).iterdir())
    assert sorted(p.name for p in Path(tout).iterdir()) == jnames
    assert len(jnames) == 4 and "dates" in jnames   # dates, nc, two npz
    assert (Path(tout) / "dates").read_text() \
        == (Path(jout) / "dates").read_text()
    for jf in sorted(Path(jout).glob("grid_conc_*.npz")):
        j, t = np.load(jf), np.load(Path(tout) / jf.name)
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    assert "convection" in sim.timings and "convection" in jsim.timings
    assert sim.timings["particle_steps"] == jsim.timings["particle_steps"]


def test_injected_draws_match_jax(jax_run, injected_run):
    jsim, jout, _, _, _ = jax_run
    sim, tout, _ = injected_run
    a = _numpy_particles(reorder.apply_perm(sim.particles,
                                            torch.argsort(sim._origin)))
    b = _numpy_particles(jsim.particles)
    for f in ("active", "itra", "itramem", "npoint", "nclass", "cbt"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("x", "y"):
        va = a[f + "_hi"] + a[f + "_lo"]
        vb = b[f + "_hi"] + b[f + "_lo"]
        err = np.abs(va - vb)
        assert err.max() <= 1e-3, (f, err.max())
        assert (err > 1e-4).sum() <= FEW_SHARE * N, (f, (err > 1e-4).sum())
    err_z = np.abs(a["z"] - b["z"])
    assert np.mean(err_z <= 1e-2 + 1e-4 * np.abs(b["z"])) >= 0.85
    assert np.mean(err_z <= 1.0) >= 0.98
    assert abs(a["z"].mean() - b["z"].mean()) < 0.5
    # the convective flux memory, every column
    cb_t, cb_j = sim.cbmf.numpy(), np.asarray(jsim.cbmf)
    assert (cb_t > 0).sum() == (cb_j > 0).sum() > 0
    np.testing.assert_allclose(cb_t, cb_j, rtol=0, atol=5e-4 * cb_j.max())
    counts = torch.stack(sim.convection_counts).numpy()
    assert counts.shape == (NSTEPS + 1, 2)
    assert (counts[:, 0] > 0).all() and sim.timings["convection_moved"] == 0
    for jf in sorted(Path(jout).glob("grid_conc_*.npz")):
        j = np.load(jf)["conc"]
        t = np.load(Path(tout) / jf.name)["conc"]
        assert j.max() > 0
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * j.max())
    d = np.load(sorted(Path(tout).glob("grid_conc_*.npz"))[-1])
    mass = float((d["conc"][0, 0, 0] * sim.geo.volume).sum() / 1e12)
    assert abs(mass - 1.0) < 1e-3


def test_two_port_runs_with_one_seed_are_bitwise_equal(tmp_path):
    runs = []
    for k in range(2):
        sim = _port_sim(tmp_path / str(k), write_netcdf=False)
        sim.run()
        runs.append(sim)
    a, b = (_numpy_particles(s.particles) for s in runs)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f].view(np.uint8), b[f].view(np.uint8),
                                      err_msg=f)
    assert torch.equal(runs[0].cbmf, runs[1].cbmf)
    for f1 in sorted((tmp_path / "0").glob("grid_conc_*.npz")):
        np.testing.assert_array_equal(np.load(f1)["conc"],
                                      np.load(tmp_path / "1" / f1.name)["conc"])


def test_simulation_from_jax_carries_cbmf_and_xlon0(jax_run, tmp_path):
    """The port's Simulation built from the JAX run takes its convective
    flux memory and the grid origin of the polar-cap projection."""
    jsim = jax_run[0]
    sim = interop.simulation_from_jax(jsim, "cpu", outdir=str(tmp_path))
    np.testing.assert_array_equal(sim.cbmf.numpy(), np.asarray(jsim.cbmf))
    assert float(sim.cbmf.max()) > 0.0
    assert sim.step_prm.xlon0 == float(np.asarray(jsim.step_prm.xlon0_pol))
    assert interop.step_params_from_numpy(jsim.step_prm) == sim.step_prm
    assert sim.step_cfg.polar == jsim.step_cfg.polar is True

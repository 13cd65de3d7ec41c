"""Port parity for the default ``Simulation`` where convection moves
particles and the polar-cap update takes them: the verification recipe
(``README.md``, "A run"; the default ``Command()`` on the
37x19x15 grid that reaches both poles, three hours of 900 s steps, hourly
output on a 60 x 40 x 3 grid) with its one box replaced by two of 1000
particles each, released over the first hour: one at 0-2 N, inside
SyntheticMet's convecting band (10 S-10 N at this resolution), and one at
80-82 N, inside the northern polar cap (poleward of 75 degrees).  The
recipe's own box, at 40-42 N, reaches neither: that run is
``tests/test_torch_default_run.py``.  One JAX run per file
(module-scoped).

With JAX's draws injected (the advance's through ``_draws_hook``, the
convective redistribution's uniforms ``jax.random.uniform(fold_in(key,
1000000 + istep))`` through ``_redist_hook``, both mapped to the slots
through ``_origin``), and the particles JAX's redistribution moved counted
by wrapping the JAX package's ``redist_particles`` where its
``Simulation`` calls it:

* particles are moved in both packages, on the same steps, and the
  counts of each step differ by at most one particle (a level is chosen
  by ``frac >= rn``, so a particle whose z the boundary layer's Langevin
  equation has carried an ulp away, or whose cumulative fraction differs
  by one, may land in another level; measured: equal on every step, 2-4
  particles a step from the fourth on, 26 in all);
* the particles in the northern cap, counted before each step's
  redistribution, are the same in both packages on every step (250, 500,
  750, then all 1000 of the polar box);
* the mask and ``itra`` exactly, ``cbt`` (the sign of the convective
  boundary layer's updraft) for all but 0.5% of the particles (measured
  4 of 2000: it follows z); x and y within 1e-4 grid units for all but
  0.5% of the particles and those within 1e-3 (the tolerances of
  ``tests/test_torch_sim.py``; in the cap sin, cos, tan, hypot, atan and
  atan2 of XLA and torch differ by an ulp or two; measured 1.1e-5 for
  all); z as a distribution: 85% within 1e-2 m + 1e-4 relative, 97% within
  1 m and the plume's mean height within 0.5 m (the Langevin equation
  amplifies an ulp, and a particle that the two redistributions put in
  different levels is a level's depth away; measured 89.9%, 98.3%, 0.015
  m); ``conc`` within rtol 1e-5 plus
  1e-5 of the largest cell, the convective flux memory ``cbmf`` within
  5e-4 of its largest value (``tests/test_torch_convection.py``).
"""
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import flexpart_tpu.run.simulation as jsimulation  # noqa: E402
from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import reorder  # noqa: E402
from flexpart_tpu_torch.core.advance import (DRAW_ROWS,  # noqa: E402
                                             SWITCHNORTH)
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

PARTS = 1000
N = 2 * PARTS
NSTEPS = 12
ROWS = {**DRAW_ROWS, 2: 1}          # ctl=-5: ifine_eff = 1
FEW_SHARE = 0.005
# the boxes: (lat1, lat2) of the convecting one and of the polar one
LAT_CONVECTING, LAT_POLAR = (0.0, 2.0), (80.0, 82.0)


def _run_kw(c, grid_mod, outdir, **kw):
    """The verification recipe with the two boxes, in the package
    ``c``/``grid_mod`` names."""
    grid = grid_mod.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=30000,
                    lsynctime=900, loutstep=3600, loutaver=3600,
                    loutsample=900)
    boxes = tuple(
        c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                     itime2=10000, lon1=0.0, lon2=2.0, lat1=lat1, lat2=lat2,
                     z1=50.0, z2=500.0, mass=(1.0,), parts=PARTS)
        for lat1, lat2 in (LAT_CONVECTING, LAT_POLAR))
    rel = c.Releases(species=(c.Species(),), boxes=boxes)
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    return dict(cmd=cmd, releases=rel, grid=grid,
                met_backend=grid_mod.SyntheticMet(grid), outgrid=og,
                outdir=str(outdir), **kw)


class _PortGrid:
    make_grid = staticmethod(make_grid)
    SyntheticMet = SyntheticMet


def _numpy_particles(p):
    if hasattr(p, "_asdict"):
        return {f: np.asarray(getattr(p, f)) for f in FIELDS}
    return interop.particles_to_numpy(p)


def _in_cap(y_hi, y_lo, grid) -> np.ndarray:
    """Particles poleward of SWITCHNORTH (the northern cap)."""
    lat = grid.ylat0 + (np.asarray(y_hi) + np.asarray(y_lo)) * grid.dy
    return lat > SWITCHNORTH


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("jax_convecting")
    moved, caps = [], []
    redist = jsimulation.redist_particles

    def counting(p, *args, **kw):
        caps.append(int(np.sum(_in_cap(p.y_hi, p.y_lo, sim.grid)
                               & np.asarray(p.active))))
        out, n_moved = redist(p, *args, **kw)
        moved.append(int(n_moved))
        return out, n_moved

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsimulation, "redist_particles", counting)
        sim = jsimulation.Simulation(**_run_kw(jconfig, jmet, outdir))
        sim.run()
    key = jax.random.PRNGKey(sim.seed)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS)]
    uniforms = [torch.as_tensor(np.array(jax.random.uniform(
        jax.random.fold_in(key, 1000000 + i), (N,))))
        for i in range(NSTEPS + 1)]
    return sim, outdir, np.array(moved), np.array(caps), draws, uniforms


@pytest.fixture(scope="module")
def injected_run(jax_run, tmp_path_factory):
    draws, uniforms = jax_run[4:]
    outdir = tmp_path_factory.mktemp("port_convecting")
    sim = Simulation(**_run_kw(tconfig, _PortGrid, outdir, device="cpu"))
    caps = []

    def hook(istep, origin):
        p = sim.particles
        caps.append(int((torch.as_tensor(_in_cap(p.y_hi, p.y_lo, sim.grid))
                         & p.active).sum()))
        return uniforms[istep][origin]

    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim._redist_hook = hook
    sim.run()
    moved = torch.stack(sim.convection_counts)[:, 1].numpy()
    return sim, outdir, moved, np.array(caps)


def test_convection_moves_particles_as_jax_does(jax_run, injected_run):
    jmoved = jax_run[2]
    sim, _, tmoved, _ = injected_run
    assert len(jmoved) == len(tmoved) == NSTEPS + 1
    assert jmoved.sum() > 0 and tmoved.sum() > 0
    assert ((jmoved > 0) == (tmoved > 0)).all()
    np.testing.assert_allclose(tmoved, jmoved, rtol=0, atol=1)
    assert sim.timings["convection_moved"] == int(tmoved.sum())


def test_particles_in_the_polar_cap_as_jax(jax_run, injected_run):
    jcaps = jax_run[3]
    sim, _, _, tcaps = injected_run
    assert sim.step_cfg.polar
    assert len(jcaps) == len(tcaps) == NSTEPS + 1
    assert (jcaps > 0).all() and (tcaps > 0).all()
    np.testing.assert_array_equal(tcaps, jcaps)
    p = sim.particles
    assert int((torch.as_tensor(_in_cap(p.y_hi, p.y_lo, sim.grid))
                & p.active).sum()) == PARTS


def test_injected_draws_match_jax(jax_run, injected_run):
    jsim, jout = jax_run[:2]
    sim, tout = injected_run[:2]
    a = _numpy_particles(reorder.apply_perm(sim.particles,
                                            torch.argsort(sim._origin)))
    b = _numpy_particles(jsim.particles)
    for f in ("active", "itra", "itramem", "npoint", "nclass"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert a["active"].sum() == N
    assert (a["cbt"] != b["cbt"]).sum() <= FEW_SHARE * N
    for f in ("x", "y"):
        va = a[f + "_hi"] + a[f + "_lo"]
        vb = b[f + "_hi"] + b[f + "_lo"]
        err = np.abs(va - vb)
        assert err.max() <= 1e-3, (f, err.max())
        assert (err > 1e-4).sum() <= FEW_SHARE * N, (f, (err > 1e-4).sum())
    err_z = np.abs(a["z"] - b["z"])
    assert np.mean(err_z <= 1e-2 + 1e-4 * np.abs(b["z"])) >= 0.85
    assert np.mean(err_z <= 1.0) >= 0.97
    assert abs(a["z"].mean() - b["z"].mean()) < 0.5
    cb_t, cb_j = sim.cbmf.numpy(), np.asarray(jsim.cbmf)
    assert (cb_t > 0).sum() == (cb_j > 0).sum() > 0
    np.testing.assert_allclose(cb_t, cb_j, rtol=0, atol=5e-4 * cb_j.max())
    for jf in sorted(Path(jout).glob("grid_conc_*.npz")):
        j = np.load(jf)["conc"]
        t = np.load(Path(tout) / jf.name)["conc"]
        assert j.max() > 0
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * j.max())

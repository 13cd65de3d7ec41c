"""Port parity for the domain fill and its regional boundary
(``core/domainfill.py``; kernel K14 on a card, its plain version here).

The fill (``init_domainfill`` with ``_init_boundary``, numpy in both
packages) is held bitwise against the JAX package's: every particle field,
the total air mass and every entry of the boundary table, for a global
fill with MDOMAINFILL 1 and 2 and a regional window.

The boundary step's plain version against ``boundcond_domainfill`` on the
same particles, with JAX's draws injected as it makes them
(``jax.random`` of fold_in(key, round), its fold_in 1 and 2): the slots
are shuffled (a sort has run) and ranked through the origin, for
MDOMAINFILL 1 and 2.  Equal: every integer and flag field and the counts;
the float fields and the accumulator within rtol 1e-6 (XLA contracts
``w0 * a + w1 * b`` into fused multiply-adds, torch does not; the
emission counts, floors of the accumulator, come out equal).

One JAX ``Simulation`` run: a regional fill in a uniform westerly, 20
steps of 900 s, so that the boundary emits after the sort of step 16,
against the port's run with JAX's advance draws (through ``_draws_hook``,
mapped through ``_origin``) and its boundary draws (``_boundary_hook``)
injected.  Equal: the active mask, itra, itramem, npoint, nclass and cbt
in schedule order, and the particles created at the boundary; x and y
within 1e-3 grid units, z within 1 m for 98% of the particles (the
tolerances of tests/test_torch_default_run.py); the accumulator within
rtol 1e-4; the last conc within rtol 1e-4 of its largest cell.

A regional run resumed from a checkpoint at an output time is the straight
run bit for bit (particles, boundary state, files), as
tests/test_domainfill.py holds the JAX package's.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import domainfill as jdf  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import Simulation, make_grid  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import domainfill as tdf  # noqa: E402
from flexpart_tpu_torch.core import reorder, rng  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.met.synthetic import uniform_wind_met  # noqa: E402

GRID = dict(nx=73, ny=37, nlev=12, dx=5.0, dy=5.0)
WINDOW = dict(lon1=-60.0, lon2=60.0, lat1=-30.0, lat2=30.0)
NORTH = dict(lon1=-60.0, lon2=60.0, lat1=30.0, lat2=70.0)
GLOBE = dict(lon1=-180.0, lon2=180.0, lat1=-90.0, lat2=90.0)
PARTS = 2000
CAPACITY = 4096
SEED = 13
NSTEPS = 20
ROWS = {**DRAW_ROWS, 2: 1}
INT_FIELDS = ("itra", "itramem", "npoint", "nclass", "idt", "itrasplit",
              "cbt", "active")
FLOAT_FIELDS = ("x_hi", "x_lo", "y_hi", "y_lo", "z", "up", "vp", "wp",
                "usig", "vsig", "wsig", "mass", "mass0", "xscav")


def _config(c, box=WINDOW, mdomainfill=1, hours=5, parts=PARTS, **kw):
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=hours * 10000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    mdomainfill=mdomainfill, **kw)
    rbox = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                        itime2=0, z1=0.0, z2=50000.0, mass=(1.0,),
                        parts=parts, **box)
    rel = c.Releases(species=(c.Species(),), boxes=(rbox,))
    og = c.OutGrid(outlon0=-60.0, outlat0=-30.0, numxgrid=24, numygrid=12,
                   dxout=5.0, dyout=5.0, outheights=(2000.0, 50000.0))
    return cmd, rel, og


def _jax_sim(outdir, met=None, **kw):
    cmd, rel, og = _config(jconfig, **kw)
    grid = jmet.make_grid(**GRID)
    return JaxSimulation(
        cmd=cmd, releases=rel, grid=grid, outgrid=og, outdir=str(outdir),
        met_backend=met or jmet.uniform_wind_met(grid, u=20.0, v=0.0),
        write_netcdf=False, seed=SEED, capacity=CAPACITY)


def _port_sim(outdir, **kw):
    sim_kw = {k: kw.pop(k) for k in ("checkpoint_at", "checkpoint_path",
                                     "receptors", "outgrid_nest")
              if k in kw}
    cmd, rel, og = _config(tconfig, **kw)
    grid = make_grid(**GRID)
    return Simulation(cmd=cmd, releases=rel, grid=grid, outgrid=og,
                      outdir=str(outdir),
                      met_backend=uniform_wind_met(grid, u=20.0, v=0.0),
                      write_netcdf=False, seed=SEED, capacity=CAPACITY,
                      device="cpu", **sim_kw)


def _window(grid, box):
    return ((box["lon1"] - grid.xlon0) / grid.dx,
            (box["lon2"] - grid.xlon0) / grid.dx,
            (box["lat1"] - grid.ylat0) / grid.dy,
            (box["lat2"] - grid.ylat0) / grid.dy)


def _jax_field(tmp_path, synthetic=True):
    grid = jmet.make_grid(**GRID)
    met = jmet.SyntheticMet(grid) if synthetic else None
    jsim = _jax_sim(tmp_path / "field", met=met)
    zf = jsim._get_field(0)
    jsim.close()
    return grid, zf


@pytest.mark.parametrize("case", [("global", 1), ("global", 2),
                                  ("regional", 1), ("north", 2)])
def test_init_domainfill_equals_jax_bitwise(case, tmp_path):
    name, md = case
    jgrid, zf = _jax_field(tmp_path)
    box = {"global": GLOBE, "regional": WINDOW, "north": NORTH}[name]
    win = _window(jgrid, box)
    jp, jtotal, jbs = jdf.init_domainfill(jgrid, zf, 20000, mdomainfill=md,
                                          seed=SEED, capacity=None,
                                          window=win)
    tgrid = interop.metgrid_from_jax(jgrid)
    tp, ttotal, tbs = tdf.init_domainfill(tgrid, zf, 20000, mdomainfill=md,
                                          seed=SEED, capacity=None,
                                          window=win)
    assert ttotal == jtotal
    for f in FIELDS:
        j = np.asarray(getattr(jp, f))
        assert tp[f].dtype == j.dtype, f
        np.testing.assert_array_equal(tp[f], j, err_msg=f)
    if name == "global":
        assert jbs is None and tbs is None
        return
    assert len(tbs["acc"]) > 100
    for f in tdf.BOUNDARY_FIELDS:
        j = np.asarray(getattr(jbs, f))
        assert tbs[f].dtype == j.dtype, f
        np.testing.assert_array_equal(tbs[f], j, err_msg=f)


def _jax_draws(key, sites, nclassunc=1):
    """boundcond_domainfill's draws of one step: (u1, u2, nclass), each
    (KMAX_EMIT, S)."""
    u1, u2, nc = [], [], []
    for r in range(tdf.KMAX_EMIT):
        rk = jax.random.fold_in(key, r)
        u1.append(np.asarray(jax.random.uniform(rk, (sites,))))
        u2.append(np.asarray(jax.random.uniform(jax.random.fold_in(rk, 1),
                                                (sites,))))
        nc.append(np.asarray(jax.random.randint(
            jax.random.fold_in(rk, 2), (sites,), 0, nclassunc)))
    return (torch.as_tensor(np.stack(u1)), torch.as_tensor(np.stack(u2)),
            torch.as_tensor(np.stack(nc).astype(np.int32)))


@pytest.mark.parametrize("md", [1, 2])
def test_boundary_step_equals_jax(md, tmp_path):
    """One boundary step through both packages on a filled window whose
    particles were moved (some out of it) and whose accumulator holds up
    to six particle masses (the four-round cap and its carry); the port's
    slots shuffled and ranked through their origin."""
    jgrid, zf = _jax_field(tmp_path)
    box = WINDOW if md == 1 else NORTH
    jp, _, jbs = jdf.init_domainfill(jgrid, zf, 6000, mdomainfill=md,
                                     seed=SEED, capacity=8192,
                                     window=_window(jgrid, box))
    rs = np.random.default_rng(5)
    n = jp.capacity
    f = {k: np.asarray(getattr(jp, k)).copy() for k in FIELDS}
    live = f["z"] > 0
    f["active"] = live
    f["x_hi"] = (f["x_hi"] + rs.uniform(-2.0, 2.0, n)).astype(np.float32)
    f["y_hi"] = (f["y_hi"] + rs.uniform(-2.0, 2.0, n)).astype(np.float32)
    # two future releases among the empty slots: never taken
    empty = np.nonzero(~live)[0]
    f["itra"][empty[[3, 11]]] = f["itramem"][empty[[3, 11]]] = 7200
    xpp = float(jbs.xpp)
    acc0 = (rs.uniform(0.0, 6.0, len(jbs.acc)) * xpp).astype(np.float32)
    jbs = jbs._replace(acc=jnp.asarray(acc0))
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 3000005)
    itime, mt0, mt1 = 900, 0, 3600
    jout, jbs2 = jdf.boundcond_domainfill(
        JParticles(**{k: jnp.asarray(v) for k, v in f.items()}), jbs, zf, zf,
        jnp.int32(itime), jnp.int32(mt0), jnp.int32(mt1), key,
        jnp.int32(900), jnp.int32(499999999), jnp.float32(jgrid.ylat0),
        jnp.float32(jgrid.dy), mdomainfill=md)
    origin = rs.permutation(n)
    p = interop.particles_from_numpy({k: v[origin] for k, v in f.items()},
                                     "cpu")
    bs = interop.boundary_from_jax(
        {k: np.asarray(v) for k, v in jbs._asdict().items()}, "cpu")
    f3d = torch.as_tensor(np.array(zf.f3d))
    height = torch.as_tensor(np.array(zf.height))
    w0, w1 = tdf.time_weights(itime, mt0, mt1)
    acc, counts = tdf.boundcond(
        p, bs, f3d, f3d, height, itime, w0, w1, rng.Key(SEED, 5), 900,
        499999999, jgrid.ylat0, jgrid.dy, mdomainfill=md,
        origin=torch.as_tensor(origin), draws=_jax_draws(key, bs.sites))
    back = np.argsort(origin)
    t = {k: v[back] for k, v in interop.particles_to_numpy(p).items()}
    j = {k: np.asarray(getattr(jout, k)) for k in FIELDS}
    for k in INT_FIELDS:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jbs2.acc), rtol=1e-6,
                               atol=1e-6 * xpp)
    killed, free, wanted, granted = counts.tolist()
    x = f["x_hi"] + f["x_lo"]
    y = f["y_hi"] + f["y_lo"]
    xl, yl = np.asarray(jbs.xlim), np.asarray(jbs.ylim)
    out = (x < xl[0]) | (x > xl[1]) | (y < yl[0]) | (y > yl[1])
    assert killed == int((live & out).sum()) > 0
    born = j["active"] & (j["itramem"] == itime)
    assert granted == min(free, wanted) == int(born.sum()) > 0
    if md == 1:
        assert wanted > 0 and (j["mass"][born] == np.float32(xpp)).all()


def test_boundary_step_without_sites_equals_jax(tmp_path):
    """A boundary step whose table holds no site: both packages kill the
    particles outside the window and emit none; the port's slots shuffled
    and ranked through their origin."""
    jgrid, zf = _jax_field(tmp_path)
    jp, _, jbs = jdf.init_domainfill(jgrid, zf, 6000, seed=SEED,
                                     capacity=8192,
                                     window=_window(jgrid, WINDOW))
    jbs = jbs._replace(**{f: getattr(jbs, f)[:0]
                          for f in tdf.BOUNDARY_FIELDS[:15]})
    rs = np.random.default_rng(7)
    n = jp.capacity
    f = {k: np.asarray(getattr(jp, k)).copy() for k in FIELDS}
    live = f["z"] > 0
    f["active"] = live
    f["x_hi"] = (f["x_hi"] + rs.uniform(-2.0, 2.0, n)).astype(np.float32)
    f["y_hi"] = (f["y_hi"] + rs.uniform(-2.0, 2.0, n)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 3000006)
    itime, mt0, mt1 = 900, 0, 3600
    jout, jbs2 = jdf.boundcond_domainfill(
        JParticles(**{k: jnp.asarray(v) for k, v in f.items()}), jbs, zf, zf,
        jnp.int32(itime), jnp.int32(mt0), jnp.int32(mt1), key,
        jnp.int32(900), jnp.int32(499999999), jnp.float32(jgrid.ylat0),
        jnp.float32(jgrid.dy))
    origin = rs.permutation(n)
    p = interop.particles_from_numpy({k: v[origin] for k, v in f.items()},
                                     "cpu")
    bs = interop.boundary_from_jax(
        {k: np.asarray(v) for k, v in jbs._asdict().items()}, "cpu")
    assert bs.sites == 0
    f3d = torch.as_tensor(np.array(zf.f3d))
    height = torch.as_tensor(np.array(zf.height))
    w0, w1 = tdf.time_weights(itime, mt0, mt1)
    acc, counts = tdf.boundcond(
        p, bs, f3d, f3d, height, itime, w0, w1, rng.Key(SEED, 6), 900,
        499999999, jgrid.ylat0, jgrid.dy, origin=torch.as_tensor(origin),
        draws=_jax_draws(key, 0))
    back = np.argsort(origin)
    t = {k: v[back] for k, v in interop.particles_to_numpy(p).items()}
    j = {k: np.asarray(getattr(jout, k)) for k in FIELDS}
    for k in FIELDS:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert acc.shape == (0,) and np.asarray(jbs2.acc).shape == (0,)
    killed, free, wanted, granted = counts.tolist()
    x = f["x_hi"] + f["x_lo"]
    y = f["y_hi"] + f["y_lo"]
    xl, yl = np.asarray(jbs.xlim), np.asarray(jbs.ylim)
    out = (x < xl[0]) | (x > xl[1]) | (y < yl[0]) | (y > yl[1])
    assert killed == int((live & out).sum()) > 0
    assert wanted == granted == 0
    assert free == int((~j["active"]).sum())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The regional fill of tests/test_domainfill.py in a uniform
    westerly, 20 steps; its schedule of draws."""
    sim = _jax_sim(tmp_path_factory.mktemp("jax_regional"), hours=5)
    sim.run()
    key = jax.random.PRNGKey(SEED)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, CAPACITY), tag=t)))
        for t, r in ROWS.items()} for i in range(NSTEPS)]
    sites = int(sim._boundary.acc.shape[0])
    bdraws = [_jax_draws(jax.random.fold_in(key, 3000000 + i), sites)
              for i in range(NSTEPS + 1)]
    return sim, draws, bdraws


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    _, draws, bdraws = jax_run
    sim = _port_sim(tmp_path_factory.mktemp("port_regional"), hours=5)
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim._boundary_hook = lambda istep: bdraws[istep]
    sim.run()
    return sim


def test_regional_run_equals_jax(jax_run, port_run):
    jsim = jax_run[0]
    sim = port_run
    assert sim.airmass_total == jsim.airmass_total
    assert sim.n_sorts >= 2 and sim._origin is not None
    counts = torch.stack(sim.boundary_counts).numpy()
    assert counts.shape == (NSTEPS + 1, 4)
    # the boundary emits after step 16's sort
    assert counts[17:, 3].sum() > 0 and counts[:, 0].sum() > 0
    a = interop.particles_to_numpy(
        reorder.apply_perm(sim.particles, torch.argsort(sim._origin)))
    b = {f: np.asarray(getattr(jsim.particles, f)) for f in FIELDS}
    for f in ("active", "itra", "itramem", "npoint", "nclass", "cbt"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    created = b["active"] & (b["itramem"] > 0)
    assert created.sum() > 20
    np.testing.assert_array_equal(a["mass"][created], b["mass"][created])
    act = b["active"]
    for f in ("x", "y"):
        err = np.abs((a[f + "_hi"] + a[f + "_lo"])
                     - (b[f + "_hi"] + b[f + "_lo"]))[act]
        assert err.max() <= 1e-3, (f, err.max())
    err_z = np.abs(a["z"] - b["z"])[act]
    assert np.mean(err_z <= 1.0) >= 0.98
    np.testing.assert_allclose(sim._boundary.acc.numpy(),
                               np.asarray(jsim._boundary.acc), rtol=1e-4,
                               atol=1e-4 * float(jsim._boundary.xpp))
    last = sorted(Path(jsim.outdir).glob("grid_conc_*.npz"))[-1]
    j, t = np.load(last)["conc"], np.load(Path(sim.outdir) / last.name)["conc"]
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * j.max())


def test_simulation_from_jax_carries_the_boundary(jax_run, tmp_path):
    jsim = jax_run[0]
    sim = interop.simulation_from_jax(jsim, "cpu", outdir=str(tmp_path))
    assert sim.cmd.mdomainfill == 1 and sim.airmass_total == \
        jsim.airmass_total
    for f in tdf.BOUNDARY_FIELDS:
        np.testing.assert_array_equal(
            getattr(sim._boundary, f).numpy(),
            np.asarray(getattr(jsim._boundary, f)), err_msg=f)
    a = interop.particles_to_numpy(sim.particles)
    for f in FIELDS:
        np.testing.assert_array_equal(
            a[f], np.asarray(getattr(jsim.particles, f)), err_msg=f)


def test_regional_checkpoint_resume_is_bitwise(tmp_path):
    """Straight 3 h with a checkpoint at 5400 s (an output time, before its
    output), then a second Simulation resumed from it: the same particles,
    boundary state and files (tests/test_domainfill.py:111-148's round
    trip, carried on to the end).  The run has receptors, fluxes and a
    nested output grid too, whose sums of the open window the checkpoint
    keeps: their files of the resumed run are the straight run's."""
    ck = tmp_path / "ck.npz"
    opts = dict(hours=3, iflux=1,
                receptors=(tconfig.Receptor("IN", 0.0, 0.0),),
                outgrid_nest=tconfig.OutGrid(
                    outlon0=-20.0, outlat0=-10.0, numxgrid=16, numygrid=8,
                    dxout=2.5, dyout=2.5, outheights=(2000.0, 50000.0)))
    a = _port_sim(tmp_path / "a", checkpoint_at=5400,
                  checkpoint_path=str(ck), **opts)
    a.run()
    b = _port_sim(tmp_path / "b", **opts)
    t0 = b.load_checkpoint(ck)
    assert t0 == 5400 and b._boundary is not None
    with np.load(ck) as d:
        assert all("bnd_" + f in d for f in tdf.BOUNDARY_FIELDS)
        assert {"creceptor", "flux", "acc_n_gridunc"} <= set(d.files)
    b.run(start_itime=t0)
    for f in FIELDS:
        assert torch.equal(getattr(a.particles, f), getattr(b.particles, f)), f
    for f in tdf.BOUNDARY_FIELDS:
        assert torch.equal(getattr(a._boundary, f), getattr(b._boundary, f)), f
    assert torch.stack(a.boundary_counts)[:, 3].sum() > 0
    for pattern in ("grid_conc_*.npz", "receptor_conc_*.npz",
                    "grid_flux_*.npz", "nest/grid_conc_*.npz"):
        files = sorted((tmp_path / "a").glob(pattern))
        assert len(files) == 2, pattern
        for f in files:
            ja, jb = np.load(f), np.load(tmp_path / "b" / f.relative_to(
                tmp_path / "a"))
            for k in ja.files:
                np.testing.assert_array_equal(ja[k], jb[k], err_msg=k)
    assert np.load(sorted((tmp_path / "a").glob(
        "receptor_conc_*.npz"))[0])["conc"].max() > 0


@pytest.mark.parametrize("md", [1, 2])
def test_global_fill_runs(md, tmp_path):
    """A global fill (no boundary) through the port's Simulation: the air
    mass of tests/test_domainfill.py (about 5.1e18 kg; MDOMAINFILL 2 keeps
    stratospheric particles only, with ozone-proxy masses)."""
    cmd, rel, og = _config(tconfig, box=GLOBE, mdomainfill=md, hours=1,
                           parts=20000)
    grid = make_grid(**GRID)
    from flexpart_tpu_torch.met import SyntheticMet
    sim = Simulation(cmd=cmd, releases=rel, grid=grid, outgrid=og,
                     outdir=str(tmp_path), met_backend=SyntheticMet(grid),
                     write_netcdf=False, write_npz=False, seed=SEED,
                     device="cpu")
    sim.run()
    assert sim._boundary is None and not sim.boundary_counts
    act = sim.particles.active
    if md == 1:
        assert 3.0e18 < sim.airmass_total < 7.0e18
        np.testing.assert_allclose(float(sim.particles.mass.double().sum()),
                                   sim.airmass_total, rtol=1e-3)
        assert float(act.double().mean()) > 0.98
    else:
        assert int(act.sum()) > 500
        assert float(sim.particles.mass[act].max()) < 1e12
        assert np.percentile(sim.particles.z[act].numpy(), 5) > 2500.0

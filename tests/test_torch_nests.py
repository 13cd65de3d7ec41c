"""Port parity: nested met grids.

  * ``test_nest_consistency`` mirrors ``tests/test_nests.py``: the
    synthetic atmosphere is analytic, so a nest made from the same formulas
    at 4x the resolution over the release area gives trajectories close to
    the mother-only run's (median within 0.1 grid units) that still differ
    (the nest was sampled).  The nested output grid of that test stays out:
    the port refuses ``outgrid_nest``.
  * ``test_innermost_nest_selection_multinest`` mirrors its namesake: with
    uniform winds of 5, 10 and 20 m/s on the mother, an outer and an inner
    nest and the turbulence off, a particle in both windows moves with the
    inner nest's wind, one in the outer only with the outer's, one outside
    with the mother's (ratios within 1e-3).
  * the port's plain advance with two nests against JAX's ``advance_all``
    with the same nests and JAX's draws injected, on 2048 particles, a third
    in each window: x, y within 1e-4 grid units, z within 1e-2 m + 1e-4
    relative, velocities within 1e-5 m/s + 1e-4 relative, the flags and
    counts equal (``tests/test_torch_advance.py``'s tolerances: float32
    transcendentals round differently in XLA and torch), and the share of
    the particles each nest samples; float32 tables (the cell sigma of a
    bfloat16 table can round to the neighbouring value in one package and
    not the other: measured once in 2048 particles, 0.5% of usig);
  * the refusals, as the reference's: nests with the adaptive step
    (``method=1``) and nests with the legacy-RNG path.
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

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox,  # noqa: E402
                                       Releases, Species)
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.legacy import LegacyRnd  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.met import (SyntheticMet, make_grid,  # noqa: E402
                                    uniform_wind_met)
from flexpart_tpu_torch.met import calcpar as tcalcpar  # noqa: E402
from flexpart_tpu_torch.met import verttransform as tvt  # noqa: E402
from flexpart_tpu_torch.run.simulation import (Simulation,  # noqa: E402
                                               nest_windows)

OG = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=90, numygrid=45,
             dxout=4.0, dyout=4.0, outheights=(500.0, 2000.0, 50000.0))
N = 2048
LSYNC = 900
MEM1 = 10800


def _run(tmp, with_nest: bool, seed=21):
    grid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=40000,
                  lsynctime=900, loutstep=3600, loutaver=3600,
                  loutsample=900, lconvection=0)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                     lon1=-50.0, lon2=-48.0, lat1=42.0, lat2=44.0,
                     z1=100.0, z2=1000.0, mass=(1.0,), parts=600)
    rel = Releases(species=(Species(),), boxes=(box,))
    kw = {}
    if with_nest:
        nest_grid = make_grid(nx=33, ny=17, nlev=15, dx=2.5, dy=2.5,
                              xlon0=-70.0, ylat0=30.0, xglobal=False)
        kw = dict(met_nests=(SyntheticMet(nest_grid),))
    sim = Simulation(cmd=cmd, releases=rel, grid=grid,
                     met_backend=SyntheticMet(grid), outgrid=OG,
                     outdir=str(tmp), write_netcdf=False, write_npz=True,
                     seed=seed, device="cpu", **kw)
    sim.run()
    return sim


def test_nest_consistency(tmp_path):
    simA = _run(tmp_path / "mother", with_nest=False)
    simB = _run(tmp_path / "nested", with_nest=True)
    # both runs keep the particles in cell order, so a slot may hold other
    # particles in the two: compare the sorted coordinates
    pa, pb = simA.particles, simB.particles
    assert int(pa.active.sum()) == int(pb.active.sum()) == 600
    xa, xb = np.sort(pa.x.numpy()), np.sort(pb.x.numpy())
    ya, yb = np.sort(pa.y.numpy()), np.sort(pb.y.numpy())
    assert np.median(np.abs(xa - xb)) < 0.1
    assert np.median(np.abs(ya - yb)) < 0.1
    assert not np.array_equal(xa, xb)
    assert simB.step_cfg.nests == ((33, 17),)
    assert sorted(Path(tmp_path / "nested").glob("grid_conc_*.npz"))


def _fields(grid, u, height=None):
    met = uniform_wind_met(grid, u=u, v=0.0)
    eta = met.fetch(0.0, "cpu")
    h = tvt.compute_heights(grid, eta) if height is None else height
    z = tvt.process_eta(grid, eta, h)
    return tcalcpar.calcpar(grid, eta, z), h


def test_innermost_nest_selection_multinest():
    mother = make_grid(nx=40, ny=30, nlev=12, dx=1.0, dy=1.0,
                       xlon0=0.0, ylat0=20.0, xglobal=False)
    z_m, height = _fields(mother, 5.0)
    # outer nest: lon 10..30 at dx=0.5; inner nest: lon 15..25 at 0.25
    outer = make_grid(nx=41, ny=21, nlev=12, dx=0.5, dy=0.5,
                      xlon0=10.0, ylat0=25.0, xglobal=False)
    z_o, _ = _fields(outer, 10.0, height)
    inner = make_grid(nx=41, ny=41, nlev=12, dx=0.25, dy=0.25,
                      xlon0=15.0, ylat0=28.0, xglobal=False)
    z_i, _ = _fields(inner, 20.0, height)
    cfg = tadv.StepConfig(nx=mother.nx, ny=mother.ny, nz=mother.nlev,
                          xglobal=False, ldirect=1, turbswitch=False,
                          ifine=1, method=0, turboff=True,
                          nests=((outer.nx, outer.ny), (inner.nx, inner.ny)))
    prm = tadv.StepParams.make(
        dx=1.0, dy=1.0, ylat0=20.0, dxconst=mother.dxconst,
        dyconst=mother.dyconst, lsynctime=900, fine=1.0,
        **nest_windows(mother, (outer, inner)))
    assert prm.xln == (10.0, 15.0) and prm.xresoln == (2.0, 4.0)
    n = 16
    p = empty_particles(n, device="cpu")
    p = p.replace(
        x_hi=torch.tensor([5.0, 12.0, 20.0] * 5 + [5.0]),   # none/outer/inner
        y_hi=torch.full((n,), 11.0), z=torch.full((n,), 500.0),
        itra=torch.zeros(n, dtype=torch.int32),
        active=torch.ones(n, dtype=torch.bool),
        mass=torch.ones((n, 1)))
    p2, _ = tadv.advance_all(p, z_m, z_m, 0, 0, 3600, trng.Key(0, 0), cfg,
                             prm, z0n=(z_o, z_i), z1n=(z_o, z_i))
    dxs = (p2.x - p.x).numpy()
    assert dxs[0] > 0
    np.testing.assert_allclose(dxs[1] / dxs[0], 2.0, rtol=1e-3)
    np.testing.assert_allclose(dxs[2] / dxs[0], 4.0, rtol=1e-3)
    a = tadv.advance_args(cfg, prm, 0, 0, 3600)
    assert tadv.nest_index(cfg, a, p.x, p.y)[:3].tolist() == [-1, 0, 1]


@pytest.fixture(scope="module")
def nested_met():
    """Mother 37x19 global at 10 degrees; two nests of SyntheticMet on its
    levels: 5 degrees over 40 W-60 E, 10-70 N and 2.5 degrees over 10 W-
    30 E, 30-60 N."""
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    outer = jmet.make_grid(nx=21, ny=13, nlev=15, dx=5.0, dy=5.0,
                           xlon0=-40.0, ylat0=10.0, xglobal=False)
    inner = jmet.make_grid(nx=17, ny=13, nlev=15, dx=2.5, dy=2.5,
                           xlon0=-10.0, ylat0=30.0, xglobal=False)
    height = jmet.compute_heights(grid, jmet.SyntheticMet(grid).fetch(0.0))
    out = {}
    for name, g in (("mother", grid), ("outer", outer), ("inner", inner)):
        m = jmet.SyntheticMet(g)
        out[name] = [jmet.calcpar(g, m.fetch(t), jmet.process_eta(
            g, m.fetch(t), height)) for t in (0.0, float(MEM1))]
    tz = {k: [interop.zfields_from_numpy(
        {f: np.asarray(v) for f, v in z._asdict().items()}, "cpu")
        for z in zs] for k, zs in out.items()}
    return grid, (outer, inner), out, tz


def _to_port_grid(g):
    return interop.metgrid_from_jax(g)


def test_two_nests_match_jax(nested_met):
    grid, nests, jz, tz = nested_met
    tgrid = _to_port_grid(grid)
    windows = nest_windows(tgrid, tuple(_to_port_grid(g) for g in nests))
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=1, turbswitch=False,
                           ifine=1, method=0, met_bf16=False,
                           nests=tuple((g.nx, g.ny) for g in nests))
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=1.0, **windows)
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    rs = np.random.default_rng(8)
    third = rs.integers(0, 3, N)
    # inner window: x 17-20, y 12-15; outer only: x 14-20, y 10-11.5
    x = np.where(third == 0, rs.uniform(17.2, 20.8, N),
                 np.where(third == 1, rs.uniform(14.2, 19.8, N),
                          rs.uniform(0.0, grid.nx - 1.0, N)))
    y = np.where(third == 0, rs.uniform(12.2, 14.8, N),
                 np.where(third == 1, rs.uniform(10.2, 11.5, N),
                          rs.uniform(0.3, grid.ny - 1.3, N)))
    p = jstate.empty_particles(N)
    p = p._replace(
        x_hi=jnp.asarray(x, jnp.float32), y_hi=jnp.asarray(y, jnp.float32),
        z=jnp.asarray(rs.uniform(5.0, 6000.0, N), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.zeros(N, jnp.int32),
        itramem=jnp.asarray(np.where(rs.uniform(size=N) < 0.5, LSYNC, -3600),
                            jnp.int32),
        mass=jnp.full((N, 1), 1.0 / N, jnp.float32))
    key = jax.random.PRNGKey(3)
    draws = {t: torch.from_numpy(np.array(jrng.normals(key, (r, N), tag=t)))
             for t, r in ((6, 6), (1, 2), (2, 1), (3, 3), (4, 3))}
    (j0, j1), zn0, zn1 = jz["mother"], (jz["outer"][0], jz["inner"][0]), \
        (jz["outer"][1], jz["inner"][1])
    jp, jd = jadv.advance_all(p, j0, j1, jnp.int32(LSYNC), jnp.int32(0),
                              jnp.int32(MEM1), key, jcfg, jprm, zn0, zn1)
    tp0 = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    tp, td = tadv.advance_all(
        tp0, tz["mother"][0], tz["mother"][1], LSYNC, 0, MEM1,
        trng.Key(1, 0), tcfg, tprm, draws=draws,
        z0n=(tz["outer"][0], tz["inner"][0]),
        z1n=(tz["outer"][1], tz["inner"][1]))
    a = interop.particles_to_numpy(tp)
    b = {k: np.asarray(v) for k, v in jp._asdict().items()}
    np.testing.assert_allclose(a["x_hi"] + a["x_lo"], b["x_hi"] + b["x_lo"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(a["y_hi"] + a["y_lo"], b["y_hi"] + b["y_lo"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(a["z"], b["z"], rtol=1e-4, atol=1e-2)
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("n_active", "n_exited"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f
    adv_args = tadv.advance_args(tcfg, tprm, LSYNC, 0, MEM1)
    idx = tadv.nest_index(tcfg, adv_args, tp0.x, tp0.y).numpy()
    assert (idx == 1).mean() > 0.25 and (idx == 0).mean() > 0.25
    # the nests moved the particles: without them the inner third differs
    mother_cfg = type(tcfg)(**{**tcfg.__dict__, "nests": ()})
    tm, _ = tadv.advance_all(tp0, tz["mother"][0], tz["mother"][1], LSYNC, 0,
                             MEM1, trng.Key(1, 0), mother_cfg, tprm,
                             draws=draws)
    assert not np.array_equal(tm.x.numpy()[idx == 1], tp.x.numpy()[idx == 1])
    np.testing.assert_array_equal(tm.x.numpy()[idx == -1],
                                  tp.x.numpy()[idx == -1])


def test_nests_refused_with_adaptive_step_and_legacy(nested_met):
    grid, nests, _, tz = nested_met
    cfg = tadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                          xglobal=True, ldirect=1, turbswitch=False,
                          ifine=1, method=0,
                          nests=tuple((g.nx, g.ny) for g in nests))
    with pytest.raises(ValueError, match="nested"):
        type(cfg)(**{**cfg.__dict__, "method": 1}).check()
    prm = tadv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0,
        **nest_windows(_to_port_grid(grid),
                       tuple(_to_port_grid(g) for g in nests)))
    p = empty_particles(16, device="cpu")
    leg = LegacyRnd(table=torch.zeros(11), nrand_init=torch.ones(16,
                    dtype=torch.int32), nrand=torch.ones(16, dtype=torch.int32))
    zn = (tz["outer"][0], tz["inner"][0])
    with pytest.raises(ValueError, match="legacy"):
        tadv.advance_all(p, tz["mother"][0], tz["mother"][1], 0, 0, MEM1,
                         trng.Key(0, 0), cfg, prm, z0n=zn, z1n=zn, leg=leg)
    tgrid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    nest = make_grid(nx=33, ny=17, nlev=15, dx=2.5, dy=2.5, xlon0=-70.0,
                     ylat0=30.0, xglobal=False)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=10000,
                  lsynctime=900, loutstep=3600, loutaver=3600,
                  loutsample=900)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                     lon1=-50.0, lon2=-48.0, lat1=42.0, lat2=44.0, z1=100.0,
                     z2=1000.0, mass=(1.0,), parts=16)
    kw = dict(cmd=cmd, releases=Releases(species=(Species(),), boxes=(box,)),
              grid=tgrid, met_backend=SyntheticMet(tgrid), outgrid=OG,
              device="cpu", met_nests=(SyntheticMet(nest),))
    with pytest.raises(ValueError, match="legacy"):
        Simulation(**kw, legacy_rng=True)
    with pytest.raises(ValueError, match="nested"):
        Simulation(**{**kw, "cmd": Command(**{**cmd.__dict__, "ctl": 5.0})})


# three windows that overlap without nesting: 5 degrees over 40 W-20 E,
# 10-50 N; 5 degrees over 0-60 E, 30-70 N; 2.5 degrees over 10-40 E,
# 0-40 N, the last partly outside both
OVERLAP = (dict(nx=13, ny=9, dx=5.0, dy=5.0, xlon0=-40.0, ylat0=10.0),
           dict(nx=13, ny=9, dx=5.0, dy=5.0, xlon0=0.0, ylat0=30.0),
           dict(nx=13, ny=17, dx=2.5, dy=2.5, xlon0=10.0, ylat0=0.0))


@pytest.fixture(scope="module")
def overlap_met(nested_met):
    """The nested_met mother and three SyntheticMet nests of OVERLAP on its
    levels, each with a jet of its own."""
    grid, _, jz, _ = nested_met
    height = jz["mother"][0].height
    nests = tuple(jmet.make_grid(nlev=15, xglobal=False, **spec)
                  for spec in OVERLAP)
    zn = []
    for k, g in enumerate(nests):
        m = jmet.SyntheticMet(g, u_jet=30.0 + 10.0 * k)
        zn.append([jmet.calcpar(g, m.fetch(t), jmet.process_eta(
            g, m.fetch(t), height)) for t in (0.0, float(MEM1))])
    tzn = [[interop.zfields_from_numpy(
        {f: np.asarray(v) for f, v in z._asdict().items()}, "cpu")
        for z in zs] for zs in zn]
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=1, turbswitch=False,
                           ifine=1, method=0, met_bf16=False,
                           nests=tuple((g.nx, g.ny) for g in nests))
    windows = nest_windows(_to_port_grid(grid),
                           tuple(_to_port_grid(g) for g in nests))
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=1.0, **windows)
    return jcfg, jprm, zn, tzn


def _edge_coords(a, k: int):
    """Nest k's four window thresholds as AdvanceArgs holds them,
    fl(xln + eps), fl(xrn - eps), fl(yln + eps), fl(yrn - eps), each with
    the float below and above it."""
    f32 = np.float32
    eps = f32(a.eps_nest)
    out = []
    for base, sign in ((a.xln[k], 1), (a.xrn[k], -1), (a.yln[k], 1),
                       (a.yrn[k], -1)):
        th = f32(f32(base) + f32(sign) * eps)
        out.append(np.array([np.nextafter(th, f32(-np.inf)), th,
                             np.nextafter(th, f32(np.inf))], f32))
    return out


def _jax_nest_index(jcfg, jprm, x, y):
    """JAX's selection, the where chain of its advance_all
    (core/advance.py:843-866): the last window that holds the particle."""
    eps_n = jnp.float32(jcfg.nx / 3.0e5)
    x, y = jnp.asarray(x), jnp.asarray(y)
    idx = jnp.full(x.shape, -1, jnp.int32)
    for k in range(len(jcfg.nests)):
        inn = ((x > jprm.xln[k] + eps_n) & (x < jprm.xrn[k] - eps_n)
               & (y > jprm.yln[k] + eps_n) & (y < jprm.yrn[k] - eps_n))
        idx = jnp.where(inn, k, idx)
    return np.asarray(idx)


def test_nest_index_a_float_from_each_edge(nested_met, overlap_met):
    """``nest_index`` (the grid K4 NESTS's nest_select picks) on each
    overlapping window's edges, at the threshold and a float on either
    side, across the other windows: JAX's where chain bit for bit; the
    threshold itself is outside (strict comparisons), the float inside it
    inside."""
    jcfg, jprm, _, _ = overlap_met
    tcfg = interop.step_config_from_jax(jcfg)
    a = tadv.advance_args(tcfg, interop.step_params_from_numpy(jprm), LSYNC,
                          0, MEM1)
    xs, ys = [], []
    for k in range(3):
        ex = np.concatenate(_edge_coords(a, k)[:2])
        ey = np.concatenate(_edge_coords(a, k)[2:])
        span_y = np.linspace(a.yln[k], a.yrn[k], 17, dtype=np.float32)
        span_x = np.linspace(a.xln[k], a.xrn[k], 17, dtype=np.float32)
        xs += [np.repeat(ex, 17), np.tile(span_x, 6)]
        ys += [np.tile(span_y, 6), np.repeat(ey, 17)]
    x, y = np.concatenate(xs), np.concatenate(ys)
    got = tadv.nest_index(tcfg, a, torch.as_tensor(x),
                          torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(got, _jax_nest_index(jcfg, jprm, x, y))
    # each window's left threshold: out at it, in a float above it (where
    # no later window holds the point, the index is the window's own)
    for k in range(3):
        th = _edge_coords(a, k)[0]
        mid_y = np.float32((a.yln[k] + a.yrn[k]) / 2.0)
        held = [tadv._in_nest(a, k, torch.tensor([v]), torch.tensor([mid_y]))
                for v in th]
        assert [bool(h) for h in held] == [False, False, True]
    assert set(np.unique(got)) == {-1, 0, 1, 2}


def test_overlapping_nests_match_jax(nested_met, overlap_met):
    """The port's plain advance with the three overlapping windows against
    JAX's ``advance_all`` with the same nests and JAX's draws injected, on
    2048 particles: a third over the windows' union, a third at their
    edges (a float from each threshold), a third anywhere;
    ``test_two_nests_match_jax``'s tolerances.  Particles in two or three
    windows take the last (``nest_index``, JAX's where chain), and those
    the last window holds move otherwise than with the mother's met."""
    grid, _, jz, tz = nested_met
    jcfg, jprm, zn, tzn = overlap_met
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    a = tadv.advance_args(tcfg, tprm, LSYNC, 0, MEM1)
    rs = np.random.default_rng(12)
    third = rs.integers(0, 3, N)
    # the union of the windows is x 14-22, y 9-16 in mother units
    x = np.where(third == 0, rs.uniform(14.0, 22.0, N),
                 rs.uniform(0.0, grid.nx - 1.0, N)).astype(np.float32)
    y = np.where(third == 0, rs.uniform(9.0, 16.0, N),
                 rs.uniform(0.3, grid.ny - 1.3, N)).astype(np.float32)
    edges = np.flatnonzero(third == 1)
    for j, i in enumerate(edges):
        k, side = j % 3, (j // 3) % 4
        v = _edge_coords(a, k)[side][(j // 12) % 3]
        if side < 2:
            x[i] = v
            y[i] = rs.uniform(a.yln[k], a.yrn[k])
        else:
            y[i] = v
            x[i] = rs.uniform(a.xln[k], a.xrn[k])
    p = jstate.empty_particles(N)
    p = p._replace(
        x_hi=jnp.asarray(x), y_hi=jnp.asarray(y),
        z=jnp.asarray(rs.uniform(5.0, 6000.0, N), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.zeros(N, jnp.int32),
        itramem=jnp.asarray(np.where(rs.uniform(size=N) < 0.5, LSYNC, -3600),
                            jnp.int32),
        mass=jnp.full((N, 1), 1.0 / N, jnp.float32))
    key = jax.random.PRNGKey(5)
    draws = {t: torch.from_numpy(np.array(jrng.normals(key, (r, N), tag=t)))
             for t, r in ((6, 6), (1, 2), (2, 1), (3, 3), (4, 3))}
    j0, j1 = jz["mother"]
    jp, jd = jadv.advance_all(p, j0, j1, jnp.int32(LSYNC), jnp.int32(0),
                              jnp.int32(MEM1), key, jcfg, jprm,
                              tuple(z[0] for z in zn),
                              tuple(z[1] for z in zn))
    tp0 = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    tp, td = tadv.advance_all(
        tp0, tz["mother"][0], tz["mother"][1], LSYNC, 0, MEM1,
        trng.Key(1, 0), tcfg, tprm, draws=draws,
        z0n=tuple(z[0] for z in tzn), z1n=tuple(z[1] for z in tzn))
    got = interop.particles_to_numpy(tp)
    want = {k: np.asarray(v) for k, v in jp._asdict().items()}
    np.testing.assert_allclose(got["x_hi"] + got["x_lo"],
                               want["x_hi"] + want["x_lo"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["y_hi"] + got["y_lo"],
                               want["y_hi"] + want["y_lo"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-4, atol=1e-2)
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("n_active", "n_exited"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f
    idx = tadv.nest_index(tcfg, a, tp0.x, tp0.y).numpy()
    np.testing.assert_array_equal(idx, _jax_nest_index(jcfg, jprm, x, y))
    held = np.stack([tadv._in_nest(a, k, tp0.x, tp0.y).numpy()
                     for k in range(3)])
    several = held.sum(0) >= 2
    assert several.sum() > 50 and (held.sum(0) == 3).sum() > 10
    last = np.where(held[2], 2, np.where(held[1], 1, np.where(held[0], 0,
                                                              -1)))
    np.testing.assert_array_equal(idx, last)
    # the last window's particles move with its jet, not the mother's
    mother_cfg = type(tcfg)(**{**tcfg.__dict__, "nests": ()})
    tm, _ = tadv.advance_all(tp0, tz["mother"][0], tz["mother"][1], LSYNC, 0,
                             MEM1, trng.Key(1, 0), mother_cfg, tprm,
                             draws=draws)
    moved = tm.x.numpy() != tp.x.numpy()
    assert moved[(idx == 2) & several].mean() > 0.9

"""Port parity: the adaptive time step (CTL > 0, ``method=1``).

The same 2048 particles (numpy, one seed; a multiple of 16) advance through
the JAX package's ``advance_all`` and the port's plain version on the same
synthetic met, ``ctl=5``, ``ifine=2``, with JAX's draws injected: tags 6, 3
and 4 as (rows, n), tags 1 and 2 per pass as (K, rows, n), pass k drawn
with ``fold_in(key, 9000 + k)`` (a particle is active in JAX's loop for one
unbroken run of passes from k = 0, so its pass j is JAX's pass j).

The next step ``ldt = trunc(min(...) * ctl)`` is a cliff: an ulp of its
argument can move ldt by a whole second, and the particle then takes other
passes.  So the agreement is stated as a distribution:
  * at least 99% of the particles have JAX's ``idt`` and pass count
    (measured: all of them);
  * over those: x, y within 1e-4 grid units, z within 1e-2 m + 1e-4
    relative, up, vp and the mesoscale memories within 1e-5 m/s + 1e-4
    relative, wp within 1e-4 + 1e-4 relative (the boundary layer's
    Langevin velocity goes through up to 7 passes of 2 substeps, each of
    which carries an ulp of XLA's exp or pow on: measured 3.3e-5 at most,
    99% of the particles within 2.6e-7, over four cases and three seeds),
    ``t_below`` within 1e-3 s, and cbt, active, itra equal (measured: x,
    y within 3.9e-6, z within 1.7e-3 m, t_below equal);
  * the rest (none measured) within the grid's extent and finite.

Also: ``_ldt_formula`` in both turbswitch forms, the port's own per-pass
Philox stream (bitwise equal to the draws ``rng.normals(pass_index=k)``
injected), chunks that give the same particles, the port of
``tests/test_core.py::test_well_mixed_adaptive_mode``, and
``apply_decay_drydep(t_below=...)`` against JAX (rtol 1e-6 on the mass,
1e-5 on the deposit, as ``tests/test_torch_massupdate.py``).
"""
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
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import hanna as jhanna  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.physics import massupdate as jmu  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import hanna as thanna  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.met import calcpar as tcalcpar  # noqa: E402
from flexpart_tpu_torch.met import synthetic as tsyn  # noqa: E402
from flexpart_tpu_torch.met import verttransform as tvt  # noqa: E402
from flexpart_tpu_torch.physics import massupdate as tmu  # noqa: E402

N = 2048
LSYNC = 900
MEM1 = 10800
IFINE = 2
PASSES = 64          # injected passes (the run takes at most 7)
TAGS = {6: 6, 3: 3, 4: 3}


@pytest.fixture(scope="module")
def met():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (0.0, float(MEM1)):
        eta = m.fetch(t)
        h = jmet.compute_heights(grid, eta)
        zs.append(jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h)))
    tz = [interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                      z._asdict().items()}, "cpu") for z in zs]
    return grid, zs, tz


def _particles(grid, seed=42):
    """Two species from two release points; z mostly in the boundary
    layer; some fresh, some with an idt of an earlier step."""
    rs = np.random.default_rng(seed)
    mass0 = np.zeros((N, 2), np.float32)
    first = rs.uniform(size=N) < 0.5
    mass0[first, 0] = 1.0
    mass0[~first, 1] = 1.0
    p = jstate.empty_particles(N, nspec=2)
    return p._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, grid.nx - 1.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.3, grid.ny - 1.3, N), jnp.float32),
        z=jnp.asarray(np.where(rs.uniform(size=N) < 0.7,
                               rs.uniform(5.0, 400.0, N),
                               rs.uniform(400.0, 3000.0, N)), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.zeros(N, jnp.int32),
        itramem=jnp.asarray(np.where(rs.uniform(size=N) < 0.5, LSYNC, -3600),
                            jnp.int32),
        idt=jnp.asarray(rs.integers(0, 300, N), jnp.int32),
        up=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        vp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        wp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        mass=jnp.asarray(mass0), mass0=jnp.asarray(mass0))


def _cfgs(grid, turbswitch=True, **kw):
    sp = [jconfig.Species(density=2500.0, dquer=10.0, dsigma=1.25),
          jconfig.Species()]
    scs = [s.size_classes() for s in sp]
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=1, turbswitch=turbswitch,
                           ifine=IFINE, method=1, nspec=2, **kw)
    jprm = jadv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0 / IFINE, ctl=5.0,
        sp_density=[max(s.density, -1.0) for s in sp],
        sp_dquer=[s.dquer for s in sp],
        sp_cunningham=[c.cunningham if c else 0.0 for c in scs],
        sp_vsetaver=[c.vsetaver if c else 0.0 for c in scs])
    return (jcfg, jprm, interop.step_config_from_jax(jcfg),
            interop.step_params_from_numpy(jprm))


def jax_draws(key, n, ifine, passes=PASSES):
    """JAX's draws of one adaptive step: (rows, n) for tags 6, 3, 4 and,
    stacked over the passes by one vmap, (K, rows, n) for tags 1 and 2."""
    ks = jnp.arange(passes)
    out = {t: np.asarray(jrng.normals(key, (r, n), tag=t))
           for t, r in TAGS.items()}
    for tag, rows in ((1, 2), (2, ifine)):
        out[tag] = np.asarray(jax.vmap(lambda k: jrng.normals(
            jax.random.fold_in(key, 9000 + k), (rows, n), tag=tag))(ks))
    return {t: torch.from_numpy(np.array(v)) for t, v in out.items()}


@pytest.mark.parametrize("turbswitch", [True, False])
def test_ldt_formula_matches_jax(turbswitch):
    rs = np.random.default_rng(5)
    n = 512
    z = rs.uniform(1.0, 2000.0, n).astype(np.float32)
    h = rs.uniform(200.0, 2500.0, n).astype(np.float32)
    ust = rs.uniform(0.05, 0.8, n).astype(np.float32)
    wst = rs.uniform(0.0, 2.5, n).astype(np.float32)
    ol = rs.choice([-50.0, -500.0, 80.0, 3000.0], n).astype(np.float32)
    wp = rs.uniform(-2.0, 2.0, n).astype(np.float32)
    jfn = jhanna.hanna if turbswitch else jhanna.hanna1
    tfn = thanna.hanna if turbswitch else thanna.hanna1
    jt = jfn(*(jnp.asarray(a) for a in (z, h, ust, wst, ol)))
    tt = tfn(*(torch.from_numpy(a) for a in (z, h, ust, wst, ol)))
    jcfg = jadv.StepConfig(nx=4, ny=4, nz=4, xglobal=False, ldirect=1,
                           turbswitch=turbswitch, ifine=1, method=1)
    jprm = jadv.StepParams.make(1.0, 1.0, 0.0, 1.0, 1.0, LSYNC, 1.0, ctl=5.0)
    j = np.asarray(jadv._ldt_formula(jcfg, jprm, jt, jnp.asarray(wp),
                                     jnp.asarray(h)))
    a = tadv.advance_args(interop.step_config_from_jax(jcfg),
                          interop.step_params_from_numpy(jprm), 0, 0, 3600)
    t = tadv._ldt_formula(interop.step_config_from_jax(jcfg), a, tt,
                          torch.from_numpy(wp), torch.from_numpy(h)).numpy()
    assert (t >= 1.0).all() and (t == np.trunc(t)).all()
    # the cliff: equal but where an ulp of the argument crosses an integer
    assert (t == j).mean() >= 0.99 and np.abs(t - j).max() <= 1.0


ADAPTIVE = {"stock": dict(),
            "settling": dict(settling=True),
            "turboff": dict(turboff=True),
            "hanna1_settling_polar": dict(turbswitch=False, settling=True,
                                          polar=True)}


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_adaptive_step_matches_jax(met, name):
    grid, (j0, j1), (t0, t1) = met
    jcfg, jprm, tcfg, tprm = _cfgs(grid, **ADAPTIVE[name])
    assert (tcfg.method, tcfg.mintime) == (1, 1.0)
    p = _particles(grid)
    key = jax.random.PRNGKey(5)
    itime = LSYNC
    jp, jd = jadv.advance_all(p, j0, j1, jnp.int32(itime), jnp.int32(0),
                              jnp.int32(MEM1), key, jcfg, jprm)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    tq, td = tadv.advance_all(tp, t0, t1, itime, 0, MEM1, trng.Key(5, 1),
                              tcfg, tprm, draws=jax_draws(key, N, IFINE))
    a = interop.particles_to_numpy(tq)
    b = {k: np.asarray(v) for k, v in jp._asdict().items()}
    passes = td.passes.numpy()
    assert passes.max() >= 3 and (passes > 0).sum() > N // 4
    same = a["idt"] == b["idt"]
    assert same.mean() >= 0.99, same.mean()
    for c in ("x", "y"):
        d = np.abs((a[c + "_hi"] + a[c + "_lo"]) - (b[c + "_hi"] + b[c + "_lo"]))
        assert d[same].max() <= 1e-4, (c, d[same].max())
    dz = np.abs(a["z"] - b["z"])
    assert (dz[same] <= 1e-2 + 1e-4 * np.abs(b["z"][same])).all(), dz.max()
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        d = np.abs(a[f] - b[f])
        atol = 1e-4 if f == "wp" else 1e-5
        assert (d[same] <= atol + 1e-4 * np.abs(b[f][same])).all(), \
            (f, d.max())
    tb = np.abs(td.t_below.numpy() - np.asarray(jd.t_below))
    assert tb[same].max() <= 1e-3 and (np.asarray(jd.t_below) > 0).any()
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f][same], b[f][same], err_msg=f)
    assert np.isfinite(a["z"]).all() and (a["z"] >= 0.0).all()
    for f in ("n_active", "n_exited", "nan_count"):
        assert abs(int(getattr(td, f)) - int(getattr(jd, f))) \
            <= (~same).sum(), f
    if tcfg.turboff:
        assert float(np.abs(a["usig"][a["active"]]).max()) == 0.0


def test_own_per_pass_draws_are_rng_normals_with_the_pass(met):
    """Without injected draws the adaptive step draws tags 1 and 2 of pass k
    from the Philox counter (index, q, k, 0): bitwise the step fed
    ``rng.normals(key, (rows, n), tag, offset, pass_index=k)``; another
    pass index gives other numbers."""
    grid, _, (t0, t1) = met
    _, _, tcfg, tprm = _cfgs(grid)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in _particles(grid, 7)._asdict().items()},
        "cpu")
    key, off = trng.Key(31, 4), 5 * N
    rows = {6: 6, 1: 2, 2: IFINE, 3: 3, 4: 3}
    inj = {t: trng.normals(key, (r, N), t, off, device="cpu")
           for t, r in rows.items() if t not in tadv.PASS_TAGS}
    for t in tadv.PASS_TAGS:
        inj[t] = torch.stack([trng.normals(key, (rows[t], N), t, off,
                                           device="cpu", pass_index=k)
                              for k in range(16)])
    a, da = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                             offset=off)
    b, db = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                             draws=inj, offset=off)
    a, b = interop.particles_to_numpy(a), interop.particles_to_numpy(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert torch.equal(da.passes, db.passes) and torch.equal(da.t_below,
                                                            db.t_below)
    k0, k1 = key.philox_key(1)
    assert not torch.equal(trng.normals_plain(2, 64, k0, k1, 0, "cpu", 1),
                           trng.normals_plain(2, 64, k0, k1, 0, "cpu", 0))
    # too few injected passes raise; they never wrap around
    short = {**inj, 1: inj[1][:1], 2: inj[2][:1]}
    with pytest.raises(ValueError, match="passes"):
        tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                         draws=short, offset=off)


def test_chunks_give_the_same_adaptive_step(met):
    """The per-pass counter holds the global index: 1 and 4 chunks give
    the same particles, t_below and passes, bitwise."""
    grid, _, (t0, t1) = met
    _, _, tcfg, tprm = _cfgs(grid, settling=True)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in _particles(grid, 9)._asdict().items()},
        "cpu")
    outs = []
    for n_chunks in (1, 4):
        q, d = tadv.advance_chunked(tp, t0, t1, LSYNC, 0, MEM1,
                                    trng.Key(77, 1), tcfg, tprm, n_chunks)
        outs.append((interop.particles_to_numpy(q), d))
    (a, da), (b, db) = outs
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert torch.equal(da.t_below, db.t_below)
    assert torch.equal(da.passes, db.passes)


def test_well_mixed_adaptive_mode():
    """Adaptive per-particle time stepping (method=1, ctl=5) must also
    preserve a well-mixed PBL distribution: the port of
    ``tests/test_core.py::test_well_mixed_adaptive_mode`` on the port's own
    Philox stream."""
    from flexpart_tpu_torch.met.fields import F2_HMIX
    grid = tsyn.make_grid(nx=40, ny=30, nlev=15, dx=1.0, dy=1.0,
                          xlon0=0.0, ylat0=20.0, xglobal=False)
    eta = tsyn.uniform_wind_met(grid, u=10.0, v=0.0).fetch(0.0, "cpu")
    height = tvt.compute_heights(grid, eta)
    z0 = tcalcpar.calcpar(grid, eta, tvt.process_eta(grid, eta, height))
    cfg = tadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                          xglobal=grid.xglobal, ldirect=1, turbswitch=True,
                          ifine=2, method=1)
    prm = tadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                               dxconst=grid.dxconst, dyconst=grid.dyconst,
                               lsynctime=900, fine=0.5, ctl=5.0)
    n = 4000
    hmix = float(z0.f2d[F2_HMIX][15, 20])
    gen = torch.Generator().manual_seed(17)
    p = empty_particles(n, device="cpu").replace(
        x_hi=torch.full((n,), 20.0), y_hi=torch.full((n,), 15.0),
        z=torch.rand(n, generator=gen) * hmix,
        active=torch.ones(n, dtype=torch.bool),
        itra=torch.zeros(n, dtype=torch.int32))
    itime = 0
    for step in range(12):
        p, diag = tadv.advance_all(p, z0, z0, itime, 0, 86400,
                                   trng.Key(17, step), cfg, prm)
        itime += 900
    assert int(diag.passes.max()) > 1
    zeta = p.z.numpy()[p.active.numpy()] / hmix
    zeta = zeta[zeta <= 1.0]
    counts, _ = np.histogram(zeta, bins=4, range=(0, 1))
    frac = counts / counts.sum()
    assert np.all(np.abs(frac - 0.25) < 0.07), frac


def test_decay_drydep_with_t_below_matches_jax():
    """After an adaptive step the dry deposition takes the seconds below
    2 HREF: prob = 1 - exp(-vd t_below / 2 HREF), no height test; a
    particle with t_below 0 deposits nothing."""
    rs = np.random.default_rng(11)
    nx, ny, n = 37, 19, 2048
    mass0 = rs.uniform(0.5, 1.5, (n, 2)).astype(np.float32)
    mass = (mass0 * rs.uniform(0.3, 1.0, (n, 2))).astype(np.float32)
    p = jstate.empty_particles(n, nspec=2)._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, nx - 1.0, n), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.0, ny - 1.0, n), jnp.float32),
        z=jnp.asarray(rs.uniform(0.0, 3000.0, n), jnp.float32),
        active=jnp.asarray(rs.uniform(size=n) < 0.9),
        mass=jnp.asarray(mass), mass0=jnp.asarray(mass0))
    vdep = rs.uniform(0.0, 0.02, (2, ny, nx)).astype(np.float32)
    t_below = np.where(rs.uniform(size=n) < 0.3, 0.0,
                       np.trunc(rs.uniform(0.0, 900.0, n))).astype(np.float32)
    sp = dict(decay=(0.693147 / 7200.0, -1.0), drydep=(True, False),
              minmass=1.0e-4)
    jq, jdep = jmu.apply_decay_drydep(p, jnp.asarray(vdep), jnp.int32(900),
                                      jnp.int32(600), jmu.MassSpecies(**sp),
                                      has_vdep=True,
                                      t_below=jnp.asarray(t_below))
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    tq, tdep = tmu.apply_decay_drydep(tp, torch.from_numpy(vdep), 900, 600,
                                      tmu.MassSpecies(**sp), has_vdep=True,
                                      t_below=torch.from_numpy(t_below))
    np.testing.assert_allclose(tq.mass.numpy(), np.asarray(jq.mass),
                               rtol=1e-6)
    np.testing.assert_allclose(tdep.numpy(), np.asarray(jdep), rtol=1e-5,
                               atol=1e-30)
    np.testing.assert_array_equal(tq.active.numpy(), np.asarray(jq.active))
    dep = tdep.numpy()
    assert (dep[0][t_below == 0.0] == 0.0).all()
    assert (dep[0][(t_below > 0) & np.asarray(p.active)] > 0.0).all()
    assert (dep[1] == 0.0).all()            # the species without drydep

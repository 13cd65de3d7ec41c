"""Port parity: every fixed step the reference takes, and the adaptive step
with the CBL and turbswitch off.

The plain advance against the JAX package's ``advance_all`` on
``tests/test_torch_cbl.py``'s convective met (SyntheticMet on 37 x 19 x
15, -h/L = 60 east of the middle column, 1.25 west of it) with JAX's draws
injected (``test_torch_cbl._jax_draws``: tags 6, 1, 2, 3, 4 and the CBL's
7, 8 and 40 + i), on its boundary-layer particles:

  * the fixed step with ``cblflag``, turbswitch on and off (ifine 4, a
    substep of 225 s: both sides of the dtftlw < 0.5 switch), held to
    ``test_cbl_fixed_step_matches_jax``'s tolerances: x, y within 1e-4
    cells; z within 1e-2 m + 1e-4 z and the velocities within 1e-4 m/s +
    1e-3 relative for 99% of the particles, every particle within 1 m and
    1e-2 m/s; cbt, active, itra, the counts and ``nan_count`` equal.
    Without turbswitch the fresh state and the horizontal OU take hanna1,
    the substeps hanna (flexpart_tpu/core/advance.py:308, :900, :1020);
  * turbswitch on (ifine 4) with settling (a third of the particles a
    10 um aerosol), with two nests (``test_torch_nests``' windows, float32
    tables) and on tile 0 of 2 x 2, each held to the same tolerances;
  * a tile's step with ``cblflag``;
  * the adaptive step with ``cblflag`` and turbswitch off (ctl 2, ifine 4),
    held to ``test_cbl_adaptive_step_matches_jax``'s tolerances: at least
    98% of the particles with JAX's idt, over those x, y within 1e-4 and z
    within 1e-2 m + 1e-4 z for 99%, the counts and ``nan_count`` equal.

A tile's step is held against JAX's serial step of its particles (those
that start in tile 0's own cells, away from its edges: none wraps or
mirrors), which is the reference tile's body (``make_tiled_advance`` draws
from its own keys and takes no injected draws).  The settling and the CBL
runs of JAX serve both their serial and their tile case, so the file adds
four JAX programs (the CBL with turbswitch, test_torch_cbl's, is a fifth
one it shares).

Without JAX: every cross runs through ``advance_all`` on CPU tensors with
the port's own draws; the refusals that stay on the card raise ValueError
by name before any tensor is read; and each cross is counted by its entry
of ``_build.ENTRIES``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import test_torch_cbl as tc  # noqa: E402
from test_torch_cbl import met  # noqa: E402,F401
from test_torch_nests import nested_met  # noqa: E402,F401
from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu_torch import _build, interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.parallel import tiles as ttiles  # noqa: E402
from flexpart_tpu_torch.parallel.sharding import Layout  # noqa: E402
from flexpart_tpu_torch.run.simulation import nest_windows  # noqa: E402

N = tc.N
LSYNC, MEM1 = tc.LSYNC, tc.MEM1
IFINE = 4
MESH = (2, 2)
HALO = 3


def _cfgs(grid, method=0, **kw):
    """Both packages' StepConfig and StepParams of a step on ``grid``
    (ifine 4; ``kw`` the JAX StepConfig's fields and the settling
    parameters and nest windows of StepParams)."""
    prm_kw = {k: kw.pop(k) for k in list(kw) if k.startswith(("sp_", "x",
                                                              "y"))}
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=1, ifine=IFINE,
                           method=method, **kw)
    jprm = jadv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0 / IFINE,
        ctl=tc.ADAPTIVE_CTL if method == 1 else -5.0, **prm_kw)
    return (jcfg, jprm, interop.step_config_from_jax(jcfg),
            interop.step_params_from_numpy(jprm))


def _aerosol_params():
    """The settling parameters of a gas (species 0) and a 10 um aerosol
    (species 1), as the Simulation fills them."""
    sp = (jconfig.Species(), jconfig.Species(density=2500.0, dquer=10.0,
                                             dsigma=1.25))
    cs = [s.size_classes() for s in sp]
    return dict(sp_density=[max(s.density, -1.0) for s in sp],
                sp_dquer=[s.dquer for s in sp],
                sp_cunningham=[c.cunningham if c else 0.0 for c in cs],
                sp_vsetaver=[c.vsetaver if c else 0.0 for c in cs])


def _with_aerosol(p, seed=5):
    """p carrying two species, a third of the particles the aerosol."""
    rs = np.random.default_rng(seed)
    aero = rs.uniform(size=N) < 1.0 / 3.0
    m = np.zeros((N, 2), np.float32)
    m[:, 0] = np.where(aero, 0.0, 1.0 / N)
    m[:, 1] = np.where(aero, 1.0 / N, 0.0)
    return p._replace(mass=jnp.asarray(m), mass0=jnp.asarray(m),
                      xscav=jnp.zeros((N, 2), jnp.float32))


def _np(p):
    return {k: np.asarray(v) for k, v in p._asdict().items()}


def _hold(a, b, counts=None, jd=None):
    """tests/test_torch_cbl.py::test_cbl_fixed_step_matches_jax's
    tolerances, on the port's fields ``a`` and JAX's ``b`` (numpy dicts);
    the counts of the port's diag ``counts`` against JAX's ``jd``."""
    np.testing.assert_allclose(a["x_hi"] + a["x_lo"], b["x_hi"] + b["x_lo"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(a["y_hi"] + a["y_lo"], b["y_hi"] + b["y_lo"],
                               rtol=0, atol=1e-4)
    dz = np.abs(a["z"] - b["z"])
    assert np.mean(dz <= 1e-2 + 1e-4 * np.abs(b["z"])) >= 0.99
    assert dz.max() <= 1.0
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        dv = np.abs(a[f] - b[f])
        assert np.mean(dv <= 1e-4 + 1e-3 * np.abs(b[f])) >= 0.99, f
        assert dv.max() <= 1e-2, f
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    if counts is not None:
        for f in ("n_active", "n_exited", "nan_count"):
            assert int(getattr(counts, f)) == int(getattr(jd, f)), f


def _fixed(met, seed=42, aerosol=False, **kw):
    """One fixed step of both packages from the same particles and JAX's
    draws: (jcfg, tcfg, tprm, particles, JAX's out, JAX's diag, draws,
    the port's out, its diag)."""
    grid, (j0, j1), (t0, t1) = met
    jcfg, jprm, tcfg, tprm = _cfgs(grid, **kw)
    p = tc._particles(grid, seed)
    if aerosol:
        p = _with_aerosol(p)
    key = jax.random.PRNGKey(seed)
    jq, jd = jadv.advance_all(p, j0, j1, jnp.int32(LSYNC), jnp.int32(0),
                              jnp.int32(MEM1), key, jcfg, jprm)
    draws = tc._jax_draws(key, IFINE, 0)
    tq, td = tadv.advance_all(tc._port(p), t0, t1, LSYNC, 0, MEM1,
                              trng.Key(1, 0), tcfg, tprm, draws=draws)
    return dict(tcfg=tcfg, tprm=tprm, p=p, jq=_np(jq), jd=jd, draws=draws,
                tq=interop.particles_to_numpy(tq), td=td)


@pytest.fixture(scope="module", params=[True, False],
                ids=["turbswitch", "no_turbswitch"])
def cbl_fixed(met, request):
    return _fixed(met, turbswitch=request.param, cblflag=True)


@pytest.fixture(scope="module")
def ts_settling(met):
    return _fixed(met, seed=44, aerosol=True, turbswitch=True,
                  settling=True, nspec=2, **_aerosol_params())


def test_fixed_cbl_matches_jax(met, cbl_fixed):
    """The fixed step with the skewed CBL, turbswitch on and off, against
    JAX's; half the particles start in the skewed east."""
    r = cbl_fixed
    assert 0.3 < tc._skewed(r["p"], met) < 0.6
    _hold(r["tq"], r["jq"], r["td"], r["jd"])


def test_ts_settling_matches_jax(ts_settling):
    """Turbswitch with settling: the aerosol ends lower than it would
    without, as JAX's."""
    r = ts_settling
    _hold(r["tq"], r["jq"], r["td"], r["jd"])
    assert r["tcfg"].turbswitch and r["tcfg"].settling


def test_ts_nests_match_jax(nested_met):
    """Turbswitch with test_torch_nests' two windows (float32 tables), a
    third of the particles in the inner one, a third in the outer only."""
    grid, nests, jz, tz = nested_met
    tgrid = interop.metgrid_from_jax(grid)
    windows = nest_windows(tgrid, tuple(interop.metgrid_from_jax(g)
                                        for g in nests))
    jcfg, jprm, tcfg, tprm = _cfgs(
        grid, turbswitch=True, met_bf16=False,
        nests=tuple((g.nx, g.ny) for g in nests), **windows)
    rs = np.random.default_rng(8)
    third = rs.integers(0, 3, N)
    x = np.where(third == 0, rs.uniform(17.2, 20.8, N),
                 np.where(third == 1, rs.uniform(14.2, 19.8, N),
                          rs.uniform(0.0, grid.nx - 1.0, N)))
    y = np.where(third == 0, rs.uniform(12.2, 14.8, N),
                 np.where(third == 1, rs.uniform(10.2, 11.5, N),
                          rs.uniform(0.3, grid.ny - 1.3, N)))
    p = tc._particles(grid, 46)._replace(
        x_hi=jnp.asarray(x, jnp.float32), y_hi=jnp.asarray(y, jnp.float32))
    key = jax.random.PRNGKey(46)
    (j0, j1), zn0, zn1 = jz["mother"], (jz["outer"][0], jz["inner"][0]), \
        (jz["outer"][1], jz["inner"][1])
    jq, jd = jadv.advance_all(p, j0, j1, jnp.int32(LSYNC), jnp.int32(0),
                              jnp.int32(MEM1), key, jcfg, jprm, zn0, zn1)
    tq, td = tadv.advance_all(
        tc._port(p), tz["mother"][0], tz["mother"][1], LSYNC, 0, MEM1,
        trng.Key(1, 0), tcfg, tprm, draws=tc._jax_draws(key, IFINE, 0),
        z0n=(tz["outer"][0], tz["inner"][0]),
        z1n=(tz["outer"][1], tz["inner"][1]))
    idx = tadv.nest_index(tcfg, tadv.advance_args(tcfg, tprm, LSYNC, 0, MEM1),
                          tc._port(p).x, tc._port(p).y).numpy()
    assert (idx == 0).mean() > 0.2 and (idx == 1).mean() > 0.2
    _hold(interop.particles_to_numpy(tq), _np(jq), td, jd)


def _tile0(met, r):
    """The port's step of tile 0 of a 2 x 2 split on the particles of run
    ``r`` that start in the tile's own cells a cell or more from its
    edges, with their draws: (their indices, the port's out as numpy)."""
    grid, _, (t0, t1) = met
    eng = ttiles.TiledEngine(Layout(4, 0), r["tcfg"],
                             interop.metgrid_from_jax(grid), *MESH, HALO)
    x0, y0 = eng.tile.ox + HALO, eng.tile.oy + HALO
    p = tc._port(r["p"])
    inside = ((p.x >= x0 + 1.0) & (p.x < x0 + eng.tx - 1.0)
              & (p.y >= y0 + 1.0) & (p.y < y0 + eng.ty - 1.0))
    idx = torch.nonzero(inside).flatten()
    assert len(idx) >= 64
    q = p.replace(**{f: getattr(p, f)[idx] for f in FIELDS})
    draws = {t: v[..., idx].contiguous() for t, v in r["draws"].items()}
    tq, td = tadv.advance_all(q, eng.decompose(t0), eng.decompose(t1), LSYNC,
                              0, MEM1, trng.Key(1, 0), eng.cfg, r["tprm"],
                              draws=draws, tile=eng.tile)
    assert eng.cfg.tile_mode
    return idx.numpy(), interop.particles_to_numpy(tq), td


def test_ts_tile_matches_jax(met, ts_settling):
    """Turbswitch (with settling) on tile 0 of 2 x 2 against JAX's serial
    step of the same particles."""
    idx, a, _ = _tile0(met, ts_settling)
    _hold(a, {f: v[idx] for f, v in ts_settling["jq"].items()})


def test_cbl_tile_matches_jax(met, cbl_fixed):
    """The fixed step with the skewed CBL on tile 0 of 2 x 2 against JAX's
    serial step of the same particles."""
    idx, a, td = _tile0(met, cbl_fixed)
    _hold(a, {f: v[idx] for f, v in cbl_fixed["jq"].items()})
    # every scheduled particle of the tile kept
    assert int(td.n_active) == int(np.asarray(cbl_fixed["p"].active)[idx]
                                   .sum())


def test_cbl_adaptive_turbswitch_off_matches_jax(met):
    """The adaptive step with the skewed CBL and turbswitch off: the fresh
    state and the first step from hanna1, the passes' horizontal OU and
    substeps from hanna, each next step by hanna1's formula."""
    grid, (j0, j1), (t0, t1) = met
    jcfg, jprm, tcfg, tprm = _cfgs(grid, method=1, turbswitch=False,
                                   cblflag=True)
    p = tc._particles(grid, 48)
    key = jax.random.PRNGKey(48)
    jq, jd = jadv.advance_all(p, j0, j1, jnp.int32(LSYNC), jnp.int32(0),
                              jnp.int32(MEM1), key, jcfg, jprm)
    tq, td = tadv.advance_all(tc._port(p), t0, t1, LSYNC, 0, MEM1,
                              trng.Key(1, 0), tcfg, tprm,
                              draws=tc._jax_draws(key, IFINE, 1))
    a, b = interop.particles_to_numpy(tq), _np(jq)
    same = (a["idt"] == b["idt"]) & a["active"]
    assert same.mean() >= 0.98 * a["active"].mean()
    for f in ("x", "y"):
        np.testing.assert_allclose((a[f + "_hi"] + a[f + "_lo"])[same],
                                   (b[f + "_hi"] + b[f + "_lo"])[same],
                                   rtol=0, atol=1e-4)
    dz = np.abs(a["z"] - b["z"])[same]
    assert np.mean(dz <= 1e-2 + 1e-4 * np.abs(b["z"][same])) >= 0.99
    for f in ("n_active", "n_exited", "nan_count"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f


# ---- without JAX: every cross on CPU tensors, the refusals, the entries

CROSSES = {
    "cbl": dict(turbswitch=True, cblflag=True),
    "cbl_no_turbswitch": dict(turbswitch=False, cblflag=True),
    "cbl_settling": dict(turbswitch=True, cblflag=True, settling=True),
    "cbl_nests": dict(turbswitch=False, cblflag=True, nests=True),
    "cbl_tile": dict(turbswitch=True, cblflag=True, tile=True),
    "cbl_tile_settling_polar": dict(turbswitch=False, cblflag=True,
                                    tile=True, settling=True, polar=True),
    "ts_settling": dict(turbswitch=True, settling=True),
    "ts_nests_settling_polar": dict(turbswitch=True, nests=True,
                                    settling=True, polar=True),
    "ts_tile": dict(turbswitch=True, tile=True),
    "adaptive_cbl_no_turbswitch": dict(turbswitch=False, cblflag=True,
                                       method=1),
}


@pytest.mark.parametrize("name", list(CROSSES))
def test_every_cross_runs_on_cpu_tensors(met, name):
    """Each cross the reference's step takes runs through ``advance_all``
    on CPU tensors with the port's own draws: every particle kept and
    finite, the NaN redraws counted; with nests (a 17 x 13 window of the
    mother's own fields) and on tile 0 of 2 x 2."""
    kw = dict(CROSSES[name])
    grid, _, (t0, t1) = met
    tgrid = interop.metgrid_from_jax(grid)
    nests, tile = kw.pop("nests", False), kw.pop("tile", False)
    cfg = tadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                          ldirect=1, ifine=IFINE, method=kw.pop("method", 0),
                          nests=((grid.nx, grid.ny),) if nests else (),
                          **kw)
    sp = _aerosol_params()
    prm = tadv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0 / IFINE,
        ctl=tc.ADAPTIVE_CTL if cfg.method == 1 else -5.0,
        xln=0.0, yln=0.0, xrn=grid.nx - 1.0, yrn=grid.ny - 1.0,
        **(sp if cfg.settling else {}))
    p = tc._port(_with_aerosol(tc._particles(grid, 50))
                 if cfg.settling else tc._particles(grid, 50))
    extra = {}
    z0, z1 = t0, t1
    if nests:
        extra = dict(z0n=(t0,), z1n=(t1,))
    if tile:
        eng = ttiles.TiledEngine(Layout(4, 0), cfg, tgrid, *MESH, HALO)
        cfg, z0, z1 = eng.cfg, eng.decompose(t0), eng.decompose(t1)
        extra = dict(tile=eng.tile)
    q, d = tadv.advance_all(p, z0, z1, LSYNC, 0, MEM1, trng.Key(3, 1), cfg,
                            prm, **extra)
    assert int(d.n_active) + int(d.n_exited) == int(p.active.sum())
    live = q.active
    for f in ("x_hi", "y_hi", "z", "wp"):
        assert torch.isfinite(getattr(q, f)[live]).all(), f
    assert int(d.nan_count) >= 0
    if not tile:
        assert int(d.n_exited) == 0


def test_card_refusals_name_what_they_refuse():
    """What K4 and K11 do not take is refused by name with ValueError, by
    the argument check that runs before any tensor is read: injected draws
    with the CBL (its substeps draw in registers) and more substeps than
    MAX_CBL_SUBSTEPS; K11 takes the CBL with turbswitch off."""
    base = dict(nx=8, ny=8, nz=4, xglobal=True, ldirect=1, turbswitch=False,
                ifine=4)
    for method, run in ((0, tadv.advance_all_cuda),
                        (1, tadv.advance_adaptive_cuda)):
        cbl = tadv.StepConfig(method=method, cblflag=True, **base)
        with pytest.raises(ValueError, match="cblflag.*injected draws"):
            run(None, None, None, None, None, cbl, {}, 0)
        deep = tadv.StepConfig(**{**cbl.__dict__, "ifine":
                                  tadv.MAX_CBL_SUBSTEPS + 1})
        with pytest.raises(ValueError, match="MAX_CBL_SUBSTEPS"):
            run(None, None, None, None, None, deep, None, 0)
        # past the refusals: the particles' own checks
        with pytest.raises(AttributeError):
            run(None, None, None, None, None, cbl, None, 0)


def test_each_cross_is_counted_by_its_entry():
    """K4's launches of a cross go to the entry of its instantiation:
    advance.cbl (with or without settling, nests), advance.tile_cbl,
    advance.ts_cross (turbswitch with settling, nests or a tile); the
    stock step, its settling and nests to the kernel, its tile to
    advance.tile."""
    base = dict(nx=8, ny=8, nz=4, xglobal=True, ldirect=1, ifine=4, method=0)

    def entry(**kw):
        kw = {**dict(turbswitch=False), **kw}
        return tadv.k4_entry(tadv.StepConfig(**base, **kw))

    assert entry(cblflag=True) is _build.ADVANCE_CBL
    assert entry(cblflag=True, turbswitch=True, settling=True,
                 nests=((4, 4),)) is _build.ADVANCE_CBL
    assert entry(cblflag=True, tile_mode=True) is _build.ADVANCE_TILE_CBL
    for kw in (dict(settling=True), dict(nests=((4, 4),)),
               dict(tile_mode=True)):
        assert entry(turbswitch=True, **kw) is _build.ADVANCE_TS_CROSS
        assert entry(**kw) is (_build.ADVANCE_TILE if "tile_mode" in kw
                               else _build.ADVANCE)
    assert entry(turbswitch=True) is _build.ADVANCE
    assert {e.name for e in (_build.ADVANCE_CBL, _build.ADVANCE_TILE_CBL,
                             _build.ADVANCE_TS_CROSS)} <= {
        e.name for e in _build.ENTRIES}

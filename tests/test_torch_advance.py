"""Port parity: the fixed-step advance against JAX, with JAX's draws.

Both packages advance the same 4096 particles on the same synthetic met
(the JAX ZFields, carried across), and the port consumes exactly the
numbers JAX draws: ``flexpart_tpu.core.rng.normals(key, shape, tag)``
with the key JAX's ``advance_all`` receives (per chunk
``fold_in(key, i)`` for ``advance_chunked``), injected by tag.

Configs: the stock step (turbswitch off, ifine=1, bf16 tables) and the
turbulent one (turbswitch on, ifine=4, f32 tables), 1 and 4 steps.

Tolerances (float32 transcendentals differ by an ulp or two between XLA
and torch, and a 900 s step multiplies velocity differences by 900):
  * x, y: atol 1e-4 grid units;
  * z: rtol 1e-4, atol 1e-2 m;
  * velocities and mesoscale memories: rtol 1e-4, atol 1e-5 m/s;
  * cbt, active, itra and the StepDiag counts: exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402

N = 4096
LSYNC = 900
MEM1 = 10800
CONFIGS = {"stock": dict(turbswitch=False, ifine=1, met_bf16=True),
           "turb_ifine4": dict(turbswitch=True, ifine=4, met_bf16=False)}
TAGS = {6: 6, 1: 2, 3: 3, 4: 3}


@pytest.fixture(scope="module")
def setup():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (0.0, float(MEM1)):
        eta = m.fetch(t)
        h = jmet.compute_heights(grid, eta)
        zs.append(jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h)))
    tz = [interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                      z._asdict().items()}, "cpu") for z in zs]
    rs = np.random.default_rng(42)
    p = jstate.empty_particles(N)
    p = p._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, grid.nx - 1.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.3, grid.ny - 1.3, N), jnp.float32),
        z=jnp.asarray(rs.uniform(5.0, 14000.0, N), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.zeros(N, jnp.int32),
        mass=jnp.full((N, 1), 1.0 / N, jnp.float32))
    return grid, zs, tz, p


def _cfgs(grid, kw):
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=1, method=0, **kw)
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=1.0 / kw["ifine"])
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    return jcfg, jprm, tcfg, tprm


def _draws(key, n, ifine):
    rows = {**TAGS, 2: ifine}
    return {t: np.asarray(jrng.normals(key, (r, n), tag=t))
            for t, r in rows.items()}


def _to_torch(d):
    return {t: torch.from_numpy(np.array(v)) for t, v in d.items()}


def _compare(tp, jp, tdiag, jdiag, where):
    a = interop.particles_to_numpy(tp)
    b = {k: np.asarray(v) for k, v in jp._asdict().items()}
    x_a, x_b = a["x_hi"] + a["x_lo"], b["x_hi"] + b["x_lo"]
    y_a, y_b = a["y_hi"] + a["y_lo"], b["y_hi"] + b["y_lo"]
    np.testing.assert_allclose(x_a, x_b, rtol=0, atol=1e-4, err_msg=f"x {where}")
    np.testing.assert_allclose(y_a, y_b, rtol=0, atol=1e-4, err_msg=f"y {where}")
    np.testing.assert_allclose(a["z"], b["z"], rtol=1e-4, atol=1e-2,
                               err_msg=f"z {where}")
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{f} {where}")
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {where}")
    for f in ("n_active", "n_exited", "nan_count"):
        assert int(getattr(tdiag, f)) == int(getattr(jdiag, f)), (f, where)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_advance_all_matches_jax(setup, name):
    grid, (j0, j1), (t0, t1), p = setup
    kw = CONFIGS[name]
    jcfg, jprm, tcfg, tprm = _cfgs(grid, kw)
    jp = p
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    base = jax.random.PRNGKey(5)
    for step in range(4):
        itime = step * LSYNC
        key = jax.random.fold_in(base, step)
        draws = _draws(key, N, kw["ifine"])
        jp, jdiag = jadv.advance_all(jp, j0, j1, jnp.int32(itime),
                                     jnp.int32(0), jnp.int32(MEM1), key,
                                     jcfg, jprm)
        tp, tdiag = tadv.advance_all(tp, t0, t1, itime, 0, MEM1,
                                     trng.Key(5, step), tcfg, tprm,
                                     draws=_to_torch(draws))
        if step in (0, 3):          # after 1 and after 4 steps
            _compare(tp, jp, tdiag, jdiag, f"{name} step {step + 1}")


def test_advance_chunked_matches_jax(setup):
    grid, (j0, j1), (t0, t1), p = setup
    kw = CONFIGS["stock"]
    jcfg, jprm, tcfg, tprm = _cfgs(grid, kw)
    n_chunks = 4
    b = N // n_chunks
    jp = p
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    base = jax.random.PRNGKey(9)
    for step in range(2):
        itime = step * LSYNC
        key = jax.random.fold_in(base, step)
        per_chunk = [_draws(jax.random.fold_in(key, i), b, 1)
                     for i in range(n_chunks)]
        draws = {t: np.concatenate([d[t] for d in per_chunk], axis=1)
                 for t in per_chunk[0]}
        jp, jdiag = jadv.advance_chunked(jp, j0, j1, jnp.int32(itime),
                                         jnp.int32(0), jnp.int32(MEM1), key,
                                         jcfg, jprm, n_chunks)
        tp, tdiag = tadv.advance_chunked(tp, t0, t1, itime, 0, MEM1,
                                         trng.Key(9, step), tcfg, tprm,
                                         n_chunks, draws=_to_torch(draws))
        _compare(tp, jp, tdiag, jdiag, f"chunked step {step + 1}")


def test_chunking_does_not_change_the_port(setup):
    """Without injected draws the port's stream is keyed by the global
    particle index, so 1 and 4 chunks give bitwise the same particles."""
    grid, _, (t0, t1), p = setup
    _, _, tcfg, tprm = _cfgs(grid, CONFIGS["stock"])
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    outs = []
    for n_chunks in (1, 4):
        q = tp
        for step in range(2):
            q, diag = tadv.advance_chunked(q, t0, t1, step * LSYNC, 0, MEM1,
                                           trng.Key(77, step), tcfg, tprm,
                                           n_chunks)
        outs.append((interop.particles_to_numpy(q), int(diag.n_active)))
    (a, na), (b, nb) = outs
    assert na == nb
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_outside_slice_raises(setup):
    grid = setup[0]
    _, _, tcfg, _ = _cfgs(grid, CONFIGS["stock"])
    for bad in (dict(method=1), dict(cblflag=True), dict(polar=True),
                dict(tile_mode=True), dict(settling=True),
                dict(nests=((5, 5),))):
        cfg = type(tcfg)(**{**tcfg.__dict__, **bad})
        with pytest.raises(NotImplementedError):
            cfg.check()

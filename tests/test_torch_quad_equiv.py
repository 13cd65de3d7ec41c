"""Port parity: the legacy-RNG path with the production interpolation
(``StepConfig.legacy_quad``).

The port's mirror of ``tests/test_quad_equiv.py``: the draws come from the
reference's rannumb table in reference order (``core/legacy.py``), every
met sample from the quad tables (K2's, here float32) in place of the
per-time-level interpolation, and the mesoscale sigmas from the tables'
per-cell 8-sample estimator.  On ``tests/test_torch_matched_rng.py``'s
grid (61 x 31 x 20 SyntheticMet at 1 degree) and start positions (the
boundary layer, the troposphere, the tropopause and the stratosphere), 64
particles, four steps of 900 s, one shared table and the same nrand bases
(``NrandStream`` in the reference's order):

  * the zeroed table (every stochastic term vanishes: the deterministic
    core, the mean winds, the density drift, the sampled h, tropopause,
    u*, w* and L, the reflections and the corrector): the port's
    ``legacy_quad`` against the JAX package's ``legacy_quad`` run, and
    against the port's own legacy interpolation (turbswitch with ifine 4
    and hanna1 with ifine 1), within test_quad_equiv's bounds: x, y 2e-4
    cells, z 0.5 m + 1e-5 z per step;
  * the table's draws: against JAX's ``legacy_quad`` within
    ``test_torch_matched_rng::test_legacy_advance_matches_jax``'s bounds,
    the same function in float32 on both sides (1e-4 cells, 1e-2 m + 1e-4
    z), and against the port's legacy interpolation within
    test_quad_equiv's bound of what the sigma estimator moves (5e-2 cells,
    30 m + 1e-3 z);
  * the sigma estimator: the tables' per-cell sigma against
    ``interp_wind_legacy``'s 8-sample form (rtol 2e-4, atol 1e-6), the
    16-sample form's median ratio to it between 1 and 3.5 with 99% of the
    ratios above 0.9 (test_sigma_estimator_bound's), and the port's
    tables' sigma against the JAX package's (rtol 1e-5).

One JAX program: the ``legacy_quad`` step with turbswitch and ifine 4.
``legacy_quad`` is carried by ``interop.step_config_from_jax``; on a CUDA
tensor the legacy path, with or without it, is refused by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from test_torch_matched_rng import (LSYNC, MEMTIME, SEED,  # noqa: E402
                                    _params, _start_positions)
from test_torch_matched_rng import met_setup, table  # noqa: E402,F401
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import interp as jinterp  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.met.fields import ZFields as JZ  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import interp as tinterp  # noqa: E402
from flexpart_tpu_torch.core import legacy as tlegacy  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.advance import (StepConfig,  # noqa: E402
                                             StepParams, advance_all)
from flexpart_tpu_torch.core.legacy import LegacyRnd  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.validation.legacy_rng import (MAXRAND,  # noqa: E402
                                                      NrandStream)

N = 64
STEPS = 4


def _bases(n, steps):
    """The nrand bases of ``steps`` steps in the reference's order, as the
    matched runs draw them: initialize's base at the first step, then
    advance's each step."""
    stream = NrandStream(SEED, MAXRAND)
    out = []
    for k in range(steps):
        ni = np.array([stream.next_nrand() if k == 0 else 1
                       for _ in range(n)])
        na = np.array([stream.next_nrand() for _ in range(n)])
        out.append((ni, na))
    return out


def _quad(cfg):
    return StepConfig(**{**cfg.__dict__, "legacy_quad": True,
                         "met_bf16": False})


def _port_run(z0, z1, cfg, prm, tab, bases):
    """The port's legacy advance over the steps: (x, y, z) per step."""
    x, y, z = _start_positions(N)
    p = empty_particles(N, device="cpu").replace(
        x_hi=torch.tensor(x, dtype=torch.float32),
        y_hi=torch.tensor(y, dtype=torch.float32),
        z=torch.tensor(z, dtype=torch.float32),
        itra=torch.zeros(N, dtype=torch.int32),
        itramem=torch.full((N,), -1, dtype=torch.int32),
        mass=torch.ones((N, 1)), mass0=torch.ones((N, 1)),
        active=torch.ones(N, dtype=torch.bool))
    traj = []
    for k, (ni, na) in enumerate(bases):
        p, _ = advance_all(p, z0, z1, k * LSYNC, 0, MEMTIME[1],
                           trng.Key(0, 0), cfg, prm,
                           leg=LegacyRnd(table=tab,
                                         nrand_init=torch.from_numpy(ni),
                                         nrand=torch.from_numpy(na)))
        traj.append(np.stack([p.x.double().numpy(), p.y.double().numpy(),
                              p.z.double().numpy()], 1))
    assert bool(p.active.all())
    return traj


def _jax_run(grid, z0, z1, tab, bases):
    """The JAX package's legacy_quad advance (turbswitch, ifine 4, float32
    tables) on the port's fields: (x, y, z) per step."""
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=grid.xglobal, ldirect=1, turbswitch=True,
                           ifine=4, method=0, legacy_quad=True,
                           met_bf16=False)
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=0.25,
                                lwindinterv=MEMTIME[1])
    jz = [JZ(**{f: jnp.asarray(getattr(zf, f).numpy()) for f in JZ._fields})
          for zf in (z0, z1)]
    x, y, z = _start_positions(N)
    jp = jstate.empty_particles(N)._replace(
        x_hi=jnp.asarray(x, jnp.float32), y_hi=jnp.asarray(y, jnp.float32),
        z=jnp.asarray(z, jnp.float32), itra=jnp.zeros(N, jnp.int32),
        itramem=jnp.full(N, -1, jnp.int32), mass=jnp.ones((N, 1)),
        active=jnp.ones(N, bool))
    jtab = jnp.asarray(tab.numpy())
    traj = []
    for k, (ni, na) in enumerate(bases):
        jp, _ = jadv.advance_all(
            jp, jz[0], jz[1], jnp.int32(k * LSYNC), jnp.int32(0),
            jnp.int32(MEMTIME[1]), jax.random.PRNGKey(0), jcfg, jprm,
            leg=jadv.LegacyRnd(table=jtab,
                               nrand_init=jnp.asarray(ni, jnp.int32),
                               nrand=jnp.asarray(na, jnp.int32)))
        traj.append(np.stack([np.asarray(jp.x, np.float64),
                              np.asarray(jp.y, np.float64),
                              np.asarray(jp.z, np.float64)], 1))
    assert interop.step_config_from_jax(jcfg).legacy_quad
    return traj


def _held(a, b, atol_xy, atol_z, rtol_z, what):
    for k in range(len(a)):
        for c, name in ((0, "x"), (1, "y")):
            np.testing.assert_allclose(a[k][:, c], b[k][:, c], rtol=0,
                                       atol=atol_xy,
                                       err_msg=f"{what}: {name} step {k}")
        np.testing.assert_allclose(a[k][:, 2], b[k][:, 2], rtol=rtol_z,
                                   atol=atol_z, err_msg=f"{what}: z step {k}")


@pytest.fixture(scope="module")
def runs(met_setup, table):
    """The runs on the zeroed table and on the table's draws: the port's
    legacy_quad and legacy interpolation (turbswitch, ifine 4) and JAX's
    legacy_quad."""
    grid, z0, z1, _ = met_setup
    cfg, prm, _ = _params(grid, True, 4)
    bases = _bases(N, STEPS)
    out = {}
    for name, tab in (("zeroed", torch.zeros(MAXRAND + 1)),
                      ("drawn", table)):
        out[name] = dict(
            quad=_port_run(z0, z1, _quad(cfg), prm, tab, bases),
            interp=_port_run(z0, z1, cfg, prm, tab, bases),
            jax=_jax_run(grid, z0, z1, tab, bases))
    return out


def test_deterministic_core_matches_jax(runs):
    """The zeroed table: the port's legacy_quad against JAX's."""
    r = runs["zeroed"]
    _held(r["quad"], r["jax"], 2e-4, 0.5, 1e-5, "legacy_quad against JAX")


@pytest.mark.parametrize("turbswitch,ifine", [(True, 4), (False, 1)])
def test_deterministic_core_is_the_legacy_interpolation(met_setup, runs,
                                                        turbswitch, ifine):
    """The zeroed table: the quad tables' interpolation reproduces the
    per-time-level one to float32 roundoff (the time blend and the
    bilinear interpolation commute)."""
    if turbswitch:
        r = runs["zeroed"]
        quad, interp = r["quad"], r["interp"]
    else:
        grid, z0, z1, _ = met_setup
        cfg, prm, _ = _params(grid, turbswitch, ifine)
        bases = _bases(N, STEPS)
        tab = torch.zeros(MAXRAND + 1)
        quad = _port_run(z0, z1, _quad(cfg), prm, tab, bases)
        interp = _port_run(z0, z1, cfg, prm, tab, bases)
    _held(quad, interp, 2e-4, 0.5, 1e-5, "legacy_quad against legacy")


def test_full_stochastic_step_matches_jax(runs):
    """The table's draws: the port's legacy_quad against JAX's, draw for
    draw."""
    r = runs["drawn"]
    _held(r["quad"], r["jax"], 1e-4, 1e-2, 1e-4, "legacy_quad against JAX")


def test_full_stochastic_step_within_the_estimator_bound(runs):
    """The table's draws through both interpolations: the same Langevin
    and free-troposphere draws, so the positions differ only by the
    mesoscale term the sigma estimators move (|dsig| * turbmesoscale *
    lsync a step), and do differ."""
    r = runs["drawn"]
    _held(r["quad"], r["interp"], 5e-2, 30.0, 1e-3,
          "legacy_quad against legacy")
    assert any(not np.array_equal(a, b)
               for a, b in zip(r["quad"], r["interp"]))


def test_sigma_estimator_bound(met_setup):
    """The tables' per-cell sigma is the reference's 8-sample estimator to
    float32 roundoff, the 16-sample form's above-PBL convention is wider
    where the bracketing levels shear; and the port's tables give JAX's
    sigma."""
    grid, z0, z1, _ = met_setup
    rs = np.random.RandomState(3)
    n = 4096
    x = rs.uniform(1.0, grid.nx - 2.0, n).astype(np.float32)
    y = rs.uniform(1.0, grid.ny - 2.0, n).astype(np.float32)
    z = rs.uniform(20.0, 15000.0, n).astype(np.float32)
    tx, ty, tz = (torch.from_numpy(v) for v in (x, y, z))
    hw = tinterp.horiz_weights(tx, ty, grid.nx, grid.ny, grid.xglobal)
    indz, dz1 = tinterp.vert_weights(tz, z0.height)
    wind8, sig16 = tlegacy.interp_wind_legacy(z0, z1, hw, indz, dz1, 0.5,
                                              0.5)
    tables = tinterp.build_step_tables_quad(z0, z1, 0.5, 0.5, 0.5, 0.5)
    wind_q = tinterp.sample_all_quad(tables, hw, indz, dz1, tx, ty, grid.nx,
                                     grid.ny)[5]
    jz = [JZ(**{f: jnp.asarray(getattr(zf, f).numpy()) for f in JZ._fields})
          for zf in (z0, z1)]
    jhw = jinterp.horiz_weights(jnp.asarray(x), jnp.asarray(y), grid.nx,
                                grid.ny, grid.xglobal)
    jindz, jdz1 = jinterp.vert_weights(jnp.asarray(z), jz[0].height)
    jtab = jinterp.build_step_tables_quad(jz[0], jz[1], jnp.float32(0.5),
                                          jnp.float32(0.5), jnp.float32(0.5),
                                          jnp.float32(0.5))
    jwind = jinterp.sample_all_quad(jtab, jhw, jindz, jdz1, jnp.asarray(x),
                                    jnp.asarray(y), grid.nx, grid.ny)[5]
    for name, ref8, ref16, got, jgot in (
            ("u", wind8.usig, sig16[0], wind_q.usig, jwind.usig),
            ("v", wind8.vsig, sig16[1], wind_q.vsig, jwind.vsig),
            ("w", wind8.wsig, sig16[2], wind_q.wsig, jwind.wsig)):
        ref8, ref16, got = ref8.numpy(), ref16.numpy(), got.numpy()
        np.testing.assert_allclose(got, ref8, rtol=2e-4, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        keep = ref8 > 1e-3
        if not keep.any():
            continue        # w's sigma is mm/s here
        ratio = ref16[keep] / ref8[keep]
        assert 1.0 < np.median(ratio) < 3.5, name
        assert np.mean(ratio > 0.9) > 0.99, name


def test_legacy_quad_is_refused_on_the_card_as_the_legacy_path():
    """Like the legacy path, legacy_quad has no kernel: advance_all refuses
    it by name on a CUDA tensor before it reads the fields (here a
    stand-in with a CUDA device)."""
    class OnTheCard:
        device = torch.device("cuda", 0)
    cfg = StepConfig(nx=8, ny=8, nz=4, xglobal=False, ldirect=1,
                     turbswitch=True, ifine=4, method=0, legacy_quad=True)
    leg = LegacyRnd(table=torch.zeros(8), nrand_init=torch.ones(1),
                    nrand=torch.ones(1))
    prm = StepParams.make(1.0, 1.0, 0.0, 1.0, 1.0, LSYNC, 0.25)
    with pytest.raises(NotImplementedError, match="legacy"):
        advance_all(OnTheCard(), None, None, 0, 0, 3600, trng.Key(0, 0),
                    cfg, prm, leg=leg)

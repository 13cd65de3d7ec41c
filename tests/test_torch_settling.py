"""Port parity: gravitational settling and ``turboff`` in the fixed step.

The same inputs (numpy, one seed) go through the JAX package's
``_viscosity``, ``_settling_velocity``, ``_particle_settling`` and
``advance_all`` (``method=0``, ``settling`` and ``turboff``, JAX's draws
injected) and the port's plain versions.

Tolerances, and why:
  * the settling velocity: rtol 2e-6.  Both run the five iterations of
    get_settling.f90 in float32 with the same operations; the powers
    ``(t / 291.15) ** 1.5`` and ``re ** 0.6`` are XLA's and torch's ``pow``,
    which may differ by an ulp, and five iterations carry it on;
  * the advance: the tolerances of ``tests/test_torch_advance.py`` (x, y
    atol 1e-4 grid units; z rtol 1e-4 and atol 1e-2 m; velocities rtol
    1e-4 and atol 1e-5 m/s; cbt, active and itra equal), since settling
    adds one velocity to w and ``turboff`` only zeroes terms.

Also here: the port of ``tests/test_core.py::test_per_species_settling``
(two single-species release points settle each with its own species'
velocity), and the ``interop`` round trip of two species' settling
parameters (each species keeps its own, not species 0's).
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
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.met import synthetic as tsyn  # noqa: E402
from flexpart_tpu_torch.met import calcpar as tcalcpar  # noqa: E402
from flexpart_tpu_torch.met import verttransform as tvt  # noqa: E402

N = 2048
LSYNC = 900
MEM1 = 10800
TAGS = {6: 6, 1: 2, 3: 3, 4: 3}
# (density [kg/m3], dquer [um], dsigma): volcanic ash, Cs-137 on particles,
# a fine sulphate, a gas (no density: 0 m/s)
SPECIES = {"ash": (2500.0, 30.0, 1.5), "cs137": (2500.0, 10.0, 1.25),
           "sulphate": (1400.0, 0.4, 1.5), "gas": (-1.0, 0.0, 1.25)}


def _params(species):
    """The four settling parameters as the JAX Simulation fills them."""
    dens, dq, cun, vset = [], [], [], []
    for density, dquer, dsigma in species:
        s = jconfig.Species(density=density, dquer=dquer, dsigma=dsigma)
        c = s.size_classes()
        dens.append(max(s.density, -1.0))
        dq.append(s.dquer)
        cun.append(c.cunningham if c else 0.0)
        vset.append(c.vsetaver if c else 0.0)
    return dens, dq, cun, vset


def test_viscosity_matches_jax():
    t = np.linspace(190.0, 330.0, 64).astype(np.float32)
    j = np.asarray(jadv._viscosity(jnp.asarray(t)))
    p = tadv._viscosity(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(p, j, rtol=2e-6)


@pytest.mark.parametrize("name", list(SPECIES))
def test_settling_velocity_matches_jax(name):
    """Over a grid of temperatures and air densities of the troposphere;
    a gas settles at exactly 0."""
    dens, dq, cun, vset = (v[0] for v in _params([SPECIES[name]]))
    t, r = np.meshgrid(np.linspace(200.0, 310.0, 16),
                       np.linspace(0.3, 1.35, 16))
    t, r = t.ravel().astype(np.float32), r.ravel().astype(np.float32)
    n = t.size
    args = [np.full(n, v, np.float32) for v in (dq, dens, cun, vset)]
    j = np.asarray(jadv._settling_velocity(
        *(jnp.asarray(a) for a in args), jnp.asarray(t), jnp.asarray(r)))
    p = tadv._settling_velocity(*(torch.from_numpy(a) for a in args),
                                torch.from_numpy(t), torch.from_numpy(r))
    np.testing.assert_allclose(p.numpy(), j, rtol=2e-6, atol=0.0)
    if dens <= 0.0:
        assert (p.numpy() == 0.0).all()
    else:
        assert (p.numpy() < 0.0).all()


def test_particle_settling_takes_the_first_species_with_mass():
    """Each particle settles with its first species of release mass, and a
    particle with none with species 0's."""
    species = [SPECIES[k] for k in ("gas", "cs137", "ash")]
    dens, dq, cun, vset = _params(species)
    jprm = jadv.StepParams.make(1.0, 1.0, 0.0, 1.0, 1.0, LSYNC, 1.0,
                                sp_density=dens, sp_dquer=dq,
                                sp_cunningham=cun, sp_vsetaver=vset)
    cfg = jadv.StepConfig(nx=4, ny=4, nz=4, xglobal=False, ldirect=1,
                          turbswitch=False, ifine=1, method=0)
    tprm = interop.step_params_from_numpy(jprm)
    a = tadv.advance_args(interop.step_config_from_jax(cfg), tprm, 0, 0, 3600)
    rs = np.random.default_rng(3)
    n = 64
    mass0 = (rs.uniform(size=(n, 3)) < 0.4).astype(np.float32)
    mass0[:4] = 0.0                                 # no mass: species 0
    mass0[4:8] = [[0.0, 0.0, 1.0]] * 4
    temp = rs.uniform(220.0, 300.0, n).astype(np.float32)
    rhoa = rs.uniform(0.4, 1.3, n).astype(np.float32)
    p = jstate.empty_particles(n, nspec=3)._replace(mass0=jnp.asarray(mass0))
    j = np.asarray(jadv._particle_settling(jprm, p, jnp.asarray(temp),
                                           jnp.asarray(rhoa)))
    got = tadv._particle_settling(a, torch.from_numpy(mass0),
                                  torch.from_numpy(temp),
                                  torch.from_numpy(rhoa)).numpy()
    np.testing.assert_allclose(got, j, rtol=2e-6, atol=0.0)
    sp = tadv.settling_species(torch.from_numpy(mass0)).numpy()
    np.testing.assert_array_equal(sp, np.argmax(mass0 > 1e-30, axis=1))
    assert (got[:4] == 0.0).all() and (got[4:8] < -0.01).all()


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


def _particles(grid, seed):
    """Two species released by two points (each particle carries one),
    half of the particles in the boundary layer, some fresh."""
    rs = np.random.default_rng(seed)
    mass0 = np.zeros((N, 2), np.float32)
    first = rs.uniform(size=N) < 0.5
    mass0[first, 0] = 1.0
    mass0[~first, 1] = 1.0
    p = jstate.empty_particles(N, nspec=2)
    return p._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, grid.nx - 1.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.3, grid.ny - 1.3, N), jnp.float32),
        z=jnp.asarray(np.where(rs.uniform(size=N) < 0.5,
                               rs.uniform(5.0, 600.0, N),
                               rs.uniform(600.0, 14000.0, N)), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.zeros(N, jnp.int32),
        itramem=jnp.asarray(np.where(rs.uniform(size=N) < 0.3, LSYNC, -3600),
                            jnp.int32),
        up=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        vp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        wp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        mass=jnp.asarray(mass0), mass0=jnp.asarray(mass0))


def _compare(tp, jp, tdiag, jdiag, where):
    a = interop.particles_to_numpy(tp)
    b = {k: np.asarray(v) for k, v in jp._asdict().items()}
    for c in ("x", "y"):
        np.testing.assert_allclose(a[c + "_hi"] + a[c + "_lo"],
                                   b[c + "_hi"] + b[c + "_lo"], rtol=0,
                                   atol=1e-4, err_msg=f"{c} {where}")
    np.testing.assert_allclose(a["z"], b["z"], rtol=1e-4, atol=1e-2,
                               err_msg=f"z {where}")
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{f} {where}")
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {where}")
    for f in ("n_active", "n_exited", "nan_count"):
        assert int(getattr(tdiag, f)) == int(getattr(jdiag, f)), (f, where)


FIXED = {"settling": dict(settling=True),
         "turboff": dict(turboff=True),
         "settling_turboff_polar": dict(settling=True, turboff=True,
                                        polar=True)}


@pytest.mark.parametrize("name", list(FIXED))
def test_fixed_step_matches_jax(met, name):
    """Two steps of the fixed-step advance with settling (an ash aerosol
    and a gas) and with turboff, JAX's draws injected."""
    grid, (j0, j1), (t0, t1) = met
    dens, dq, cun, vset = _params([SPECIES["ash"], SPECIES["gas"]])
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                           ldirect=1, turbswitch=False, ifine=1, method=0,
                           nspec=2, **FIXED[name])
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=1.0, sp_density=dens,
                                sp_dquer=dq, sp_cunningham=cun,
                                sp_vsetaver=vset)
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    assert (tcfg.settling, tcfg.turboff) == (jcfg.settling, jcfg.turboff)
    jp = _particles(grid, 8)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    base = jax.random.PRNGKey(13)
    for step in range(2):
        itime = (step + 1) * LSYNC
        key = jax.random.fold_in(base, step)
        draws = {t: torch.from_numpy(np.array(jrng.normals(key, (r, N),
                                                           tag=t)))
                 for t, r in {**TAGS, 2: 1}.items()}
        jp, jdiag = jadv.advance_all(jp, j0, j1, jnp.int32(itime),
                                     jnp.int32(0), jnp.int32(MEM1), key,
                                     jcfg, jprm)
        tp, tdiag = tadv.advance_all(tp, t0, t1, itime, 0, MEM1,
                                     trng.Key(13, step), tcfg, tprm,
                                     draws=draws)
        _compare(tp, jp, tdiag, jdiag, f"{name} step {step + 1}")
    if jcfg.turboff:
        # the mesoscale memory of every scheduled particle is zeroed (the
        # free troposphere keeps a particle's up and vp, as JAX does)
        for f in ("usig", "vsig", "wsig"):
            assert float(getattr(tp, f)[tp.active].abs().max()) == 0.0, f


def test_per_species_settling():
    """Two single-species release points with different particle sizes:
    each particle settles with ITS species' velocity (advance.f90:518-531
    via the first-species-with-mass rule), not species 0's; the port of
    ``tests/test_core.py::test_per_species_settling``."""
    grid = tsyn.make_grid(nx=40, ny=30, nlev=15, dx=1.0, dy=1.0,
                          xlon0=0.0, ylat0=20.0, xglobal=False)
    m = tsyn.uniform_wind_met(grid, u=10.0, v=0.0)
    eta = m.fetch(0.0, "cpu")
    height = tvt.compute_heights(grid, eta)
    z0 = tcalcpar.calcpar(grid, eta, tvt.process_eta(grid, eta, height))
    heavy = tconfig.Species(density=2500.0, dquer=10.0, dsigma=1.0001)
    light = tconfig.Species(density=1400.0, dquer=0.4, dsigma=1.0001)
    scs = [heavy.size_classes(), light.size_classes()]
    assert scs[0] is not None and scs[1] is not None
    cfg = tadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                          xglobal=grid.xglobal, ldirect=1, turbswitch=False,
                          ifine=1, method=0, turboff=True, settling=True)
    prm = tadv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=900, fine=1.0,
        sp_density=[heavy.density, light.density],
        sp_dquer=[heavy.dquer, light.dquer],
        sp_cunningham=[c.cunningham for c in scs],
        sp_vsetaver=[c.vsetaver for c in scs])
    n = 16
    mass = np.zeros((n, 2), np.float32)
    mass[: n // 2, 0] = 1.0     # release point A: heavy species only
    mass[n // 2:, 1] = 1.0      # release point B: light species only
    p = empty_particles(n, 2, device="cpu").replace(
        x_hi=torch.full((n,), 10.0), y_hi=torch.full((n,), 5.0),
        z=torch.full((n,), 3000.0), mass=torch.from_numpy(mass),
        mass0=torch.from_numpy(mass),
        active=torch.ones(n, dtype=torch.bool),
        itra=torch.zeros(n, dtype=torch.int32))
    p2, _ = tadv.advance_all(p, z0, z0, 0, 0, 3600, trng.Key(0, 0), cfg, prm)
    drop = 3000.0 - p2.z.numpy()
    heavy_drop, light_drop = drop[: n // 2], drop[n // 2:]
    # 10 um @ 2500 kg/m3 settles orders of magnitude faster than
    # 0.4 um @ 1400 kg/m3
    assert heavy_drop.min() > 1.0            # ~7 mm/s * 900 s
    assert light_drop.max() < 0.1
    assert heavy_drop.min() > 20 * light_drop.max()


def test_interop_carries_each_species_settling():
    """``step_params_from_numpy`` keeps one value per species: two species
    that settle differently settle differently after the round trip."""
    dens, dq, cun, vset = _params([SPECIES["ash"], SPECIES["sulphate"]])
    jprm = jadv.StepParams.make(1.0, 1.0, -90.0, 1.0, 1.0, LSYNC, 0.25,
                                ctl=5.0, sp_density=dens, sp_dquer=dq,
                                sp_cunningham=cun, sp_vsetaver=vset)
    tprm = interop.step_params_from_numpy(
        {k: np.asarray(v) for k, v in jprm._asdict().items()})
    for f in tadv.SPECIES_PARAMS:
        want = tuple(float(v) for v in np.asarray(getattr(jprm, f)))
        assert getattr(tprm, f) == want and len(want) == 2, f
    assert tprm.ctl == 5.0 and tprm.fine == 0.25
    cfg = tadv.StepConfig(nx=4, ny=4, nz=4, xglobal=False, ldirect=1,
                          turbswitch=True, ifine=4, method=1, settling=True)
    a = tadv.advance_args(cfg, tprm, 0, 0, 3600)
    mass0 = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    v = tadv._particle_settling(a, mass0, torch.full((2,), 280.0),
                                torch.full((2,), 1.2))
    assert float(v[0]) < 100 * float(v[1]) < 0.0
    assert a.nspec == 2 and list(a.sp_dquer)[:2] == list(tprm.sp_dquer)

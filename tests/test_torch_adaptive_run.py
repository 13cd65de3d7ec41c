"""Port parity for a run with the adaptive step and a settling aerosol.

The port's run recipe (README.md, "The PyTorch/CUDA port") with
``Command(ctl=5.0)`` (the adaptive step, ``method=1``; turbswitch on,
``ifine=4``) and two release boxes of one species each, so that the
reference's rule turns settling on: a tracer from 40-42 N, 0-2 E (800
particles) and a Cs-137-like aerosol with a density (2500 kg/m3, 10 um:
about 7 mm/s) from SyntheticMet's storm band at 46-52 N, 20-30 E (208
particles), both over the first hour; three hours of 900 s steps on the
37x19x15 grid to both poles, hourly output.  One JAX run per file
(module-scoped; the adaptive JAX program is the slowest to compile).

JAX's draws are injected through ``_draws_hook`` (tags 6, 3, 4 as
(rows, n) with ``fold_in(key, istep)``; tags 1 and 2 per pass, (K, rows,
n), with ``fold_in(fold_in(key, istep), 9000 + k)``) and the convective
redistribution's uniforms through ``_redist_hook``, as in
``tests/test_torch_default_run.py``.  Held against JAX:
  * the release schedule bitwise, the active count, ``dates``;
  * ``StepConfig`` and the run scalars of the adaptive step;
  * z as a distribution, as ``tests/test_torch_sim.py`` states it (the
    Langevin equation of the boundary layer amplifies an ulp, and the
    adaptive step's ``trunc(lim * ctl)`` is a cliff): 85% of the
    particles within 1e-2 m + 1e-4 relative, 97% within 1 m, the mean
    height of each species within 1 m (measured: 99.9%, 100%, 2e-4 m, the
    worst particle 0.14 m apart); x and y within 1e-4 grid units for 99%
    of them (measured: all, within 1.4e-5); ``idt`` equal for 98%
    (measured: 99.9%, one particle);
  * the aerosol's wet and dry deposition grids by their totals within
    rtol 1e-2 and its airborne mass within 1e-3 relative (a deposit
    depends on the particle's height: its dry part on the seconds below
    2 HREF; measured: the totals within 2e-7);
  * the tracer's ``conc`` of the last file by its total within 1e-3 of
    the released mass (both packages recover it).
With the same draws, the aerosol ends lower than the same run's aerosol
without a density by more than 20 m on average (measured: 62 m).  Between
two port runs with the port's own Philox streams: bitwise equal particles
and deposition grids, and the aerosol's budget (airborne + wet + dry) is
its released mass within 1e-5.

``test_step_config_matches_jax`` builds both ``Simulation``s (no run) for
each configuration the port refused before the adaptive step came: a
single-species density aerosol (settling on), a two-species box with a
density aerosol (settling off, as the reference rules), ``ctl=5`` and
``turboff``.
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
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import settling_species  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

N_TRACER, N_AEROSOL = 800, 208
N = N_TRACER + N_AEROSOL
NSTEPS = 12
IFINE = 4
PASSES = 40          # injected passes per step (the run takes at most 9)


def _aerosol(c, density=2500.0):
    return c.Species(name="CS-137", decay_halflife=30.17 * 365.25 * 86400.0,
                     crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                     in_aero=0.1, density=density, dquer=10.0, dsigma=1.25,
                     dryvel=1.0e-3)


def _recipe(c, grid_mod, outdir, cmd_kw=None, boxes=None, species=None,
            **kw):
    grid = grid_mod.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=30000,
                    lsynctime=900, loutstep=3600, loutaver=3600,
                    loutsample=900, **(cmd_kw or dict(ctl=5.0)))
    when = dict(idate1=20200101, itime1=0, idate2=20200101, itime2=10000)
    if boxes is None:
        boxes = (c.ReleaseBox(lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0,
                              z1=50.0, z2=500.0, mass=(1.0, 0.0),
                              parts=N_TRACER, **when),
                 c.ReleaseBox(lon1=20.0, lon2=30.0, lat1=46.0, lat2=52.0,
                              z1=50.0, z2=1500.0, mass=(0.0, 1.0),
                              parts=N_AEROSOL, **when))
    else:
        boxes = tuple(c.ReleaseBox(**when, **b) for b in boxes)
    rel = c.Releases(species=species or (c.Species(), _aerosol(c)),
                     boxes=boxes)
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    return dict(cmd=cmd, releases=rel, grid=grid,
                met_backend=grid_mod.SyntheticMet(grid), outgrid=og,
                outdir=str(outdir), **kw)


class _PortGrid:
    make_grid = staticmethod(make_grid)
    SyntheticMet = SyntheticMet


def _slots(v, origin):
    """Injected draws in slot order: the particle axis is the last."""
    return v[..., origin].contiguous()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jout = tmp_path_factory.mktemp("jax_adaptive")
    jsim = JaxSimulation(**_recipe(jconfig, jmet, jout))
    schedule = {f: np.asarray(getattr(jsim.particles, f)) for f in FIELDS}
    jsim.run()
    key = jax.random.PRNGKey(jsim.seed)
    ks = jnp.arange(PASSES)
    draws = []
    for i in range(NSTEPS):
        ki = jax.random.fold_in(key, i)
        d = {t: np.asarray(jrng.normals(ki, (r, N), tag=t))
             for t, r in ((6, 6), (3, 3), (4, 3))}
        for tag, rows in ((1, 2), (2, IFINE)):
            d[tag] = np.asarray(jax.vmap(lambda k: jrng.normals(
                jax.random.fold_in(ki, 9000 + k), (rows, N), tag=tag))(ks))
        draws.append({t: torch.as_tensor(np.array(v)) for t, v in d.items()})
    uniforms = [torch.as_tensor(np.array(jax.random.uniform(
        jax.random.fold_in(key, 1000000 + i), (N,))))
        for i in range(NSTEPS + 1)]
    def injected(outdir, **kw):
        s = Simulation(**_recipe(tconfig, _PortGrid, outdir, device="cpu",
                                 **kw))
        schedule = interop.particles_to_numpy(s.particles)
        s._draws_hook = lambda istep, origin: {
            t: _slots(v, origin) for t, v in draws[istep].items()}
        s._redist_hook = lambda istep, origin: uniforms[istep][origin]
        s.run()
        return s, schedule

    tout = tmp_path_factory.mktemp("port_adaptive")
    sim, port_schedule = injected(tout)
    origin = sim._slot_origin()
    # the same run and draws with an aerosol that has no density: what
    # settling alone moves
    flat = injected(tmp_path_factory.mktemp("port_flat"), species=(
        tconfig.Species(), _aerosol(tconfig, density=-1.0)))[0]
    own = []
    for k in range(2):
        s = Simulation(**_recipe(tconfig, _PortGrid,
                                 tmp_path_factory.mktemp(f"own{k}"),
                                 device="cpu"))
        s.run()
        own.append(s)
    return jsim, jout, schedule, sim, tout, port_schedule, origin, flat, own


def _back(sim, origin, name):
    """A port field in the JAX package's slot order."""
    out = np.empty_like(getattr(sim.particles, name).numpy())
    out[origin.numpy()] = getattr(sim.particles, name).numpy()
    return out


def test_schedule_and_configuration_match_jax(runs):
    jsim, jout, schedule, sim, tout, port_schedule, _, _, _ = runs
    for f in FIELDS:
        np.testing.assert_array_equal(port_schedule[f], schedule[f],
                                      err_msg=f)
    cfg, jcfg = sim.step_cfg, jsim.step_cfg
    assert (cfg.method, cfg.settling, cfg.turbswitch, cfg.ifine,
            cfg.mintime) == (jcfg.method, jcfg.settling, jcfg.turbswitch,
                             jcfg.ifine, jcfg.mintime) == (1, True, True,
                                                           IFINE, 1.0)
    jprm = interop.step_params_from_numpy(
        {k: np.asarray(v) for k, v in jsim.step_prm._asdict().items()})
    for f in ("ctl", "lsynctime", "fine", "sp_density", "sp_dquer",
              "sp_cunningham", "sp_vsetaver"):
        assert getattr(sim.step_prm, f) == getattr(jprm, f), f
    assert (Path(tout) / "dates").read_text() == \
        (Path(jout) / "dates").read_text()
    assert int(sim.particles.active.sum()) \
        == int(np.sum(np.asarray(jsim.particles.active))) == N


def test_positions_match_jax_as_a_distribution(runs):
    jsim, _, _, sim, _, _, origin, _, _ = runs
    jz = np.asarray(jsim.particles.z)
    tz = _back(sim, origin, "z")
    d = np.abs(tz - jz)
    assert (d <= 1e-2 + 1e-4 * np.abs(jz)).mean() >= 0.85, d
    assert (d <= 1.0).mean() >= 0.97
    sp = settling_species(torch.from_numpy(np.array(jsim.particles.mass0)))
    for s in (0, 1):
        m = sp.numpy() == s
        assert abs(tz[m].mean() - jz[m].mean()) <= 1.0, s
    for c in ("x", "y"):
        j = np.asarray(getattr(jsim.particles, c + "_hi")) \
            + np.asarray(getattr(jsim.particles, c + "_lo"))
        t = _back(sim, origin, c + "_hi") + _back(sim, origin, c + "_lo")
        assert (np.abs(t - j) <= 1e-4).mean() >= 0.99, c
    assert (_back(sim, origin, "idt") == np.asarray(jsim.particles.idt)) \
        .mean() >= 0.98


def test_deposition_and_conc_match_jax(runs):
    jsim, jout, _, sim, tout, _, _, _, _ = runs
    for k in ("wetgridunc", "drygridunc"):
        t = getattr(sim.acc, k).numpy()[..., 1].sum(dtype=np.float64)
        j = np.asarray(getattr(jsim.acc, k))[..., 1].sum(dtype=np.float64)
        assert j > 0.0 and abs(t / j - 1.0) <= 1e-2, (k, t, j)
        assert getattr(sim.acc, k).numpy()[..., 0].sum() == 0.0
    air_t = sim.particles.mass.numpy()[sim.particles.active.numpy(), 1].sum(
        dtype=np.float64)
    jm, ja = np.asarray(jsim.particles.mass), np.asarray(jsim.particles.active)
    air_j = jm[ja, 1].sum(dtype=np.float64)
    assert abs(air_t / air_j - 1.0) <= 1e-3
    files = sorted(Path(jout).glob("grid_conc_*.npz"))
    assert [f.name for f in files] == sorted(
        f.name for f in Path(tout).glob("grid_conc_*.npz"))
    j = np.load(files[-1])["conc"]
    t = np.load(Path(tout) / files[-1].name)["conc"]
    assert t.shape == j.shape
    mj = float((j[0, 0, 0] * jsim.geo.volume).sum() / 1e12)
    mt = float((t[0, 0, 0] * sim.geo.volume).sum() / 1e12)
    assert abs(mj - 1.0) < 1e-3 and abs(mt - 1.0) < 1e-3


def test_the_aerosol_sinks(runs):
    """With the same draws, the aerosol (about 7 mm/s) ends lower than it
    does without a density, by tens of metres on average over 2-3 hours."""
    _, _, _, sim, _, _, origin, flat, _ = runs
    sp = settling_species(torch.from_numpy(_back(sim, origin, "mass0")))
    drop = _back(flat, flat._slot_origin(), "z") - _back(sim, origin, "z")
    aero = sp.numpy() == 1
    assert drop[aero].mean() > 20.0, drop[aero].mean()
    assert sim.step_cfg.settling and not flat.step_cfg.settling


def test_own_streams_reproduce_and_the_budget_closes(runs):
    """Two port runs with one seed: bitwise; the aerosol's budget closes
    and it deposits wet and dry."""
    a, b = runs[-1]
    pa, pb = interop.particles_to_numpy(a.particles), \
        interop.particles_to_numpy(b.particles)
    for f in FIELDS:
        np.testing.assert_array_equal(pa[f], pb[f], err_msg=f)
    for k in ("wetgridunc", "drygridunc"):
        assert torch.equal(getattr(a.acc, k), getattr(b.acc, k)), k
    air = float(a.particles.mass[a.particles.active, 1].sum(
        dtype=torch.float64))
    wet = float(a.acc.wetgridunc[..., 1].sum(dtype=torch.float64))
    dry = float(a.acc.drygridunc[..., 1].sum(dtype=torch.float64))
    assert wet > 0.0 and dry > 0.0
    assert abs(air + wet + dry - 1.0) <= 1e-5, (air, wet, dry)
    assert int(a.particles.idt.max()) > 1


CONFIGS = {
    "density aerosol, one species": dict(
        species=(_aerosol,), boxes=(dict(lon1=0.0, lon2=2.0, lat1=40.0,
                                         lat2=42.0, z1=50.0, z2=500.0,
                                         mass=(1.0,), parts=96),),
        cmd_kw=dict(ctl=-5.0)),
    # ROADMAP C #9: one box emits two species, so the reference runs the
    # density aerosol without settling, and so must the port
    "two species in one box": dict(
        species=("tracer", _aerosol), boxes=(dict(
            lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0, z1=50.0, z2=500.0,
            mass=(1.0, 1.0), parts=96),), cmd_kw=dict(ctl=-5.0)),
    "ctl=5": dict(cmd_kw=dict(ctl=5.0)),
    "turboff": dict(cmd_kw=dict(ctl=-5.0), turboff=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_config_matches_jax(name, tmp_path):
    """Each configuration the port refused before this slice builds in both
    packages with the same ``settling``, ``turboff``, ``method``, ``ifine``
    and ``ctl``."""
    kw = dict(CONFIGS[name])
    species = kw.pop("species", None)
    sims = []
    for c, grid_mod, extra in ((jconfig, jmet, {}),
                               (tconfig, _PortGrid, dict(device="cpu"))):
        sp = None
        if species is not None:
            sp = tuple(c.Species() if s == "tracer" else s(c)
                       for s in species)
        sims.append((JaxSimulation if c is jconfig else Simulation)(
            **_recipe(c, grid_mod, tmp_path / c.__name__, species=sp,
                      **kw, **extra)))
    jsim, sim = sims
    for f in ("settling", "turboff", "method", "ifine", "turbswitch"):
        assert getattr(sim.step_cfg, f) == getattr(jsim.step_cfg, f), f
    assert sim.step_prm.ctl == float(np.asarray(jsim.step_prm.ctl))
    want = {"density aerosol, one species": dict(settling=True, method=0),
            "two species in one box": dict(settling=False, method=0),
            "ctl=5": dict(method=1, ifine=4),
            "turboff": dict(turboff=True, method=0)}[name]
    for f, v in want.items():
        assert getattr(sim.step_cfg, f) == v, f

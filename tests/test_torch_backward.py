"""Port parity for backward runs (``ldirect = -1``).

The same numpy-seeded inputs go through the JAX package and the port's
plain versions on the CPU:

* the release schedule of a backward run (release times counted back
  from the run's end), plain and with the backward deposition modes
  (``bkdep`` 3: the 0-20 km column, 4: the 0-30 m layer, ``xscav`` = -1
  on the released slots): every field bitwise, dtype included;
* the fixed-step advance at ``ldirect = -1`` (the displacement, the
  Langevin equation's time direction, the z update and the end time
  reversed) with JAX's draws injected, stock and turbulent (ifine 4):
  the tolerances of ``tests/test_torch_advance.py`` (x, y within 1e-4
  grid units, z within 1e-2 m + rtol 1e-4, velocities within 1e-5 m/s +
  rtol 1e-4; cbt, active, itra and the counts equal; XLA and torch round
  their float32 transcendentals an ulp apart, and XLA contracts
  products and sums);
* the adaptive step at ``ldirect = -1`` with settling, JAX's per-pass
  draws injected, on the heights of ``tests/test_torch_adaptive.py`` (up
  to 3 km): its distribution (99% of the particles with JAX's idt, those
  within its tolerances);
* ``assign_wetbkdep`` and ``assign_drybkdep``: xscav and the mass of each
  fresh particle; the masses exactly, the factors within rtol 1e-6, not
  bitwise (the wet factor goes through XLA's and torch's ``pow`` and
  ``exp``, the dry one is a 4-point sum that XLA contracts into FMAs:
  measured 3.0e-7 and 1.9e-7 relative at most; on the card K9 and K10
  ``BKDEP`` equal the plain versions bitwise);
* a small backward ``Simulation.run`` (the configuration of
  ``tests/test_modes.py::test_backward_run``, one JAX run per file):
  the schedule bitwise, the output files' names, the netCDF prefix and
  units; with JAX's draws injected through ``Simulation._draws_hook``,
  positions, ``xscav`` and ``conc`` within the tolerances of
  ``tests/test_torch_sim.py`` (the boundary layer's Langevin equation
  amplifies an ulp over the 24 steps: z as a distribution, 85% within the
  one-step tolerance and 98% within 1 m; the particles whose z parted take
  other winds, so x and y are held within 1e-4 grid units for 99.5% of
  them, the forward runs' share, and within 2e-3 for all (measured: 2 of
  400 beyond 1e-4, the worst 1.1e-3), and ``cbt``, the sign of the last reflection, which follows z,
  equal for 98% of them (measured: 2 of 400 differ); the residence times
  within rtol 1e-5 + 1e-5 of the largest cell for all but 0.1% of the
  cells, all within rtol 1e-3 (measured: 2 of 12,150 cells beyond, by
  1.05e-4), and their sum within 1e-5);
* the reference's unformatted files (``write_fortran``): the header of a
  Simulation byte for byte but its version string, forward and backward
  (backward it states iedate/ietime and the release times counted back
  from the end, negated and swapped), the ``grid_time_*`` files of the
  run above and the ``linversionout = 1`` time series of the same run,
  decoded and held to the residence times' tolerance.

``tests/test_torch_bkdep_run.py`` runs WETBKDEP and DRYBKDEP through both
packages; ``tests/test_torch_convection.py`` holds the backward
redistribution, ``tests/test_torch_conccalc.py`` the ``bkdep`` and
particle-count sampling.  Particle counts are multiples of 16 (torch's
CPU ``pow`` rounds a last partial vector differently).
"""
import dataclasses
import struct
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
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import release as jrel  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.io.netcdf4 import open_nc4  # noqa: E402
from flexpart_tpu.physics import bkdep as jbk  # noqa: E402
from flexpart_tpu.physics.wetdepo import WetSpecies as JWetSpecies  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import release as trel  # noqa: E402
from flexpart_tpu_torch.core import reorder  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.io.fortran_writer import (  # noqa: E402
    _RecReader, read_grid_sparse, read_header, sparse_decode)
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.physics import bkdep as tbk  # noqa: E402
from flexpart_tpu_torch.physics.wetdepo import WetSpecies  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

GRID = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
LSYNC = 900
N = 2048
# a backward step inside a wind interval: its start and the met times
ITIME, MEM0, MEM1 = -900, -3600, 0
TAGS = {6: 6, 1: 2, 3: 3, 4: 3}
PASSES = 64
FEW_SHARE = 0.005


def _numpy(p):
    if dataclasses.is_dataclass(p):
        return interop.particles_to_numpy(p)
    return {f: np.asarray(getattr(p, f)) for f in FIELDS}


def _port(p):
    return interop.particles_from_numpy(_numpy(p), "cpu")


# ------------------------------------------------------------- release --

def _release_config(c, bkdep):
    cmd = c.Command(ibdate=20200101, ibtime=60000, iedate=20200101,
                    ietime=120000, ldirect=-1, lsynctime=LSYNC,
                    ind_receptor=bkdep or 1)
    boxes = (c.ReleaseBox(idate1=20200101, itime1=100000, idate2=20200101,
                          itime2=120000, lon1=0.0, lon2=2.0, lat1=40.0,
                          lat2=42.0, z1=50.0, z2=500.0, mass=(1.0, 3.0),
                          parts=1000),
             c.ReleaseBox(idate1=20200101, itime1=113000, idate2=20200101,
                          itime2=113000, lon1=-170.0, lon2=-170.0,
                          lat1=-10.0, lat2=-10.0, z1=1000.0, z2=1000.0,
                          mass=(2.0,), parts=333))
    return cmd, c.Releases(species=(c.Species(), c.Species(name="B")),
                           boxes=boxes)


@pytest.mark.parametrize("bkdep", [0, 3, 4])
def test_backward_release_schedule_equals_jax_bitwise(bkdep):
    jcmd, jrels = _release_config(jconfig, bkdep)
    tcmd, trels = _release_config(tconfig, bkdep)
    assert tcmd.ideltas == jcmd.ideltas == -21600
    jp = jrel.build_release_schedule(jrels, jcmd, jmet.make_grid(**GRID),
                                     capacity=1500, nclassunc=3, seed=7,
                                     bkdep=bkdep)
    tp = trel.build_release_schedule(trels, tcmd, make_grid(**GRID),
                                     capacity=1500, nclassunc=3, seed=7,
                                     bkdep=bkdep, device="cpu")
    a, b = _numpy(tp), _numpy(jp)
    for f in FIELDS:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    n = 1333
    itra = a["itra"][:n]
    # counted back from the run's end, on the sync steps
    assert itra.max() == 0 and itra.min() == -7200 + LSYNC \
        and (itra % LSYNC == 0).all()
    z = a["z"][:n]
    if bkdep == 3:
        assert z.max() > 15000.0 and z.min() >= 0.0
    elif bkdep == 4:
        assert z.max() <= 30.0
    else:
        assert z.min() >= 50.0 and z.max() <= 1000.0
    assert (a["xscav"][:n] == (-1.0 if bkdep else 1.0)).all()
    assert (a["xscav"][n:] == 1.0).all()


# ------------------------------------------------------------- advance --

@pytest.fixture(scope="module")
def met():
    grid = jmet.make_grid(**GRID)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (float(MEM0), float(MEM1)):
        eta = m.fetch(t)
        h = jmet.compute_heights(grid, eta)
        zs.append(jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h)))
    tz = [interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                      z._asdict().items()}, "cpu") for z in zs]
    return grid, zs, tz


def _particles(grid, nspec=1, seed=42, ztop=14000.0):
    """Particles over the grid up to ``ztop``, most in the boundary layer,
    scheduled now; half released on this step (fresh), the rest earlier
    (later in model time: the run counts down)."""
    rs = np.random.default_rng(seed)
    mass0 = np.zeros((N, nspec), np.float32)
    mass0[np.arange(N), rs.integers(0, nspec, N)] = 1.0
    p = jstate.empty_particles(N, nspec=nspec)
    return p._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, grid.nx - 1.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.3, grid.ny - 1.3, N), jnp.float32),
        z=jnp.asarray(np.where(rs.uniform(size=N) < 0.7,
                               rs.uniform(5.0, 400.0, N),
                               rs.uniform(400.0, ztop, N)), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.full(N, ITIME, jnp.int32),
        itramem=jnp.asarray(np.where(rs.uniform(size=N) < 0.5, ITIME,
                                     ITIME + 3600), jnp.int32),
        idt=jnp.asarray(rs.integers(0, 300, N), jnp.int32),
        up=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        vp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        wp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        mass=jnp.asarray(mass0), mass0=jnp.asarray(mass0))


FIXED = {"stock": dict(turbswitch=False, ifine=1, met_bf16=True),
         "turb_ifine4": dict(turbswitch=True, ifine=4, met_bf16=False)}


@pytest.mark.parametrize("name", list(FIXED))
def test_fixed_advance_backward_matches_jax(met, name):
    grid, (j0, j1), (t0, t1) = met
    kw = FIXED[name]
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=-1, method=0, **kw)
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=1.0 / kw["ifine"])
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    assert tcfg.ldirect == -1
    assert tadv.advance_args(tcfg, tprm, ITIME, MEM0, MEM1).ldirf == -1.0
    p = _particles(grid)
    key = jax.random.PRNGKey(7)
    draws = {t: torch.from_numpy(np.array(jrng.normals(key, (r, N), tag=t)))
             for t, r in {**TAGS, 2: kw["ifine"]}.items()}
    jp, jd = jadv.advance_all(p, j0, j1, jnp.int32(ITIME), jnp.int32(MEM0),
                              jnp.int32(MEM1), key, jcfg, jprm)
    tp, td = tadv.advance_all(_port(p), t0, t1, ITIME, MEM0, MEM1,
                              trng.Key(7, 0), tcfg, tprm, draws=draws)
    a, b = _numpy(tp), _numpy(jp)
    for c in ("x", "y"):
        np.testing.assert_allclose(a[c + "_hi"] + a[c + "_lo"],
                                   b[c + "_hi"] + b[c + "_lo"], rtol=0,
                                   atol=1e-4, err_msg=c)
    np.testing.assert_allclose(a["z"], b["z"], rtol=1e-4, atol=1e-2)
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    # the step ends before it began
    assert (a["itra"][a["active"]] == ITIME - LSYNC).all()
    for f in ("n_active", "n_exited", "nan_count"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f
    # and it is not the forward step: SyntheticMet's westerlies carry the
    # particles west, back in time
    fwd, _ = tadv.advance_all(_port(p), t0, t1, ITIME, MEM0, MEM1,
                              trng.Key(7, 0),
                              dataclasses.replace(tcfg, ldirect=1), tprm,
                              draws=draws)
    x0 = np.asarray(p.x_hi)
    on = a["active"]
    assert np.median((a["x_hi"] - x0)[on]) < 0.0 \
        < np.median((fwd.x_hi.numpy() - x0)[on])


def test_adaptive_advance_backward_matches_jax(met):
    grid, (j0, j1), (t0, t1) = met
    sp = [jconfig.Species(density=2500.0, dquer=10.0, dsigma=1.25),
          jconfig.Species()]
    scs = [s.size_classes() for s in sp]
    ifine = 2
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=-1, turbswitch=True,
                           ifine=ifine, method=1, nspec=2, settling=True)
    jprm = jadv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0 / ifine, ctl=5.0,
        sp_density=[max(s.density, -1.0) for s in sp],
        sp_dquer=[s.dquer for s in sp],
        sp_cunningham=[c.cunningham if c else 0.0 for c in scs],
        sp_vsetaver=[c.vsetaver if c else 0.0 for c in scs])
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    # the heights of tests/test_torch_adaptive.py
    p = _particles(grid, nspec=2, ztop=3000.0)
    key = jax.random.PRNGKey(5)
    draws = {t: np.asarray(jrng.normals(key, (r, N), tag=t))
             for t, r in ((6, 6), (3, 3), (4, 3))}
    for tag, rows in ((1, 2), (2, ifine)):
        draws[tag] = np.asarray(jax.vmap(lambda k: jrng.normals(
            jax.random.fold_in(key, 9000 + k), (rows, N), tag=tag))(
                jnp.arange(PASSES)))
    jp, jd = jadv.advance_all(p, j0, j1, jnp.int32(ITIME), jnp.int32(MEM0),
                              jnp.int32(MEM1), key, jcfg, jprm)
    tp, td = tadv.advance_all(
        _port(p), t0, t1, ITIME, MEM0, MEM1, trng.Key(5, 1), tcfg, tprm,
        draws={t: torch.from_numpy(np.array(v)) for t, v in draws.items()})
    a, b = _numpy(tp), _numpy(jp)
    passes = td.passes.numpy()
    assert passes.max() >= 3 and (passes > 0).sum() > N // 4
    same = a["idt"] == b["idt"]
    assert same.mean() >= 0.99, same.mean()
    for c in ("x", "y"):
        d = np.abs((a[c + "_hi"] + a[c + "_lo"])
                   - (b[c + "_hi"] + b[c + "_lo"]))
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
    assert (a["itra"][a["active"]] == ITIME - LSYNC).all()


# --------------------------------------------------------------- bkdep --

def _bkdep_particles(grid, nspec=2, seed=3):
    """Particles over the grid in the lowest 3 km, half of them fresh
    (xscav = -1), the rest with a factor from an earlier step; some
    inactive."""
    rs = np.random.default_rng(seed)
    fresh = rs.uniform(size=N) < 0.5
    xs = np.where(fresh[:, None], -1.0, 0.25).repeat(nspec, 1)
    p = jstate.empty_particles(N, nspec=nspec)
    return p._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, grid.nx - 1.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.0, grid.ny - 1.0, N), jnp.float32),
        z=jnp.asarray(rs.uniform(0.0, 3000.0, N), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.95),
        mass=jnp.asarray(rs.uniform(0.5, 1.5, (N, nspec)), jnp.float32),
        xscav=jnp.asarray(xs, jnp.float32))


def _assert_assigned_like_jax(tq, jq, p):
    a, b = _numpy(tq), _numpy(jq)
    np.testing.assert_array_equal(a["mass"] == 0, b["mass"] == 0)
    np.testing.assert_allclose(a["mass"], b["mass"], rtol=0, atol=0)
    np.testing.assert_allclose(a["xscav"], b["xscav"], rtol=1e-6, atol=0)
    fresh = np.asarray(p.active) & (np.asarray(p.xscav)[:, 0] < 0)
    # the fresh particles were assigned, the others kept their factor
    assert (a["xscav"][fresh] >= 0).all()
    np.testing.assert_array_equal(a["xscav"][~fresh],
                                  np.asarray(p.xscav)[~fresh])
    return a, fresh


def test_assign_wetbkdep_matches_jax(met):
    """WETBKDEP: the factor of SyntheticMet's scavenging at the particle
    times the 20 km column (two species: an aerosol and a gas)."""
    grid, (j0, _), (t0, _) = met
    species = (dict(crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                    in_aero=0.1, dquer=0.4),
               dict(weta_gas=1e-4, wetb_gas=0.8, henry=1.0e5))
    p = _bkdep_particles(grid)
    jq = jbk.assign_wetbkdep(p, j0, jnp.int32(ITIME), jnp.int32(LSYNC),
                             tuple(JWetSpecies.from_species(
                                 jconfig.Species(**s)) for s in species),
                             False, jnp.full(N, 20000.0, jnp.float32))
    tq = tbk.assign_wetbkdep(_port(p), t0, tuple(
        WetSpecies.from_species(tconfig.Species(**s)) for s in species))
    a, fresh = _assert_assigned_like_jax(tq, jq, p)
    # it rains on some of them, and the rest lose their mass
    assert (a["xscav"][fresh] > 0).sum() > 10
    assert (a["mass"][fresh] == 0).sum() > 10


def test_assign_wetbkdep_with_clwc_matches_jax(met):
    """WETBKDEP with ``use_clwc``: the in-cloud rule's cloud water from the
    column's, a numpy-seeded ``ctwc`` field in both packages (SyntheticMet
    processed without ``use_clwc`` leaves it at zero); the factors to the
    test above's limits, and unlike those of the rate's cloud water."""
    from flexpart_tpu_torch.met.fields import F2_CTWC
    grid, (j0, _), (t0, _) = met
    species = (dict(crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                    in_aero=0.1, dquer=0.4),
               dict(weta_gas=1e-4, wetb_gas=0.8, henry=1.0e5))
    ctwc = np.random.default_rng(9).uniform(0.0, 2.0, (grid.ny, grid.nx)) \
        .astype(np.float32)
    jf2 = np.array(j0.f2d)
    jf2[F2_CTWC] = ctwc
    tf2 = t0.f2d.clone()
    tf2[F2_CTWC] = torch.from_numpy(ctwc)
    p = _bkdep_particles(grid, seed=5)
    jq = jbk.assign_wetbkdep(p, j0._replace(f2d=jnp.asarray(jf2)),
                             jnp.int32(ITIME), jnp.int32(LSYNC),
                             tuple(JWetSpecies.from_species(
                                 jconfig.Species(**s)) for s in species),
                             True, jnp.full(N, 20000.0, jnp.float32))
    wet = tuple(WetSpecies.from_species(tconfig.Species(**s))
                for s in species)
    tq = tbk.assign_wetbkdep(_port(p), t0.replace(f2d=tf2), wet,
                             use_clwc=True)
    a, fresh = _assert_assigned_like_jax(tq, jq, p)
    assert (a["xscav"][fresh] > 0).sum() > 10
    rate = _numpy(tbk.assign_wetbkdep(_port(p), t0.replace(f2d=tf2), wet))
    assert not np.array_equal(rate["xscav"], a["xscav"])


def test_assign_drybkdep_matches_jax(met):
    """DRYBKDEP: the deposition velocity at the particle, from a field of
    which a tenth is not positive (those particles lose their mass)."""
    grid, _, _ = met
    rs = np.random.default_rng(8)
    vdep = (rs.uniform(0.0, 0.022, (2, grid.ny, grid.nx)) - 0.002) \
        .astype(np.float32)
    p = _bkdep_particles(grid, seed=4)
    jq = jbk.assign_drybkdep(p, jnp.asarray(vdep))
    tq = tbk.assign_drybkdep(_port(p), torch.from_numpy(vdep))
    a, fresh = _assert_assigned_like_jax(tq, jq, p)
    assert (a["mass"][fresh] == 0).sum() > 0
    assert (a["xscav"][fresh] > 0).sum() > 0.5 * fresh.sum()


# ---------------------------------------------------------- Simulation --

NS = 400          # the particles of tests/test_modes.py::test_backward_run
SEED = 4
NSTEPS = 24


def _sim_config(c):
    cmd = c.Command(ibdate=20200101, ibtime=60000, iedate=20200101,
                    ietime=120000, ldirect=-1, lsynctime=LSYNC,
                    loutstep=3600, loutaver=3600, loutsample=900,
                    lconvection=0)
    box = c.ReleaseBox(idate1=20200101, itime1=120000, idate2=20200101,
                       itime2=120000, lon1=-50.0, lon2=-48.0, lat1=42.0,
                       lat2=44.0, z1=100.0, z2=500.0, mass=(1.0,), parts=NS)
    og = c.OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=90, numygrid=45,
                   dxout=4.0, dyout=4.0, outheights=(500.0, 2000.0, 50000.0))
    return cmd, c.Releases(species=(c.Species(),), boxes=(box,)), og


@pytest.fixture(scope="module")
def jax_backward(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("jax_backward")
    cmd, rel, og = _sim_config(jconfig)
    grid = jmet.make_grid(**GRID)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=jmet.SyntheticMet(grid), outgrid=og,
                        outdir=str(outdir), seed=SEED, write_fortran=True)
    schedule = _numpy(sim.particles)
    sim.run()
    key = jax.random.PRNGKey(SEED)
    rows = {**DRAW_ROWS, 2: 1}           # ctl=-5: ifine_eff = 1
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, NS), tag=t))) for t, r in rows.items()}
        for i in range(NSTEPS)]
    return sim, outdir, schedule, draws


@pytest.fixture(scope="module")
def port_backward(jax_backward, tmp_path_factory):
    _, _, _, draws = jax_backward
    outdir = tmp_path_factory.mktemp("port_backward")
    cmd, rel, og = _sim_config(tconfig)
    grid = make_grid(**GRID)
    sim = Simulation(cmd=cmd, releases=rel, grid=grid,
                     met_backend=SyntheticMet(grid), outgrid=og,
                     outdir=str(outdir), seed=SEED, device="cpu",
                     write_fortran=True)
    schedule = _numpy(sim.particles)
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    return sim, outdir, schedule


def test_backward_simulation_schedule_and_files_equal_jax(jax_backward,
                                                          port_backward):
    jsim, jout, jsched, _ = jax_backward
    sim, tout, tsched = port_backward
    for f in FIELDS:
        np.testing.assert_array_equal(tsched[f], jsched[f], err_msg=f)
    assert sim.bkdep == jsim.bkdep == 0
    assert sim.last_itime == jsim.last_itime == -21600
    assert sim.timings["particle_steps"] == jsim.timings["particle_steps"] > 0
    jnames = sorted(q.name for q in Path(jout).iterdir())
    assert sorted(q.name for q in Path(tout).iterdir()) == jnames
    # the npz stem stays the reference's; the netCDF file is grid_time_
    assert len([n for n in jnames if n.startswith("grid_conc_")
                and n.endswith(".npz")]) == 5
    assert [n for n in jnames if n.endswith(".nc")] \
        == ["grid_time_20200101120000.nc"]
    assert (Path(tout) / "dates").read_text() \
        == (Path(jout) / "dates").read_text()
    assert sim.writer.nc_meta["units"] == jsim.writer.nc_meta["units"] == "s"
    for name in ("grid_time_20200101120000.nc",):
        with open_nc4(str(Path(jout) / name)) as j, \
                open_nc4(str(Path(tout) / name)) as t:
            assert sorted(t.keys()) == sorted(j.keys())
            assert t["spec001_mr"].attrs["units"] == "s"
            for k in ("ldirect", "ibdate", "ietime", "ind_receptor"):
                assert t.attrs[k] == j.attrs[k], k
            np.testing.assert_array_equal(t["time"][:], j["time"][:])
            np.testing.assert_array_equal(t["RELSTART"][:], j["RELSTART"][:])


def test_backward_simulation_positions_and_conc_match_jax(jax_backward,
                                                         port_backward):
    jsim, jout, jsched, _ = jax_backward
    sim, tout, tsched = port_backward
    a = _numpy(reorder.apply_perm(sim.particles, torch.argsort(sim._origin)))
    b = _numpy(jsim.particles)
    for f in ("active", "itra", "itramem", "npoint", "nclass", "mass",
              "xscav"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    # cbt, the sign of the last reflection, follows the z path
    assert np.mean(a["cbt"] == b["cbt"]) >= 0.98
    for c in ("x", "y"):
        err = np.abs((a[c + "_hi"] + a[c + "_lo"])
                     - (b[c + "_hi"] + b[c + "_lo"]))
        assert err.max() <= 2e-3, (c, err.max())
        assert (err > 1e-4).sum() <= FEW_SHARE * NS, (c, err.max())
    err_z = np.abs(a["z"] - b["z"])
    near = np.mean(err_z <= 1e-2 + 1e-4 * np.abs(b["z"]))
    assert near >= 0.85, near
    assert np.mean(err_z <= 1.0) >= 0.98, np.mean(err_z <= 1.0)
    assert abs(a["z"].mean() - b["z"].mean()) < 1.0
    # backward through the westerlies: the particles went west
    x0 = jsched["x_hi"][:NS]
    assert np.median(a["x_hi"][:NS] - x0) < -0.05
    for jf in sorted(Path(jout).glob("grid_conc_*.npz")):
        j, t = np.load(jf)["conc"], np.load(Path(tout) / jf.name)["conc"]
        assert j.max() > 0 and np.isfinite(t).all()
        err = np.abs(t - j) - 1e-5 * np.abs(j)
        assert (err > 1e-5 * j.max()).mean() <= 1e-3
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-5 * j.max())
        assert abs(t.sum() - j.sum()) <= 1e-5 * j.sum()


def test_backward_simulation_from_jax_carries_the_command(jax_backward,
                                                          tmp_path):
    """``interop.simulation_from_jax`` of a backward JAX run: the same
    Command (ldirect, the dates the run counts back from) and the same
    schedule, xscav included."""
    jsim, _, jsched, _ = jax_backward
    sim = interop.simulation_from_jax(jsim, "cpu", outdir=str(tmp_path))
    assert sim.cmd.ldirect == -1 and sim.cmd.bdate == jsim.cmd.bdate
    assert sim.cmd.ideltas == jsim.cmd.ideltas
    assert sorted(sim._release_times) == [0]
    a = _numpy(sim.particles)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], jsched[f], err_msg=f)


def _assert_residence_times_close(t, j):
    """The tolerance of the residence times above: rtol 1e-5 + 1e-5 of the
    largest cell for all but 0.1% of the cells, all within rtol 1e-3."""
    assert j.max() > 0 and np.isfinite(t).all()
    err = np.abs(t - j) - 1e-5 * np.abs(j)
    assert (err > 1e-5 * j.max()).mean() <= 1e-3
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-5 * j.max())


def test_backward_fortran_files_match_jax(jax_backward, port_backward):
    """The reference's unformatted files of the backward run: the header
    byte for byte but the version string (it states the run's end,
    iedate/ietime, and the release times counted back), the same
    ``grid_time_*_nnn`` names, each decoded to JAX's residence times
    within the tolerance above."""
    jsim, jout, _, _ = jax_backward
    sim, tout, _ = port_backward
    j = (Path(jout) / "header").read_bytes()
    t = (Path(tout) / "header").read_bytes()
    assert len(t) == len(j) and t[:12] == j[:12] and t[268:] == j[268:]
    h = read_header(Path(tout) / "header")
    assert (h["ibdate"], h["ibtime"]) == (20200101, 120000)
    assert h["releases"][0]["start"] == h["releases"][0]["end"] == 0
    names = sorted(q.name for q in Path(jout).glob("grid_*_001"))
    assert names == sorted(q.name for q in Path(tout).glob("grid_*_001"))
    assert len([n for n in names if n.startswith("grid_time_")]) == 5
    og = sim.outgrid
    nx, ny, nz = og.numxgrid, og.numygrid, len(og.outheights)
    for name in names:
        jt, jc, _, _ = read_grid_sparse(Path(jout) / name, nx, ny, nz)
        tt, tc, _, _ = read_grid_sparse(Path(tout) / name, nx, ny, nz)
        assert tt == jt < 0
        if name.startswith("grid_time_"):
            _assert_residence_times_close(tc, jc)


@pytest.mark.parametrize("ldirect", [1, -1])
def test_simulation_header_equals_jax(ldirect, tmp_path):
    """The header each package's Simulation writes at construction, for a
    run with two species and two boxes released in its middle: forward
    from ibdate, backward from iedate with the release times negated and
    swapped; byte for byte but the version string."""
    times = (dict(itime1=80000, itime2=93000), dict(itime1=100000,
                                                    itime2=100000))
    heads = []
    for c, S, gridf, met in ((jconfig, JaxSimulation, jmet.make_grid,
                              jmet.SyntheticMet),
                             (tconfig, Simulation, make_grid, SyntheticMet)):
        cmd, _, og = _sim_config(c)
        cmd = dataclasses.replace(cmd, ldirect=ldirect)
        boxes = tuple(c.ReleaseBox(idate1=20200101, idate2=20200101,
                                   lon1=-50.0 + 10 * k, lon2=-48.0 + 10 * k,
                                   lat1=42.0, lat2=44.0, z1=100.0, z2=500.0,
                                   mass=(1.0, 0.5 * k), parts=48,
                                   comment=f"BOX{k}", **tm)
                      for k, tm in enumerate(times))
        rel = c.Releases(species=(c.Species(), c.Species(name="SO2")),
                         boxes=boxes)
        grid = gridf(**GRID)
        out = tmp_path / S.__module__.split(".")[0]
        kw = dict(device="cpu") if S is Simulation else {}
        sim = S(cmd=cmd, releases=rel, grid=grid, met_backend=met(grid),
                outgrid=og, outdir=str(out), seed=SEED, write_fortran=True,
                **kw)
        sim.close()
        heads.append((out / "header").read_bytes())
    j, t = heads
    assert len(t) == len(j) and t[:12] == j[:12] and t[268:] == j[268:]
    h = read_header(tmp_path / "flexpart_tpu_torch" / "header")
    starts = [(r["start"], r["end"]) for r in h["releases"]]
    if ldirect == 1:
        assert (h["ibdate"], h["ibtime"]) == (20200101, 60000)
        assert starts == [(7200, 12600), (14400, 14400)]
    else:
        assert (h["ibdate"], h["ibtime"]) == (20200101, 120000)
        # 08:00-09:30 and 10:00 are 4 h-2.5 h and 2 h before the 12:00 end
        assert starts == [(9000, 14400), (7200, 7200)]


def test_inversion_files_match_jax(jax_backward, tmp_path):
    """``linversionout = 1`` (the configuration of
    ``tests/test_modes.py::test_inversion_output`` on this file's run):
    one file per release and species named by the release date, appended
    each output step with its date and the surface layer's residence
    times.  The same records as JAX's; the values within the tolerance
    above.  The JAX run reuses the compiled advance of this file's run."""
    _, _, _, draws = jax_backward
    outs = []
    for c, S, gridf, met in ((jconfig, JaxSimulation, jmet.make_grid,
                              jmet.SyntheticMet),
                             (tconfig, Simulation, make_grid, SyntheticMet)):
        cmd, rel, og = _sim_config(c)
        cmd = dataclasses.replace(cmd, linversionout=1)
        grid = gridf(**GRID)
        out = tmp_path / S.__module__.split(".")[0]
        kw = dict(device="cpu") if S is Simulation else {}
        sim = S(cmd=cmd, releases=rel, grid=grid, met_backend=met(grid),
                outgrid=og, outdir=str(out), seed=SEED, write_fortran=True,
                write_netcdf=False, write_npz=False, **kw)
        if S is Simulation:
            sim._draws_hook = lambda istep, origin: {
                t: v[:, origin].contiguous() for t, v in draws[istep].items()}
        sim.run()
        outs.append(out)
    names = sorted(q.name for q in outs[0].glob("grid_*"))
    assert names == ["grid_time_20200101120000_001"]
    assert sorted(q.name for q in outs[1].glob("grid_*")) == names
    og = _sim_config(tconfig)[2]
    nx, ny = og.numxgrid, og.numygrid
    recs = []
    for out in outs:
        r = _RecReader((out / names[0]).read_bytes())
        steps = []
        while not r.eof:
            date, = struct.unpack("<i", r.rec())
            hms, = struct.unpack("<i", r.rec())
            ni, = struct.unpack("<i", r.rec())
            idx = np.frombuffer(r.rec(), np.int32, ni)
            nr, = struct.unpack("<i", r.rec())
            vals = np.frombuffer(r.rec(), np.float32, nr)
            steps.append((date, hms, sparse_decode(idx, vals, nx * ny,
                                                   index_offset=nx * ny)))
        recs.append(steps)
    j, t = recs
    assert [s[:2] for s in t] == [s[:2] for s in j]
    assert len(j) == 5 and j[0][:2] == (20200101, 103000)
    _assert_residence_times_close(np.stack([s[2] for s in t]),
                                  np.stack([s[2] for s in j]))

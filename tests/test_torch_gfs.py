"""The port's NCEP GFS met input: ``met/gfsmet``, ``met/pblprofile``, and
the isobaric-level and cloud-water paths of ``met/verttransform`` and
``met/calcpar``, mirroring ``tests/test_gfs.py`` on the port and against
the JAX package on the same file (``test_gfs.make_gfs_file``: 8 isobaric
levels on a 10-degree 0..350 E grid, a terrain block where ps = 80 kPa
puts three levels below ground, cloud water on every level).

Tolerances against JAX:
- ``grid_from_gfs_grib``, ``eta_from_gfs_grib`` and ``pbl_profile``:
  bitwise (the same float64 numpy);
- ``process_eta`` with ``pressure_levels`` and ``use_clwc``: every 3-D
  field within rtol 1e-5 plus 1e-6 of its largest value
  (``tests/test_torch_met.py``'s limits: log, exp and pow differ by an ulp,
  and the column integral carries it up), w plus 1e-5 of its largest
  (``W_ATOL``), the cloud classes exactly, ``ctwc`` and ``cloudsh`` within
  rtol 1e-5;
- ``calcpar``: ``hmix`` within 5e-5 (``lsubgrid``: the excess orography
  is zero here, but ``hmixplus`` is computed), the others within 1e-5;
- a small GFS ``Simulation`` with ``use_clwc`` (the tracer and a
  scavenged aerosol, 304 particles, two hours, ``lconvection=0``) with
  JAX's draws injected: the particles to ``tests/test_torch_sim.py``'s
  limits (x and y within 1e-4 grid units for all but 0.5%, those within
  ten times as much; z as a distribution), the wet deposit of each
  species in total within rtol 1e-5 and cell by cell within 1e-5 of the
  largest cell.  One JAX ``Simulation`` in the file (module-scoped).
"""
from datetime import datetime

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.met import gfsmet as jgfsmet  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.io import gribio  # noqa: E402
from flexpart_tpu_torch.met import calcpar as tcalcpar  # noqa: E402
from flexpart_tpu_torch.met import fields as tf  # noqa: E402
from flexpart_tpu_torch.met.gfsmet import (GfsMet, eta_from_gfs_grib,  # noqa: E402
                                           grid_from_gfs_grib, looks_like_gfs)
from flexpart_tpu_torch.met.pblprofile import pbl_profile  # noqa: E402
from flexpart_tpu_torch.met.verttransform import (compute_heights,  # noqa: E402
                                                  process_eta)
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

from test_gfs import NX, PLEVELS, make_gfs_file  # noqa: E402

RTOL = 1e-5
# w's eta-slope correction is the difference of the level heights of two
# neighbouring columns at one height (a few metres, where the file's
# temperatures are noisy) times 1/cos(lat), 5.8 at 80 degrees: the ulp by
# which torch's and XLA's log differ in the height integral (up to 2e-3 m
# at 10 km, with jax.disable_jit too) shows there; measured 7.8e-6 of the
# largest |w|, at 6 of 5,624 values, all on the rows at 80 N and 80 S
W_ATOL = 1e-5
N = 304
SEED = 5
HOURS = 4
NSTEPS = 8
ROWS = {**DRAW_ROWS, 2: 1}          # ctl=-5: ifine_eff = 1
FEW_SHARE = 0.005


@pytest.fixture(scope="module")
def gfs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gfs")
    path = make_gfs_file(tmp)
    grid = grid_from_gfs_grib(path)
    eta = eta_from_gfs_grib(path, grid, device="cpu")
    return path, grid, eta


@pytest.fixture(scope="module")
def jax_gfs(gfs):
    path = gfs[0]
    grid = jgfsmet.grid_from_gfs_grib(path)
    return grid, jgfsmet.eta_from_gfs_grib(path, grid)


def test_detect_and_grid(gfs, jax_gfs):
    path, grid, eta = gfs
    assert looks_like_gfs(path)
    assert grid.pressure_levels
    assert grid.nlev == len(PLEVELS)
    assert grid.xglobal and grid.nx == NX + 1
    assert grid.xlon0 == -179.0
    assert grid.akm[0] == 100000.0 and grid.akm[-1] == 10000.0
    np.testing.assert_array_equal(grid.bkm, 0.0)
    jgrid = jax_gfs[0]
    for k in ("nx", "ny", "nlev", "xlon0", "ylat0", "dx", "dy", "xglobal",
              "pressure_levels"):
        assert getattr(grid, k) == getattr(jgrid, k), k
    assert grid.akm.tobytes() == jgrid.akm.tobytes()
    assert grid.bkm.tobytes() == jgrid.bkm.tobytes()


def test_lon_roll_roundtrip(gfs):
    """The roll puts input column j at output column (j + i179) % nx, and
    the cyclic column repeats the first."""
    path, grid, eta = gfs
    msgs = [m for m in gribio.scan(path)
            if m.param == 2002 and m.level_type == 100
            and m.level == 100000]
    raw = msgs[0].values()
    u0 = eta.uuh[0].numpy()
    i179 = int(round(179.0 / grid.dx))
    np.testing.assert_allclose(u0[:, :NX], np.roll(raw, i179, axis=1),
                               rtol=1e-5)
    np.testing.assert_array_equal(u0[:, -1], u0[:, 0])


def test_rh_conversion_and_td2(gfs):
    _, _, eta = gfs
    q = eta.qvh.numpy()
    assert (q > 0).all() and (q < 0.05).all()
    assert q[0].mean() > q[-1].mean() * 2
    td2, tt2 = eta.td2.numpy(), eta.tt2.numpy()
    assert (td2 <= tt2 + 0.5).all() and (td2 > 230.0).all()


def test_profile_method_fluxes(gfs):
    _, _, eta = gfs
    s, h = eta.surfstr.numpy(), eta.sshf.numpy()
    assert (s > 0).all() and (s < 10.0).all()
    assert (h >= -400.0).all() and (h <= 200.0).all()
    assert np.isfinite(s).all() and np.isfinite(h).all()


def test_precip_split(gfs):
    _, _, eta = gfs
    ls, cv = eta.lsprec.numpy(), eta.convprec.numpy()
    assert (ls >= 0).all() and (cv >= 0).all()
    assert ls.max() < 5.0 and cv.max() < 5.0
    assert cv.max() > 0.0 and ls.max() > 0.0


def test_eta_from_gfs_grib_equals_jax_bitwise(gfs, jax_gfs):
    _, _, eta = gfs
    jeta = jax_gfs[1]
    for k in tf.ETA_FIELDS:
        a, b = getattr(eta, k).numpy(), np.asarray(getattr(jeta, k))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_pbl_profile_scalar_cases():
    """Neutral (hf = 0), no shear (ustar = 0.01) and stable (hf > 0), as
    tests/test_gfs.py holds JAX's."""
    ps = np.full(3, 101325.0)
    td2 = np.full(3, 280.0)
    t2 = np.array([288.0, 288.0, 288.0])
    tml1 = np.array([288.0 - 0.0098 * 28.0, 290.0, 291.0])
    u10 = np.array([5.0, 5.0, 5.0])
    uml1 = np.array([7.0, 5.0, 7.0])
    stress, hf = pbl_profile(ps, td2, 30.0, t2, tml1, u10, uml1)
    rhoa = 101325.0 / (287.05 * (288.0 * (1 + 0.378 * 991.8 / 101325.0)))
    ust_n = 0.40 * 2.0 / np.log(3.0)
    assert abs(stress[0] - ust_n ** 2 * rhoa) / stress[0] < 0.05
    assert hf[0] == 0.0
    assert abs(stress[1] - 0.01 ** 2 * rhoa) / stress[1] < 0.05
    assert hf[1] == 0.0
    assert hf[2] > 0.0 and stress[2] > 0.0


def test_pbl_profile_equals_jax_bitwise():
    """Every regime at once on random columns: the same float64 numpy."""
    rng = np.random.default_rng(7)
    n = 4096
    ps = rng.uniform(8e4, 1.03e5, n)
    t2 = rng.uniform(250.0, 310.0, n)
    td2 = t2 - rng.uniform(0.0, 15.0, n)
    tml1 = t2 + rng.uniform(-3.0, 3.0, n)
    u10 = rng.uniform(0.0, 12.0, n)
    uml1 = u10 + rng.uniform(-1.0, 6.0, n)
    a = pbl_profile(ps, td2, 30.0, t2, tml1, u10, uml1)
    b = jgfsmet.pbl_profile(ps, td2, 30.0, t2, tml1, u10, uml1)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_verttransform_below_ground(gfs):
    """Columns with ps = 80 kPa: the 100 / 92.5 / 85 kPa levels are below
    ground; the z grid's bottom takes the first above-ground level's
    values, and heights and density stay physical."""
    _, grid, eta = gfs
    height = compute_heights(grid, eta)
    assert height[0] == 0.0 and (np.diff(height) > 0).all()
    assert 2500.0 < height[3] < 12000.0
    zf = tcalcpar.calcpar(grid, eta, process_eta(grid, eta, height,
                                                 use_clwc=True))
    u, tt = zf.f3d[tf.F3_U].numpy(), zf.f3d[tf.F3_TT].numpy()
    rho = zf.f3d[tf.F3_RHO].numpy()
    assert np.isfinite(u).all() and np.isfinite(rho).all()
    assert (rho > 0).all() and (rho[0] > rho[-1]).all()
    np.testing.assert_allclose(u[0, 9, 30], eta.uuh[3, 9, 30].item(),
                               rtol=1e-4)
    np.testing.assert_allclose(u[0, 2, 2], eta.uuh[0, 2, 2].item(),
                               rtol=1e-4)
    assert 200.0 < tt.min() and tt.max() < 320.0


def test_hmix_ignores_below_ground_levels(gfs):
    """Poisoning the below-ground isobaric levels (p > ps) changes
    neither hmix, nor the Obukhov length, nor the tropopause."""
    _, grid, eta = gfs
    height = compute_heights(grid, eta)
    z = process_eta(grid, eta, height, use_clwc=True)
    base = tcalcpar.calcpar(grid, eta, z)
    below = torch.as_tensor(grid.akm, dtype=torch.float32)[:, None, None] \
        >= eta.ps[None]
    assert bool(below.any())
    bad = eta.__class__(**{k: getattr(eta, k) for k in tf.ETA_FIELDS})
    bad.tth = torch.where(below, 150.0, eta.tth)
    bad.uuh = torch.where(below, 80.0, eta.uuh)
    poisoned = tcalcpar.calcpar(grid, bad, z)
    for k in (tf.F2_HMIX, tf.F2_OLI, tf.F2_TROPO):
        np.testing.assert_allclose(base.f2d[k].numpy(),
                                   poisoned.f2d[k].numpy(), rtol=1e-5)


@pytest.fixture(scope="module")
def preprocessed(gfs, jax_gfs):
    _, grid, eta = gfs
    jgrid, jeta = jax_gfs
    th = compute_heights(grid, eta)
    jh = jmet.compute_heights(jgrid, jeta)
    tz = process_eta(grid, eta, th, use_clwc=True)
    jz = jmet.process_eta(jgrid, jeta, jh, use_clwc=True)
    return th, jh, tz, jz, tcalcpar.calcpar(grid, eta, tz, lsubgrid=True), \
        jmet.calcpar(jgrid, jeta, jz, lsubgrid=True)


def test_process_eta_pressure_levels_clwc_matches_jax(preprocessed):
    th, jh, tz, jz, _, _ = preprocessed
    np.testing.assert_allclose(th, jh, rtol=1e-12)
    f3t, f3j = tz.f3d.numpy(), np.asarray(jz.f3d)
    for name in ("F3_U", "F3_V", "F3_W", "F3_RHO", "F3_DRHODZ", "F3_TT",
                 "F3_QV", "F3_CLW"):
        k = getattr(tf, name)
        atol = (W_ATOL if name == "F3_W" else 1e-6) * np.abs(f3j[k]).max()
        np.testing.assert_allclose(f3t[k], f3j[k], rtol=RTOL,
                                   atol=atol + 1e-30, err_msg=name)
    clouds = tz.clouds.numpy()
    np.testing.assert_array_equal(clouds, np.asarray(jz.clouds))
    # the file's cloud water puts clouds in every column that rains
    assert ((clouds == 2) | (clouds == 3)).any()
    f2t, f2j = tz.f2d.numpy(), np.asarray(jz.f2d)
    assert f2j[tf.F2_CTWC].max() > 0.0
    for k in (tf.F2_CTWC, tf.F2_CLOUDSH):
        np.testing.assert_allclose(f2t[k], f2j[k], rtol=RTOL, atol=1e-30)
    # below-ground levels: the z grid's bottom is the first level above
    # ground in the terrain block, in both
    assert float(np.asarray(jz.f3d)[tf.F3_U, 0, 9, 30]) \
        == pytest.approx(float(f3t[tf.F3_U, 0, 9, 30]), rel=RTOL)


def test_calcpar_pressure_levels_matches_jax(preprocessed):
    _, _, _, _, tc, jc = preprocessed
    f2t, f2j = tc.f2d.numpy(), np.asarray(jc.f2d)
    for name in ("F2_USTAR", "F2_OLI", "F2_WSTAR", "F2_TROPO", "F2_HMIX"):
        k = getattr(tf, name)
        rtol = 5e-5 if name == "F2_HMIX" else RTOL
        np.testing.assert_allclose(f2t[k], f2j[k], rtol=rtol, atol=1e-30,
                                   err_msg=name)


# ----- a small GFS run with use_clwc, against JAX -----

def _species(c):
    return (c.Species(),
            c.Species(name="CS-137", crain_aero=1.0, csnow_aero=1.0,
                      ccn_aero=0.9, in_aero=0.1, dquer=0.4))


def _config(c):
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=20000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=0, lon1=-60.0, lon2=-40.0, lat1=0.0,
                       lat2=20.0, z1=100.0, z2=2000.0, mass=(1.0, 1.0),
                       parts=N)
    og = c.OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=36, numygrid=18,
                   dxout=10.0, dyout=10.0,
                   outheights=(500.0, 2000.0, 50000.0))
    return dict(cmd=cmd, releases=c.Releases(species=_species(c),
                                             boxes=(box,)), outgrid=og)


@pytest.fixture(scope="module")
def gfs_met(tmp_path_factory):
    met = tmp_path_factory.mktemp("gfs_met")
    for h in range(HOURS):
        make_gfs_file(met, name=f"GF2020010100{h}")
    return met


def _backend(c, cls, met):
    entries = tuple(c.WindFieldEntry(time=datetime(2020, 1, 1, h),
                                     filename=f"GF2020010100{h}")
                    for h in range(HOURS))
    return cls(metdata=met, entries=entries, bdate=datetime(2020, 1, 1))


@pytest.fixture(scope="module")
def jax_run(gfs_met, tmp_path_factory):
    outdir = tmp_path_factory.mktemp("jax_gfs_run")
    b = _backend(jconfig, jgfsmet.GfsMet, gfs_met)
    sim = JaxSimulation(**_config(jconfig), grid=b.grid(), met_backend=b,
                        outdir=str(outdir), write_netcdf=False,
                        wind_interval=b.wind_interval, seed=SEED,
                        use_clwc=b.sumclouds)
    sim.run()
    key = jax.random.PRNGKey(SEED)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS + 1)]
    return sim, draws


def _assert_close(a, b, atol, what):
    err = np.abs(a - b)
    assert err.max() <= 10 * atol, (what, err.max())
    assert int((err > atol).sum()) <= FEW_SHARE * len(a), (what, err.max())


def test_gfs_run_with_clwc_against_jax(jax_run, gfs_met, tmp_path):
    jsim, draws = jax_run
    b = _backend(tconfig, GfsMet, gfs_met)
    assert b.sumclouds
    sim = Simulation(**_config(tconfig), grid=b.grid(), met_backend=b,
                     outdir=str(tmp_path), write_netcdf=False,
                     wind_interval=b.wind_interval, seed=SEED,
                     use_clwc=b.sumclouds, device="cpu")
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    assert sim.use_clwc and sim.grid.pressure_levels
    assert sim.timings["particle_steps"] == jsim.timings["particle_steps"] > 0
    order = torch.argsort(sim._origin).numpy()
    a = {f: v[order] for f, v in interop.particles_to_numpy(
        sim.particles).items()}
    bj = {f: np.asarray(getattr(jsim.particles, f)) for f in FIELDS}
    for f in ("active", "itra", "itramem", "npoint", "nclass", "cbt"):
        np.testing.assert_array_equal(a[f], bj[f], err_msg=f)
    assert int(a["active"].sum()) == N
    _assert_close(a["x_hi"] + a["x_lo"], bj["x_hi"] + bj["x_lo"], 1e-4, "x")
    _assert_close(a["y_hi"] + a["y_lo"], bj["y_hi"] + bj["y_lo"], 1e-4, "y")
    err_z = np.abs(a["z"] - bj["z"])
    assert np.mean(err_z <= 1e-2 + 1e-4 * np.abs(bj["z"])) >= 0.85
    assert np.mean(err_z <= 1.0) >= 0.98
    assert abs(a["z"].mean() - bj["z"].mean()) < 0.5
    # the aerosol is scavenged in cloud (the tracer not at all)
    wt = sim.acc.wetgridunc.numpy().reshape(-1, 2).astype(np.float64)
    wj = np.asarray(jsim.acc.wetgridunc).reshape(-1, 2).astype(np.float64)
    assert wt[:, 0].sum() == wj[:, 0].sum() == 0.0
    assert wj[:, 1].sum() > 1e-3
    np.testing.assert_allclose(wt.sum(axis=0), wj.sum(axis=0), rtol=RTOL)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=RTOL * wj.max())
    np.testing.assert_allclose(a["mass"], bj["mass"], rtol=1e-4)

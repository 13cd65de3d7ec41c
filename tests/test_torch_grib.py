"""The port's ECMWF GRIB met input: the decoder binding (``io/gribio``)
and ``met/gribmet``, against the JAX package's on the same files.

The GRIB files are written by ``tests/test_gribdec.py``'s encoders
(``encode_grib2_simple``, ``encode_grib1_simple`` and its full wind-field
file, here with cloud liquid and ice water, parameters 246 and 247, on
every model level).

- The decoder library is built from ``native/gribdec/gribdec.cpp`` into
  ``build/gribdec/`` (never the committed binary), once, however many
  threads ask for it first; without ``g++`` the build raises by name.
- ``scan`` and ``values``: every message's metadata and values bitwise
  equal to the JAX package's, ``pv`` included, on GRIB1 and GRIB2.
- ``grid_from_grib`` (with and without ``nxshift``) and ``eta_from_grib``
  (every field) bitwise equal to JAX's; ``GribMet``'s wind interval and
  its error for a missing time equal to JAX's.
- A port ``Simulation`` on ``GribMet`` ends bitwise where the same run on
  ``NpzMet`` archives of the decoded fields ends (the decode is the only
  difference, and it is taken out).
- ``tests/test_gribdec.py::test_grib_met_backend_end_to_end``'s run
  (300 particles, two hours, ``lconvection=0``, a 10-degree global grid
  that reaches both poles) through both packages, JAX's draws injected
  into the port, held to ``tests/test_torch_sim.py``'s limits: the mask,
  ``cbt`` and ``itra`` exactly; x and y within 1e-4 grid units for all but
  0.5% of the particles and those within ten times as much; z as a
  distribution (85% within 1e-2 m + 1e-4 relative, 98% within 1 m, the
  mean within 0.5 m); ``conc`` within rtol 1e-5 plus 1e-5 of its largest
  cell.  One JAX ``Simulation`` in the file (module-scoped).
"""
import threading
from datetime import datetime
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.io import gribio as jgribio  # noqa: E402
from flexpart_tpu.met import gribmet as jgribmet  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.io import gribio  # noqa: E402
from flexpart_tpu_torch.met import gribmet  # noqa: E402
from flexpart_tpu_torch.met.fields import ETA_FIELDS  # noqa: E402
from flexpart_tpu_torch.met.npzmet import NpzMet, save_eta_npz  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

from test_gribdec import (_full_windfield_grib, encode_grib1_simple,  # noqa: E402
                          encode_grib2_simple)

ROOT = Path(__file__).resolve().parent.parent
N = 300
SEED = 2
HOURS = 4
NSTEPS = 8
ROWS = {**DRAW_ROWS, 2: 1}          # ctl=-5: ifine_eff = 1
FEW_SHARE = 0.005


def _windfield_with_clouds(path, tsec):
    """``_full_windfield_grib``'s file (36 x 19 x 8, 10 degrees) and, on
    every model level, cloud liquid water (246) and cloud ice water
    (247) in a band of clouds."""
    _full_windfield_grib(path, tsec)
    y, x = np.mgrid[0:19, 0:36]
    blobs = []
    for lev in range(1, 9):
        cloud = np.where((y > 4) & (y < 12) & (lev > 4),
                         1e-4 * (1.0 + np.sin(x / 4.0)), 0.0)
        for num, f in ((83, cloud), (84, 0.25 * cloud * (y % 3))):
            blobs.append(encode_grib2_simple(
                f, lat1=-90.0, lon1=0.0, dlat=10.0, dlon=10.0, disc=0,
                cat=1, num=num, level_type=105, level=lev))
    with open(path, "ab") as f:
        f.write(b"".join(blobs))


@pytest.fixture(scope="module")
def metdir(tmp_path_factory):
    """Four hourly ECMWF-style files and their index entries (for both
    packages' config types)."""
    met = tmp_path_factory.mktemp("grib_met")
    for h in range(HOURS):
        _windfield_with_clouds(met / f"EN2020010100{h}", h * 3600)
    return met


def _entries(c, met):
    return tuple(c.WindFieldEntry(time=datetime(2020, 1, 1, h),
                                  filename=f"EN2020010100{h}")
                 for h in range(HOURS))


def _backends(met):
    bdate = datetime(2020, 1, 1)
    return (jgribmet.GribMet(metdata=met, entries=_entries(jconfig, met),
                             bdate=bdate),
            gribmet.GribMet(metdata=met, entries=_entries(tconfig, met),
                            bdate=bdate))


def test_decoder_is_built_from_source_once(tmp_path, monkeypatch):
    """Eight threads ask for the library of an empty build directory at
    once: one g++ build of native/gribdec/gribdec.cpp, one library, loaded
    from there; never the committed binary."""
    lib = gribio._lib()
    assert Path(lib._name).parent == ROOT / "build" / "gribdec"
    assert Path(lib._name).name.startswith("libgribdec-")
    cmd = gribio.build_command(tmp_path / "x.so")
    assert str(ROOT / "native" / "gribdec" / "gribdec.cpp") in cmd
    for flag in ("-O2", "-fPIC", "-std=c++17", "-shared"):
        assert flag in cmd

    monkeypatch.setattr(gribio, "BUILD_DIR", tmp_path / "gribdec")
    monkeypatch.setattr(gribio, "_LIB", [])
    builds = []
    build = gribio._build
    monkeypatch.setattr(gribio, "_build",
                        lambda out: (builds.append(out), build(out)))
    got = [None] * 8

    def ask(i):
        got[i] = gribio._lib()

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and all(g is got[0] for g in got)
    assert Path(got[0]._name).parent == tmp_path / "gribdec"
    assert sorted(p.name for p in (tmp_path / "gribdec").iterdir()) \
        == [builds[0].name]


def test_missing_compiler_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(gribio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        gribio.build_command(tmp_path / "x.so")


@pytest.mark.parametrize("edition", [1, 2])
def test_scan_and_values_equal_jax_bitwise(edition, tmp_path):
    ny, nx = 19, 36
    y, x = np.mgrid[0:ny, 0:nx]
    blobs = []
    for k in range(3):
        f = 280.0 + 20.0 * np.sin(x / (5.0 + k)) * np.cos(y / 3.0)
        if edition == 1:
            blobs.append(encode_grib1_simple(
                f, lat1=-90.0, lon1=0.0, dlat=10.0, dlon=10.0, param=130,
                level_type=109, level=k + 1, pv=[0.0, 3000.0, 1.0, 0.5]))
        else:
            blobs.append(encode_grib2_simple(
                f, lat1=-90.0, lon1=0.0, dlat=10.0, dlon=10.0, disc=0,
                cat=0, num=k, level_type=105, level=k + 1,
                pv=[0.0, 5000.0, 10000.0, 1.0, 0.6, 0.1][:6 - 2 * k]))
    p = tmp_path / f"t.grib{edition}"
    p.write_bytes(b"".join(blobs))
    mj, mt = jgribio.scan(p), gribio.scan(p)
    assert len(mj) == len(mt) == 3
    for a, b in zip(mj, mt):
        assert a.edition == b.edition == edition
        for f in ("path", "offset", "length", "param", "level_type",
                  "level", "nx", "ny", "lat1", "lon1", "lat2", "lon2",
                  "dlat", "dlon", "date", "time", "step"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.pv.dtype == b.pv.dtype and a.pv.tobytes() == b.pv.tobytes()
        va, vb = a.values(), b.values()
        assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes()


@pytest.mark.parametrize("nxshift", [0, 9])
def test_grid_equals_jax(nxshift, metdir):
    f = metdir / "EN20200101000"
    gj = jgribmet.grid_from_grib(f, nxshift=nxshift)
    gt = gribmet.grid_from_grib(f, nxshift=nxshift)
    for k in ("nx", "ny", "nlev", "xlon0", "ylat0", "dx", "dy", "xglobal",
              "pressure_levels"):
        assert getattr(gt, k) == getattr(gj, k), k
    assert gt.akm.tobytes() == gj.akm.tobytes()
    assert gt.bkm.tobytes() == gj.bkm.tobytes()
    assert (gt.nx, gt.nlev) == (37, 9)


@pytest.mark.parametrize("nxshift", [0, 9])
def test_eta_from_grib_equals_jax_bitwise(nxshift, metdir):
    f = metdir / "EN20200101001"
    g = gribmet.grid_from_grib(f, nxshift=nxshift)
    ej = jgribmet.eta_from_grib(f, jgribmet.grid_from_grib(f,
                                                           nxshift=nxshift),
                                nxshift=nxshift)
    times = gribmet.ReadTimes()
    et = gribmet.eta_from_grib(f, g, nxshift=nxshift, device="cpu",
                               times=times)
    for k in ETA_FIELDS:
        a, b = np.asarray(getattr(ej, k)), getattr(et, k).numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    # the cloud water is liquid + ice, and the file carried both
    assert float(et.clwch.max()) > 0.0
    assert times.files == 1 and times.seconds["decode"] > 0.0
    assert set(times.seconds) == {"scan", "decode", "assembly", "copy"}


def test_gribmet_interval_and_missing_time_equal_jax(metdir):
    jm, tm = _backends(metdir)
    assert tm.wind_interval == jm.wind_interval == 3600
    errors = []
    for fetch in (lambda: jm.fetch(7200.0 + 1.0),
                  lambda: tm.fetch(7200.0 + 1.0, "cpu")):
        with pytest.raises(FileNotFoundError) as err:
            fetch()
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "no GRIB wind field for t=7201s"
    assert tm.grid() is tm.grid()


def _config(c):
    """tests/test_gribdec.py::test_grib_met_backend_end_to_end's run."""
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=20000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=0, lon1=100.0, lon2=110.0, lat1=-10.0,
                       lat2=0.0, z1=100.0, z2=500.0, mass=(1.0,),
                       parts=N)
    og = c.OutGrid(outlon0=0.0, outlat0=-90.0, numxgrid=36, numygrid=18,
                   dxout=10.0, dyout=10.0,
                   outheights=(500.0, 2000.0, 50000.0))
    return dict(cmd=cmd, releases=c.Releases(species=(c.Species(),),
                                             boxes=(box,)), outgrid=og)


def _port_sim(backend, outdir, **kw):
    return Simulation(**_config(tconfig), grid=backend.grid(),
                      met_backend=backend, outdir=str(outdir),
                      write_netcdf=False,
                      wind_interval=backend.wind_interval, seed=SEED,
                      device="cpu", **kw)


def _numpy_particles(p):
    if hasattr(p, "_asdict"):
        return {f: np.asarray(getattr(p, f)) for f in FIELDS}
    return interop.particles_to_numpy(p)


@pytest.fixture(scope="module")
def jax_run(metdir, tmp_path_factory):
    outdir = tmp_path_factory.mktemp("jax_grib")
    backend = _backends(metdir)[0]
    sim = JaxSimulation(**_config(jconfig), grid=backend.grid(),
                        met_backend=backend, outdir=str(outdir),
                        write_netcdf=False,
                        wind_interval=backend.wind_interval, seed=SEED)
    sim.run()
    key = jax.random.PRNGKey(SEED)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS + 1)]
    return sim, outdir, draws


def _assert_close(a, b, atol, what):
    err = np.abs(a - b)
    assert err.max() <= 10 * atol, (what, err.max())
    assert int((err > atol).sum()) <= FEW_SHARE * len(a), (what, err.max())


def test_grib_run_against_jax_with_injected_draws(jax_run, metdir,
                                                  tmp_path):
    jsim, jout, draws = jax_run
    sim = _port_sim(_backends(metdir)[1], tmp_path)
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    assert sim.step_cfg.polar and sim.timings["particle_steps"] \
        == jsim.timings["particle_steps"] > 0
    order = torch.argsort(sim._origin)
    a = _numpy_particles(sim.particles)
    a = {f: v[order.numpy()] for f, v in a.items()}
    b = _numpy_particles(jsim.particles)
    for f in ("active", "itra", "itramem", "npoint", "nclass", "cbt"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert int(a["active"].sum()) == N
    _assert_close(a["x_hi"] + a["x_lo"], b["x_hi"] + b["x_lo"], 1e-4, "x")
    _assert_close(a["y_hi"] + a["y_lo"], b["y_hi"] + b["y_lo"], 1e-4, "y")
    err_z = np.abs(a["z"] - b["z"])
    assert np.mean(err_z <= 1e-2 + 1e-4 * np.abs(b["z"])) >= 0.85
    assert np.mean(err_z <= 1.0) >= 0.98
    assert abs(a["z"].mean() - b["z"].mean()) < 0.5
    jnpz = sorted(Path(jout).glob("grid_conc_*.npz"))
    assert [p.name for p in sorted(tmp_path.glob("grid_conc_*.npz"))] \
        == [p.name for p in jnpz] and jnpz
    for jf in jnpz:
        j, t = np.load(jf)["conc"], np.load(tmp_path / jf.name)["conc"]
        assert j.max() > 0
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * j.max())


def test_grib_run_equals_npz_run_of_the_decoded_fields(metdir, tmp_path):
    """The same port run on GribMet and on npz archives that save_eta_npz
    wrote from GribMet.fetch: bitwise equal particles and conc."""
    backend = _backends(metdir)[1]
    npz = tmp_path / "npz"
    npz.mkdir()
    for h in range(HOURS):
        save_eta_npz(npz / f"EN2020010100{h}.npz",
                     backend.fetch(h * 3600.0, "cpu"), backend.grid())
    entries = tuple(tconfig.WindFieldEntry(
        time=datetime(2020, 1, 1, h), filename=f"EN2020010100{h}.npz")
        for h in range(HOURS))
    npzmet = NpzMet(metdata=npz, entries=entries,
                    bdate=datetime(2020, 1, 1))
    runs = []
    for name, b in (("grib", backend), ("npz", npzmet)):
        sim = Simulation(**_config(tconfig), grid=backend.grid(),
                         met_backend=b, outdir=str(tmp_path / name),
                         write_netcdf=False, wind_interval=b.wind_interval,
                         seed=SEED, device="cpu")
        sim.run()
        runs.append(sim)
    a, b = (_numpy_particles(s.particles) for s in runs)
    for f in FIELDS:
        assert a[f].tobytes() == b[f].tobytes(), f
    for f1 in sorted((tmp_path / "grib").glob("grid_conc_*.npz")):
        np.testing.assert_array_equal(
            np.load(f1)["conc"], np.load(tmp_path / "npz" / f1.name)["conc"])
    assert backend.read_times.files >= HOURS

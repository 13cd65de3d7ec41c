"""Port parity for the npz met backend (``met/npzmet.py``).

The same archives, written from numpy-seeded synthetic fields, go through
the JAX package's ``NpzMet`` and the port's:

* one archive is read into the same fields by both, every key bitwise
  (float32 both sides: the archive holds float32 and neither package
  computes on the read);
* ``grid_from_npz`` gives the same grid (sizes, corner, spacing, the
  hybrid coefficients bitwise, ``xglobal``);
* an archive written by either package's ``save_eta_npz`` holds the same
  keys, dtypes and values as the other's, and each package reads the
  other's;
* the wind interval and the error for a time the AVAILABLE index lacks
  are the same;
* a port ``Simulation`` on ``NpzMet`` equals, bitwise, the same
  ``Simulation`` on the ``SyntheticMet`` whose fields were dumped: the
  particles and every npz output (port only, 320 particles, the port's
  own Philox stream, on the CPU).
"""
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.config import read_available as jread_available  # noqa: E402
from flexpart_tpu.met import npzmet as jnpz  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.met import npzmet as tnpz  # noqa: E402
from flexpart_tpu_torch.met.fields import ETA_FIELDS, eta_from_numpy  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

GRID = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
BDATE = datetime(2020, 1, 1)
HOURS = 5


def _seeded_fields(grid, seed):
    """Synthetic fields with numpy-seeded noise on every field, so that no
    key is a smooth function either package could recompute."""
    eta = SyntheticMet(grid).fetch(0.0, "cpu")
    rng = np.random.default_rng(seed)
    out = {}
    for k in ETA_FIELDS:
        v = getattr(eta, k).numpy()
        out[k] = (v * (1.0 + 1e-3 * rng.standard_normal(v.shape))
                  ).astype(np.float32)
    return out


def _write_job(met, writer, seed=0):
    """An AVAILABLE index of HOURS hourly archives written by ``writer``
    ("jax" or "torch") from the same seeded fields."""
    met.mkdir(parents=True, exist_ok=True)
    tgrid = make_grid(**GRID)
    jgrid = jmet.make_grid(**GRID)
    lines = ["header"] * 3
    for h in range(HOURS):
        d = _seeded_fields(tgrid, seed + h)
        name = f"EN20200101{h:02d}.npz"
        if writer == "jax":
            jnpz.save_eta_npz(met / name, jmet.fields.eta_from_numpy(d), jgrid)
        else:
            tnpz.save_eta_npz(met / name, eta_from_numpy(d, "cpu"), tgrid)
        lines.append(f"20200101 {h:02d}0000      {name}      ON DISC")
    (met / "AVAILABLE").write_text("\n".join(lines) + "\n")
    return met / "AVAILABLE"


def _backends(met, avail):
    j = jnpz.NpzMet(metdata=met, entries=jread_available(avail), bdate=BDATE)
    t = tnpz.NpzMet(metdata=met, entries=tconfig.read_available(avail),
                    bdate=BDATE)
    return j, t


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_both_packages_read_an_archive_into_the_same_fields(writer, tmp_path):
    avail = _write_job(tmp_path / "met", writer)
    j, t = _backends(tmp_path / "met", avail)
    for tsec in (0.0, 3600.0 * (HOURS - 1)):
        je, te = j.fetch(tsec), t.fetch(tsec, "cpu")
        for k in ETA_FIELDS:
            a, b = np.asarray(getattr(je, k)), getattr(te, k).numpy()
            assert a.dtype == b.dtype == np.float32, k
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_grid_from_npz_equals_jax(writer, tmp_path):
    avail = _write_job(tmp_path / "met", writer)
    j, t = _backends(tmp_path / "met", avail)
    jg, tg = j.grid(), t.grid()
    for k in ("nx", "ny", "nlev", "xlon0", "ylat0", "dx", "dy", "xglobal",
              "pressure_levels"):
        assert getattr(tg, k) == getattr(jg, k), k
    for k in ("akm", "bkm"):
        assert getattr(tg, k).dtype == getattr(jg, k).dtype
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    assert tg.xglobal and tg.nx == 37


def test_archives_of_both_writers_are_the_same(tmp_path):
    """Each package's ``save_eta_npz`` writes the same keys, dtypes and
    values from the same fields, so each reads the other's."""
    _write_job(tmp_path / "jax", "jax")
    _write_job(tmp_path / "torch", "torch")
    for h in range(HOURS):
        name = f"EN20200101{h:02d}.npz"
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "torch" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            assert set(ETA_FIELDS) | {"akm", "bkm", "xlon0", "ylat0", "dx",
                                      "dy"} == set(a.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_wind_interval_and_missing_time_match_jax(tmp_path):
    avail = _write_job(tmp_path / "met", "torch")
    j, t = _backends(tmp_path / "met", avail)
    assert t.wind_interval == j.wind_interval == 3600
    for backend, call in ((j, lambda: j.fetch(1800.0)),
                          (t, lambda: t.fetch(1800.0, "cpu"))):
        with pytest.raises(FileNotFoundError, match="no wind field for "
                           "t=1800s in AVAILABLE"):
            call()
    # one archive: the reference's default interval
    one = tconfig.read_available(avail)[:1]
    assert tnpz.NpzMet(metdata=tmp_path / "met", entries=one,
                       bdate=BDATE).wind_interval == 3600
    assert jnpz.NpzMet(metdata=tmp_path / "met", entries=one,
                       bdate=BDATE).wind_interval == 3600


def _sim(outdir, met_backend, grid):
    cmd = tconfig.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                          ietime=30000, lsynctime=900, loutstep=3600,
                          loutaver=3600, loutsample=900)
    box = tconfig.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                             itime2=10000, lon1=0.0, lon2=2.0, lat1=40.0,
                             lat2=42.0, z1=50.0, z2=500.0, mass=(1.0,),
                             parts=320)
    rel = tconfig.Releases(species=(tconfig.Species(),), boxes=(box,))
    og = tconfig.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60,
                         numygrid=40, dxout=2.0, dyout=2.0,
                         outheights=(500.0, 2000.0, 50000.0))
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=met_backend, outgrid=og,
                      outdir=str(outdir), seed=7, device="cpu",
                      write_netcdf=False)


def test_simulation_on_npz_equals_simulation_on_the_dumped_met(tmp_path):
    """The default Command (convection, subgrid orography, the polar caps
    of a grid that reaches both poles) on SyntheticMet, and on the npz
    archives of SyntheticMet's fields: the same run bit for bit."""
    grid = make_grid(**GRID)
    synthetic = SyntheticMet(grid)
    met = tmp_path / "met"
    met.mkdir()
    lines = ["header"] * 3
    for h in range(HOURS):
        name = f"EN20200101{h:02d}.npz"
        tnpz.save_eta_npz(met / name, synthetic.fetch(h * 3600.0, "cpu"),
                          grid)
        lines.append(f"20200101 {h:02d}0000      {name}      ON DISC")
    (met / "AVAILABLE").write_text("\n".join(lines) + "\n")
    npz = tnpz.NpzMet(metdata=met,
                      entries=tconfig.read_available(met / "AVAILABLE"),
                      bdate=BDATE)
    a = _sim(tmp_path / "synthetic", synthetic, grid)
    a.run()
    b = _sim(tmp_path / "npz", npz, npz.grid())
    b.run()
    assert b.step_cfg == a.step_cfg
    assert int(a.particles.active.sum()) == 320
    pa = interop.particles_to_numpy(a.particles)
    pb = interop.particles_to_numpy(b.particles)
    for k in pa:
        np.testing.assert_array_equal(pb[k], pa[k], err_msg=k)
    names = sorted(p.name for p in (tmp_path / "synthetic").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "npz").iterdir())
    files = [n for n in names if n.endswith(".npz")]
    assert len(files) == 2
    for n in files:
        with np.load(tmp_path / "synthetic" / n) as x, \
                np.load(tmp_path / "npz" / n) as y:
            assert x["conc"].max() > 0
            for k in x.files:
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)
    assert Path(tmp_path / "npz" / "dates").read_text() \
        == Path(tmp_path / "synthetic" / "dates").read_text()

"""A regional domain fill on tiles, and a tiles checkpoint resumed, in gloo
groups of 4 ranks (a 1 x 4 tile mesh: the window spans two tiles) started by
``flexpart_tpu_torch.parallel.launch``.

The run is ``torch_tiles_ranks.port_domainfill``: tests/test_torch_
domainfill.py's window (60 W - 60 E, 30 S - 30 N of a 73 x 37 grid of 5
degree cells, a uniform 20 m/s westerly), 1000 particles of air in 2048
slots, turboff, 2 h.  Every rank keeps the whole site table and runs the
sites whose column its tile owns; a site draws by its global index.

* ``test_domainfill_tiles_matches_serial`` mirrors
  tests/test_torch_domainfill.py::test_regional_run_equals_jax on tiles:
  the sites' accumulators (summed over the group) equal to the port's
  serial run's bit for bit and to the JAX package's serial run's within
  that test's tolerance (rtol 1e-4, atol 1e-4 particle masses); with
  turboff the particles killed, wished and emitted each step equal to the
  serial run's and the live particles' rows bitwise its rows (other
  slots); every emitted particle a fresh origin, each once;
* ``test_tiles_checkpoint_resumes_bitwise`` mirrors
  tests/test_checkpoint.py's resume on tiles: the straight run writes a
  checkpoint at 1 h (every rank's slots, origins and partial grids, the
  boundary's accumulators), a second group resumes from it and ends with
  every rank's particles, origins and files equal to the straight run's
  bit for bit; a run of another tile capacity is refused by name.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import torch_tiles_ranks as tr  # noqa: E402
from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch.parallel import launch  # noqa: E402


def _launch(store, fn, n, *args):
    return launch.launch(fn, n, "cpu", args=args, threads=2,
                         store_dir=str(store))


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    out = tmp_path_factory.mktemp("serial")
    sim = tr.port_domainfill(out)
    sim.run()
    return tr.summary(sim)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The 4-rank run with its checkpoint at 1 h."""
    out = tmp_path_factory.mktemp("tiles")
    return out, _launch(out, tr.rank_domainfill, 4, str(out), 3600)


def _jax_serial(out):
    grid = jmet.make_grid(nx=73, ny=37, nlev=12, dx=5.0, dy=5.0)
    cmd = jconfig.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                          ietime=20000, lsynctime=900, loutstep=3600,
                          loutaver=3600, loutsample=900, lconvection=0,
                          mdomainfill=1)
    box = jconfig.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                             itime2=0, lon1=-60.0, lon2=60.0, lat1=-30.0,
                             lat2=30.0, z1=0.0, z2=50000.0, mass=(1.0,),
                             parts=1000)
    og = jconfig.OutGrid(outlon0=-60.0, outlat0=-30.0, numxgrid=24,
                         numygrid=12, dxout=5.0, dyout=5.0,
                         outheights=(2000.0, 50000.0))
    sim = JaxSimulation(cmd=cmd, releases=jconfig.Releases(
        species=(jconfig.Species(),), boxes=(box,)), grid=grid, outgrid=og,
        outdir=str(out), met_backend=jmet.uniform_wind_met(grid, u=20.0,
                                                           v=0.0),
        write_netcdf=False, seed=13, capacity=2048, turboff=True)
    sim.run()
    return np.asarray(sim._boundary.acc), float(sim._boundary.xpp)


def test_domainfill_tiles_matches_serial(serial, straight, tmp_path):
    out, res = straight
    got = res[0]
    assert tuple(got["mesh"]) == (1, 4)
    for other in res[1:]:
        np.testing.assert_array_equal(other["ensemble"], got["ensemble"])
        np.testing.assert_array_equal(other["boundary_acc"],
                                      got["boundary_acc"])
    np.testing.assert_array_equal(got["boundary_acc"],
                                  serial["boundary_acc"])
    jacc, xpp = _jax_serial(tmp_path / "jax")
    np.testing.assert_allclose(got["boundary_acc"], jacc, rtol=1e-4,
                               atol=1e-4 * xpp)
    steps = len(serial["boundary_counts"])
    assert len(got["boundary_counts"]) == steps == 9
    for a, b in zip(got["boundary_counts"], serial["boundary_counts"]):
        # killed, wished, granted (the free slots are the tiles')
        np.testing.assert_array_equal(a[[0, 2, 3]], b[[0, 2, 3]])
    assert sum(int(c[3]) for c in got["boundary_counts"]) > 0
    assert sum(int(c[0]) for c in got["boundary_counts"]) > 0
    np.testing.assert_array_equal(got["ensemble"], serial["ensemble"])
    origin = got["origin"]
    assert len(np.unique(origin)) == len(origin)
    assert 0 < (origin >= 2048).sum() <= got["next_origin"] - 2048


def test_tiles_checkpoint_resumes_bitwise(straight, tmp_path):
    out, res = straight
    ckpt = out / "checkpoint.npz"
    assert ckpt.exists()
    with np.load(ckpt) as d:
        assert tuple(d["tiles_mesh"]) == (1, 4)
        assert d["acc_gridunc"].shape[0] == 4
        assert int(d["tiles_local_cap"]) == res[0]["local_cap"]
    again = _launch(tmp_path, tr.rank_domainfill, 4, str(tmp_path / "r"),
                    None, str(ckpt))
    for a, b in zip(again, res):
        for f, v in b["particles"].items():
            np.testing.assert_array_equal(a["particles"][f], v, err_msg=f)
        np.testing.assert_array_equal(a["origin"], b["origin"])
        np.testing.assert_array_equal(a["boundary_acc"], b["boundary_acc"])
        assert a["next_origin"] == b["next_origin"]
    # the outputs from the checkpoint's hour on: every file the straight
    # run wrote, bit for bit
    names = sorted(q.name for q in out.iterdir() if q.suffix == ".npz"
                   and q.name != "checkpoint.npz")
    assert len(names) >= 1
    for name in names:
        da, db = np.load(out / name), np.load(tmp_path / "r" / name)
        for k in da.files:
            np.testing.assert_array_equal(db[k], da[k], err_msg=name)
    (tmp_path / "bad").mkdir()
    with pytest.raises(launch.RankFailed, match="tile capacity"):
        _launch(tmp_path / "bad", tr.rank_domainfill, 4,
                str(tmp_path / "bad"), None, str(ckpt), None,
                res[0]["local_cap"] + 8)

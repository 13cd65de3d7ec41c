"""The rebalance of a hot tile, and a tiles checkpoint written after it, in
gloo groups of 2 ranks (a 1 x 2 tile mesh) started by
``flexpart_tpu_torch.parallel.launch``, against the port's serial run and
the JAX package's serial run (one JAX run a file).

The run mirrors the reference's test_tiled_dynamic_rebalance
(tests/test_tiles_mode.py:151-205) on a 1 x 2 mesh: a 100 m/s westerly
carries a release into the tile whose own release fills its 26 slots; the
migration defers, and the group regroups at 52 slots (every schedulable
slot placed again by its owner, the draws' offset with the new capacity).
It writes a checkpoint at 1 h, after the regroup.

* ``test_tiled_dynamic_rebalance``: no particle is lost: 48 live, each
  origin once, the live ensemble within the reference's rtol 2e-4, atol
  1e-4 of the port's serial run and the JAX package's;
* ``test_tiles_checkpoint_after_regroup_resumes_bitwise`` mirrors
  tests/test_checkpoint.py's resume on tiles after a regroup: the
  checkpoint keeps the regrouped capacity, a run of the same configuration
  (26 slots asked for) resumes from it, and ends with every rank's
  particles, origins and files equal to the straight run's bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import torch_tiles_ranks as tr  # noqa: E402
from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu.met import make_grid as jmake_grid  # noqa: E402
from flexpart_tpu.met import uniform_wind_met as juniform  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch.parallel import launch  # noqa: E402

ENS_RTOL, ENS_ATOL = 2e-4, 1e-4


def _launch(store, fn, n, *args):
    return launch.launch(fn, n, "cpu", args=args, threads=2,
                         store_dir=str(store))


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The 2-rank run with its checkpoint at 1 h."""
    out = tmp_path_factory.mktemp("tiles")
    return out, _launch(out, tr.rank_rebalance, 2, str(out), 3600)


def test_tiled_dynamic_rebalance(straight, tmp_path):
    from flexpart_tpu_torch import Simulation, make_grid
    from flexpart_tpu_torch import config as tconfig
    from flexpart_tpu_torch.met import uniform_wind_met
    res = straight[1]
    got = res[0]
    assert tuple(got["mesh"]) == (1, 2)
    assert got["migrations"]["regroups"] >= 1
    assert got["local_cap"] >= 52, "the rebalance must grow the capacity"
    assert got["migrations"]["deferred"] > 0
    np.testing.assert_array_equal(res[1]["ensemble"], got["ensemble"])
    grid, cmd, rel, og = tr.rebalance_config(tconfig, make_grid)
    serial = Simulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=uniform_wind_met(grid, u=100.0),
                        outgrid=og, outdir=str(tmp_path / "s"), seed=5,
                        turboff=True, write_netcdf=False, met_bf16=False,
                        device="cpu")
    serial.run()
    want = tr.summary(serial)
    jgrid, jcmd, jrel, jog = tr.rebalance_config(jconfig, jmake_grid)
    jsim = JaxSimulation(cmd=jcmd, releases=jrel, grid=jgrid,
                         met_backend=juniform(jgrid, u=100.0), outgrid=jog,
                         outdir=str(tmp_path / "j"), seed=5, turboff=True,
                         write_netcdf=False, met_bf16=False)
    jsim.run()
    jens = tr._live_rows({k: np.asarray(v) for k, v in
                          jsim.particles._asdict().items()}, np)
    assert got["ensemble"].shape[1] == want["ensemble"].shape[1] == 48
    for ens in (want["ensemble"], jens):
        assert ens.shape == got["ensemble"].shape
        np.testing.assert_allclose(got["ensemble"], ens, rtol=ENS_RTOL,
                                   atol=ENS_ATOL)
    origin = got["origin"]
    assert len(np.unique(origin)) == len(origin) == 48


def test_tiles_checkpoint_after_regroup_resumes_bitwise(straight, tmp_path):
    out, res = straight
    ckpt = out / "checkpoint.npz"
    with np.load(ckpt) as d:
        assert int(d["itime"]) == 3600
        assert int(d["tiles_local_cap"]) == res[0]["local_cap"] >= 52
    again = _launch(tmp_path, tr.rank_rebalance, 2, str(tmp_path / "r"),
                    None, str(ckpt))
    for a, b in zip(again, res):
        assert a["local_cap"] == b["local_cap"]
        for f, v in b["particles"].items():
            np.testing.assert_array_equal(a["particles"][f], v, err_msg=f)
        np.testing.assert_array_equal(a["origin"], b["origin"])
    names = sorted(q.name for q in out.iterdir() if q.suffix == ".npz"
                   and q.name != "checkpoint.npz")
    assert len(names) >= 2
    for name in names:
        da, db = np.load(out / name), np.load(tmp_path / "r" / name)
        for k in da.files:
            np.testing.assert_array_equal(db[k], da[k], err_msg=name)

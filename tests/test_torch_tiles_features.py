"""The options of a tiles run that sample the whole fields, held against
the JAX package's tiles run and the port's serial run, in gloo groups of
4 ranks (a 1 x 4 tile mesh) started by
``flexpart_tpu_torch.parallel.launch``.

The runs are tests/test_tiles_mode.py's ``_sim_full`` (the
``torch_tiles_ranks.port_full`` job: a wide release of 96 particles over
every tile, turboff, 3 h of 900 s steps, capacity 4 x the release):

* ``test_tiled_split_oh_receptors_flux_match_serial`` mirrors the
  reference's test of that name: splitting at 2 h, the OH reaction of the
  REACT species, one receptor and the gross fluxes, against the JAX
  package's ``distributed="tiles"`` run at 4 devices (its mesh the
  group's; one JAX run a file) and against the port's serial run, with the
  reference's tolerances (tests/test_tiles_mode.py:245-287): the live
  particles' ensemble within rtol 2e-4, atol 1e-4, the receptors' sums
  within rtol 1e-3, atol 1e-10, every flux file within rtol 2e-3, atol
  1e-6 (the grid's 36 x 18 cells take a 1 x 4 mesh in both packages);
* ``test_tiled_convection_statistical`` mirrors the reference's test of
  that name (its :290-311): convection on, 192 particles, against the
  port's serial run: K7 draws by the tile's slot, so the two are other
  realisations; every particle kept, the mass within rtol 1e-5, the
  medians of the heights within 1500 m.
"""
import glob
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import torch_tiles_ranks as tr  # noqa: E402
from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu.met import SyntheticMet as JSyntheticMet  # noqa: E402
from flexpart_tpu.met import make_grid as jmake_grid  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch.parallel import launch  # noqa: E402

ENS_RTOL, ENS_ATOL = 2e-4, 1e-4
FEATURES = dict(cmd_kw=dict(itsplit=7200, iflux=1), ohreact=True)


def _receptors(c):
    return (c.Receptor(name="MID", lon=-20.0, lat=10.0),)


def _launch(store, fn, n, *args, **kw):
    return launch.launch(fn, n, "cpu", args=args + (kw,) if kw else args,
                         threads=2, store_dir=str(store))


def rank_features(outdir) -> dict:
    from flexpart_tpu_torch import config as tconfig
    return tr.rank_full(outdir, receptors=_receptors(tconfig), **FEATURES)


@pytest.fixture(scope="module")
def jax_tiles(tmp_path_factory):
    """The JAX package's tiles run of the features at 4 devices."""
    out = tmp_path_factory.mktemp("jax_features")
    grid = jmake_grid(**tr.FULL_GRID)
    cmd, rel, og = tr.full_config(jconfig, ohreact=True,
                                  **FEATURES["cmd_kw"])
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=JSyntheticMet(grid), outgrid=og,
                        outdir=str(out), seed=77, turboff=True,
                        distributed="tiles", write_netcdf=False,
                        met_bf16=False, n_devices=4, capacity=96 * 4,
                        receptors=_receptors(jconfig))
    assert (sim._tiles.nty, sim._tiles.ntx) == (1, 4)
    sim.run()
    p = {k: np.asarray(v) for k, v in sim.particles._asdict().items()}
    return out, tr._live_rows(p, np), np.asarray(sim.creceptor)


def _flux_files(d) -> list:
    return sorted(glob.glob(str(Path(d) / "grid_flux_*.npz")))


def test_tiled_split_oh_receptors_flux_match_serial(jax_tiles,
                                                    tmp_path):
    from flexpart_tpu_torch import config as tconfig
    res = _launch(tmp_path, rank_features, 4, str(tmp_path / "t"))
    got = res[0]
    assert tuple(got["mesh"]) == (1, 4)
    for other in res[1:]:
        np.testing.assert_array_equal(other["ensemble"], got["ensemble"])
    serial = tr.port_full(tmp_path / "s", receptors=_receptors(tconfig),
                          **FEATURES)
    serial.run()
    want = tr.summary(serial)
    jout, jens, jrec = jax_tiles
    # splitting fired, identically; OH took mass
    assert got["ensemble"].shape[1] > 96
    assert want["split_counts"][0][2] > 0
    assert sum(int(c[2]) for c in got["split_counts"]) == sum(
        int(c[2]) for c in want["split_counts"])
    assert got["mass"] < 0.999
    for ens in (want["ensemble"], jens):
        assert got["ensemble"].shape == ens.shape
        np.testing.assert_allclose(got["ensemble"], ens, rtol=ENS_RTOL,
                                   atol=ENS_ATOL)
    # the children's origins: fresh, each once, after the schedule's
    origin = got["origin"]
    assert len(np.unique(origin)) == len(origin)
    assert (origin >= 384).sum() == got["next_origin"] - 384 > 0
    for rec in (want["creceptor"], jrec):
        np.testing.assert_allclose(got["creceptor"], rec, rtol=1e-3,
                                   atol=1e-10)
    saw = False
    for ref in (tmp_path / "s", jout):
        fa, fb = _flux_files(ref), _flux_files(tmp_path / "t")
        assert [Path(f).name for f in fa] == [Path(f).name for f in fb]
        assert len(fb) >= 1
        for a, b in zip(fa, fb):
            da, db = np.load(a)["flux"], np.load(b)["flux"]
            saw |= da.sum() > 0
            np.testing.assert_allclose(db, da, rtol=2e-3, atol=1e-6)
    assert saw


def rank_convection(outdir) -> dict:
    return tr.rank_full(outdir, parts=192, cmd_kw=dict(lconvection=1))


def test_tiled_convection_statistical(tmp_path):
    got = _launch(tmp_path, rank_convection, 4, str(tmp_path / "t"))[0]
    serial = tr.port_full(tmp_path / "s", parts=192,
                          cmd_kw=dict(lconvection=1))
    serial.run()
    want = tr.summary(serial)
    n = 192
    assert got["ensemble"].shape[1] == want["ensemble"].shape[1] == n
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-5)
    zs, zt = want["ensemble"][2], got["ensemble"][2]
    assert abs(np.median(zs) - np.median(zt)) < 1500.0
    # the convection ran at every step of both (its moved count summed)
    assert got["convection_moved"] is not None
    assert want["convection_moved"] is not None

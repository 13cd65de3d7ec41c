"""The port's tiles mode run end to end on the CPU: gloo groups of 4 ranks
(a 2 x 2 tile mesh) and of 2 ranks (1 x 2), started by
``flexpart_tpu_torch.parallel.launch``.

The run is tests/test_tiles_mode.py's ``_sim`` (tests/torch_tiles_ranks.py:
turboff, an aerosol that rains out, decays and deposits dry, a wide
release over every tile and a hot spot) on a 36 x 18 grid of 20 x 10
degree cells.  Held, with the reference's tolerances
(tests/test_tiles_mode.py:76-97):

* the grids (conc, wet, dry) of both groups against the JAX package's
  ``distributed="tiles"`` run at 4 devices (its 2 x 2 mesh: the 4-rank
  group's; one JAX run a file) and against the port's serial run, within rtol 2e-3, atol 1e-7; the ensembles of
  the surviving particles (x, y, z, mass, sorted) within rtol 2e-4, atol
  1e-4;
* two 4-rank runs bitwise: the particles in schedule-origin order and
  every output file;
* a turbulent 2-rank run keeps every particle: the placed slots' origins
  are the schedule's, each once, every released particle live and no
  mass gained;
* a field that outgrows the halo sized from the first one is refused by
  name in the run;
* ``python -m flexpart_tpu_torch pathnames --tiles --device cpu --devices
  2`` runs a job to the banner and writes the serial CLI's files.
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
from flexpart_tpu_torch import main as tmain  # noqa: E402
from flexpart_tpu_torch.parallel import launch  # noqa: E402

GRID_RTOL, GRID_ATOL = 2e-3, 1e-7
ENS_RTOL, ENS_ATOL = 2e-4, 1e-4


def _launch(store, fn, n, *args):
    return launch.launch(fn, n, "cpu", args=args, threads=2,
                         store_dir=str(store))


def _grids(outdir) -> list:
    return sorted(glob.glob(str(Path(outdir) / "grid_conc_*.npz")))


def _held_grids(a_dir, b_dir) -> tuple:
    """The grids of two runs within the reference's tolerance; returns
    (files, whether any wet and any dry deposit was seen)."""
    fa, fb = _grids(a_dir), _grids(b_dir)
    assert [Path(f).name for f in fa] == [Path(f).name for f in fb]
    assert len(fa) >= 2
    wet = dry = False
    for a, b in zip(fa, fb):
        da, db = np.load(a), np.load(b)
        for k in ("conc", "wet", "dry"):
            np.testing.assert_allclose(db[k], da[k], rtol=GRID_RTOL,
                                       atol=GRID_ATOL, err_msg=f"{a} {k}")
        wet |= float(np.asarray(da["wet"]).max()) > 0
        dry |= float(np.asarray(da["dry"]).max()) > 0
    return len(fa), wet, dry


def _ensemble(x, y, z, mass, active):
    """The live particles' (x, y, z, mass), sorted by x, then y, z, mass
    (the position first: a last-bit difference of two masses must not
    pair other particles)."""
    cols = np.stack([x[active], y[active], z[active], mass[active]])
    return cols[:, np.lexsort(cols[::-1])]


def _port_ensemble(res):
    p = res["particles"]
    return _ensemble(p["x_hi"] + p["x_lo"], p["y_hi"] + p["y_lo"], p["z"],
                     p["mass"][:, 0], p["active"])


@pytest.fixture(scope="module")
def jax_tiles(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_tiles")
    grid = jmake_grid(**tr.GRID)
    cmd, rel, og = tr.tiles_config(jconfig)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=JSyntheticMet(grid), outgrid=og,
                        outdir=str(out), seed=77, turboff=True,
                        distributed="tiles", write_netcdf=False,
                        met_bf16=False, n_devices=4)
    assert (sim._tiles.nty, sim._tiles.ntx) == (2, 2)
    sim.run()
    act = np.asarray(sim.particles.active)
    ens = _ensemble(np.asarray(sim.particles.x), np.asarray(sim.particles.y),
                    np.asarray(sim.particles.z),
                    np.asarray(sim.particles.mass)[:, 0], act)
    return out, ens


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    out = tmp_path_factory.mktemp("serial")
    sim = tr.port_tiles(out)
    sim.run()
    return out, tr.ended(sim)


_RUNS = {}


def _tiles_run(n, tmp_path_factory):
    """The ``n``-rank tiles run, once per module."""
    if n not in _RUNS:
        out = tmp_path_factory.mktemp(f"tiles{n}")
        _RUNS[n] = (n, out, _launch(out, tr.rank_tiles, n, str(out)))
    return _RUNS[n]


@pytest.fixture(scope="module", params=[4, 2])
def tiles(request, tmp_path_factory):
    return _tiles_run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def tiles4(tmp_path_factory):
    return _tiles_run(4, tmp_path_factory)


def test_tiles_mesh_and_layout(tiles):
    n, _, res = tiles
    r0 = res[0]
    assert tuple(r0["mesh"]) == {4: (2, 2), 2: (1, 2)}[n]
    assert r0["halo"] >= 2 and r0["local_cap"] >= 64
    assert r0["migrations"]["migrations"] == 12
    assert r0["stats"]["migrate_counts"]["calls"] == 12 * (4 if n == 4
                                                           else 2)
    # every rank gathered the same run
    for other in res[1:]:
        for f, a in r0["particles"].items():
            np.testing.assert_array_equal(other["particles"][f], a)


def test_tiles_match_serial(tiles, serial):
    n, out, res = tiles
    files, wet, dry = _held_grids(serial[0], out)
    assert dry, "the run must deposit dry"
    np.testing.assert_allclose(_port_ensemble(res[0]),
                               _port_ensemble(serial[1]), rtol=ENS_RTOL,
                               atol=ENS_ATOL)
    assert res[0]["particle_steps"] == serial[1]["particle_steps"]


def test_tiles_match_jax_tiles(tiles, jax_tiles):
    """Both groups against the JAX package's tiles run (one JAX run a
    file: its 4-device 2 x 2 mesh, the 4-rank group's)."""
    n, out, res = tiles
    jout, jens = jax_tiles
    _held_grids(jout, out)
    ens = _port_ensemble(res[0])
    assert ens.shape == jens.shape
    np.testing.assert_allclose(ens, jens, rtol=ENS_RTOL, atol=ENS_ATOL)


def test_two_tiles_runs_are_bitwise(tiles4, tmp_path):
    n, out, res = tiles4
    again = _launch(tmp_path, tr.rank_tiles, 4, str(tmp_path / "b"))[0]
    np.testing.assert_array_equal(again["origin"], res[0]["origin"])
    for f, a in res[0]["particles"].items():
        np.testing.assert_array_equal(again["particles"][f], a, err_msg=f)
    files = {q.name: q.read_bytes() for q in Path(out).iterdir()}
    assert files == {q.name: q.read_bytes()
                     for q in (tmp_path / "b").iterdir()}


def test_turbulent_tiles_run_keeps_every_particle(tmp_path):
    """Two ranks with turbulence on: the placed slots' origins are the
    schedule's, each once (nothing lost or doubled by the migration),
    every released particle live with finite state above ground, no
    particle gained mass, the grids finite and positive."""
    res = _launch(tmp_path, tr.rank_tiles, 2, str(tmp_path / "t"), False)[0]
    sim = tr.port_tiles(tmp_path / "serial", turboff=False)
    sim.run()
    origin = res["origin"]
    from flexpart_tpu_torch.core.state import ITRA_INACTIVE
    sched = np.nonzero(sim.particles.itra.numpy() != ITRA_INACTIVE)[0]
    assert len(origin) == len(np.unique(origin)) == len(sched) == 144
    p = res["particles"]
    live = p["active"]
    assert live.sum() == int(sim.particles.active.sum()) == 144
    for f in ("x_hi", "y_hi", "z", "up", "vp", "wp"):
        assert np.isfinite(p[f][live]).all(), f
    assert p["z"][live].min() >= 0.0
    assert (p["mass"] <= p["mass0"]).all()
    assert res["migrations"]["deferred"] == 0
    for f in _grids(tmp_path / "t"):
        conc = np.load(f)["conc"]
        assert np.isfinite(conc).all() and conc.max() > 0


def test_tiles_refuse_a_field_that_outgrows_the_halo(tmp_path):
    with pytest.raises(launch.RankFailed, match="outgrows the halo"):
        _launch(tmp_path, tr.rank_strong_wind, 1, str(tmp_path / "o"))


def test_cli_tiles_on_the_cpu_writes_the_serial_files(tmp_path_factory,
                                                      tmp_path):
    """The CLI job of tests/test_torch_cli.py without convection (turbulent)
    through ``--tiles --device cpu --devices 2``: it runs to the banner
    and writes the serial CLI's files and ``dates``, its grids holding the
    same mass within 1e-3 (other slots, so other draws)."""
    from test_torch_cli import COMMAND, _job, _write_met
    from flexpart_tpu_torch.met import make_grid
    met = tmp_path_factory.mktemp("tilesmet")
    _write_met(met / "mother", make_grid(nx=37, ny=19, nlev=15, dx=10.0,
                                         dy=10.0))
    command = COMMAND.replace("LCONVECTION=1", "LCONVECTION=0")
    runs = {}
    for name, flags in (("serial", []),
                        ("tiles2", ["--tiles", "--devices", "2", "-v"])):
        job = _job(tmp_path / name, met, command=command)
        assert tmain.main([str(job), "--device", "cpu", *flags]) == 0
        out = tmp_path / name / "output"
        runs[name] = {q.name: q.read_bytes() for q in out.iterdir()}
    assert sorted(runs["tiles2"]) == sorted(runs["serial"])
    assert runs["tiles2"]["dates"] == runs["serial"]["dates"]
    a, b = tmp_path / "serial" / "output", tmp_path / "tiles2" / "output"
    for fa in _grids(a):
        ca, cb = np.load(fa)["conc"], np.load(b / Path(fa).name)["conc"]
        assert np.isfinite(cb).all()
        np.testing.assert_allclose(cb.sum(), ca.sum(), rtol=1e-3)

"""The initial condition and a warm start on tiles, in gloo groups of 2
ranks (a 1 x 2 tile mesh) started by ``flexpart_tpu_torch.parallel.launch``,
against one JAX run of the same job each (the initial condition's on the
JAX package's tiles, at ``n_devices=2``; the warm start's serial) and the
port's serial run.  The reference's tiles mode runs both options; its tests
hold neither on tiles, so each case mirrors the reference's test of the
option and takes the tolerances of its tiles test
(tests/test_tiles_mode.py::test_tiled_simulation_matches_serial: the grids
within rtol 2e-3, atol 1e-7, the live ensemble within rtol 2e-4, atol
1e-4).

* ``test_tiled_initial_condition_matches_jax`` mirrors
  tests/test_modes.py::test_initial_cond_sensitivity on tiles:
  ``torch_tiles_ranks.initcond_config``, a backward run with
  ``linit_cond = 1`` (turboff) in which particles leave the domain in the
  advance (scanned against the state before the migration), cross the
  tiles' border, end at the age limit (scanned after the migration) and
  survive to the end; the group's summed grid and every grid_initial file
  (read back by the JAX package's reader) against the JAX package's tiles
  run and the port's serial run, the live ensemble against the JAX tiles
  run's and the serial run's inside the domain (a particle that left it
  ends for good on tiles, as in the reference's tiles run).
* ``test_tiled_warm_start_matches_jax`` mirrors
  tests/test_cli.py::test_cli_warm_start_ipin on tiles: ``ipin = 1`` from
  a serial run's ``partposit_end``: the dump's particles placed by tile
  after the schedule; the live ensemble (the 48 scheduled and the 48 warm
  particles) against the JAX package's and the port's serial warm starts
  from the same file, each origin once.
"""
import struct
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
from flexpart_tpu.io.fortran_writer import (_RecReader,  # noqa: E402
                                            sparse_decode)
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch.parallel import launch  # noqa: E402

ENS_RTOL, ENS_ATOL = 2e-4, 1e-4
GRID_RTOL, GRID_ATOL = 2e-3, 1e-7
PARTS = 48


def _launch(store, fn, n, *args):
    return launch.launch(fn, n, "cpu", args=args, threads=2,
                         store_dir=str(store))


def _jax_full(outdir, hours=3, **cmd_kw):
    """The JAX package's serial ``_sim_full`` run of ``PARTS`` particles
    in the port's capacity, turboff (the warm start's)."""
    cmd, rel, og = tr.full_config(jconfig, PARTS, hours, **cmd_kw)
    grid = jmet.make_grid(**tr.FULL_GRID)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=jmet.SyntheticMet(grid), outgrid=og,
                        outdir=str(outdir), seed=77, turboff=True,
                        capacity=PARTS * 4, write_netcdf=False,
                        met_bf16=False)
    sim.run()
    return sim


def _read_initial(path, nx, ny, nz):
    """grid_initial_nnn: (itime, the decoded field of release 1)."""
    r = _RecReader(Path(path).read_bytes())
    itime, = struct.unpack("<i", r.rec())
    for _ in range(8):             # the empty wet and dry blocks
        r.rec()
    ni, = struct.unpack("<i", r.rec())
    idx = np.frombuffer(r.rec(), np.int32, ni)
    nr, = struct.unpack("<i", r.rec())
    vals = np.frombuffer(r.rec(), np.float32, nr)
    return itime, sparse_decode(idx, vals, nx * ny * nz,
                                index_offset=nx * ny)


def test_tiled_initial_condition_matches_jax(tmp_path):
    res = _launch(tmp_path, tr.rank_initcond, 2, str(tmp_path / "t"))
    got = res[0]
    assert tuple(got["mesh"]) == (1, 2)
    assert sum(r["migrations"]["sent"] for r in res) > 0
    serial = tr.port_initcond(tmp_path / "s")
    serial.run()
    want = tr.summary(serial)
    grid, cmd, rel, og, ages = tr.initcond_config(jconfig, jmet.make_grid)
    jsim = JaxSimulation(cmd=cmd, releases=rel, grid=grid, outgrid=og,
                         ageclasses=ages,
                         met_backend=jmet.uniform_wind_met(grid, u=60.0),
                         outdir=str(tmp_path / "j"), seed=77, turboff=True,
                         write_netcdf=False, met_bf16=False,
                         distributed="tiles", n_devices=2)
    jsim.run()
    jp = {k: np.asarray(v) for k, v in jsim.particles._asdict().items()}
    # some particles left the domain through its western face
    assert ((jp["x_hi"] + jp["x_lo"]) < 0).sum() > 0
    jic = np.asarray(jsim.init_cond)
    assert jic.sum() > 0
    # a particle that left the domain ends for good on tiles, as in the
    # reference's tiles run; the serial run's next release wakes it again
    # outside the domain (x < 0)
    inside = want["ensemble"][:, want["ensemble"][0] >= 0]
    for ens in (tr._live_rows(jp, np), inside):
        assert ens.shape == got["ensemble"].shape
        np.testing.assert_allclose(got["ensemble"], ens, rtol=ENS_RTOL,
                                   atol=ENS_ATOL)
    # the grid the files are written from: the group's partials summed
    for ref in (want["init_cond"], jic):
        assert ref.shape == got["init_cond"].shape
        np.testing.assert_allclose(got["init_cond"], ref, rtol=GRID_RTOL,
                                   atol=GRID_ATOL)
    names = sorted(q.name for q in (tmp_path / "j").glob("grid_initial_*"))
    assert names
    for d in ("s", "t"):
        assert sorted(q.name for q in (tmp_path / d).glob(
            "grid_initial_*")) == names
    shape = (og.numxgrid, og.numygrid, len(og.outheights))
    for name in names:
        jt, j = _read_initial(tmp_path / "j" / name, *shape)
        assert j.sum() > 0
        for d in ("s", "t"):
            t, f = _read_initial(tmp_path / d / name, *shape)
            assert t == jt
            np.testing.assert_allclose(f, j, rtol=GRID_RTOL, atol=GRID_ATOL,
                                       err_msg=f"{d}/{name}")


def rank_warm(outdir) -> dict:
    return tr.rank_full(outdir, parts=PARTS, hours=2, cmd_kw=dict(ipin=1))


def test_tiled_warm_start_matches_jax(tmp_path):
    prev = tr.port_full(tmp_path / "prev", parts=PARTS, hours=2,
                        cmd_kw=dict(ipout=2))
    prev.run()
    dump = (tmp_path / "prev" / "partposit_end").read_bytes()
    for d in ("s", "t", "j"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "partposit_end").write_bytes(dump)
    got = _launch(tmp_path, rank_warm, 2, str(tmp_path / "t"))[0]
    serial = tr.port_full(tmp_path / "s", parts=PARTS, hours=2,
                          cmd_kw=dict(ipin=1))
    serial.run()
    jsim = _jax_full(tmp_path / "j", hours=2, ipin=1)
    jens = tr._live_rows({k: np.asarray(v) for k, v in
                          jsim.particles._asdict().items()}, np)
    # the 48 scheduled and the 48 warm particles, all live
    assert got["ensemble"].shape[1] == 2 * PARTS
    for ens in (tr.summary(serial)["ensemble"], jens):
        assert ens.shape == got["ensemble"].shape
        np.testing.assert_allclose(got["ensemble"], ens, rtol=ENS_RTOL,
                                   atol=ENS_ATOL)
    origin = got["origin"]
    assert len(np.unique(origin)) == len(origin)
    assert origin.max() < got["next_origin"]

"""The port's particle data-parallelism run end to end on the CPU: gloo
groups of 2 and 3 processes (``flexpart_tpu_torch.parallel.launch``).

The run is tests/test_parallel.py's ``_mini_sim`` with the turbulence off
and a split (tests/torch_dp_ranks.py): 128 particles in 192 slots, an
aerosol that rains out and deposits dry, every particle due to split at
3600 s while 64 slots are free, so the 64 granted parents lie on other
ranks than their children's slots (rank 0's children land on rank 1 of 2,
on rank 2 of 3; rank 2 of 3 holds no live particle before the split).
Held, as the reference's serial == mpirun contract
(tests/test_parallel.py:157-189):

* the grids (conc, wet, dry) against the JAX package's
  ``distributed="dp"`` run on its 8-device virtual mesh and against the
  port's serial run, within rtol 1e-5, atol 1e-12 (the reference's dp
  tolerance: the sums of a cell change order);
* the final particles, put in schedule-origin order, bitwise against the
  port's serial run (a rank sorts its own rows, so the slots differ), and
  the split counts (due, free, granted) equal;
* a turbulent run of 2 ranks as statistics (tests/test_parallel.py:71):
  per-shard sorts give other slots than the serial sort, so other draws.

The regional domain fill (tests/test_torch_domainfill.py's, with
receptors, fluxes and a nested output grid) on 2 ranks: the boundary's
counts per step and the particles equal the serial run's, its files
within the same tolerance; its checkpoint, written by 2 ranks, resumes in
3 and ends in the same particles.  ``python -m flexpart_tpu_torch
pathnames --dp --device cpu --devices 2`` runs a job to the banner and
writes the serial CLI's files.
"""
import glob
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import torch_dp_ranks as dr  # noqa: E402
from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu.met import SyntheticMet as JSyntheticMet  # noqa: E402
from flexpart_tpu.met import make_grid as jmake_grid  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import main as tmain  # noqa: E402
from flexpart_tpu_torch.parallel import launch  # noqa: E402

RTOL, ATOL = 1e-5, 1e-12


def _launch(store, fn, n, *args):
    """``fn(*args)`` in ``n`` gloo ranks, their FileStore under ``store``
    (a test's own directory)."""
    return launch.launch(fn, n, "cpu", args=args, threads=2,
                         store_dir=str(store))


def _grids(outdir) -> list:
    return sorted(glob.glob(str(Path(outdir) / "grid_conc_*.npz")))


def _held_grids(a_dir, b_dir, keys=("conc", "wet", "dry")) -> int:
    fa, fb = _grids(a_dir), _grids(b_dir)
    assert [Path(f).name for f in fa] == [Path(f).name for f in fb]
    assert len(fa) >= 2
    for a, b in zip(fa, fb):
        da, db = np.load(a), np.load(b)
        for k in keys:
            if k in da.files:
                np.testing.assert_allclose(db[k], da[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{a} {k}")
    return len(fa)


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dp")
    grid = jmake_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd, rel, og = dr.mini_config(jconfig)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=JSyntheticMet(grid), outgrid=og,
                        outdir=str(out), seed=77, distributed="dp",
                        write_netcdf=False, turboff=True,
                        capacity=dr.MINI_CAPACITY)
    assert sim._mesh is not None and sim._mesh.devices.size == 8
    sim.run()
    return out


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    out = tmp_path_factory.mktemp("serial")
    sim = dr.port_mini(out)
    sim.run()
    return out, dr.ended(sim)


@pytest.fixture(scope="module", params=[2, 3])
def dp(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"dp{n}")
    res = _launch(out, dr.rank_mini, n, str(out))
    return n, out, res


def test_dp_grids_match_jax_dp_and_serial(dp, serial, jax_dp):
    n, out, _ = dp
    assert _held_grids(serial[0], out) == _held_grids(jax_dp, out)


def test_dp_particles_equal_serial_in_origin_order(dp, serial):
    n, _, res = dp
    r0 = res[0]
    assert r0["world"] == n
    s = dr.in_origin_order(serial[1])
    d = dr.in_origin_order(r0)
    for f, a in s.items():
        np.testing.assert_array_equal(d[f], a, err_msg=f)
    assert r0["particle_steps"] == serial[1]["particle_steps"]
    # every rank gathered the same whole run
    for other in res[1:]:
        for f, a in r0["particles"].items():
            np.testing.assert_array_equal(other["particles"][f], a)


def test_dp_split_crosses_ranks_as_serial(dp, serial):
    n, _, res = dp
    counts = res[0]["split_counts"]
    assert counts == serial[1]["split_counts"]
    due, free, granted = counts[0]
    assert due > free == granted > 0
    assert res[0]["stats"]["all_to_all"]["calls"] == 1


def test_dp_turbulent_run_is_physical(tmp_path):
    """Two ranks with turbulence on: every particle live and finite, none
    below ground, the mass and the split counts as the serial run's."""
    res = _launch(tmp_path, dr.rank_mini, 2, str(tmp_path / "dp"), False)[0]
    sim = dr.port_mini(tmp_path / "serial", turboff=False)
    sim.run()
    p = res["particles"]
    live = p["active"]
    assert live.sum() == int(sim.particles.active.sum()) == 192
    for f in ("x_hi", "y_hi", "z", "up", "vp", "wp"):
        assert np.isfinite(p[f][live]).all(), f
    assert p["z"][live].min() >= 0.0
    assert res["split_counts"] == [c.tolist() for c in sim.split_counts]
    np.testing.assert_allclose(p["mass"].sum(),
                               float(sim.particles.mass.sum()), rtol=1e-3)
    assert len(_grids(tmp_path / "dp")) == len(
        _grids(tmp_path / "serial")) >= 2


@pytest.fixture(scope="module")
def df_serial(tmp_path_factory):
    out = tmp_path_factory.mktemp("df_serial")
    sim = dr.port_df(out)
    sim.run()
    return out, dr.ended(sim)


def test_dp_domainfill_boundary_and_checkpoint(df_serial, tmp_path):
    """The boundary over 2 ranks as the serial run's, every step; its
    checkpoint at 5400 s resumed by 3 ranks ends in the same particles."""
    ck = tmp_path / "ck.npz"
    a = _launch(tmp_path, dr.rank_df, 2, str(tmp_path / "a"), None,
                str(ck), 5400)[0]
    out_s, s = df_serial
    assert a["boundary_counts"] == s["boundary_counts"]
    granted = np.asarray(s["boundary_counts"])[:, 3]
    assert granted.sum() > 0
    ps, pa = dr.in_origin_order(s), dr.in_origin_order(a)
    for f in ps:
        np.testing.assert_array_equal(pa[f], ps[f], err_msg=f)
    for pattern in ("grid_conc_*.npz", "receptor_conc_*.npz",
                    "grid_flux_*.npz", "nest/grid_conc_*.npz"):
        fs = sorted(out_s.glob(pattern))
        assert len(fs) == 2, pattern
        for f in fs:
            da = np.load(f)
            db = np.load(tmp_path / "a" / f.relative_to(out_s))
            for k in da.files:
                if da[k].dtype.kind != "f":
                    np.testing.assert_array_equal(db[k], da[k])
                    continue
                np.testing.assert_allclose(db[k], da[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{f} {k}")
    with np.load(ck) as d:
        assert int(d["dp_world"]) == 2 and len(d["p_z"]) == dr.DF_CAPACITY
    b = _launch(tmp_path, dr.rank_df, 3, str(tmp_path / "b"), str(ck))[0]
    pb = dr.in_origin_order(b)
    n = dr.DF_CAPACITY
    for f in ps:
        np.testing.assert_array_equal(pb[f][:n], ps[f], err_msg=f)
    # the pad slots of 3 ranks: empty, and free slots of the boundary's
    pads = len(pb["z"]) - n
    assert pads == 2 and not pb["active"][n:].any()
    tail = np.asarray(s["boundary_counts"][-len(b["boundary_counts"]):])
    tail[:, 1] += pads
    np.testing.assert_array_equal(b["boundary_counts"], tail)


def test_cli_dp_on_the_cpu_writes_the_serial_files(tmp_path_factory,
                                                   tmp_path):
    """The CLI job of tests/test_torch_cli.py (turbulent) through ``--dp
    --device cpu``: with ``--devices 1`` every output file is the serial
    CLI's, byte for byte (a group of one rank is the serial run); with
    ``--devices 2`` it runs to the banner and writes the same files and
    ``dates``, its grids holding the same mass within 1e-3 (the ranks'
    sorts give other draws)."""
    from test_torch_cli import _job, _write_met
    from flexpart_tpu_torch.met import make_grid
    met = tmp_path_factory.mktemp("dpmet")
    _write_met(met / "mother", make_grid(nx=37, ny=19, nlev=15, dx=10.0,
                                         dy=10.0))
    runs = {}
    for name, flags in (("serial", []),
                        ("dp1", ["--dp", "--devices", "1"]),
                        ("dp2", ["--dp", "--devices", "2", "-v"])):
        job = _job(tmp_path / name, met)
        assert tmain.main([str(job), "--device", "cpu", *flags]) == 0
        out = tmp_path / name / "output"
        runs[name] = {q.name: q.read_bytes() for q in out.iterdir()}
    assert runs["dp1"] == runs["serial"]
    assert sorted(runs["dp2"]) == sorted(runs["serial"])
    assert runs["dp2"]["dates"] == runs["serial"]["dates"]
    a, b = tmp_path / "serial" / "output", tmp_path / "dp2" / "output"
    for fa in _grids(a):
        ca, cb = np.load(fa)["conc"], np.load(b / Path(fa).name)["conc"]
        assert np.isfinite(cb).all()
        np.testing.assert_allclose(cb.sum(), ca.sum(), rtol=1e-3)

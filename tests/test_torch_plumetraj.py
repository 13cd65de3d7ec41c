"""Port parity for the plume trajectories (``iout`` 4 and 5;
``grid/plumetraj.py``, numpy on the host in both packages).

``cluster_particles`` bitwise against the JAX package's on the same
positions; ``PlumeTrajWriter`` and ``plume_step`` write the same text on
the same particles and diagnostics, the port's given in another slot
order with ``order`` putting them back.  ``cluster_particles_torch`` (the
clusters of particles on a card) against the numpy version on the CPU:
the centres within 1e-4 degrees, the shares within one particle, heights
and distances within rtol 1e-4 (torch's and numpy's sin and arcsin may
round an ulp apart).

One JAX ``Simulation`` run with ``iout=5`` (concentrations and plume
trajectories) over 16 steps, against the port's with JAX's draws injected
(and clustered in schedule order, through ``_origin``): the same
``trajectories.txt`` header, one line per output and release, and each
line's numbers within the particles' own agreement: the centroid within
2e-3 degrees and 2 m, the rms distances and heights within 1% and 2 m, the
fractions (in the PBL, the troposphere, below 2 pvu) within one particle
of a release's 504 and the print's rounding (one of the 2% whose height
the boundary layer's Langevin equation has moved apart can cross the
mixing height), the clusters' centres within 0.05 degrees and their
shares within two particles (k-means may move a particle on a cluster's
border to the other cluster).
"""
from pathlib import Path

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
from flexpart_tpu.grid import plumetraj as jpt  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.grid import plumetraj as tpt  # noqa: E402

GRID = dict(nx=37, ny=15, nlev=15, dx=10.0, dy=10.0, ylat0=-70.0)
N = 1008
SEED = 9
NSTEPS = 16
ROWS = {**DRAW_ROWS, 2: 1}


def _config(c):
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=40000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    lsubgrid=0, iout=5)
    boxes = tuple(c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                               itime2=0, lon1=lon, lon2=lon + 2.0,
                               lat1=40.0, lat2=42.0, z1=50.0, z2=500.0,
                               mass=(1.0,), parts=N // 2)
                  for lon in (0.0, 20.0))
    rel = c.Releases(species=(c.Species(),), boxes=boxes)
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    return cmd, rel, og


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cmd, rel, og = _config(jconfig)
    grid = jmet.make_grid(**GRID)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=jmet.SyntheticMet(grid), outgrid=og,
                        outdir=str(tmp_path_factory.mktemp("jax_traj")),
                        seed=SEED, write_netcdf=False, write_npz=False)
    sim.run()
    key = jax.random.PRNGKey(SEED)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS)]
    return sim, draws


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    jsim, draws = jax_run
    sim = interop.simulation_from_jax(
        jsim, "cpu", outdir=str(tmp_path_factory.mktemp("port_traj")))
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    return sim


@pytest.mark.parametrize("n", [3, 5, 400])
def test_cluster_particles_equals_jax(n):
    rs = np.random.default_rng(n)
    lon = rs.uniform(-30.0, 40.0, n)
    lat = rs.uniform(20.0, 70.0, n)
    z = rs.uniform(0.0, 3000.0, n)
    j = jpt.cluster_particles(lon, lat, z)
    t = tpt.cluster_particles(lon, lat, z)
    assert t == j
    assert (t is None) == (n < tpt.NCLUSTER)


def _diag(n, rs):
    return tuple(torch.as_tensor(rs.uniform(lo, hi, n).astype(np.float32))
                 for lo, hi in ((0, 500), (-3, 3), (0, 0.01), (0.5, 1.3),
                                (100, 2000), (8000, 12000), (220, 300)))


def test_plume_step_writes_jaxs_text(tmp_path):
    cmd, rel, og = _config(jconfig)
    rs = np.random.default_rng(4)
    n = 600
    grid = jmet.make_grid(**GRID)
    pop = dict(x=rs.uniform(17, 21, n).astype(np.float32),
               y=rs.uniform(10, 12, n).astype(np.float32),
               z=rs.uniform(0, 3000, n).astype(np.float32),
               active=rs.random(n) < 0.9,
               itra=np.full(n, 3600, np.int32),
               npoint=rs.integers(0, 2, n).astype(np.int32))
    diag = _diag(n, rs)

    class P:
        pass

    jp, tp = P(), P()
    for k, v in pop.items():
        setattr(jp, k, v)
    origin = rs.permutation(n)      # port slot k holds JAX slot origin[k]
    for k, v in pop.items():
        setattr(tp, k, torch.as_tensor(v[origin]))
    jw = jpt.PlumeTrajWriter(tmp_path / "j.txt", rel, cmd.bdate)
    tw = tpt.PlumeTrajWriter(tmp_path / "t.txt", rel, cmd.bdate)
    jpt.plume_step(jp, grid, tuple(d.numpy() for d in diag), 3600, 2, jw)
    tdiag = tuple(d[origin] for d in diag)
    tpt.plume_step(tp, grid, tdiag, 3600, 2, tw,
                   order=torch.as_tensor(np.argsort(origin)))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_trajectories_in_simulation_equal_jax(jax_run, port_run):
    jsim, sim = jax_run[0], port_run
    jl = (Path(jsim.outdir) / "trajectories.txt").read_text().splitlines()
    tl = (Path(sim.outdir) / "trajectories.txt").read_text().splitlines()
    assert sim.n_sorts >= 1 and sim._origin is not None
    head = 2 + 2 * 2
    assert tl[:head] == jl[:head] and len(tl) == len(jl) == head + 3 * 2
    for a, b in zip(tl[head:], jl[head:]):
        va = np.asarray(a.split(), float)
        vb = np.asarray(b.split(), float)
        assert va[:2].tolist() == vb[:2].tolist()       # point, itime
        np.testing.assert_allclose(va[2:4], vb[2:4], atol=2e-3)
        np.testing.assert_allclose(va[4:9], vb[4:9], atol=2.0, rtol=1e-3)
        np.testing.assert_allclose(va[9:13], vb[9:13], atol=2.0, rtol=1e-2)
        np.testing.assert_allclose(va[13:16], vb[13:16],
                                   atol=100.0 / (N // 2) + 0.1)
        ca, cb = va[16:].reshape(5, 5), vb[16:].reshape(5, 5)
        np.testing.assert_allclose(ca[:, :2], cb[:, :2], atol=0.05)
        np.testing.assert_allclose(ca[:, 3], cb[:, 3],
                                   atol=2 * 100.0 / (N // 2) + 0.1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cluster_particles_torch_is_the_numpy_version(dtype):
    """The version that clusters particles on a card, on the CPU against
    the numpy one (float32 input, as plume_step passes positions, and
    float64): the centres within 1e-4 degrees, the shares within one
    particle, the heights and rms distances within rtol 1e-4."""
    rs = np.random.default_rng(11)
    n = 4000
    lon = rs.uniform(-30.0, 40.0, n).astype(dtype)
    lat = rs.uniform(20.0, 70.0, n).astype(dtype)
    z = rs.uniform(0.0, 3000.0, n).astype(dtype)
    (a, ra) = tpt.cluster_particles_torch(torch.as_tensor(lon),
                                          torch.as_tensor(lat),
                                          torch.as_tensor(z))
    (b, rb) = tpt.cluster_particles(lon, lat, z)
    a, b = np.asarray(a, float), np.asarray(b, float)
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-4)
    np.testing.assert_allclose(a[:, 3], b[:, 3], atol=100.0 / n + 1e-9)
    np.testing.assert_allclose(a[:, [2, 4]], b[:, [2, 4]], rtol=1e-4)
    np.testing.assert_allclose(ra, rb, rtol=1e-4)
    assert tpt.cluster_particles_torch(*(torch.zeros(3),) * 3) is None

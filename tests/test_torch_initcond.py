"""Port parity for the initial-condition sensitivity (``linit_cond``;
``grid/initcond.py``, kernel K17 on a card, its plain version here).

``write_initial_cond`` (numpy in both packages) byte for byte on the same
grid.

The plain version against JAX's ``make_initcond_scatter`` on the same
particles and mask (made with numpy), ``linit_cond`` 1 (divided by the
air density at the particle) and 2 (the mass): the same cells hit and the
sums within rtol 1e-5 plus 1e-5 of the largest cell (XLA contracts
``x * dx + shift`` into a fused multiply-add, so the kernel's weights move
by an ulp of the cell coordinate, which a small weight such as
(1 - wx)(1 - wy) feels relatively; the density's four-corner sum and the
scatters add in other orders).

One JAX ``Simulation`` run, backward with ``linit_cond=1`` over 20 steps,
whose particles end at the last age class (4 h) from step 16 on, after
the sort of step 16 (the step whose sort would make a mask of the active
particles taken before it stale), against the port's with JAX's draws
injected.  (A particle that the age limit ends keeps its next time in
itra, so the next step's release wakes it again and it ends once more:
the JAX package does so, and the port with it; each end is scattered.)
The same files; ``grid_initial_001`` read back by both
packages' readers, its total within rtol 1e-4 (each particle's mass is
divided by the density at its height, which the two packages' heights
share to 1 m for 98% of the particles; measured 1.3e-5) and its cells
within 1e-5 plus 3% of the largest cell (the output cells are 4 degrees
and 500 m
deep at the bottom: a particle whose height the boundary layer's Langevin
equation has moved apart in the two packages, 2% of them by more than
1 m, can end in the next cell).  With ``linit_cond=2`` and no particle
ended (a port-only run without age classes) the grid holds the released
mass itself, within rtol 1e-5, and the file, divided by it, 1.
"""
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.grid import initcond as jic  # noqa: E402
from flexpart_tpu.io.fortran_writer import (_RecReader,  # noqa: E402
                                            sparse_decode)
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.grid import initcond as tic  # noqa: E402

GRID = dict(nx=37, ny=15, nlev=15, dx=10.0, dy=10.0, ylat0=-70.0)
N = 1008
SEED = 8
NSTEPS = 20
ROWS = {**DRAW_ROWS, 2: 1}
HEIGHTS = (500.0, 2000.0, 50000.0)
OG = dict(outlon0=-60.0, outlat0=0.0, numxgrid=30, numygrid=20, dxout=4.0,
          dyout=4.0, outheights=HEIGHTS)


def _config(c, linit_cond=1, lage=(7200, 14400)):
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=50000, ldirect=-1, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    lsubgrid=0, linit_cond=linit_cond)
    box = c.ReleaseBox(idate1=20200101, itime1=40000, idate2=20200101,
                       itime2=50000, lon1=0.0, lon2=2.0, lat1=40.0,
                       lat2=42.0, z1=50.0, z2=1500.0, mass=(2.0,), parts=N)
    rel = c.Releases(species=(c.Species(),), boxes=(box,))
    return cmd, rel, c.OutGrid(**OG), c.AgeClasses(lage=lage)


def _jax_sim(outdir, linit_cond=1):
    cmd, rel, og, ages = _config(jconfig, linit_cond)
    grid = jmet.make_grid(**GRID)
    return JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                         met_backend=jmet.SyntheticMet(grid), outgrid=og,
                         ageclasses=ages, outdir=str(outdir), seed=SEED,
                         write_netcdf=False, write_npz=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    sim = _jax_sim(tmp_path_factory.mktemp("jax_ic"))
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
        jsim, "cpu", outdir=str(tmp_path_factory.mktemp("port_ic")))
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    return sim


def _read_initial(path, og=OG):
    """grid_initial_nnn: (itime, the (nz, ny, nx) field of release 1)."""
    r = _RecReader(Path(path).read_bytes())
    itime, = struct.unpack("<i", r.rec())
    for _ in range(8):             # the empty wet and dry blocks
        r.rec()
    ni, = struct.unpack("<i", r.rec())
    idx = np.frombuffer(r.rec(), np.int32, ni)
    nr, = struct.unpack("<i", r.rec())
    vals = np.frombuffer(r.rec(), np.float32, nr)
    nx, ny, nz = og["numxgrid"], og["numygrid"], len(og["outheights"])
    field = sparse_decode(idx, vals, nx * ny * nz, index_offset=nx * ny)
    return itime, field.reshape(nz, ny, nx)


def test_initial_cond_file_is_the_references_bytes(tmp_path):
    rs = np.random.default_rng(2)
    g = (rs.random((2, 3, 4, 5, 2)) * (rs.random((2, 3, 4, 5, 2)) < 0.3)) \
        .astype(np.float32)
    rm = np.asarray([[2.0, 0.0], [1.5, 3.0]], np.float32)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jic.write_initial_cond(tmp_path / "j", -18000, g, rm)
    tic.write_initial_cond(tmp_path / "t", -18000, g, rm)
    for k in (1, 2):
        name = f"grid_initial_{k:03d}"
        assert (tmp_path / "t" / name).read_bytes() \
            == (tmp_path / "j" / name).read_bytes()


def _population(n, seed):
    rs = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x_hi=rs.uniform(-1.0, 36.5, n).astype(f32),
        x_lo=rs.uniform(-1e-6, 1e-6, n).astype(f32),
        y_hi=rs.uniform(0.0, 14.0, n).astype(f32),
        y_lo=np.zeros(n, f32), z=rs.uniform(0.0, 60000.0, n).astype(f32),
        itra=np.zeros(n, np.int32), itramem=np.zeros(n, np.int32),
        npoint=rs.integers(0, 2, n).astype(np.int32),
        nclass=np.zeros(n, np.int32), idt=np.zeros(n, np.int32),
        itrasplit=np.zeros(n, np.int32),
        up=np.zeros(n, f32), vp=np.zeros(n, f32), wp=np.zeros(n, f32),
        usig=np.zeros(n, f32), vsig=np.zeros(n, f32), wsig=np.zeros(n, f32),
        cbt=np.ones(n, np.int8),
        mass=rs.uniform(0.5, 1.5, (n, 2)).astype(f32),
        mass0=np.ones((n, 2), f32), xscav=np.ones((n, 2), f32),
        active=rs.random(n) < 0.9), rs.random(n) < 0.3


@pytest.mark.parametrize("linit_cond", [1, 2])
def test_scatter_twin_equals_jax(linit_cond, jax_run):
    jsim = jax_run[0]
    zf = jsim._get_field(0)
    pop, mask = _population(6000, linit_cond)

    def cfg(c):
        return c.InitCondConfig(
            nxg=30, nyg=20, nzg=3, npointspec=2, dxout=4.0, dyout=4.0,
            xoutshift=jsim.geo.xoutshift, youtshift=jsim.geo.youtshift,
            dx_met=10.0, dy_met=10.0, linit_cond=linit_cond)

    j = np.asarray(jic.make_initcond_scatter(HEIGHTS)(
        jic.zero_init_cond(cfg(jic), 2),
        JParticles(**{k: jnp.asarray(v) for k, v in pop.items()}),
        jnp.asarray(mask), zf, cfg(jic)))
    zt = interop.zfields_from_numpy(zf, "cpu")
    t = tic.zero_init_cond(cfg(tic), 2)
    tic.make_initcond_scatter(HEIGHTS, "cpu")(
        t, interop.particles_from_numpy(pop, "cpu"), torch.as_tensor(mask),
        zt, cfg(tic))
    t = t.numpy()
    assert j.sum() > 0 and (j != 0).sum() > 100
    np.testing.assert_array_equal(t != 0, j != 0)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * j.max())


@pytest.mark.parametrize("linit_cond", [1, 2])
def test_scatter_twin_on_a_plume_equals_jax_and_the_f64_sum(linit_cond,
                                                            jax_run):
    """A plume, the shape K17's tables are for: most of the masked
    particles in a box of about one output cell, so that a few cells take
    hundreds of pairs each (sim_initcond's retroplume at its end, cut to a
    few thousand particles).  The plain version against JAX (the same
    cells hit; the sums as test_scatter_twin_equals_jax) and against the
    float64 sum of its own pairs within K8's rule (a cell of m pairs within
    max(m * 2**-24, 1e-5) relatively: chip_smoke.held_against_f64, which
    holds K17 on the card to the same)."""
    jsim = jax_run[0]
    zf = jsim._get_field(0)
    pop, _ = _population(6000, 10 + linit_cond)
    rs = np.random.default_rng(20 + linit_cond)
    mask = rs.random(6000) < 0.8
    f32 = np.float32
    # most of the masked ones within about one 4-degree cell, a few spread
    plume = mask & (rs.random(6000) < 0.9)
    pop["x_hi"] = np.where(plume, rs.uniform(14.05, 14.3, 6000),
                           pop["x_hi"]).astype(f32)
    pop["y_hi"] = np.where(plume, rs.uniform(8.05, 8.3, 6000),
                           pop["y_hi"]).astype(f32)
    pop["z"] = np.where(plume, rs.uniform(0.0, 3000.0, 6000),
                        pop["z"]).astype(f32)

    def cfg(c):
        return c.InitCondConfig(
            nxg=30, nyg=20, nzg=3, npointspec=2, dxout=4.0, dyout=4.0,
            xoutshift=jsim.geo.xoutshift, youtshift=jsim.geo.youtshift,
            dx_met=10.0, dy_met=10.0, linit_cond=linit_cond)

    j = np.asarray(jic.make_initcond_scatter(HEIGHTS)(
        jic.zero_init_cond(cfg(jic), 2),
        JParticles(**{k: jnp.asarray(v) for k, v in pop.items()}),
        jnp.asarray(mask), zf, cfg(jic)))
    zt = interop.zfields_from_numpy(zf, "cpu")
    tp = interop.particles_from_numpy(pop, "cpu")
    t = tic.zero_init_cond(cfg(tic), 2)
    tic.make_initcond_scatter(HEIGHTS, "cpu")(
        t, tp, torch.as_tensor(mask), zt, cfg(tic))
    # the plume: few cells, hundreds of pairs in each of the fullest
    lin, valid, contrib = tic.initcond_pairs(
        tp, torch.as_tensor(mask), zt,
        torch.tensor(HEIGHTS, dtype=torch.float32), cfg(tic))
    lin, contrib = lin[valid], contrib[valid]
    pairs = torch.bincount(lin, minlength=t[..., 0].numel())
    assert int(pairs.max()) > 500 and int((pairs > 100).sum()) <= 48
    ref = torch.zeros(t.numel() // 2, 2, dtype=torch.float64)
    ref.index_add_(0, lin, contrib.double())
    got = t.view(-1, 2).double()
    rtol = torch.clamp(pairs.double() * 2.0 ** -24, min=1e-5)[:, None]
    assert bool(torch.all((got - ref).abs() <= rtol * ref))
    t = t.numpy()
    np.testing.assert_array_equal(t != 0, j != 0)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * j.max())


def test_initcond_in_simulation_equals_jax(jax_run, port_run):
    jsim, sim = jax_run[0], port_run
    jout, tout = Path(jsim.outdir), Path(sim.outdir)
    assert sorted(p.name for p in tout.iterdir()) \
        == sorted(p.name for p in jout.iterdir())
    assert sim.n_sorts >= 2 and sim.last_itime == jsim.last_itime == -18000
    # the particles end at the last age class from step 16 on
    assert sim.ageclasses.max_age == 14400
    np.testing.assert_array_equal(
        np.sort(sim.particles.itramem.numpy()),
        np.sort(np.asarray(jsim.particles.itramem)))
    jt, j = _read_initial(jout / "grid_initial_001")
    tt, t = _read_initial(tout / "grid_initial_001")
    assert tt == jt == -18000
    np.testing.assert_allclose(t.sum(), j.sum(), rtol=1e-4)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0.03 * j.max())
    np.testing.assert_allclose(float(sim.init_cond.double().sum()),
                               float(np.asarray(jsim.init_cond).sum()),
                               rtol=1e-4)


def test_initcond_counts_every_survivor_once(tmp_path):
    """linit_cond=2 without age classes: every particle survives to the
    run's end, and the grid holds the released mass (2.0) once; the file,
    divided by it, sums to 1."""
    cmd, rel, og, ages = _config(tconfig, linit_cond=2, lage=())
    grid = make_grid(**GRID)
    sim = Simulation(cmd=cmd, releases=rel, grid=grid, outgrid=og,
                     ageclasses=ages, met_backend=SyntheticMet(grid),
                     outdir=str(tmp_path), seed=SEED, write_netcdf=False,
                     write_npz=False, device="cpu")
    sim.run()
    assert int(sim.particles.active.sum()) == N
    np.testing.assert_allclose(float(sim.init_cond.double().sum()), 2.0,
                               rtol=1e-5)
    _, f = _read_initial(tmp_path / "grid_initial_001")
    np.testing.assert_allclose(f.sum(), 1.0, rtol=1e-5)

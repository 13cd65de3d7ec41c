"""Port parity for particle dumps, warm start and checkpoints
(``io/partdump.py``).

One JAX run (a 2 h forward run with ``IPOUT=2``, module-scoped) writes
the reference-format ``partposit_end``.  On its final particles the
port's writers give the JAX package's bytes: ``write_partposit`` (all
live particles, and those updated at itime only), ``write_shortposit``
and ``write_partposit_average``, with the same met quantities, sums and
counts handed to both.  The port reads the JAX package's file as JAX
reads it; a warm start (``IPIN=1``) from it gives JAX's particles bit for
bit.  The dump's met quantities (``particle_diagnostics``) agree with
JAX's within rtol 1e-5 (XLA's einsum adds the four corners in its own
order).

On the port alone (``tests/test_checkpoint.py:56-78``): a run with
convection and splitting, checkpointed at 2 h and resumed, ends in the
straight run's particles, origins, grids and ``partposit_end``, bit for
bit; the resumed part crosses a sort (step 16) and two splits, and the
straight run that wrote the checkpoint equals one that did not.  The
averaged dump (``IPOUT=3``) of that run keeps each particle's sums through
the sorts of release steps and step 16: the sums and counts it writes
equal ones taken in schedule-origin order, bit for bit.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import jax.numpy as jnp  # noqa: E402

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.io import partdump as jpd  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.io import partdump as tpd  # noqa: E402

GRID = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)


def _config(c, **cmd_kw):
    cmd = c.Command(**{**dict(
        ibdate=20200101, ibtime=0, iedate=20200101, ietime=20000,
        lsynctime=900, loutstep=3600, loutaver=3600, loutsample=900,
        lconvection=0, ipout=2), **cmd_kw})
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=3600, lon1=0.0, lon2=2.0, lat1=40.0,
                       lat2=42.0, z1=50.0, z2=500.0, mass=(1.0, 2.0),
                       parts=208)
    rel = c.Releases(species=(c.Species(), c.Species(name="B")),
                     boxes=(box,))
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=30, numygrid=20,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 50000.0))
    return cmd, rel, og


def _jax_sim(outdir, **cmd_kw):
    cmd, rel, og = _config(jconfig, **cmd_kw)
    grid = jmet.make_grid(**GRID)
    return JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                         met_backend=jmet.SyntheticMet(grid), outgrid=og,
                         outdir=str(outdir), seed=9, write_netcdf=False,
                         write_npz=False)


def _port_sim(outdir, sim_kw=None, **cmd_kw):
    cmd, rel, og = _config(tconfig, **cmd_kw)
    grid = make_grid(**GRID)
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), seed=9, write_netcdf=False,
                      write_npz=False, device="cpu", **(sim_kw or {}))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("jax")
    sim = _jax_sim(outdir)
    sim.run()
    p = {f: np.array(getattr(sim.particles, f)) for f in FIELDS}
    return sim, Path(outdir) / "partposit_end", p


def _diag(n, seed=3):
    rng = np.random.default_rng(seed)
    return tuple((rng.random(n) * 300.0).astype(np.float32)
                 for _ in range(7))


def _both(p):
    """The same particles as the JAX package's and the port's."""
    return (JParticles(**{f: jnp.asarray(v) for f, v in p.items()}),
            interop.particles_from_numpy(p, "cpu"))


@pytest.mark.parametrize("only_current", [False, True])
def test_write_partposit_gives_the_reference_bytes(jax_run, tmp_path,
                                                    only_current):
    sim, _, p = jax_run
    p = {f: v.copy() for f, v in p.items()}
    itime = sim.last_itime
    # a third of the live particles are next updated at another time
    p["itra"][::3] = itime + 900
    jp, tp = _both(p)
    diag = _diag(len(p["z"]))
    grid = interop.metgrid_from_jax(sim.grid)
    jpd.write_partposit(tmp_path / "j", itime, jp, sim.grid, diag,
                        only_current=only_current)
    tpd.write_partposit(tmp_path / "t", itime, tp, grid,
                        tuple(torch.as_tensor(d) for d in diag),
                        only_current=only_current)
    a, b = (tmp_path / "j").read_bytes(), (tmp_path / "t").read_bytes()
    assert len(b) == len(a) and b == a
    n_rec = 208 if not only_current else 208 - len(p["itra"][::3])
    assert len(a) == 12 + (n_rec + 1) * (28 + 4 * 9)


def test_read_partposit_reads_the_reference_file(jax_run):
    sim, dump, _ = jax_run
    it_j, j = jpd.read_partposit(dump, 2)
    it_t, t = tpd.read_partposit(dump, 2)
    assert it_t == it_j == sim.last_itime == 7200
    assert sorted(t) == sorted(j) and len(t["z"]) == 208
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_shortposit_and_averaged_dump_give_the_reference_bytes(jax_run,
                                                              tmp_path):
    sim, _, p = jax_run
    jp, tp = _both(p)
    itime = sim.last_itime
    grid = interop.metgrid_from_jax(sim.grid)
    topo = _diag(len(p["z"]))[0]
    jpd.write_shortposit(tmp_path / "js", itime, jp, sim.grid, topo)
    tpd.write_shortposit(tmp_path / "ts", itime, tp, grid,
                         torch.as_tensor(topo))
    a = (tmp_path / "js").read_bytes()
    assert (tmp_path / "ts").read_bytes() == a
    assert np.frombuffer(a, "<i4", 1, 16)[0] == 208
    rng = np.random.default_rng(5)
    sums = (rng.random((13, len(p["z"]))) * 2.0 - 1.0).astype(np.float32)
    sums[3:] *= 500.0
    counts = rng.integers(0, 9, len(p["z"])).astype(np.float32)
    jpd.write_partposit_average(tmp_path / "ja", itime, jp, sums, counts)
    tpd.write_partposit_average(tmp_path / "ta", itime, tp,
                                torch.as_tensor(sums),
                                torch.as_tensor(counts))
    assert (tmp_path / "ta").read_bytes() == (tmp_path / "ja").read_bytes()


def test_particle_diagnostics_close_to_jax(jax_run):
    sim, _, p = jax_run
    jp, tp = _both(p)
    z0, z1 = sim._get_field(3600), sim._get_field(7200)
    jd = jpd.particle_diagnostics(jp, z0, z1, jnp.float32(0.25),
                                  jnp.float32(0.75))
    t0 = interop.zfields_from_numpy(_np_fields(z0), "cpu")
    t1 = interop.zfields_from_numpy(_np_fields(z1), "cpu")
    td = tpd.particle_diagnostics(tp, t0, t1, 0.25, 0.75)
    for name, a, b in zip(("topo", "pv", "qv", "rho", "hmix", "tropo", "tt"),
                          jd, td):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=1e-6 * np.abs(a).max(),
                                   err_msg=name)


def _np_fields(z):
    return {k: np.asarray(getattr(z, k))
            for k in ("f3d", "f2d", "clouds", "vdep", "height")}


def test_warm_start_from_a_reference_file_gives_the_reference_particles(
        jax_run, tmp_path):
    _, dump, _ = jax_run
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        shutil.copy(dump, tmp_path / side / "partposit_end")
    js = _jax_sim(tmp_path / "jax", ipin=1)
    ts = _port_sim(tmp_path / "port", ipin=1)
    a = {f: np.asarray(getattr(js.particles, f)) for f in FIELDS}
    b = interop.particles_to_numpy(ts.particles)
    assert len(b["z"]) == 208 + 208
    for f in FIELDS:
        assert b[f].dtype == a[f].dtype, f
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    assert ts._first_release is None and 0 in ts._release_times
    js.close()
    ts.close()


def test_warm_start_without_a_dump_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="partposit_end"):
        _port_sim(tmp_path, ipin=1)


RESUME = dict(ietime=50000, lconvection=1, itsplit=3600)


def _resume_sim(outdir, **kw):
    return _port_sim(outdir, sim_kw=kw, **RESUME)


def test_checkpoint_and_resume_equal_the_straight_run(tmp_path):
    ckpt = tmp_path / "ck.npz"
    plain = _resume_sim(tmp_path / "plain")
    plain.run()
    full = _resume_sim(tmp_path / "full", checkpoint_at=7200,
                       checkpoint_path=str(ckpt))
    full.run()
    assert ckpt.exists()
    resumed = _resume_sim(tmp_path / "resume")
    t0 = resumed.load_checkpoint(ckpt)
    assert t0 == 7200
    resumed.run(start_itime=t0)
    assert resumed.last_itime == full.last_itime == 18000
    # the height grid comes back as compute_heights makes it
    assert type(resumed._height) is type(full._height) is np.ndarray
    assert resumed._height.dtype == full._height.dtype
    assert full.n_sorts > 0 and resumed.n_sorts > 0
    # the resumed part: the sort at step 16 and the splits at 9000, 16200
    assert len(resumed.split_counts) == 3
    for other in (plain, resumed):
        for f in FIELDS:
            assert torch.equal(getattr(other.particles, f),
                               getattr(full.particles, f)), f
        assert torch.equal(other._origin, full._origin)
        for g in ("gridunc", "wetgridunc", "drygridunc"):
            assert torch.equal(getattr(other.acc, g), getattr(full.acc, g))
        assert (Path(other.outdir) / "partposit_end").read_bytes() \
            == (Path(full.outdir) / "partposit_end").read_bytes()


def test_averaged_dump_follows_its_particles_through_sorts(tmp_path,
                                                          monkeypatch):
    """Each step's sample is added by schedule origin beside the run; at
    each ``partposit_average_`` dump the run's sums and counts, slot by
    slot, are those of the particle now in the slot."""
    sim = _port_sim(tmp_path, **{**RESUME, "ipout": 3})
    n = sim.particles.capacity
    acc = {}
    checked = []
    sample_fn, write_fn = tpd.averaging_sample, tpd.write_partposit_average

    def origin():
        return sim._origin if sim._origin is not None else torch.arange(n)

    def sample(p, *args):
        s, live = sample_fn(p, *args)
        if not acc:
            acc.update(s=torch.zeros(13, n), c=torch.zeros(n),
                       sorts=sim.n_sorts)
        o = origin()
        inc = live.to(torch.float32)
        acc["s"][:, o] = acc["s"][:, o] + s * inc[None, :]
        acc["c"][o] = acc["c"][o] + inc
        return s, live

    def write(path, itime, p, sums, counts):
        o = origin()
        assert torch.equal(sums, acc["s"][:, o]), itime
        assert torch.equal(counts, acc["c"][o]), itime
        checked.append((itime, sim.n_sorts - acc["sorts"]))
        acc.clear()
        write_fn(path, itime, p, sums, counts)

    monkeypatch.setattr(tpd, "averaging_sample", sample)
    monkeypatch.setattr(tpd, "write_partposit_average", write)
    sim.run()
    assert [t for t, _ in checked] == [5400, 9000, 12600, 16200]
    # sorts inside the windows: the release steps 900-3600, and step 16
    # at 14400
    assert all(k > 0 for t, k in checked if t in (5400, 16200)), checked
    assert len(list(Path(tmp_path).glob("partposit_average_*"))) == 4


def test_legacy_rng_cannot_resume(tmp_path):
    sim = _port_sim(tmp_path, sim_kw=dict(legacy_rng=True))
    with pytest.raises(ValueError, match="legacy_rng cannot resume"):
        sim.run(start_itime=3600)

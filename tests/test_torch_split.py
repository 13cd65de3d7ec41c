"""Port parity for particle splitting (``core/split.py``; kernel K13 on a
card, its plain version here).

The cases of ``tests/test_split.py``, each through both packages on the
same particles, made with numpy: doubling and mass, nothing due, the
capacity guard, scheduled releases (never a child's slot), and the run
of 100 particles that splits three times to 800.  Equal, bitwise: every
field of the split particles and the counts (due, free, granted).

The port keeps its particles in met-cell order and ranks free slots and
due parents by the slots' schedule origins (``Simulation._origin``).  A
shuffled origin must give JAX's granted parents and children: the port's
particles, put back in origin order, equal JAX's split of the particles
in origin order, bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core.split import split_particles as jsplit  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.split import (split_particles,  # noqa: E402
                                           split_particles_plain)
from flexpart_tpu_torch.core.state import FIELDS, ITRA_INACTIVE  # noqa: E402


def make_pop(n=16, n_live=4, itsplit=3600, nspec=1, seed=0):
    """tests/test_split.py's population as numpy arrays: n_live particles
    at x = 0, 1, ..., released at 0 and next updated at 7200; every other
    field drawn from a seed, so that a copy that misses a field shows."""
    rng = np.random.default_rng(seed)
    live = np.arange(n) < n_live
    f32 = np.float32

    def drawn(shape=(n,)):
        return rng.random(shape).astype(f32)

    return dict(
        x_hi=np.where(live, np.arange(n), 0).astype(f32), x_lo=drawn() * 1e-6,
        y_hi=drawn() * 10, y_lo=drawn() * 1e-6,
        z=np.where(live, 100.0, 0.0).astype(f32),
        itra=np.where(live, 7200, ITRA_INACTIVE).astype(np.int32),
        itramem=np.zeros(n, np.int32),
        npoint=rng.integers(0, 3, n).astype(np.int32),
        nclass=rng.integers(0, 5, n).astype(np.int32),
        idt=rng.integers(0, 900, n).astype(np.int32),
        itrasplit=np.where(live, itsplit, ITRA_INACTIVE).astype(np.int32),
        up=drawn(), vp=drawn(), wp=drawn(), usig=drawn(), vsig=drawn(),
        wsig=drawn(),
        cbt=np.where(drawn() < 0.5, 1, -1).astype(np.int8),
        mass=np.where(live[:, None], 1.0, 0.0).astype(f32)
        * np.ones((1, nspec), f32),
        mass0=np.where(live[:, None], 1.0, 0.0).astype(f32)
        * np.ones((1, nspec), f32),
        xscav=drawn((n, nspec)), active=live)


def both(pop, itime=7200, origin=None):
    """JAX's split of ``pop`` and the port's (as numpy), the port's with
    its counts.  With ``origin``, the port's particles are ``pop`` put in
    slot order k -> origin[k], and its result is put back in origin order
    before it is returned."""
    j = jsplit(JParticles(**{f: jnp.asarray(v) for f, v in pop.items()}),
               jnp.int32(itime))
    jnp_out = {f: np.asarray(getattr(j, f)) for f in FIELDS}
    if origin is None:
        q = interop.particles_from_numpy(pop, "cpu")
        q, counts = split_particles(q, itime, 1, None)
        t = interop.particles_to_numpy(q)
    else:
        shuffled = {f: v[origin] for f, v in pop.items()}
        q = interop.particles_from_numpy(shuffled, "cpu")
        q, counts = split_particles(q, itime, 1, torch.as_tensor(origin))
        back = np.argsort(origin)
        t = {f: v[back] for f, v in interop.particles_to_numpy(q).items()}
    return jnp_out, t, counts.tolist()


def assert_equal(j, t):
    for f in FIELDS:
        assert t[f].dtype == j[f].dtype, f
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)


def test_split_doubles_and_conserves_mass():
    pop = make_pop(nspec=2)
    j, t, counts = both(pop)
    assert_equal(j, t)
    assert counts == [4, 12, 4]
    assert int(t["active"].sum()) == 8
    np.testing.assert_allclose(t["mass"].sum(0), [4.0, 4.0], rtol=1e-6)
    np.testing.assert_array_equal(t["mass"][t["active"]], 0.5)
    assert (t["itrasplit"][t["active"]] == 7200).all()


def test_split_not_due():
    pop = make_pop(itsplit=999999999)
    j, t, counts = both(pop)
    assert_equal(j, t)
    assert counts == [0, 12, 0]
    for f in FIELDS:
        np.testing.assert_array_equal(t[f], pop[f], err_msg=f)


def test_split_capacity_guard():
    """Two free slots for four due parents: the first two by slot split,
    the other two keep their full mass."""
    pop = make_pop(n=6, n_live=4)
    j, t, counts = both(pop)
    assert_equal(j, t)
    assert counts == [4, 2, 2]
    np.testing.assert_allclose(t["mass"][:, 0],
                               [0.5, 0.5, 1.0, 1.0, 0.5, 0.5])


def test_split_respects_scheduled_releases():
    pop = make_pop(n=6, n_live=4)
    pop["itra"][5] = pop["itramem"][5] = 10800
    pop["mass"][5] = 9.0
    j, t, counts = both(pop)
    assert_equal(j, t)
    assert counts == [4, 1, 1]
    assert t["mass"][5, 0] == 9.0 and t["itra"][5] == 10800
    assert int(t["active"].sum()) == 5


@pytest.mark.parametrize("n_live", [5, 40, 70])
def test_split_with_a_shuffled_origin_grants_what_jax_grants(n_live):
    """Slots out of schedule order (a sort has run): the port ranks by
    origin, so the granted parents and the children's origins are JAX's;
    with 40 live of 80 every due one splits, with 70 the guard holds."""
    pop = make_pop(n=80, n_live=n_live, nspec=2, seed=n_live)
    # half of the live ones due, two future releases among the free slots
    pop["itrasplit"][1:n_live:2] = 999999999
    for k in (n_live + 3, 79):
        pop["itra"][k] = pop["itramem"][k] = 10800
    origin = np.random.default_rng(7).permutation(80)
    j, t, counts = both(pop, origin=origin)
    assert_equal(j, t)
    due = (n_live + 1) // 2
    free = 80 - n_live - 2
    assert counts == [due, free, min(due, free)]


@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["identity", "shuffled"])
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_split_at_the_edges_of_warps_and_tiles_equals_jax(n, shuffled):
    """Sizes around a warp's 32 flags and a 4096 tile, the sizes K13's
    bitmaps and scan tiles break at: half the slots live, every other live
    one due (a single slot: due with no free slot, the guard), a future
    release among the free slots; the identity and a shuffled origin.
    JAX's split of the particles in origin order, bitwise, and the
    counts."""
    n_live = (n + 1) // 2
    pop = make_pop(n=n, n_live=n_live, nspec=2, seed=n)
    pop["itrasplit"][1:n_live:2] = 999999999
    future = n > n_live
    if future:
        pop["itra"][n - 1] = pop["itramem"][n - 1] = 10800
    origin = np.random.default_rng(n).permutation(n) if shuffled else None
    j, t, counts = both(pop, origin=origin)
    assert_equal(j, t)
    due = (n_live + 1) // 2
    free = n - n_live - int(future)
    assert counts == [due, free, min(due, free)]


def test_kernel_and_plain_versions_pick_by_device():
    """A CPU tensor takes the plain version; the wrapper passes the origin
    and itime through."""
    pop = make_pop()
    p = interop.particles_from_numpy(pop, "cpu")
    a, ca = split_particles(p, 7200, 1, torch.arange(16))
    b, cb = split_particles_plain(interop.particles_from_numpy(pop, "cpu"),
                                  7200, 1, None)
    assert ca.tolist() == cb.tolist() == [4, 12, 4]
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _config(c, parts=100):
    grid = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=60000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    itsplit=3600)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                       lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0,
                       z1=50.0, z2=500.0, mass=(1.0,), parts=parts)
    rel = c.Releases(species=(c.Species(),), boxes=(box,))
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=30, numygrid=20,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 50000.0))
    return grid, cmd, rel, og


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """tests/test_split.py's run in the JAX package: 100 -> 800."""
    grid, cmd, rel, og = _config(jconfig)
    g = jmet.make_grid(**grid)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=g,
                        met_backend=jmet.SyntheticMet(g), outgrid=og,
                        outdir=str(tmp_path_factory.mktemp("jax")),
                        capacity=1000, write_netcdf=False)
    sim.run()
    return sim


def test_split_in_simulation_equals_jax(jax_run, tmp_path):
    """The run of tests/test_split.py: output times 5400, 9000, 12600,
    16200, 19800; splits at 5400, 9000 and 16200, 100 -> 200 -> 400 ->
    800, in both packages; the port's splits each granted as many as were
    due, its origins still a permutation, the same split times and mass
    in each schedule slot as JAX's (the split is a function of the slots'
    split times, which no draw changes)."""
    grid, cmd, rel, og = _config(tconfig)
    g = make_grid(**grid)
    sim = Simulation(cmd=cmd, releases=rel, grid=g,
                     met_backend=SyntheticMet(g), outgrid=og,
                     outdir=str(tmp_path), capacity=1000,
                     write_netcdf=False, device="cpu")
    sim.run()
    n_jax = int(np.sum(np.asarray(jax_run.particles.active)))
    assert n_jax == int(sim.particles.active.sum()) == 800
    assert [c.tolist() for c in sim.split_counts] == [
        [100, 900, 100], [200, 800, 200], [0, 600, 0], [400, 600, 400],
        [0, 200, 0]]
    np.testing.assert_allclose(float(sim.particles.mass.sum()), 1.0,
                               rtol=1e-5)
    origin = sim._origin.numpy()
    assert sorted(origin.tolist()) == list(range(1000))
    back = np.argsort(origin)
    for f in ("active", "itrasplit", "itramem", "mass", "mass0", "npoint"):
        np.testing.assert_array_equal(
            getattr(sim.particles, f).numpy()[back],
            np.asarray(getattr(jax_run.particles, f)), err_msg=f)

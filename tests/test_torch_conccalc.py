"""Port parity: concentration sampling (gridunc) against JAX.

The same particles go through ``flexpart_tpu.grid.conccalc`` and the
port's plain twin of kernel K3.  Tolerance: rtol 1e-6 (atol 1e-12 for
empty cells) — both sides compute every contribution with the same
float32 operations, only the order of the float additions into a cell
differs (XLA's scatter vs ``index_add_``).  XLA contracts
``x * dx_met + xoutshift`` into an FMA; the particles sit on a lattice
where the product is exact, so that contraction changes no bit.

Covered: a young plume (single-index path), an old plume with particles
at the edges and outside the grid (4-point kernel path), ``ind_samp`` 0
and -1, nspec 2, nage 2, and out-of-range particles, which are dropped;
on both paths, the backward deposition runs' contribution (times
max(xscav, 0), K3's ``BKDEP`` instantiation on a card) and the particle
count (1, or the 4-point weight: ``COUNT``), at the same tolerance; and
a backward deposition run's plume (thousands of pairs a cell), where the
twin and JAX are each held to K8's rule against the float64 sum of the
pairs, the rule that K3's BKDEP body is held to on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.config import OutGrid  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.grid import conccalc as jcc  # noqa: E402
from flexpart_tpu.grid import outgrid as jog  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.grid import conccalc as tcc  # noqa: E402
from flexpart_tpu_torch.grid import outgrid as tog  # noqa: E402
from flexpart_tpu_torch.met.synthetic import make_grid  # noqa: E402

N = 3000
ITIME = 14400
OG = OutGrid(outlon0=-60.0, outlat0=-30.0, numxgrid=48, numygrid=30,
             dxout=2.5, dyout=2.0, outheights=(300.0, 2000.0, 10000.0))


@pytest.fixture(scope="module")
def setup():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    eta = jmet.SyntheticMet(grid).fetch(0.0)
    h = jmet.compute_heights(grid, eta)
    z = jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h))
    tz = interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                     z._asdict().items()}, "cpu")
    return grid, z, tz


def _particles(grid, old: bool, seed=0):
    rs = np.random.default_rng(seed)
    # lon -65..65, lat -35..35: straddles every edge of the output grid
    lon = rs.uniform(-65.0, 65.0, N)
    lat = rs.uniform(-35.0, 35.0, N)
    # positions on a 2**-12 lattice: x * dx_met is then exact, so XLA's
    # contraction of ``x * dx_met + xoutshift`` into an FMA cannot move
    # the output-grid coordinate and both sides weight alike
    x = (np.round((lon - grid.xlon0) / grid.dx * 4096) / 4096).astype(np.float32)
    y = (np.round((lat - grid.ylat0) / grid.dy * 4096) / 4096).astype(np.float32)
    z = rs.uniform(0.0, 12000.0, N).astype(np.float32)     # some above top
    itramem = np.where(rs.uniform(size=N) < 0.5, 0,
                       ITIME - 3600) if old else np.full(N, ITIME - 3600)
    p = jstate.empty_particles(N, nspec=2)
    return p._replace(
        x_hi=jnp.asarray(x), y_hi=jnp.asarray(y), z=jnp.asarray(z),
        itra=jnp.asarray(np.where(rs.uniform(size=N) < 0.95, ITIME,
                                  ITIME - 900).astype(np.int32)),
        itramem=jnp.asarray(np.asarray(itramem, np.int32)),
        nclass=jnp.asarray(rs.integers(0, 2, N).astype(np.int32)),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        mass=jnp.asarray(rs.uniform(0.5, 1.5, (N, 2)).astype(np.float32)))


@pytest.mark.parametrize("old,ind_samp", [(False, 0), (True, 0),
                                          (False, -1), (True, -1)])
def test_gridunc_matches_jax(setup, old, ind_samp):
    grid, jz, tz = setup
    tgrid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    jgeo = jog.OutputGridGeometry(OG, grid)
    tgeo = tog.OutputGridGeometry(OG, tgrid)
    kw = dict(nxg=jgeo.nxg, nyg=jgeo.nyg, nzg=jgeo.nzg, npointspec=1,
              nclassunc=2, nage=2, dxout=OG.dxout, dyout=OG.dyout,
              xoutshift=jgeo.xoutshift, youtshift=jgeo.youtshift,
              dx_met=grid.dx, dy_met=grid.dy, ind_samp=ind_samp,
              kernel_possible=old)
    jcfg = jcc.ConcConfig(**kw)
    tcfg = tcc.ConcConfig(**kw)
    lage = np.asarray([7200, 999999], np.int32)
    jp = _particles(grid, old)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")

    jacc = jog.zero_accumulators(jgeo, 2, 1, 2, 2)
    jacc = jcc.make_conccalc(OG.outheights)(
        jacc, jp, jz, jnp.int32(ITIME), jnp.asarray(lage), jnp.float32(0.5),
        jcfg)
    tacc = interop.accumulators_from_numpy(
        {k: np.asarray(v) for k, v in
         jog.zero_accumulators(jgeo, 2, 1, 2, 2)._asdict().items()}, "cpu")
    assert tacc.gridunc.shape == tog.zero_accumulators(
        tgeo, 2, 1, 2, 2, device="cpu").gridunc.shape
    tacc = tcc.make_conccalc(OG.outheights)(
        tacc, tp, tz, ITIME, torch.as_tensor(lage), 0.5, tcfg)

    a = interop.accumulators_to_numpy(tacc)["gridunc"]
    b = np.asarray(jacc.gridunc)
    assert a.shape == b.shape == (2, 2, 1, 3, 30, 48, 2)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    assert float(tacc.outnum) == float(jacc.outnum) == 0.5
    if ind_samp == 0:
        # live particles outside the grid or above the top were dropped
        live = np.asarray(jp.active) & (np.asarray(jp.itra) == ITIME)
        assert 0.0 < a.sum() < 0.5 * np.asarray(jp.mass)[live].sum()


@pytest.mark.parametrize("old", [False, True])
@pytest.mark.parametrize("mode", ["bkdep", "particle_count_output"])
def test_bkdep_and_particle_count_match_jax(setup, old, mode):
    """The ``bkdep`` branch (each species' contribution times max(xscav,
    0), ``conccalc.py:144-145,178-179`` there) and the
    ``particle_count_output`` branch (``:140-141,174-175``), on the
    single-index and the 4-point path, with scavenging factors of which a
    fifth are negative (sampled as 0)."""
    grid, jz, tz = setup
    jgeo = jog.OutputGridGeometry(OG, grid)
    kw = dict(nxg=jgeo.nxg, nyg=jgeo.nyg, nzg=jgeo.nzg, npointspec=1,
              nclassunc=2, nage=2, dxout=OG.dxout, dyout=OG.dyout,
              xoutshift=jgeo.xoutshift, youtshift=jgeo.youtshift,
              dx_met=grid.dx, dy_met=grid.dy, ind_samp=0,
              kernel_possible=old, **{mode: True})
    lage = np.asarray([7200, 999999], np.int32)
    xscav = np.random.default_rng(5).uniform(-0.5, 2.0, (N, 2)) \
        .astype(np.float32)
    jp = _particles(grid, old)._replace(xscav=jnp.asarray(xscav))
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    jacc = jcc.make_conccalc(OG.outheights)(
        jog.zero_accumulators(jgeo, 2, 1, 2, 2), jp, jz, jnp.int32(ITIME),
        jnp.asarray(lage), jnp.float32(0.5), jcc.ConcConfig(**kw))
    tacc = tog.zero_accumulators(tog.OutputGridGeometry(OG, make_grid(
        nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)), 2, 1, 2, 2, device="cpu")
    tacc = tcc.make_conccalc(OG.outheights)(
        tacc, tp, tz, ITIME, torch.as_tensor(lage), 0.5,
        tcc.ConcConfig(**kw))
    a = tacc.gridunc.numpy()
    b = np.asarray(jacc.gridunc)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    assert b.sum() > 0
    # the branch did change the sum: not the mass sampling
    plain = tcc.make_conccalc(OG.outheights)(
        tog.zero_accumulators(tog.OutputGridGeometry(OG, make_grid(
            nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)), 2, 1, 2, 2,
            device="cpu"), tp, tz, ITIME, torch.as_tensor(lage), 0.5,
        tcc.ConcConfig(**{**kw, mode: False}))
    assert not np.allclose(plain.gridunc.numpy(), a, rtol=1e-3)


@pytest.mark.parametrize("old", [False, True])
def test_bkdep_plume_holds_k8s_rule_against_f64_and_jax(setup, old):
    """The ``bkdep`` branch on what a backward deposition run samples: a
    plume, 8192 live particles in one 2.5 x 2 degree output cell's
    neighbourhood at 300-2000 m (a few cells, thousands of pairs each),
    young (one target) or past 3 h (the 4-point kernel), factors of which
    a fifth are negative.  The plain twin (``index_add_``, the CPU's
    float32 sum) and JAX's ``_conccalc_impl`` (XLA's scatter) are each
    held to K8's rule against the float64 sum of the pairs
    (``conccalc_pairs``): a cell of m pairs within max(m x 2**-24, 1e-5),
    relatively, as the kernel (K3's BKDEP body) is held on the card; a
    plume is never held to another float32 sum at rtol 1e-5."""
    grid, jz, tz = setup
    jgeo = jog.OutputGridGeometry(OG, grid)
    kw = dict(nxg=jgeo.nxg, nyg=jgeo.nyg, nzg=jgeo.nzg, npointspec=1,
              nclassunc=1, nage=1, dxout=OG.dxout, dyout=OG.dyout,
              xoutshift=jgeo.xoutshift, youtshift=jgeo.youtshift,
              dx_met=grid.dx, dy_met=grid.dy, ind_samp=0,
              kernel_possible=True, bkdep=True)
    n = 8192
    rs = np.random.default_rng(11)
    lon = rs.uniform(0.0, 2.5, n)
    lat = rs.uniform(10.0, 12.0, n)
    x = (np.round((lon - grid.xlon0) / grid.dx * 4096) / 4096).astype(
        np.float32)
    y = (np.round((lat - grid.ylat0) / grid.dy * 4096) / 4096).astype(
        np.float32)
    p = jstate.empty_particles(n, nspec=2)
    jp = p._replace(
        x_hi=jnp.asarray(x), y_hi=jnp.asarray(y),
        z=jnp.asarray(rs.uniform(300.0, 2000.0, n).astype(np.float32)),
        itra=jnp.full(n, ITIME, jnp.int32),
        itramem=jnp.full(n, ITIME - (14400 if old else 3600), jnp.int32),
        active=jnp.ones(n, bool),
        mass=jnp.asarray(rs.uniform(0.5, 1.5, (n, 2)).astype(np.float32)),
        xscav=jnp.asarray(rs.uniform(-0.5, 2.0, (n, 2)).astype(np.float32)))
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    lage = np.asarray([999999], np.int32)
    jacc = jcc.make_conccalc(OG.outheights)(
        jog.zero_accumulators(jgeo, 2, 1), jp, jz, jnp.int32(ITIME),
        jnp.asarray(lage), jnp.float32(0.5), jcc.ConcConfig(**kw))
    tgeo = tog.OutputGridGeometry(OG, make_grid(nx=37, ny=19, nlev=15,
                                                dx=10.0, dy=10.0))
    tacc = tcc.make_conccalc(OG.outheights)(
        tog.zero_accumulators(tgeo, 2, 1, device="cpu"), tp, tz, ITIME,
        torch.as_tensor(lage), 0.5, tcc.ConcConfig(**kw))
    flat = tacc.gridunc.view(-1, 2)
    lin, valid, contrib = tcc.conccalc_pairs(
        flat.shape[0], tp, ITIME, torch.as_tensor(lage),
        torch.as_tensor(np.asarray(OG.outheights, np.float32)), 0.5, None,
        tcc.ConcConfig(**kw))
    lin, contrib = lin[valid], contrib[valid]
    ref = torch.zeros(flat.shape, dtype=torch.float64)
    ref.index_add_(0, lin, contrib.double())
    pairs = torch.zeros(flat.shape[0], dtype=torch.int64)
    pairs.index_add_(0, lin, torch.ones_like(lin))
    assert int((pairs > 0).sum()) <= 24 and int(pairs.max()) >= 1000
    rtol = torch.clamp(pairs.double() * 2.0 ** -24, min=1e-5)[:, None]
    assert float(ref.sum()) > 0.0
    for who, got in (("plain twin", flat.double()),
                     ("jax", torch.as_tensor(np.array(jacc.gridunc))
                      .reshape(flat.shape).double())):
        assert bool(torch.all((got - ref).abs() <= rtol * ref)), who


def test_out_of_range_is_dropped(setup):
    """Particles far outside the grid or above the top level add nothing
    (JAX drops them with the 2**30 sentinel; the twin filters them)."""
    grid, jz, tz = setup
    tgeo = tog.OutputGridGeometry(OG, make_grid(nx=37, ny=19, nlev=15,
                                                dx=10.0, dy=10.0))
    cfg = tcc.ConcConfig(nxg=tgeo.nxg, nyg=tgeo.nyg, nzg=tgeo.nzg,
                         npointspec=1, nclassunc=1, nage=1, dxout=OG.dxout,
                         dyout=OG.dyout, xoutshift=tgeo.xoutshift,
                         youtshift=tgeo.youtshift, dx_met=grid.dx,
                         dy_met=grid.dy, ind_samp=0, kernel_possible=True)
    jp = _particles(grid, True)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    tp = tp.replace(x_hi=torch.full_like(tp.x_hi, 1e9),
                    z=torch.full_like(tp.z, 5.0))
    acc = tog.zero_accumulators(tgeo, 2, 1, device="cpu")
    acc = tcc.make_conccalc(OG.outheights)(
        acc, tp, tz, ITIME, torch.tensor([999999], dtype=torch.int32), 1.0,
        cfg)
    assert float(acc.gridunc.abs().sum()) == 0.0
    tp = tp.replace(x_hi=torch.full_like(tp.x_hi, 20.0),
                    z=torch.full_like(tp.z, 2e4))
    acc = tcc.make_conccalc(OG.outheights)(
        acc, tp, tz, ITIME, torch.tensor([999999], dtype=torch.int32), 1.0,
        cfg)
    assert float(acc.gridunc.abs().sum()) == 0.0

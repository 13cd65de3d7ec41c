"""The port's particle sharding (``flexpart_tpu_torch/parallel/``) on 2, 3
and 4 shards in one process, against the JAX package's
``flexpart_tpu.parallel`` on its 8-device virtual mesh
(tests/conftest.py) and against the port's own unsplit calls.

A rank ``r`` of ``W`` holds the global slots ``[r * L, (r + 1) * L)`` of
the capacity padded to a multiple of ``W`` (``Layout``): the pad of a
capacity of 100 over 3, and each rank's rows, equal JAX's
``pad_particles`` and its ``P("p")`` sharding (and
``interop.rank_rows_from_numpy`` of a JAX ``Particles``).  Each shard
goes through the port's calls with its offsets, held against the unsplit
call:

* the advance with the turbulence off, offset ``r * L``: bitwise (shards
  of a multiple of 16 particles: torch's CPU ``pow`` rounds a last partial
  vector differently), its diagnostics summed to the unsplit ones and to
  JAX's ``psum``, its positions within tests/test_torch_advance.py's
  tolerances of JAX's sharded advance;
* sampling (K3's plain twin) and the deposit scatter (K8's) into partial
  grids, summed in rank order: within rtol 1e-5 of the unsplit grid (and
  of JAX's ``reduce_acc_partials``), ``outnum`` not summed;
* K13's plain twin with each rank's ``Share`` and the rows exchanged as
  ``split_sharded`` exchanges them: every field and the counts bitwise the
  unsplit split (and JAX's), with due > free and the granted parents on
  other ranks than their children's slots, a rank with no live particle,
  and shuffled origins;
* K14's plain twin with each rank's first free rank from the free counts
  after the kill: every field, the accumulator and the summed counts
  bitwise the unsplit step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import torch_dp_ranks as dr  # noqa: E402
from flexpart_tpu import parallel as jpar  # noqa: E402
from flexpart_tpu.config import OutGrid as JOutGrid  # noqa: E402
from flexpart_tpu.core import advance_all as jadvance_all  # noqa: E402
from flexpart_tpu.core.split import split_particles as jsplit  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.core.state import empty_particles as jempty  # noqa: E402
from flexpart_tpu.grid import conccalc as jcc  # noqa: E402
from flexpart_tpu.grid import outgrid as jog  # noqa: E402
from flexpart_tpu.met import (calcpar, compute_heights, make_grid,  # noqa: E402
                              process_eta, uniform_wind_met)
from flexpart_tpu_torch import interop, parallel  # noqa: E402
from flexpart_tpu_torch.config import OutGrid  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import domainfill as tdf  # noqa: E402
from flexpart_tpu_torch.core import rng  # noqa: E402
from flexpart_tpu_torch.core.release import activate  # noqa: E402
from flexpart_tpu_torch.core.split import (split_particles_plain,  # noqa: E402
                                           due_and_free)
from flexpart_tpu_torch.core.state import FIELDS, ITRA_INACTIVE  # noqa: E402
from flexpart_tpu_torch.grid import conccalc as tcc  # noqa: E402
from flexpart_tpu_torch.grid import outgrid as tog  # noqa: E402
from flexpart_tpu_torch.met import make_grid as tmake_grid  # noqa: E402
from flexpart_tpu_torch.parallel.sharding import (  # noqa: E402
    Layout, crossing_slots, free_after_kill, pack_rows, split_shares,
    unpack_rows)
from flexpart_tpu_torch.physics.wetdepo import depo_scatter  # noqa: E402

from test_core import make_cfg  # noqa: E402

WORLDS = (2, 3, 4)
N = 192                       # shards of 96, 64 and 48: multiples of 16
MESH = 8


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's setup: a 40 x 30 regional grid at 1 degree
    with a uniform 10 m/s westerly, processed by JAX, carried across."""
    grid = make_grid(nx=40, ny=30, nlev=15, dx=1.0, dy=1.0, xlon0=0.0,
                     ylat0=20.0, xglobal=False)
    eta = uniform_wind_met(grid, u=10.0, v=0.0).fetch(0.0)
    z0 = calcpar(grid, eta, process_eta(grid, eta,
                                        compute_heights(grid, eta)))
    tz = interop.zfields_from_numpy(
        {k: np.asarray(v) for k, v in z0._asdict().items()}, "cpu")
    return grid, z0, tz


def _particles(n, seed, nspec=1):
    """tests/test_parallel.py's particles, drawn with numpy."""
    rs = np.random.default_rng(seed)
    p = jempty(n, nspec)
    return p._replace(
        x_hi=jnp.asarray(rs.uniform(5.0, 30.0, n), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(5.0, 25.0, n), jnp.float32),
        z=jnp.asarray(rs.uniform(10.0, 5000.0, n), jnp.float32),
        active=jnp.asarray(rs.uniform(size=n) < 0.9),
        itra=jnp.zeros(n, jnp.int32), itramem=jnp.zeros(n, jnp.int32),
        npoint=jnp.asarray(rs.integers(0, 2, n), jnp.int32),
        mass=jnp.asarray(rs.uniform(0.1, 1.0, (n, nspec)), jnp.float32))


def _np(jp) -> dict:
    return {f: np.asarray(getattr(jp, f)) for f in FIELDS}


def _shards(p, world):
    """The ranks' rows of port particles ``p`` (padded), as copies."""
    p = parallel.pad_particles(p, world)
    return [parallel.shard_particles(p, Layout(world, r))
            for r in range(world)]


def _cat(shards):
    return {f: torch.cat([getattr(s, f) for s in shards]).numpy()
            for f in FIELDS}


def test_pad_and_rank_rows_equal_jax():
    """A capacity of 100 over 3: 2 pad slots (inactive, never scheduled),
    34 rows a rank, JAX's padded array and its P("p") shards."""
    jp = _particles(100, 1)
    jpad = jpar.pad_particles(jp, 3)
    assert jpad.capacity == 102
    tp = interop.particles_from_numpy(_np(jp), "cpu")
    tpad = parallel.pad_particles(tp, 3)
    assert tpad.capacity == 102
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tpad, f).numpy(),
                                      np.asarray(getattr(jpad, f)), f)
    assert not tpad.active[100:].any()
    assert (tpad.itra[100:] == ITRA_INACTIVE).all()
    mesh = jpar.particle_mesh(3)
    jsh = jpar.shard_particles(jpad, mesh)
    for r in range(3):
        lay = Layout(3, r)
        assert lay.rows(102) == (34 * r, 34)
        mine = parallel.shard_particles(tpad, lay)
        rows = interop.rank_rows_from_numpy(_np(jp), 3, r)
        for f in FIELDS:
            shard = [s for s in getattr(jsh, f).addressable_shards
                     if s.index[0].start == 34 * r][0]
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          np.asarray(shard.data), f)
            np.testing.assert_array_equal(rows[f], np.asarray(shard.data), f)
    with pytest.raises(ValueError, match="no multiple"):
        Layout(3, 0).rows(100)
    # a numpy schedule pads the same way
    sched = parallel.pad_particles(interop.particles_to_numpy(tp), 3)
    for f in FIELDS:
        np.testing.assert_array_equal(sched[f], getattr(tpad, f).numpy())


@pytest.fixture(scope="module")
def advanced(setup):
    """JAX's sharded advance on the 8-device mesh (turbulence off) and the
    port's unsplit advance of the same particles."""
    grid, z0, tz = setup
    jcfg, jprm = make_cfg(grid, turboff=True)
    jp = _particles(N, 0)
    key = jax.random.PRNGKey(5)
    mesh = jpar.particle_mesh(MESH)
    adv = jpar.make_sharded_advance(mesh, jcfg)
    z_r = jpar.replicate(z0, mesh)
    jout, jdiag = adv(jpar.shard_particles(jp, mesh), z_r, z_r, jnp.int32(0),
                      jnp.int32(0), jnp.int32(3600), key, jprm)
    jserial = jadvance_all(jp, z0, z0, jnp.int32(0), jnp.int32(0),
                           jnp.int32(3600), key, jcfg, jprm)[0]
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    tp = interop.particles_from_numpy(_np(jp), "cpu")
    tout, tdiag = tadv.advance_all(tp, tz, tz, 0, 0, 3600, rng.Key(5, 0),
                                   tcfg, tprm)
    return dict(jp=jp, jout=jout, jdiag=jdiag, jserial=jserial, tcfg=tcfg,
                tprm=tprm, tout=tout, tdiag=tdiag)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_advance_is_the_unsplit_one(setup, advanced, world):
    _, _, tz = setup
    a = advanced
    tp = interop.particles_from_numpy(_np(a["jp"]), "cpu")
    outs, diags = [], []
    for r, shard in enumerate(_shards(tp, world)):
        first, _ = Layout(world, r).rows(N)
        q, d = tadv.advance_all(shard, tz, tz, 0, 0, 3600, rng.Key(5, 0),
                                a["tcfg"], a["tprm"], offset=first)
        outs.append(q)
        diags.append(d)
    got = _cat(outs)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], getattr(a["tout"], f).numpy(),
                                      f)
    for k in ("n_active", "n_exited", "nan_count"):
        total = sum(int(getattr(d, k)) for d in diags)
        assert total == int(getattr(a["tdiag"], k)), k
    assert sum(int(d.n_active) for d in diags) == int(a["jdiag"].n_active)
    # JAX's sharded advance is its serial one bitwise; the port's is held
    # to it as tests/test_torch_advance.py holds the advance
    for f in ("x_hi", "y_hi", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(a["jout"], f)),
                                      np.asarray(getattr(a["jserial"], f)))
    jx = np.asarray(a["jout"].x_hi) + np.asarray(a["jout"].x_lo)
    jy = np.asarray(a["jout"].y_hi) + np.asarray(a["jout"].y_lo)
    np.testing.assert_allclose(got["x_hi"] + got["x_lo"], jx, atol=1e-4)
    np.testing.assert_allclose(got["y_hi"] + got["y_lo"], jy, atol=1e-4)
    np.testing.assert_allclose(got["z"], np.asarray(a["jout"].z), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_array_equal(got["active"],
                                  np.asarray(a["jout"].active))


OG = dict(outlon0=0.0, outlat0=20.0, numxgrid=20, numygrid=15, dxout=2.0,
          dyout=2.0, outheights=(500.0, 2000.0, 20000.0))
CC = dict(nxg=20, nyg=15, nzg=3, npointspec=2, nclassunc=1, nage=1,
          dxout=2.0, dyout=2.0, xoutshift=0.0, youtshift=0.0, dx_met=1.0,
          dy_met=1.0, ind_samp=0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_conccalc_and_deposit_reduce_to_the_unsplit_grids(
        setup, world):
    grid, z0, tz = setup
    tgrid = tmake_grid(nx=40, ny=30, nlev=15, dx=1.0, dy=1.0, xlon0=0.0,
                       ylat0=20.0, xglobal=False)
    jp = _particles(N, 3, nspec=2)
    tp = interop.particles_from_numpy(_np(jp), "cpu")
    geo = tog.OutputGridGeometry(OutGrid(**OG), tgrid)
    cfg = tcc.ConcConfig(**CC)
    lage = torch.tensor([999999999], dtype=torch.int32)
    cc = parallel.make_sharded_conccalc(None, OG["outheights"])
    whole = cc(tog.zero_accumulators(geo, 2, 2, device="cpu"), tp, tz, 0, lage, 1.0, cfg)
    deposit = torch.as_tensor(
        np.random.default_rng(7).uniform(0, 1e-3, (2, N)), dtype=torch.float32)
    depo_whole = torch.zeros_like(whole.wetgridunc)
    depo_scatter(depo_whole, deposit, tp, 0, lage, cfg)
    parts, depo = [], []
    for r, shard in enumerate(_shards(tp, world)):
        first, per = Layout(world, r).rows(N)
        acc = cc(tog.zero_accumulators(geo, 2, 2, device="cpu"), shard, tz, 0, lage, 1.0,
                 cfg)
        parts.append(acc)
        g = torch.zeros_like(whole.wetgridunc)
        scatter = parallel.make_sharded_depo_scatter(None, depo_scatter)
        scatter(g, deposit[:, first:first + per].contiguous(), shard, 0,
                lage, cfg)
        depo.append(g)
    summed = parts[0].gridunc.clone()
    for q in parts[1:]:
        summed += q.gridunc
    np.testing.assert_allclose(summed.numpy(), whole.gridunc.numpy(),
                               rtol=1e-5, atol=1e-12)
    assert all(float(q.outnum) == float(whole.outnum) == 1.0 for q in parts)
    dsum = depo[0].clone()
    for g in depo[1:]:
        dsum += g
    np.testing.assert_allclose(dsum.numpy(), depo_whole.numpy(), rtol=1e-5,
                               atol=1e-12)
    # JAX's partials on its 8-device mesh, reduced
    mesh = jpar.particle_mesh(MESH)
    jgeo = jog.OutputGridGeometry(JOutGrid(**OG), grid)
    jcfg = jcc.ConcConfig(**CC)
    ccp = jpar.make_sharded_conccalc(mesh, OG["outheights"], jcfg)
    accp = ccp(jpar.zero_acc_partials(mesh, jgeo, 2, 2, 1, 1),
               jpar.shard_particles(jp, mesh), jpar.replicate(z0, mesh),
               jnp.int32(0), jnp.asarray([999999999], jnp.int32),
               jnp.float32(1.0))
    total = jpar.reduce_acc_partials(accp)
    np.testing.assert_allclose(summed.numpy(), np.asarray(total.gridunc),
                               rtol=1e-5, atol=1e-12)
    assert float(total.outnum) == 1.0


def _split_population(n, seed, live_until, free_from, origin_seed=None):
    """Particles for a split at 7200 s: the slots below ``live_until``
    live and due (every second one of them twice as long ago), those from
    ``free_from`` on free, the rest scheduled releases (neither); every
    other field drawn, so that a copy that misses one shows."""
    rs = np.random.default_rng(seed)
    k = np.arange(n)
    live = k < live_until
    free = k >= free_from
    f32 = np.float32
    d = {f: rs.random(n).astype(f32) for f in
         ("x_hi", "x_lo", "y_hi", "y_lo", "z", "up", "vp", "wp", "usig",
          "vsig", "wsig")}
    d.update(
        itra=np.where(live, 7200, np.where(free, ITRA_INACTIVE, 9000))
        .astype(np.int32),
        itramem=np.where(live, 0, 9000).astype(np.int32),
        npoint=rs.integers(0, 3, n).astype(np.int32),
        nclass=rs.integers(0, 5, n).astype(np.int32),
        idt=rs.integers(0, 900, n).astype(np.int32),
        itrasplit=np.where(live, np.where(k % 2 == 0, 3600, 7200),
                           ITRA_INACTIVE).astype(np.int32),
        cbt=np.where(rs.random(n) < 0.5, 1, -1).astype(np.int8),
        mass=rs.random((n, 2)).astype(f32),
        mass0=rs.random((n, 2)).astype(f32),
        xscav=rs.random((n, 2)).astype(f32), active=live)
    return d


def _local_origins(world, seed):
    """Per rank a shuffled permutation of its own slots (a rank sorts only
    its rows), and the global origin of each global slot."""
    rs = np.random.default_rng(seed)
    per = N // world
    local = [rs.permutation(per) for _ in range(world)]
    return local, np.concatenate([o + r * per for r, o in enumerate(local)])


SPLIT_CASES = {
    # live | scheduled | free: due 128 > free 64, rank 0's parents take
    # the last rank's slots
    "due_over_free": (128, 128),
    # 48 live, 144 free: the last ranks hold no live particle
    "free_over_due": (48, 48),
    # no free slot: nothing granted
    "no_free": (192, 192),
    # 96 live, 32 scheduled, 64 free
    "scheduled_between": (96, 128),
}


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_split_shares_equal_the_unsplit_split(world, case, shuffled):
    live_until, free_from = SPLIT_CASES[case]
    pop = _split_population(N, 11, live_until, free_from)
    local, origin = (_local_origins(world, 5) if shuffled
                     else (None, None))
    whole = interop.particles_from_numpy(pop, "cpu")
    _, wcounts = split_particles_plain(
        whole, 7200, 1, None if origin is None else torch.as_tensor(origin))
    # JAX's split of the particles in origin order
    jin = {f: (a if origin is None else a[np.argsort(origin)])
           for f, a in pop.items()}
    jout = jsplit(JParticles(**{f: jnp.asarray(a) for f, a in jin.items()}),
                  jnp.int32(7200), 1)
    # each rank's share, then the exchange of split_sharded
    shards = _shards(interop.particles_from_numpy(pop, "cpu"), world)
    shards = [interop.particles_from_numpy(interop.particles_to_numpy(s),
                                           "cpu") for s in shards]
    orig = [None if local is None else torch.as_tensor(o) for o in
            (local or [None] * world)]
    counts = np.array([[int(m.sum()) for m in due_and_free(s, 7200, 1)]
                       for s in shards])
    shares, moves = split_shares(counts)
    sent, arrive = [], []
    for r, s in enumerate(shards):
        _, c, parents, takers = split_particles_plain(s, 7200, 1, orig[r],
                                                      shares[r])
        assert int(c[2]) == shares[r].limits()[0]
        away, into = crossing_slots(shares[r], parents, takers)
        rows = pack_rows(s, away)
        sent.append(torch.split(rows, moves[r].tolist()))
        arrive.append(into)
    for t in range(world):
        got = torch.cat([sent[s][t] for s in range(world)])
        assert got.shape[0] == moves[:, t].sum() == arrive[t].shape[0]
        unpack_rows(shards[t], arrive[t], got)
    if case == "due_over_free":
        assert moves.sum() == 64 and moves[0, world - 1] > 0
    got = _cat(shards)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], getattr(whole, f).numpy(), f)
    assert [int(counts[:, 0].sum()), int(counts[:, 1].sum()),
            shares[0].granted] == wcounts.tolist()
    back = np.argsort(origin) if origin is not None else slice(None)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f][back],
                                      np.asarray(getattr(jout, f)), f)


@pytest.fixture(scope="module")
def boundary_case(tmp_path_factory):
    """The regional fill of tests/torch_dp_ranks.py (serial, on the CPU):
    its particles released, a tenth of them moved out of the window,
    its boundary state with inflow gathered and the fields of its first
    hour."""
    sim = dr.port_df(tmp_path_factory.mktemp("bc"))
    sim._fill_domain()
    z0, z1 = sim._get_field(0), sim._get_field(3600)
    p = activate(sim.particles, 0)
    out = torch.arange(p.capacity) % 10 == 3
    p.x_hi[out] += 30.0
    # inflow gathered over earlier steps: up to three particle masses a site
    bs = sim._boundary
    gen = torch.Generator().manual_seed(3)
    sim._boundary = bs.replace(acc=torch.rand(bs.sites, generator=gen)
                               * 3.0 * bs.limits()[0])
    sim.close()
    return sim, p, z0, z1


@pytest.mark.parametrize("world", WORLDS)
def test_boundary_free_base_equals_the_unsplit_step(boundary_case, world):
    sim, p, z0, z1 = boundary_case
    bs = sim._boundary
    cmd = sim.cmd

    def step(q, free_base=None):
        return tdf.boundcond(
            q, bs, z0.f3d, z1.f3d, z0.height, 900, 0.75, 0.25,
            rng.Key(sim.seed, 3000001), cmd.lsynctime, 499999999,
            sim.grid.ylat0, sim.grid.dy, check_x=True, free_base=free_base)

    def copy(q):
        return interop.particles_from_numpy(interop.particles_to_numpy(q),
                                            "cpu")

    whole = copy(p)
    wacc, wcounts = step(whole)
    assert wcounts[0] > 0 and wcounts[3] > 0
    shards = [copy(s) for s in _shards(p, world)]
    free = [int(free_after_kill(s, bs, True)) for s in shards]
    counts, accs = [], []
    for r, s in enumerate(shards):
        a, c = step(s, torch.tensor([sum(free[:r])], dtype=torch.int64))
        accs.append(a)
        counts.append(c)
        assert int(c[1]) == free[r]
    got = _cat(shards)
    n = p.capacity
    for f in FIELDS:
        np.testing.assert_array_equal(got[f][:n],
                                      getattr(whole, f).numpy(), f)
    assert not got["active"][n:].any()
    for a in accs:
        assert torch.equal(a, wacc)
    c = torch.stack(counts)
    pads = len(got["z"]) - n
    assert [int(c[:, 0].sum()), int(c[:, 1].sum()) - pads, int(c[0, 2]),
            int(c[:, 3].sum())] == wcounts.tolist()

"""The port's tiles layer in one process, against the JAX package's
``flexpart_tpu.parallel.domain`` and ``parallel.tiles`` on its virtual mesh
(tests/conftest.py's 8 host devices).

* The layout bitwise: ``decompose_zfields`` (ceil tiles, uneven ones
  included), ``decompose``, ``tile_of``, ``local_coords``, ``in_reach``,
  ``halo_for``, ``plan_tile_capacity``, ``shard_by_tile`` and
  ``shard_by_tile_scheduled``; ``interp_tile`` equal.
* ``choose_tile_mesh`` equal to the JAX version wherever that admits no
  empty tile; an empty tile is never chosen.
* The migration split by hand into 2 x 2 tiles (``migrate_in_process``)
  against ``make_migrate``: nothing lost, every particle on its owner, its
  state with it, each tile holding the particles the JAX mesh holds.
* The tiled plain advance (``step_in_process``: each tile's step on its
  tile, then the migration) against ``make_tiled_advance`` on the 2 x 4
  mesh, without and with the polar caps, to tests/test_domain_decomp.py's
  tolerances (:557-560, :663-675).
* The tiled plain advance against the port's serial plain advance with the
  same draws (injected by schedule origin), turbulent, on 2 x 2 and 1 x 1
  tiles: every particle that the step neither wraps, mirrors, kills nor
  moves by the caps' update bitwise, the others within the reference's
  tolerance.
* Every option that tiles part 1 refused, run in a one-rank gloo group
  against the serial run; the refusals left (nested met, backward
  deposition, ``legacy_rng``) by name, and the halo check.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu.core import StepConfig as JStepConfig  # noqa: E402
from flexpart_tpu.core import StepParams as JStepParams  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.core.state import empty_particles as jempty  # noqa: E402
from flexpart_tpu.met import (calcpar, compute_heights, make_grid,  # noqa: E402
                              process_eta, uniform_wind_met)
from flexpart_tpu.met.fields import F3_U  # noqa: E402
from flexpart_tpu.met.fields import ZFields as JZFields  # noqa: E402
from flexpart_tpu.parallel import domain as jdom  # noqa: E402
from flexpart_tpu.parallel import tiles as jtiles  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import rng  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS, ITRA_INACTIVE  # noqa: E402
from flexpart_tpu_torch.parallel import domain as tdom  # noqa: E402
from flexpart_tpu_torch.parallel import tiles as ttiles  # noqa: E402
from flexpart_tpu_torch.parallel.sharding import Layout  # noqa: E402

MEM1 = 36000000


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _jft(nty, ntx, tx, ty, halo):
    return jdom.FieldTiles(tiles=jnp.zeros(1), x0=jnp.zeros(1),
                           y0=jnp.zeros(1), ntx=ntx, nty=nty, tx=tx, ty=ty,
                           halo=halo)


def _tft(nty, ntx, tx, ty, halo):
    return tdom.FieldTiles(tiles=None, x0=np.zeros(1), y0=np.zeros(1),
                           ntx=ntx, nty=nty, tx=tx, ty=ty, halo=halo)


# (nty, ntx, ny, nx_field, halo): dividing and ceil-sized (uneven) tiles
LAYOUTS = [(2, 2, 18, 36, 3), (2, 4, 36, 72, 4), (3, 2, 19, 37, 2),
           (2, 3, 37, 72, 3), (1, 1, 12, 24, 2)]


@pytest.mark.parametrize("nty,ntx,ny,nxf,halo", LAYOUTS)
@pytest.mark.parametrize("xglobal", [True, False])
def test_decompose_zfields_bitwise(nty, ntx, ny, nxf, halo, xglobal):
    """Every component of every tile, the pole rows clamped and the seam
    wrapped (or clamped on a limited-area grid) as the reference cuts
    them; one tile alone is that tile of the stack."""
    rng_ = np.random.default_rng(nty * 100 + ntx)
    nx = nxf + 1
    z = dict(f3d=rng_.standard_normal((3, 4, ny, nx)).astype(np.float32),
             f2d=rng_.standard_normal((5, ny, nx)).astype(np.float32),
             clouds=rng_.integers(0, 6, (4, ny, nx)).astype(np.int8),
             vdep=rng_.standard_normal((2, ny, nx)).astype(np.float32),
             height=np.arange(4, dtype=np.float32))
    jz = jdom.decompose_zfields(JZFields(**z), nty, ntx, halo, nxf, xglobal)
    tz = tdom.decompose_zfields(interop.zfields_from_numpy(z, "cpu"), nty,
                                ntx, halo, nxf, xglobal)
    for f in ("f3d", "f2d", "clouds", "vdep"):
        np.testing.assert_array_equal(getattr(tz, f).numpy(),
                                      np.asarray(getattr(jz, f)), err_msg=f)
    t = nty * ntx - 1
    one = tdom.decompose_zfields(interop.zfields_from_numpy(z, "cpu"), nty,
                                 ntx, halo, nxf, xglobal, tile=t)
    np.testing.assert_array_equal(one.f3d.numpy(), tz.f3d[t].numpy())
    rows, cols = tdom.tile_indices(ny, nxf, nty, ntx, halo, xglobal)
    jrows, jcols = jdom._tile_indices(ny, nxf, nty, ntx, halo, xglobal)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)


def test_layout_functions_bitwise():
    """decompose, tile_of, local_coords, in_reach and interp_tile on the
    reference's dividing layout (its decompose asserts one)."""
    rng_ = np.random.default_rng(0)
    nf, nz, ny, nxf, halo = 3, 4, 36, 72, 3
    f = rng_.standard_normal((nf, nz, ny, nxf + 1)).astype(np.float32)
    f[..., -1] = f[..., 0]
    jft = jdom.decompose(f, nty=4, nx_field=nxf, ntx=6, halo=halo,
                         xglobal=True)
    tft = tdom.decompose(torch.as_tensor(f), nty=4, nx_field=nxf, ntx=6,
                         halo=halo, xglobal=True)
    np.testing.assert_array_equal(tft.tiles.numpy(), np.asarray(jft.tiles))
    np.testing.assert_array_equal(tft.x0, np.asarray(jft.x0))
    np.testing.assert_array_equal(tft.y0, np.asarray(jft.y0))
    n = 5000
    x = rng_.uniform(0.0, nxf - 1e-3, n).astype(np.float32)
    y = rng_.uniform(0.0, ny - 1.001, n).astype(np.float32)
    jt = np.asarray(jdom.tile_of(jnp.asarray(x), jnp.asarray(y), jft))
    tt = tdom.tile_of(torch.as_tensor(x), torch.as_tensor(y), tft)
    np.testing.assert_array_equal(tt.numpy(), jt)
    # positions displaced by up to the halo, some out of reach
    dx = rng_.uniform(-halo - 1, halo + 1, n).astype(np.float32)
    xd, yd = x + dx, y - dx
    jxl, jyl = jdom.local_coords(jnp.asarray(xd), jnp.asarray(yd),
                                 jnp.asarray(jt), jft)
    txl, tyl = tdom.local_coords(torch.as_tensor(xd), torch.as_tensor(yd),
                                 tt, tft)
    np.testing.assert_array_equal(txl.numpy(), np.asarray(jxl))
    np.testing.assert_array_equal(tyl.numpy(), np.asarray(jyl))
    jr = np.asarray(jdom.in_reach(jxl, jyl, jft))
    np.testing.assert_array_equal(tdom.in_reach(txl, tyl, tft).numpy(), jr)
    assert 0 < jr.sum() < n
    kz = rng_.integers(0, nz, n)
    ji = jdom.interp_tile(jft, jnp.asarray(jt), F3_U, jnp.asarray(x),
                          jnp.asarray(y), jnp.asarray(kz))
    ti = tdom.interp_tile(tft, tt, F3_U, torch.as_tensor(x),
                          torch.as_tensor(y), torch.as_tensor(kz))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("umax,lsync,dx", [(60.0, 900.0, 5.0),
                                           (37.5, 900.0, 10.0),
                                           (120.0, -3600.0, 1.0),
                                           (0.0, 900.0, 0.5)])
def test_halo_for_and_the_wind_it_supports(umax, lsync, dx):
    h = tdom.halo_for(umax, lsync, dx)
    assert h == jdom.halo_for(umax, lsync, dx)
    # the supported wind sizes to the same halo, a faster one to a wider
    limit = tdom.wind_for_halo(h, lsync, dx)
    assert limit >= umax and tdom.halo_for(limit, lsync, dx) <= h
    assert tdom.halo_for(limit * 1.01 + 1e-3, lsync, dx) > h
    tdom.check_halo(limit, h, lsync, dx)
    with pytest.raises(ValueError, match="outgrows the halo"):
        tdom.check_halo(limit * 1.01 + 1e-3, h, lsync, dx)


def _schedule(n, nx, ny, seed):
    """A schedule of ``n`` slots: a hot spot and a spread, some slots
    unschedulable, some released later."""
    rng_ = np.random.default_rng(seed)
    d = {k: np.asarray(v) for k, v in jempty(n)._asdict().items()}
    d["x_hi"] = np.concatenate([rng_.uniform(0, 3, n // 2),
                                rng_.uniform(0, nx, n - n // 2)]) \
        .astype(np.float32)
    d["y_hi"] = rng_.uniform(0, ny - 1, n).astype(np.float32)
    d["itra"] = np.where(rng_.random(n) < 0.1, jdom.ITRA_INACTIVE,
                         rng_.integers(0, 3, n) * 900).astype(np.int32)
    d["itramem"] = d["itra"].copy()
    d["active"] = d["itra"] == 0
    d["npoint"] = np.arange(n, dtype=np.int32)
    d["mass"] = rng_.random((n, 1)).astype(np.float32)
    return d


@pytest.mark.parametrize("nty,ntx,ny,nxf,halo", LAYOUTS)
def test_capacity_and_placement_bitwise(nty, ntx, ny, nxf, halo):
    """plan_tile_capacity, shard_by_tile (live slots) and
    shard_by_tile_scheduled (every schedulable slot) against the
    reference's, ceil tiles included; the origins name each placed slot's
    schedule slot."""
    tx, ty = -(-nxf // ntx), -(-ny // nty)
    d = _schedule(600, nxf, ny, nty + 7 * ntx)
    keep = d["itra"] != jdom.ITRA_INACTIVE
    cap = ttiles.plan_tile_capacity(d["x_hi"][keep], d["y_hi"][keep], ntx,
                                    nty, tx, ty)
    assert cap == jtiles.plan_tile_capacity(d["x_hi"][keep], d["y_hi"][keep],
                                            d["active"][keep], ntx, nty, tx,
                                            ty)
    jft, tft = _jft(nty, ntx, tx, ty, halo), _tft(nty, ntx, tx, ty, halo)
    want = jtiles.shard_by_tile_scheduled(d, jft, cap)
    got, origin = ttiles.shard_by_tile_scheduled(d, tft, cap)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    placed = origin >= 0
    assert placed.sum() == keep.sum()
    np.testing.assert_array_equal(got["npoint"][placed], origin[placed])
    want = jdom.shard_by_tile(d, jft, cap)
    got = tdom.shard_by_tile(d, tft, cap)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    with pytest.raises(ValueError, match="planned capacity"):
        ttiles.shard_by_tile_scheduled(d, tft, 8)


def _empty_tile(n, ny, nxf, mesh):
    nty, ntx = mesh
    ty, tx = -(-ny // nty), -(-nxf // ntx)
    return (nty - 1) * ty >= ny or (ntx - 1) * tx >= nxf


def test_choose_tile_mesh_matches_jax_without_empty_tiles():
    """Equal to the JAX choice wherever that leaves no tile empty; never a
    mesh with an empty tile (ny=10 over 6 ranks: the JAX choice 6 x 1 has
    an empty last row of tiles, the port finds none that has not and
    raises by name)."""
    compared = 0
    for n in range(1, 13):
        for ny, nxf in ((18, 36), (181, 360), (37, 72), (19, 37), (10, 2),
                        (10, 4), (5, 90), (90, 5), (7, 7)):
            try:
                jm = jtiles.choose_tile_mesh(n, ny, nxf)
            except ValueError:
                jm = None
            try:
                tm = ttiles.choose_tile_mesh(n, ny, nxf)
            except ValueError:
                tm = None
            if tm is not None:
                assert not _empty_tile(n, ny, nxf, tm)
            if jm is not None and not _empty_tile(n, ny, nxf, jm):
                assert tm == jm, (n, ny, nxf)
                compared += 1
    assert compared > 60
    assert _empty_tile(6, 10, 2, jtiles.choose_tile_mesh(6, 10, 2))
    with pytest.raises(ValueError, match="a tile empty"):
        ttiles.choose_tile_mesh(6, 10, 2)


def _shards(tiled: dict, world: int, cap: int):
    return [interop.particles_from_numpy(
        {f: a[r * cap:(r + 1) * cap] for f, a in tiled.items()}, "cpu")
        for r in range(world)]


def test_migration_2x2_matches_make_migrate():
    """tests/test_domain_decomp.py::test_ppermute_migration on a 2 x 2
    mesh: particles displaced by up to a tile in each direction, migrated
    by the port's passes in one process and by ``make_migrate`` on 4 JAX
    devices.  Nothing lost, every particle on its owner, its state with it
    (mass by id), each tile the JAX tile's set of ids; the origins travel
    too."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    nty = ntx = 2
    tx, ty, cap = 36, 18, 128
    rng_ = np.random.default_rng(3)
    n = 150
    d = {k: np.asarray(v) for k, v in jempty(nty * ntx * cap)._asdict()
         .items()}
    src = {k: v.copy() for k, v in d.items()}
    src["x_hi"][:n] = rng_.uniform(0, 71.99, n).astype(np.float32)
    src["y_hi"][:n] = rng_.uniform(0, 35.99, n).astype(np.float32)
    src["active"][:n] = True
    src["itra"][:n] = 0
    src["npoint"][:n] = np.arange(1, n + 1)
    src["mass"][:n] = rng_.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    jft = _jft(nty, ntx, tx, ty, 2)
    tiled = jdom.shard_by_tile(src, jft, cap)
    dx = rng_.uniform(-tx, tx, nty * ntx * cap).astype(np.float32)
    dy = rng_.uniform(-ty, ty, nty * ntx * cap).astype(np.float32)
    tiled["x_hi"] = (tiled["x_hi"] + dx * tiled["active"]) % 72.0
    tiled["y_hi"] = np.clip(tiled["y_hi"] + dy * tiled["active"], 0.0,
                            35.99)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(nty, ntx),
                (jdom.AX_TY, jdom.AX_TX))
    sh = NamedSharding(mesh, P((jdom.AX_TY, jdom.AX_TX)))
    pt = JParticles(**{k: jax.device_put(jnp.asarray(v), sh)
                       for k, v in tiled.items()})
    jout, n_bad = jdom.make_migrate(mesh, ntx, nty, tx, ty, msg_cap=cap)(pt)
    assert int(n_bad) == 0
    jout = _np(jout)

    shards = _shards(tiled, nty * ntx, cap)
    origins = [torch.as_tensor(
        np.where(tiled["active"][r * cap:(r + 1) * cap],
                 tiled["npoint"][r * cap:(r + 1) * cap] - 1, -1)
        .astype(np.int64)) for r in range(nty * ntx)]
    layout = tdom.TileLayout(ntx=ntx, nty=nty, tx=tx, ty=ty)
    mig = tdom.migrate_in_process(layout, shards, origins)
    assert mig["deferred"] == 0 and mig["moved"] > 50
    out = {f: np.concatenate([getattr(q, f).numpy() for q in shards])
           for f in FIELDS}
    act = out["active"]
    assert act.sum() == n
    holder = np.nonzero(act)[0] // cap
    xs, ys = out["x_hi"][act], out["y_hi"][act]
    owner = (np.clip((ys // ty).astype(int), 0, nty - 1) * ntx
             + np.clip((xs // tx).astype(int), 0, ntx - 1))
    np.testing.assert_array_equal(holder, owner)
    ids = out["npoint"][act]
    o = np.argsort(ids)
    np.testing.assert_array_equal(out["mass"][act, 0][o],
                                  src["mass"][ids[o] - 1, 0])
    oc = np.concatenate([q.numpy() for q in origins])
    np.testing.assert_array_equal(oc[act], ids - 1)
    assert (oc[~act] == -1).all()
    jact = jout["active"]
    for t in range(nty * ntx):
        mine = set(out["npoint"][t * cap:(t + 1) * cap][
            act[t * cap:(t + 1) * cap]])
        theirs = set(jout["npoint"][t * cap:(t + 1) * cap][
            jact[t * cap:(t + 1) * cap]])
        assert mine == theirs, t


def test_migration_defers_what_a_full_tile_cannot_take():
    """A target with fewer free slots than crossing particles takes what
    fits, the rest stay on the sender (live, in its halo) and are counted;
    the next migration moves them once there is room."""
    nty, ntx, tx, ty, cap = 1, 2, 10, 10, 8
    d = {k: np.array(v) for k, v in jempty(2 * cap)._asdict().items()}
    d["active"][:] = True
    d["itra"][:] = 0
    d["x_hi"][:cap] = 12.5              # all of tile 0's belong to tile 1
    d["x_hi"][cap:cap + 5] = 15.0       # tile 1 has 3 free slots
    d["active"][cap + 5:] = False
    d["itra"][cap + 5:] = tdom.ITRA_INACTIVE
    shards = _shards(d, 2, cap)
    origins = [torch.arange(cap), torch.arange(cap, 2 * cap)]
    origins[1][5:] = -1
    layout = tdom.TileLayout(ntx=ntx, nty=nty, tx=tx, ty=ty)
    mig = tdom.migrate_in_process(layout, shards, origins)
    assert mig["moved"] == 3 and mig["deferred"] == cap - 3
    assert int(shards[0].active.sum()) == cap - 3
    assert int(shards[1].active.sum()) == cap
    # tile 0's first three slots went, in slot order, into tile 1's free
    # slots in slot order
    np.testing.assert_array_equal(origins[1][5:].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(shards[0].active[:3].numpy(), [False] * 3)
    shards[1].active[:5] = False
    shards[1].itra[:5] = tdom.ITRA_INACTIVE
    mig = tdom.migrate_in_process(layout, shards, origins)
    assert mig["moved"] == 5 and mig["deferred"] == 0


def _setup(polar: bool, u: float, v: float, turb: bool = False):
    """tests/test_domain_decomp.py's grids: both packages' configuration,
    the JAX fields and the port's copy of them."""
    if polar:
        grid = make_grid(nx=73, ny=37, nlev=10, dx=5.0, dy=5.0, ylat0=-90.0,
                         xglobal=True)
    else:
        grid = make_grid(nx=73, ny=36, nlev=10, dx=5.0, dy=5.0, ylat0=-87.5,
                         xglobal=True)
    eta = uniform_wind_met(grid, u=u, v=v).fetch(0.0)
    zf = calcpar(grid, eta, process_eta(grid, eta, compute_heights(grid,
                                                                   eta)))
    jcfg = JStepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                       ldirect=1, turbswitch=False, ifine=1, method=0,
                       turboff=not turb, polar=polar, met_bf16=False)
    jprm = JStepParams.make(dx=5.0, dy=5.0, ylat0=grid.ylat0, xlon0=-180.0,
                            dxconst=grid.dxconst, dyconst=grid.dyconst,
                            lsynctime=900, fine=1.0)
    tz = interop.zfields_from_numpy(_np(zf), "cpu")
    return (grid, zf, jcfg, jprm, tz, interop.step_config_from_jax(jcfg),
            interop.step_params_from_numpy(jprm))


def _engines(tcfg, grid, nty, ntx, halo, cap):
    engs = [ttiles.TiledEngine(Layout(nty * ntx, r), tcfg, grid, nty, ntx,
                               halo) for r in range(nty * ntx)]
    for e in engs:
        e.local_cap = cap
    return engs


def _tiled_run(particles: dict, tcfg, tprm, tz, grid, nty, ntx, halo, cap,
               steps, draws_of=None):
    """The port's tiled plain run in one process: placed by
    shard_by_tile_scheduled, ``steps`` steps of step_in_process.  Returns
    (the shards as one numpy dict, the origins, the migrations)."""
    engs = _engines(tcfg, grid, nty, ntx, halo, cap)
    tiled, origin = ttiles.shard_by_tile_scheduled(particles,
                                                   engs[0].field_tiles(), cap)
    shards = _shards(tiled, nty * ntx, cap)
    origins = [torch.as_tensor(origin[r * cap:(r + 1) * cap])
               for r in range(nty * ntx)]
    moved = 0
    for i in range(steps):
        draws = None if draws_of is None else [draws_of(i, o)
                                               for o in origins]
        _, mig = ttiles.step_in_process(engs, shards, origins, tz, tz,
                                        i * 900, 0, MEM1, rng.Key(0, i),
                                        tprm, draws)
        assert mig["deferred"] == 0
        moved += mig["moved"]
    out = {f: np.concatenate([getattr(q, f).numpy() for q in shards])
           for f in FIELDS}
    return out, np.concatenate([o.numpy() for o in origins]), moved


def _by_id(out, origin, n):
    """The placed particles' fields in schedule order (slot o holds origin
    o)."""
    at = np.full(n, -1)
    keep = origin >= 0
    at[origin[keep]] = np.nonzero(keep)[0]
    assert (at >= 0).all()
    return {f: a[at] for f, a in out.items()}


def _jax_tiled(jp, zf, jcfg, jprm, nty, ntx, tx, ty, halo, cap, steps):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.asarray(jax.devices()[:nty * ntx]).reshape(nty, ntx),
                (jdom.AX_TY, jdom.AX_TX))
    sh = NamedSharding(mesh, P((jdom.AX_TY, jdom.AX_TX)))
    zt = jdom.decompose_zfields(zf, nty, ntx, halo, nx_field=72,
                                xglobal=True)
    zt = JZFields(*[jax.device_put(a, sh) if i < 4 else a
                    for i, a in enumerate(zt)])
    tiled = jdom.shard_by_tile(_np(jp), _jft(nty, ntx, tx, ty, halo), cap)
    pt = JParticles(**{k: jax.device_put(jnp.asarray(v), sh)
                       for k, v in tiled.items()})
    step = jdom.make_tiled_advance(mesh, jcfg, ntx, nty, tx, ty, halo,
                                   msg_cap=cap)
    key = jax.random.PRNGKey(4)
    for i in range(steps):
        pt, n_act, n_bad = step(pt, zt, zt, jnp.int32(i * 900), jnp.int32(0),
                                jnp.int32(MEM1), jax.random.fold_in(key, i),
                                jprm)
        assert int(n_bad) == 0
    out = _np(pt)
    act = out["active"]
    o = np.argsort(out["npoint"][act])
    return {f: a[act][o] for f, a in out.items()}


def _particles(x, y, z):
    n = len(x)
    jp = jempty(n)._replace(
        x_hi=jnp.asarray(x), y_hi=jnp.asarray(y), z=jnp.asarray(z),
        itra=jnp.zeros(n, jnp.int32), mass=jnp.ones((n, 1), jnp.float32),
        npoint=jnp.arange(1, n + 1, dtype=jnp.int32),
        active=jnp.ones(n, bool))
    return jp, _np(jp)


def test_tiled_advance_matches_make_tiled_advance():
    """tests/test_domain_decomp.py::test_tiled_advance_matches_global's
    run on the 2 x 4 mesh (turboff, uniform wind, 6 steps, halo 4) in
    both packages: nothing lost, every particle where the reference's
    tiled step puts it (x, y atol 2e-3, z atol 0.5)."""
    grid, zf, jcfg, jprm, tz, tcfg, tprm = _setup(False, 25.0, 5.0)
    rng_ = np.random.default_rng(7)
    n = 200
    x = rng_.uniform(0.0, 71.9, n).astype(np.float32)
    y = rng_.uniform(2.0, 33.9, n).astype(np.float32)
    z = rng_.uniform(100.0, 9000.0, n).astype(np.float32)
    jp, d = _particles(x, y, z)
    jt = _jax_tiled(jp, zf, jcfg, jprm, 2, 4, 18, 18, 4, 128, 6)
    out, origin, moved = _tiled_run(d, tcfg, tprm, tz, grid, 2, 4, 4, 128, 6)
    assert moved > 0
    t = _by_id(out, origin, n)
    assert t["active"].all() and len(jt["z"]) == n
    for f, atol in (("x", 2e-3), ("y", 2e-3)):
        np.testing.assert_allclose(t[f + "_hi"] + t[f + "_lo"],
                                   jt[f + "_hi"] + jt[f + "_lo"], atol=atol)
    np.testing.assert_allclose(t["z"], jt["z"], atol=0.5)


def test_tiled_advance_polar_caps_match_make_tiled_advance():
    """tests/test_domain_decomp.py::test_tiled_advance_polar_caps's run:
    half the particles near the north pole, the caps on.  None lost (the
    x passes route the caps' jumps across tiles); the particles that never
    enter a cap as the reference's tiled step puts them (rtol 5e-7, atol
    1e-5 in x, y; 1e-3 m in z), the cap particles within its cap
    tolerance (y 0.35 cells, z 1 m)."""
    grid, zf, jcfg, jprm, tz, tcfg, tprm = _setup(True, 20.0, 8.0)
    rng_ = np.random.default_rng(11)
    n = 160
    x = rng_.uniform(0.0, 71.9, n).astype(np.float32)
    y = np.concatenate([rng_.uniform(8.0, 26.0, n // 2),
                        rng_.uniform(33.5, 35.6, n - n // 2)]) \
        .astype(np.float32)
    z = rng_.uniform(3000.0, 9000.0, n).astype(np.float32)
    jp, d = _particles(x, y, z)
    jt = _jax_tiled(jp, zf, jcfg, jprm, 2, 4, 18, 19, 4, 256, 6)
    out, origin, moved = _tiled_run(d, tcfg, tprm, tz, grid, 2, 4, 4, 256, 6)
    t = _by_id(out, origin, n)
    assert t["active"].all() and len(jt["z"]) == n
    # which particles ever enter a cap, from the serial port run
    p = interop.particles_from_numpy(d, "cpu")
    zero = {g: torch.zeros((r, n)) for g, r in
            {**tadv.DRAW_ROWS, 2: 1}.items()}
    switch_y = (75.0 - (-90.0)) / 5.0
    ever = np.zeros(n, bool)
    for i in range(6):
        ever |= p.y.numpy() > switch_y
        p, _ = tadv.advance_all(p, tz, tz, i * 900, 0, MEM1, rng.Key(0, i),
                                tcfg, tprm, draws=zero)
    ever |= p.y.numpy() > switch_y
    assert ever.sum() > 20
    tx_, ty_ = t["x_hi"] + t["x_lo"], t["y_hi"] + t["y_lo"]
    jx, jy = jt["x_hi"] + jt["x_lo"], jt["y_hi"] + jt["y_lo"]
    mid = ~ever
    np.testing.assert_allclose(tx_[mid], jx[mid], rtol=5e-7, atol=1e-5)
    np.testing.assert_allclose(ty_[mid], jy[mid], rtol=5e-7, atol=1e-5)
    np.testing.assert_allclose(t["z"][mid], jt["z"][mid], rtol=5e-7,
                               atol=1e-3)
    assert np.isfinite(tx_[ever]).all() and (ty_[ever] <= 36.0 + 1e-3).all()
    np.testing.assert_allclose(ty_[ever], jy[ever], atol=0.35)
    np.testing.assert_allclose(t["z"][ever], jt["z"][ever], atol=1.0)


@pytest.mark.parametrize("mesh,halo", [((2, 2), 4), ((1, 1), 3)])
@pytest.mark.parametrize("polar", [False, True])
def test_tiled_advance_is_the_serial_advance(mesh, halo, polar):
    """The port's tiled plain advance (turbulent, 4 steps, the draws of
    each particle injected by its schedule origin) against the port's
    serial plain advance with the same draws: every particle that the
    steps never wrap at the seam, mirror at a pole, kill or move by the
    caps' update bitwise in every field, migrated or not; the others
    within the reference's tolerances."""
    grid, zf, jcfg, jprm, tz, tcfg, tprm = _setup(polar, 30.0, 6.0, True)
    rng_ = np.random.default_rng(5)
    n = 512
    x = rng_.uniform(0.0, 71.99, n).astype(np.float32)
    y = rng_.uniform(0.5, grid.ny - 1.5, n).astype(np.float32)
    z = rng_.uniform(10.0, 9000.0, n).astype(np.float32)
    _, d = _particles(x, y, z)
    rows = {**tadv.DRAW_ROWS, 2: 1}
    g = torch.Generator().manual_seed(9)
    draws = [{t: torch.randn((r, n), generator=g) for t, r in rows.items()}
             for _ in range(4)]
    # the serial run, and which particles a step wraps, mirrors or caps
    p = interop.particles_from_numpy(d, "cpu")
    lat = lambda yy: grid.ylat0 + yy * grid.dy  # noqa: E731
    special = np.zeros(n, bool)
    for i in range(4):
        x0, y0 = p.x.numpy(), p.y.numpy()
        p, _ = tadv.advance_all(p, tz, tz, i * 900, 0, MEM1, rng.Key(0, i),
                                tcfg, tprm, draws=draws[i])
        x1, y1 = p.x.numpy(), p.y.numpy()
        special |= np.abs(x1 - x0) > 30.0        # wrapped at the seam
        # within a cell of it: the serial step wraps (or clamps within
        # nx / 3e5 of it) at its predictor too
        special |= (np.minimum(x0, x1) < 1.0) | (np.maximum(x0, x1) > 71.0)
        special |= (np.abs(lat(y0)) > 74.0) | (np.abs(lat(y1)) > 74.0)
        special |= ~p.active.numpy()
    serial = interop.particles_to_numpy(p)

    def draws_of(i, o):
        return {t: v[..., o.clamp(min=0)] for t, v in draws[i].items()}
    nty, ntx = mesh
    out, origin, moved = _tiled_run(d, tcfg, tprm, tz, grid, nty, ntx, halo,
                                    n, 4, draws_of)
    t = _by_id(out, origin, n)
    plain = ~special
    assert plain.sum() > n // 2
    for f in FIELDS:
        np.testing.assert_array_equal(t[f][plain], serial[f][plain],
                                      err_msg=f)
    for f in ("x", "y"):
        a = t[f + "_hi"] + t[f + "_lo"]
        b = serial[f + "_hi"] + serial[f + "_lo"]
        diff = np.abs(a - b)
        if f == "x":
            diff = np.minimum(diff, (grid.nx - 1) - diff)
        assert diff[special & serial["active"]].max(initial=0.0) < 0.35
    if mesh == (2, 2):
        assert moved > 0


def test_tiled_cbl_advance_matches_jax():
    """K11 TILE x CBL's twin, the plain adaptive step with the skewed CBL
    on each tile of a 2 x 2 split (``step_in_process``: each tile's step,
    then the migration), against the JAX package's adaptive step with
    ``cblflag``: tests/test_torch_cbl.py's convective met (a strongly
    convective east, -h/L = 60) and boundary-layer particles, one step
    (ifine 4), each particle drawing JAX's draws of its schedule slot.
    ``make_tiled_advance`` itself cannot trace the adaptive step under the
    installed JAX (its loop of passes inside ``shard_map`` is refused: the
    carry's varying axes differ), so the reference here is its tile's
    body, the JAX adaptive step, on the whole grid.  Held to
    tests/test_torch_cbl.py::test_cbl_adaptive_step_matches_jax's
    tolerances on the particles whose next step agrees: x, y within 1e-4
    cells, z within 1e-2 m + 1e-4 z for 99% of them; every particle kept,
    on its owner; the active and NaN-redraw counts equal."""
    import test_torch_cbl as tc
    from flexpart_tpu import met as jmet
    from flexpart_tpu.core import advance as jadv
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (0.0, float(tc.MEM1)):
        eta = m.fetch(t)
        zs.append(tc._convective(jmet.calcpar(grid, eta, jmet.process_eta(
            grid, eta, jmet.compute_heights(grid, eta))), grid.nx // 2))
    tz = [interop.zfields_from_numpy(_np(z), "cpu") for z in zs]
    jcfg, jprm, tcfg, tprm = tc._cfgs(grid, 1, tc.ADAPTIVE_IFINE)
    nty, ntx, halo, cap = 2, 2, 3, tc.N
    rs = np.random.default_rng(21)
    n = tc.N
    jp = tc._particles(grid, seed=21)._replace(
        x_hi=jnp.asarray(rs.uniform(1.0, 34.9, n), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(1.5, 16.5, n), jnp.float32),
        active=jnp.ones(n, bool))
    key = jax.random.PRNGKey(4)
    jq, jd = jadv.advance_all(jp, zs[0], zs[1], jnp.int32(tc.LSYNC),
                              jnp.int32(0), jnp.int32(tc.MEM1), key, jcfg,
                              jprm)
    jt = _np(jq)
    jdraws = tc._jax_draws(key, tc.ADAPTIVE_IFINE, 1)
    d = _np(jp)
    engs = _engines(tcfg, grid, nty, ntx, halo, cap)
    placed, origin = ttiles.shard_by_tile_scheduled(d, engs[0].field_tiles(),
                                                    cap)
    shards = _shards(placed, 4, cap)
    origins = [torch.as_tensor(origin[r * cap:(r + 1) * cap])
               for r in range(4)]
    # each slot draws its particle's draws (an empty slot the first's)
    draws = [{t: v[..., o.clamp(min=0)] for t, v in jdraws.items()}
             for o in origins]
    diags, mig = ttiles.step_in_process(engs, shards, origins, tz[0], tz[1],
                                        tc.LSYNC, 0, tc.MEM1, rng.Key(0, 0),
                                        tprm, draws)
    assert mig["deferred"] == 0
    out = {f: np.concatenate([getattr(q, f).numpy() for q in shards])
           for f in FIELDS}
    t = _by_id(out, np.concatenate([o.numpy() for o in origins]), n)
    assert t["active"].sum() == int(jd.n_active) == n
    assert sum(int(dg.nan_count) for dg in diags) == int(jd.nan_count)
    assert tc._skewed(jp, (grid,)) > 0.3
    same = t["idt"] == jt["idt"]
    assert same.mean() >= 0.98
    for f in ("x", "y"):
        np.testing.assert_allclose((t[f + "_hi"] + t[f + "_lo"])[same],
                                   (jt[f + "_hi"] + jt[f + "_lo"])[same],
                                   rtol=0, atol=1e-4)
    dz = np.abs(t["z"] - jt["z"])[same]
    assert np.mean(dz <= 1e-2 + 1e-4 * np.abs(jt["z"][same])) >= 0.99
    for f in ("x_hi", "y_hi", "z", "wp"):
        assert np.isfinite(t[f]).all(), f


def _refusal_sim(tmp_path, **kw):
    import torch_tiles_ranks as tr
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch import config as tconfig
    cmd_kw = kw.pop("cmd", {})
    grid = make_grid(**tr.GRID)
    cmd, rel, og = tr.tiles_config(tconfig, parts=16, spread=False)
    cmd = dataclasses.replace(cmd, **cmd_kw)
    if "species" in kw:
        rel = tconfig.Releases(species=(kw.pop("species"),),
                               boxes=rel.boxes)
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(tmp_path), distributed="tiles",
                      device="cpu", **kw)


# each option that tiles part 1 refused, as it runs now: (the Command's
# changes, the Simulation's, how the run is held against the serial run)
# in a one-rank gloo group.  "slots": every slot bitwise (world size 1 with
# the serial capacity as the tile's keeps the slots, so the draws); "rows":
# the live particles' rows bitwise (a split's children and the boundary's
# emissions take the tile's free slots in slot order, the serial run's in
# origin order, so other slots)
OPTIONS = {
    "splitting (itsplit)": (dict(itsplit=3600), {}, "rows"),
    "domain filling (mdomainfill)": (dict(mdomainfill=1), {}, "rows"),
    "convection (lconvection=1)": (dict(lconvection=1), {}, "slots"),
    "OH species": ({}, dict(ohreact=True), "slots"),
    "receptors": ({}, dict(receptors="R"), "slots"),
    "gross fluxes (iflux)": (dict(iflux=1), {}, "slots"),
    "the initial condition (linit_cond)": (dict(linit_cond=1, ldirect=-1),
                                           {}, "slots"),
    "the skewed CBL (cblflag)": (dict(cblflag=1, ctl=5.0),
                                 dict(turboff=False), "slots"),
    "a warm start (ipin=1)": (dict(ipin=1), {}, "slots"),
    "checkpoints (checkpoint_at)": ({}, dict(checkpoint_at=3600), "slots"),
}


def _option_run(out, distributed, cmd_kw, kw):
    import torch_tiles_ranks as tr
    from flexpart_tpu_torch import config as tconfig
    kw = dict(kw)
    if kw.get("receptors") == "R":
        kw["receptors"] = (tconfig.Receptor("R", 0.0, 40.0),)
    if "checkpoint_at" in kw:
        kw["checkpoint_path"] = str(out / "checkpoint.npz")
    cap = 16 * 4
    tile = {"tile_local_cap": cap} if distributed else {}
    if cmd_kw.get("mdomainfill"):
        sim = tr.port_domainfill(out, distributed, parts=600, capacity=1024,
                                 **({"tile_local_cap": 1024}
                                    if distributed else {}))
    else:
        sim = tr.port_full(out, distributed, parts=16, hours=2,
                           cmd_kw=cmd_kw, capacity=cap, **tile, **kw)
    sim.run()
    return sim


@pytest.mark.parametrize("name", list(OPTIONS))
def test_tiles_refuses_what_it_does_not_run_by_name(tmp_path, name):
    """Each option that a tiles run refused by name before runs now: two
    hours of the reference's ``_sim_full`` job with it, in a one-rank
    gloo group, against the serial run (turboff but for the CBL; the
    tile's capacity the serial run's).  Held bitwise: every slot where
    world size 1 keeps the slots and so the draws, the live particles'
    rows where the option fills free slots (in the tile's slot order, not
    the serial run's origin order), and the grids, fluxes, receptors,
    initial-condition grids and counts of each option; a fresh origin for
    every child and emitted particle, each once."""
    import torch_tiles_ranks as tr
    cmd_kw, kw, how = OPTIONS[name]
    if name.startswith("a warm start"):
        # the dump of a run before (IPOUT=2) in both output directories
        prev = _option_run(tmp_path / "prev", None, dict(ipout=2), {})
        for d in ("s", "t"):
            (tmp_path / d).mkdir()
            (tmp_path / d / "partposit_end").write_bytes(
                (Path(prev.outdir) / "partposit_end").read_bytes())
    serial = _option_run(tmp_path / "s", None, cmd_kw, kw)
    with tr.group_of_one(tmp_path / "g"):
        tiles = _option_run(tmp_path / "t", "tiles", cmd_kw, kw)
        got, want = tr.summary(tiles), tr.summary(serial)
        if name.startswith("checkpoints"):
            again = tr.port_full(tmp_path / "r", "tiles", parts=16, hours=2,
                                 capacity=64, tile_local_cap=64)
            again.run(start_itime=again.load_checkpoint(
                tmp_path / "t" / "checkpoint.npz"))
            for f in FIELDS:
                assert torch.equal(getattr(again.particles, f),
                                   getattr(tiles.particles, f)), f
    a, b = want["particles"], got["particles"]
    if how == "slots":
        # an empty slot of a tile holds zeros, the serial run's the
        # empty particle's values: the slots in use held
        used = serial.particles.itra.numpy() != ITRA_INACTIVE
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(tiles.particles, f).numpy()[used],
                getattr(serial.particles, f).numpy()[used], err_msg=f)
        np.testing.assert_array_equal(tiles.particles.itra.numpy(),
                                      serial.particles.itra.numpy())
    else:
        np.testing.assert_array_equal(got["ensemble"], want["ensemble"])
        origin = got["origin"]
        assert len(np.unique(origin)) == len(origin)
        # the fresh origins follow the schedule's 64, one per new particle
        # (a later one may take a dead particle's slot and origin)
        first = 1024 if name.startswith("domain") else 64
        fresh = (origin >= first).sum()
        assert 0 < fresh <= got["next_origin"] - first
    assert b["active"].sum() == int(serial.particles.active.sum()) > 0
    for key in ("split_counts", "boundary_counts"):
        assert len(got[key]) == len(want[key])
        for x, y in zip(got[key], want[key]):
            np.testing.assert_array_equal(x, y, err_msg=key)
    if name.startswith("splitting"):
        assert got["split_counts"] and got["split_counts"][0][2] > 0
    if name.startswith("domain"):
        np.testing.assert_array_equal(got["boundary_acc"],
                                      want["boundary_acc"])
        assert sum(int(c[3]) for c in got["boundary_counts"]) > 0
    if name == "receptors":
        np.testing.assert_array_equal(got["creceptor"], want["creceptor"])
    if name.startswith("convection"):
        assert got["convection_moved"] == want["convection_moved"]
    files = sorted(q.name for q in Path(serial.outdir).iterdir()
                   if q.suffix == ".npz" and not q.name.startswith("check"))
    assert files and files == sorted(
        q.name for q in Path(tiles.outdir).iterdir()
        if q.suffix == ".npz" and not q.name.startswith("check"))
    for fname in files:
        da = np.load(Path(serial.outdir) / fname)
        db = np.load(Path(tiles.outdir) / fname)
        for k in da.files:
            np.testing.assert_array_equal(db[k], da[k], err_msg=fname + k)


def test_tiles_refuses_nests_and_backward_deposition_as_the_reference(
        tmp_path):
    from flexpart_tpu_torch import SyntheticMet, make_grid
    nest = make_grid(nx=21, ny=11, nlev=15, dx=2.0, dy=2.0, xlon0=-30.0,
                     ylat0=20.0, xglobal=False)
    with pytest.raises(ValueError, match="nested met"):
        _refusal_sim(tmp_path, met_nests=(SyntheticMet(nest),))
    with pytest.raises(ValueError, match="backward deposition"):
        _refusal_sim(tmp_path, cmd=dict(ldirect=-1, ind_receptor=4))
    with pytest.raises(ValueError, match="legacy_rng"):
        _refusal_sim(tmp_path, legacy_rng=True)


def test_tiles_needs_a_process_group(tmp_path):
    """Without an initialised group the run says how to start one."""
    with pytest.raises(RuntimeError, match="--tiles"):
        _refusal_sim(tmp_path)

"""The tiles engine of ``Simulation(distributed="tiles")``: the met fields
decomposed over the ranks, one tile a rank, and the particles owned by
the tile they are in.

Port of ``flexpart_tpu/parallel/tiles.py``.  Each rank
is a process of its own over dp's ``Group`` (parallel/sharding.py: NCCL on
the cards, gloo on the CPU).  It holds the haloed tile of every processed
wind field (``TiledEngine.decompose``, parallel/domain.py) and the slots of
the particles in its tile, ``local_cap`` of them (``plan_tile_capacity``
from the release schedule, or the caller's), placed by
``shard_by_tile_scheduled``.  Particles keep GLOBAL grid positions
between the phases:

* the advance is K4 ``TILE`` or K11 ``TILE`` on the rank's tile (the
  tile's quad tables by K2 from the tile's fields; draws by the tile
  rank's slot, ``offset = rank * local_cap``, as dp draws), the global
  boundary conditions inside it, then the migration to the owning tiles
  (``domain.migrate_local``);
* the wet scavenging (K9) and the decay and dry deposition (K10) sample
  the tile's fields at the particles' tile-frame positions (``to_local``:
  the global position less the tile's origin, an exact subtraction, so
  the stencil is the global one's bit for bit);
* the sampling (K3) and the deposit scatters (K8) add global positions
  into the rank's own partial grids, summed in rank order at output
  (``sharding.reduce_acc_partials``); the density of ``ind_samp = -1`` is
  gathered from the tile at the tile-frame positions;
* the fluxes (K16) and the initial condition's scan of the particles that
  ended in the advance (K17) read the state after the advance and before
  the migration (between ``TiledEngine.step`` and ``TiledEngine.migrate``),
  in the slots of the state before the step;
* the rebalance of a hot tile (``TiledEngine.regroup``) gathers every
  schedulable slot and places it again at a larger ``local_cap``;
* a regional domain fill's boundary runs on every rank over the whole site
  table, each rank's sites those whose column its tile owns
  (``owned_sites``, the reference's ``partition_boundary`` rule).

Convection (K6 over the whole grid, K7 at global positions), the OH
reaction (K12) and the receptors (K15) run on the whole fields, which every
rank keeps beside its tile, as the reference runs them on its replicated
fields.

Each particle carries its schedule origin through every sort and
migration, so that the end dump and the tests can put a tiles run's
particles in the serial run's order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.advance import StepConfig, Tile, advance_all
from ..core.state import FIELDS, ITRA_INACTIVE, Particles
from ..grid.conccalc import make_conccalc
from ..met.fields import ZFields
from ..physics.massupdate import apply_decay_drydep
from ..physics.wetdepo import wet_deposition
from . import domain


def choose_tile_mesh(n_devices: int, ny: int, nx_field: int) -> tuple:
    """(nty, ntx) with nty * ntx == n_devices: among the factorizations
    whose tiles hold at least 2 x 2 cells and leave no tile empty
    ((nty - 1) * ty < ny and (ntx - 1) * tx < nx_field, ceil-sized tiles),
    the one whose aspect ratio is nearest the grid's, a few pad rows and
    columns weighed in (the reference's score)."""
    best = None
    for nty in range(1, n_devices + 1):
        if n_devices % nty:
            continue
        ntx = n_devices // nty
        ty = -(-ny // nty)
        tx = -(-nx_field // ntx)
        if ty < 2 or tx < 2:
            continue
        if (nty - 1) * ty >= ny or (ntx - 1) * tx >= nx_field:
            continue                 # the last tile would own no cell
        pad = (ty * nty - ny) * nx_field + (tx * ntx - nx_field) * ny
        aspect = abs(np.log(max(ntx, 1) / max(nty, 1))
                     - np.log(nx_field / ny))
        score = aspect + 5.0 * pad / (ny * nx_field)
        if best is None or score < best[0]:
            best = (score, nty, ntx)
    if best is None:
        raise ValueError(
            f"{n_devices} devices cannot tile the {ny}x{nx_field} met grid "
            "(tiles would be under 2 cells, or a tile empty); change the "
            "device count")
    return best[1], best[2]


def plan_tile_capacity(x, y, ntx: int, nty: int, tx: int, ty: int,
                       slack: float = 1.5, floor: int = 64) -> int:
    """Slots a tile holds, from the positions (x, y) of every schedulable
    slot: the fullest tile's count with ``slack`` head-room for the
    migration's churn and ``floor`` more, rounded up to 8."""
    it = np.clip((np.asarray(x) // tx).astype(int), 0, ntx - 1)
    jt = np.clip((np.asarray(y) // ty).astype(int), 0, nty - 1)
    occ = np.bincount(jt * ntx + it, minlength=ntx * nty)
    need = int(np.ceil(occ.max() * slack)) + floor
    return -(-need // 8) * 8


def shard_by_tile_scheduled(p_np: dict, ft, local_cap: int) -> tuple:
    """Host side: EVERY schedulable slot (live now or released later; itra
    not ITRA_INACTIVE) grouped by the tile that owns its position, in a
    (ntiles * local_cap,) tile-major layout, each tile's in slot order.
    Returns (the arrays by field, each slot's schedule origin, -1 for an
    empty slot).  Raises where a tile cannot hold its slots."""
    from ..core.state import ITRA_INACTIVE
    keep = np.asarray(p_np["itra"]) != ITRA_INACTIVE
    return domain._group_by_tile(
        p_np, np.asarray(p_np["x_hi"]), np.asarray(p_np["y_hi"]), keep, ft,
        local_cap, ("itra", "itrasplit"),
        "planned capacity (raise tile_local_cap: a release hot spot)")


def regroup_rows(whole: dict, origin: np.ndarray, riders, ft,
                 new_cap: int) -> tuple:
    """Host side of a regroup: the schedulable slots (itra not
    ITRA_INACTIVE) of every tile laid end to end (``whole``, numpy by
    field; ``origin`` their origins, ``riders`` per-slot arrays) put in
    origin order and placed again by the tile that owns their position
    now (x_hi + x_lo, as the migration sees it) at ``new_cap`` slots a
    tile, tile-major (``shard_by_tile_scheduled``'s rule).  Returns (the
    arrays by field, the slots' origins, -1 for an empty one, the riders,
    0 in an empty slot); raises where a tile cannot hold its slots."""
    at = np.nonzero(np.asarray(whole["itra"]) != ITRA_INACTIVE)[0]
    at = at[np.argsort(origin[at], kind="stable")]
    if (origin[at] < 0).any():
        raise RuntimeError("regroup: a schedulable slot without an origin")
    sel = {f: np.asarray(a)[at] for f, a in whole.items()}
    x = torch.as_tensor(sel["x_hi"]) + torch.as_tensor(sel["x_lo"])
    y = torch.as_tensor(sel["y_hi"]) + torch.as_tensor(sel["y_lo"])
    tiled, src = domain._group_by_tile(
        sel, x.numpy(), y.numpy(), np.ones(at.size, bool), ft, new_cap,
        ("itra", "itrasplit"), "regrouped capacity")
    placed = src >= 0
    pick = at[np.maximum(src, 0)]
    new_origin = np.where(placed, origin[pick], -1)
    moved = [np.where(placed, np.asarray(r)[pick], 0).astype(
        np.asarray(r).dtype) for r in riders]
    return tiled, new_origin, moved


def to_local(p: Particles, tile: Tile) -> Particles:
    """A copy of ``p`` with tile-frame positions: (x_hi + x_lo) - ox with a
    zero low part, y likewise (an exact subtraction of an integer below
    2**24, so a gather's corner and weights are the global position's)."""
    zero = torch.zeros_like(p.x_lo)
    return p.replace(x_hi=(p.x_hi + p.x_lo) - float(tile.ox), x_lo=zero,
                     y_hi=(p.y_hi + p.y_lo) - float(tile.oy),
                     y_lo=zero.clone())


def _global_positions(q: Particles, p: Particles) -> Particles:
    return q.replace(x_hi=p.x_hi, x_lo=p.x_lo, y_hi=p.y_hi, y_lo=p.y_lo)


def tiled_wet_deposition(p: Particles, zt: ZFields, tile: Tile, *args,
                         **kw):
    """K9 (``wet_deposition``) on the tile's fields at the tile-frame
    positions; returns (particles with their global positions, deposit)."""
    q, dep = wet_deposition(to_local(p, tile), zt, *args, **kw)
    return _global_positions(q, p), dep


def tiled_decay_drydep(p: Particles, vdep_tile, tile: Tile, *args, **kw):
    """K10 (``apply_decay_drydep``) with the tile's deposition-velocity
    field at the tile-frame positions; returns (particles with their
    global positions, deposit)."""
    q, dep = apply_decay_drydep(to_local(p, tile), vdep_tile, *args, **kw)
    return _global_positions(q, p), dep


def make_tiled_conccalc(outheights, tile: Tile, nest: bool = False):
    """K3 into this rank's partial grid at the global positions; the
    ``ind_samp = -1`` density gathered from the tile's fields at the
    tile-frame positions."""
    run = make_conccalc(outheights, nest=nest)

    def tiled(acc, p, zt, itime, lage, weight, cfg):
        return run(acc, p, zt, itime, lage, weight, cfg,
                   rho_at=to_local(p, tile) if cfg.ind_samp == -1 else None)
    return tiled


def end_exits(p: Particles, q: Particles) -> Particles:
    """``q`` (a tile's step of ``p``) with the particles that left the
    domain in it gone for good, as in the reference's tiled step
    (flexpart_tpu/parallel/domain.py:430-437): their schedule time
    cleared, so that no release wakes them again and their slots are
    free.  (A serial run keeps the time, and the next step's release
    wakes such a particle outside the domain, to end again.)"""
    gone = p.active & ~q.active
    return q.replace(itra=torch.where(
        gone, torch.full_like(q.itra, ITRA_INACTIVE), q.itra))


def step_in_process(engines: list, shards: list, origins: list, z0: ZFields,
                    z1: ZFields, itime: int, mt0: int, mt1: int, key, prm,
                    draws: list | None = None) -> tuple:
    """Every rank's step of a tiles run in one process, in place on
    ``shards`` and ``origins``: each tile's advance on its tile of the
    whole fields ``z0``, ``z1`` (``engines[r]``: rank r's TiledEngine over
    a ``sharding.Layout``), then ``domain.migrate_in_process``.
    ``draws``: per rank its injected draws (the plain version).  Returns
    (each rank's StepDiag before the migration, the migration's
    counts)."""
    diags = []
    for r, eng in enumerate(engines):
        q, d = advance_all(shards[r], eng.decompose(z0), eng.decompose(z1),
                           itime, mt0, mt1, key, eng.cfg, prm,
                           draws=None if draws is None else draws[r],
                           offset=eng.index * eng.local_cap, tile=eng.tile)
        shards[r] = end_exits(shards[r], q)
        diags.append(d)
    mig = domain.migrate_in_process(engines[0].layout, shards, origins)
    return diags, mig


class TiledEngine:
    """What a rank of a tiles run needs: its tile of the layout, the
    decomposition of each wind field, the initial placement, the advance
    with the migration after it."""

    def __init__(self, group, cfg: StepConfig, grid, nty: int, ntx: int,
                 halo: int):
        if nty * ntx != group.world:
            raise ValueError(f"a {nty} x {ntx} tile mesh on {group.world} "
                             "ranks")
        self.group = group
        self.nty, self.ntx = nty, ntx
        self.halo = halo
        self.nx_field = grid.nxfield
        self.xglobal = grid.xglobal
        # ceil tile sizes: a grid that does not divide gets pad rows and
        # columns (clamped at the pole, wrapped at the seam) that no
        # particle reaches
        self.tx = -(-self.nx_field // ntx)
        self.ty = -(-grid.ny // nty)
        self.index = group.rank                  # this rank's tile
        jt, it = divmod(self.index, ntx)
        self.tile = Tile(ox=it * self.tx - halo, oy=jt * self.ty - halo,
                         nx=self.tx + 2 * halo, ny=self.ty + 2 * halo)
        self.cfg = dataclasses.replace(cfg, tile_mode=True)
        self.cfg.check()
        # with the polar caps a particle may jump across many tiles in x
        # (and y) in one step: enough ring passes to reach any tile
        self.layout = domain.TileLayout(
            ntx=ntx, nty=nty, tx=self.tx, ty=self.ty,
            rounds_x=ntx // 2 if cfg.polar else 1,
            rounds_y=max(nty // 2, 1) if cfg.polar else 1)
        self.local_cap: int | None = None
        self.stats = {"migrations": 0, "sent": 0, "deferred": 0,
                      "regroups": 0}

    def field_tiles(self) -> domain.FieldTiles:
        """The layout as a FieldTiles without fields."""
        return domain.FieldTiles(
            tiles=None, x0=np.zeros(1, np.int32), y0=np.zeros(1, np.int32),
            ntx=self.ntx, nty=self.nty, tx=self.tx, ty=self.ty,
            halo=self.halo)

    def decompose(self, zf: ZFields) -> ZFields:
        """This rank's tile of one processed field stack (the
        mpif_gf_send_vars analog: once per wind read, no per-step
        broadcast)."""
        return domain.decompose_zfields(zf, self.nty, self.ntx, self.halo,
                                        self.nx_field, self.xglobal,
                                        tile=self.index)

    def shard_initial(self, sched: dict, local_cap: int | None = None):
        """This rank's slots of the release schedule (numpy by field):
        every schedulable slot grouped by the tile that owns its release
        position at ``local_cap`` slots a tile (planned from the schedule
        when None).  Returns (the rank's arrays, their schedule origins,
        -1 for an empty slot)."""
        from ..core.state import ITRA_INACTIVE
        if local_cap is None:
            keep = np.asarray(sched["itra"]) != ITRA_INACTIVE
            local_cap = plan_tile_capacity(
                np.asarray(sched["x_hi"])[keep],
                np.asarray(sched["y_hi"])[keep], self.ntx, self.nty, self.tx,
                self.ty)
        self.local_cap = local_cap
        tiled, origin = shard_by_tile_scheduled(sched, self.field_tiles(),
                                                local_cap)
        lo = self.index * local_cap
        return ({f: a[lo:lo + local_cap] for f, a in tiled.items()},
                origin[lo:lo + local_cap])

    def step(self, p: Particles, z0t: ZFields, z1t: ZFields, itime: int,
             mt0: int, mt1: int, key, prm, draws: dict | None = None):
        """The rank's step before the migration: K4 or K11 ``TILE`` on its
        tile (draws by the tile rank's slot), the boundary conditions
        inside, the particles that left the domain ended (``end_exits``).
        Returns (the advanced particles in the slots of ``p``: the
        reference's ``return_pre``; the rank's StepDiag)."""
        q, diag = advance_all(p, z0t, z1t, itime, mt0, mt1, key, self.cfg,
                              prm, draws=draws,
                              offset=self.index * self.local_cap,
                              tile=self.tile)
        return end_exits(p, q), diag

    def migrate(self, q: Particles, diag, origin: torch.Tensor, riders=()):
        """The migration after ``step``, in place on ``q`` and on
        ``origin``; ``riders``: per-slot tensors that move with their
        particles, in place.  Returns (particles, the group's StepDiag
        after the migration: its t_below in the particles' new slots, its
        passes in the old ones; the group's deferred particles)."""
        # the adaptive step's time below 2 HREF goes with its particle to
        # the dry deposition after the migration
        riders = ((() if diag.t_below is None else (diag.t_below,))
                  + tuple(riders))
        mig = domain.migrate_local(self.group, self.layout, q, origin,
                                   riders)
        self.stats["migrations"] += 1
        self.stats["sent"] += mig["sent"]
        self.stats["deferred"] += mig["deferred"]
        dev = q.device
        counts = torch.stack([
            q.active.sum(dtype=torch.int64), diag.n_exited.to(torch.int64),
            torch.as_tensor(diag.nan_count, device=dev).to(torch.int64)
            .reshape(())])
        tot = self.group.sum(counts, "diag")
        return q, dataclasses.replace(diag, n_active=tot[0],
                                      n_exited=tot[1],
                                      nan_count=tot[2]), mig["deferred"]

    def regroup(self, p: Particles, origin: torch.Tensor, new_cap: int,
                riders=()):
        """The rebalance of a hot tile (the reference's ``regroup``,
        mpif_calculate_part_redist, mpi_mod.f90:566-658): every slot of the
        group with its origin and ``riders`` (per-slot tensors) gathered
        onto every rank and placed again by ``regroup_rows`` at ``new_cap``
        slots a tile; this rank takes its block, and ``local_cap`` (so the
        draws' offset) becomes ``new_cap``.  Returns (particles, origins,
        riders) of the rank."""
        g, dev = self.group, p.device
        whole = {f: g.cat_rows(getattr(p, f), "regroup").cpu().numpy()
                 for f in FIELDS}
        o = g.cat_rows(origin, "regroup").cpu().numpy()
        rd = [g.cat_rows(r, "regroup").cpu().numpy() for r in riders]
        tiled, new_origin, moved = regroup_rows(whole, o, rd,
                                                self.field_tiles(), new_cap)
        lo = self.index * new_cap
        q = Particles(**{f: torch.as_tensor(a[lo:lo + new_cap], device=dev)
                         for f, a in tiled.items()})
        self.local_cap = new_cap
        self.stats["regroups"] += 1
        return (q, torch.as_tensor(new_origin[lo:lo + new_cap], device=dev),
                [torch.as_tensor(r[lo:lo + new_cap], device=dev)
                 for r in moved])

    def owned_sites(self, col_flat: torch.Tensor, nx: int) -> torch.Tensor:
        """The regional boundary's sites whose column this rank's tile
        owns (the reference's ``partition_boundary``, tiles.py:392-441):
        ``col_flat`` the sites' flat columns of the (ny, nx) met grid."""
        jy = torch.div(col_flat, nx, rounding_mode="floor")
        ix = col_flat - jy * nx
        it = torch.clamp(torch.div(ix, self.tx, rounding_mode="floor"), 0,
                         self.ntx - 1)
        jt = torch.clamp(torch.div(jy, self.ty, rounding_mode="floor"), 0,
                         self.nty - 1)
        return (jt * self.ntx + it) == self.index

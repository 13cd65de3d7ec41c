"""Domain decomposition of the met fields, and the particles' migration
between tiles, over ``torch.distributed``.

Port of ``flexpart_tpu/parallel/domain.py``.  A tiles run splits the
(NF3, nz, ny, nx) field stack into lat/lon tiles, one a rank, each with a
halo ring sized by the largest displacement of a step (CFL) plus the
interpolation stencil; a rank holds its tile and the particles inside it.
The tiles are cut once per wind read from the processed fields (pole rows
clamped, seam columns wrapped): a gather of this rank's rows and columns
(``decompose_zfields``).  The particles keep GLOBAL grid positions; a
tile's advance moves only the corner of each gather into the tile's tables
(core/advance.py's tile mode).

After a step the particles that left their tile's owned cells move to
the owning neighbour (``migrate_local``): ring passes in x (cyclic), then
in y, each pass in two phases over the group.  First every rank's counts,
(crossing particles, free slots), by one ``all_gather``: the receiver
grants what fits in its free slots, which leave out its own outgoing
particles (still live when it counts), so two full tiles that swap
particles defer them rather than lose them.  Then the granted particles'
rows (every field, packed as ``sharding.pack_rows`` packs a split's
children, and the particle's schedule origin) by one ``all_to_all``; the
receiver writes them into its free slots in slot order, arrivals in
(pass, sender, slot) order, and the sender frees their slots.  A denied
particle stays on its sender, in the halo, and tries again next step; the
group's deferred count is known on every rank from the gathered counts.
Every crossing particle is sent unless its target is full: there is no
message buffer of fixed size (the reference's ``msg_cap``).

The same functions run the passes of several tiles in one process
(``migrate_in_process``), which is how the card holds them.

Everything here but the migration is plain torch or numpy, run once per
wind read (the layout) or at set-up (the placement).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.state import ITRA_INACTIVE, Particles
from ..met.fields import ZFields
from .sharding import pack_rows, unpack_rows


@dataclasses.dataclass
class FieldTiles:
    """Haloed lat/lon tiles of one field stack.

    ``tiles[t]`` covers grid columns [x0[t]-halo, x0[t]+tx+halo) and rows
    [y0[t]-halo, y0[t]+ty+halo), x wrapped cyclically (global grids) and y
    clamped at the poles; ``tiles`` may be None where only the layout is
    wanted."""
    tiles: torch.Tensor | None   # (ntiles, NF3, nz, ty+2h, tx+2h)
    x0: np.ndarray               # (ntiles,) owned-region origin column
    y0: np.ndarray               # (ntiles,) owned-region origin row
    ntx: int
    nty: int
    tx: int
    ty: int
    halo: int

    @property
    def ntiles(self) -> int:
        return self.ntx * self.nty


def _m_per_deg(ylat_max: float) -> float:
    return 111198.5 * max(np.cos(np.deg2rad(ylat_max)), 1e-2)


def halo_for(umax: float, lsynctime: float, dx_deg: float,
             ylat_max: float = 85.0) -> int:
    """Halo width in grid cells from the CFL bound: the largest zonal
    displacement of a step at the highest resolved latitude plus one cell
    for the bilinear stencil and one for the Petterssen predictor point."""
    cells = umax * abs(lsynctime) / (dx_deg * _m_per_deg(ylat_max))
    return int(np.ceil(cells)) + 2


def wind_for_halo(halo: int, lsynctime: float, dx_deg: float,
                  ylat_max: float = 85.0) -> float:
    """The largest wind [m/s] that ``halo_for`` sizes to at most ``halo``
    cells: what a tiles run's halo supports."""
    return (halo - 2) * dx_deg * _m_per_deg(ylat_max) / abs(lsynctime)


def check_halo(umax: float, halo: int, lsynctime: float,
               dx_deg: float) -> None:
    """Raise where a wind field's largest |u| or |v| [m/s] outgrows what
    the halo supports (``wind_for_halo``): a particle could then leave its
    tile's halo within a step."""
    limit = wind_for_halo(halo, lsynctime, dx_deg)
    if umax > limit:
        raise ValueError(
            f"distributed='tiles': a wind field of {umax:.1f} m/s outgrows "
            f"the halo of {halo} cells, sized from the first field; it "
            f"supports {limit:.1f} m/s")


def tile_indices(ny: int, nx_field: int, nty: int, ntx: int, halo: int,
                 xglobal: bool) -> tuple:
    """Row and column gather maps of every tile: rows (nty, ty+2h) clamped
    at the poles, cols (ntx, tx+2h) wrapped at the seam.  Ceil-sized
    tiles: where the grid does not divide, the last tiles' pad rows and
    columns clamp at the pole or wrap at the seam (duplicated values in
    cells no particle visits)."""
    ty = -(-ny // nty)
    tx = -(-nx_field // ntx)
    rows = np.stack([np.clip(np.arange(j * ty - halo, j * ty + ty + halo),
                             0, ny - 1) for j in range(nty)])
    cols = []
    for i in range(ntx):
        c = np.arange(i * tx - halo, i * tx + tx + halo)
        cols.append(c % nx_field if xglobal
                    else np.clip(c, 0, nx_field - 1))
    return rows, np.stack(cols)


def _tile(a: torch.Tensor, rows, cols) -> torch.Tensor:
    """A tile of ``a`` (..., ny, nx): its (rows, cols) gathered."""
    r = torch.as_tensor(rows, dtype=torch.long, device=a.device)
    c = torch.as_tensor(cols, dtype=torch.long, device=a.device)
    return a[..., r[:, None], c[None, :]].contiguous()


def decompose(f3d, nty: int, nx_field: int, ntx: int, halo: int,
              xglobal: bool) -> FieldTiles:
    """Tile a (NF3, nz, ny, nx) stack; ``nx_field`` excludes the cyclic
    duplicate column (grid.nxfield).  Ceil-sized tiles (``tile_indices``):
    where the grid divides, the reference's ``decompose``."""
    f = torch.as_tensor(f3d)
    ny = f.shape[-2]
    rows, cols = tile_indices(ny, nx_field, nty, ntx, halo, xglobal)
    ty, tx = rows.shape[1] - 2 * halo, cols.shape[1] - 2 * halo
    tiles = torch.stack([_tile(f, rows[jt], cols[it])
                         for jt in range(nty) for it in range(ntx)])
    t = np.arange(nty * ntx)
    return FieldTiles(tiles=tiles, x0=((t % ntx) * tx).astype(np.int32),
                      y0=((t // ntx) * ty).astype(np.int32), ntx=ntx,
                      nty=nty, tx=tx, ty=ty, halo=halo)


def tile_of(x, y, ft: FieldTiles) -> torch.Tensor:
    """The owning tile of grid positions (x, y)."""
    it = torch.clamp(torch.div(x, ft.tx, rounding_mode="floor")
                     .to(torch.int32), 0, ft.ntx - 1)
    jt = torch.clamp(torch.div(y, ft.ty, rounding_mode="floor")
                     .to(torch.int32), 0, ft.nty - 1)
    return jt * ft.ntx + it


def local_coords(x, y, tile_id, ft: FieldTiles) -> tuple:
    """Grid (x, y) -> the tile's haloed local coordinates."""
    t = torch.as_tensor(tile_id).long()
    x0 = torch.as_tensor(ft.x0, device=t.device)[t]
    y0 = torch.as_tensor(ft.y0, device=t.device)[t]
    return x - x0 + ft.halo, y - y0 + ft.halo


def in_reach(xl, yl, ft: FieldTiles) -> torch.Tensor:
    """Whether a tile-local position can still be interpolated from this
    tile (inside the halo, with one cell of stencil room)."""
    return ((xl >= 0) & (xl <= ft.tx + 2 * ft.halo - 2)
            & (yl >= 0) & (yl <= ft.ty + 2 * ft.halo - 2))


def interp_tile(ft: FieldTiles, tile_id, field_idx: int, x, y, kz):
    """Bilinear interpolation of one field level from each particle's
    owning tile at tile-local coordinates (a test helper: the advance
    gathers through the tile's quad tables)."""
    xl, yl = local_coords(x, y, tile_id, ft)
    txh = ft.tx + 2 * ft.halo
    tyh = ft.ty + 2 * ft.halo
    ix = torch.clamp(torch.floor(xl).to(torch.int32), 0, txh - 2).long()
    jy = torch.clamp(torch.floor(yl).to(torch.int32), 0, tyh - 2).long()
    ddx = torch.clamp(xl - ix, 0.0, 1.0)
    ddy = torch.clamp(yl - jy, 0.0, 1.0)
    t = torch.as_tensor(tile_id).long()
    f = ft.tiles[t, field_idx, torch.as_tensor(kz).long()]   # (N, tyh, txh)
    n = torch.arange(x.shape[0])
    v00 = f[n, jy, ix]
    v10 = f[n, jy, ix + 1]
    v01 = f[n, jy + 1, ix]
    v11 = f[n, jy + 1, ix + 1]
    return ((1 - ddx) * (1 - ddy) * v00 + ddx * (1 - ddy) * v10
            + (1 - ddx) * ddy * v01 + ddx * ddy * v11)


def decompose_zfields(zf: ZFields, nty: int, ntx: int, halo: int,
                      nx_field: int, xglobal: bool,
                      tile: int | None = None) -> ZFields:
    """Tile every component of a ZFields stack (``height`` is
    column-independent and stays whole): every tile's, each component with
    a leading (nty*ntx) tile axis, or with ``tile`` that tile's alone (a
    rank's, on the fields' device)."""
    rows, cols = tile_indices(zf.f3d.shape[-2], nx_field, nty, ntx, halo,
                              xglobal)
    ts = range(nty * ntx) if tile is None else (tile,)

    def cut(a):
        if a is None:
            return None
        out = [_tile(a, rows[t // ntx], cols[t % ntx]) for t in ts]
        return out[0] if tile is not None else torch.stack(out)

    return ZFields(f3d=cut(zf.f3d), f2d=cut(zf.f2d), clouds=cut(zf.clouds),
                   vdep=cut(zf.vdep), height=zf.height)


def shard_by_tile(p_np: dict, ft: FieldTiles, local_cap: int) -> dict:
    """Host side: the ACTIVE particles of a global population grouped by
    owning tile into a (ntiles * local_cap,) tile-major layout, each tile's
    in slot order (the other slots inactive)."""
    x = np.asarray(p_np["x_hi"])
    y = np.asarray(p_np["y_hi"])
    keep = np.asarray(p_np["active"]).astype(bool)
    return _group_by_tile(p_np, x, y, keep, ft, local_cap,
                          ("itra",), "local capacity")[0]


def _group_by_tile(p_np: dict, x, y, keep, ft, local_cap: int,
                   inactive_fields: tuple, what: str) -> tuple:
    """The rows of ``keep`` grouped by the tile that owns (x, y), tile-major,
    each tile's in slot order; the other slots zero but for
    ``inactive_fields`` (ITRA_INACTIVE).  Returns (the arrays by field,
    the slot each row came from, -1 for an empty slot)."""
    it = np.clip((x // ft.tx).astype(np.int64), 0, ft.ntx - 1)
    jt = np.clip((y // ft.ty).astype(np.int64), 0, ft.nty - 1)
    tid = jt * ft.ntx + it
    src = np.nonzero(keep)[0]
    src = src[np.argsort(tid[src], kind="stable")]
    t = tid[src]
    fill = np.bincount(t, minlength=ft.ntiles)
    if fill.size and fill.max() > local_cap:
        bad = int(np.argmax(fill))
        raise ValueError(f"tile {bad} over {what} {local_cap}: "
                         f"{int(fill[bad])} particles")
    first = np.concatenate([[0], np.cumsum(fill)[:-1]])
    dst = t * local_cap + (np.arange(src.size) - first[t])
    n = ft.ntiles * local_cap
    out = {}
    for name, arr in p_np.items():
        arr = np.asarray(arr)
        buf = np.zeros((n,) + arr.shape[1:], arr.dtype)
        if name in inactive_fields:
            buf[:] = ITRA_INACTIVE
        buf[dst] = arr[src]
        out[name] = buf
    origin = np.full(n, -1, np.int64)
    origin[dst] = src
    return out, origin


# ------------------------------------------------------------ migration --

@dataclasses.dataclass(frozen=True)
class TileLayout:
    """The tiles of a run: ``ntx`` x ``nty`` tiles of ``tx`` x ``ty`` owned
    cells (rank ``jt * ntx + it`` owns tile (jt, it)) and the migration's
    ring passes: ``rounds_x`` in x (cyclic), ``rounds_y`` in y."""
    ntx: int
    nty: int
    tx: int
    ty: int
    rounds_x: int = 1
    rounds_y: int = 1

    @property
    def world(self) -> int:
        return self.ntx * self.nty

    def passes(self) -> list:
        """(axis, sign) of each pass in order: x first, then y."""
        out = []
        if self.ntx > 1:
            out += [("x", s) for _ in range(max(self.rounds_x, 1))
                    for s in (1, -1)]
        if self.nty > 1:
            out += [("y", s) for _ in range(max(self.rounds_y, 1))
                    for s in (1, -1)]
        return out

    def target(self, rank: int, axis: str, sign: int) -> int:
        """The rank that ``rank`` sends to in a pass, or -1 (no neighbour
        beyond a pole)."""
        jt, it = divmod(rank, self.ntx)
        if axis == "x":
            return jt * self.ntx + (it + sign) % self.ntx
        jt = jt + sign
        return jt * self.ntx + it if 0 <= jt < self.nty else -1


def free_slots(p: Particles) -> torch.Tensor:
    """Slots that take an arrival: inactive and not a future release."""
    return (~p.active) & ((p.itra == ITRA_INACTIVE)
                          | (p.itra != p.itramem))


def _hop(p: Particles, layout: TileLayout, rank: int, axis: str):
    """Each particle's next hop (-1, 0, +1) along ``axis`` from this
    rank's tile towards its owner: in x the shortest way round the ring,
    in y straight (the pole conditions keep y inside the grid)."""
    jt, it = divmod(rank, layout.ntx)
    if axis == "x":
        n = layout.ntx
        dest = torch.clamp(torch.div(p.x, layout.tx, rounding_mode="floor")
                           .to(torch.int32), 0, n - 1)
        off = ((dest - it + n // 2 + n) % n) - n // 2
    else:
        dest = torch.clamp(torch.div(p.y, layout.ty, rounding_mode="floor")
                           .to(torch.int32), 0, layout.nty - 1)
        off = dest - jt
    return torch.where(p.active, torch.clamp(off, -1, 1),
                       torch.zeros_like(off))


def pass_counts(p: Particles, layout: TileLayout, rank: int, axis: str,
                sign: int) -> tuple:
    """(the particles that cross in this pass, (crossing, free) as an
    int64 tensor on the particles' device): what a rank tells the group."""
    send = p.active & (_hop(p, layout, rank, axis) == sign)
    return send, torch.stack([send.sum(), free_slots(p).sum()]).to(
        torch.int64)


def grants(counts, layout: TileLayout, axis: str, sign: int) -> tuple:
    """From every rank's (crossing, free), (world, 2): the particles each
    rank may send (its target's free slots are the limit) and each rank's
    target (-1: none)."""
    counts = np.asarray(counts, np.int64)
    target = np.array([layout.target(r, axis, sign)
                       for r in range(layout.world)])
    granted = np.zeros(layout.world, np.int64)
    for s, t in enumerate(target):
        if t >= 0:
            granted[s] = min(counts[s, 0], counts[t, 1])
    return granted, target


def pack(p: Particles, origin: torch.Tensor, slots: torch.Tensor,
         riders=()):
    """The rows of ``slots``: every field as int32 words
    (``sharding.pack_rows``), each of ``riders`` (per-slot float32 or int32
    tensors that travel with their particles) as one more, and the schedule
    origin as two more."""
    o = origin[slots].contiguous().view(torch.int32).reshape(-1, 2)
    extra = [r[slots].contiguous().view(torch.int32).reshape(-1, 1)
             for r in riders]
    return torch.cat([pack_rows(p, slots), *extra, o], dim=1)


def deactivate(p: Particles, origin: torch.Tensor,
               slots: torch.Tensor) -> None:
    """Free the slots of particles that left, in place."""
    p.active[slots] = False
    p.itra[slots] = ITRA_INACTIVE
    origin[slots] = -1


def merge(p: Particles, origin: torch.Tensor, rows: torch.Tensor,
          riders=()) -> None:
    """Write arrived rows (``pack``) into the first free slots in slot
    order, in place."""
    if rows.shape[0] == 0:
        return
    slots = torch.nonzero(free_slots(p)).flatten()[:rows.shape[0]]
    if slots.shape[0] < rows.shape[0]:
        raise RuntimeError(f"{rows.shape[0]} arrivals, {slots.shape[0]} "
                           "free slots: a grant outran the counts")
    k = len(riders)
    unpack_rows(p, slots, rows[:, :-2 - k])
    for j, r in enumerate(riders):
        col = rows[:, rows.shape[1] - 2 - k + j].contiguous()
        r.index_copy_(0, slots, col.view(r.dtype))
    origin.index_copy_(0, slots, rows[:, -2:].contiguous().view(torch.int64)
                       .flatten())


def migrate_local(group, layout: TileLayout, p: Particles,
                  origin: torch.Tensor, riders=()) -> dict:
    """One migration of THIS rank's particles (in place, with their
    origins and ``riders``) over the group: every pass of ``layout``, each
    an ``all_gather`` of the counts and, where a particle is granted, an
    ``all_to_all`` of the rows.  Returns the group's particles deferred
    (denied, summed over the passes; the same on every rank) and this
    rank's rows sent."""
    deferred = sent = 0
    for axis, sign in layout.passes():
        send, mine = pass_counts(p, layout, group.rank, axis, sign)
        counts = torch.stack(group.all_gather(mine, "migrate_counts")) \
            .cpu().numpy()
        granted, target = grants(counts, layout, axis, sign)
        deferred += int((counts[:, 0] - granted).sum())
        if granted.sum() == 0:
            continue
        mine_n = int(granted[group.rank])
        slots = torch.nonzero(send).flatten()[:mine_n]
        to = [0] * layout.world
        if mine_n:
            to[int(target[group.rank])] = mine_n
        frm = [int(granted[s]) if target[s] == group.rank else 0
               for s in range(layout.world)]
        rows = group.all_to_all(pack(p, origin, slots, riders), to, frm,
                                "migrate")
        merge(p, origin, rows, riders)
        deactivate(p, origin, slots)
        sent += mine_n
    return dict(deferred=deferred, sent=sent)


def migrate_in_process(layout: TileLayout, shards: list, origins: list,
                       riders=None) -> dict:
    """``migrate_local`` of every rank's shard in one process, in place:
    the same passes and functions, the counts and rows handed over as the
    group's collectives would (rows in sender order).  Returns the
    deferred count, the rows moved and their bytes.  ``riders``: per shard a
    tuple of per-slot tensors that travel with their particles."""
    riders = riders or [()] * len(shards)
    deferred = moved = nbytes = 0
    for axis, sign in layout.passes():
        sends, counts = [], []
        for r, q in enumerate(shards):
            send, c = pass_counts(q, layout, r, axis, sign)
            sends.append(send)
            counts.append(c.cpu().numpy())
        granted, target = grants(np.stack(counts), layout, axis, sign)
        deferred += int((np.stack(counts)[:, 0] - granted).sum())
        if granted.sum() == 0:
            continue
        slots = [torch.nonzero(s).flatten()[:int(g)]
                 for s, g in zip(sends, granted)]
        rows = [pack(q, o, s, rd)
                for q, o, s, rd in zip(shards, origins, slots, riders)]
        for t in range(layout.world):
            got = [rows[s] for s in range(layout.world) if target[s] == t]
            if got:
                merge(shards[t], origins[t], torch.cat(got), riders[t])
        for q, o, s in zip(shards, origins, slots):
            deactivate(q, o, s)
        moved += int(granted.sum())
        nbytes += sum(r.numel() * r.element_size() for r in rows)
    return dict(deferred=deferred, moved=moved, bytes=nbytes)

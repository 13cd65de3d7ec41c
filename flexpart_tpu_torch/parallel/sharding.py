"""Particle data-parallelism over ``torch.distributed``: one process a
device.

Port of ``flexpart_tpu/parallel/sharding.py``.  The reference shards one
logically global particle array over a JAX mesh and lets XLA insert the
collectives; here each rank is a process of its own (``parallel/
launch.py``, or ``torchrun``) that holds its rows of the global array and
calls every collective itself.  The layout is the reference's ``P("p")``:
with capacity ``C`` padded to a multiple of the world size ``W``, rank
``r`` holds the contiguous global slots ``[r * L, (r + 1) * L)``, ``L =
C / W``.  Pad slots are inactive and never scheduled.  Met fields are
replicated: every rank reads and preprocesses them itself.

What crosses ranks, and where:

* the advance (K4, K11) and the convective redistribution (K7) draw by
  the global slot (``offset = r * L``), so a shard draws what the serial
  run draws in those slots; the step's diagnostics are summed over the
  group (``make_sharded_advance``);
* sampling (K3) and the deposit scatters (K8) add into the rank's own
  partial grids, summed in rank order when written
  (``reduce_acc_partials``); ``outnum`` is not summed: every rank adds the
  same sample weights;
* a split (K13) ranks due particles and free slots over the group in
  origin order, rank-major (``split_sharded``: one ``all_gather`` of two
  counts, the children that land on another rank as packed rows in one
  ``all_to_all_single``);
* the domain fill's boundary (K14) is replicated by site; each rank writes
  the wishes that fall on its free slots (``boundcond_sharded``: one
  ``all_gather`` of the free counts);
* the dumps and checkpoints gather the rows to rank 0, which writes.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU ones;
a group of the other backend is refused, never used in its place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core import domainfill
from ..core.advance import StepDiag, advance_all
from ..core.split import Share, due_and_free, split_particles
from ..core.state import FIELDS, ITRA_INACTIVE, Particles, empty_particles
from ..grid.conccalc import make_conccalc
from ..grid.outgrid import Accumulators, zero_accumulators

# the backend of each device type; no other is taken
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# the collectives whose seconds are taken with the card synchronised
# before and after (those at output times); the others' seconds are the
# host's time to enqueue them
SYNCED = frozenset(("reduce", "gather", "all_to_all", "split_counts"))


@dataclasses.dataclass
class Layout:
    """A rank's place in the particle layout: the world size and its rank.
    Rank ``r`` holds the contiguous global slots ``[r * L, (r + 1) * L)``
    of a capacity padded to a multiple of the world size."""
    world: int
    rank: int

    def rows(self, capacity: int) -> tuple[int, int]:
        """(first global slot, rows) of this rank at a padded capacity."""
        if capacity % self.world:
            raise ValueError(f"capacity {capacity} is no multiple of "
                             f"{self.world} ranks; pad it (pad_particles)")
        per = capacity // self.world
        return self.rank * per, per


class Group(Layout):
    """The initialised process group of a data-parallel run as one rank
    sees it: its layout, device, and per collective its calls, bytes (what
    this rank sends and receives) and seconds."""

    def __init__(self, device, n_devices: int | None = None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "distributed='dp' or 'tiles' needs an initialised "
                "torch.distributed process group, one process a device: "
                "start the run with flexpart_tpu_torch.parallel.launch "
                "(python -m flexpart_tpu_torch pathnames --dp or --tiles) "
                "or torchrun")
        self.device = torch.device(device)
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        want = BACKENDS.get(self.device.type)
        if want is None or self.backend != want:
            raise RuntimeError(
                f"a data-parallel run on {self.device.type} takes the "
                f"{want} backend; the process group has {self.backend}")
        if n_devices is not None and n_devices != self.world:
            raise ValueError(f"n_devices={n_devices}, but the process group "
                             f"has {self.world} ranks")
        self.stats: dict[str, dict] = {}

    @contextlib.contextmanager
    def _timed(self, name: str, nbytes: int):
        sync = self.device.type == "cuda" and name in SYNCED
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(self.device)
        st = self.stats.setdefault(name, {"calls": 0, "bytes": 0,
                                          "seconds": 0.0})
        st["calls"] += 1
        st["bytes"] += int(nbytes)
        st["seconds"] += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor, name: str) -> list:
        """Every rank's ``t`` (same shape on each), in rank order."""
        wire = t.contiguous()
        if wire.dtype == torch.bool:
            wire = wire.to(torch.uint8)
        out = [torch.empty_like(wire) for _ in range(self.world)]
        nbytes = wire.numel() * wire.element_size() * (self.world + 1)
        with self._timed(name, nbytes):
            dist.all_gather(out, wire)
        return [o.to(torch.bool) for o in out] if t.dtype == torch.bool \
            else out

    def sum(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The ranks' ``t`` summed in rank order (the same bits on every
        rank and in every run); one rank's ``t`` itself."""
        parts = self.all_gather(t, name)
        if self.world == 1:
            return t
        out = parts[0].clone()
        for q in parts[1:]:
            out += q
        return out

    def cat_rows(self, t: torch.Tensor, name: str, dim: int = 0):
        """The ranks' ``t`` concatenated along ``dim`` in rank order (the
        global slot order of per-particle rows)."""
        parts = self.all_gather(t, name)
        return parts[0] if self.world == 1 else torch.cat(parts, dim=dim)

    def all_to_all(self, rows: torch.Tensor, send: list, recv: list,
                   name: str) -> torch.Tensor:
        """``rows`` (k, width) split by ``send`` counts to the ranks in
        order; what the ranks sent here, (sum(recv), width), in rank
        order."""
        width = rows.shape[1]
        out = torch.empty((sum(recv), width), dtype=rows.dtype,
                          device=rows.device)
        nbytes = (rows.numel() + out.numel()) * rows.element_size()
        with self._timed(name, nbytes):
            dist.all_to_all_single(out, rows.contiguous(), recv, send)
        return out


def particle_mesh(n_devices: int | None = None, device="cuda") -> Group:
    """The process group over which particle rows are sharded (the
    reference's 1-D mesh): this process's rank, on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return Group(device, n_devices)


def pad_particles(p, multiple: int):
    """Append inactive slots so that the capacity is a multiple of
    ``multiple`` (pad slots never activate: itra stays at the inactive
    sentinel).  ``p``: Particles, or a dict of numpy arrays by field (a
    release schedule)."""
    if isinstance(p, Particles):
        rem = p.capacity % multiple
        if rem == 0:
            return p
        return Particles.cat([p, empty_particles(multiple - rem, p.nspec,
                                                 device=p.device)])
    cap = len(p["z"])
    rem = cap % multiple
    if rem == 0:
        return p
    extra = empty_particles(multiple - rem, p["mass"].shape[1],
                            device="cpu")
    return {f: np.concatenate([p[f], getattr(extra, f).numpy()])
            for f in FIELDS}


def shard_particles(p, group: Layout):
    """This rank's rows of a global (padded) particle array: Particles
    (views) or a dict of numpy arrays."""
    if isinstance(p, Particles):
        first, per = group.rows(p.capacity)
        return p.rows(first, first + per)
    first, per = group.rows(len(p["z"]))
    return {f: p[f][first:first + per] for f in FIELDS}


def replicate(tree, group: Group):
    """Met fields are replicated: every rank reads and processes its own
    copy, so there is nothing to send (the reference's placement)."""
    return tree


def make_sharded_advance(group: Group, cfg) -> Callable:
    """(p, z0, z1, itime, mt0, mt1, key, prm, **kw) -> (p, diag): the
    advance of this rank's rows with the draws of their global slots
    (``offset`` = the rank's first slot; the key is not folded with the
    rank, the global slot already separates the streams) and the
    diagnostics summed over the group."""
    def advance(p, z0, z1, itime, mt0, mt1, key, prm, offset: int = 0,
                **kw):
        p, diag = advance_all(p, z0, z1, itime, mt0, mt1, key, cfg, prm,
                              offset=offset, **kw)
        counts = torch.stack([diag.n_active.to(torch.int64),
                              diag.n_exited.to(torch.int64),
                              torch.as_tensor(diag.nan_count,
                                              device=p.device).to(
                                                  torch.int64).reshape(())])
        tot = group.sum(counts, "diag")
        return p, dataclasses.replace(diag, n_active=tot[0],
                                      n_exited=tot[1], nan_count=tot[2])
    return advance


def zero_acc_partials(group: Group, geo, nspec: int, npointspec: int,
                      nclassunc: int = 1, nage: int = 1) -> Accumulators:
    """This rank's partial accumulators (the reference's per-device slice
    of its leading device axis): zeros of the full output grid."""
    return zero_accumulators(geo, nspec, npointspec, nclassunc, nage,
                             device=group.device)


def make_sharded_conccalc(group: Group, outheights, nest: bool = False):
    """Sampling of this rank's particles into its own partial grid (K3):
    no communication until output."""
    return make_conccalc(outheights, nest=nest)


def make_sharded_depo_scatter(group: Group, scatter_fn: Callable):
    """The deposit scatter (K8) of this rank's particles into its own
    partial 2-D grid: ``scatter_fn`` itself, which adds in place."""
    return scatter_fn


def reduce_acc_partials(group: Group, acc: Accumulators) -> Accumulators:
    """The partial grids summed in rank order (the output-time reduction,
    mpif_tm_reduce_grid); ``outnum`` is every rank's own, which all share:
    each adds the same sample weights."""
    return Accumulators(
        gridunc=group.sum(acc.gridunc, "reduce"),
        wetgridunc=group.sum(acc.wetgridunc, "reduce"),
        drygridunc=group.sum(acc.drygridunc, "reduce"),
        outnum=acc.outnum)


# ------------------------------------------------------------- split --

def split_shares(counts) -> tuple[list, np.ndarray]:
    """From every rank's (due, free) counts, (world, 2): each rank's
    ``Share`` of the group's split, and the children that cross ranks,
    ``moves[sender, taker]`` (the diagonal 0: a child that lands on its
    parent's rank is written there)."""
    counts = np.asarray(counts, np.int64)
    nd, nf = counts[:, 0], counts[:, 1]
    dbase = np.concatenate([[0], np.cumsum(nd)[:-1]])
    fbase = np.concatenate([[0], np.cumsum(nf)[:-1]])
    granted = int(min(nd.sum(), nf.sum()))
    shares = [Share(int(dbase[r]), int(fbase[r]), granted, int(nd[r]),
                    int(nf[r])) for r in range(len(counts))]
    moves = np.zeros((len(counts), len(counts)), np.int64)
    for s, sh in enumerate(shares):
        lo, hi = sh.due_base, sh.due_base + sh.limits()[0]
        # the parents' group due ranks [lo, hi) fall on the takers' free
        # ranks
        moves[s] = np.clip(fbase + nf, lo, hi) - np.clip(fbase, lo, hi)
    np.fill_diagonal(moves, 0)
    return shares, moves


def crossing_slots(share: Share, parents: torch.Tensor,
                   takers: torch.Tensor) -> tuple:
    """(the parents whose child goes to another rank, in group order; the
    free slots that take the children of other ranks, in group order):
    from K13's lists of a rank's share (by rank)."""
    _, n_take, lo, hi = share.limits()
    shift = share.due_base - share.free_base
    keep = torch.ones(n_take, dtype=torch.bool, device=takers.device)
    keep[lo + shift:hi + shift] = False
    return (torch.cat([parents[:lo], parents[hi:]]).long(),
            takers.long()[keep])


def pack_rows(p: Particles, slots: torch.Tensor) -> torch.Tensor:
    """The rows of ``slots``, every field of FIELDS as int32 words, one row
    a particle (floats by their bits, int8 and bool widened)."""
    cols = []
    for f in FIELDS:
        t = getattr(p, f)
        t = t[slots].reshape(slots.shape[0], t[0].numel())
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        elif t.dtype != torch.int32:
            t = t.to(torch.int32)
        cols.append(t)
    return torch.cat(cols, dim=1)


def unpack_rows(p: Particles, slots: torch.Tensor,
                rows: torch.Tensor) -> None:
    """Write packed ``rows`` (``pack_rows``) into ``slots`` of ``p``, in
    place."""
    at = 0
    for f in FIELDS:
        t = getattr(p, f)
        width = t[0].numel()
        v = rows[:, at:at + width].contiguous()
        at += width
        v = v.view(torch.float32) if t.dtype == torch.float32 \
            else v.to(t.dtype)
        t.index_copy_(0, slots, v.reshape((-1,) + tuple(t.shape[1:])))


def split_sharded(group: Group, p: Particles, itime: int, ldirect: int,
                  origin: torch.Tensor | None):
    """One split over the group, in place on this rank's rows: the r-th
    due particle of the group in origin order (rank-major, the rank's own
    origin order inside) takes the group's r-th free slot, while free
    slots last (core/split.py).  ``origin``: the rank's local origins.
    Returns the group's counts (due, free, granted) as an int32 tensor on
    the rank's device."""
    due, free = due_and_free(p, itime, ldirect)
    mine = torch.stack([due.sum(), free.sum()]).to(torch.int64)
    counts = torch.stack(group.all_gather(mine, "split_counts")) \
        .cpu().numpy()
    shares, moves = split_shares(counts)
    share = shares[group.rank]
    p, _, parents, takers = split_particles(p, itime, ldirect, origin, share)
    if moves.sum() > 0:
        away, arrive = crossing_slots(share, parents, takers)
        got = group.all_to_all(pack_rows(p, away), moves[group.rank].tolist(),
                               moves[:, group.rank].tolist(), "all_to_all")
        unpack_rows(p, arrive, got)
    return torch.tensor([int(counts[:, 0].sum()), int(counts[:, 1].sum()),
                         share.granted], dtype=torch.int32, device=p.device)


# ---------------------------------------------------- domain-fill bc --

def free_after_kill_mask(p: Particles, bs, check_x: bool) -> torch.Tensor:
    """The slots that K14's kill pass leaves free: inactive and not a
    future release, or live outside the window (they are destroyed)."""
    _, xlo, xhi, ylo, yhi = bs.limits()
    y = p.y
    outside = (y < ylo) | (y > yhi)
    if check_x:
        x = p.x
        outside = outside | (x < xlo) | (x > xhi)
    free = (~p.active) & ((p.itra == ITRA_INACTIVE) | (p.itra != p.itramem))
    return free | (p.active & outside)


def free_after_kill(p: Particles, bs, check_x: bool) -> torch.Tensor:
    """``free_after_kill_mask``'s slots as one int64 count on the
    particles' device."""
    return free_after_kill_mask(p, bs, check_x).sum().to(
        torch.int64).reshape(1)


def boundcond_sharded(group: Group, p: Particles, bs, f0, f1, height,
                      itime: int, w0: float, w1: float, key, lsynctime,
                      itsplit: int, ylat0: float, dy: float, **kw):
    """One boundary step over the group, in place on this rank's rows: the
    sites and their draws are every rank's, and the group's k-th wish
    takes the group's k-th free slot in origin order, so this rank writes
    the wishes whose rank falls on its free slots (K14's ``free_base``,
    from one ``all_gather`` of the free counts after the kill; on the
    device, no host wait).  Returns (the new accumulator, the group's
    counts (killed, free, wanted, granted))."""
    check_x = kw.get("check_x", True)
    free = group.all_gather(free_after_kill(p, bs, check_x), "boundary")
    base = torch.zeros(1, dtype=torch.int64, device=p.device)
    for q in free[:group.rank]:
        base = base + q
    acc, counts = domainfill.boundcond(
        p, bs, f0, f1, height, itime, w0, w1, key, lsynctime, itsplit,
        ylat0, dy, free_base=base, **kw)
    # wanted is every rank's: counted once
    one = torch.tensor([1, 1, int(group.rank == 0), 1], dtype=torch.int32,
                       device=p.device)
    return acc, group.sum(counts * one, "boundary")


def gather_particles(group: Group, p: Particles, name: str = "gather"):
    """Every rank's rows in global slot order (on every rank: rank 0
    writes them)."""
    return Particles(**{f: group.cat_rows(getattr(p, f), name)
                        for f in FIELDS})

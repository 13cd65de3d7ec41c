"""Particle splitting (timemanager.f90:473-504).

Port of ``flexpart_tpu/core/split.py``.  At every output time with
ldirect*itime >= ldirect*itsplit, every live particle whose next-split
time has passed is duplicated: parent and child each get half the
parent's mass, all other state is copied, and the next-split interval
doubles (itrasplit = 2*(itrasplit-itramem)+itramem).  Children go into
free slots of the fixed-capacity state, the r-th due parent into the r-th
free slot; parents without a free slot keep their full mass (the
reference's maxpart guard).

The reference ranks free slots and due parents by slot index.  The port
keeps its particles in met-cell order, so it ranks both by the slot's
schedule origin (``Simulation._origin``, the reference's slot of the
particle in each port slot; the identity before the first sort): the same
parents are granted as in the reference and each child lands in the port
slot that holds the reference's child slot, so ``_origin`` stays a
permutation.  Children break the cell order; the run loop sorts after a
split.

Two versions, both updating the particles' tensors in place (parents and
children are disjoint slots): ``split_particles_plain`` (cumsum and masked
``index_copy_``) for CPU tensors, and kernel K13 (``csrc/split.cu``: the
flags as bits in origin order, one scan of their words, each slot's rank
from its word, the copy; its scratch laid out by ``split_plan``) for
CUDA tensors.  ``split_particles`` picks by device and never
falls from one to the other.  A rank of a data-parallel run splits its
``Share`` of the group's split (both versions; parallel/sharding.py sends
the children that land on other ranks).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .origin_rank import (MAX_FLAGS, pointers, rank_plan, rank_scratch,
                          sm_count)
from .state import FIELDS, ITRA_INACTIVE, Particles


def due_and_free(p: Particles, itime: int, ldirect: int):
    """(due, free) masks: live particles whose split time has passed; slots
    that are inactive and hold no future release (a scheduled slot still
    has itra == itramem == its release time)."""
    due = (p.active & (p.itrasplit != ITRA_INACTIVE)
           & (ldirect * itime >= ldirect * p.itrasplit.long()))
    free = (~p.active) & ((p.itra == ITRA_INACTIVE) | (p.itra != p.itramem))
    return due, free


def doubled_interval(itrasplit: torch.Tensor,
                     itramem: torch.Tensor) -> torch.Tensor:
    """2 * (itrasplit - itramem) + itramem, the interval clipped before
    doubling so that the result stays in int32 (split.py:48-50 there)."""
    dt = torch.clamp(itrasplit.long() - itramem.long(), -499999999,
                     499999999)
    return torch.clamp(2 * dt + itramem.long(), -999999998,
                       999999999).to(torch.int32)


class Share(NamedTuple):
    """A rank's share of a split over a process group (a data-parallel
    run, ``parallel/sharding.py::split_sharded``): the group's due rank of
    the rank's first due particle and free rank of its first free slot (in
    the group's origin order, rank-major), the group's granted count
    min(due, free), and the rank's own due and free counts.  The rank's due
    particle j is the group's due particle ``due_base + j``; its child takes
    the group's free slot of that rank, on this rank its free slot
    ``j + due_base - free_base`` where that lies in 0 .. free - 1."""
    due_base: int
    free_base: int
    granted: int
    due: int
    free: int

    def limits(self) -> tuple:
        """(parents, takers, lo, hi): the due particles granted a child,
        the free slots that take one, and the due ranks [lo, hi) whose
        child lands on this rank (K13's ``share_limits``)."""
        parents = min(max(self.granted - self.due_base, 0), self.due)
        takers = min(max(self.granted - self.free_base, 0), self.free)
        shift = self.due_base - self.free_base
        lo = min(max(-shift, 0), parents)
        hi = max(min(max(takers - shift, 0), parents), lo)
        return parents, takers, lo, hi


def split_particles_plain(p: Particles, itime: int, ldirect: int = 1,
                          origin: torch.Tensor | None = None,
                          share: Share | None = None):
    """Plain twin of K13, in place.  Returns (particles, counts): counts is
    an int32 tensor (due, free, granted); with a ``share``, (particles,
    counts, the slots of the parents granted a child, the free slots that
    take one), granted then the rank's parents."""
    n, dev = p.capacity, p.device
    due, free = due_and_free(p, itime, ldirect)
    slots = torch.arange(n, device=dev)
    o = slots if origin is None else origin.long()
    at_origin = torch.empty(n, dtype=torch.long, device=dev)
    at_origin.index_copy_(0, o, slots)
    free_o = torch.zeros(n, dtype=torch.bool, device=dev)
    free_o.index_copy_(0, o, free)
    due_o = torch.zeros(n, dtype=torch.bool, device=dev)
    due_o.index_copy_(0, o, due)
    free_rank = torch.cumsum(free_o, 0) - 1
    due_rank = torch.cumsum(due_o, 0) - 1
    n_free = int(free_rank[-1]) + 1 if n else 0
    n_due = int(due_rank[-1]) + 1 if n else 0
    if share is None:
        granted = min(n_due, n_free)
        parents, takers, lo, hi = granted, granted, 0, granted
    else:
        if (share.due, share.free) != (n_due, n_free):
            raise ValueError(f"K13 share counts {share.due, share.free} "
                             f"against the slots' {n_due, n_free}")
        parents, takers, lo, hi = share.limits()
    shift = 0 if share is None else share.due_base - share.free_base
    # the slot of the r-th free origin and of the r-th due one
    free_slot = torch.empty(n, dtype=torch.long, device=dev)
    free_slot.index_copy_(0, free_rank[free_o], at_origin[free_o])
    due_slot = torch.empty(n, dtype=torch.long, device=dev)
    due_slot.index_copy_(0, due_rank[due_o], at_origin[due_o])
    parent = due_slot[:parents]
    pair = parent[lo:hi]
    child = free_slot[lo + shift:hi + shift]
    for name in FIELDS:
        t = getattr(p, name)
        if name == "mass":
            half = t[parent] * 0.5
            t.index_copy_(0, parent, half)
            t.index_copy_(0, child, half[lo:hi])
        elif name == "itrasplit":
            nxt = doubled_interval(t[parent], p.itramem[parent])
            t.index_copy_(0, parent, nxt)
            t.index_copy_(0, child, nxt[lo:hi])
        elif name == "active":
            t.index_fill_(0, child, True)
        else:
            t.index_copy_(0, child, t[pair])
    counts = torch.tensor([n_due, n_free, parents], dtype=torch.int32,
                          device=dev)
    if share is None:
        return p, counts
    return p, counts, parent, free_slot[:takers]


def split_plan(n: int, share: bool = False):
    """K13's scratch at ``n`` slots (origin_rank.rank_plan): the free and
    the due bitmaps, the free and due slots by rank, at most min(due,
    free) <= n // 2 of each (in a share up to n of each: a rank may give
    all its free slots to other ranks' parents), and the slots free or due
    in slot order."""
    m = n if share else n // 2 + 1
    return rank_plan(n, n, (m, m), n)


def split_particles_cuda(p: Particles, itime: int, ldirect: int = 1,
                         origin: torch.Tensor | None = None,
                         share: Share | None = None):
    """K13 launch, in place; the counts (due, free, granted) stay on the
    card.  With a ``share``, also the slots of the parents granted a child
    and the free slots that take one (views of the scratch, by rank)."""
    n, dev = p.capacity, p.device
    if n >= MAX_FLAGS:
        raise ValueError("K13 indexes particles with int32")
    for name in FIELDS:
        t = getattr(p, name)
        if t.device != dev or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"K13: particle field {name} must be contiguous "
                             f"({n}, ...) on {dev}")
    if origin is not None and (origin.device != dev
                               or origin.dtype != torch.int64
                               or tuple(origin.shape) != (n,)
                               or not origin.is_contiguous()):
        raise ValueError(f"K13: origin must be contiguous int64 ({n},) on "
                         f"{dev}")
    if n == 0:
        counts = torch.zeros(3, dtype=torch.int32, device=dev)
        if share is None:
            return p, counts
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        return p, counts, none, none
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    plan = split_plan(n, share is not None)
    scratch = rank_scratch(plan, dev)
    at = pointers(scratch, plan)
    fields = (ctypes.c_void_p * len(FIELDS))(
        *(getattr(p, f).data_ptr() for f in FIELDS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.SPLIT(
            ctypes.addressof(fields),
            None if origin is None else origin.data_ptr(), n, p.nspec,
            int(itime), int(ldirect), at["bits"], at["prefix"],
            at["status"], at["ticket"], 4 * plan.zero, plan.tiles_a,
            at["flagged"], at["list_a"], at["list_b"],
            *((0, 0, -1) if share is None
              else (share.due_base, share.free_base, share.granted)),
            counts.data_ptr(), sm_count(dev), stream)
    if share is None:
        return p, counts
    parents, takers, _, _ = share.limits()
    return (p, counts, scratch[plan.list_b:plan.list_b + parents],
            scratch[plan.list_a:plan.list_a + takers])


def split_particles(p: Particles, itime: int, ldirect: int = 1,
                    origin: torch.Tensor | None = None,
                    share: Share | None = None):
    """Split the particles due at ``itime``, in place; ``origin`` the
    slots' schedule origins (None: the identity).  K13 on a CUDA device,
    the plain version on the CPU.  Returns (particles, counts), counts an
    int32 tensor (due, free, granted) on the particles' device; with a
    rank's ``share`` of a group's split, also the slots of its parents
    granted a child and its free slots that take one, each by rank."""
    run = {"cuda": split_particles_cuda,
           "cpu": split_particles_plain}.get(p.device.type)
    if run is None:
        raise ValueError(f"no splitting backend for device {p.device}")
    return run(p, itime, ldirect, origin, share)

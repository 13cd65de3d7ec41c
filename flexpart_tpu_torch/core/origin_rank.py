"""The scratch of the kernels that rank flagged slots by schedule origin
(K13's splitting, K14's boundary step; ``csrc/origin_rank.cuh``).

A ranking holds two bitmaps, one bit a flag, each padded to whole scan
tiles of ``RANK_TILE_WORDS`` words; per word the popcount prefix of its
bitmap; a 64-bit state per tile and the scan's ticket; then the lists of
slots by rank, a bitmap of the slots in slot order (which ones to rank)
and, for K14, the wishes' candidates.  ``rank_plan`` lays
them out in one int32 buffer, the part the launcher zeroes first (the
bitmaps, the states, the ticket and a counter) at its start; a layout is
computed once per sizes.  A call takes its buffer from the caching
allocator (``rank_scratch``), ordered on its stream as any tensor is.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# csrc/origin_rank.cuh: threads of a scan tile, words each of them scans
RANK_THREADS = 256
RANK_ITEMS = 16
RANK_TILE_WORDS = RANK_THREADS * RANK_ITEMS
RANK_TILE_FLAGS = 32 * RANK_TILE_WORDS
# the kernels index slots and flags with int32, padded to whole tiles
MAX_FLAGS = 2 ** 31 - RANK_TILE_FLAGS


def rank_tiles(flags: int) -> int:
    """Scan tiles of a bitmap of ``flags`` flags (at least one)."""
    return max(1, -(-flags // RANK_TILE_FLAGS))


class RankPlan(NamedTuple):
    """Offsets in int32 of one scratch buffer, and its size."""
    tiles_a: int       # scan tiles of bitmap a
    tiles: int         # of both bitmaps
    bits: int          # bitmap a's words, then b's (tiles * RANK_TILE_WORDS)
    status: int        # (tiles,) 64-bit
    ticket: int
    counter: int       # K14's killed count
    zero: int          # int32 zeroed before a call: bits .. counter
    prefix: int        # per word, like bits
    list_a: int        # slots by rank
    list_b: int
    flagged: int       # a bitmap of the slots in slot order, whole warps
    extra: int         # ``extra`` int32 after it
    size: int


@functools.lru_cache(maxsize=16)
def rank_plan(flags_a: int, flags_b: int, lists: tuple, slots: int,
              extra: int = 0) -> RankPlan:
    """The layout for bitmaps of ``flags_a`` and ``flags_b`` flags, two
    lists of ``lists`` = (a, b) entries, a bitmap of ``slots`` slots in
    slot order (a word for each warp of the launch's blocks of
    RANK_THREADS) and ``extra`` int32 more."""
    tiles_a = rank_tiles(flags_a)
    tiles = tiles_a + rank_tiles(flags_b)
    words = tiles * RANK_TILE_WORDS
    status = words                          # 8-byte aligned: words is even
    ticket = status + 2 * tiles
    zero = -(-(ticket + 2) // 4) * 4        # the prefixes 16-byte aligned
    prefix = zero
    list_a = prefix + words
    list_b = list_a + lists[0]
    flagged = list_b + lists[1]
    after = flagged + -(-slots // RANK_THREADS) * (RANK_THREADS // 32)
    return RankPlan(tiles_a, tiles, 0, status, ticket, ticket + 1, zero,
                    prefix, list_a, list_b, flagged, after, after + extra)


_SMS: dict = {}


def sm_count(device) -> int:
    """The card's SMs, read once per device (the K13 copy's grid)."""
    dev = torch.device(device)
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev]


def rank_scratch(plan: RankPlan, device) -> torch.Tensor:
    """The int32 buffer of ``plan`` on ``device``, uninitialised (the
    launcher zeroes its first part)."""
    return torch.empty(plan.size, dtype=torch.int32, device=device)


def pointers(buf: torch.Tensor, plan: RankPlan) -> dict:
    """The addresses of the plan's parts in ``buf``."""
    at, step = buf.data_ptr(), buf.element_size()
    return {f: at + step * getattr(plan, f)
            for f in ("bits", "status", "ticket", "counter", "prefix",
                      "list_a", "list_b", "flagged", "extra")}

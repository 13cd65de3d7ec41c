"""The scratch plans of the kernels that rank flagged slots by schedule
origin (``core/origin_rank.py``: K13's ``split_plan``, K14's
``boundary_plan``) against ``csrc/origin_rank.cuh``'s constants and the
launchers' use of them, at sizes around a warp, a 4096 tile and the
131,072-flag scan tile; and a call's scratch buffer."""
import math
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu_torch import _build  # noqa: E402
from flexpart_tpu_torch.core import domainfill, origin_rank, split  # noqa: E402

SIZES = [1, 31, 33, 4095, 4097, 2 ** 17, 2 ** 17 + 1, 2 ** 20 + 1]


def _header_tile_words():
    text = (_build.CSRC / "origin_rank.cuh").read_text()
    threads = int(re.search(r"constexpr int RANK_THREADS = (\d+);", text)[1])
    items = int(re.search(r"constexpr int RANK_ITEMS = (\d+);", text)[1])
    return threads * items


def _check_layout(plan, flags_a, flags_b, lists, slots, extra):
    words = _header_tile_words()
    assert plan.tiles_a == max(1, math.ceil(flags_a / (32 * words)))
    assert plan.tiles - plan.tiles_a == max(1, math.ceil(flags_b
                                                         / (32 * words)))
    # every flag has its bit: fp_split and fp_domainfill refuse fewer tiles
    assert plan.tiles_a * words * 32 >= flags_a
    assert (plan.tiles - plan.tiles_a) * words * 32 >= flags_b
    # zeroed by one memset from the bits on: bits, 64-bit states, ticket,
    # counter; the states 8-byte and the prefixes 16-byte aligned
    assert plan.bits == 0 and plan.status == plan.tiles * words
    assert plan.status % 2 == 0
    assert plan.ticket == plan.status + 2 * plan.tiles
    assert plan.counter == plan.ticket + 1 < plan.zero == plan.prefix
    assert plan.zero % 4 == 0
    assert plan.list_a == plan.prefix + plan.tiles * words
    assert plan.list_b == plan.list_a + lists[0]
    # the slot-order bitmap: a word for each warp of the blocks of
    # RANK_THREADS that cover the slots
    assert plan.flagged == plan.list_b + lists[1]
    threads = words // int(re.search(
        r"constexpr int RANK_ITEMS = (\d+);",
        (_build.CSRC / "origin_rank.cuh").read_text())[1])
    assert plan.extra - plan.flagged \
        == math.ceil(slots / threads) * threads // 32
    assert plan.size == plan.extra + extra


@pytest.mark.parametrize("n", SIZES)
def test_split_plan_matches_the_header(n):
    """K13: the free and the due bitmaps of n flags each, and lists of at
    most min(due, free) <= n // 2 slots."""
    _check_layout(split.split_plan(n), n, n, (n // 2 + 1, n // 2 + 1), n, 0)


@pytest.mark.parametrize("sites", [1, 31, 8193, 694479])
@pytest.mark.parametrize("n", [33, 4097, 2 ** 20 + 1])
def test_boundary_plan_matches_the_header(n, sites):
    """K14: the free bitmap of n flags, the wishes' of KMAX_EMIT a site,
    one list of at most min(free, wanted) <= KMAX_EMIT * S entries and
    the wishes' five arrays."""
    wishes = domainfill.KMAX_EMIT * sites
    _check_layout(domainfill.boundary_plan(n, sites), n, wishes, (wishes, 0),
                  n, 5 * wishes)


@pytest.mark.parametrize("n", SIZES[:4])
def test_scratch_is_one_int32_buffer_of_the_plan(n):
    """A call's scratch: one uninitialised int32 buffer of the plan's size
    on the call's device, taken anew on every call."""
    plan = split.split_plan(n)
    first = origin_rank.rank_scratch(plan, "cpu")
    assert first.dtype == torch.int32 and first.numel() == plan.size
    assert first.device.type == "cpu"
    at = origin_rank.pointers(first, plan)
    assert at["bits"] == first.data_ptr()
    assert at["prefix"] == first.data_ptr() + 4 * plan.prefix
    assert origin_rank.rank_scratch(plan, "cpu") is not first

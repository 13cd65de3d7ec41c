"""Keep the particles in the order of their met cells.

A layout decision of the port, not a feature of the model: slot order
carries no meaning (a particle has no identity field, release takes any
free slot), so the port may hold the ensemble in the order that suits the
card.  The advance gathers one row of the quad tables per particle, the
row of the particle's cell; with the particles sorted by that row,
neighbouring threads of K4 name the same or neighbouring rows and the
gathers hit the caches instead of device memory.

``reorder_by_cell`` sorts by K4's own row id (``indz*ny*nx + jy*nx + ix``
from the ``horiz_weights`` / ``vert_weights`` the advance uses); particles
that are not scheduled (``active`` false) get the key ``R`` and go last.
It returns new particles and the permutation, ``out.f == in.f[perm]`` for
every field ``f``, bitwise.  The sort is stable: particles with the same
key keep their slot order, so ``perm`` equals
``torch.argsort(cell_keys, stable=True)`` on every input and is a function
of the ensemble alone.

Two versions: ``reorder_by_cell_plain`` (stable ``argsort`` +
``index_select``) runs for CPU tensors; ``reorder_by_cell_cuda`` launches
kernel K5 (``csrc/reorder.cu``), a least-significant-digit radix sort
written by hand in which no atomic decides a place, for CUDA tensors.  The
two give the same ``perm`` and the same particles, bit for bit.
``reorder_by_cell`` picks by the device and never falls from one to the
other.

The draw counter of the advance is the slot index, so a reordered
ensemble consumes an equally valid, different stream; because ``perm`` is a
function of the ensemble, a run stays a function of its seed.  With
injected draws permuted alike the advance commutes with the permutation
bitwise.

The caller of the step decides when to sort: every ``REORDER_EVERY``
steps, and when a release has woken particles out of cell order.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .interp import _cell_rowid, horiz_weights, vert_weights
from .state import FIELDS, Particles

# Steps between two sorts on the main path.  Chosen from chip_smoke.py's
# ``reorder`` line on the H100: K4 and K3 stay as fast 64 steps after a sort
# as right after it, so the interval only spreads K5's millisecond; from 16
# steps on, a longer interval gains less per step than K4's readings vary,
# and it would leave newly released particles out of order for longer.
# PERF.md section 6 has the readings.
REORDER_EVERY = 16
# What sizes K5's scratch (csrc/reorder.cu): entries per block of its
# scan, pairs per block of a radix pass, and the widest digit.  The kernel
# plans its passes itself and refuses scratch that is too short for them.
SCAN_TILE = 2048
SORT_TILE = 4096
MAX_DIGIT_BITS = 8


class ReorderFields(ctypes.Structure):
    """The particle arrays K5 moves, the ``ReorderFields`` struct of
    ``csrc/reorder.cu`` field for field: source and destination pointers
    and the bytes per particle of each of ``state.FIELDS``."""
    _fields_ = [
        ("src", ctypes.c_void_p * len(FIELDS)),
        ("dst", ctypes.c_void_p * len(FIELDS)),
        ("width", ctypes.c_int * len(FIELDS)),
    ]


def cell_keys(p: Particles, height: torch.Tensor, cfg) -> torch.Tensor:
    """(N,) int64 sort key: the quad-table row of each scheduled particle,
    ``R`` for the others."""
    hw = horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, _ = vert_weights(p.z, height)
    n_rows = (cfg.nz - 1) * cfg.ny * cfg.nx
    row = _cell_rowid(hw, indz, cfg.nx, cfg.ny)
    return torch.where(p.active, row, torch.full_like(row, n_rows))


def apply_perm(p: Particles, perm: torch.Tensor) -> Particles:
    """Particles with every field gathered through ``perm``."""
    idx = perm.long()
    return Particles(**{f: getattr(p, f).index_select(0, idx)
                        for f in FIELDS})


def reorder_by_cell_plain(p: Particles, height: torch.Tensor, cfg):
    """Plain PyTorch version of K5: a stable argsort of the cell keys.
    Returns (particles, perm)."""
    perm = torch.argsort(cell_keys(p, height, cfg), stable=True)
    return apply_perm(p, perm), perm.to(torch.int32)


def reorder_by_cell_cuda(p: Particles, height: torch.Tensor, cfg):
    """K5 launch: the keys, as many radix passes as the largest key needs
    (digit counts per block, their exclusive scan, a stable scatter of the
    (key, slot) pairs), one gather pass over all fields.  Returns
    (particles, perm)."""
    n = p.capacity
    dev = p.device
    n_rows = (cfg.nz - 1) * cfg.ny * cfg.nx
    if n >= 2 ** 31 or n_rows + 1 >= 2 ** 31:
        raise ValueError("K5 indexes particles and cells with int32")
    if height.device != dev or height.dtype != torch.float32 \
            or height.shape != (cfg.nz,) or not height.is_contiguous():
        raise ValueError(f"K5: height must be float32 ({cfg.nz},) on {dev}")
    fields = ReorderFields()
    out = {}
    for k, name in enumerate(FIELDS):
        t = getattr(p, name)
        if t.device != dev or not t.is_contiguous() or t.shape[0] != n \
                or t.dim() > 2:
            raise ValueError(f"K5: particle field {name} must be contiguous "
                             f"with {n} rows on {dev}")
        width = t.element_size() * (t.shape[1] if t.dim() == 2 else 1)
        if width != 1 and width % 4:
            raise ValueError(f"K5: particle field {name} has {width} bytes "
                             "per particle; 1 or a multiple of 4 is taken")
        out[name] = torch.empty_like(t)
        fields.src[k] = t.data_ptr()
        fields.dst[k] = out[name].data_ptr()
        fields.width[k] = width
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "z"):
        if getattr(p, name).dtype != torch.float32:
            raise ValueError(f"K5: particle field {name} must be float32")
    if p.active.dtype != torch.bool:
        raise ValueError("K5: particle field active must be bool")
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return p, perm
    n_counts = (1 << MAX_DIGIT_BITS) * (-(-n // SORT_TILE))
    if n_counts >= 2 ** 31:
        raise ValueError("K5 indexes its digit counts with int32")
    # scratch: the (key, slot) pairs of two passes, the [digit][block]
    # counts of the widest digit and the tile sums of their scan
    pairs = torch.empty((4, n), dtype=torch.int32, device=dev)
    counts = torch.empty(n_counts, dtype=torch.int32, device=dev)
    sums = torch.empty(-(-n_counts // SCAN_TILE), dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.REORDER(p.x_hi.data_ptr(), p.x_lo.data_ptr(),
                       p.y_hi.data_ptr(), p.y_lo.data_ptr(), p.z.data_ptr(),
                       p.active.data_ptr(), height.data_ptr(), n, cfg.nx,
                       cfg.ny, cfg.nz,
                       *(pairs[k].data_ptr() for k in range(4)),
                       counts.data_ptr(), counts.numel(), sums.data_ptr(),
                       sums.numel(), perm.data_ptr(),
                       ctypes.addressof(fields), stream)
    return Particles(**out), perm


def reorder_by_cell(p: Particles, height: torch.Tensor, cfg):
    """Sort the particles by met cell: K5 for particles on a CUDA device,
    the plain version for particles on the CPU.  ``cfg`` is the advance's
    ``StepConfig`` (``nx``, ``ny``, ``nz``, ``xglobal``).
    Returns (particles, perm) with ``out.f == in.f[perm]``."""
    dev = p.device
    if dev.type == "cuda":
        return reorder_by_cell_cuda(p, height, cfg)
    if dev.type == "cpu":
        return reorder_by_cell_plain(p, height, cfg)
    raise ValueError(f"no reorder backend for device {dev}")

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (flexpart_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the hand-written kernels from
flexpart_tpu_torch/csrc/ at first use (into build/kernels/) and drives
the port's stock forward step on the card, in phases:

  1. device   — card name and power limit, torch and CUDA versions;
  2. build    — nvcc for every kernel source, all started together;
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the main path's shapes, with its time, the twin's, its
                bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s,
                whichever is larger) and, where one PyTorch call computes
                the same function, that call's time (the normals kernel
                and its library call take some 10 us, less than a launch
                costs the host, so both are timed as replays of a CUDA
                graph of 50 launches); the sampling on both paths, on an
                unordered and on a cell-ordered ensemble, all particles
                old and half of them, with the global atomics it would
                make without its per-warp sums (the (particle, target)
                pairs) and with them (the distinct (warp, target) pairs);
                the cell-order sort must give the stable argsort of the
                cell keys as its permutation and the plain version's
                particles, bitwise, on four inputs (shuffled, 16 steps
                after a sort, every slot unscheduled, a release step) and
                twice in a row, and the advance must commute with it; the
                advance's POLAR instantiation on 10 x 2**20 particles over
                the whole sphere (both caps, some crossing a pole); the
                convection columns (K6) on SyntheticMet's two met times
                and on the moist-unstable sounding at every column, each
                through five steps of the flux memory's feedback, and the
                redistribution (K7) of 10 x 2**20 particles against both
                cases' matrices, with injected uniforms and its own, z
                bitwise and the moved counts equal;
  4. step     — one full step (tables, advance, sampling) on SyntheticMet
                at the bench grid, 2**20 particles, kernels against twins
                with the same draws; and the advance kernel with its draws
                made in registers against the same kernel fed the normals
                kernel's draws, bitwise;
  5. reorder  — what the cell order is worth and how fast it decays: the
                advance and the sampling timed 0 to 64 steps after a sort,
                the sort timed on a shuffled and on a nearly ordered
                ensemble, on SyntheticMet and on the main path's uniform
                wind, and from these the device time per step for a sort
                every 1, 2, 4, ... 64 steps;
  6. main     — the main path at full width: uniform-wind met on the
                361x181x30 grid, 10 x 2**20 particles, the 720x360x3
                output grid, 33 steps of 900 s (from the twelfth on they
                sample with the 4-point kernel), the particles sorted by
                cell every REORDER_EVERY = 16 steps; launch counts are
                reset just before and read just after;
  7. profile  — REORDER_EVERY more steady steps (one sort among them)
                under torch.profiler: CUDA launches per step, device time
                by kernel with the sort's share, device busy share;
  8. sim      — the port's Simulation.run at full width with the default
                Command (convection and subgrid orography on): 10 x 2**20
                particles released from one box over the first hour, three
                hours on SyntheticMet on the 361x181x30 grid, which reaches
                the poles (the advance's POLAR instantiation), hourly npz
                (and netCDF where h5py imports) output on the 720x360x3
                grid; twice with one seed: the runs must end in bitwise
                equal particles, all particles active, the mass recovered
                from the last file 1 within 1e-3; per step, the columns
                that convect and the particles convection moved.  The first run carries no
                probe and is timed as a whole; the second, under
                torch.profiler and synchronised at the top of every step,
                gives the section timers, the step time during and after
                the release, the device time of each kernel per call, the
                sorts, and the share of active particles out of cell order
                at the top of each step, and keeps the ensemble, the met
                fields and the flux memory of one release step and of one
                steady step: on those, K2, K5, K6, K7, K3 and K4 (injected
                draws) are held against their plain versions at the kernels
                phase's tolerances, and K7 once more with the step's
                particles put in its convecting columns (the plume lies
                outside SyntheticMet's convecting bands), where it must
                move some.

Prints one JSON object per phase, then a {"kernels": [...]} line, the
nvidia-smi name/power line, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result.  It also fails without a CUDA card,
and when run from a directory that holds nothing else of the repo.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BENCH_GRID = dict(nx=361, ny=181, nlev=30, dx=1.0, dy=1.0, xlon0=-180.0,
                  ylat0=-90.0, xglobal=True)
N_MAIN = 10 * 2 ** 20
CHUNK = 2 ** 19
N_STEP4 = 2 ** 20
MAIN_STEPS = 33          # step 0 warms up; 32 steady steps, two sorts
DECAY_STEPS = 64         # steps followed after a sort in the reorder phase
SORT_INTERVALS = (1, 2, 4, 8, 16, 32, 64)
LSYNC = 900
K1_SHAPE = (6, 2 ** 19)
K1_ATOL = 5e-6
K3_RTOL = 1e-5
# K4 against the plain advance: positions in grid units, z in metres (plus
# 1e-4 relative), velocities and mesoscale memories in m/s.  The two run
# the same float32 operations in the same order and have agreed bitwise on
# the H100; the room is for a toolkit whose expf/powf/cosf differ by an ulp
# from the ones torch was built with, which a 900 s step multiplies.  cbt
# and active hinge on comparisons of such floats: at most K4_FLAG_SHARE of
# the particles may differ there.
K4_XY_ATOL = 1e-4
K4_Z_ATOL, K4_Z_RTOL = 1e-2, 1e-4
K4_V_ATOL, K4_V_RTOL = 1e-5, 1e-4
K4_FLAG_SHARE = 1e-5
# the card's peaks (NVIDIA H100 SXM data sheet) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per element, counted from the sources.  A draw: a quarter of
# a Philox call (10 rounds of 2 multiply-high, 2 multiply-low, 4 xor and 2
# add: 100) and half a Box-Muller pair (2 shifts, 2 conversions, logf about
# 25, sqrtf about 10, sincosf about 40, 5 multiplies and subtractions, 8 for
# the clips: about 95), with the stores and the loop about 80; the six rows
# of K1_SHAPE take two calls and three pairs.  It was 175 while each draw
# had a Philox call and a logf/sqrtf/cosf of its own.  A sampled particle:
# 60 for its cell and weights and, on the 4-point path, four rounds of a
# warp match and a shuffle loop of about 60 each.
K1_OPS_PER_DRAW = 80
K2_OPS_PER_LANE = 12
K3_OPS_PER_PARTICLE = 300
K4_OPS_PER_PARTICLE = 1800
K5_OPS_PER_PARTICLE = 60
# K6 against its plain pipeline: every float output within this share of
# its largest magnitude, the flags exactly.  Both add each level sum in
# level order and spell every operation alike, and have agreed bitwise on
# the H100; the room is for a toolkit whose expf/logf/powf differ by an ulp
# from the ones torch was built with.
K6_SHARE = 1e-5
CONV_TW = (0.75, 0.25)      # the step's time weights in the kernels phase
CONV_SPINUP = 5             # steps of cbmf feedback before the comparison
# operations of K6 per column, counted from csrc/convection.cu: the
# entrainment row and the normalisation scan (about 60 per (i, j)), the
# flux sums (MENT's two column prefix sums and the three row sums of
# M above, FUP and FDOWN: 5 per (i, j)), the rows of fmassfrac (4 per
# (i, j)), the profiles and the lifted parcel (about 200 per level)
def k6_ops_per_column(L1: int) -> int:
    return 69 * L1 ** 2 + 200 * L1


K7_OPS_PER_PARTICLE = 30    # the column, the level search's setup, the store
K7_OPS_PER_LIVE_LEVEL = 12  # the level search and the cumulative row
K4_POLAR_OPS = 150          # per cap particle: the six transcendentals and
#                             the plane arithmetic, at both call sites
K4_CASES = {"stock": dict(turbswitch=False, ifine=1, met_bf16=True),
            "turb_ifine4": dict(turbswitch=True, ifine=4, met_bf16=True),
            "f32_tables": dict(turbswitch=False, ifine=1, met_bf16=False)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def registers_by_entry(build_log: str) -> dict:
    """{kernel entry: registers} from nvcc's -Xptxas -v lines; a template
    instantiation is named by its bool arguments (advance_kernel<1,0,1>
    is BF16, not TS, POLAR)."""
    import re
    out, entry = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            base = re.search(r"\d([a-z][a-z_]*_kernel)", name)
            flags = re.findall(r"Lb([01])E", name)
            entry = (base.group(1) if base else name) \
                + (f"<{','.join(flags)}>" if flags else "")
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            out[entry] = int(m.group(1))
    return out


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_graph_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() in ms when ``reps`` calls are captured into
    one CUDA graph and replayed: for a kernel shorter than the host takes to
    launch it, which event timing around a Python loop cannot see."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(n_bytes), bound_operations=int(n_ops))


# ----------------------------------------------------------------- setup --

def met_fields(kind: str, grid, device, times=(0.0,)):
    """ZFields at each time, on one height grid taken from the first."""
    from flexpart_tpu_torch.met import calcpar, synthetic, verttransform
    met = (synthetic.SyntheticMet(grid) if kind == "synthetic"
           else synthetic.uniform_wind_met(grid, u=10.0, v=1.0))
    out, height = [], None
    for t in times:
        eta = met.fetch(t, device)
        if height is None:
            height = verttransform.compute_heights(grid, eta)
        out.append(calcpar.calcpar(grid, eta, verttransform.process_eta(
            grid, eta, height)))
    return out


def bench_particles(n: int, device, seed: int, old_fraction: float = 0.0):
    """bench.py's start: x in [30, 330], y in [30, 150], z in [10, 8000] m,
    all active, mass 1/n; drawn on the card from a torch.Generator."""
    import torch
    from flexpart_tpu_torch.core.state import empty_particles
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    p = empty_particles(n, device=device)
    itramem = torch.where(torch.rand(n, generator=gen, device=device)
                          < old_fraction, -10800, 0).to(torch.int32)
    return p.replace(x_hi=u(30.0, 330.0), y_hi=u(30.0, 150.0),
                     z=u(10.0, 8000.0),
                     active=torch.ones(n, dtype=torch.bool, device=device),
                     itra=torch.zeros(n, dtype=torch.int32, device=device),
                     itramem=itramem,
                     mass=torch.full((n, 1), 1.0 / n, device=device))


def edge_particles(n: int, device, seed: int, itime: int, hmix_at):
    """bench_particles with what the advance branches on: half the
    particles released at ``itime`` (fresh), 1/64 not scheduled, the first
    4096 spread along the poles and the date line, and a quarter moved
    below the local mixing height ``hmix_at(particles)`` so that every
    boundary-layer branch is taken."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    def u(lo, hi, m=n):
        return torch.rand(m, generator=gen, device=device) * (hi - lo) + lo

    x, y = p.x_hi.clone(), p.y_hi.clone()
    m = 1024
    y[0:m] = u(0.0, 0.02, m)                  # south pole
    y[m:2 * m] = u(179.98, 180.0, m)          # north pole
    x[2 * m:3 * m] = u(0.0, 0.01, m)          # date line, west side
    x[3 * m:4 * m] = u(359.99, 360.0, m)      # date line, east side
    fresh = u(0.0, 1.0) < 0.5
    p = p.replace(x_hi=x, y_hi=y)
    z = torch.where(u(0.0, 1.0) < 0.25, u(0.0, 1.0) * hmix_at(p), p.z)
    return p.replace(
        z=z, x_lo=u(-1e-6, 1e-6), y_lo=u(-1e-6, 1e-6),
        itramem=torch.where(fresh, itime, itime - 7200).to(torch.int32),
        itra=torch.full_like(p.itra, itime),
        up=u(-1.0, 1.0), vp=u(-1.0, 1.0), wp=u(-1.0, 1.0),
        usig=u(-0.3, 0.3), vsig=u(-0.3, 0.3), wsig=u(-0.01, 0.01),
        cbt=torch.where(u(0.0, 1.0) < 0.1, -1, 1).to(torch.int8),
        active=u(0.0, 1.0) >= 1.0 / 64)


def compare_particles(pk, pp, what: str, nxm: float) -> dict:
    """K4's particles against the plain advance's, by the K4_* tolerances.
    Positions are compared where both kept the particle (one that left the
    grid is dropped wherever it went), x as a distance on the cyclic axis."""
    import torch
    n = pk.capacity
    both = pk.active & pp.active
    ddx = (pk.x - pp.x).abs()
    dx = float(torch.minimum(ddx, nxm - ddx)[both].max())
    dy = float((pk.y - pp.y).abs()[both].max())
    check(dx <= K4_XY_ATOL and dy <= K4_XY_ATOL,
          f"{what}: x/y differ by {dx}/{dy}")
    dz = (pk.z - pp.z).abs()
    check(bool(torch.all(dz <= K4_Z_ATOL + K4_Z_RTOL * pp.z.abs())),
          f"{what}: z differs by {float(dz.max())}")
    dv = 0.0
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        d = (getattr(pk, f) - getattr(pp, f)).abs()
        check(bool(torch.all(d <= K4_V_ATOL + K4_V_RTOL * getattr(pp, f).abs())),
              f"{what}: {f} differs by {float(d.max())}")
        dv = max(dv, float(d.max()))
    check(torch.equal(pk.itra, pp.itra), f"{what}: itra differs")
    flags = {f: int((getattr(pk, f) != getattr(pp, f)).sum())
             for f in ("cbt", "active")}
    for f, c in flags.items():
        check(c <= K4_FLAG_SHARE * n, f"{what}: {f} differs for {c} of {n}")
    return dict(max_dx=dx, max_dy=dy, max_dz=float(dz.max()), max_dv=dv,
                cbt_differ=flags["cbt"], active_differ=flags["active"])


def check_same_bits(pa, pb, what: str, fields=None) -> None:
    """Bitwise equality of the named particle fields (default: the fields
    the advance writes)."""
    import torch
    from flexpart_tpu_torch.core.advance import OUT_FIELDS
    for f in fields or OUT_FIELDS:
        a, b = getattr(pa, f), getattr(pb, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"{what}: {f} differs in "
              f"{int((a != b).sum())} particles")


def sample_met(p, height, tables, cfg):
    """(h, tropop, ust, wst, ol, wind) at the particles, plain version."""
    from flexpart_tpu_torch.core import interp
    hw = interp.horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, dz1 = interp.vert_weights(p.z, height)
    return interp.sample_all_quad(tables, hw, indz, dz1, p.x, p.y,
                                  cfg.nx, cfg.ny)


# the branches of the advance that a comparison must have entered
K4_BRANCHES = ("fresh", "pbl", "neutral", "unstable", "stable",
               "unstable_zeta_lt_0.03", "unstable_zeta_lt_0.4",
               "unstable_zeta_lt_0.96", "unstable_zeta_ge_0.96",
               "tlw_z_lt_ol", "tlw_zeta_lt_0.1", "tlw_else", "reflected",
               "troposphere", "transition", "stratosphere", "unscheduled",
               "date_line_wrapped", "pole_mirrored")


def branch_counts(p, p_out, height, tables, cfg, itime: int) -> dict:
    """How many scheduled particles of ``p`` enter each branch of the
    advance, from the plain version's own predicates; ``p_out`` is the
    plain version's result (``reflected``: a boundary-layer particle whose
    last substep bounced off the ground or the mixing height;
    ``pole_mirrored``: x moved by half the globe; ``exited``, a handful of
    particles at most on a global grid, is reported and not required)."""
    import torch
    from flexpart_tpu_torch.core import hanna
    h, tropop, _, _, ol, _ = sample_met(p, height, tables, cfg)
    on = p.active
    pbl = on & ((p.z / h) <= 1.0)
    free = on & ~pbl
    neutral, unstable, stable = hanna._regimes(h, hanna._small_ol(ol))
    zeta = torch.clamp(p.z / h, 0.0, 1.0)
    un = pbl & unstable
    nxm = float(cfg.nx - 1)
    kept = on & p_out.active
    jump = (p_out.x - p.x).abs()
    cyclic = torch.minimum(jump, nxm - jump)
    masks = {
        "fresh": on & ((p.itramem == itime) | (itime == 0)),
        "pbl": pbl, "neutral": pbl & neutral, "unstable": un,
        "stable": pbl & stable,
        "unstable_zeta_lt_0.03": un & (zeta < 0.03),
        "unstable_zeta_lt_0.4": un & (zeta >= 0.03) & (zeta < 0.4),
        "unstable_zeta_lt_0.96": un & (zeta >= 0.4) & (zeta < 0.96),
        "unstable_zeta_ge_0.96": un & (zeta >= 0.96),
        "tlw_z_lt_ol": un & (p.z < ol.abs()),
        "tlw_zeta_lt_0.1": un & (p.z >= ol.abs()) & (zeta < 0.1),
        "tlw_else": un & (p.z >= ol.abs()) & (zeta >= 0.1),
        "reflected": pbl & (p_out.cbt == -1),
        "troposphere": free & (p.z < tropop),
        "transition": free & (p.z >= tropop) & (p.z < tropop + 1000.0),
        "stratosphere": free & (p.z >= tropop + 1000.0),
        "unscheduled": ~on,
        "date_line_wrapped": kept & (jump > 0.75 * nxm),
        "pole_mirrored": kept & (cyclic > 0.25 * nxm),
        "exited": on & ~p_out.active,
    }
    return {k: int(v.sum()) for k, v in masks.items()}


def unique_rows(p, height, cfg) -> int:
    """Table rows that the particles' cells name (each needs reading once)."""
    import torch
    from flexpart_tpu_torch.core import interp
    hw = interp.horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, _ = interp.vert_weights(p.z, height)
    rows = interp._cell_rowid(hw, indz, cfg.nx, cfg.ny)[p.active]
    return int(torch.unique(rows).numel())


def step_setup(grid, **cfg_kw):
    from flexpart_tpu_torch.config import OutGrid
    from flexpart_tpu_torch.core.advance import StepConfig, StepParams
    from flexpart_tpu_torch.grid.conccalc import ConcConfig
    from flexpart_tpu_torch.grid.outgrid import OutputGridGeometry
    kw = {**K4_CASES["stock"], **cfg_kw}
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                     ldirect=1, method=0, **kw)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=1.0 / kw["ifine"])
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720, numygrid=360,
                 dxout=0.5, dyout=0.5, outheights=(100.0, 1000.0, 50000.0))
    geo = OutputGridGeometry(og, grid)
    ccfg = ConcConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg, npointspec=1,
                      nclassunc=1, nage=1, dxout=og.dxout, dyout=og.dyout,
                      xoutshift=geo.xoutshift, youtshift=geo.youtshift,
                      dx_met=grid.dx, dy_met=grid.dy, ind_samp=0)
    return cfg, prm, og, geo, ccfg


# ---------------------------------------------------------------- phases --

def phase_kernels(device, grid) -> dict:
    """Each kernel against its plain twin at the main path's shapes."""
    import torch
    from flexpart_tpu_torch.core import interp, reorder, rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    res = {}

    # K1: (6, 2**19) draws, a chunk of the main path (tag 6), at an offset
    rows, cols = K1_SHAPE
    key = rng.Key(1234, 5)
    k0, k1 = key.philox_key(6)
    off = 3 * cols
    zk = rng.normals_cuda(rows, cols, k0, k1, off, device)
    zp = rng.normals_plain(rows, cols, k0, k1, off, device)
    err = float((zk - zp).abs().max())
    check(err <= K1_ATOL, f"K1 vs twin max abs err {err} > {K1_ATOL}")
    a = rng.normals(key, (8, 4096), 5, device=device)
    b = rng.normals(key, (8, 4096), 5, device=device)
    c = rng.normals(key, (8, 4096), 6, device=device)
    check(torch.equal(a, b), "K1 not deterministic")
    check(not torch.equal(a, c), "K1 tags do not separate streams")
    check(float(zk.abs().max()) <= 3.0, "K1 draws exceed the +-3 clip")
    mean, std = float(a.mean()), float(a.std())
    check(abs(mean) < 0.02 and abs(std - 1.0) < 0.02,
          f"K1 moments mean={mean} std={std}")
    for r in (1, 2, 3, 5):        # the last Philox call of a column, cut short
        check(torch.equal(rng.normals_cuda(r, 4096, k0, k1, off, device),
                          zk[:r, :4096]), f"K1 ({r}, n) is not rows 0-{r - 1}")

    def kernel():
        return rng.normals_cuda(rows, cols, k0, k1, off, device)

    def library():
        return torch.randn(K1_SHAPE, device=device).clamp_(-3.0, 3.0)

    ms = cuda_graph_ms(kernel)
    library_ms = cuda_graph_ms(library)
    plain_ms = cuda_ms(lambda: rng.normals_plain(rows, cols, k0, k1, off,
                                                 device), 5)
    res["normals"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, mean=mean, std=std,
                          ms_with_launch=cuda_ms(kernel, 50),
                          library_ms_with_launch=cuda_ms(library, 50),
                          **bound(4 * rows * cols,
                                  K1_OPS_PER_DRAW * rows * cols))

    # K2: the step tables at the bench grid, f32 and bf16, bitwise
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    tw = (0.3, 0.7, 0.21666666865348816, 0.7833333611488342)
    f3d0, f2d0, f3d1, f2d1 = z0.f3d, z0.f2d, z1.f3d, z1.f2d
    times = {}
    k2_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tk = interp.quad_tables_cuda(f3d0, f3d1, f2d0, f2d1, *tw, dt)
        tp = interp.quad_tables_plain(f3d0, f3d1, f2d0, f2d1, *tw, dt)
        for name in ("rows", "rowsE"):
            x, y = getattr(tk, name), getattr(tp, name)
            check(x.shape == y.shape == ((grid.nlev - 1) * grid.ny * grid.nx,
                                         64 if name == "rows" else 32),
                  f"K2 {name} shape {x.shape}")
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            diff = x.view(bits) != y.view(bits)
            lanes = torch.nonzero(diff.any(dim=0)).flatten().tolist()
            err = float((x.float() - y.float()).abs().max())
            k2_err = max(k2_err, err)
            check(not lanes, f"K2 {name} {dt} differs from the twin in lanes "
                  f"{lanes}: {int(diff.sum())} values, max abs {err}")
        del tk, tp
        times[dt] = (cuda_ms(lambda: interp.quad_tables_cuda(
            f3d0, f3d1, f2d0, f2d1, *tw, dt), 10),
            cuda_ms(lambda: interp.quad_tables_plain(
                f3d0, f3d1, f2d0, f2d1, *tw, dt), 3))
    # 5 wind fields and 5 surface fields of two times in, the bf16 tables
    # out: 64 lanes of rows and 32 of rowsE per cell
    n_rows = (grid.nlev - 1) * grid.ny * grid.nx
    k2_in = 2 * 4 * (5 * grid.nlev + 5) * grid.ny * grid.nx
    res["quad_tables"] = dict(max_abs_err=k2_err, ms=times[torch.bfloat16][0],
                              plain_ms=times[torch.bfloat16][1],
                              library_ms=None,
                              f32_ms=times[torch.float32][0],
                              f32_plain_ms=times[torch.float32][1],
                              **bound(k2_in + 2 * (64 + 32) * n_rows,
                                      K2_OPS_PER_LANE * (64 + 32) * n_rows))
    height = z0.height
    del z0, z1

    # K3: sampling of 10 x 2**20 particles: both paths, on an unordered and
    # on a cell-ordered ensemble, all particles old enough for the 4-point
    # kernel and half of them.  Float atomics, now after per-warp sums,
    # order the additions differently in every run: hence a relative
    # tolerance.
    cfg, _, og, geo, ccfg = step_setup(grid)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    gk = zero_accumulators(geo, 1, 1, device=device).gridunc
    gp = torch.zeros_like(gk)
    grid_rows = gk.numel()
    warp = torch.arange(N_MAIN, device=device) // cc.K3_GROUP
    worst = 0.0
    k3 = {}
    for old in (1.0, 0.5):
        p = bench_particles(N_MAIN, device, seed=7, old_fraction=old)
        p = p.replace(itra=torch.full_like(p.itra, 14400),
                      itramem=p.itramem + 14400 - 3600)
        for order in ("unordered", "ordered"):
            if order == "ordered":
                p = reorder.reorder_by_cell_cuda(p, height, cfg)[0]
            for kp in (False, True):
                c = ccfg.replace(kernel_possible=kp)
                args = (p, 14400, lage, oh, 1.0, None, c)
                what = (f"K3 {'4-point' if kp else 'single-index'} path, "
                        f"{order}, {old} old")
                gk.zero_()
                gp.zero_()
                cc.conccalc_cuda(gk.view(-1, 1), *args)
                cc.conccalc_plain(gp.view(-1, 1), *args)
                d = (gk - gp).abs()
                worst = max(worst, float(d.max()))
                check(bool(torch.all(d <= K3_RTOL * gp.abs())),
                      f"{what} exceeds rtol {K3_RTOL}: max rel "
                      f"{float((d / gp.abs().clamp(min=1e-30)).max())}")
                check(abs(float(gk.sum()) - float(gp.sum()))
                      <= 1e-5 * float(gp.sum()), f"{what}: total differs")
                # the global atomics: one per pair without the per-warp
                # sums, one per distinct (warp, target) with them
                lin, valid, _ = cc.conccalc_pairs(grid_rows, *args)
                pairs = (warp[:, None] * grid_rows + lin)[valid]
                case = dict(
                    pairs=int(pairs.numel()),
                    warp_target_pairs=int(torch.unique(pairs).numel()))
                del lin, valid, pairs
                check(0 < case["warp_target_pairs"] <= case["pairs"],
                      f"{what}: {case} pairs")
                case.update(
                    ms=cuda_ms(lambda: cc.conccalc_cuda(gk.view(-1, 1), *args),
                               10),
                    plain_ms=cuda_ms(lambda: cc.conccalc_plain(
                        gp.view(-1, 1), *args), 3))
                k3[f"{'kernel' if kp else 'single'}_{order}_"
                   f"{'all' if old == 1.0 else 'half'}_old"] = case
    # the main path's steady step: the 4-point path on ordered, old particles.
    # 41 B of particle state in, the grid read and written once (atomics
    # on top are not counted)
    steady = k3["kernel_ordered_all_old"]
    res["conccalc"] = dict(max_abs_err=worst, ms=steady["ms"],
                           plain_ms=steady["plain_ms"], library_ms=None,
                           cases=k3,
                           **bound(41 * N_MAIN + 2 * 4 * gk.numel(),
                                   K3_OPS_PER_PARTICLE * N_MAIN))
    del p, gk, gp, warp
    torch.cuda.empty_cache()
    res["advance"] = kernel_advance(device, grid)
    torch.cuda.empty_cache()
    res["reorder"] = kernel_reorder(device, grid)
    torch.cuda.empty_cache()
    res["advance"]["polar"] = kernel_advance_polar(device, grid)
    torch.cuda.empty_cache()
    res["convection"], res["redist"] = kernel_convection(device, grid)
    return res


def kernel_advance(device, grid) -> dict:
    """K4 against the plain advance on the card: three configurations at
    one 2**19 chunk of edge_particles with injected draws, each required
    to enter every branch of the advance; then the main path's
    configuration at the main path's shape, each side making its own draws
    from the same key (K4 in registers, the plain version through the
    normals kernel).  K4's time is taken on the ensemble in cell order, as
    the main path keeps it, and also on the unordered ensemble, on
    injected draws, on the same particles sorted by height and on none
    scheduled (a plain copy)."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 4)
    nxm = float(grid.nx - 1)

    def setup(**kw):
        cfg, prm, *_ = step_setup(grid, **kw)
        tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(z0, z1, *tw,
                                               dtype=cfg.table_dtype)
        a = advance.advance_args(cfg, prm, itime, 0, mem1)

        def runs(p, draws, offset):
            args = (p, z0.height, tables, a, key, cfg)
            return (lambda: advance.advance_all_cuda(*args, draws, offset),
                    lambda: advance.advance_all_plain(*args, draws, offset),
                    lambda: advance.advance_all_cuda(*args, None, offset))
        return cfg, tables, runs

    def make_draws(cfg, n, offset):
        return {tag: rng.normals(key, (rows, n), tag, offset, device=device)
                for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}

    res = {"cases": {}}
    offset = 5 * CHUNK
    for name, kw in K4_CASES.items():
        cfg, tables, runs = setup(**kw)
        p = edge_particles(CHUNK, device, 21, itime, lambda q: sample_met(
            q, z0.height, tables, cfg)[0])
        draws = make_draws(cfg, CHUNK, offset)
        kernel, plain, in_registers = runs(p, draws, offset)
        (pk, dk), (pp, dp) = kernel(), plain()
        torch.cuda.synchronize()
        case = compare_particles(pk, pp, f"K4 {name}", nxm)
        for f in ("n_active", "n_exited"):
            check(abs(int(getattr(dk, f)) - int(getattr(dp, f)))
                  <= K4_FLAG_SHARE * CHUNK, f"K4 {name}: {f} differs")
        check_same_bits(in_registers()[0], pk,
                        f"K4 {name}: draws in registers vs injected")
        branches = branch_counts(p, pp, z0.height, tables, cfg, itime)
        for b in K4_BRANCHES:
            check(branches[b] > 0,
                  f"K4 {name}: no test particle enters branch {b}")
        case.update(n_active=int(dk.n_active), n_exited=int(dk.n_exited),
                    branches=branches,
                    ms=cuda_ms(in_registers, 20), plain_ms=cuda_ms(plain, 3))
        res["cases"][name] = case
        del p, draws, pk, pp, kernel, plain, in_registers, runs, tables
        torch.cuda.empty_cache()

    cfg, tables, runs = setup()
    p = bench_particles(N_MAIN, device, seed=3, old_fraction=1.0)  # steady
    _, plain, in_registers = runs(p, None, 0)
    (pk, _), (pp, _) = in_registers(), plain()
    torch.cuda.synchronize()
    full = compare_particles(pk, pp, "K4 at the main path's shape", nxm)
    # 54 B of state in, 50 B out, each table row that a particle's cell
    # names read once (128 B of the start table, 48 B of the end table)
    row_b = 128 if cfg.met_bf16 else 256
    rows0 = unique_rows(p, z0.height, cfg)
    rows1 = unique_rows(pk, z0.height, cfg)
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    res.update(full, n=N_MAIN, unique_rows=rows0, unique_rows_end=rows1,
               max_abs_err=max(full["max_dx"], full["max_dy"]),
               branches=branch_counts(p, pp, z0.height, tables, cfg, itime),
               ms=cuda_ms(runs(ordered, None, 0)[2], 10),
               unordered_ms=cuda_ms(in_registers, 10),
               plain_ms=cuda_ms(plain, 2),
               library_ms=None,
               **bound(104 * N_MAIN + row_b * rows0 + row_b * 3 // 8 * rows1,
                       K4_OPS_PER_PARTICLE * N_MAIN))
    del pk, pp, plain, ordered
    # where K4's time goes on the unordered ensemble: the same launch
    # without the generator, with neighbouring threads gathering
    # neighbouring rows, and with no work
    res["injected_draws_ms"] = cuda_ms(
        runs(p, make_draws(cfg, N_MAIN, 0), 0)[0], 10)
    torch.cuda.empty_cache()
    res["sorted_by_z_ms"] = cuda_ms(
        runs(p.replace(z=torch.sort(p.z).values), None, 0)[2], 10)
    res["none_scheduled_ms"] = cuda_ms(
        runs(p.replace(active=torch.zeros_like(p.active)), None, 0)[2], 10)
    return res


def sphere_particles(n: int, device, seed: int, itime: int, nx: int,
                     ny: int):
    """bench_particles spread over the whole sphere: x in [0, nx - 1), y in
    [0, ny - 1], a quarter released at ``itime`` (fresh), the first
    2**16 within 0.15 degrees of a pole (half north, half south), a
    quarter of those within 0.01 degrees, so that some cross it within a
    step."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)

    def u(lo, hi, m=n):
        return torch.rand(m, generator=gen, device=device) * (hi - lo) + lo

    y = u(0.0, ny - 1.0)
    m = 2 ** 15
    y[:m] = u(ny - 1.15, ny - 1.0, m)
    y[m:2 * m] = u(0.0, 0.15, m)
    # a kilometre from the pole, where a step's turbulence carries across
    y[:m // 4] = u(ny - 1.01, ny - 1.0, m // 4)
    y[m:m + m // 4] = u(0.0, 0.01, m // 4)
    fresh = u(0.0, 1.0) < 0.25
    return p.replace(x_hi=u(0.0, nx - 1.0), y_hi=y,
                     itramem=torch.where(fresh, itime, itime - 7200)
                     .to(torch.int32),
                     itra=torch.full_like(p.itra, itime))


def kernel_advance_polar(device, grid) -> dict:
    """K4's POLAR instantiation against the plain advance on 10 x 2**20
    particles over the whole sphere, both caps included, with injected
    draws; with its draws made in registers against itself fed K1's,
    bitwise.  The particles in the north cap, in the south cap and those
    that cross a pole within the step must be > 0.  Timed unordered and
    in cell order, beside the stock instantiation on the same particles."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 6)
    nxm = float(grid.nx - 1)
    cfg, prm, *_ = step_setup(grid, polar=True)
    stock = step_setup(grid)[0]
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    a_stock = advance.advance_args(stock, prm, itime, 0, mem1)
    check(a.polar == 1 and a_stock.polar == 0, "K4 polar: polar flags")
    p = sphere_particles(N_MAIN, device, 31, itime, grid.nx, grid.ny)
    draws = {tag: rng.normals(key, (rows, N_MAIN), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}

    def run(q, d, args=a, c=cfg):
        return advance.advance_all_cuda(q, z0.height, tables, args, key, c,
                                        d, 0)

    (pk, dk) = run(p, draws)
    (pp, dp) = advance.advance_all_plain(p, z0.height, tables, a, key, cfg,
                                         draws, 0)
    torch.cuda.synchronize()
    res = compare_particles(pk, pp, "K4 POLAR", nxm)
    for f in ("n_active", "n_exited"):
        check(abs(int(getattr(dk, f)) - int(getattr(dp, f)))
              <= K4_FLAG_SHARE * N_MAIN, f"K4 POLAR: {f} differs")
    check_same_bits(run(p, None)[0], pk,
                    "K4 POLAR: draws in registers vs injected")
    bitwise = all(torch.equal(getattr(pk, f), getattr(pp, f))
                  for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z"))
    lat = grid.ylat0 + p.y * grid.dy
    north, south = p.active & (lat > 75.0), p.active & (lat < -75.0)
    jump = (pp.x - p.x).abs()
    crossed = (north | south) & pp.active & (torch.minimum(jump, nxm - jump)
                                             > 0.25 * nxm)
    counts = dict(north_cap=int(north.sum()), south_cap=int(south.sum()),
                  pole_crossings=int(crossed.sum()),
                  exited=int((p.active & ~pp.active).sum()))
    for b in ("north_cap", "south_cap", "pole_crossings"):
        check(counts[b] > 0, f"K4 POLAR: no test particle enters {b}")
    n_cap = counts["north_cap"] + counts["south_cap"]
    row_b = 128 if cfg.met_bf16 else 256
    rows0 = unique_rows(p, z0.height, cfg)
    rows1 = unique_rows(pk, z0.height, cfg)
    del pk, pp, draws
    torch.cuda.empty_cache()
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    res.update(
        bitwise=bitwise, branches=counts, n=N_MAIN, library_ms=None,
        max_abs_err=max(res["max_dx"], res["max_dy"]),
        ms=cuda_ms(lambda: run(ordered, None), 10),
        unordered_ms=cuda_ms(lambda: run(p, None), 10),
        stock_ms_same_particles=cuda_ms(
            lambda: run(ordered, None, a_stock, stock), 10),
        plain_ms=cuda_ms(lambda: advance.advance_all_plain(
            p, z0.height, tables, a, key, cfg, None, 0), 2),
        **bound(104 * N_MAIN + row_b * rows0 + row_b * 3 // 8 * rows1,
                K4_OPS_PER_PARTICLE * N_MAIN + K4_POLAR_OPS * n_cap))
    return res


def sounding_eta(grid, device):
    """The moist-unstable sounding of tests/test_convection.py::_soundings
    at every column of ``grid``, on the grid's own eta levels at ps =
    101325 Pa: T falls 6.5 K/km from 300 K (floor 200 K) with z = -7500 m
    ln(p/ps), q = 0.92 q_sat(p, T) exp(-z / 3000 m) with the port's
    f_qvsat; tt2 = 302 K, td2 = 300 K.  Returns the (ps, tth, qvh, tt2,
    td2) tensors K6 takes."""
    import numpy as np
    import torch
    from flexpart_tpu_torch.met.thermo import f_qvsat
    ps = 101325.0
    p = np.asarray(grid.akz) + np.asarray(grid.bkz) * ps
    z = -7500.0 * np.log(np.maximum(p, 1.0) / ps)
    t = np.maximum(300.0 - 6.5e-3 * z, 200.0)
    qsat = f_qvsat(torch.as_tensor(p), torch.as_tensor(t)).numpy()
    q = 0.92 * qsat * np.exp(-z / 3000.0)
    shape = (grid.ny, grid.nx)

    def col(v):
        return torch.as_tensor(np.asarray(v, np.float32)[:, None, None]
                               .repeat(grid.ny, 1).repeat(grid.nx, 2),
                               device=device).contiguous()

    def flat(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return (flat(ps), col(t), col(q), flat(302.0), flat(300.0))


def check_convection(kern, fields, cbmf, what: str, tw=CONV_TW) -> tuple:
    """K6 against its plain pipeline on the same fields and time weights:
    (kernel's outputs, plain outputs, the comparison)."""
    import torch
    from flexpart_tpu_torch.physics import convection as cv
    k = cv.convection_cuda(kern, fields, *tw, cbmf, float(LSYNC))
    p = cv.convection_plain(kern, fields, *tw, cbmf, float(LSYNC))
    torch.cuda.synchronize()
    worst, differ = 0.0, 0
    for f in cv.ConvectionFields._fields:
        a, b = getattr(k, f), getattr(p, f)
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: K6 {f} is {a.dtype} {tuple(a.shape)}")
        if not b.dtype.is_floating_point:
            n = int((a != b).sum())
            check(n == 0, f"{what}: K6 {f} differs in {n} columns")
            continue
        d = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f"{what}: K6 {f} not finite")
        tol = K6_SHARE * float(b.abs().max())
        check(bool(torch.all(d <= tol)),
              f"{what}: K6 {f} differs by {float(d.max())} > {tol}")
        worst = max(worst, float(d.max()))
        differ += int((a != b).sum())
    return k, p, dict(max_abs_err=worst, values_differ=differ,
                      convecting_columns=int(k.lconv.sum()),
                      columns=int(k.lconv.numel()))


def redist_args(conv, kern, grid, itime: int = 0) -> tuple:
    """The arguments of redist_cuda / redist_plain after the key."""
    return (conv.fmassfrac, conv.rlevmass, conv.phconv, conv.sub,
            conv.uvzlev, conv.pconv, conv.tconv, conv.lconv, LSYNC, itime,
            kern.nl, grid.nx, grid.ny)


def check_redist(p, key, conv, kern, grid, rn, what: str,
                 itime: int = 0) -> dict:
    """K7 against redist_plain on the same particles and matrices:
    z bitwise and the moved counts equal.  Both sum each cumulative row in
    level order and spell every operation alike, so any difference is a
    fault (a level is chosen by a comparison: one ulp in a cumulative
    fraction moves a particle to another level)."""
    import torch
    from flexpart_tpu_torch.physics import convection as cv
    args = redist_args(conv, kern, grid, itime)
    qk, mk = cv.redist_cuda(p, key, *args, rn=rn)
    qp, mp = cv.redist_plain(p, key, *args, rn=rn)
    torch.cuda.synchronize()
    n = p.capacity
    d = (qk.z - qp.z).abs()
    differ = int((qk.z.view(torch.int32) != qp.z.view(torch.int32)).sum())
    check(differ == 0, f"{what}: K7 z differs from the plain version's for "
          f"{differ} of {n} particles, by up to {float(d.max())} m")
    check(int(mk) == int(mp),
          f"{what}: K7 moved {int(mk)}, the plain version {int(mp)}")
    check(bool(torch.isfinite(qk.z).all()), f"{what}: K7 z not finite")
    return dict(moved=int(mk), plain_moved=int(mp), z_differ=differ,
                max_abs_err=float(d.max()))


def k7_bound(p, conv, kern, grid, itime: int = 0) -> dict:
    """K7's least time on these inputs: the particle state read (25 B) and
    z written (4 B) once, the flags of every column once, and, for the
    particles that convection may move (scheduled, in a convecting
    column), each distinct column's profiles and each distinct matrix row
    once."""
    import torch
    L1 = kern.L1
    ix = torch.clamp(torch.round(p.x).long(), 0, grid.nx - 1)
    jy = torch.clamp(torch.round(p.y).long(), 0, grid.ny - 1)
    col = jy * grid.nx + ix
    live = p.active & (p.itra == itime) & conv.lconv[col]
    uvz = conv.uvzlev[col[live]]
    lev = torch.clamp((uvz[:, 1:L1] < p.z[live][:, None]).sum(1), 0, L1 - 1)
    cols = int(torch.unique(col[live]).numel())
    rows = int(torch.unique(col[live] * L1 + lev).numel())
    n_bytes = (29 * p.capacity + conv.lconv.numel()
               + cols * 4 * (2 * (L1 + 1) + 5 * L1) + rows * 4 * L1)
    n_ops = K7_OPS_PER_PARTICLE * p.capacity \
        + K7_OPS_PER_LIVE_LEVEL * L1 * int(live.sum())
    return dict(live=int(live.sum()), live_columns=cols, **bound(n_bytes,
                                                                 n_ops))


def kernel_convection(device, grid) -> tuple[dict, dict]:
    """K6 and K7 against their plain versions at full width.  K6 on two
    cases of the bench grid, each through CONV_SPINUP steps of the
    cloud-base mass flux feedback, compared at every step: SyntheticMet's
    two met times (about a sixth of the columns convect), and the
    moist-unstable sounding at every column (all convect, every branch of
    the scheme is entered).  K7 on 10 x 2**20 particles against the
    matrices of both cases, with injected uniforms and with its own; the
    sounding case must move particles."""
    import torch
    from flexpart_tpu_torch.core import rng
    from flexpart_tpu_torch.met import synthetic
    from flexpart_tpu_torch.physics import convection as cv
    kern = cv.make_convection_kernel(grid)
    C, L1 = grid.nx * grid.ny, kern.L1
    met = synthetic.SyntheticMet(grid)
    eta = ("ps", "tth", "qvh", "tt2", "td2")
    e0, e1 = (met.fetch(t, device) for t in (0.0, 3600.0))
    sound = sounding_eta(grid, device)
    cases = {"synthetic": tuple(getattr(e0, n) for n in eta)
             + tuple(getattr(e1, n) for n in eta),
             "sounding": sound + sound}
    del e0, e1
    k6, k7, last = {}, {}, {}
    for name, fields in cases.items():
        cbmf = torch.zeros(C, dtype=torch.float32, device=device)
        steps = []
        for s in range(CONV_SPINUP):
            k, p, cmp_ = check_convection(kern, fields, cbmf,
                                          f"K6 {name} step {s}")
            steps.append(cmp_)
            cbmf = p.cbmf
        last[name] = (k, cbmf)
        k6[name] = dict(
            steps=steps, convecting_columns=steps[-1]["convecting_columns"],
            max_abs_err=max(c["max_abs_err"] for c in steps),
            values_differ=sum(c["values_differ"] for c in steps),
            nctop_max=int(k.nctop.max()),
            ms=cuda_ms(lambda: cv.convection_cuda(kern, fields, *CONV_TW,
                                                  cbmf, float(LSYNC)), 10),
            plain_ms=cuda_ms(lambda: cv.convection_plain(
                kern, fields, *CONV_TW, cbmf, float(LSYNC)), 2))
        del k, p
    check(k6["synthetic"]["convecting_columns"] > 0,
          "K6: no column of SyntheticMet convects")
    check(k6["sounding"]["convecting_columns"] == C,
          f"K6: {k6['sounding']['convecting_columns']} of {C} columns "
          "convect on the moist-unstable sounding")
    # in: per column and met time the L1 profile levels of tth and qvh and
    # ps, tt2, td2, then cbmf, and the grid's coefficients (akz, bkz at L1
    # levels, akm, bkm at L1 + 1); out: fmassfrac, four profiles of L1, two
    # of L1 + 1, cbmf, nctop and the flags
    k6_bytes = 4 * C * (2 * (2 * L1 + 3) + 1) + 4 * (4 * L1 + 2) \
        + C * (4 * (L1 * L1 + 4 * L1 + 2 * (L1 + 1) + 2) + 1)
    conv_res = dict(
        nl=kern.nl, L1=L1, columns=C, cases=k6, library_ms=None,
        library="none",
        max_abs_err=max(c["max_abs_err"] for c in k6.values()),
        ms=k6["synthetic"]["ms"], plain_ms=k6["synthetic"]["plain_ms"],
        all_convecting_ms=k6["sounding"]["ms"],
        **bound(k6_bytes, k6_ops_per_column(L1) * C))

    p = bench_particles(N_MAIN, device, seed=13)
    key = rng.Key(4321, 7)
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    rn = torch.rand(N_MAIN, generator=gen, device=device)
    for name, (conv, _) in last.items():
        case = {}
        for draw, u in (("injected", rn), ("in_registers", None)):
            case[draw] = check_redist(p, key, conv, kern, grid, u,
                                      f"K7 {name}, {draw} uniforms")
        args = redist_args(conv, kern, grid)
        case.update(
            k7_bound(p, conv, kern, grid),
            ms=cuda_ms(lambda: cv.redist_cuda(p, key, *args), 10),
            plain_ms=cuda_ms(lambda: cv.redist_plain(p, key, *args), 2))
        k7[name] = case
    check(k7["sounding"]["in_registers"]["moved"] > 0
          and k7["sounding"]["injected"]["moved"] > 0,
          "K7: no particle moved on the convecting case")
    steady = k7["synthetic"]
    redist_res = dict(
        n=N_MAIN, cases=k7, library_ms=None, library="none",
        max_abs_err=max(c[d]["max_abs_err"] for c in k7.values()
                        for d in ("injected", "in_registers")),
        moved=k7["sounding"]["in_registers"]["moved"],
        ms=steady["ms"], plain_ms=steady["plain_ms"],
        all_convecting_ms=k7["sounding"]["ms"],
        **{f: steady[f] for f in ("bound_ms", "bound_by", "bound_bytes",
                                  "bound_operations")})
    return conv_res, redist_res


def check_sorted(p, q, perm, height, cfg, what: str) -> None:
    """The cell-order sort's contract: ``perm`` is the stable argsort of the
    cell keys, bitwise (so it names every slot once, the keys of ``q`` never
    decrease, equal keys keep their slot order and the particles that are
    not scheduled come last), and every field of ``q`` is ``p[perm]``
    bitwise."""
    import torch
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.core.state import FIELDS
    n = p.capacity
    check(perm.shape == (n,) and perm.dtype == torch.int32,
          f"{what}: perm is {perm.dtype} {tuple(perm.shape)}")
    want = torch.argsort(reorder.cell_keys(p, height, cfg), stable=True)
    differ = int((perm.long() != want).sum())
    check(differ == 0, f"{what}: perm differs from the stable argsort of the "
          f"keys in {differ} of {n} slots")
    check_same_bits(q, reorder.apply_perm(p, want), f"{what}: out vs in[perm]",
                    FIELDS)
    n_on = int(p.active.sum())
    check(bool(q.active[:n_on].all()) and not bool(q.active[n_on:].any()),
          f"{what}: unscheduled particles are not last")


def release_step_particles(n: int, n_fresh: int, device, seed: int):
    """What the sort meets on a release step: ``n_fresh`` particles just
    woken inside a 2 x 2 degree box, in the last slots (a schedule is built
    in box order), and every other slot not scheduled yet."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)

    def u(lo, hi):
        return torch.rand(n_fresh, generator=gen, device=device) * (hi - lo) + lo

    x, y, z = p.x_hi.clone(), p.y_hi.clone(), p.z.clone()
    x[n - n_fresh:] = u(180.0, 182.0)
    y[n - n_fresh:] = u(130.0, 132.0)
    z[n - n_fresh:] = u(50.0, 500.0)
    active = torch.zeros_like(p.active)
    active[n - n_fresh:] = True
    return p.replace(x_hi=x, y_hi=y, z=z, active=active)


def kernel_reorder(device, grid) -> dict:
    """K5 against its plain version on the card.  At one 2**19 chunk of
    edge_particles (1/64 not scheduled): K4 on K5's output with the injected
    draws permuted alike must equal K4 on the unordered input, permuted,
    bitwise.  At the main path's shape, on four inputs (the shuffled
    ensemble; the main path's, REORDER_EVERY steps after a sort; every slot
    unscheduled; a release step): ``perm`` must equal the stable argsort of
    the keys and every field the plain version's, bitwise, and a second
    launch must give the same ``perm``; each input is timed beside the
    plain version, ``torch.argsort`` of its keys, and its bound."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.core.state import FIELDS
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    cfg, prm, *_ = step_setup(grid)
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    key = rng.Key(4321, 4)
    height = z0.height

    def k4(p, draws=None, k=key):
        return advance.advance_all_cuda(p, height, tables, a, k, cfg, draws, 0)[0]

    p = edge_particles(CHUNK, device, 21, itime, lambda q: sample_met(
        q, height, tables, cfg)[0])
    q, perm = reorder.reorder_by_cell_cuda(p, height, cfg)
    torch.cuda.synchronize()
    check_sorted(p, q, perm, height, cfg, "K5 edge particles")
    draws = {tag: rng.normals(key, (rows, CHUNK), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}
    idx = perm.long()
    draws_q = {t: d[:, idx].contiguous() for t, d in draws.items()}
    check_same_bits(k4(q, draws_q), reorder.apply_perm(k4(p, draws), perm),
                    "K4 on K5's output vs K4 on the unordered input, permuted")
    n_unscheduled = int((~p.active).sum())
    del p, q, draws, draws_q
    torch.cuda.empty_cache()

    # every field read once and written once, perm written; the pairs and
    # the digit counts are scratch.  On a shuffled ensemble every field of a
    # particle comes from a 32 B sector of its own.
    shuffled = bench_particles(N_MAIN, device, seed=3, old_fraction=1.0)
    widths = [getattr(shuffled, f)[0].numel() * getattr(shuffled, f).element_size()
              for f in FIELDS]
    n_bytes = (2 * sum(widths) + 4) * N_MAIN + 4 * grid.nlev
    sector_bytes = (sum(32 * -(-w // 32) for w in widths) + sum(widths) + 4) \
        * N_MAIN
    ordered = reorder.reorder_by_cell_cuda(shuffled, height, cfg)[0]
    for s in range(reorder.REORDER_EVERY):
        ordered = k4(ordered, k=rng.Key(4321, 10 + s))
    inputs = {
        "shuffled": shuffled,
        "ordered": ordered,
        "all_unscheduled": shuffled.replace(
            active=torch.zeros_like(shuffled.active)),
        "release_step": release_step_particles(N_MAIN, N_STEP4, device, 3),
    }
    del shuffled, ordered
    cases = {}
    for name, p in inputs.items():
        what = f"K5 at the main path's shape, {name}"
        q, perm = reorder.reorder_by_cell_cuda(p, height, cfg)
        check_sorted(p, q, perm, height, cfg, what)
        q_plain, perm_plain = reorder.reorder_by_cell_plain(p, height, cfg)
        check(torch.equal(perm, perm_plain), f"{what}: perm vs the plain version's")
        check_same_bits(q, q_plain, f"{what}: fields vs the plain version's",
                        FIELDS)
        del q, q_plain, perm_plain
        check(torch.equal(reorder.reorder_by_cell_cuda(p, height, cfg)[1], perm),
              f"{what}: two launches give different perms")
        keys = reorder.cell_keys(p, height, cfg)
        cases[name] = dict(
            scheduled=int(p.active.sum()),
            occupied_bins=int(torch.unique(keys).numel()),
            slots_moved_share=float((perm != torch.arange(
                N_MAIN, dtype=torch.int32, device=device)).float().mean()),
            ms=cuda_ms(lambda: reorder.reorder_by_cell_cuda(p, height, cfg), 5),
            plain_ms=cuda_ms(lambda: reorder.reorder_by_cell_plain(
                p, height, cfg), 2),
            library_ms=cuda_ms(lambda: torch.argsort(keys, stable=True), 3),
            **bound(n_bytes, K5_OPS_PER_PARTICLE * N_MAIN))
        del keys, perm
        torch.cuda.empty_cache()
    cases["shuffled"]["sector_bound_ms"] = sector_bytes / HBM_BYTES_PER_S * 1e3
    steady = cases["ordered"]
    return dict(
        max_abs_err=0.0, n=N_MAIN, steps_after_sort=reorder.REORDER_EVERY,
        edge_unscheduled=n_unscheduled, cases=cases,
        **{f: steady[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "bound_bytes",
                                  "bound_operations", "slots_moved_share")},
        shuffled_ms=cases["shuffled"]["ms"])


def phase_reorder(device, grid) -> dict:
    """What the cell order is worth and how fast it decays.  On SyntheticMet
    and on the main path's uniform wind: K4 and K3 (4-point path) on the
    unordered bench ensemble, then right after a sort and after each of
    DECAY_STEPS further steps, K5 on the shuffled ensemble and 0 and each of
    SORT_INTERVALS steps after a sort; from these the device time of K4 +
    K3 + K5 per step for a sort every 1, 2, ... 64 steps."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, prm, og, geo, ccfg = step_setup(grid)
    ccfg = ccfg.replace(kernel_possible=True)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    flat = zero_accumulators(geo, 1, 1, device=device).gridunc.view(-1, 1)
    itime = 3600
    res = {"reorder_every": reorder.REORDER_EVERY}
    for kind in ("synthetic", "uniform"):
        if kind == "synthetic":
            z0, z1 = met_fields(kind, grid, device, (0.0, 10800.0))
            mem1 = 10800
        else:
            (z0,) = met_fields(kind, grid, device)
            z1, mem1 = z0, 86400
        tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(z0, z1, *tw,
                                               dtype=cfg.table_dtype)
        a = advance.advance_args(cfg, prm, itime, 0, mem1)
        height = z0.height

        def k4(p, s=0):
            return advance.advance_all_cuda(p, height, tables, a,
                                            rng.Key(55, s), cfg, None, 0)[0]

        def k3_ms(p):
            return cuda_ms(lambda: cc.conccalc_cuda(
                flat, p, itime + LSYNC, lage, oh, 1.0, None, ccfg), 5)

        def k5_ms(p):
            return cuda_ms(lambda: reorder.reorder_by_cell_cuda(
                p, height, cfg), 3)

        # one step first: the particles are old enough for the 4-point path
        p = k4(bench_particles(N_MAIN, device, seed=3, old_fraction=1.0), 99)
        out = dict(k4_unordered_ms=cuda_ms(lambda: k4(p), 5),
                   k3_unordered_ms=k3_ms(p), k5_shuffled_ms=k5_ms(p),
                   k4_ms=[], k3_ms=[], k5_ms={})
        p, _ = reorder.reorder_by_cell_cuda(p, height, cfg)
        for s in range(DECAY_STEPS + 1):
            out["k4_ms"].append(cuda_ms(lambda: k4(p), 5))
            out["k3_ms"].append(k3_ms(p))
            if s in (0,) + SORT_INTERVALS:
                out["k5_ms"][str(s)] = k5_ms(p)
            p = k4(p, s)
        out["unordered_ms_per_step"] = (out["k4_unordered_ms"]
                                        + out["k3_unordered_ms"])
        out["ms_per_step_if_sorted_every"] = {
            str(e): (sum(out["k4_ms"][:e]) + sum(out["k3_ms"][:e])
                     + out["k5_ms"][str(e)]) / e for e in SORT_INTERVALS}
        res[kind] = out
        del p, tables, z0, z1
        torch.cuda.empty_cache()
    return res


def phase_step(device, grid) -> dict:
    """One full step at 2**20 particles: kernels vs plain twins, same draws."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, rng
    from flexpart_tpu_torch.core.state import Particles
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, prm, og, geo, ccfg = step_setup(grid)
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    n = N_STEP4
    n_chunks = n // CHUNK
    p = bench_particles(n, device, seed=11)
    key = rng.Key(99, 0)
    draws = {tag: rng.normals(key, (rows, n), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    itime, mem1 = 3600, 10800
    ccfg = ccfg.replace(kernel_possible=False)

    # kernels: the entry points a user calls
    pk, dk = advance.advance_chunked(p, z0, z1, itime, 0, mem1, key, cfg,
                                     prm, n_chunks, draws=draws)
    acc = zero_accumulators(geo, 1, 1, device=device)
    acc = cc.conccalc(acc, pk, z0, itime + LSYNC, lage, 1.0, ccfg, oh)
    gk = acc.gridunc

    # plain twins: the chunk loop with the twin tables and twin sampling
    tw0, tw1, ew0, ew1, _ = advance._time_weights(itime, 0, mem1, prm, cfg)
    tables = interp.quad_tables_plain(z0.f3d, z1.f3d, z0.f2d, z1.f2d, tw0,
                                      tw1, ew0, ew1, cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    parts = []
    for c in range(n_chunks):
        lo, hi = c * CHUNK, (c + 1) * CHUNK
        q, _ = advance.advance_all_plain(
            p.rows(lo, hi), z0.height, tables, a, key, cfg,
            {t: v[:, lo:hi] for t, v in draws.items()}, lo)
        parts.append(q)
    pp = Particles.cat(parts)
    gp = zero_accumulators(geo, 1, 1, device=device).gridunc
    cc.conccalc_plain(gp.view(-1, 1), pp, itime + LSYNC, lage, oh, 1.0, None,
                      ccfg)

    res = compare_particles(pk, pp, "step", float(grid.nx - 1))
    check(int(dk.n_active) == n and int(dk.nan_count) == 0, "step: lost particles")
    gd = (gk - gp).abs()
    check(bool(torch.all(gd <= K3_RTOL * gp.abs())), "step: gridunc differs")
    check(abs(float(gk.sum()) - 1.0) < 1e-3, f"step: sampled mass {float(gk.sum())}")

    # the device function against K1: K4 drawing in registers gives bitwise
    # the particles of K4 fed rng.normals' draws for the same key
    p_reg, _ = advance.advance_chunked(p, z0, z1, itime, 0, mem1, key, cfg,
                                       prm, n_chunks)
    check_same_bits(p_reg, pk, "step: draws in registers vs the normals kernel's")
    return dict(n=n, **res, in_register_draws_bitwise=True,
                gridunc_max_abs_err=float(gd.max()), mass=float(gk.sum()))


def phase_main(device, grid, kernels) -> tuple[dict, dict]:
    """The bench.py step at full width, MAIN_STEPS steps with a sort every
    REORDER_EVERY; launch counts reset just
    before and read just after.  Then the profile of two more steps.
    Returns (main, profile)."""
    import torch
    from flexpart_tpu_torch.core import advance, reorder, rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, prm, og, geo, ccfg = step_setup(grid)
    every = reorder.REORDER_EVERY
    (z0,) = met_fields("uniform", grid, device)
    p = bench_particles(N_MAIN, device, seed=0)
    conc = cc.make_conccalc(og.outheights)
    acc = zero_accumulators(geo, 1, 1, device=device)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    n_chunks = max(1, N_MAIN // CHUNK)
    finite = torch.ones((), dtype=torch.bool, device=device)
    diags, step_s = [], []

    def one_step(i: int):
        nonlocal p, acc
        it = i * LSYNC
        if i % every == 0:
            p, _ = reorder.reorder_by_cell(p, z0.height, cfg)
        p, diag = advance.advance_chunked(p, z0, z0, it, 0, 86400,
                                          rng.Key(2, i), cfg, prm, n_chunks)
        c = ccfg.replace(kernel_possible=cc.kernel_possible_at(it + LSYNC, 0))
        acc = conc(acc, p, z0, it + LSYNC, lage, 1.0, c)
        return diag

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t_all = time.perf_counter()
    for i in range(MAIN_STEPS):
        t0 = time.perf_counter()
        diag = one_step(i)
        finite &= (torch.isfinite(p.x).all() & torch.isfinite(p.y).all()
                   & torch.isfinite(p.z).all())
        diags.append(diag)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = {k.name: k.launches for k in kernels}

    for i, d in enumerate(diags):
        check(int(d.n_active) == N_MAIN, f"main step {i}: n_active {int(d.n_active)}")
        check(int(d.nan_count) == 0, f"main step {i}: nan_count {int(d.nan_count)}")
    check(bool(finite), "main: non-finite positions")
    total = float(acc.gridunc.sum(dtype=torch.float64))
    check(abs(total - MAIN_STEPS) <= 1e-3 * MAIN_STEPS,
          f"main: sampled mass {total} != {MAIN_STEPS}")
    # the draws of the main path are made inside the advance kernel; the
    # stand-alone normals kernel is launched by the other phases
    for name in ("advance", "quad_tables", "conccalc", "reorder"):
        check(launches[name] > 0, f"main: kernel {name} was never launched")
    check(launches["reorder"] == len(range(0, MAIN_STEPS, every)),
          f"main: {launches['reorder']} sorts in {MAIN_STEPS} steps")
    steady = step_s[1:]
    rate = N_MAIN * len(steady) / sum(steady)
    res = dict(n=N_MAIN, steps=MAIN_STEPS, n_chunks=n_chunks,
               advance_launches_per_step=launches["advance"] / MAIN_STEPS,
               reorder_every=every,
               steady_steps_with_a_sort=len(range(every, MAIN_STEPS, every)),
               wall_s=wall, first_step_s=step_s[0],
               steady_step_s=sum(steady) / len(steady),
               steady_step_min_s=min(steady), steady_step_max_s=max(steady),
               particle_steps_per_s=rate, sampled_mass=total,
               kernel_steps=sum(cc.kernel_possible_at(i * LSYNC + LSYNC, 0)
                                for i in range(MAIN_STEPS)),
               launches=launches)

    def steps(first: int, count: int):
        for i in range(first, first + count):
            one_step(i)
        torch.cuda.synchronize()

    # a window of `every` steps holds exactly one sort
    return res, profile_steps(steps, MAIN_STEPS, every)


# the device functions of csrc/reorder.cu, as the profiler names them
SORT_KERNELS = ("key_kernel", "digit_count_kernel", "scan_tile_sums_kernel",
                "scan_sums_kernel", "scan_tiles_kernel", "scatter_kernel",
                "gather_kernel")


def device_rows(prof) -> list:
    """(kernel name, launches, device ms) of a torch.profiler profile, the
    device-side rows only, longest first."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    return rows


def profile_steps(steps, first: int, count: int) -> dict:
    """``count`` more steady steps under torch.profiler: CUDA kernels per
    step, device time by kernel (the sort's kernels also summed) and the
    share of the window the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps(first, count)
    t0 = time.perf_counter()
    steps(first + count, count)
    unprofiled = time.perf_counter() - t0
    rows = device_rows(prof)
    device_ms = sum(r[2] for r in rows)
    sort = [r for r in rows if any(w in r[0] for w in SORT_KERNELS)]
    return dict(steps=count, unprofiled_step_s=unprofiled / count,
                cuda_kernels_per_step=sum(r[1] for r in rows) / count,
                device_ms_per_step=device_ms / count,
                device_busy_share=device_ms / 1e3 / unprofiled,
                sort_kernels_per_step=sum(r[1] for r in sort) / count,
                sort_ms_per_step=sum(r[2] for r in sort) / count,
                top=[dict(name=k[:60], calls=c / count, ms=ms / count)
                     for k, c, ms in rows[:12]])



# ------------------------------------------------------------ Simulation --

SIM_GRID = BENCH_GRID      # global, to the poles: the polar caps are on
SIM_HOURS = 3
SIM_DIR = ROOT / "build" / "sim_smoke"


def sim_setup(outdir, device, write_netcdf: bool, **kw):
    """The port's Simulation at full width with the default Command
    (convection and subgrid orography on): 10 x 2**20 particles released
    from a 2 x 2 degree box over the first hour, three hours of 900 s steps
    on SyntheticMet, on the main phase's global 1-degree grid, which
    reaches the poles (the advance takes its polar-cap update), hourly
    output on the main phase's 0.5-degree, 3-layer grid."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox,
                                           Releases, Species)
    grid = make_grid(**SIM_GRID)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=SIM_HOURS * 10000, lsynctime=LSYNC, loutstep=3600,
                  loutaver=3600, loutsample=900)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=10000,
                     lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0, z1=50.0,
                     z2=500.0, mass=(1.0,), parts=N_MAIN)
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720, numygrid=360,
                 dxout=0.5, dyout=0.5, outheights=(100.0, 1000.0, 50000.0))
    return Simulation(cmd=cmd, releases=Releases(species=(Species(),),
                                                 boxes=(box,)),
                      grid=grid, met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), device=device,
                      write_netcdf=write_netcdf, **kw)


def sim_kernel_checks(sim, snap, what: str) -> dict:
    """K2, K5, K6, K7, K3 and K4 against their plain versions on the
    tensors that one step of ``Simulation.run`` gave them: ``snap`` is
    (istep, itime, particles after the step's release and before its sort,
    z0, z1, mt0, mt1, the raw fields of both met times, the flux memory
    cbmf) as the step probe saw them.  The order is the step's: the tables
    of its time weights, the sort, the convection columns of its time
    weights, the redistribution of the sorted particles with the step's
    key (injected uniforms, and once more its own, which must give the
    same particles; and with those particles put in the step's convecting
    columns, where some must move), then on the redistributed particles
    the sampling (the
    step's own path and the 4-point path) and the advance with the step's
    key, fed injected draws on both sides and once more with its draws made
    in registers.  Tolerances as in the kernels phase, but for the
    sampling, which is held to the float64 sum of its pairs; every check
    is fatal."""
    import numpy as np
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.core.state import FIELDS
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.physics import convection as cv
    istep, itime, p, z0, z1, mt0, mt1, eta0, eta1, cbmf = snap
    cfg, prm, device = sim.step_cfg, sim.step_prm, sim.device
    height = z0.height
    n = p.capacity
    res = dict(istep=istep, itime=itime, scheduled=int(p.active.sum()),
               occupied_met_cells=unique_rows(p, height, cfg))

    # K2: bitwise
    tw = advance._time_weights(itime, mt0, mt1, prm, cfg)[:4]
    targs = (z0.f3d, z1.f3d, z0.f2d, z1.f2d, *tw, cfg.table_dtype)
    tk = interp.quad_tables_cuda(*targs)
    tp = interp.quad_tables_plain(*targs)
    bits = torch.int16 if cfg.table_dtype == torch.bfloat16 else torch.int32
    for name in ("rows", "rowsE"):
        x, y = getattr(tk, name), getattr(tp, name)
        differ = int((x.view(bits) != y.view(bits)).sum())
        check(x.shape == y.shape and differ == 0,
              f"{what}: K2 {name} differs from the plain version in "
              f"{differ} values")
    res["quad_tables"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: interp.quad_tables_cuda(*targs), 10),
        plain_ms=cuda_ms(lambda: interp.quad_tables_plain(*targs), 3))

    # K5: perm and every field bitwise, twice
    q, perm = reorder.reorder_by_cell_cuda(p, height, cfg)
    check_sorted(p, q, perm, height, cfg, f"{what}: K5")
    q_plain, perm_plain = reorder.reorder_by_cell_plain(p, height, cfg)
    check(torch.equal(perm, perm_plain), f"{what}: K5 perm vs the plain version's")
    check_same_bits(q, q_plain, f"{what}: K5 fields vs the plain version's",
                    FIELDS)
    check(torch.equal(reorder.reorder_by_cell_cuda(p, height, cfg)[1], perm),
          f"{what}: K5 gives two perms on one input")
    del q_plain, perm_plain
    res["reorder"] = dict(
        max_abs_err=0.0,
        slots_moved_share=float((perm != torch.arange(
            n, dtype=torch.int32, device=device)).float().mean()),
        ms=cuda_ms(lambda: reorder.reorder_by_cell_cuda(p, height, cfg), 5),
        plain_ms=cuda_ms(lambda: reorder.reorder_by_cell_plain(p, height, cfg),
                         2))
    del perm

    # K6 at the step's time weights and flux memory, then K7 on the sorted
    # particles with the step's key; the step goes on with K7's particles
    kern = sim.conv_kernel
    fields = tuple(getattr(e, name) for e in (eta0, eta1)
                   for name in ("ps", "tth", "qvh", "tt2", "td2"))
    dt1, dt2 = float(itime - mt0), float(mt1 - itime)
    dtt = 1.0 / (dt1 + dt2)
    tw = (float(np.float32(dt2 * dtt)), float(np.float32(dt1 * dtt)))
    conv, _, k6 = check_convection(kern, fields, cbmf, f"{what}:", tw)
    res["convection"] = dict(
        **k6, ms=cuda_ms(lambda: cv.convection_cuda(kern, fields, *tw, cbmf,
                                                    float(LSYNC)), 10),
        plain_ms=cuda_ms(lambda: cv.convection_plain(kern, fields, *tw,
                                                     cbmf, float(LSYNC)), 2))
    key = rng.Key(sim.seed, istep)
    k0, k1 = key.philox_key(cv.REDIST_TAG)
    own = rng.uniforms_plain(n, k0, k1, device)
    k7 = check_redist(q, key, conv, kern, sim.grid, own,
                      f"{what}: K7 injected", itime)
    args7 = redist_args(conv, kern, sim.grid, itime)
    q_in = q
    q_inj, m_inj = cv.redist_cuda(q_in, key, *args7, rn=own)
    q, m_reg = cv.redist_cuda(q_in, key, *args7)
    check_same_bits(q, q_inj, f"{what}: K7 uniforms in registers vs "
                    "rng.uniforms_plain's", ("z",))
    check(int(m_reg) == int(m_inj), f"{what}: K7 moved counts differ")
    # The step's plume lies outside SyntheticMet's convecting bands, so K7
    # finds no live particle in it.  So K7 is held once more on the step's
    # own matrices with the same particles put at the centres of the
    # convecting columns (slot s in the s-th of them, round robin), all
    # scheduled, their z kept: they must move.
    cols = torch.nonzero(conv.lconv).flatten().to(torch.int32)
    check(cols.numel() > 0, f"{what}: no column convects")
    at = cols[torch.arange(n, device=device) % cols.numel()]
    zero = torch.zeros_like(q_in.x_lo)
    q_live = q_in.replace(
        x_hi=(at % sim.grid.nx).float(), x_lo=zero,
        y_hi=(at // sim.grid.nx).float(), y_lo=zero,
        itra=torch.full_like(q_in.itra, itime),
        active=torch.ones_like(q_in.active))
    k7_live = check_redist(q_live, key, conv, kern, sim.grid, own,
                           f"{what}: K7 on convecting columns", itime)
    check(k7_live["moved"] > 0, f"{what}: K7 moved no particle of the "
          "step's convecting columns")
    res["redist"] = dict(
        **k7, **k7_bound(q_in, conv, kern, sim.grid, itime),
        on_convecting_columns=dict(
            **k7_live, **k7_bound(q_live, conv, kern, sim.grid, itime)),
        ms=cuda_ms(lambda: cv.redist_cuda(q_in, key, *args7), 10),
        plain_ms=cuda_ms(lambda: cv.redist_plain(q_in, key, *args7), 2))
    del q_in, q_inj, q_live, conv, fields

    # K3 on the sorted particles, as the step samples them
    step_ccfg = sim._ccfg_at(itime, sim.conc_cfg)
    oh = torch.tensor(sim.outgrid.outheights, dtype=torch.float32,
                      device=device)
    rhoi = cc._rho_at_particles(q, z1) if step_ccfg.ind_samp == -1 else None
    gk = torch.zeros_like(sim.acc.gridunc)
    gp = torch.zeros_like(gk)
    flat_k, flat_p = gk.view(-1, q.nspec), gp.view(-1, q.nspec)
    res["conccalc"] = {}
    for kp in sorted({step_ccfg.kernel_possible, True}):
        c = step_ccfg.replace(kernel_possible=kp)
        args = (q, itime, sim.lage, oh, 1.0, rhoi, c)
        path = "4-point" if kp else "single-index"
        gk.zero_()
        gp.zero_()
        cc.conccalc_cuda(flat_k, *args)
        cc.conccalc_plain(flat_p, *args)
        # A plume puts up to 10**6 equal contributions into one output
        # cell, and float32 additions in different orders then differ by
        # more than the kernels phase's rtol (the plain version's
        # index_add_ adds them one by one).  So both are held to the
        # float64 sum of the same pairs: any order of m float32 additions
        # of non-negative terms stays within m * 2**-24 of it, relatively,
        # and a cell of few pairs is held as tightly as in the kernels phase.
        lin, valid, contrib = cc.conccalc_pairs(flat_k.shape[0], *args)
        lin, contrib = lin[valid], contrib[valid]
        ref = torch.zeros(flat_k.shape, dtype=torch.float64, device=device)
        ref.index_add_(0, lin, contrib.double())
        pairs = torch.zeros(flat_k.shape[0], dtype=torch.int64, device=device)
        pairs.index_add_(0, lin, torch.ones_like(lin))
        del lin, valid, contrib
        rtol = torch.clamp(pairs.double() * 2.0 ** -24, min=K3_RTOL)[:, None]
        check(float(ref.sum()) > 0.0, f"{what}: K3 {path} samples nothing")
        rel = {}
        for who, flat in (("kernel", flat_k), ("plain", flat_p)):
            d = (flat.double() - ref).abs()
            rel[who] = float((d / ref.clamp(min=1e-300)).max())
            check(bool(torch.all(d <= rtol * ref)),
                  f"{what}: K3 {path} path, {who}: a cell is further from "
                  f"the float64 sum of its pairs than their count allows, "
                  f"max rel {rel[who]}")
        res["conccalc"][path] = dict(
            the_steps_own_path=kp == step_ccfg.kernel_possible,
            max_abs_err=float((flat_k.double() - ref).abs().max()),
            max_rel_err_vs_f64=rel["kernel"],
            plain_max_rel_err_vs_f64=rel["plain"],
            total_rel_err_vs_f64=abs(float(flat_k.sum(dtype=torch.float64))
                                     / float(ref.sum()) - 1.0),
            cells_hit=int((pairs != 0).sum()),
            most_pairs_in_a_cell=int(pairs.max()),
            ms=cuda_ms(lambda: cc.conccalc_cuda(flat_k, *args), 10),
            plain_ms=cuda_ms(lambda: cc.conccalc_plain(flat_p, *args), 3))
        del ref, pairs, rtol, d
    del gk, gp, flat_k, flat_p

    # K4 on the sorted particles with the step's key
    key = rng.Key(sim.seed, istep)
    a = advance.advance_args(cfg, prm, itime, mt0, mt1)
    draws = {tag: rng.normals(key, (rows, n), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}

    def kernel(d=draws):
        return advance.advance_all_cuda(q, height, tk, a, key, cfg, d, 0)

    def plain():
        return advance.advance_all_plain(q, height, tp, a, key, cfg, draws, 0)

    (pk, dk), (pp, dp) = kernel(), plain()
    torch.cuda.synchronize()
    k4 = compare_particles(pk, pp, f"{what}: K4", float(cfg.nx - 1))
    for f in ("n_active", "n_exited"):
        check(abs(int(getattr(dk, f)) - int(getattr(dp, f)))
              <= K4_FLAG_SHARE * n, f"{what}: K4 {f} differs")
    check_same_bits(kernel(None)[0], pk,
                    f"{what}: K4 draws in registers vs injected")
    branches = branch_counts(q, pp, height, tp, cfg, itime)
    del pk, pp
    res["advance"] = dict(
        **k4, max_abs_err=max(k4["max_dx"], k4["max_dy"]),
        n_active=int(dk.n_active), n_exited=int(dk.n_exited),
        branches=branches, ms=cuda_ms(lambda: kernel(None), 10),
        plain_ms=cuda_ms(plain, 2))
    del draws
    torch.cuda.empty_cache()
    return res


def phase_sim(device, kernels) -> dict:
    """``Simulation.run`` on the card, twice with one seed.  The first run
    carries no probe and never waits for the card inside a step: it is
    timed as a whole, and its launch counts are the path's.  The second
    runs under torch.profiler with the section timers synchronised and a
    probe at the top of every step, after the step's release and before
    its sort if it has one: the probe waits for the card and reads the
    host clock, takes the share of active particles whose cell key is
    below their left neighbour's, and keeps the ensemble, the met fields
    (processed and raw) and the convective flux memory of one release step
    and of one steady step.  The two runs must end in bitwise equal
    particles; then every kernel is held against its plain version on the
    two kept steps (``sim_kernel_checks``).  Per step of run A: the
    columns that convect and the particles that convection moved."""
    import shutil
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.core.state import FIELDS
    try:
        import h5py  # noqa: F401
        netcdf = True
    except ImportError:
        netcdf = False
    shutil.rmtree(SIM_DIR, ignore_errors=True)
    nsteps = SIM_HOURS * 3600 // LSYNC

    # --- run A: timed as a whole, no probe ---
    t_setup = time.perf_counter()
    sim = sim_setup(SIM_DIR / "a", device, netcdf)
    setup_s = time.perf_counter() - t_setup
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    for name in ("advance", "quad_tables", "conccalc", "reorder",
                 "convection", "redist"):
        check(launches[name] > 0, f"sim: kernel {name} was never launched")
    check(launches["advance"] == nsteps and launches["quad_tables"] == nsteps,
          f"sim: {launches} launches in {nsteps} steps")
    # convection runs on every step, the last (which does not advance) too
    check(launches["convection"] == launches["redist"] == nsteps + 1,
          f"sim: {launches} convection launches in {nsteps + 1} steps")
    check(sim.step_cfg.polar and sim.conv_kernel is not None
          and sim.cmd.lsubgrid == 1, "sim: not the default Command's path")
    conv_counts = torch.stack(sim.convection_counts).cpu().numpy()
    check(bool((conv_counts[:, 0] > 0).all()), "sim: a step had no "
          "convecting column")
    check(launches["reorder"] == sim.n_sorts, "sim: sorts and K5 launches differ")
    pa = sim.particles
    check(int(pa.active.sum()) == N_MAIN,
          f"sim: {int(pa.active.sum())} of {N_MAIN} particles active")
    for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "up", "vp", "wp"):
        check(bool(torch.isfinite(getattr(pa, f)).all()), f"sim: {f} not finite")
    check(sim.timings["particle_steps"] > 0 and sim._prefetch_failures == 0,
          "sim: no particle steps, or the met reader failed")

    # the files of the recipe, with its names and shapes
    out = SIM_DIR / "a"
    dates = (out / "dates").read_text().split()
    check(dates == ["20200101013000", "20200101023000"], f"sim: dates {dates}")
    npz = sorted(q.name for q in out.glob("grid_conc_*.npz"))
    check(npz == [f"grid_conc_{d}.npz" for d in dates], f"sim: npz {npz}")
    check(len(list(out.glob("grid_conc_*.nc"))) == int(netcdf), "sim: nc files")
    last = np.load(out / npz[-1])
    conc_a = last["conc"]
    check(conc_a.shape == (1, 1, 1, 3, 360, 720), f"sim: conc {conc_a.shape}")
    check(bool(np.isfinite(conc_a).all()), "sim: conc not finite")
    mass = float((conc_a[0, 0, 0] * sim.geo.volume).sum() / 1e12)
    check(abs(mass - 1.0) < 1e-3, f"sim: mass fraction {mass}")
    timers_a = {k: v for k, v in sim.timings.items()}
    sorts_a = sim.n_sorts
    del sim

    # --- run B: profiled and probed ---
    sim = sim_setup(SIM_DIR / "b", device, False, profile=True)
    release_steps = sorted(t // LSYNC for t in sim._release_times)
    # a step in the middle of the release (an active plume, a block just
    # woken in the last slots, the rest unscheduled) and the last step
    # that advances, long after it
    keep = {release_steps[len(release_steps) // 2]: "release step",
            nsteps - 1: "steady step"}
    check(len(keep) == 2 and nsteps - 1 > release_steps[-1],
          f"sim: release steps {release_steps} leave no steady step to keep")
    stamps, shares, snaps = [], [], {}

    def probe(istep, itime):
        torch.cuda.synchronize()
        t_in = time.perf_counter()
        p = sim.particles
        z0, z1, mt0, mt1 = sim._fields_for(itime)
        keys = reorder.cell_keys(p, z0.height, sim.step_cfg)
        below = (keys[1:] < keys[:-1]) & p.active[1:]
        shares.append(torch.stack([below.sum(), p.active.sum()]))
        if istep in keep:
            snaps[keep[istep]] = (istep, itime, p, z0, z1, mt0, mt1,
                                  sim._get_eta(mt0), sim._get_eta(mt1),
                                  sim.cbmf)
        torch.cuda.synchronize()
        stamps.append((t_in, time.perf_counter()))

    sim._step_probe = probe
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run()
        torch.cuda.synchronize()
    pb = sim.particles
    check_same_bits(pa, pb, "sim: two runs with one seed", FIELDS)
    conc_b = np.load(SIM_DIR / "b" / npz[-1])["conc"]
    worst = float(np.abs(conc_a - conc_b).max())
    check(bool(np.all(np.abs(conc_a - conc_b) <= K3_RTOL * np.abs(conc_a))),
          f"sim: conc of two runs with one seed differs by {worst}")
    check(sim.n_sorts == sorts_a, "sim: the two runs sorted differently")
    rows = device_rows(prof)
    del prof, pa, pb

    def per_launch(words, n):
        hit = [r for r in rows if any(w in r[0] for w in words)]
        return dict(ms_total=sum(r[2] for r in hit),
                    kernels=sum(r[1] for r in hit),
                    ms_per_call=sum(r[2] for r in hit) / max(n, 1), calls=n)

    counts = torch.stack(shares).cpu().numpy()
    out_of_order = [float(b) / max(int(a), 1) for b, a in counts]
    report = sim.timers.report()
    # stamps[i]: the host clock as the probe of step i of run B began and
    # ended, the card idle both times; a step lasts from the end of its
    # probe to the beginning of the next
    first_steady = release_steps[-1] + 1
    step_s = np.array([stamps[i + 1][0] - stamps[i][1]
                       for i in range(len(stamps) - 1)])
    steady, release = step_s[first_steady:], step_s[:first_steady]
    check(set(snaps) == set(keep.values()), f"sim: kept steps {list(snaps)}")
    on_sim_inputs = {name.replace(" ", "_"): sim_kernel_checks(
        sim, snap, f"sim {name} {snap[0]}") for name, snap in snaps.items()}
    snaps.clear()
    res = dict(
        n=N_MAIN, steps=nsteps, netcdf=netcdf, setup_s=setup_s,
        release_steps=release_steps, sorts=sorts_a, launches=launches,
        # run A: no probe, no wait for the card inside a step
        run_s=run_s, particle_steps=timers_a["particle_steps"],
        particle_steps_per_s_whole_run=timers_a["particle_steps"] / run_s,
        section_seconds_unsynced={k: v for k, v in timers_a.items()
                                  if k not in ("particle_steps",)},
        mass_fraction=mass, conc_two_runs_max_abs_diff=worst,
        two_runs_bitwise_equal=True,
        # run B: under the profiler, synchronised at the top of every step
        synced_first_step_s=float(release[0]),
        synced_release_step_s=[float(x) for x in release[1:]],
        synced_steady_step_s=[float(x) for x in steady],
        synced_steady_step_mean_s=float(steady.mean()),
        # all N_MAIN particles are active on every step after the last release
        synced_steady_particle_steps_per_s=float(
            N_MAIN * len(steady) / steady.sum()),
        active_out_of_order_share=out_of_order,
        active_per_step=[int(a) for _, a in counts],
        # run A, per step (the last, which does not advance, included)
        convecting_columns_per_step=[int(c) for c in conv_counts[:, 0]],
        convection_moved_per_step=[int(m) for m in conv_counts[:, 1]],
        columns=SIM_GRID["nx"] * SIM_GRID["ny"],
        section_table_synced=report.splitlines(),
        device_per_call={
            "advance": per_launch(("advance_kernel",), nsteps),
            "quad_tables": per_launch(("quad_tables_kernel",), nsteps),
            "conccalc": per_launch(("conccalc_kernel",), launches["conccalc"]),
            "reorder": per_launch(SORT_KERNELS, sorts_a),
            "convection": per_launch(("convection_kernel",), nsteps + 1),
            "redist": per_launch(("redist_kernel",), nsteps + 1)},
        device_ms_all_kernels=sum(r[2] for r in rows),
        top=[dict(name=k[:60], calls=c, ms=ms) for k, c, ms in rows[:10]],
        kernels_on_sim_inputs=on_sim_inputs)
    del sim
    shutil.rmtree(SIM_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------ main --

def main() -> int:
    if not (ROOT / "flexpart_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout of the repo "
                         "(flexpart_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke run needs an NVIDIA card")
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.met.synthetic import make_grid

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    kernels = list(_build.KERNELS)
    build_s = _build.build_all(kernels)
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln] for k in kernels}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "registers": {k.name: registers_by_entry(k.build_log)
                        for k in kernels}})

    grid = make_grid(**BENCH_GRID)
    t0 = time.perf_counter()
    kres = phase_kernels(device, grid)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, **kres,
          "power_limit": smi})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sres = phase_step(device, grid)
    emit({"phase": "step", "seconds": time.perf_counter() - t0, **sres})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rres = phase_reorder(device, grid)
    emit({"phase": "reorder", "seconds": time.perf_counter() - t0, **rres,
          "device": name, "power_limit": smi})
    torch.cuda.empty_cache()

    normals_other = _build.NORMALS.launches
    mres, pres = phase_main(device, grid, kernels)
    emit({"phase": "main", **mres,
          "cuda_kernels_per_step": pres["cuda_kernels_per_step"],
          "device": name, "power_limit": smi})
    emit({"phase": "profile", **pres, "device": name, "power_limit": smi})
    del pres
    torch.cuda.empty_cache()

    # the launches of the kernels line stay the main phase's; the sim phase
    # resets the counts for its own run and reports them in its line
    t0 = time.perf_counter()
    simres = phase_sim(device, kernels)
    emit({"phase": "sim", "seconds": time.perf_counter() - t0, **simres,
          "device": name, "power_limit": smi})

    # launches: the main path's own count.  The normals kernel is not
    # launched there: its generator (fp::normal_words, fp::normal_pair) runs
    # inside the advance kernel's one launch; the stand-alone kernel serves
    # rng.normals.
    src = "flexpart_tpu_torch/csrc/{}.cu"
    replaces = {"normals": ("flexpart_tpu/core/rng.py:61", "pallas"),
                "quad_tables": ("flexpart_tpu/core/interp.py:457", "XLA"),
                "conccalc": ("flexpart_tpu/grid/conccalc.py:78", "XLA"),
                "advance": ("flexpart_tpu/core/advance.py:768", "XLA"),
                # the JAX package keeps no particle order; its tiles mode
                # moves particles between slots here
                "reorder": ("flexpart_tpu/parallel/domain.py:151", "none"),
                "convection": ("flexpart_tpu/physics/convection.py:379",
                               "XLA"),
                "redist": ("flexpart_tpu/physics/convection.py:453", "XLA")}
    k5 = kres["reorder"]["cases"]
    extra = {"reorder": {
        # per input: K5, the plain version, torch.argsort of the keys, the
        # byte bound; the shuffled input's bound by 32 B sectors beside it
        "inputs": {n: {f: c[f] for f in ("ms", "plain_ms", "library_ms",
                                        "bound_ms") } for n, c in k5.items()},
        "shuffled_sector_bound_ms": k5["shuffled"]["sector_bound_ms"]},
        "normals": {
        "on_main_path_as": "fp::normal_words and fp::normal_pair of "
                           "flexpart_tpu_torch/csrc/philox_normal.cuh, "
                           "inlined into advance.cu",
        "launches_other_phases": normals_other},
        "conccalc": {
            # of the steady step's case: the 4-point path, ordered, all old
            "global_atomics_without_warp_sums":
                kres["conccalc"]["cases"]["kernel_ordered_all_old"]["pairs"],
            "global_atomics": kres["conccalc"]["cases"]
                ["kernel_ordered_all_old"]["warp_target_pairs"]},
        # the POLAR instantiation on the whole sphere; main keeps it off
        "advance": {"polar": {f: kres["advance"]["polar"][f] for f in (
            "ms", "unordered_ms", "stock_ms_same_particles", "plain_ms",
            "bound_ms", "bound_by", "max_abs_err", "bitwise", "branches")}},
        "convection": {f: kres["convection"][f] for f in (
            "library", "all_convecting_ms", "nl", "L1", "columns")},
        "redist": {f: kres["redist"][f] for f in (
            "library", "all_convecting_ms", "moved")}}
    for kname in ("convection", "redist"):
        extra[kname]["convecting_columns"] = {
            n: c["convecting_columns"]
            for n, c in kres["convection"]["cases"].items()}
    # each kernel against its plain version on the two steps kept from the
    # sim phase (the sampling: the step's own path)
    for kname in ("quad_tables", "conccalc", "advance", "reorder",
                  "convection", "redist"):
        on_sim = {}
        for step, r in simres["kernels_on_sim_inputs"].items():
            r = r[kname]
            if kname == "conccalc":
                r = next(c for c in r.values() if c["the_steps_own_path"])
            on_sim[step] = {f: r[f] for f in ("max_abs_err", "ms", "plain_ms")}
        extra.setdefault(kname, {})["sim_inputs"] = on_sim
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": src.format(k.name),
         "replaces": replaces[k.name][0], "tpu_route": replaces[k.name][1],
         "launches": mres["launches"][k.name],
         "launches_sim": simres["launches"][k.name],
         **{f: kres[k.name][f] for f in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}, **extra.get(k.name, {})}
        for k in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

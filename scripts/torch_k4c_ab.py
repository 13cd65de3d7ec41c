#!/usr/bin/env python3
"""Time the fixed step with the skewed CBL (K4 CBL, and K4 TILE x CBL) of
this checkout beside older or variant sources, on the same inputs, in one
process on one CUDA card:

    python3 scripts/torch_k4c_ab.py [OLD_DIR] [--variant FILE.cu ...]

OLD_DIR holds an older commit's ``advance.cu``, ``advance_common.cuh`` and
``advance_adaptive.cu`` (``git show <commit>:flexpart_tpu_torch/csrc/<f>
> build/<dir>/<f>``); a header not there is this checkout's.  Its K4 is
timed as ``old`` and its K11 beside this checkout's K11 CBL.  An older
``fp_advance`` that takes fewer arguments (no scratch before the stream)
is handed this wrapper's arguments without them.  Each ``--variant`` is a
``.cu`` file exporting ``fp_advance`` with this checkout's arguments, as
an edited copy of ``advance.cu`` under ``build/`` (another build
constant or design).

The inputs are those of ``chip_smoke.py``: the kernels case of
``kernel_advance_fixed_cbl`` (10 x 2**20 boundary-layer particles on
convective_met's fields, in cell order and as drawn; stock K4 TS on the
same particles beside it), the same particles in cell order with the
strong CBL in every column (``all_zone``) and in none (``no_zone``),
each of the 8 steps of ``phase_fixed_cbl``'s path (its particles as the
path hands them to K4), K4 TILE x CBL on a 1 x 1 tile (every tenth
particle of the kernels case, ``fixed_cbl_tile``'s case), K11 CBL (the
adaptive step, ctl 5) on the kernels case in cell order, this checkout's
beside OLD_DIR's, and K4's turbswitch crosses, which share K4's body with
the CBL's stages (``fixed_ts_crosses``' cases at ``N_CROSS`` particles:
settling without the polar caps, two nests, a 1 x 1 tile), and stock K4
on ``kernel_advance``'s main case (10 x 2**20 steady particles in cell
order, the main path's configuration).  Every kernel
must give this checkout's
outputs bit for bit (every field, the counts, ``nan_count``), and this
checkout's are held against the plain version on the kernels case in
cell order and on ``all_zone``.  Each case is timed in turns
(``kernel_ab.in_turns``) as replays of a CUDA graph of ``REPS`` calls.

Where a source has the ``FP_CBL_LANES`` measurement build (a build of its
own, never launched by a path), each case also gives the skewed
substeps' lane efficiency: the active lanes over 32 over the warp entries
of the skewed substep.  Prints the card's name and power limit and one
JSON line: per case the times, lane efficiencies and the shares of the
substeps' branches (``chip_smoke.fixed_cbl_shares``), per kernel the
ptxas registers, stack and spills of each CBL instantiation, this
checkout's K4 CBL's resident warps an SM (``chip_smoke.k4_cbl_occupancy``),
and with OLD_DIR the stock instantiations' ptxas lines against OLD_DIR's.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402

REPS = 10


def cbl_layout(kernel) -> dict:
    """ptxas's line of each CBL entry of ``kernel``'s build (K4's kernels
    named for the CBL, K11's of turbulence 2)."""
    return {e: v for e, v in cs.ptxas_by_entry(kernel.build_log).items()
            if "cbl" in e or re.search(r"adaptive\w*<\d,2,", e)}


def fp_advance_argc(kernel) -> int:
    """The arguments of ``fp_advance`` in ``kernel``'s sources (the file
    that defines it: the source, or a file it includes)."""
    for f in kernel.sources():
        text = re.sub(r"//[^\n]*", "", f.read_text())
        m = re.search(r'extern\s+"C"\s+int\s+fp_advance\s*\((.*?)\)\s*\{',
                      text, re.S)
        if m:
            return len(m.group(1).split(","))
    raise ValueError(f"no fp_advance in {kernel.source}")


class FewerArgs:
    """A K4 whose ``fp_advance`` takes the first ``argc - 1`` of this
    wrapper's arguments and the stream: the scratch this checkout passes
    before the stream is dropped."""

    def __init__(self, kernel, argc: int):
        self.kernel, self.argc = kernel, argc
        self.name = kernel.name

    def launch(self, *args) -> None:
        self.kernel.launch(*args[:self.argc - 1], args[-1])

    __call__ = launch


@contextlib.contextmanager
def swapped_entry(entry, kernel):
    """``entry`` launches through ``kernel`` inside the block."""
    saved = entry.kernel
    entry.kernel = kernel
    try:
        yield
    finally:
        entry.kernel = saved


def lanes_kernel(kernel, src: Path | None, part: int):
    """``kernel``'s CBL part ``part`` (6: the grid's, 8: a tile's) built
    with FP_CBL_LANES=1 from ``src`` (None: this checkout's)."""
    from flexpart_tpu_torch import _build
    flags = (f"-DFP_PART={part}", "-DFP_CBL_LANES=1")
    if src is None:
        return _build.Kernel(kernel.name, kernel.symbol, kernel.argtypes,
                             defines=flags)
    k = kernel_ab.source_kernel(kernel, src)
    k.parts, k.defines = 1, flags
    return k


def ts_cross_cases(device, grid, ab) -> dict:
    """K4's turbswitch crosses, which share K4's body with the CBL's stages,
    on chip_smoke.fixed_ts_crosses' cases at N_CROSS particles in cell
    order (settling without the polar caps, the two nests, a 1 x 1 tile),
    each through ``ab(q, height, tables, a, key, cfg, settle=,
    tables_n=)``: {case: ab's result}."""
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.run.simulation import nest_windows
    out = {}
    zc0, zc1 = cs.met_fields("synthetic", grid, device, (0.0, 10800.0))
    it, mem1 = 3600, 10800
    kc = rng.Key(4321, 29)
    ts = dict(turbswitch=True, ifine=4)
    cfg_s, prm_s = cs.settling_params(grid, settling=True, polar=False, **ts)
    tw_ = advance._time_weights(it, 0, mem1, prm_s, cfg_s)[:4]
    tab_s = interp.build_step_tables_quad(zc0, zc1, *tw_,
                                          dtype=cfg_s.table_dtype)
    q = reorder.reorder_by_cell_cuda(cs.boundary_layer_particles(
        cs.N_CROSS, device, 59, grid, it,
        lambda q: cs.sample_met(q, zc0.height, tab_s, cfg_s)[0]), zc0.height,
        cfg_s)[0]
    out["ts_cross_settling"] = ab(
        q, zc0.height, tab_s, advance.advance_args(cfg_s, prm_s, it, 0,
                                                   mem1), kc, cfg_s,
        settle=advance.settle_met(zc0, cfg_s))
    del q, tab_s
    ni = cs.nests_inputs(device, grid, (cs.NEST_OUTER, cs.NEST_INNER),
                         (cs.NEST_U_JET["outer"], cs.NEST_U_JET["inner"]), 31,
                         lambda a, nests: cs.nested_particles(
                             cs.N_CROSS, device, 61, grid, cs.NEST_ITIME,
                             nests))
    cn = advance.StepConfig(**{**ni["cfg"].__dict__, **ts, "polar": True})
    pn = advance.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=cs.LSYNC, fine=1.0 / cn.ifine,
        **nest_windows(grid, ni["nests"]))
    out["ts_cross_nests"] = ab(
        ni["p"], ni["height"], ni["tables"],
        advance.advance_args(cn, pn, cs.NEST_ITIME, 0, cs.NEST_MEM1), kc, cn,
        tables_n=ni["tables_n"])
    del ni
    ct, pt, *_ = cs.step_setup(grid, polar=True, **ts)
    tw_ = advance._time_weights(it, 0, mem1, pt, ct)[:4]
    eng = cs.tile_engines(ct, grid, (1, 1), cs.tiles_halo(grid, zc0))[0]
    zt0, _, tt, _ = cs.tile_inputs([eng], zc0, zc1, tw_, ct)[0]
    q = reorder.reorder_by_cell_cuda(cs.bench_particles(
        cs.N_CROSS, device, seed=67, old_fraction=0.5), zc0.height, ct)[0]
    out["ts_cross_tile"] = ab(
        q, zt0.height, tt,
        advance.advance_args(eng.cfg, pt, it, 0, mem1, eng.tile), kc, eng.cfg)
    del q, zt0, tt, zc0, zc1
    return out


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.met.synthetic import make_grid
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", nargs="?", type=Path)
    ap.add_argument("--variant", action="append", default=[], type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    k4 = {"this": _build.ADVANCE}
    k11 = {"this": _build.ADVANCE_ADAPTIVE}
    srcs = {"this": None}
    if args.old is not None:
        old = args.old.resolve()
        k4["old"] = kernel_ab.source_kernel(_build.ADVANCE, old / "advance.cu")
        k11["old"] = kernel_ab.source_kernel(_build.ADVANCE_ADAPTIVE,
                                             old / "advance_adaptive.cu")
        srcs["old"] = old / "advance.cu"
    for v in args.variant:
        name, k = kernel_ab.kernel_for(_build.ADVANCE, str(v), ROOT)
        k4[name] = k
        srcs[name] = v.resolve()
    names = list(k4)
    lanes = {}
    for name, src in srcs.items():
        texts = [f.read_text() for f in (
            k4[name].sources() if src is not None else
            _build.ADVANCE.sources())]
        if any("FP_CBL_LANES" in t for t in texts):
            lanes[name] = {part: lanes_kernel(_build.ADVANCE, src, part)
                           for part in (6, 8)}
    # an older fp_advance with fewer arguments takes the first ones and
    # the stream (FewerArgs)
    argc_this = len(_build.ADVANCE.argtypes)
    argcs = {name: fp_advance_argc(k) for name, k in k4.items()}
    for name, k in k4.items():
        if argcs[name] != argc_this:
            k.argtypes = (_build.ADVANCE.argtypes[:argcs[name] - 1]
                          + _build.ADVANCE.argtypes[-1:])
    build_s = _build.build_all(
        list(_build.KERNELS) + [k for n, k in k4.items() if n != "this"]
        + [k for n, k in k11.items() if n != "this"]
        + [k for d in lanes.values() for k in d.values()])
    launchers = {name: k if argcs[name] == argc_this
                 else FewerArgs(k, argcs[name]) for name, k in k4.items()}
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()

    def launch(kernel, q, height, tables, a, key, cfg, settle=None,
               tables_n=()):
        # a cross's entry launches through its kernel; the stock step is
        # the kernel itself
        entry = advance.k4_entry(cfg)
        with (kernel_ab.swapped("ADVANCE", kernel)
              if entry is _build.ADVANCE else swapped_entry(entry, kernel)):
            return advance.advance_all_cuda(q, height, tables, copy.copy(a),
                                            key, cfg, None, 0, settle,
                                            tables_n)

    def lane_efficiency(name, q, height, tables, a, key, cfg) -> dict:
        return cs.k4_cbl_lane_efficiency(
            q, height, tables, a, key, cfg,
            kernel=lanes[name][8 if cfg.tile_mode else 6])

    outs = advance.OUT_FIELDS + ("n_active", "n_exited", "nan_count")

    def ab(q, height, tables, a, key, cfg, plain: bool = False,
           settle=None, tables_n=()) -> dict:
        ref, out = None, {}
        for name in names:
            pk, dk = launch(launchers[name], q, height, tables, a, key, cfg,
                            settle, tables_n)
            if name == "this" and cfg.cblflag and not cfg.tile_mode:
                rule = int(advance.k4_cbl_deferred(q, height, tables, cfg,
                                                   a).sum())
                cs.check(int(dk.deferred) == rule,
                         f"K4 CBL deferred {int(dk.deferred)} particles, "
                         f"the plain rule {rule}")
                out["deferred"] = rule
            got = [getattr(pk, f) for f in advance.OUT_FIELDS] + [
                dk.n_active.reshape(1), dk.n_exited.reshape(1),
                dk.nan_count.reshape(1)]
            got = [g.view(torch.int32) if g.dtype == torch.float32 else g
                   for g in got]
            if ref is None:
                ref = got
            else:
                for f, x, y in zip(outs, got, ref):
                    cs.check(torch.equal(x, y),
                             f"{name}: {f} differs from this checkout's in "
                             f"{int((x != y).sum())} values")
            out[name] = lane_efficiency(name, q, height, tables, a, key,
                                        cfg) if (name in lanes
                                                 and cfg.cblflag) else {}
            del pk, dk, got
        out["nan_count"] = int(ref[-1])
        del ref
        if plain:
            r, _, _ = cs.check_fixed(q, height, tables, a, key, cfg, None,
                                     "K4 CBL this checkout")
            out["plain_bitwise"] = r["bitwise"]
        times = kernel_ab.in_turns(
            lambda name: launch(launchers[name], q, height, tables, a, key,
                                cfg, settle, tables_n), "this", names[1:],
            REPS, timer=cs.cuda_graph_ms)
        for name in names:
            out[name]["ms"] = times[name]
        torch.cuda.empty_cache()
        return out

    def profile(q, height, tables, a, key, cfg, calls: int = 5) -> dict:
        """Device ms a call of each kernel of each K4 (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile as prof_
        out = {}
        for name in names:
            launch(launchers[name], q, height, tables, a, key, cfg)
            torch.cuda.synchronize()
            with prof_(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    launch(launchers[name], q, height, tables, a, key, cfg)
                torch.cuda.synchronize()
            out[name] = {k[:60]: ms / calls for k, _, ms in
                         cs.device_rows(prof) if "advance" in k}
        return out

    cases = {}
    grid = make_grid(**cs.BENCH_GRID)
    itime = cs.FIXED_CBL_ITIME
    c = cs.fixed_cbl_inputs(device, grid, cs.N_MAIN, itime)
    z0, z1, cfg, prm, tw, tables, a = (c[k] for k in (
        "z0", "z1", "cfg", "prm", "tw", "tables", "a"))
    height = z0.height
    key = rng.Key(4321, 17)
    p = c["p"]
    ordered = reorder.reorder_by_cell_cuda(p, height, cfg)[0]
    for name, q in (("cell_ordered", ordered), ("as_drawn", p)):
        cases[name] = {
            **ab(q, height, tables, a, key, cfg, plain=name == "cell_ordered"),
            "shares": cs.fixed_cbl_shares(q, height, tables, cfg, a, itime)}
    ts = advance.StepConfig(**{**cfg.__dict__, "cblflag": False})
    a_ts = advance.advance_args(ts, prm, itime, 0, 10800)
    for name in ("cell_ordered",):
        cases[name]["profile"] = profile(ordered, height, tables, a, key, cfg)
    cases["cell_ordered"]["stock_k4_ts_ms"] = cs.cuda_graph_ms(
        lambda: advance.advance_all_cuda(ordered, height, tables,
                                         copy.copy(a_ts), key, ts, None, 0),
        REPS)

    # the same particles with the strong CBL in every column and in none
    zr0, zr1 = cs.met_fields("synthetic", grid, device, (0.0, 10800.0))
    for name, split in (("all_zone", 0), ("no_zone", grid.nx)):
        m0, m1 = (cs.convective_met(z, split) for z in (zr0, zr1))
        tz = interp.build_step_tables_quad(m0, m1, *tw,
                                           dtype=cfg.table_dtype)
        cases[name] = {
            **ab(ordered, height, tz, a, key, cfg, plain=name == "all_zone"),
            "shares": cs.fixed_cbl_shares(ordered, height, tz, cfg, a,
                                          itime),
            "profile": profile(ordered, height, tz, a, key, cfg)}
        del tz, m0, m1

    # K11 CBL on the kernels case in cell order: this checkout's and OLD's
    k11_cfg, k11_prm = cs.cbl_params(grid)
    a11 = advance.advance_args(k11_cfg, k11_prm, itime, 0, 10800)

    def launch11(name):
        with kernel_ab.swapped("ADVANCE_ADAPTIVE", k11[name]):
            return advance.advance_adaptive_cuda(
                ordered, height, tables, copy.copy(a11), key, k11_cfg, None,
                0)
    if "old" in k11:
        pa, da = launch11("this")
        pb, db = launch11("old")
        for f in advance.ADAPTIVE_OUT_FIELDS:
            cs.check(torch.equal(getattr(pa, f), getattr(pb, f)),
                     f"K11 CBL: {f} differs from the old source's")
        cs.check(torch.equal(da.lane_work, db.lane_work),
                 "K11 CBL: lane work differs from the old source's")
        del pa, pb, da, db
    cases["k11_cbl_cell_ordered"] = kernel_ab.in_turns(
        launch11, "this", [n for n in k11 if n != "this"], 3,
        timer=cs.cuda_graph_ms)

    # the host's part of a call: 2**14 particles, a call's host seconds
    # over many calls with the card synchronised at the end
    small = cs.every_kth(ordered, 640)

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    cases["host_2e14"] = kernel_ab.in_turns(
        lambda name: launch(launchers[name], small, height, tables, a, key,
                            cfg), "this", names[1:], 50, timer=host_ms)
    del small

    # K4 TILE x CBL on a 1 x 1 tile (fixed_cbl_tile's case)
    q = cs.every_kth(ordered, 10)
    eng = cs.tile_engines(cfg, grid, (1, 1), cs.tiles_halo(grid, z0))[0]
    zt0, _, tt, _ = cs.tile_inputs([eng], z0, z1, tw, cfg)[0]
    at = advance.advance_args(eng.cfg, prm, itime, 0, 10800, eng.tile)
    cases["tile_1x1"] = ab(q, zt0.height, tt, at, key, eng.cfg)
    del q, zt0, tt, p, ordered, tables
    torch.cuda.empty_cache()

    # the 8 steps of phase_fixed_cbl's path, each as the path hands it to K4
    c = cs.fixed_cbl_inputs(device, grid, cs.N_MAIN, itime, seed=73)
    p = c["p"]
    del c
    for i in range(cs.FIXED_CBL_STEPS):
        it = itime + i * cs.LSYNC
        if i % reorder.REORDER_EVERY == 0:
            p, _ = reorder.reorder_by_cell(p, height, cfg)
        tws = advance._time_weights(it, 0, 10800, prm, cfg)[:4]
        ts_ = interp.build_step_tables_quad(z0, z1, *tws,
                                            dtype=cfg.table_dtype)
        a_i = advance.advance_args(cfg, prm, it, 0, 10800)
        k_i = rng.Key(5, i)
        cases[f"fixed_cbl_step_{i}"] = ab(p, height, ts_, a_i, k_i, cfg)
        p, _ = advance.advance_all_cuda(p, height, ts_, copy.copy(a_i), k_i,
                                        cfg, None, 0)
        del ts_

    del p
    torch.cuda.empty_cache()

    cases.update(ts_cross_cases(device, grid, ab))

    # stock K4 on kernel_advance's main case: the main path's
    # configuration, steady particles in cell order
    cfg_m, prm_m, *_ = cs.step_setup(grid)
    zm0, zm1 = cs.met_fields("synthetic", grid, device, (0.0, 10800.0))
    tw_m = advance._time_weights(3600, 0, 10800, prm_m, cfg_m)[:4]
    tab_m = interp.build_step_tables_quad(zm0, zm1, *tw_m,
                                          dtype=cfg_m.table_dtype)
    q = reorder.reorder_by_cell_cuda(cs.bench_particles(
        cs.N_MAIN, device, seed=3, old_fraction=1.0), zm0.height, cfg_m)[0]
    cases["stock_k4_main"] = ab(
        q, zm0.height, tab_m, advance.advance_args(cfg_m, prm_m, 3600, 0,
                                                   10800),
        rng.Key(4321, 4), cfg_m)
    del q, tab_m, zm0, zm1
    torch.cuda.empty_cache()

    steps = [cases[f"fixed_cbl_step_{i}"] for i in
             range(cs.FIXED_CBL_STEPS)]
    # the stock instantiations' ptxas lines, this checkout's against OLD's
    stock = {}
    for what, ks in (("k4", k4), ("k11", k11)):
        if "old" in ks:
            lines = {n: {e: v for e, v in cs.ptxas_by_entry(
                ks[n].build_log).items() if "cbl" not in e
                and not re.search(r"adaptive\w*<\d,2,", e)}
                for n in ("this", "old")}
            stock[what] = dict(
                entries=len(lines["this"]),
                equal=lines["this"] == lines["old"],
                differing={e: [lines["old"].get(e), v] for e, v in
                           lines["this"].items() if lines["old"].get(e) != v})
    print(smi, flush=True)
    cs.emit({"k4c_ab": {
        "kernels": names, "device": torch.cuda.get_device_name(0),
        "power_limit": smi, "build_s": build_s,
        "layout": {n: cbl_layout(k) for n, k in k4.items()},
        "occupancy_this": cs.k4_cbl_occupancy(grid.nlev),
        "layout_k11": {n: cbl_layout(k) for n, k in k11.items()},
        "stock_ptxas": stock,
        "fixed_cbl_per_call_ms_best_of_turns": {
            n: sum(min(s[n]["ms"]) for s in steps) / len(steps)
            for n in names},
        "cases": cases}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

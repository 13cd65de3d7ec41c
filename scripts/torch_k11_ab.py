#!/usr/bin/env python3
"""Time the adaptive-step advance (K11) of this checkout beside K11s built
from other source files or with other compile-time constants, on the same
inputs, in one process on one CUDA card:

    python3 scripts/torch_k11_ab.py OTHER [OTHER ...]

Each OTHER is a ``.cu`` file exporting ``fp_advance_adaptive`` with this
checkout's arguments (``kernel_ab.source_kernel``): an older commit's
``advance_adaptive.cu``, with its ``advance_common.cuh`` beside it, or an
edited copy of this checkout's under ``build/`` (another
``MIN_BLOCKS_CBL``, another design of the pass); a header not beside it
is this checkout's.  A kernel with other arguments is compared by running
each commit's own ``chip_smoke.py`` in one call instead.

The inputs are those of ``chip_smoke.py``: the kernels phase's spread
ensemble (10 x 2**20 particles over the boundary layer of the sphere, in
cell order and as drawn) and every step of the sim_adaptive phase's
``Simulation.run``; the CBL instantiation's kernels case (the same
number of particles under a strong CBL over the eastern half, in cell
order and as drawn; the stock TS instantiation on the same particles
beside it) and every step of the sim_cbl phase's run.  A run's advance is
intercepted: each step's particles, tables and key are handed to every
kernel.  Each case is timed in turns (``kernel_ab.in_turns``, ``REPS``
launches each); every kernel must give this checkout's outputs bit for bit
(every field, ``idt``, ``t_below``, the passes, the counts and
``nan_count``).  On the CBL's kernels case each kernel's skewed work is
counted as chip_smoke.py's bound counts it (cbl_skewed_calls on the
particles, each call charged the cheapest path through its function: in
the kernel's own code where the function is a call there, else in the
checkout's cbl_calls_build).  Prints the card's name and power limit and
one JSON line, with each kernel's lane efficiency.
"""

from __future__ import annotations

import copy
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402

REPS = 5
FIELDS = ("cbl_skewed_wp", "cbl_skew", "cbl_fresh_wp")


def skewed_count(kernel, cfg, calls: dict) -> dict:
    """The skewed work of ``kernel``'s CBL instantiation on particles whose
    calls cbl_skewed_calls counted: each call charged the cheapest path
    through its function (cs.function_paths), read from the kernel where
    cbl_skewed_wp is a call there, else from the checkout's
    cs.cbl_calls_build()."""
    entry = cs.k11_entry(cfg)
    name = cs.sass_instantiation(kernel, "advance_adaptive_kernel", entry)[0]
    syms = cs.elf_functions(kernel, name)
    present = [f for f in FIELDS
               if any(re.search(r"\d%sE" % f, s) for s in syms)]
    src, read_from = kernel, "own"
    if "cbl_skewed_wp" not in present:
        src, read_from = cs.cbl_calls_build(), "cbl_calls_build"
        present = list(cs.CBL_SKEWED_FUNCTIONS)
    paths = cs.function_paths(src, "advance_adaptive_kernel", entry, present)
    return dict(read_from=read_from, paths=paths,
                instructions=sum(calls[f] * paths[f]["cheapest"]
                                 for f in paths))


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.met.synthetic import make_grid
    from flexpart_tpu_torch.run import simulation as simmod

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    this = _build.ADVANCE_ADAPTIVE
    others = [kernel_ab.kernel_for(this, a, ROOT) for a in sys.argv[1:]]
    names = ["this"] + [n for n, _ in others]
    kernels = dict([("this", this)] + others)
    build_s = _build.build_all(list(_build.KERNELS) + list(kernels.values())
                               [1:] + [cs.cbl_calls_build()])
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()

    def launch(name, q, height, tables, a, key, cfg, settle):
        with kernel_ab.swapped("ADVANCE_ADAPTIVE", kernels[name]):
            return advance.advance_adaptive_cuda(q, height, tables,
                                                 copy.copy(a), key, cfg, None,
                                                 0, settle)

    outs = advance.ADAPTIVE_OUT_FIELDS + ("t_below", "passes", "n_active",
                                          "n_exited", "nan_count")

    def ab(*inputs) -> dict:
        ref = None
        out = {}
        for name in names:
            pk, dk = launch(name, *inputs)
            got = [getattr(pk, f) for f in advance.ADAPTIVE_OUT_FIELDS] + [
                dk.t_below, dk.passes, dk.n_active.reshape(1),
                dk.n_exited.reshape(1), dk.nan_count.reshape(1)]
            got = [g.view(torch.int32) if g.dtype == torch.float32 else g
                   for g in got]
            if ref is None:
                ref = got
            else:
                for f, x, y in zip(outs, got, ref):
                    cs.check(torch.equal(x, y),
                             f"{name}: {f} differs from this checkout's in "
                             f"{int((x != y).sum())} values")
            out[name] = cs.lane_efficiency(dk.lane_work)
        times = kernel_ab.in_turns(lambda name: launch(name, *inputs),
                                   "this", names[1:], REPS)
        for name in names:
            out[name]["ms"] = times[name]
        out["passes_total"] = int(ref[len(advance.ADAPTIVE_OUT_FIELDS) + 1]
                                  .sum(dtype=torch.int64))
        return out

    cases = {}
    # the kernels phase's spread ensemble (the stock TS instantiation)
    grid = make_grid(**cs.BENCH_GRID)
    z0, z1 = cs.met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 9)
    cfg, prm = cs.settling_params(grid, turbswitch=True, ifine=4, method=1,
                                  settling=True, polar=True)
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    settle = advance.settle_met(z0, cfg)
    p = cs.boundary_layer_particles(
        cs.N_MAIN, device, 41, grid, itime,
        lambda q: cs.sample_met(q, z0.height, tables, cfg)[0])
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    for name, q in (("spread_cell_ordered", ordered), ("spread_as_drawn", p)):
        cases[name] = ab(q, z0.height, tables, a, key, cfg, settle)
    del p, ordered, tables, z0, z1
    torch.cuda.empty_cache()

    # the CBL's kernels case (chip_smoke.kernel_advance_cbl's inputs)
    z0, z1 = (cs.convective_met(z, grid.nx // 2) for z in
              cs.met_fields("synthetic", grid, device, (0.0, 10800.0)))
    key = rng.Key(4321, 13)
    cfg, prm = cs.cbl_params(grid)
    stock = advance.StepConfig(**{**cfg.__dict__, "cblflag": False})
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    a_stock = advance.advance_args(stock, prm, itime, 0, mem1)
    p = cs.boundary_layer_particles(
        cs.N_MAIN, device, 43, grid, itime,
        lambda q: cs.sample_met(q, z0.height, tables, cfg)[0])
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    for name, q in (("cbl_cell_ordered", ordered), ("cbl_as_drawn", p)):
        cases[name] = ab(q, z0.height, tables, a, key, cfg, None)
    cases["cbl_cell_ordered_stock_ts"] = ab(ordered, z0.height, tables,
                                            a_stock, key, stock, None)
    calls = cs.cbl_skewed_calls(ordered, z0.height, tables, a, key, cfg,
                                itime)
    skewed = {"calls": calls,
              **{n: skewed_count(k, cfg, calls) for n, k in kernels.items()}}
    del p, ordered, tables, z0, z1
    torch.cuda.empty_cache()

    # every step of the sim_adaptive and the sim_cbl runs
    inner = simmod.advance_all
    per_call = {}
    for path, run_dir, cmd_kw in (
            ("sim_adaptive", cs.SIM_ADAPTIVE_DIR, None),
            ("sim_cbl", cs.SIM_CBL_DIR, dict(cblflag=1))):
        shutil.rmtree(run_dir, ignore_errors=True)
        sim = cs.sim_adaptive_setup(run_dir / "ab", device, False,
                                    cmd_kw=cmd_kw)
        steps = {}

        def intercepted(p, z0, z1, itime, mt0, mt1, key, cfg, prm, **kw):
            tw = advance._time_weights(itime, mt0, mt1, prm, cfg)[:4]
            tables = interp.build_step_tables_quad(z0, z1, *tw,
                                                   dtype=cfg.table_dtype)
            a = advance.advance_args(cfg, prm, itime, mt0, mt1)
            steps[f"{path}_step_{len(steps)}"] = ab(
                p, z0.height, tables, a, key, cfg,
                advance.settle_met(z0, cfg))
            del tables
            return inner(p, z0, z1, itime, mt0, mt1, key, cfg, prm, **kw)

        simmod.advance_all = intercepted
        try:
            sim.run()
            torch.cuda.synchronize()
        finally:
            simmod.advance_all = inner
        del sim
        shutil.rmtree(run_dir, ignore_errors=True)
        cases.update(steps)
        per_call[path] = {n: sum(min(c[n]["ms"]) for c in steps.values())
                          / len(steps) for n in names}
    print(smi, flush=True)
    cs.emit({"k11_ab": {
        "kernels": names, "device": torch.cuda.get_device_name(0),
        "power_limit": smi, "build_s": build_s,
        "ptxas": {n: cs.ptxas_by_entry(k.build_log)
                  for n, k in kernels.items()},
        "per_call_ms_best_of_turns": per_call,
        "cbl_skewed_work": skewed,
        "cases": cases}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

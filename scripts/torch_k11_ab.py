#!/usr/bin/env python3
"""Time the adaptive-step advance (K11) of this checkout beside K11s built
from other source files, on the same inputs, in one process on one CUDA
card:

    python3 scripts/torch_k11_ab.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu exports ``fp_advance_adaptive`` with this checkout's
arguments (``kernel_ab.source_kernel``): this source with another
compile-time constant, for example, or an older commit's.  A kernel with
other arguments is compared by running each commit's own ``chip_smoke.py``
in one call instead.

The inputs are those of ``chip_smoke.py``: the kernels phase's spread
ensemble (10 x 2**20 particles over the boundary layer of the sphere, in
cell order and as drawn) and every step of the sim_adaptive phase's
``Simulation.run``, whose advance is intercepted: each step's particles,
tables and key are handed to every kernel.  Each case is timed in turns
(``kernel_ab.in_turns``, ``REPS`` launches each); every kernel must give
this checkout's outputs bit for bit (every field, ``idt``, ``t_below``,
the passes and the counts).  Prints the card's name and power limit and
one JSON line, with each kernel's lane efficiency.
"""

from __future__ import annotations

import copy
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402

REPS = 5


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.met.synthetic import make_grid
    from flexpart_tpu_torch.run import simulation as simmod

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    this = _build.ADVANCE_ADAPTIVE
    srcs = [Path(a).resolve() for a in sys.argv[1:]]
    names = ["this"] + [str(s.relative_to(ROOT)) if s.is_relative_to(ROOT)
                        else str(s) for s in srcs]
    kernels = dict(zip(names, [this] + [kernel_ab.source_kernel(this, s)
                                        for s in srcs]))
    build_s = _build.build_all(list(_build.KERNELS) + list(kernels.values())
                               [1:])
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()

    def launch(name, q, height, tables, a, key, cfg, settle):
        with kernel_ab.swapped("ADVANCE_ADAPTIVE", kernels[name]):
            return advance.advance_adaptive_cuda(q, height, tables,
                                                 copy.copy(a), key, cfg, None,
                                                 0, settle)

    def ab(*inputs) -> dict:
        ref = None
        out = {}
        for name in names:
            pk, dk = launch(name, *inputs)
            got = [getattr(pk, f) for f in advance.ADAPTIVE_OUT_FIELDS] + [
                dk.t_below, dk.passes, dk.n_active.reshape(1),
                dk.n_exited.reshape(1)]
            got = [g.view(torch.int32) if g.dtype == torch.float32 else g
                   for g in got]
            if ref is None:
                ref = got
            else:
                for f, x, y in zip(advance.ADAPTIVE_OUT_FIELDS
                                   + ("t_below", "passes", "n_active",
                                      "n_exited"), got, ref):
                    cs.check(torch.equal(x, y),
                             f"{name}: {f} differs from this checkout's in "
                             f"{int((x != y).sum())} values")
            out[name] = cs.lane_efficiency(dk.lane_work)
        times = kernel_ab.in_turns(lambda name: launch(name, *inputs),
                                   "this", names[1:], REPS)
        for name in names:
            out[name]["ms"] = times[name]
        out["passes_total"] = int(ref[-3].sum(dtype=torch.int64))
        return out

    cases = {}
    # the kernels phase's spread ensemble
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

    # every step of the sim_adaptive run
    shutil.rmtree(cs.SIM_ADAPTIVE_DIR, ignore_errors=True)
    sim = cs.sim_adaptive_setup(cs.SIM_ADAPTIVE_DIR / "ab", device, False)
    inner = simmod.advance_all
    steps = {}

    def intercepted(p, z0, z1, itime, mt0, mt1, key, cfg, prm, **kw):
        tw = advance._time_weights(itime, mt0, mt1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(z0, z1, *tw,
                                               dtype=cfg.table_dtype)
        a = advance.advance_args(cfg, prm, itime, mt0, mt1)
        steps[f"sim_adaptive_step_{len(steps)}"] = ab(
            p, z0.height, tables, a, key, cfg, advance.settle_met(z0, cfg))
        del tables
        return inner(p, z0, z1, itime, mt0, mt1, key, cfg, prm, **kw)

    simmod.advance_all = intercepted
    try:
        sim.run()
        torch.cuda.synchronize()
    finally:
        simmod.advance_all = inner
    del sim
    shutil.rmtree(cs.SIM_ADAPTIVE_DIR, ignore_errors=True)
    cases.update(steps)
    per_call = {n: sum(min(c[n]["ms"]) for c in steps.values()) / len(steps)
                for n in names}
    print(smi, flush=True)
    cs.emit({"k11_ab": {
        "kernels": names, "device": torch.cuda.get_device_name(0),
        "power_limit": smi, "build_s": build_s,
        "ptxas": {n: cs.ptxas_by_entry(k.build_log)
                  for n, k in kernels.items()},
        "sim_adaptive_per_call_ms_best_of_turns": per_call,
        "cases": cases}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

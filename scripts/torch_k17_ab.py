#!/usr/bin/env python3
"""Time the initial-condition scatter (K17) of this checkout beside a K17
built from another source file, on the same inputs, in one process on one
CUDA card:

    python3 scripts/torch_k17_ab.py OTHER.cu [--waves W,...] [--other-plan]

OTHER.cu exports ``fp_initcond`` with the arguments of the first K17 (one
thread per particle: no launch plan after the grid), e.g. ``git show
<commit>:flexpart_tpu_torch/csrc/initcond.cu > build/k17_old/initcond.cu``;
with ``--other-plan``, with this checkout's arguments (the launch plan
after the grid: a later K17, launched through this checkout's wrapper).
The inputs are those of ``chip_smoke.py``: the kernels phase's cases (10 x
2**20 deposition particles in cell order, a tenth masked, all, and a tenth
moved into a plume of 120 cells) and every K17 call of the
sim_initcond phase's ``Simulation.run`` (a backward run with linit_cond =
1: a call a step on the particles that ended in it, and one at the end on
the survivors, a retroplume), intercepted: each call's particles, mask and
fields are handed to both kernels, each adding into a grid of its own.
Each case is timed other, this, this, other (``REPS`` launches captured
in a CUDA graph and replayed, chip_smoke.cuda_graph_ms: a step's call on
an empty mask is shorter than the host takes to launch it), and both
grids must lie within K8's rule of the float64 sum of the pairs
(chip_smoke.held_against_f64).
``--waves``: this checkout's kernel also with its plan made for each of
these numbers of waves of resident blocks (``k17_plan``'s ``waves``),
timed and held alike as ``this_waves<W>``.  Prints the card's name and
power limit and one JSON line.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402

REPS = 20


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.grid import initcond as ic
    from flexpart_tpu_torch.met.synthetic import make_grid

    argv = sys.argv[1:]
    waves = []
    if "--waves" in argv:
        at = argv.index("--waves")
        waves = [int(w) for w in argv[at + 1].split(",")]
        del argv[at:at + 2]
    other_plan = "--other-plan" in argv
    args = [a for a in argv if not a.startswith("--")]
    if len(args) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    names = ["other", "this"] + [f"this_waves{w}" for w in waves]
    plan = ic.k17_plan
    other_src = Path(args[0]).resolve()
    this = _build.INITCOND
    # the first K17's arguments: this one's without the plan's three ints
    other = kernel_ab.source_kernel(
        this, other_src,
        None if other_plan else this.argtypes[:-4] + this.argtypes[-1:])
    _build.build_all([this, other])
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()

    def launch(name, grid, p, mask, zf, oh, cfg):
        if name.startswith("this_waves"):
            w = int(name[len("this_waves"):])
            ic.k17_plan = lambda n, nspec, sms: plan(n, nspec, sms, w)
            try:
                ic.initcond_cuda(grid, p, mask, zf, oh, cfg)
            finally:
                ic.k17_plan = plan
            return
        if name == "this" or other_plan:
            with kernel_ab.swapped("INITCOND",
                                   this if name == "this" else other):
                ic.initcond_cuda(grid, p, mask, zf, oh, cfg)
            return
        # the older launcher: initcond_cuda's arguments without the plan
        rho = zf.f3d[ic.F3_RHO]
        nz, ny, nx = rho.shape

        def c(v):
            return float(ic.np.float32(v))

        other(p.x_hi.data_ptr(), p.x_lo.data_ptr(), p.y_hi.data_ptr(),
              p.y_lo.data_ptr(), p.z.data_ptr(), p.npoint.data_ptr(),
              p.mass.data_ptr(), mask.data_ptr(), rho.data_ptr(),
              zf.height.data_ptr(), nz, ny, nx, int(cfg.linit_cond == 1),
              oh.data_ptr(), cfg.nzg, p.capacity, p.nspec, cfg.nxg, cfg.nyg,
              cfg.npointspec, int(cfg.ioutputforeachrelease), c(cfg.dx_met),
              c(cfg.dy_met), c(cfg.xoutshift), c(cfg.youtshift),
              c(cfg.dxout), c(cfg.dyout), grid.data_ptr(),
              torch.cuda.current_stream(device).cuda_stream)

    def ab(p, mask, zf, oh, cfg) -> dict:
        grids = {}
        for name in names:
            g = ic.zero_init_cond(cfg, p.nspec, device)
            launch(name, g, p, mask, zf, oh, cfg)
            grids[name] = g.view(-1, p.nspec)
        out = dict(masked=int(mask.sum()))
        if out["masked"]:
            lin, valid, contrib = ic.initcond_pairs(p, mask, zf, oh, cfg)
            out.update(cs.held_against_f64(grids, lin[valid], contrib[valid],
                                           cs.K17_RTOL, "K17 A/B"))
            del lin, valid, contrib
        else:
            cs.check(not any(bool(g.any()) for g in grids.values()),
                     "K17 A/B: an empty mask added something")
        g = ic.zero_init_cond(cfg, p.nspec, device)
        times = kernel_ab.in_turns(
            lambda name: launch(name, g, p, mask, zf, oh, cfg), "this",
            [n for n in names if n != "this"], REPS, cs.cuda_graph_ms)
        out.update({f"{n}_ms": times[n] for n in names})
        return out

    cases = {}
    grid = make_grid(**cs.BENCH_GRID)
    cfg, _, og, geo, _ = cs.step_setup(grid)
    zf = cs.met_fields("synthetic", grid, device)[0]
    spread = cs.depo_particles(cs.N_MAIN, device, 67, grid)
    p, _ = reorder.reorder_by_cell(spread, zf.height, cfg)
    plume, in_plume = cs.initcond_plume(spread, device, 73, grid)
    plume, perm = reorder.reorder_by_cell(plume, zf.height, cfg)
    in_plume = in_plume[perm.long()]
    del spread
    icfg = ic.InitCondConfig(
        nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg, npointspec=1,
        dxout=og.dxout, dyout=og.dyout, xoutshift=geo.xoutshift,
        youtshift=geo.youtshift, dx_met=grid.dx, dy_met=grid.dy,
        linit_cond=1)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(71)
    died = p.active & (torch.rand(p.capacity, generator=gen,
                                  device=device) < 0.1)
    for name, q, mask in (("died", p, died), ("run_end", p, p.active),
                          ("plume", plume, in_plume)):
        cases[name] = ab(q, mask, zf, oh, icfg)
    del p, plume, died, in_plume
    torch.cuda.empty_cache()

    # every K17 call of the sim_initcond run
    shutil.rmtree(cs.SIM_IC_DIR, ignore_errors=True)
    sim = cs.sim_backward_setup(cs.SIM_IC_DIR / "ab", device, False,
                                cmd_kw=dict(linit_cond=1, iout=5))
    inner = ic.initcond_cuda
    steps = {}

    def intercepted(g, q, mask, zf, oh, cfg):
        ic.initcond_cuda = inner
        try:
            steps[f"sim_initcond_call_{len(steps)}"] = ab(q, mask, zf, oh,
                                                          cfg)
        finally:
            ic.initcond_cuda = intercepted
        inner(g, q, mask, zf, oh, cfg)

    ic.initcond_cuda = intercepted
    try:
        sim.run()
        torch.cuda.synchronize()
    finally:
        ic.initcond_cuda = inner
    del sim
    shutil.rmtree(cs.SIM_IC_DIR, ignore_errors=True)
    cases.update(steps)
    per_call = {n: sum(min(c[f"{n}_ms"]) for c in steps.values())
                / len(steps) for n in names}
    print(smi, flush=True)
    cs.emit({"k17_ab": {
        "other": str(other_src.relative_to(ROOT))
        if other_src.is_relative_to(ROOT) else other_src.name,
        "this": str(this.source.relative_to(ROOT)),
        "device": torch.cuda.get_device_name(0), "power_limit": smi,
        "ptxas": {"this": cs.ptxas_by_entry(this.build_log),
                  "other": cs.ptxas_by_entry(other.build_log)},
        "sim_initcond_per_call_ms_best_of_turns": per_call,
        "cases": cases}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

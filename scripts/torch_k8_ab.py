#!/usr/bin/env python3
"""Time the deposit scatter (K8) of this checkout beside a K8 built from
another source file, on the same inputs, in one process on one CUDA card:

    python3 scripts/torch_k8_ab.py OTHER.cu

OTHER.cu exports ``fp_depo_scatter`` with this checkout's arguments: an
older commit's ``flexpart_tpu_torch/csrc/depo_scatter.cu``, for example
``git show <commit>:flexpart_tpu_torch/csrc/depo_scatter.cu >
build/k8_other/depo_scatter.cu``.  The inputs are those of
``chip_smoke.py``: the kernels phase's spread ensemble (10 x 2**20
particles over the globe, two species, the decay and dry pass's deposit,
cell-ordered and as drawn), its two plumes (``plume_dense``,
``plume_sparse``) and the wet and dry deposits of the two steps that the
sim phase keeps from ``Simulation.run``.  Each case is timed other, this,
this, other (CUDA events, 10 launches each, after a warm-up), and the two
grids must agree within max(1e-4, pairs in the cell x 2**-22) of each
other.  Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.met.synthetic import make_grid
    from flexpart_tpu_torch.physics import massupdate as mu
    from flexpart_tpu_torch.physics import wetdepo as wd

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    other_src = Path(sys.argv[1]).resolve()
    this = _build.DEPO_SCATTER
    other = kernel_ab.source_kernel(this, other_src)
    _build.build_all([this])
    _build.build_all([other])      # the same library if the sources agree
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()

    def launch(kernel, flat, dep, p, itime, lage, ccfg):
        with kernel_ab.swapped("DEPO_SCATTER", kernel):
            wd.depo_scatter_cuda(flat, dep, p, itime, lage, ccfg)

    def ab(p, dep, itime, lage, ccfg) -> dict:
        rows = (ccfg.nage * ccfg.nclassunc * ccfg.npointspec * ccfg.nyg
                * ccfg.nxg)
        grids = {}
        for name, k in (("other", other), ("this", this)):
            g = torch.zeros((rows, dep.shape[0]), dtype=torch.float32,
                            device=device)
            launch(k, g, dep, p, itime, lage, ccfg)
            grids[name] = g
        nage_idx = wd.depo_age_class(p, itime, lage, ccfg.nage)
        kp = (p.npoint if ccfg.ioutputforeachrelease
              else torch.zeros_like(p.npoint)).long()
        lin, valid, _ = wd.depo_pairs(rows, dep, p, nage_idx, kp, ccfg)
        pairs = torch.zeros(rows, dtype=torch.float64, device=device)
        pairs.index_add_(0, lin[valid], torch.ones_like(lin[valid],
                                                        dtype=torch.float64))
        del lin, valid
        a, b = grids["other"].double(), grids["this"].double()
        tol = torch.clamp(pairs * 2.0 ** -22, min=1e-4)[:, None]
        d = (a - b).abs()
        cs.check(bool(torch.all(d <= tol * a.abs())),
                 f"the two kernels differ: max abs {float(d.max())}")
        g = grids["this"]
        kernels = {"other": other, "this": this}
        times = kernel_ab.in_turns(
            lambda name: launch(kernels[name], g, dep, p, itime, lage, ccfg),
            "this", ["other"], 10)
        return dict(other_ms=times["other"], this_ms=times["this"],
                    cells_hit=int((pairs > 0).sum()),
                    most_pairs_in_a_cell=int(pairs.max()),
                    max_abs_diff=float(d.max()))

    grid = make_grid(**cs.BENCH_GRID)
    cfg, _, _, _, ccfg = cs.step_setup(grid)
    ccfg = ccfg.replace(nage=2)
    lage = torch.tensor([3600, 999999999], dtype=torch.int32, device=device)
    species = cs.depo_species()
    msp = mu.MassSpecies(decay=tuple(s.decay for s in species),
                         drydep=tuple(s.drydep for s in species))
    (z0,) = cs.met_fields("synthetic", grid, device, (3600.0,))
    gen = torch.Generator(device=device)
    gen.manual_seed(22)
    vdep = torch.rand((len(species), grid.ny, grid.nx), generator=gen,
                      device=device) * 0.02
    cases = {}
    p = cs.depo_particles(cs.N_MAIN, device, 23, grid)
    for oname, q in (("as_drawn", p), ("cell_ordered",
                     reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0])):
        dep = mu.decay_drydep_cuda(q, vdep, cs.LSYNC, 2700, msp, True)[1]
        cases[f"spread_dry_{oname}"] = ab(q, dep, 10800, lage, ccfg)
    del p, q, dep
    q, deposits = cs.plume_particles(cs.N_MAIN, device, 24, grid)
    q = reorder.reorder_by_cell_cuda(q, z0.height, cfg)[0]
    for kind, dep in deposits.items():
        cases[kind] = ab(q, dep, 10800, lage, ccfg)
    del q, deposits
    torch.cuda.empty_cache()

    # the sim phase's run, with the two steps it keeps
    shutil.rmtree(cs.SIM_DIR, ignore_errors=True)
    sim = cs.sim_setup(cs.SIM_DIR / "ab", device, False)
    release_steps = sorted(t // cs.LSYNC for t in sim._release_times)
    nsteps = cs.SIM_HOURS * 3600 // cs.LSYNC
    keep = {release_steps[len(release_steps) // 2]: "release_step",
            nsteps - 1: "steady_step"}
    snaps = {}

    def probe(istep, itime):
        if istep in keep:
            snaps[keep[istep]] = (istep, itime, sim.particles,
                                  *sim._fields_for(itime))

    sim._step_probe = probe
    sim.run()
    torch.cuda.synchronize()
    wet, msp = sim.wet_species, sim.mass_species
    for name, (istep, itime, p, zf0, zf1, mt0, mt1) in snaps.items():
        loutnext = 3600 * max(1, -(-itime // 3600))
        ldeltat = itime - (loutnext - 3600)
        interp_t = itime - cs.LSYNC // 2
        zw = zf0 if abs(mt0 - interp_t) < abs(mt1 - interp_t) else zf1
        wdep = wd.wetdepo_cuda(p, zw, cs.LSYNC, ldeltat, wet, msp)[1]
        ddep = mu.decay_drydep_cuda(p, zf1.vdep, cs.LSYNC, ldeltat, msp,
                                    True)[1]
        cases[f"sim_{name}_{istep}_wet"] = ab(p, wdep, itime, sim.lage,
                                              sim.conc_cfg)
        cases[f"sim_{name}_{istep}_dry"] = ab(p, ddep, itime + cs.LSYNC,
                                              sim.lage, sim.conc_cfg)
    del sim, snaps
    shutil.rmtree(cs.SIM_DIR, ignore_errors=True)
    print(smi, flush=True)
    cs.emit({"k8_ab": {"other": str(other_src.relative_to(ROOT))
                       if other_src.is_relative_to(ROOT) else other_src.name,
                       "this": str(this.source.relative_to(ROOT)),
                       "device": torch.cuda.get_device_name(0),
                       "power_limit": smi, "cases": cases}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

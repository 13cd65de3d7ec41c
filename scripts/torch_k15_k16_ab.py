#!/usr/bin/env python3
"""Time the receptor sampling (K15) and the gross fluxes (K16) of this
checkout beside a K15 and a K16 built from other source files, on the same
inputs, in one process on one CUDA card:

    python3 scripts/torch_k15_k16_ab.py OTHER_RECEPTORS.cu OTHER_FLUXES.cu \
        [--prior PRIOR_RECEPTORS.cu PRIOR_FLUXES.cu] [--other-only]

The OTHER and PRIOR files export ``fp_receptors`` and ``fp_fluxes`` with
this checkout's arguments: the first K15 and K16, e.g.

    mkdir -p build/k1516_old
    for f in receptors.cu fluxes.cu; do
      git show 287f772:flexpart_tpu_torch/csrc/$f > build/k1516_old/$f; done

or edited copies of this checkout's under ``build/`` (a header beside a
file is found before csrc/'s).  ``--other-only`` builds this checkout's
kernels but times the OTHER ones alone: the old kernels' breakdown, taken
before a new kernel is first timed.

The inputs: ``chip_smoke.py``'s K15 cases (receptor_inputs: ``fill``,
``surface``, ``at_receptors``) and K16's (flux_inputs), and every K15 and
K16 call of a ``sim_domainfill`` run (sim_domainfill_setup), intercepted:
each call's inputs handed to every kernel before the run's own call.  On
each input every kernel is held to its check (K15 bitwise against the plain
twin; K16 against the float64 sum of its pairs, K8's rule, each kernel
adding into a zero flux array of its own), then timed other, prior, this,
this, prior, other: ``REPS`` calls captured into one CUDA graph and
replayed (chip_smoke.cuda_graph_ms; K16's calls add into one scratch flux
array), and once more by torch.profiler per launch
(chip_smoke.profiled_in_place).  The bounds of each input by what it needs
(chip_smoke.k15_bounds, k16_bound).  Prints the card's name and power
limit, one JSON line per input as it is done ({"k15_k16_ab_case": ...}),
and one JSON line of them all.
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
    from flexpart_tpu_torch.grid import fluxes as fx
    from flexpart_tpu_torch.grid import receptors as rc
    from flexpart_tpu_torch.met.synthetic import make_grid

    args, prior = sys.argv[1:], []
    other_only = "--other-only" in args
    args = [a for a in args if a != "--other-only"]
    if "--prior" in args:
        at = args.index("--prior")
        prior, args = args[at + 1:at + 3], args[:at] + args[at + 3:]
        if len(prior) != 2:
            raise SystemExit(__doc__)
    if len(args) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    srcs = [Path(a).resolve() for a in args + prior]
    names = (["other"] if other_only else
             ["other", "this"] + (["prior"] if prior else []))
    kernels = {"receptors": {"this": _build.RECEPTORS},
               "fluxes": {"this": _build.FLUXES}}
    for i, kname in enumerate(("receptors", "fluxes")):
        built = kernels[kname]["this"]
        kernels[kname]["other"] = kernel_ab.source_kernel(built, srcs[i])
        if prior:
            kernels[kname]["prior"] = kernel_ab.source_kernel(built,
                                                              srcs[2 + i])
    _build.build_all(list(dict.fromkeys(
        k for d in kernels.values() for k in d.values())))
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    inner_rec, inner_flux = rc.sample_receptors_cuda, fx.calcfluxes_cuda

    def sample(name, *a):
        with kernel_ab.swapped("RECEPTORS", kernels["receptors"][name]):
            return inner_rec(*a)

    def flux(name, f, *a):
        with kernel_ab.swapped("FLUXES", kernels["fluxes"][name]):
            inner_flux(f, *a)

    def timed(launch) -> dict:
        """Every kernel in turns, by graphs; then once more per launch by
        the profiler."""
        this = "this" if "this" in names else names[0]
        times = kernel_ab.in_turns(launch, this,
                                   [n for n in names if n != this], REPS,
                                   cs.cuda_graph_ms)
        out = {f"{n}_ms": times[n] for n in names}
        for n in names:
            prof = cs.profiled_in_place(lambda: None, lambda _: launch(n))
            out[f"{n}_profiled_ms"] = prof["device_ms"]
            out[f"{n}_per_launch"] = prof["per_launch"]
        return out

    def done(name, out) -> dict:
        cs.emit({"k15_k16_ab_case": name, **out})
        return out

    def ab_receptors(creceptor, rec, p, itime, weight, dx, dy) -> dict:
        c0 = torch.zeros_like(creceptor)
        plain = rc.sample_receptors_plain(c0, rec, p, itime, 1.0, dx, dy)
        for name in names:
            k = sample(name, c0, rec, p, itime, 1.0, dx, dy)
            cs.check(torch.equal(k.view(torch.int32),
                                 plain.view(torch.int32)),
                     f"K15 A/B {name}: differs from the plain version by "
                     f"{float((k - plain).abs().max())}")
        b = cs.k15_bounds(p, rec, itime, dx, dy)
        out = dict(itime=itime, bitwise=True, **{f: b[f] for f in (
            "bound_ms", "bound_by", "bound_all_slots_ms", "live", "near",
            "pairs_past_gate", "pairs_inside", "particles_inside")})
        out.update(timed(lambda name: sample(name, c0, rec, p, itime, 1.0,
                                             dx, dy)))
        return out

    def ab_fluxes(p, *a) -> dict:
        # calcfluxes' arguments after the particles: xold, yold, zold,
        # itime, lage, outheight, ohhalf, cfg[, ioutputforeachrelease]
        per_release = a[8] if len(a) > 8 else True
        cfg = a[7]
        idx, valid = fx.flux_pairs(p, *a[:8], per_release)
        lin = idx[valid]
        contrib = p.mass[torch.nonzero(valid, as_tuple=True)[0]]
        del idx, valid
        grids = {}
        for name in names:
            g = fx.zero_flux(cfg, p.nspec, device)
            flux(name, g, p, *a[:8], per_release)
            grids[name] = g.view(-1, p.nspec)
        out = dict(itime=a[3])
        if lin.numel():
            out.update(cs.held_against_f64(grids, lin, contrib, cs.K16_RTOL,
                                           "K16 A/B"))
        else:
            cs.check(not any(bool(g.any()) for g in grids.values()),
                     "K16 A/B: a crossing added where there is none")
            out.update(pairs=0, cells_hit=0)
        del grids, lin, contrib
        b = cs.k16_bound(p, a[3], per_release, out["cells_hit"])
        out.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        scratch = fx.zero_flux(cfg, p.nspec, device)
        out.update(timed(lambda name: flux(name, scratch, p, *a[:8],
                                           per_release)))
        del scratch
        return out

    res = {}
    grid = make_grid(**cs.BENCH_GRID)
    rec = cs.df_receptors(grid, device)
    for name, p in cs.receptor_inputs(device, grid):
        c0 = torch.zeros((rec.x.shape[0], p.nspec), dtype=torch.float32,
                         device=device)
        res[f"k15_{name}"] = done(f"k15_{name}", ab_receptors(
            c0, rec, p, cs.K15_ITIME, 1.0, grid.dx, grid.dy))
        del p
    torch.cuda.empty_cache()
    res["k16_moved"] = done("k16_moved",
                            ab_fluxes(*cs.flux_inputs(device, grid)))
    torch.cuda.empty_cache()

    # every K15 and K16 call of a sim_domainfill run, each A/B before the
    # run's own call
    calls = {"receptors": {}, "fluxes": {}}

    def sampling_call(creceptor, rec, p, itime, weight, dx, dy):
        d = calls["receptors"]
        name = f"sim_domainfill_k15_call_{len(d)}"
        d[name] = done(name, ab_receptors(creceptor, rec, p, itime, weight,
                                          dx, dy))
        return inner_rec(creceptor, rec, p, itime, weight, dx, dy)

    def flux_call(f, p, *a):
        d = calls["fluxes"]
        name = f"sim_domainfill_k16_call_{len(d)}"
        d[name] = done(name, ab_fluxes(p, *a))
        inner_flux(f, p, *a)

    shutil.rmtree(cs.SIM_DF_DIR, ignore_errors=True)
    sim = cs.sim_domainfill_setup(cs.SIM_DF_DIR / "ab", device, False)
    rc.sample_receptors_cuda, fx.calcfluxes_cuda = sampling_call, flux_call
    try:
        sim.run()
        torch.cuda.synchronize()
    finally:
        rc.sample_receptors_cuda, fx.calcfluxes_cuda = inner_rec, inner_flux
    del sim
    shutil.rmtree(cs.SIM_DF_DIR, ignore_errors=True)
    per_call = {}
    for kname, got in calls.items():
        cs.check(len(got) > 0, f"A/B: no {kname} call of sim_domainfill "
                 "intercepted")
        per_call[kname] = {
            n: sum(min(c[f"{n}_ms"]) for c in got.values()) / len(got)
            for n in names}
        per_call[kname]["calls"] = len(got)
        res.update(got)
    print(smi, flush=True)
    cs.emit({"k15_k16_ab": {
        **{key: [str(s.relative_to(ROOT)) if s.is_relative_to(ROOT)
                 else s.name for s in part]
           for key, part in (("other", srcs[:2]), ("prior", srcs[2:]))},
        "timed": names,
        "device": torch.cuda.get_device_name(0), "power_limit": smi,
        "ptxas": {kname: {n: cs.ptxas_by_entry(k.build_log)
                          for n, k in d.items()}
                  for kname, d in kernels.items()},
        "sim_domainfill_per_call_ms_best_of_turns": per_call,
        "cases": res}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the backward deposition run's sampling (K3's BKDEP body) and its
dry factor (K10's BKDEP instantiation) of this checkout beside a K3 and a
K10 built from other source files, on the same inputs, in one process on
one CUDA card:

    python3 scripts/torch_k3b_k10b_ab.py OTHER_CONCCALC.cu OTHER_DRYDEPO.cu

The OTHER files are the first K3 BKDEP and K10 BKDEP (template flags of
the stock bodies), e.g.

    mkdir -p build/k3b10b_old
    for f in conccalc.cu drydepo.cu at_least_zero.cuh; do
      git show 5e5884b:flexpart_tpu_torch/csrc/$f > build/k3b10b_old/$f; done

(a header beside a file is found before csrc/'s); both take this
checkout's arguments.  More K3s are timed beside them, edited copies of
this checkout's written to build/k3b10b_variants/ (K3_VARIANTS): 256
rounds of direct atomics after a table that found few repeats (64), and
the table left where it found fewer than 16 additions a row (8).

The inputs: K3 BKDEP on chip_smoke.py's cases (the spread ensemble on
both paths, bkdep_plume_particles' BKDEP_PLUMES) and on every K3 BKDEP
call of sim_bkdep's three runs (recorded by chip_smoke.BkdepCalls); K10
BKDEP on kernel_bkdep's particles with half and with all the slots fresh,
and on every K10 BKDEP call of sim_bkdep's DRYBKDEP run.  On each input
every kernel is held to its check (K3 within K3_RTOL of the plain twin on
the spread cases, within K8's rule of the float64 sum of its pairs on the
plumes and the calls; K10's mass and xscav bitwise), then timed other,
the variants, this, this, the variants, other: ``REPS`` calls captured into
one CUDA graph and replayed (chip_smoke.cuda_graph_ms), and once more per
launch by torch.profiler (chip_smoke.profiled_in_place); beside them the
stock K3 on the same particles and index_add_ of the call's pairs (K3),
and each input's bound by need.  Prints the card's name and power limit,
each kernel's ptxas lines, one JSON line per input as it is done
({"k3b_k10b_ab_case": ...}), and one JSON line of them all.
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
VARIANTS = ROOT / "build" / "k3b10b_variants"
AB_DIR = ROOT / "build" / "k3b10b_ab"


# K3 variants beside this checkout's: edits of its source (the text in
# it, the text put in its place)
K3_VARIANTS = {
    "direct_rounds_256": ("constexpr int DIRECT_ROUNDS = 64;",
                          "constexpr int DIRECT_ROUNDS = 256;"),
    "reuse_16": ("constexpr int REUSE = 8;", "constexpr int REUSE = 16;"),
}


def k3_variants(this) -> dict:
    """The K3 variants of K3_VARIANTS, each an edited copy of this
    checkout's source under build/k3b10b_variants/<name>/."""
    text = this.source.read_text()
    out = {}
    for name, (want, put) in K3_VARIANTS.items():
        if want not in text:
            raise SystemExit(f"{this.source}: no '{want}' to edit")
        d = VARIANTS / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "conccalc.cu").write_text(text.replace(want, put))
        out[name] = kernel_ab.source_kernel(this, d / "conccalc.cu")
    return out


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    from flexpart_tpu_torch.met.synthetic import make_grid
    from flexpart_tpu_torch.physics import bkdep as bk

    args = sys.argv[1:]
    if len(args) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    srcs = [Path(a).resolve() for a in args]
    k3 = {"this": _build.CONCCALC,
          "other": kernel_ab.source_kernel(_build.CONCCALC, srcs[0]),
          **k3_variants(_build.CONCCALC)}
    k10 = {"this": _build.DRYDEPO,
           "other": kernel_ab.source_kernel(_build.DRYDEPO, srcs[1])}
    _build.build_all(list(dict.fromkeys([*k3.values(), *k10.values(),
                                         *_build.KERNELS])))
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    ptxas = {"conccalc": {n: cs.ptxas_by_entry(k.build_log)
                          for n, k in k3.items()},
             "drydepo": {n: cs.ptxas_by_entry(k.build_log)
                         for n, k in k10.items()}}
    cs.emit({"k3b_k10b_ab_ptxas": ptxas})

    def timed(launch, names) -> dict:
        """Every kernel in turns, by graphs; then once more per launch by
        the profiler."""
        times = kernel_ab.in_turns(launch, "this",
                                   [n for n in names if n != "this"], REPS,
                                   cs.cuda_graph_ms)
        out = {f"{n}_ms": times[n] for n in names}
        for n in names:
            prof = cs.profiled_in_place(lambda: None, lambda _: launch(n))
            out[f"{n}_profiled_ms"] = prof["device_ms"]
            out[f"{n}_per_launch"] = prof["per_launch"]
        return out

    def done(name, out) -> dict:
        cs.emit({"k3b_k10b_ab_case": name, **out})
        return out

    # ---- K3 BKDEP ----
    def sample(name, flat, p, a):
        with kernel_ab.swapped("CONCCALC_BKDEP",
                               _build.Entry(k3[name], "conccalc.bkdep")):
            cc.conccalc_cuda(flat, p, *a)

    def ab_k3(p, shape, a, plume: bool, what: str) -> dict:
        rows, nspec = shape
        fp_ = torch.zeros(shape, dtype=torch.float32, device=device)
        cc.conccalc_plain(fp_, p, *a)
        lin, valid, contrib = cc.conccalc_pairs(rows, p, *a)
        lin, contrib = lin[valid], contrib[valid]
        del valid
        out = {}
        for name in k3:
            fk = torch.zeros_like(fp_)
            sample(name, fk, p, a)
            torch.cuda.synchronize()
            r = cs.held_k3(fk, fp_, lin, contrib, plume, f"{what} {name}")
            out[f"{name}_max_abs_err"] = r["max_abs_err"]
            out.update({f: r[f] for f in ("pairs", "cells_hit",
                                          "most_pairs_in_a_cell") if f in r})
        fk = torch.zeros_like(fp_)
        out.update(timed(lambda name: sample(name, fk, p, a), list(k3)))
        stock = a[-1].replace(bkdep=False)
        out["stock_k3_ms"] = cs.cuda_graph_ms(
            lambda: cc.conccalc_cuda(fk, p, *a[:-1], stock), REPS)
        flat_l = torch.zeros_like(fp_)
        out["library_ms"] = cs.cuda_graph_ms(
            lambda: flat_l.index_add_(0, lin, contrib), REPS)
        out.update(kernel_possible=a[-1].kernel_possible, n=p.capacity,
                   **cs.k3_bound(p, a[0], lin, nspec, True, a[4] is not None))
        del fk, fp_, flat_l, lin, contrib
        torch.cuda.empty_cache()
        return out

    res = {}
    grid = make_grid(**cs.BENCH_GRID)
    cfg, _, og, geo, ccfg = cs.step_setup(grid)
    (z0,) = cs.met_fields("synthetic", grid, device)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    shape = tuple(zero_accumulators(geo, 2, 1, device="cpu").gridunc
                  .view(-1, 2).shape)
    spread = reorder.reorder_by_cell_cuda(cs.backward_conccalc_particles(
        device, 2), z0.height, cfg)[0]
    for kp in (False, True):
        name = f"k3_spread_{'4point' if kp else 'single'}"
        a = (cs.BKDEP_ITIME, lage, oh, 1.0, None,
             ccfg.replace(kernel_possible=kp, bkdep=True))
        res[name] = done(name, ab_k3(spread, shape, a, False, name))
    del spread
    for case, aged, kp in cs.BKDEP_PLUMES:
        name = f"k3_{case}"
        p = cs.bkdep_plume_particles(device, grid, aged)
        a = (cs.BKDEP_ITIME, lage, oh, 1.0, None,
             ccfg.replace(kernel_possible=kp, bkdep=True))
        res[name] = done(name, ab_k3(p, shape, a, True, name))
        del p

    # ---- K10 BKDEP ----
    def factor(name, q, vdep):
        with kernel_ab.swapped("DRYDEPO_BKDEP",
                               _build.Entry(k10[name], "drydepo.bkdep")):
            return bk.assign_drybkdep_cuda(q, vdep)

    def ab_k10(q, vdep, what) -> dict:
        pl = bk.assign_drybkdep_plain(q, vdep)
        out = {}
        for name in k10:
            k = factor(name, q, vdep)
            torch.cuda.synchronize()
            r = cs.held_bkdep(k, pl, q, f"{what} {name}")
            out.update(zeroed=r["zeroed"], positive=r["positive"],
                       fresh=r["fresh"], bitwise=True)
            del k
        del pl
        out.update(timed(lambda name: factor(name, q, vdep), list(k10)))
        out.update(n=q.capacity, **cs.k10_bkdep_bound(q, vdep))
        return out

    q = reorder.reorder_by_cell_cuda(cs.bkdep_particles(cs.depo_particles(
        cs.N_MAIN, device, 23, grid), device, 24), z0.height, cfg)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    vdep = torch.rand((2, grid.ny, grid.nx), generator=gen,
                      device=device) * 0.022 - 0.002
    res["k10_half_fresh"] = done("k10_half_fresh", ab_k10(q, vdep,
                                                          "K10 half fresh"))
    q = q.replace(xscav=torch.full_like(q.xscav, -1.0))
    res["k10_all_fresh"] = done("k10_all_fresh", ab_k10(q, vdep,
                                                        "K10 all fresh"))
    del q, vdep
    torch.cuda.empty_cache()

    # ---- every call of sim_bkdep's three runs ----
    calls = cs.BkdepCalls()
    shutil.rmtree(AB_DIR, ignore_errors=True)
    for mode, name, clwc in ((3, "wetbkdep", False), (4, "drybkdep", False),
                             (3, "wetbkdep_clwc", True)):
        sim = cs.sim_backward_setup(AB_DIR / name, device, False,
                                    n=cs.N_BKDEP, hours=1, ind_receptor=mode,
                                    release_hours=0, lout=1800, use_clwc=clwc)
        with calls:
            sim.run()
        torch.cuda.synchronize()
        del sim
    shutil.rmtree(AB_DIR, ignore_errors=True)
    cs.check(len(calls.k3) > 0 and len(calls.k10) > 0,
             f"A/B: {len(calls.k3)} K3 and {len(calls.k10)} K10 BKDEP calls")
    got = {"k3": {}, "k10": {}}
    for i, (p, shp, a) in enumerate(calls.k3):
        name = f"sim_bkdep_k3_call_{i}"
        got["k3"][name] = done(name, ab_k3(p, shp, a, True, name))
    for i, (q, vdep) in enumerate(calls.k10):
        name = f"sim_bkdep_k10_call_{i}"
        got["k10"][name] = done(name, ab_k10(q, vdep, name))
    calls.k3.clear()
    calls.k10.clear()

    per_call = {}
    for kname, kernels, extra in (("k3", k3, ("library_ms", "stock_k3_ms")),
                                  ("k10", k10, ())):
        rows = got[kname]
        per_call[kname] = {n: sum(min(c[f"{n}_ms"]) for c in rows.values())
                           / len(rows) for n in kernels}
        for f in extra + ("bound_ms",):
            per_call[kname][f] = sum(c[f] for c in rows.values()) / len(rows)
        per_call[kname]["calls"] = len(rows)
        res.update(rows)
    cs.emit({"k3b_k10b_ab": {
        "other": [str(s.relative_to(ROOT)) if s.is_relative_to(ROOT)
                  else s.name for s in srcs],
        "timed": {"conccalc": list(k3), "drydepo": list(k10)},
        "device": torch.cuda.get_device_name(0), "power_limit": smi,
        "ptxas": ptxas, "per_call_ms_best_of_turns": per_call,
        "cases": {n: {f: v for f, v in c.items() if "per_launch" not in f}
                  for n, c in res.items()}}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

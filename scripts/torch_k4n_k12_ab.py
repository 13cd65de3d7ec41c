#!/usr/bin/env python3
"""Time the nested-met advance (K4's NESTS instantiation) and the OH
reaction (K12) of this checkout beside a K4 and a K12 built from other
source files, on the same inputs, in one process on one CUDA card:

    python3 scripts/torch_k4n_k12_ab.py OTHER_ADVANCE.cu OTHER_OHREACTION.cu

The OTHER files are the first K4 NESTS and K12, e.g.

    mkdir -p build/k4n12_old
    for f in advance.cu advance_common.cuh philox_normal.cuh cell_index.cuh \
             ohreaction.cu at_least_zero.cuh; do
      git show 1d43594:flexpart_tpu_torch/csrc/$f > build/k4n12_old/$f; done

(a header beside a file is found before csrc/'s).  OTHER_ADVANCE.cu takes
this checkout's arguments; OTHER_OHREACTION.cu takes them without the scan
flag (it scans every axis).  Two more K12s are timed beside them: the
checkout's with THREADS = 768 (an edited copy written to
build/k4n12_variants/), and scripts/k12_bulk_blend.cu (the blended field
written by a launch of its own, each block pulling it with one bulk
asynchronous copy).

The inputs: K4 NESTS on chip_smoke.py's two-nest case (nests_two_inputs:
in cell order, and as drawn; the stock K4 on the same particles timed
too) and its overlapping windows (nests_overlap_inputs), and on every K4
NESTS call of a sim_nested run (intercepted: each call's inputs handed to
every kernel before the run's own call); K12 on the kernels phase's
particles (in cell order, as drawn; in cell order with no species
reacting, the species loop's share), its edge particles, an OH grid with
descending longitudes (the checkout's SCAN instantiation) and every K12
call of a straight sim_oh_split run.  On each input every kernel is held
to its check (K4 against the plain advance with K1's draws injected, every
output bitwise; K12's mass bitwise against its plain version), then timed
other, the variants, this, this, the variants, other: ``REPS`` calls
captured into one CUDA graph and replayed (chip_smoke.cuda_graph_ms),
and once more per launch by torch.profiler (chip_smoke.profiled_in_place).
Prints the card's name and power limit, each kernel's ptxas lines, one JSON
line per input as it is done ({"k4n_k12_ab_case": ...}), and one JSON line
of them all.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402

REPS = {"k4": 8, "k12": 20}
VARIANTS = ROOT / "build" / "k4n12_variants"


def k12_variants(this) -> dict:
    """The K12 variants beside this checkout's: THREADS = 768 (an edited
    copy) and the bulk copy (scripts/k12_bulk_blend.cu)."""
    from flexpart_tpu_torch import _build
    VARIANTS.mkdir(parents=True, exist_ok=True)
    text = this.source.read_text()
    want = "constexpr int THREADS = 1024;"
    if want not in text:
        raise SystemExit(f"{this.source}: no '{want}' to edit")
    t768 = VARIANTS / "ohreaction.cu"
    t768.write_text(text.replace(want, "constexpr int THREADS = 768;"))
    bulk = _build.Kernel("k12_bulk_blend", "fp_ohreaction_bulk",
                         this.argtypes[:-1] + [_build.P, _build.P])
    return {"t768": kernel_ab.source_kernel(this, t768),
            "bulk": kernel_ab.source_kernel(
                bulk, ROOT / "scripts" / "k12_bulk_blend.cu")}


def main() -> int:
    import torch
    from flexpart_tpu_torch import SyntheticMet, _build
    from flexpart_tpu_torch.core import advance, rng
    from flexpart_tpu_torch.physics import ohchem
    from flexpart_tpu_torch.met.synthetic import make_grid

    args = sys.argv[1:]
    if len(args) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    srcs = [Path(a).resolve() for a in args]
    k4 = {"this": _build.ADVANCE,
          "other": kernel_ab.source_kernel(_build.ADVANCE, srcs[0])}
    # the old K12 takes the arguments without the scan flag
    old_types = _build.OHREACTION.argtypes[:-3] + _build.OHREACTION.argtypes[-2:]
    k12 = {"this": _build.OHREACTION,
           "other": kernel_ab.source_kernel(_build.OHREACTION, srcs[1],
                                            old_types),
           **k12_variants(_build.OHREACTION)}
    _build.build_all(list(dict.fromkeys([*k4.values(), *k12.values(),
                                         *_build.KERNELS])))
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    ptxas = {"advance": {n: cs.ptxas_by_entry(k.build_log)
                         for n, k in k4.items()},
             "ohreaction": {n: cs.ptxas_by_entry(k.build_log)
                            for n, k in k12.items()}}
    cs.emit({"k4n_k12_ab_ptxas": ptxas})
    inner_adv = advance.advance_all_cuda

    def timed(launch, names, reps) -> dict:
        """Every kernel in turns, by graphs; then once more per launch by
        the profiler."""
        times = kernel_ab.in_turns(launch, "this",
                                   [n for n in names if n != "this"], reps,
                                   cs.cuda_graph_ms)
        out = {f"{n}_ms": times[n] for n in names}
        for n in names:
            prof = cs.profiled_in_place(lambda: None, lambda _: launch(n))
            out[f"{n}_profiled_ms"] = prof["device_ms"]
            out[f"{n}_per_launch"] = prof["per_launch"]
        return out

    def done(name, out) -> dict:
        cs.emit({"k4n_k12_ab_case": name, **out})
        return out

    # ---- K4 NESTS ----
    def nests(name, c, draws=None):
        with kernel_ab.swapped("ADVANCE", k4[name]):
            return inner_adv(c["p"], c["height"], c["tables"], c["a"],
                             c["key"], c["cfg"], draws, c["offset"],
                             c["settle"], c["tables_n"])[0]

    def ab_nests(c, stock=None):
        """Both K4s on the call ``c`` (advance_all_cuda's arguments by
        name) against the plain advance with injected draws (every output
        bitwise), then timed with their draws in registers."""
        p, key, cfg = c["p"], c["key"], c["cfg"]
        draws = {tag: rng.normals(key, (rows, p.capacity), tag, c["offset"],
                                  device=device)
                 for tag, rows in advance.draw_tags(cfg).items()}
        pp = advance.advance_all_plain(
            p, c["height"], c["tables"], c["a"], key, cfg, draws,
            c["offset"], c["settle"], tables_n=c["tables_n"])[0]
        for name in k4:
            pk = nests(name, c, draws)
            differ = cs.differing_particles(pk, pp, advance.OUT_FIELDS)
            cs.check(differ == 0, f"K4 NESTS A/B {name}: differs from the "
                     f"plain version in {differ} particles")
            del pk
        del pp, draws
        out = dict(n=p.capacity, bitwise=True)
        out.update(timed(lambda name: nests(name, c), list(k4), REPS["k4"]))
        if stock is not None:
            a_stock, cfg_stock = stock
            out["stock_k4_ms"] = cs.cuda_graph_ms(lambda: inner_adv(
                p, c["height"], c["tables"], a_stock, key, cfg_stock, None,
                0)[0], REPS["k4"])
        return out

    def case_of(c, order):
        """A kernels-phase case as advance_all_cuda's arguments by name."""
        return dict(p=c["p"] if order == "cell_order" else c["drawn"],
                    height=c["height"], tables=c["tables"], a=c["a"],
                    key=c["key"], cfg=c["cfg"], offset=0, settle=None,
                    tables_n=c["tables_n"])

    res = {}
    grid = make_grid(**cs.BENCH_GRID)
    c = cs.nests_two_inputs(device, grid)
    for order in ("cell_order", "as_drawn"):
        res[f"k4n_{order}"] = done(f"k4n_{order}", ab_nests(
            case_of(c, order), (c["a_stock"], c["stock"])))
    del c
    torch.cuda.empty_cache()
    c = cs.nests_overlap_inputs(device, grid, cs.N_OVERLAP)
    res["k4n_overlapping"] = done("k4n_overlapping",
                                  ab_nests(case_of(c, "cell_order")))
    del c
    torch.cuda.empty_cache()

    calls = {"nests": {}, "oh": {}}

    def nests_call(p, height, tables, a, key, cfg, draws, offset,
                   settle=None, tables_n=()):
        if cfg.nests and draws is None:
            d = calls["nests"]
            name = f"sim_nested_k4n_call_{len(d)}"
            d[name] = done(name, ab_nests(dict(
                p=p, height=height, tables=tables, a=a, key=key, cfg=cfg,
                offset=offset, settle=settle, tables_n=tables_n)))
        return inner_adv(p, height, tables, a, key, cfg, draws, offset,
                         settle, tables_n)

    shutil.rmtree(cs.SIM_NESTED_DIR, ignore_errors=True)
    ngrid = cs.nest_grid(cs.make_sim_grid(), cs.SIM_NEST)
    sim = cs.sim_setup(cs.SIM_NESTED_DIR / "ab", device, False,
                       met_nests=(SyntheticMet(
                           ngrid, u_jet=cs.NEST_U_JET["inner"]),))
    advance.advance_all_cuda = nests_call
    try:
        sim.run()
        torch.cuda.synchronize()
    finally:
        advance.advance_all_cuda = inner_adv
    del sim
    shutil.rmtree(cs.SIM_NESTED_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- K12 ----
    def oh(name, p, g, args):
        a, _specs = ohchem.k12_arguments(p, g, *args)
        mass = torch.empty_like(p.mass)
        stream = torch.cuda.current_stream(device).cuda_stream
        k = k12[name]
        if name == "other":
            k(*a, mass.data_ptr(), stream)
        elif name == "bulk":
            blended = torch.empty(len(g.lon) * len(g.lat) * len(g.alt_top),
                                  dtype=torch.float32, device=device)
            k(*a, int(g.scan), mass.data_ptr(), blended.data_ptr(), stream)
        else:
            k(*a, int(g.scan), mass.data_ptr(), stream)
        return mass

    def ab_oh(p, g, args) -> dict:
        plain = ohchem.ohreaction_plain(p, g, *args).mass
        for name in k12:
            m = oh(name, p, g, args)
            cs.check(torch.equal(m.view(torch.int32), plain.view(torch.int32)),
                     f"K12 A/B {name}: differs from the plain version")
        noh = len(g.lon) * len(g.lat) * len(g.alt_top)
        b = cs.k12_bound(p.capacity, int(p.active.sum()), p.nspec, noh,
                         args[6].shape[0])
        out = dict(n=p.capacity, active=int(p.active.sum()), scan=g.scan,
                   bitwise=True, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"])
        out.update(timed(lambda name: oh(name, p, g, args), list(k12),
                         REPS["k12"]))
        return out

    _, g, args, p, ps = cs.oh_inputs(device, grid)
    for name, q in (("cell_order", ps), ("as_drawn", p)):
        res[f"k12_{name}"] = done(f"k12_{name}", ab_oh(q, g, args))
    # the species loop's share: the same particles with no species
    # reacting (every mass written through)
    inert = dataclasses.replace(g, consts=(None,) * len(g.consts))
    res["k12_cell_order_no_reaction"] = done(
        "k12_cell_order_no_reaction", ab_oh(ps, inert, args))
    edge = cs.oh_edge_particles(cs.N_OH_EDGE, device, 31, grid, g)
    res["k12_edges"] = done("k12_edges", ab_oh(edge, g, args))
    del edge, p
    _, gu, args_u = cs.oh_fields(cs.oh_unsorted_field(), device, grid)
    res["k12_unsorted_scan"] = done("k12_unsorted_scan",
                                    ab_oh(ps, gu, args_u))
    del ps
    torch.cuda.empty_cache()

    shutil.rmtree(cs.SIM_OH_DIR, ignore_errors=True)
    sim = cs.sim_oh_split_setup(cs.SIM_OH_DIR / "ab", device,
                                capacity=cs.OH_CAPACITY)
    inner_oh = sim._ohreaction

    def oh_call(p, *a):
        d = calls["oh"]
        name = f"sim_oh_split_k12_call_{len(d)}"
        d[name] = done(name, ab_oh(p, inner_oh.grid, a))
        return inner_oh(p, *a)

    sim._ohreaction = oh_call
    sim.run()
    torch.cuda.synchronize()
    del sim
    shutil.rmtree(cs.SIM_OH_DIR, ignore_errors=True)

    per_call = {}
    for kname, kernels in (("nests", k4), ("oh", k12)):
        got = calls[kname]
        cs.check(len(got) > 0, f"A/B: no {kname} call intercepted")
        per_call[kname] = {
            n: sum(min(c[f"{n}_ms"]) for c in got.values()) / len(got)
            for n in kernels}
        per_call[kname]["calls"] = len(got)
        per_call[kname]["bound_ms"] = (
            sum(c["bound_ms"] for c in got.values()) / len(got)
            if kname == "oh" else None)
        res.update(got)
    cs.emit({"k4n_k12_ab": {
        "other": [str(s.relative_to(ROOT)) if s.is_relative_to(ROOT)
                  else s.name for s in srcs],
        "timed": {"advance": list(k4), "ohreaction": list(k12)},
        "device": torch.cuda.get_device_name(0), "power_limit": smi,
        "ptxas": ptxas, "per_call_ms_best_of_turns": per_call,
        "cases": res}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

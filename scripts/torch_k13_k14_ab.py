#!/usr/bin/env python3
"""Time the splitting (K13) and the domain fill's boundary step (K14) of
this checkout beside a K13 and a K14 built from other source files, on the
same inputs, in one process on one CUDA card:

    python3 scripts/torch_k13_k14_ab.py OTHER_SPLIT.cu OTHER_DOMAINFILL.cu \
        [--prior PRIOR_SPLIT.cu PRIOR_DOMAINFILL.cu]

The OTHER files export ``fp_split`` and ``fp_domainfill`` with the
arguments of the first K13 and K14 (their flags as bytes in schedule-origin
order, their scratch allocated by the wrapper on every call), e.g.

    mkdir -p build/k1314_old
    for f in split.cu domainfill.cu block_scan.cuh; do
      git show ef8bd4e:flexpart_tpu_torch/csrc/$f > build/k1314_old/$f; done

The PRIOR files, where given, export them with this checkout's arguments
(an earlier revision of the current design, its ``origin_rank.cuh``
beside them), and are timed in the same turns.

The inputs: ``chip_smoke.py``'s cases (kernel_split's three at 12 x 2**20
slots, kernel_boundcond's MDOMAINFILL 1 and 2 at 11 x 2**20), and every K13
call of a ``sim_oh_split`` run (sim_oh_split_setup, no checkpoint) and
every K14 call of a ``sim_domainfill`` run (sim_domainfill_setup),
intercepted: each call's particles and arguments handed to every kernel.
On each input, every kernel is held bitwise against the plain twin (every
particle field and the counts; K14's accumulator too), then timed other,
this, this, other: ``REPS`` calls, each on the input restored by copies,
captured into one CUDA graph and replayed, less the copies' graph alone
(chip_smoke.graph_in_place_ms); and once more by torch.profiler per
launch (chip_smoke.profiled_in_place, each call on a copy made before the
window).  The bounds of each input by bytes and by 32-byte sectors
(chip_smoke.k13_bounds, k14_bounds).
Prints the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402

REPS = 10
P, I, U32, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# the first K13's and K14's exported functions
OLD_SPLIT_ARGS = [P, P, I, I, I, I, P, P, P, P, P, P, P, P, I, P]
OLD_DOMAINFILL_ARGS = ([P, P, I, I, P, I, P, P, P, P, I, I, I]
                       + [F] * 8 + [I, I, F, F, I, I, I, U32, U32]
                       + [P] * 3 + [P] * 11 + [P, I, P])
OLD_TILE = 4096


def old_split(kernel, p, itime, ldirect=1, origin=None):
    """The first K13's wrapper: flags and ints allocated on every call."""
    import torch
    from flexpart_tpu_torch.core.state import FIELDS
    n, dev = p.capacity, p.device
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    tiles = -(-n // OLD_TILE)
    flags = torch.zeros((2, tiles * OLD_TILE), dtype=torch.uint8, device=dev)
    ints = torch.empty(3 * n + 2 * tiles, dtype=torch.int32, device=dev)
    fields = (ctypes.c_void_p * len(FIELDS))(
        *(getattr(p, f).data_ptr() for f in FIELDS))
    at, step = ints.data_ptr(), ints.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        kernel(ctypes.addressof(fields),
               None if origin is None else origin.data_ptr(), n, p.nspec,
               int(itime), int(ldirect), flags[0].data_ptr(),
               flags[1].data_ptr(), at, at + step * n,
               at + step * (n + tiles), at + step * (n + 2 * tiles),
               at + step * (2 * n + 2 * tiles), counts.data_ptr(), sms,
               stream)
    return p, counts


def old_boundcond(kernel, p, bs, f0, f1, height, itime, w0, w1, key,
                  lsynctime, itsplit, ylat0, dy, mdomainfill=1, ldirect=1,
                  nclassunc=1, check_x=True, origin=None, draws=None):
    """The first K14's wrapper: flags, ints and candidates allocated on
    every call."""
    import numpy as np
    import torch
    from flexpart_tpu_torch.core import domainfill as df
    from flexpart_tpu_torch.core.state import FIELDS
    n, dev, s = p.capacity, p.device, bs.sites
    xpp, xlo, xhi, ylo, yhi = bs.limits()
    acc = torch.empty_like(bs.acc)
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    tiles = -(-n // OLD_TILE)
    wishes = df.KMAX_EMIT * s
    wtiles = -(-wishes // OLD_TILE)
    free_o = torch.zeros(tiles * OLD_TILE, dtype=torch.uint8, device=dev)
    want = torch.zeros(wtiles * OLD_TILE, dtype=torch.uint8, device=dev)
    ints = torch.empty(n + tiles + wtiles + 2 * wishes, dtype=torch.int32,
                       device=dev)
    cand = torch.empty(4 * wishes, dtype=torch.float32, device=dev)
    fields = (ctypes.c_void_p * len(FIELDS))(
        *(getattr(p, f).data_ptr() for f in FIELDS))
    table = (ctypes.c_void_p * 15)(
        *(getattr(bs, f).data_ptr() for f in df.BOUNDARY_FIELDS[:15]))
    nz, ny, nx = f0.shape[1:]
    at, step = ints.data_ptr(), ints.element_size()
    cat, cstep = cand.data_ptr(), cand.element_size()
    k0, k1 = key.philox_key(df.BOUNDARY_TAG)

    def c(v):
        return float(np.float32(v))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        kernel(ctypes.addressof(fields),
               None if origin is None else origin.data_ptr(), n, p.nspec,
               ctypes.addressof(table), s, acc.data_ptr(), f0.data_ptr(),
               f1.data_ptr(), height.data_ptr(), nz, ny, nx, c(w0), c(w1),
               c(lsynctime), c(xpp), c(xlo), c(xhi), c(ylo), c(yhi),
               int(check_x), int(mdomainfill), c(ylat0), c(dy), int(itime),
               int(itime) + int(ldirect) * int(itsplit), int(nclassunc), k0,
               k1, *((None, None, None) if draws is None
                     else tuple(d.data_ptr() for d in draws)),
               free_o.data_ptr(), at, at + step * n, want.data_ptr(),
               at + step * (n + tiles), at + step * (n + tiles + wtiles),
               at + step * (n + tiles + wtiles + wishes), cat,
               cat + cstep * wishes, cat + 2 * cstep * wishes,
               cat + 3 * cstep * wishes, counts.data_ptr(), sms, stream)
    return acc, counts


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import domainfill as df
    from flexpart_tpu_torch.core import split as sp
    from flexpart_tpu_torch.core.state import FIELDS
    from flexpart_tpu_torch.met.synthetic import make_grid
    from flexpart_tpu_torch.run import simulation as simmod

    args, prior = sys.argv[1:], []
    if "--prior" in args:
        at = args.index("--prior")
        prior, args = args[at + 1:at + 3], args[:at] + args[at + 3:]
        if len(prior) != 2:
            raise SystemExit(__doc__)
    if len(args) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    srcs = [Path(a).resolve() for a in args + prior]
    names = ["other", "this"] + (["prior"] if prior else [])
    kernels = {
        "split": {"this": _build.SPLIT,
                  "other": kernel_ab.source_kernel(_build.SPLIT, srcs[0],
                                                   OLD_SPLIT_ARGS)},
        "domainfill": {"this": _build.DOMAINFILL,
                       "other": kernel_ab.source_kernel(
                           _build.DOMAINFILL, srcs[1], OLD_DOMAINFILL_ARGS)}}
    if prior:
        kernels["split"]["prior"] = kernel_ab.source_kernel(_build.SPLIT,
                                                            srcs[2])
        kernels["domainfill"]["prior"] = kernel_ab.source_kernel(
            _build.DOMAINFILL, srcs[3])
    for d in kernels.values():
        if d["other"]._lib_path() == d["this"]._lib_path():
            d["other"] = d["this"]          # one source: built once
    _build.build_all(list(dict.fromkeys(
        k for d in kernels.values() for k in d.values())))
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    inner_split, inner_bound = sp.split_particles_cuda, df.boundcond_cuda

    def split(name, p, *a):
        if name == "other":
            return old_split(kernels["split"]["other"], p, *a)
        with kernel_ab.swapped("SPLIT", kernels["split"][name]):
            return inner_split(p, *a)

    def bound(name, p, *a, **kw):
        if name == "other":
            return old_boundcond(kernels["domainfill"]["other"], p, *a, **kw)
        with kernel_ab.swapped("DOMAINFILL", kernels["domainfill"][name]):
            return inner_bound(p, *a, **kw)

    def timed(launch, p) -> dict:
        """Every kernel on ``p`` (restored before each call), in turns, by
        graphs; then once more by the profiler."""
        work = cs.clone_particles(p)

        def restore():
            for f in FIELDS:
                getattr(work, f).copy_(getattr(p, f))

        times = kernel_ab.in_turns(
            lambda name: launch(name, work), "this",
            [n for n in names if n != "this"], REPS,
            lambda fn, reps: cs.graph_in_place_ms(restore, fn, reps))
        out = {f"{n}_ms": times[n] for n in names}
        for n in names:
            prof = cs.profiled_in_place(lambda: cs.clone_particles(p),
                                        lambda q: launch(n, q))
            out[f"{n}_profiled_ms"] = prof["device_ms"]
            out[f"{n}_per_launch"] = prof["per_launch"]
        del work
        return out

    def ab_split(p, itime, ldirect, origin) -> dict:
        ref, cref = sp.split_particles_plain(cs.clone_particles(p), itime,
                                             ldirect, origin)
        for name in names:
            k, ck = split(name, cs.clone_particles(p), itime, ldirect,
                          origin)
            cs.check(ck.tolist() == cref.tolist(),
                     f"K13 A/B {name}: counts {ck.tolist()} / "
                     f"{cref.tolist()}")
            cs.check_same_bits(k, ref, f"K13 A/B {name}", FIELDS)
            del k
        parents, children = cs.split_pairs(p, ref)
        out = dict(itime=itime, due_free_granted=cref.tolist(),
                   origin=origin is not None, bitwise=True,
                   **cs.k13_bounds(p, itime, ldirect, origin is not None,
                                   parents, children))
        del ref
        out.update(timed(lambda name, q: split(name, q, itime, ldirect,
                                               origin), p))
        return out

    def ab_bound(p, *a, **kw) -> dict:
        # boundcond's arguments after the particles: bs, f0, f1, height,
        # itime, ..., mdomainfill (12), ldirect, nclassunc, check_x (15)
        bs, f0, itime = a[0], a[1], a[4]
        md = kw.get("mdomainfill", a[12] if len(a) > 12 else 1)
        check_x = kw.get("check_x", a[15] if len(a) > 15 else True)
        origin = kw.get("origin", a[16] if len(a) > 16 else None)
        ref = cs.clone_particles(p)
        acc_p, cref = df.boundcond_plain(ref, *a, **kw)
        for name in names:
            k = cs.clone_particles(p)
            acc_k, ck = bound(name, k, *a, **kw)
            cs.check(ck.tolist() == cref.tolist(),
                     f"K14 A/B {name}: counts {ck.tolist()} / "
                     f"{cref.tolist()}")
            cs.check_same_bits(k, ref, f"K14 A/B {name}", FIELDS)
            cs.check(torch.equal(acc_k.view(torch.int32),
                                 acc_p.view(torch.int32)),
                     f"K14 A/B {name}: the accumulators differ")
            del k
        _, xlo, xhi, ylo, yhi = bs.limits()
        x, y = p.x, p.y
        outside = (y < ylo) | (y > yhi)
        if check_x:
            outside = outside | (x < xlo) | (x > xhi)
        killed = p.active & outside
        born = ref.active & (~p.active | killed)
        cs.check(int(born.sum()) == cref.tolist()[3]
                 and int(killed.sum()) == cref.tolist()[0],
                 f"K14 A/B: killed and born slots {cref.tolist()}")
        out = dict(itime=itime, killed_free_wanted_granted=cref.tolist(),
                   mdomainfill=md, bitwise=True,
                   **cs.k14_bounds(p, origin is not None, bs, f0.shape[1],
                                   f0.shape[2] * f0.shape[3], md, check_x,
                                   torch.nonzero(killed).flatten(),
                                   torch.nonzero(born).flatten()))
        del ref
        out.update(timed(lambda name, q: bound(name, q, *a, **kw), p))
        return out

    res = {}
    grid = make_grid(**cs.BENCH_GRID)
    for name, p, origin in cs.split_inputs(device, grid, cs.OH_CAPACITY):
        res[f"k13_{name}"] = ab_split(p, cs.OH_ITIME, 1, origin)
        del p
        torch.cuda.empty_cache()
    p, origin, bs, step = cs.boundcond_inputs(device, grid)
    for md in (1, 2):
        res[f"k14_mdomainfill_{md}"] = ab_bound(p, bs, *step, md, 1, 1,
                                                True, origin)
    del p, bs
    torch.cuda.empty_cache()

    # every K13 call of a sim_oh_split run, every K14 call of a
    # sim_domainfill run
    calls = {}

    def split_call(p, itime, ldirect, origin):
        calls[f"sim_oh_split_call_{len(calls)}"] = ab_split(
            cs.clone_particles(p), itime, ldirect,
            None if origin is None else origin.clone())
        return sp.split_particles(p, itime, ldirect, origin)

    shutil.rmtree(cs.SIM_OH_DIR, ignore_errors=True)
    sim = cs.sim_oh_split_setup(cs.SIM_OH_DIR / "ab", device,
                                capacity=cs.OH_CAPACITY)
    simmod.split_particles = split_call
    try:
        sim.run()
        torch.cuda.synchronize()
    finally:
        simmod.split_particles = sp.split_particles
    del sim
    shutil.rmtree(cs.SIM_OH_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    n_split = len(calls)
    boundcond = df.boundcond

    def bound_call(p, *a, **kw):
        calls[f"sim_domainfill_call_{len(calls) - n_split}"] = ab_bound(
            cs.clone_particles(p), *a, **kw)
        return boundcond(p, *a, **kw)

    shutil.rmtree(cs.SIM_DF_DIR, ignore_errors=True)
    sim = cs.sim_domainfill_setup(cs.SIM_DF_DIR / "ab", device, False)
    df.boundcond = bound_call
    try:
        sim.run()
        torch.cuda.synchronize()
    finally:
        df.boundcond = boundcond
    del sim
    shutil.rmtree(cs.SIM_DF_DIR, ignore_errors=True)
    res.update(calls)
    per_call = {}
    for path, prefix in (("sim_oh_split", "sim_oh_split_call_"),
                         ("sim_domainfill", "sim_domainfill_call_")):
        got = [c for k, c in calls.items() if k.startswith(prefix)]
        cs.check(len(got) > 0, f"A/B: no call of {path} intercepted")
        per_call[path] = {
            n: sum(min(c[f"{n}_ms"]) for c in got) / len(got)
            for n in names}
        per_call[path]["calls"] = len(got)
    print(smi, flush=True)
    cs.emit({"k13_k14_ab": {
        **{key: [str(s.relative_to(ROOT)) if s.is_relative_to(ROOT)
                 else s.name for s in part]
           for key, part in (("other", srcs[:2]), ("prior", srcs[2:]))},
        "device": torch.cuda.get_device_name(0), "power_limit": smi,
        "ptxas": {kname: {n: cs.ptxas_by_entry(k.build_log)
                          for n, k in d.items()}
                  for kname, d in kernels.items()},
        "per_call_ms_best_of_turns": per_call, "cases": res}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A short first check of the advance and the backward run's kernels on
the card.

    python3 scripts/torch_advance_check.py [n_particles] [check ...]

Builds every kernel (one nvcc per source, all started together), prints
the card's name and power limit, the build's seconds and the ptxas
registers, stack and spills of every kernel's instantiations (empty where
build/kernels/ already held the libraries: nvcc did not run), then runs
chip_smoke.py's checks of K11's CBL instantiation (``cbl``, with K11 TILE x CBL) and K4's NESTS
instantiation (``nests``) against
their plain versions at ``n_particles`` (default 2**20, a tenth of the
main path's), each with its times, one JSON line per check; on request
also those of a backward run: the advance at ldirect = -1 (``backward``),
K3's BKDEP and COUNT instantiations (``conccalc_backward``), K9's and
K10's BKDEP (``bkdep``) and K6 with K7 and its BACKWARD instantiation
(``convection``), and chip_smoke.py's sim_bkdep phase (``sim_bkdep``:
its three runs at 2**20 particles whatever ``n_particles``, K3 BKDEP and
K10 BKDEP held on every call, the traced run); K12, the OH reaction
(``oh``), and K13, the particle splitting (``split``); K14-K17 of the sim_domainfill and sim_initcond
phases (``domainfill``: the boundary, the receptors, the fluxes and the
initial-condition scatter, on a fill of ``n_particles`` in 1.1 times as
many slots), or K17 alone (``initcond``); the sim_dp phase's shards
(``dp_shards``: a step of ``n_particles`` split into 2 and 4 shards, K13
and K14 with a rank's offsets); K4 TILE and K11 TILE against their plain
versions (``tile``), the sim_tiles phase's step split into 2 x 2 tiles
(``tile_shards``, with a regroup by hand) and its adaptive tiles run at
world size 1 (``sim_tiles_adaptive``, 10 x 2**20 particles whatever
``n_particles``), and its tiles runs of the options at world size 1
(``sim_tiles_options``: the skewed CBL, the regional domain fill, OH with
splitting and a checkpoint's resume; ``n_particles`` should be the main
path's 10 x 2**20, which those runs' checks expect); the fixed step's
crosses (``fixed_cbl``: K4 CBL against its plain version at
``n_particles`` with its queue's length, skewed lane efficiency and
layout, every K4 CBL instantiation at 2**16, K4 TILE x CBL, K4's
turbswitch crosses and K11 CBL with turbswitch off at 2**20) and the fixed_cbl path at ``n_particles``
(``fixed_cbl_path``).  A failed check raises.  This is the quick call to make
after changing a kernel, before a whole chip_smoke.py run.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def tiles_adaptive(cs, device) -> dict:
    """chip_smoke.sim_tiles_adaptive in this process's group of one."""
    from flexpart_tpu_torch import _build
    with cs.group_of_one(cs.SIM_TILES_DIR / "group"):
        return cs.sim_tiles_adaptive(
            device, list(_build.KERNELS) + list(_build.ENTRIES))


def tiles_options(cs, device, which=("cbl", "domainfill", "oh_split")
                  ) -> dict:
    """chip_smoke.py's tiles runs of the options in this process's group
    of one: sim_tiles_cbl, sim_tiles_domainfill, sim_tiles_oh_split (or
    those of ``which``)."""
    from flexpart_tpu_torch import _build
    kernels = list(_build.KERNELS) + list(_build.ENTRIES)
    runs = {"cbl": lambda: cs.sim_tiles_adaptive(device, kernels, cbl=True),
            "domainfill": lambda: cs.sim_tiles_domainfill(device, kernels),
            "oh_split": lambda: cs.sim_tiles_oh_split(device, kernels)}
    out = {}
    with cs.group_of_one(cs.SIM_TILES_DIR / "group"):
        for name in which:
            t0 = time.perf_counter()
            out["sim_tiles_" + name] = runs[name]()
            out["sim_tiles_" + name]["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    import torch
    import chip_smoke as cs
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.met.synthetic import make_grid
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    args = sys.argv[1:]
    n = int(args.pop(0)) if args and args[0].isdigit() else 2 ** 20
    which = args or ["cbl", "nests"]
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all(list(_build.KERNELS))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for k in _build.KERNELS:
        print(json.dumps({k.name: cs.ptxas_by_entry(k.build_log)}),
              flush=True)
    cs.N_MAIN = n
    cs.DF_CAPACITY = n + n // 10
    grid = make_grid(**cs.BENCH_GRID)
    device = torch.device("cuda", 0)
    checks = {"cbl": cs.kernel_advance_cbl, "nests": cs.kernel_advance_nests,
              "backward": cs.kernel_advance_backward,
              "conccalc_backward": cs.kernel_conccalc_backward,
              "bkdep": cs.kernel_bkdep,
              "sim_bkdep": lambda d, g: cs.phase_sim_bkdep(
                  d, list(_build.KERNELS) + list(_build.ENTRIES)),
              "oh": cs.kernel_ohreaction,
              "split": lambda d, g: cs.kernel_split(d, g, n),
              "initcond": cs.kernel_initcond,
              "domainfill": lambda d, g: {
                  "boundcond": cs.kernel_boundcond(d, g),
                  "receptors": cs.kernel_receptors(d, g),
                  "fluxes": cs.kernel_fluxes(d, g),
                  "initcond": cs.kernel_initcond(d, g)},
              "dp_shards": cs.dp_shards,
              "fixed_cbl": cs.kernel_advance_fixed_cbl,
              "fixed_cbl_path": lambda d, g: cs.phase_fixed_cbl(
                  d, g, list(_build.KERNELS) + list(_build.ENTRIES)),
              "tile": cs.kernel_advance_tile,
              "tile_shards": cs.tile_shards,
              "sim_tiles_adaptive": lambda d, g: tiles_adaptive(cs, d),
              "sim_tiles_options": lambda d, g: tiles_options(cs, d),
              "sim_tiles_domainfill": lambda d, g: tiles_options(
                  cs, d, ("domainfill",)),
              "sim_tiles_oh_split": lambda d, g: tiles_options(
                  cs, d, ("oh_split",)),
              "convection": lambda d, g: dict(zip(
                  ("convection", "redist", "redist.backward"),
                  cs.kernel_convection(d, g)))}
    for name in which:
        t0 = time.perf_counter()
        r = checks[name](device, grid)
        if name not in ("oh", "split", "domainfill", "initcond"):
            r.pop("cases", None)
        print(json.dumps({"check": name, "seconds": time.perf_counter() - t0,
                          **r}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A short first check of the advance and the backward run's kernels on
the card.

    python3 scripts/torch_advance_check.py [n_particles] [check ...]

Builds every kernel (one nvcc per source, all started together), prints
the card's name and power limit, the build's seconds and the ptxas
registers, stack and spills of every kernel's instantiations (empty where
build/kernels/ already held the libraries: nvcc did not run), then runs
chip_smoke.py's checks of K11's CBL instantiation (``cbl``) and K4's NESTS
instantiation (``nests``) against
their plain versions at ``n_particles`` (default 2**20, a tenth of the
main path's), each with its times, one JSON line per check; on request
also those of a backward run: the advance at ldirect = -1 (``backward``),
K3's BKDEP and COUNT instantiations (``conccalc_backward``), K9's and
K10's BKDEP (``bkdep``) and K6 with K7 and its BACKWARD instantiation
(``convection``); K12, the OH reaction (``oh``), and K13, the particle
splitting (``split``); K14-K17 of the sim_domainfill and sim_initcond
phases (``domainfill``: the boundary, the receptors, the fluxes and the
initial-condition scatter, on a fill of ``n_particles`` in 1.1 times as
many slots), or K17 alone (``initcond``).  A failed check raises.  This is the quick call to make
after changing a kernel, before a whole chip_smoke.py run.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


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
              "oh": cs.kernel_ohreaction,
              "split": lambda d, g: cs.kernel_split(d, g, n),
              "initcond": cs.kernel_initcond,
              "domainfill": lambda d, g: {
                  "boundcond": cs.kernel_boundcond(d, g),
                  "receptors": cs.kernel_receptors(d, g),
                  "fluxes": cs.kernel_fluxes(d, g),
                  "initcond": cs.kernel_initcond(d, g)},
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

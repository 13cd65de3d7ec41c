#!/usr/bin/env python3
"""Where the deposit scatter (K8) spends its time: this checkout's
``flexpart_tpu_torch/csrc/depo_scatter.cu`` beside copies of it cut short
after each stage of a corner, timed on the same inputs in one process on
one CUDA card:

    python3 scripts/torch_k8_floor.py

The stages: ``loads`` (the particle's loads, its cell and weights, then
nothing per corner), ``match`` (and the corner's __match_any_sync and
__reduce_max_sync), ``sums`` (and the group sums by pointer jumping); then
the whole kernel.  A cut copy adds what it computed into a register that
the compiler cannot drop, and writes nothing else: its grid is wrong, and
only its time is read.  The inputs are those of ``chip_smoke.py``'s
kernels phase: the spread ensemble (10 x 2**20 particles, two species, the
decay and dry pass's deposit) as drawn and in cell order, and its two
plumes.  Each is timed twice (CUDA events, 10 launches each).  Prints the
card's name and power limit and one JSON line.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROW = "      const unsigned row = static_cast<unsigned>(lin);\n"
MOST = ("      const int most = __reduce_max_sync(FULL, valid ? __popc(peers)"
        " : 0);\n")
SUMS = ("{ float a = valid ? wj * d0 : 0.0f, b = valid ? wj * d1 : 0.0f; "
        "group_sums(peers, most, lane, a, b); acc += a + b; continue; }\n")
STAGES = {"loads": (ROW, "{ acc += valid ? wj * d0 : 0.0f; continue; }\n"),
          "match": (MOST, "{ acc += most; continue; }\n"),
          "sums": (MOST, SUMS)}


def cut(source: str, after: str, stop: str) -> str:
    """The kernel with ``stop`` inserted after the line ``after`` of its
    corner loop, and the register it adds into kept alive."""
    for anchor in (after, "  int used = 0, adds = 0, direct_rounds = 0;\n",
                   "  // the block's rows:"):
        if source.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in depo_scatter.cu: "
                             f"{anchor!r}")
    text = source.replace(after, after + "      " + stop)
    text = text.replace("  int used = 0, adds = 0, direct_rounds = 0;\n",
                        "  int used = 0, adds = 0, direct_rounds = 0;\n"
                        "  float acc = 0.0f;\n")
    return text.replace("  // the block's rows:",
                        "  if (acc == -1.0f) grid[0] = acc;\n"
                        "  // the block's rows:")


def main() -> int:
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.met.synthetic import make_grid
    from flexpart_tpu_torch.physics import massupdate as mu
    from flexpart_tpu_torch.physics import wetdepo as wd

    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    this = _build.DEPO_SCATTER
    source = this.source.read_text()
    out_dir = ROOT / "build" / "k8_floor"
    kernels = {}
    for name, (after, stop) in STAGES.items():
        path = out_dir / name / "depo_scatter.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(cut(source, after, stop))

        class Cut(_build.Kernel):
            @property
            def source(self, path=path) -> Path:
                return path

        kernels[name] = Cut(this.name, this.symbol, this.argtypes)
    kernels["kernel"] = this
    _build.build_all(list(kernels.values()))
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()

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
    p = cs.depo_particles(cs.N_MAIN, device, 23, grid)
    cases = {}
    for oname, q in (("spread_as_drawn", p), ("spread_cell_ordered",
                     reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0])):
        cases[oname] = (q, mu.decay_drydep_cuda(q, vdep, cs.LSYNC, 2700, msp,
                                                True)[1])
    q, deposits = cs.plume_particles(cs.N_MAIN, device, 24, grid)
    q = reorder.reorder_by_cell_cuda(q, z0.height, cfg)[0]
    for kind, dep in deposits.items():
        cases[kind] = (q, dep)
    rows = ccfg.nage * ccfg.nclassunc * ccfg.npointspec * ccfg.nyg * ccfg.nxg

    def launch(kernel, flat, dep, q):
        saved = _build.DEPO_SCATTER
        _build.DEPO_SCATTER = kernel
        try:
            wd.depo_scatter_cuda(flat, dep, q, 10800, lage, ccfg)
        finally:
            _build.DEPO_SCATTER = saved

    res = {}
    for cname, (q, dep) in cases.items():
        flat = torch.zeros((rows, 2), dtype=torch.float32, device=device)
        res[cname] = {name: [cs.cuda_ms(lambda: launch(k, flat, dep, q), 10)
                             for _ in range(2)]
                      for name, k in kernels.items()}
    print(smi, flush=True)
    cs.emit({"k8_floor": {"device": torch.cuda.get_device_name(0),
                          "power_limit": smi, "ms": res}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

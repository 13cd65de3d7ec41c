#!/usr/bin/env python3
"""The passes of the adaptive step on a small run of the port, on the CPU.

    python3 scripts/torch_adaptive_passes.py [--particles 4000]

Runs ``Simulation.run`` of ``chip_smoke.py``'s ``sim_adaptive`` phase
(``sim_adaptive_setup``: ``Command(ctl=5.0)``, three hours of 900 s steps
on the global 1-degree grid, the tracer and the settling Cs-137-like
aerosol from one box each) with few particles, an eighth of them the
aerosol, on the plain versions, and prints one JSON object: the passes per
boundary-layer particle and step (mean, p50, p99, max), per step the warp
efficiency of ``chip_smoke.warp_efficiency`` in the run's slot order, the
aerosol's budget and the mean heights of both species.  These are counts
of the plain version on the CPU, no device time: what a prediction of
K11's passes and warp efficiency starts from.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=4000)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke
    from flexpart_tpu_torch.core.advance import settling_species
    from flexpart_tpu_torch.run import simulation as simmod

    n = args.particles
    passes = []
    inner = simmod.advance_all

    def counted(*a, **kw):
        p, diag = inner(*a, **kw)
        passes.append(diag.passes.clone())
        return p, diag

    simmod.advance_all = counted
    try:
        with tempfile.TemporaryDirectory() as out:
            sim = chip_smoke.sim_adaptive_setup(out, "cpu", False, n=n,
                                                n_storm=n // 8)
            sim.run()
    finally:
        simmod.advance_all = inner
    took = torch.cat([q[q > 0] for q in passes]).float().numpy()
    p = sim.particles
    sp = settling_species(p.mass0)
    air = float(p.mass[p.active, 1].sum(dtype=torch.float64))
    wet = float(sim.acc.wetgridunc[..., 1].sum(dtype=torch.float64))
    dry = float(sim.acc.drygridunc[..., 1].sum(dtype=torch.float64))
    print(json.dumps(dict(
        particles=n, device="cpu (plain versions)",
        passes_mean=float(took.mean()),
        passes_p50=float(np.percentile(took, 50)),
        passes_p99=float(np.percentile(took, 99)), passes_max=int(took.max()),
        warp_efficiency_per_step=[
            chip_smoke.warp_efficiency(q)["warp_efficiency"] for q in passes],
        aerosol_budget=dict(airborne=air, wet=wet, dry=dry,
                            sum=air + wet + dry),
        mean_z_tracer=float(p.z[p.active & (sp == 0)].mean()),
        mean_z_aerosol=float(p.z[p.active & (sp == 1)].mean()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

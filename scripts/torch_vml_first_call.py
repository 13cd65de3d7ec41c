#!/usr/bin/env python3
"""Show the first-call race of torch's MKL vector math on the CPU, and its
cure (``flexpart_tpu_torch/utils/cpu.py``).

    python3 scripts/torch_vml_first_call.py [--runs 480] [--threads 8]

Each run is a fresh interpreter that sets torch's intra-op threads, then
(``cold``) calls one function on 65,536 equal float32 inputs, so that the
threads make the function's first VML call of the process at once, or
(``warm``) first calls ``warm_vector_math()`` and then does the same.  A run
fails when the results are not all equal.  Runs go 16 at a time.  Prints
one JSON object: the torch version, its MKL, the CPU, and per function
and mode the runs and the failures.
"""

from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = """
import sys
import torch
torch.set_num_threads({threads})
if {warm}:
    from flexpart_tpu_torch.utils.cpu import warm_vector_math
    warm_vector_math()
y = getattr(torch, {fn!r})(torch.full((65536,), 0.61234))
print(int(bool((y == y[0]).all())))
"""


def one_run(fn: str, warm: bool, threads: int) -> bool:
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(fn=fn, warm=warm,
                                            threads=threads)],
        capture_output=True, text=True, cwd=ROOT, check=True)
    return out.stdout.strip() == "1"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=480)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--functions", default="exp,sin,log")
    args = ap.parse_args()
    import torch
    cpu = next((ln.split(":", 1)[1].strip() for ln in
                Path("/proc/cpuinfo").read_text().splitlines()
                if ln.startswith("model name")), platform.processor())
    res = {"torch": torch.__version__,
           "mkl": torch.backends.mkl.is_available()
           and torch.__config__.show().split("Math Kernel Library")[1]
           .split("\n")[0].strip(),
           "cpu": cpu, "threads": args.threads, "runs": args.runs,
           "failed": {}}
    with ThreadPoolExecutor(16) as pool:
        for fn in args.functions.split(","):
            for warm in (False, True):
                ok = list(pool.map(lambda _: one_run(fn, warm, args.threads),
                                   range(args.runs)))
                res["failed"][f"{fn} {'warm' if warm else 'cold'}"] = \
                    ok.count(False)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

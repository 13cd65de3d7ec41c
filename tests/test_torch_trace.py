"""The port's profiler trace (``Simulation(trace_dir=...)`` and the
command line's ``--trace-dir``), the counterpart of the JAX package's
``jax.profiler.trace`` around its run.

A one-step run on the CPU with ``trace_dir`` writes one TensorBoard trace
(``*.pt.trace.json``) there, which parses as a Chrome trace whose events
hold the run's torch operations; a job run through the command line with
``--trace-dir`` does the same, and still writes its output files.  On the
card the trace holds the kernels too: ``chip_smoke.py``'s ``sim_bkdep``
phase checks that it names every hand-written kernel the run launched.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu_torch import main as tmain  # noqa: E402
from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox,  # noqa: E402
                                       Releases, Species)
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

import test_torch_cli as cli  # noqa: E402


def _events(trace_dir: Path) -> list:
    """The events of the one trace written into ``trace_dir``."""
    (trace,) = trace_dir.glob("*.pt.trace.json")
    return json.loads(trace.read_text())["traceEvents"]


def _op_names(events) -> set:
    return {e["name"] for e in events if e.get("ph") == "X"}


def test_simulation_trace_dir_writes_a_trace(tmp_path):
    grid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=1500,
                  lsynctime=900, loutstep=3600, loutaver=3600,
                  loutsample=900, lconvection=0, lsubgrid=0)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                     lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0, z1=50.0,
                     z2=500.0, mass=(1.0,), parts=256)
    og = OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                 dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    sim = Simulation(cmd=cmd, releases=Releases(species=(Species(),),
                                                boxes=(box,)),
                     grid=grid, met_backend=SyntheticMet(grid), outgrid=og,
                     outdir=str(tmp_path / "out"), device="cpu",
                     trace_dir=str(tmp_path / "trace"))
    sim.run()
    assert sim.timings["particle_steps"] == 256
    names = _op_names(_events(tmp_path / "trace"))
    # the run's torch operations (the sort's argsort among them)
    assert any(n.startswith("aten::") for n in names)
    assert "aten::argsort" in names or "aten::sort" in names


def test_cli_trace_dir_writes_a_trace(tmp_path):
    met = tmp_path / "met"
    cli._write_met(met / "mother", make_grid(nx=37, ny=19, nlev=15,
                                             dx=10.0, dy=10.0))
    pathnames = cli._job(tmp_path / "job", met)
    trace = tmp_path / "trace"
    assert tmain.main([str(pathnames), "--device", "cpu", "--trace-dir",
                       str(trace)]) == 0
    assert any(n.startswith("aten::") for n in _op_names(_events(trace)))
    cli._assert_job_output(tmp_path / "job" / "output")

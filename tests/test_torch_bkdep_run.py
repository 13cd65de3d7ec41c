"""Port parity for the backward deposition modes through ``Simulation.run``.

The configurations of ``tests/test_modes.py::test_wetbkdep`` and
``::test_drybkdep`` (``ldirect=-1``; ``ind_receptor`` 3, WETBKDEP: a gas
released over the full 0-20 km column in SyntheticMet's storm band; 4,
DRYBKDEP: a species with a dry velocity released in the 0-30 m layer) go
through the JAX package and the port on the CPU, JAX's draws injected into
the port through ``Simulation._draws_hook``; WETBKDEP once more with
``use_clwc`` (the in-cloud rule's cloud water from SyntheticMet's column
cloud water, the readclouds classification).  The three JAX runs share one
configuration of the advance, so JAX compiles it once.

Equal: the schedule, bitwise (the forced release heights, ``xscav`` = -1);
the output files' names (the reference's npz stem, the netCDF prefixes
``grid_wetdep_`` and ``grid_drydep_``) and units; ``wetscav_precip.txt``,
byte for byte (both print the same float32 fields); which particles lost
their mass to a zero factor.  Within tolerances: the factors, rtol 1e-6
(measured 3.0e-7: XLA's and torch's ``pow`` and ``exp``, and XLA's
contractions, round an ulp apart; ``tests/test_torch_backward.py``), the
dry factor the species' ``dryvel`` within rtol 1e-5 (the reference's
test); the positions as ``tests/test_torch_backward.py`` holds a backward
run's (z as a distribution), but for DRYBKDEP's particles, released in
the 0-30 m layer: 1% of them beyond 1e-4 grid units and 95% of z within
1 m (measured 0.99% and 96.4%); the residence times within rtol 1e-5 + 1e-5
of the largest cell for all but 0.1% of the cells, all within rtol 1e-3.

Why DRYBKDEP needs the wider limit: the particles that part are parted by
XLA:CPU's compiled program, not by the port.  JAX's own advance run op by
op (``jax.disable_jit()``) on the compiled run's step inputs agrees with the
port within the forward limits (measured: none beyond 1e-4 grid units,
99.7% of z within 1 m, 82% of z bitwise), and parts from the compiled run
on the very particles the port parts from it (3 of 304: 49, 57 and 253).
The first operations whose compiled result differs from the op-by-op
result on those three particles, each evaluated on the compiled
program's own inputs: the quad stencil's four-corner sums
(``flexpart_tpu/core/interp.py:521-523``, products and sums contracted
into FMAs), the neutral TL_u of ``flexpart_tpu/core/hanna.py:110``
(``0.5 * z / sigv_n / (1.0 + 1.5e-3 * corr)``, which XLA's simplifier
computes as ``a / (b * c)``; particles 49 and 57) and the unstable TL_w of
``flexpart_tpu/core/hanna.py:41`` (``0.55 - 0.38 * abs(z / ol)``, an FMA;
particle 253).  An ulp there is amplified by the reflections at the ground
that the 0-30 m release makes frequent.
``test_bkdep_positions_match_jax_run_op_by_op`` holds this.
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.io.netcdf4 import open_nc4  # noqa: E402
from flexpart_tpu.run import simulation as jsim_module  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import reorder  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

GRID = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
N = 304          # the reference test's 300, to a multiple of 16
SEED = 4
NSTEPS = 24
# run -> (ind_receptor, use_clwc)
MODES = {"wetbkdep": (3, False), "drybkdep": (4, False),
         "wetbkdep_clwc": (3, True)}


def _config(c, mode):
    cmd = c.Command(ibdate=20200101, ibtime=60000, iedate=20200101,
                    ietime=120000, ldirect=-1, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    ind_receptor=mode)
    if mode == 3:
        # in the synthetic storm band (|lat| ~ 50, sin(3 lambda) > 0)
        where = dict(lon1=28.0, lon2=32.0, lat1=48.0, lat2=52.0)
        sp = c.Species(weta_gas=1e-4, wetb_gas=0.8, henry=1.0e5)
    else:
        where = dict(lon1=-50.0, lon2=-48.0, lat1=42.0, lat2=44.0)
        sp = c.Species(dryvel=0.02)
    box = c.ReleaseBox(idate1=20200101, itime1=120000, idate2=20200101,
                       itime2=120000, z1=100.0, z2=500.0, mass=(1.0,),
                       parts=N, **where)
    og = c.OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=90, numygrid=45,
                   dxout=4.0, dyout=4.0, outheights=(500.0, 2000.0, 50000.0))
    return cmd, c.Releases(species=(sp,), boxes=(box,)), og


def _numpy(p):
    if dataclasses.is_dataclass(p):
        return interop.particles_to_numpy(p)
    return {f: np.asarray(getattr(p, f)) for f in FIELDS}


@pytest.fixture(scope="module", params=list(MODES), ids=list(MODES))
def runs(request, tmp_path_factory):
    """(ind_receptor, JAX sim, its outdir, its schedule, port sim, its
    outdir, its schedule, JAX's advance steps) of one run; the port fed
    JAX's draws."""
    name = request.param
    mode, use_clwc = MODES[name]
    jout = tmp_path_factory.mktemp(f"jax_{name}")
    cmd, rel, og = _config(jconfig, mode)
    grid = jmet.make_grid(**GRID)
    jsim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                         met_backend=jmet.SyntheticMet(grid), outgrid=og,
                         outdir=str(jout), seed=SEED, use_clwc=use_clwc)
    jsched = _numpy(jsim.particles)
    # the compiled advance's inputs and outputs, step by step
    steps = []
    compiled = jsim_module.advance_all

    def recording(*args, **kw):
        out = compiled(*args, **kw)
        steps.append((args, kw, out[0]))
        return out

    jsim_module.advance_all = recording
    try:
        jsim.run()
    finally:
        jsim_module.advance_all = compiled
    key = jax.random.PRNGKey(SEED)
    rows = {**DRAW_ROWS, 2: 1}
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in rows.items()}
        for i in range(NSTEPS)]
    tout = tmp_path_factory.mktemp(f"port_{name}")
    cmd, rel, og = _config(tconfig, mode)
    tgrid = make_grid(**GRID)
    sim = Simulation(cmd=cmd, releases=rel, grid=tgrid,
                     met_backend=SyntheticMet(tgrid), outgrid=og,
                     outdir=str(tout), seed=SEED, device="cpu",
                     use_clwc=use_clwc)
    assert sim.use_clwc == jsim.use_clwc == use_clwc
    tsched = _numpy(sim.particles)
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    return mode, jsim, jout, jsched, sim, tout, tsched, steps


def test_bkdep_schedule_and_files_equal_jax(runs):
    mode, jsim, jout, jsched, sim, tout, tsched, _ = runs
    assert sim.bkdep == jsim.bkdep == mode
    assert not sim._bkdep_pending
    for f in FIELDS:
        np.testing.assert_array_equal(tsched[f], jsched[f], err_msg=f)
    z = tsched["z"][:N]
    assert (z.max() > 5000.0) if mode == 3 else (z.max() <= 30.0)
    assert (tsched["xscav"][:N] == -1.0).all()
    jnames = sorted(q.name for q in Path(jout).iterdir())
    assert sorted(q.name for q in Path(tout).iterdir()) == jnames
    prefix = "grid_wetdep_" if mode == 3 else "grid_drydep_"
    assert [n for n in jnames if n.endswith(".nc")] \
        == [f"{prefix}20200101120000.nc"]
    assert len([n for n in jnames if n.endswith(".npz")]) == 5
    assert sim.writer.nc_meta["units"] == jsim.writer.nc_meta["units"] \
        == "s m3 kg-1"
    with open_nc4(str(Path(jout) / f"{prefix}20200101120000.nc")) as j, \
            open_nc4(str(Path(tout) / f"{prefix}20200101120000.nc")) as t:
        assert sorted(t.keys()) == sorted(j.keys())
        assert t["spec001_mr"].attrs["units"] == "s m3 kg-1"
        assert t.attrs["ind_receptor"] == j.attrs["ind_receptor"] == mode
    if mode == 3:
        text = (Path(tout) / "wetscav_precip.txt").read_bytes()
        assert text == (Path(jout) / "wetscav_precip.txt").read_bytes()
        assert len(text.splitlines()) == 8      # met times 06:00-13:00


def test_bkdep_factors_and_mass_match_jax(runs):
    mode, jsim, jout, jsched, sim, tout, tsched, _ = runs
    a = _numpy(reorder.apply_perm(sim.particles, torch.argsort(sim._origin)))
    b = _numpy(jsim.particles)
    np.testing.assert_array_equal(a["active"], b["active"])
    on = a["active"]
    xs, xj = a["xscav"][on, 0], b["xscav"][on, 0]
    assert (xs >= 0).all()
    np.testing.assert_allclose(xs, xj, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(a["mass"] == 0, b["mass"] == 0)
    if mode == 3:
        # some particles saw rain, the others lost their mass
        assert (xs > 0).sum() > 10 and (xs == 0).sum() > 10
        np.testing.assert_array_equal(a["mass"][on, 0] == 0, xs == 0)
    else:
        np.testing.assert_allclose(xs, 0.02, rtol=1e-5)


def test_bkdep_positions_and_residence_times_match_jax(runs):
    mode, jsim, jout, jsched, sim, tout, tsched, _ = runs
    a = _numpy(reorder.apply_perm(sim.particles, torch.argsort(sim._origin)))
    b = _numpy(jsim.particles)
    # DRYBKDEP's particles start in the 0-30 m layer, where they reflect
    # at the ground on most substeps and an ulp parts more z paths
    # (measured: 0.99% beyond 1e-4 in x, 96.4% of z within 1 m)
    few, within_1m = (0.005, 0.98) if mode == 3 else (0.01, 0.95)
    for c in ("x", "y"):
        err = np.abs((a[c + "_hi"] + a[c + "_lo"])
                     - (b[c + "_hi"] + b[c + "_lo"]))
        assert err.max() <= 2e-3 and (err > 1e-4).mean() <= few, \
            (c, err.max(), (err > 1e-4).mean())
    err_z = np.abs(a["z"] - b["z"])
    near = np.mean(err_z <= 1e-2 + 1e-4 * np.abs(b["z"]))
    assert near >= 0.85, near
    assert np.mean(err_z <= 1.0) >= within_1m, np.mean(err_z <= 1.0)
    for jf in sorted(Path(jout).glob("grid_conc_*.npz")):
        j, t = np.load(jf)["conc"], np.load(Path(tout) / jf.name)["conc"]
        assert np.isfinite(t).all() and t.min() >= 0.0 and j.max() > 0
        err = np.abs(t - j) - 1e-5 * np.abs(j)
        assert (err > 1e-5 * j.max()).mean() <= 1e-3
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-5 * j.max())


def _parted(a, b):
    """The particles whose x or y differ by more than 1e-4 grid units."""
    return {c: set(np.nonzero(np.abs((a[c + "_hi"] + a[c + "_lo"])
                                     - (b[c + "_hi"] + b[c + "_lo"]))
                              > 1e-4)[0].tolist()) for c in ("x", "y")}


def test_bkdep_positions_match_jax_run_op_by_op(runs):
    """JAX's advance replayed op by op (``jax.disable_jit()``) from the
    compiled run's first step, each step fed what the run changed between
    advances (release, mass, ``xscav``): the port holds the forward limits
    against it (0.5% beyond 1e-4 grid units, 98% of z within 1 m), and the
    particles that part the port from the compiled run are the ones that
    part JAX's op-by-op run from it (the module docstring names the
    operations)."""
    mode, jsim, jout, jsched, sim, tout, tsched, steps = runs
    state = None
    for k, (args, kw, compiled_out) in enumerate(steps):
        p = args[0]
        if state is not None:
            prev = _numpy(steps[k - 1][2])
            now = _numpy(p)
            # a field the run left alone since the last advance takes the
            # op-by-op value; a field it changed takes the run's
            p = p._replace(**{f: jax.numpy.asarray(
                state[f] if np.array_equal(prev[f], now[f]) else now[f])
                for f in FIELDS})
        with jax.disable_jit():
            state = _numpy(jsim_module.advance_all(p, *args[1:], **kw)[0])
    compiled = _numpy(steps[-1][2])
    a = _numpy(reorder.apply_perm(sim.particles, torch.argsort(sim._origin)))
    for c in ("x", "y"):
        err = np.abs((a[c + "_hi"] + a[c + "_lo"])
                     - (state[c + "_hi"] + state[c + "_lo"]))
        assert (err > 1e-4).mean() <= 0.005, (c, err.max())
    err_z = np.abs(a["z"] - state["z"])
    assert np.mean(err_z <= 1.0) >= 0.98, np.mean(err_z <= 1.0)
    assert _parted(a, compiled) == _parted(state, compiled)
    # XLA's rewrites on their own: a / b / c as a / (b * c), a * b + c as
    # one rounding; torch, like numpy, rounds each operation
    rng = np.random.default_rng(1)
    u, v, w = (rng.uniform(0.5, 2.0, 4096).astype(np.float32)
               for _ in range(3))
    div = np.asarray(jax.jit(lambda u, v, w: u / v / w)(u, v, w))
    np.testing.assert_array_equal(div, u / (v * w))
    assert (div != (u / v) / w).any()
    tu, tv, tw = (torch.from_numpy(q) for q in (u, v, w))
    np.testing.assert_array_equal((tu / tv / tw).numpy(), (u / v) / w)
    fma = np.asarray(jax.jit(lambda u, v, w: u * v + w)(u, v, w))
    assert (fma != u * v + w).any()
    np.testing.assert_array_equal((tu * tv + tw).numpy(), u * v + w)

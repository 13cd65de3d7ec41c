"""Port parity for ``Simulation.run``: forward, serial, fixed step, on
synthetic met.

One JAX run per file (module-scoped: it pays the XLA compile of the
advance).  The verification recipe of both packages — a 2 x 2 degree box
of 1008 particles released over the first hour, three hours of 900 s steps,
hourly output on a 60 x 40 x 3 grid — with ``lconvection=0``,
``lsubgrid=0`` and a cyclic met grid that stops at 70 degrees (no polar
cap), the configuration that holds the advance, the release, the sort and
the writers against JAX without convection, subgrid orography or caps,
goes through both packages on the CPU.  The recipe verbatim, with all
three, is ``tests/test_torch_default_run.py``.

Equal: the release schedule bitwise, the active count, ``dates``, the
names, shapes and dtypes in the npz files, the variables of the netCDF file
as ``open_nc4`` reads them, the reference's unformatted ``header`` byte for
byte but its version string (both runs write the Fortran files).

With JAX's draws injected through the port's test hook and the slots mapped
back through the sorts' permutations (``Simulation._origin``): the mask,
``cbt`` and ``itra`` exactly; x and y within 1e-4 grid units, z within rtol
1e-4 + 1e-2 m (the tolerances of tests/test_torch_slice.py: XLA contracts
``a*b + c*d`` into FMAs, torch does not) for all but 0.5% of the particles,
and those within ten times as much (over twelve steps on bf16 tables a
table entry that the two packages compute an ulp apart now and then rounds
to the other bfloat16, and the particles of that cell drift by 2**-8 of
one wind component for a step; measured: 1 of 1008 particles, 2.8e-4 in
x).  z follows the boundary layer's Langevin equation, which amplifies an
ulp: 85% of the particles within the one-step tolerance, 98% within 1 m,
the plume's mean height within 0.5 m.  ``conc`` within rtol 1e-5 plus an atol of 1e-5 of the largest cell,
and ``conc * volume`` summed to 1e-6.  1008 is a
multiple of 16: torch's CPU ``pow`` rounds a last partial vector
differently, and the bitwise comparisons between port runs move particles
between slots.

With the port's own Philox stream only statistics can agree: the mass
fraction recovered from the last npz within 1e-3 of JAX's, and the plume's
centre of mass within 0.25 grid units (2.5 degrees) horizontally and 150 m
vertically (1008 particles with a horizontal spread of about 1 grid unit
and a vertical spread of several hundred metres after three hours).

Between port runs, bitwise: two runs with one seed; a run that sorts on
every step against one that sorts only when a release forces it, with the
same injected draws carried along with their particles.
"""
import dataclasses
import json
import logging
import subprocess
import sys
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
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import reorder  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.io.fortran_writer import (  # noqa: E402
    read_grid_sparse, read_header)

N = 1008
SEED = 3
GRID = dict(nx=37, ny=15, nlev=15, dx=10.0, dy=10.0, ylat0=-70.0)
ROWS = {**DRAW_ROWS, 2: 1}          # ctl=-5: ifine_eff = 1
NSTEPS = 12
FEW_SHARE = 0.005


def _config(c, **cmd_kw):
    cmd = c.Command(**{**dict(
        ibdate=20200101, ibtime=0, iedate=20200101, ietime=30000,
        lsynctime=900, loutstep=3600, loutaver=3600, loutsample=900,
        lconvection=0, lsubgrid=0), **cmd_kw})
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=10000, lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0,
                       z1=50.0, z2=500.0, mass=(1.0,), parts=N)
    rel = c.Releases(species=(c.Species(),), boxes=(box,))
    og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                   dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    return cmd, rel, og


def _port_sim(outdir, **kw):
    cmd, rel, og = _config(tconfig, **kw.pop("cmd_kw", {}))
    grid = kw.pop("grid", None) or make_grid(**GRID)
    return Simulation(**{**dict(
        cmd=cmd, releases=rel, grid=grid, met_backend=SyntheticMet(grid),
        outgrid=og, outdir=str(outdir), seed=SEED, device="cpu"), **kw})


def _numpy_particles(p):
    if dataclasses.is_dataclass(p):
        return interop.particles_to_numpy(p)
    return {f: np.asarray(getattr(p, f)) for f in FIELDS}


def _in_schedule_order(sim):
    """The port's final particles, each back in its schedule slot."""
    return reorder.apply_perm(sim.particles, torch.argsort(sim._origin))


def _assert_close(a, b, atol, rtol, what):
    """All within ten times the tolerance, and all but FEW_SHARE of the
    particles within the tolerance itself."""
    err = np.abs(a - b) - rtol * np.abs(b)
    assert err.max() <= 10 * atol, (what, err.max())
    beyond = int((err > atol).sum())
    assert beyond <= FEW_SHARE * len(a), (what, beyond, err.max())


def _mass_fraction(sim, outdir):
    d = np.load(sorted(Path(outdir).glob("grid_conc_*.npz"))[-1])
    return float((d["conc"][0, 0, 0] * sim.geo.volume).sum() / 1e12)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("jax_out")
    cmd, rel, og = _config(jconfig)
    grid = jmet.make_grid(**GRID)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=jmet.SyntheticMet(grid), outgrid=og,
                        outdir=str(outdir), seed=SEED, write_fortran=True)
    schedule = _numpy_particles(sim.particles)
    sim.run()
    key = jax.random.PRNGKey(SEED)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS)]
    return sim, outdir, schedule, draws


@pytest.fixture(scope="module")
def injected_run(jax_run, tmp_path_factory):
    """The port fed JAX's draws, carried along with their particles."""
    _, _, _, draws = jax_run
    outdir = tmp_path_factory.mktemp("port_injected")
    sim = _port_sim(outdir, write_fortran=True)
    schedule = _numpy_particles(sim.particles)
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    return sim, outdir, schedule


@pytest.fixture(scope="module")
def own_stream_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("port_own")
    sim = _port_sim(outdir, profile=True, write_fortran=True)
    sim.run()
    return sim, outdir


def test_schedule_equals_jax_bitwise(jax_run, injected_run):
    _, _, jsched, _ = jax_run
    _, _, tsched = injected_run
    for f in FIELDS:
        assert tsched[f].dtype == jsched[f].dtype, f
        np.testing.assert_array_equal(tsched[f], jsched[f], err_msg=f)


def test_active_count_and_output_names_equal_jax(jax_run, injected_run,
                                                 own_stream_run):
    jsim, jout, _, _ = jax_run
    n_jax = int(np.sum(np.asarray(jsim.particles.active)))
    assert n_jax == N
    jnames = sorted(p.name for p in Path(jout).iterdir())
    # dates, nc, two npz; the Fortran files: header, and per output step
    # grid_conc_*_001 and grid_pptv_*_001 (iout=3)
    assert "dates" in jnames and "header" in jnames and len(jnames) == 9
    assert len([n for n in jnames if n.endswith("_001")]) == 4
    for sim, out in (injected_run[:2], own_stream_run):
        assert int(sim.particles.active.sum()) == n_jax
        names = sorted(p.name for p in Path(out).iterdir()
                       if p.name != "profile.txt")
        assert names == jnames
        assert (Path(out) / "dates").read_text() \
            == (Path(jout) / "dates").read_text()
        assert sim.last_itime == jsim.last_itime == 10800
        assert sim.timings["particle_steps"] \
            == jsim.timings["particle_steps"] > 0


def test_npz_names_shapes_dtypes_equal_jax(jax_run, injected_run):
    _, jout, _, _ = jax_run
    _, tout, _ = injected_run
    for jf in sorted(Path(jout).glob("grid_conc_*.npz")):
        j, t = np.load(jf), np.load(Path(tout) / jf.name)
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        for k in ("outlon0", "outlat0", "dxout", "dyout", "outheights", "unc",
                  "wet", "dry"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_netcdf_variables_equal_jax(jax_run, injected_run):
    """Every variable of the JAX run's file is in the port's with the same
    shape, dtype, attributes and dimension scales; all but the
    concentrations (compared in the npz test below, with their tolerance)
    hold the same values."""
    _, jout, _, _ = jax_run
    _, tout, _ = injected_run
    jnc = sorted(Path(jout).glob("grid_conc_*.nc"))
    tnc = sorted(Path(tout).glob("grid_conc_*.nc"))
    assert len(jnc) == len(tnc) == 1 and jnc[0].name == tnc[0].name
    with open_nc4(str(jnc[0])) as j, open_nc4(str(tnc[0])) as t:
        assert sorted(t.keys()) == sorted(j.keys())
        assert "spec001_mr" in t and "ORO" in t and "RELPART" in t
        for k in ("Conventions", "loutstep", "lsubgrid", "lconvection",
                  "ibdate", "ietime", "dxout", "outlon0"):
            assert t.attrs[k] == j.attrs[k], k
        assert "_NCProperties" in t.attrs
        for name in j.keys():
            jv, tv = j[name], t[name]
            assert tv.shape == jv.shape and tv.dtype == jv.dtype, name
            assert sorted(tv.attrs.keys()) == sorted(jv.attrs.keys()), name
            assert tv.compression == jv.compression, name
            if not name.startswith("spec"):
                np.testing.assert_array_equal(tv[...], jv[...], err_msg=name)
        v = t["spec001_mr"]
        assert [v.dims[i][0].name for i in range(6)] == [
            "/nageclass", "/pointspec", "/time", "/height", "/latitude",
            "/longitude"]
        assert list(t["time"][:]) == [5400, 9000]
        assert v.attrs["units"] == "ng m-3"
        jc = j["spec001_mr"][...]
        np.testing.assert_allclose(v[...], jc, rtol=1e-5,
                                   atol=1e-5 * np.abs(jc).max())
        jp = j["spec001_pptv"][...]
        np.testing.assert_allclose(t["spec001_pptv"][...], jp, rtol=1e-4,
                                   atol=1e-5 * np.abs(jp).max())


def test_injected_draws_positions_match_jax(jax_run, injected_run):
    jsim, _, _, _ = jax_run
    sim, _, _ = injected_run
    assert sim.n_sorts == 4                 # steps 0, 1, 2, 3 wake particles
    assert not torch.equal(sim._origin, torch.arange(N))
    a = _numpy_particles(_in_schedule_order(sim))
    b = _numpy_particles(jsim.particles)
    for f in ("active", "itra", "itramem", "npoint", "nclass", "cbt"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_array_equal(a["mass"], b["mass"])
    _assert_close(a["x_hi"] + a["x_lo"], b["x_hi"] + b["x_lo"], 1e-4, 0, "x")
    _assert_close(a["y_hi"] + a["y_lo"], b["y_hi"] + b["y_lo"], 1e-4, 0, "y")
    # z: the boundary-layer Langevin equation amplifies an ulp (wp moves z,
    # z sets sigw and the time scale of the next substep, and a reflection
    # at the ground or at the mixing height is a jump), so after twelve
    # steps only a share of the particles is still within the one-step
    # tolerance.  Measured: 90% within 3e-3 m, 99% within 0.6 m, the worst
    # 122 m (with f32 tables: 0.16 m, 25 m, 230 m)
    err_z = np.abs(a["z"] - b["z"])
    assert np.mean(err_z <= 1e-2 + 1e-4 * np.abs(b["z"])) >= 0.85
    assert np.mean(err_z <= 1.0) >= 0.98
    assert abs(a["z"].mean() - b["z"].mean()) < 0.5
    # the plume did travel: this is not a comparison of release positions
    assert np.abs(a["x_hi"] - np.asarray(injected_run[2]["x_hi"])).max() > 0.01


def test_injected_draws_conc_matches_jax(jax_run, injected_run):
    jsim, jout, _, _ = jax_run
    sim, tout, _ = injected_run
    for jf in sorted(Path(jout).glob("grid_conc_*.npz")):
        j, t = np.load(jf)["conc"], np.load(Path(tout) / jf.name)["conc"]
        assert j.max() > 0
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * j.max())
        mj = (j[0, 0, 0] * jsim.geo.volume).sum()
        mt = (t[0, 0, 0] * sim.geo.volume).sum()
        assert abs(mt - mj) <= 1e-6 * mj
    np.testing.assert_array_equal(sim.geo.volume, jsim.geo.volume)


def test_fortran_files_match_jax(jax_run, injected_run):
    """The reference's unformatted files: the header byte for byte but the
    version string, and each sparse grid file decoded to the values of
    JAX's within the tolerance of ``conc`` above (the mixing ratios of
    ``grid_pptv_*`` within the netCDF test's rtol 1e-4: the density on the
    output grid comes from the met fields both packages process), and
    equal to the port's own npz of the same step."""
    jsim, jout, _, _ = jax_run
    sim, tout, _ = injected_run
    j = (Path(jout) / "header").read_bytes()
    t = (Path(tout) / "header").read_bytes()
    assert len(t) == len(j) and t[:12] == j[:12] and t[268:] == j[268:]
    assert read_header(Path(tout) / "header")["flexversion"] \
        == "flexpart_tpu_torch 1.0"
    og = sim.outgrid
    nx, ny, nz = og.numxgrid, og.numygrid, len(og.outheights)
    grids = sorted(q.name for q in Path(jout).glob("grid_*_001"))
    assert len(grids) == 4
    for name in grids:
        jt, jc, jw, jd = read_grid_sparse(Path(jout) / name, nx, ny, nz)
        tt, tc, tw, td = read_grid_sparse(Path(tout) / name, nx, ny, nz)
        assert tt == jt and jc.max() > 0
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(td, jd)
        rtol = 1e-4 if name.startswith("grid_pptv_") else 1e-5
        np.testing.assert_allclose(tc, jc, rtol=rtol, atol=1e-5 * jc.max())
        if name.startswith("grid_conc_"):
            npz = np.load(Path(tout) / (name[:-4] + ".npz"))["conc"][0]
            np.testing.assert_allclose(tc, npz, rtol=2e-6, atol=1e-12)


def test_own_stream_statistics_match_jax(jax_run, own_stream_run):
    jsim, jout, _, _ = jax_run
    sim, tout = own_stream_run
    fj, ft = _mass_fraction(jsim, jout), _mass_fraction(sim, tout)
    assert abs(fj - 1.0) < 1e-3 and abs(ft - fj) < 1e-3
    a = _numpy_particles(sim.particles)
    b = _numpy_particles(jsim.particles)
    on_a, on_b = a["active"], b["active"]
    for f, tol in (("x_hi", 0.25), ("y_hi", 0.25), ("z", 150.0)):
        ca, cb = a[f][on_a].mean(), b[f][on_b].mean()
        assert abs(ca - cb) < tol, (f, ca, cb)
        # and the two plumes are about as wide
        assert 0.7 < a[f][on_a].std() / b[f][on_b].std() < 1.4, f
    assert np.isfinite(a["z"]).all()
    report = (Path(tout) / "profile.txt").read_text()
    for section in ("advance", "conccalc", "reorder", "output", "getfields"):
        assert section in report
    assert sim._prefetch_failures == 0


def test_two_port_runs_with_one_seed_are_bitwise_equal(own_stream_run,
                                                       tmp_path):
    sim, out = own_stream_run
    again = _port_sim(tmp_path)
    again.run()
    a, b = _numpy_particles(sim.particles), _numpy_particles(again.particles)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f].view(np.uint8), b[f].view(np.uint8),
                                      err_msg=f)
    for f1 in sorted(Path(out).glob("grid_conc_*.npz")):
        np.testing.assert_array_equal(np.load(f1)["conc"],
                                      np.load(tmp_path / f1.name)["conc"])
    other = _port_sim(tmp_path / "other_seed", seed=SEED + 1)
    other.run()
    assert not np.array_equal(_numpy_particles(other.particles)["z"], a["z"])


def test_a_sort_never_changes_a_result(tmp_path, monkeypatch):
    """Sorting on every step against sorting only when a release forces
    it: with the draws carried along with their particles, every particle
    ends bitwise where it would have, and only the order of the float
    additions into an output cell may differ."""
    def draws_for(istep, origin):
        d = {t: trng.normals(trng.Key(77, istep), (r, N), t, device="cpu")
             for t, r in ROWS.items()}
        return {t: v[:, origin].contiguous() for t, v in d.items()}

    runs = {}
    for every in (1, 10 ** 9):
        monkeypatch.setattr(reorder, "REORDER_EVERY", every)
        sim = _port_sim(tmp_path / str(every), write_netcdf=False)
        sim._draws_hook = draws_for
        sim.run()
        runs[every] = sim
    assert runs[1].n_sorts == NSTEPS + 1 and runs[10 ** 9].n_sorts == 4
    a = _numpy_particles(_in_schedule_order(runs[1]))
    b = _numpy_particles(_in_schedule_order(runs[10 ** 9]))
    for f in FIELDS:
        np.testing.assert_array_equal(a[f].view(np.uint8), b[f].view(np.uint8),
                                      err_msg=f)
    for f1 in sorted((tmp_path / "1").glob("grid_conc_*.npz")):
        c1 = np.load(f1)["conc"]
        c2 = np.load(tmp_path / str(10 ** 9) / f1.name)["conc"]
        np.testing.assert_allclose(c1, c2, rtol=1e-6, atol=1e-12)


def test_age_classes_terminate_like_jax(tmp_path):
    """Two age classes (1 h, 2 h): the outputs gain the age axis, and both
    packages put the same mass into each class.  Particles older than the
    last class are switched off after the advance, and, in the reference as
    in the port, switched on again by the next step's ``activate``, because
    the advance has just set their ``itra`` to that step: the port mirrors
    this, so the active counts and the particle steps stay equal.  (A
    second, short-lived JAX run: the advance it compiled for the module's
    run is reused.)"""
    lage = (3600, 7200)
    cmd, rel, og = _config(jconfig)
    grid = jmet.make_grid(**GRID)
    jsim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                         met_backend=jmet.SyntheticMet(grid), outgrid=og,
                         outdir=str(tmp_path / "jax"), seed=SEED,
                         ageclasses=jconfig.AgeClasses(lage=lage),
                         write_netcdf=False)
    jsim.run()
    sim = _port_sim(tmp_path / "port", write_netcdf=False,
                    ageclasses=tconfig.AgeClasses(lage=lage))
    sim.run()
    assert int(sim.particles.active.sum()) \
        == int(np.sum(np.asarray(jsim.particles.active))) == N
    # counted by the advance, before the age check switches particles off
    assert sim.timings["particle_steps"] == jsim.timings["particle_steps"] > 0
    np.testing.assert_array_equal(
        np.sort(sim.particles.itramem.numpy()),
        np.sort(np.asarray(jsim.particles.itramem)))
    for jf in sorted((tmp_path / "jax").glob("grid_conc_*.npz")):
        j, t = np.load(jf)["conc"], np.load(tmp_path / "port" / jf.name)["conc"]
        assert t.shape == j.shape and t.shape[2] == 2
        # the same mass in each age class (positions differ: own draws)
        mj = (j[0, 0] * jsim.geo.volume).sum(axis=(1, 2, 3))
        mt = (t[0, 0] * sim.geo.volume).sum(axis=(1, 2, 3))
        np.testing.assert_allclose(mt, mj, rtol=1e-3)
        assert (mj > 0).all()


# option -> the Simulation's arguments; a case whose refusal names
# another option says so under "names", and one whose refusal is not a
# NotImplementedError names its error under "error" (a backward run, the
# Fortran files and distributed="tiles" with every option are ported:
# their cases hold that what the reference's tiles mode refuses, backward
# deposition, nested met and legacy_rng, is refused with them too, as the
# reference refuses it, before the header is written)
REFUSED = {
    "ldirect": dict(cmd_kw=dict(ldirect=-1, ind_receptor=4),
                    distributed="tiles", names="backward deposition",
                    error=ValueError),
    "distributed": dict(distributed="tiles", met_nests="nest",
                        names="nested met", error=ValueError),
    "write_fortran": dict(write_fortran=True, distributed="tiles",
                          legacy_rng=True, names="legacy_rng",
                          error=ValueError),
}

# options the port runs since they were ported (they were cases of
# REFUSED): particle dumps, warm start, checkpoints, OH chemistry and
# splitting; the domain fill, receptors, the nested output grid, the
# gross fluxes, the initial-condition sensitivity and the plume
# trajectories; the profiler trace (trace_dir, under the outdir).  The Simulation's arguments, run for one step of 900 s
# (two for itsplit, which counts only when shorter than the run; three for
# the options that write at an output time, OUTPUT_AT_2700)
ONE_STEP = dict(ietime=1500)
OUTPUT_AT_2700 = dict(ietime=10000, loutstep=1800, loutaver=1800)
PORTED = {
    "ipin": dict(cmd_kw=dict(ipin=1, **ONE_STEP)),
    "ipout": dict(cmd_kw=dict(ipout=2, **ONE_STEP)),
    "mquasilag": dict(cmd_kw=dict(mquasilag=1, loutstep=900, loutaver=900,
                                  **ONE_STEP)),
    "itsplit": dict(cmd_kw=dict(itsplit=900, ietime=3000)),
    "OH reaction": dict(species=dict(ohcconst=1e-12),
                        cmd_kw=dict(ONE_STEP)),
    "checkpoint_at": dict(checkpoint_at=900, cmd_kw=dict(ONE_STEP)),
    "mdomainfill": dict(cmd_kw=dict(mdomainfill=1, **ONE_STEP)),
    "receptors": dict(receptors=(tconfig.Receptor("r", 1.0, 41.0),),
                      cmd_kw=dict(OUTPUT_AT_2700)),
    "outgrid_nest": dict(outgrid_nest=tconfig.OutGrid(
        0.0, 40.0, 4, 4, 0.5, 0.5, (100.0,)), cmd_kw=dict(OUTPUT_AT_2700)),
    "iflux": dict(cmd_kw=dict(iflux=1, **OUTPUT_AT_2700)),
    "linit_cond": dict(cmd_kw=dict(linit_cond=1, **ONE_STEP)),
    "iout=4/5": dict(cmd_kw=dict(iout=5, **OUTPUT_AT_2700)),
    "trace_dir": dict(cmd_kw=dict(ONE_STEP)),
}


@pytest.mark.parametrize("option", list(REFUSED))
def test_unported_option_is_refused_by_name(option, tmp_path):
    kw = dict(REFUSED[option])
    name = kw.pop("names", option)
    error = kw.pop("error", NotImplementedError)
    species = kw.pop("species", None)
    if species is not None:
        cmd, rel, og = _config(tconfig)
        rel = tconfig.Releases(species=(tconfig.Species(**species),),
                               boxes=rel.boxes)
        kw["releases"] = rel
    if kw.get("met_nests") == "nest":
        nest = make_grid(nx=21, ny=11, nlev=GRID["nlev"], dx=2.0, dy=2.0,
                         xlon0=-30.0, ylat0=20.0, xglobal=False)
        kw["met_nests"] = (SyntheticMet(nest),)
    with pytest.raises(error) as err:
        _port_sim(tmp_path, **kw)
    assert name in str(err.value)
    # nothing was written before the refusal
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("option", list(PORTED))
def test_ported_option_runs(option, tmp_path):
    """What each formerly refused option leaves after its first step."""
    from flexpart_tpu_torch.io import partdump
    kw = dict(PORTED[option])
    species = kw.pop("species", None)
    if species is not None:
        cmd, rel, og = _config(tconfig)
        rel = tconfig.Releases(species=(tconfig.Species(**species),),
                               boxes=rel.boxes)
        kw["releases"] = rel
    if option == "ipin":
        # a previous run's partposit_end: 16 particles at 10 E, 45 N
        prev = _port_sim(tmp_path / "prev").particles
        itra = prev.itra
        released = int(((itra >= 0) & (itra <= 900)).sum())
        warm = prev.rows(0, 16).replace(x_hi=torch.full((16,), 19.0),
                            y_hi=torch.full((16,), 11.5),
                            active=torch.ones(16, dtype=torch.bool))
        tmp_path.mkdir(exist_ok=True)
        diag = tuple(torch.zeros(16) for _ in range(7))
        partdump.write_partposit(tmp_path / "partposit_end", 0, warm,
                                 make_grid(**GRID), diag, only_current=False)
    if option == "checkpoint_at":
        kw["checkpoint_path"] = str(tmp_path / "ck.npz")
    if option == "trace_dir":
        kw["trace_dir"] = str(tmp_path / "trace")
    sim = _port_sim(tmp_path, **kw)
    sim.run()
    n_live = int(sim.particles.active.sum())
    assert sim.timings["particle_steps"] > 0 and n_live > 0
    if option == "ipin":
        # the schedule's releases of the first two steps and the dump's
        assert sim.particles.capacity == N + 16
        assert n_live == released + 16
    elif option == "ipout":
        _, d = partdump.read_partposit(tmp_path / "partposit_end", 1)
        assert len(d["z"]) == n_live
    elif option == "mquasilag":
        assert list(tmp_path.glob("shortposit_20200101001500"))
    elif option == "itsplit":
        assert sim._splits and sim._origin is not None
    elif option == "OH reaction":
        assert "ohchem" in sim.timings and sim.any_ohreact
    elif option == "mdomainfill":
        # the release box is the window: a regional fill with a boundary
        assert sim.airmass_total > 0 and sim._boundary is not None
        assert len(sim.boundary_counts) == 2
    elif option == "receptors":
        assert list(tmp_path.glob("receptor_conc_*.npz"))
        assert (tmp_path / "receptor_conc").exists()
    elif option == "outgrid_nest":
        assert list((tmp_path / "nest").glob("grid_conc_*.npz"))
    elif option == "iflux":
        assert list(tmp_path.glob("grid_flux_*"))
    elif option == "linit_cond":
        assert (tmp_path / "grid_initial_001").exists()
        assert float(sim.init_cond.sum()) > 0
    elif option == "iout=4/5":
        assert len((tmp_path / "trajectories.txt").read_text()
                   .splitlines()) == 2 + 2 + 1
    elif option == "trace_dir":
        (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)
    else:
        again = _port_sim(tmp_path / "again")
        assert again.load_checkpoint(tmp_path / "ck.npz") == 900


def test_simulation_from_jax_carries_the_configuration(jax_run, tmp_path):
    jsim = jax_run[0]
    sim = interop.simulation_from_jax(jsim, "cpu", outdir=str(tmp_path))
    cmd, rel, og = _config(tconfig)
    assert sim.cmd == cmd and sim.releases == rel and sim.outgrid == og
    assert sim.seed == SEED and sim.nclassunc == 1 and sim.met_bf16
    assert sim.device == torch.device("cpu")
    assert type(sim.grid) is type(make_grid(**GRID))
    assert (sim.grid.nx, sim.grid.ny, sim.grid.ylat0) == (37, 15, -70.0)
    np.testing.assert_array_equal(sim.grid.akm, jsim.grid.akm)
    a = _numpy_particles(sim.particles)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], jax_run[2][f], err_msg=f)


def test_cuda_is_the_default_device_and_is_not_replaced(tmp_path):
    """The constructor asks for the card unless told otherwise, and raises
    where there is none instead of carrying on on the CPU."""
    field = {f.name: f for f in dataclasses.fields(Simulation)}["device"]
    assert field.default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cmd, rel, og = _config(tconfig)
    grid = make_grid(**GRID)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(cmd=cmd, releases=rel, grid=grid,
                   met_backend=SyntheticMet(grid), outgrid=og,
                   outdir=str(tmp_path))


def test_legacy_rng_on_cuda_is_refused_by_name(tmp_path):
    """The legacy-RNG validation path has no kernel: on the card the
    constructor refuses it by name (before it looks for a card), and
    writes nothing."""
    cmd, rel, og = _config(tconfig)
    grid = make_grid(**GRID)
    with pytest.raises(NotImplementedError, match="legacy_rng"):
        Simulation(cmd=cmd, releases=rel, grid=grid,
                   met_backend=SyntheticMet(grid), outgrid=og,
                   outdir=str(tmp_path), device="cuda", legacy_rng=True)
    assert not list(tmp_path.iterdir())


def test_reader_failure_is_counted_and_read_again(tmp_path, caplog):
    """A met read that dies in the reader thread is logged and counted, and
    the step loop reads that field itself, as the reference does."""
    sim = _port_sim(tmp_path, write_netcdf=False)
    calls = {"n": 0}
    inner = sim.met_backend

    class Flaky:
        def fetch(self, t, device):
            calls["n"] += 1
            if t == 7200.0 and calls["n"] == 3:
                raise OSError("wind file vanished")
            return inner.fetch(t, device)

    sim.met_backend = Flaky()
    with caplog.at_level(logging.WARNING, logger="flexpart_tpu_torch"):
        sim.run()
    assert sim._prefetch_failures == 1
    assert "died in the reader thread" in caplog.text
    assert int(sim.particles.active.sum()) == N
    assert len(list(tmp_path.glob("grid_conc_*.npz"))) == 2


def test_simulation_imports_without_jax_cuda_or_a_compiler():
    """A fresh interpreter imports the run loop and everything under it
    without loading jax or the JAX package, with no CUDA device, no nvcc
    and no triton around."""
    code = ("import sys\n"
            "import flexpart_tpu_torch.run.simulation\n"
            "from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid\n"
            "from flexpart_tpu_torch.met import SyntheticMet, make_grid\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'flexpart_tpu' or m.startswith('flexpart_tpu.')"
            " or m == 'triton']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root),
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")

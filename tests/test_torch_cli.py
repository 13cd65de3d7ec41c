"""The port's command line, ``python -m flexpart_tpu_torch pathnames``.

A job directory in the reference's layout (pathnames, options/, the
AVAILABLE index and npz met written by the port's ``save_eta_npz``) is run
end to end, as ``tests/test_cli.py::test_cli_end_to_end`` runs the JAX
package's, with ``IPOUT=0``: in a
fresh interpreter in which ``import jax`` and ``import flexpart_tpu``
fail, on the CPU (``--device cpu``), to the success banner, with the npz,
``dates``, ``header`` and ``grid_conc_*_001`` files.  The same job runs so
on GRIB met: ECMWF hybrid-eta files (``tests/test_gribdec.py``'s full
wind field) and NCEP GFS isobaric files (``tests/test_gfs.py``'s).

Against the JAX package: ``build_simulation`` of both on one job
directory gives the same Command, Releases, OutGrid, met grid and wind
interval (no JAX run, so nothing is compiled); on GRIB met also the same
``use_clwc``, off for ECMWF and on for GFS (its ``sumclouds``).  The CLI
refuses by name, before any file is written, what the port does not run
yet: ``--dp``, ``--tiles``, ``--trace-dir``; it runs an ``IPOUT=2`` job
and then the same job with ``IPIN=1`` from its ``partposit_end`` (JAX's
``build_simulation`` giving the same particles), an OH-reactive species
with the reference's ``OH_variables.bin``, and jobs with RECEPTORS,
OUTGRID_NEST (NESTED_OUTPUT=1), IFLUX=1, LINIT_COND=1 and MDOMAINFILL=1
(both packages' ``build_simulation`` giving the same receptors, nest
grid and Command), each writing its files; a release outside
the run's window fails, as the reference's does; ``--device cuda`` (the
default) without a card raises and never falls back to the CPU.  Nested
met from the pathnames file's nest pairs reaches the Simulation.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import main as jmain  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch import main as tmain  # noqa: E402
from flexpart_tpu_torch.io.fortran_writer import (  # noqa: E402
    read_grid_sparse, read_header)
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.met.npzmet import save_eta_npz  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNER = ("CONGRATULATIONS: YOU HAVE SUCCESSFULLY COMPLETED A FLEXPART "
          "MODEL RUN!")

# tests/test_cli.py's job, with IPOUT=0
COMMAND = """&COMMAND
 LDIRECT=1,
 IBDATE=20200101, IBTIME=000000,
 IEDATE=20200101, IETIME=030000,
 LOUTSTEP=3600, LOUTAVER=3600, LOUTSAMPLE=900,
 ITSPLIT=99999999, LSYNCTIME=900,
 CTL=-5.0, IFINE=4, IOUT=1, IPOUT=0, LSUBGRID=0, LCONVECTION=1,
 LAGESPECTRA=0, IPIN=0, IOUTPUTFOREACHRELEASE=1, IFLUX=0, MDOMAINFILL=0,
 IND_SOURCE=1, IND_RECEPTOR=1, MQUASILAG=0, NESTED_OUTPUT=0,
 LINIT_COND=0, SURF_ONLY=0, CBLFLAG=0,
 /
"""

RELEASES = """&RELEASES_CTRL
 NSPEC=1, SPECNUM_REL=24,
 /
&RELEASE
 IDATE1=20200101, ITIME1=000000, IDATE2=20200101, ITIME2=000000,
 LON1=-50.0, LON2=-48.0, LAT1=42.0, LAT2=44.0,
 Z1=100.0, Z2=500.0, ZKIND=1, MASS=1.0, PARTS=800,
 COMMENT="E2E",
 /
"""

SPECIES_024 = """&SPECIES_PARAMS
 PSPECIES="AIRTRACER", PWEIGHTMOLAR=29.0,
 /
"""

OUTGRID = """&OUTGRID
 OUTLON0=-180.0, OUTLAT0=-90.0, NUMXGRID=72, NUMYGRID=36,
 DXOUT=5.0, DYOUT=5.0, OUTHEIGHTS=500.0,2000.0,50000.0,
 /
"""

NEST = dict(nx=9, ny=9, nlev=15, dx=1.0, dy=1.0, xlon0=-53.0, ylat0=39.0,
            xglobal=False)


def _write_met(met, grid, hours=5):
    met.mkdir(parents=True)
    backend = SyntheticMet(grid)
    lines = ["header"] * 3
    for h in range(hours):
        name = f"EN20200101{h:02d}"
        save_eta_npz(met / (name + ".npz"), backend.fetch(h * 3600.0, "cpu"),
                     grid)
        lines.append(f"20200101 {h:02d}0000      {name}.npz      ON DISC")
    (met / "AVAILABLE").write_text("\n".join(lines) + "\n")


def _write_grib_met(met, kind, hours=5):
    """Hourly GRIB files of one kind and their AVAILABLE index."""
    from test_gfs import make_gfs_file
    from test_gribdec import _full_windfield_grib
    met.mkdir(parents=True)
    lines = ["header"] * 3
    for h in range(hours):
        name = f"{'GF' if kind == 'gfs' else 'EN'}20200101{h:02d}"
        if kind == "gfs":
            make_gfs_file(met, name=name)
        else:
            _full_windfield_grib(met / name, h * 3600)
        lines.append(f"20200101 {h:02d}0000      {name}      ON DISC")
    (met / "AVAILABLE").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def gribdirs(tmp_path_factory):
    """ECMWF and GFS GRIB met, each as the mother grid of a job."""
    root = tmp_path_factory.mktemp("grib")
    for kind in ("ecmwf", "gfs"):
        _write_grib_met(root / kind / "mother", kind)
    return root


# the GRIB jobs release at 40-42 E: the ECMWF file's grid starts at 0 E
# (no nxshift) and a particle's longitude stays in the met grid's frame,
# so at 50 W (310 E) it would sample past the 180 W output grid's east
# edge, in both packages
GRIB_RELEASES = {"RELEASES": RELEASES.replace("LON1=-50.0, LON2=-48.0",
                                              "LON1=40.0, LON2=42.0")}


def _run_cli_without_jax(pathnames, tmp_path):
    """``python -m flexpart_tpu_torch pathnames --device cpu -v`` in a
    fresh interpreter in which the JAX package and jax cannot load."""
    block = tmp_path / "block"
    for mod in ("jax", "flexpart_tpu"):
        (block / mod).mkdir(parents=True)
        (block / mod / "__init__.py").write_text(
            f"raise ImportError('the port imported {mod}')\n")
    return subprocess.run(
        [sys.executable, "-m", "flexpart_tpu_torch", str(pathnames),
         "--device", "cpu", "-v"],
        capture_output=True, text=True, timeout=300, cwd=pathnames.parent,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{block}:{ROOT}",
             "OMP_NUM_THREADS": "2", "HOME": str(tmp_path)})


def _assert_job_output(out, npart=800):
    """The banner's run wrote the npz, dates, header and sparse files."""
    npz = sorted(out.glob("grid_conc_*.npz"))
    assert len(npz) >= 2
    assert (out / "dates").exists() and (out / "header").exists()
    assert not list(out.glob("*.nc"))                 # LNETCDFOUT=0
    d = np.load(npz[-1])
    assert np.isfinite(d["conc"]).all() and d["conc"].max() > 0.0
    h = read_header(out / "header")
    assert (h["numxgrid"], h["numygrid"]) == (72, 36)
    assert h["releases"][0]["npart"] == npart
    assert h["species"] == ["AIRTRACER"]
    grids = sorted(out.glob("grid_conc_*_001"))
    assert [g.name[:-4] for g in grids] == [p.name[:-4] for p in npz]
    _, conc, _, _ = read_grid_sparse(grids[-1], 72, 36, 3)
    np.testing.assert_allclose(conc[0, 0], d["conc"][0, 0, 0], rtol=2e-6,
                               atol=1e-12)


@pytest.fixture(scope="module")
def metdir(tmp_path_factory):
    """npz met of the mother grid of tests/test_cli.py and of a 1-degree
    nest inside it, each with its AVAILABLE index."""
    root = tmp_path_factory.mktemp("met")
    _write_met(root / "mother", make_grid(nx=37, ny=19, nlev=15, dx=10.0,
                                          dy=10.0))
    _write_met(root / "nest", make_grid(**NEST))
    return root


def _job(base, metdir, command=COMMAND, nests=False, files=None):
    """A job directory of its own: options/, an empty output/ and a
    pathnames file naming the shared met."""
    opts = base / "options"
    (opts / "SPECIES").mkdir(parents=True)
    (base / "output").mkdir()
    (opts / "COMMAND").write_text(command)
    (opts / "RELEASES").write_text(RELEASES)
    (opts / "SPECIES" / "SPECIES_024").write_text(SPECIES_024)
    (opts / "OUTGRID").write_text(OUTGRID)
    for name, text in (files or {}).items():
        (opts / name).write_text(text)
    m = metdir / "mother"
    lines = [f"{opts}/", f"{base / 'output'}/", f"{m}/", f"{m / 'AVAILABLE'}"]
    if nests:
        n = metdir / "nest"
        lines += [f"{n}/", f"{n / 'AVAILABLE'}"]
    (base / "pathnames").write_text("\n".join(lines) + "\n")
    return base / "pathnames"


def test_cli_end_to_end_on_npz_met(metdir, tmp_path):
    pathnames = _job(tmp_path / "job", metdir)
    res = _run_cli_without_jax(pathnames, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert BANNER in res.stdout
    assert "particle-steps in" in res.stdout
    out = tmp_path / "job" / "output"
    npz = sorted(out.glob("grid_conc_*.npz"))
    assert len(npz) >= 2
    assert (out / "dates").exists() and (out / "header").exists()
    assert not (out / "partposit_end").exists()
    assert not list(out.glob("*.nc"))                 # LNETCDFOUT=0
    d = np.load(npz[-1])
    assert np.isfinite(d["conc"]).all() and d["conc"].max() > 0.0
    h = read_header(out / "header")
    assert (h["numxgrid"], h["numygrid"]) == (72, 36)
    assert h["releases"][0]["npart"] == 800 and h["species"] == ["AIRTRACER"]
    grids = sorted(out.glob("grid_conc_*_001"))
    assert [g.name[:-4] for g in grids] == [p.name[:-4] for p in npz]
    _, conc, _, _ = read_grid_sparse(grids[-1], 72, 36, 3)
    np.testing.assert_allclose(conc[0, 0], d["conc"][0, 0, 0], rtol=2e-6,
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["ecmwf", "gfs"])
def test_cli_end_to_end_on_grib_met(kind, gribdirs, tmp_path):
    """The job on GRIB met, in a fresh interpreter without JAX: the
    decoder (built from native/gribdec/gribdec.cpp) reads it in the met
    reader thread, to the banner and the job's files."""
    pathnames = _job(tmp_path / "job", gribdirs / kind, files=GRIB_RELEASES)
    res = _run_cli_without_jax(pathnames, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert BANNER in res.stdout and "particle-steps in" in res.stdout
    _assert_job_output(tmp_path / "job" / "output")


@pytest.mark.parametrize("kind", ["ecmwf", "gfs"])
def test_build_simulation_on_grib_equals_jax(kind, gribdirs, tmp_path):
    """Both packages' build_simulation on one GRIB job: the same Command,
    met grid (levels and pressure levels included), wind interval and
    use_clwc (ECMWF off: GribMet has no sumclouds; GFS on)."""
    pathnames = _job(tmp_path / "job", gribdirs / kind, files=GRIB_RELEASES)
    jsim = jmain.build_simulation(str(pathnames))
    jsim.close()
    shutil.rmtree(tmp_path / "job" / "output")
    (tmp_path / "job" / "output").mkdir()
    sim = tmain.build_simulation(str(pathnames), device="cpu")
    sim.close()
    assert type(sim.met_backend).__name__ == type(jsim.met_backend).__name__ \
        == ("GfsMet" if kind == "gfs" else "GribMet")
    assert sim.cmd == interop.command_from_jax(jsim.cmd)
    for k in ("nx", "ny", "nlev", "xlon0", "ylat0", "dx", "dy", "xglobal",
              "pressure_levels"):
        assert getattr(sim.grid, k) == getattr(jsim.grid, k), k
    np.testing.assert_array_equal(sim.grid.akm, jsim.grid.akm)
    np.testing.assert_array_equal(sim.grid.bkm, jsim.grid.bkm)
    assert sim.wind_interval == jsim.wind_interval == 3600
    assert sim.use_clwc == jsim.use_clwc == (kind == "gfs")


def test_build_simulation_equals_jax(metdir, tmp_path):
    pathnames = _job(tmp_path / "job", metdir)
    jsim = jmain.build_simulation(str(pathnames))
    jsim.close()
    shutil.rmtree(tmp_path / "job" / "output")
    (tmp_path / "job" / "output").mkdir()
    sim = tmain.build_simulation(str(pathnames), device="cpu")
    sim.close()
    assert sim.cmd == interop.command_from_jax(jsim.cmd)
    assert sim.releases == interop.releases_from_jax(jsim.releases)
    assert sim.outgrid == interop.outgrid_from_jax(jsim.outgrid)
    assert sim.ageclasses == interop.ageclasses_from_jax(jsim.ageclasses)
    for k in ("nx", "ny", "nlev", "xlon0", "ylat0", "dx", "dy", "xglobal"):
        assert getattr(sim.grid, k) == getattr(jsim.grid, k), k
    np.testing.assert_array_equal(sim.grid.akm, jsim.grid.akm)
    np.testing.assert_array_equal(sim.grid.bkm, jsim.grid.bkm)
    assert sim.wind_interval == jsim.wind_interval == 3600
    assert sim.write_fortran and jsim.write_fortran       # LNETCDFOUT=0
    assert not sim.write_netcdf and not jsim.write_netcdf
    assert sim.seed == jsim.seed == 1234
    assert sim.particles.capacity == jsim.particles.capacity == 800


# case -> (COMMAND edits, options files, CLI flags, the name refused)
REFUSED = {
    "dp": ({}, {}, ["--dp"], "distributed"),
    "tiles": ({}, {}, ["--tiles"], "distributed"),
    "trace_dir": ({}, {}, ["--trace-dir", "trace"], "trace_dir"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_cli_refuses_by_name_before_writing(case, metdir, tmp_path):
    edits, files, flags, name = REFUSED[case]
    command = COMMAND
    for a, b in edits.items():
        command = command.replace(a, b)
    pathnames = _job(tmp_path / "job", metdir, command=command, files=files)
    with pytest.raises(NotImplementedError, match="not ported yet") as err:
        tmain.main([str(pathnames), "--device", "cpu", *flags])
    assert name in str(err.value)
    assert not list((tmp_path / "job" / "output").iterdir())


OH_SPECIES = SPECIES_024.replace(
    "PWEIGHTMOLAR=29.0,", "PWEIGHTMOLAR=29.0, POHCCONST=1.0E-11, "
    "POHDCONST=500.0, POHNCONST=0.0,")


def _cli_ipin(metdir, tmp_path):
    """An IPOUT=2 run through main(), then the same job with IPIN=1 from
    its partposit_end: both packages' build_simulation give the same
    particles (the schedule's 800 and the dump's), bit for bit, and the
    port runs them to the end."""
    from flexpart_tpu_torch.io import partdump
    job = tmp_path / "job"
    pathnames = _job(job, metdir, command=COMMAND.replace("IPOUT=0",
                                                          "IPOUT=2"))
    assert tmain.main([str(pathnames), "--device", "cpu"]) == 0
    itime, d = partdump.read_partposit(job / "output" / "partposit_end", 1)
    assert itime == 10800 and len(d["z"]) == 800
    (job / "options" / "COMMAND").write_text(COMMAND.replace("IPIN=0",
                                                             "IPIN=1"))
    jsim = jmain.build_simulation(str(pathnames))
    jsim.close()
    sim = tmain.build_simulation(str(pathnames), device="cpu")
    assert sim.particles.capacity == 1600
    a = interop.particles_to_numpy(sim.particles)
    for f, v in a.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jsim.particles,
                                                            f)), err_msg=f)
    sim.run()
    assert int(sim.particles.active.sum()) == 1600


def _cli_oh_field(metdir, tmp_path):
    """An OH-reactive species with OH_FIELDS/OH_variables.bin where the
    reference looks for it (ohfields_path, relative to options/): both
    packages' build_simulation read the same climatology, and the port
    runs the job with its OH chemistry."""
    from test_torch_ohchem import _write_oh_file
    job = tmp_path / "job"
    pathnames = _job(job, metdir, files={})
    (job / "options" / "SPECIES" / "SPECIES_024").write_text(OH_SPECIES)
    oh = tmp_path / "flexin" / "OH_FIELDS" / "OH_variables.bin"
    oh.parent.mkdir(parents=True)
    _write_oh_file(oh)
    jsim = jmain.build_simulation(str(pathnames))
    jsim.close()
    sim = tmain.build_simulation(str(pathnames), device="cpu")
    assert sim.any_ohreact and sim.releases.species[0].ohcconst == 1.0e-11
    for k in ("lon", "lat", "alt", "oh", "lonjr", "latjr", "jrate_avg"):
        np.testing.assert_array_equal(getattr(sim.oh_field, k),
                                      getattr(jsim.oh_field, k), err_msg=k)
    assert sim.oh_field.oh.shape == (8, 6, 3, 12)
    sim.run()
    assert "ohchem" in sim.timings
    assert int(sim.particles.active.sum()) == 800


# case -> (COMMAND edits, options files, what the run writes in output/)
OPTIONS = {
    "receptors": ({}, {"RECEPTORS": '&RECEPTORS RECEPTOR="A", LON=-40.0, '
                                    'LAT=43.0, /\n'},
                  ("receptor_conc", "receptor_conc_20200101013000.npz")),
    "outgrid_nest": ({"NESTED_OUTPUT=0": "NESTED_OUTPUT=1"},
                     {"OUTGRID_NEST": "&OUTGRIDN OUTLON0N=-60.0, "
                      "OUTLAT0N=30.0, NUMXGRIDN=20, NUMYGRIDN=20, "
                      "DXOUTN=1.0, DYOUTN=1.0, /\n"},
                     ("nest/grid_conc_20200101013000.npz",)),
    "iflux": ({"IFLUX=0": "IFLUX=1"}, {},
              ("grid_flux_20200101013000", "grid_flux_20200101013000.npz")),
    "linit_cond": ({"LINIT_COND=0": "LINIT_COND=1"}, {},
                   ("grid_initial_001",)),
    "mdomainfill": ({"MDOMAINFILL=0": "MDOMAINFILL=1"}, {},
                    ("grid_conc_20200101013000.npz",)),
}


def _cli_option(case, metdir, tmp_path):
    """A job with a formerly refused option: both packages'
    build_simulation read the same configuration, and the port runs it
    through main() to the banner, writing the option's files."""
    edits, files, wrote = OPTIONS[case]
    command = COMMAND
    for a, b in edits.items():
        command = command.replace(a, b)
    pathnames = _job(tmp_path / "job", metdir, command=command, files=files)
    jsim = jmain.build_simulation(str(pathnames))
    jsim.close()
    sim = tmain.build_simulation(str(pathnames), device="cpu")
    sim.close()
    assert sim.cmd == interop.command_from_jax(jsim.cmd)
    assert sim.receptors == interop.receptors_from_jax(jsim.receptors)
    assert (sim.outgrid_nest is None) == (jsim.outgrid_nest is None)
    if sim.outgrid_nest is not None:
        assert sim.outgrid_nest == interop.outgrid_from_jax(jsim.outgrid_nest)
    assert tmain.main([str(pathnames), "--device", "cpu"]) == 0
    out = tmp_path / "job" / "output"
    for name in wrote:
        assert (out / name).exists(), name


@pytest.mark.parametrize("case", ["ipin", "oh_field", *OPTIONS])
def test_cli_runs_what_it_refused_before(case, metdir, tmp_path):
    if case in OPTIONS:
        _cli_option(case, metdir, tmp_path)
    else:
        {"ipin": _cli_ipin, "oh_field": _cli_oh_field}[case](metdir,
                                                             tmp_path)


def test_cli_release_outside_window_fails(metdir, tmp_path):
    """A COMMAND window a day after the release and the met
    (tests/test_cli.py:103-121): both packages fail at the first met read,
    with the same error, before any step."""
    command = (COMMAND.replace("IBDATE=20200101", "IBDATE=20200102")
               .replace("IEDATE=20200101", "IEDATE=20200102"))
    pathnames = _job(tmp_path / "job", metdir, command=command)
    errors = []
    for main in (jmain.main, lambda argv: tmain.main(argv + ["--device",
                                                              "cpu"])):
        with pytest.raises(FileNotFoundError) as err:
            main([str(pathnames)])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert errors[1].startswith("no wind field for t=0s in AVAILABLE")


def test_cli_device_cuda_without_a_card_raises(metdir, tmp_path):
    """The CLI's device is the card unless told otherwise; without one the
    run raises and writes nothing, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    pathnames = _job(tmp_path / "job", metdir)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main([str(pathnames)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main([str(pathnames), "--device", "cuda"])
    assert not list((tmp_path / "job" / "output").iterdir())


def test_cli_nested_met_from_pathnames(metdir, tmp_path):
    """A (metdata, AVAILABLE) pair after the first four lines of pathnames
    is a nested met grid: the Simulation samples it (K4's NESTS
    instantiation on a card), and the run reaches the banner."""
    pathnames = _job(tmp_path / "job", metdir, nests=True)
    sim = tmain.build_simulation(str(pathnames), device="cpu")
    assert sim.step_cfg.nests == ((NEST["nx"], NEST["ny"]),)
    assert sim.nest_grids[0].xlon0 == NEST["xlon0"]
    sim.close()
    shutil.rmtree(tmp_path / "job" / "output")
    (tmp_path / "job" / "output").mkdir()
    assert tmain.main([str(pathnames), "--device", "cpu"]) == 0
    assert len(list((tmp_path / "job" / "output").glob("grid_conc_*_001"))) \
        >= 2

"""The port's service layer (``flexpart_tpu_torch.service``) against the
JAX package's (``flexpart_tpu.service``, of which it is a copy).

Both packages' ``prepare_job_directory`` on one options tree that this
file writes (one key a line, so that every key the runtime configuration
names is patched), with the shipped runtime-configuration template and
one ``EnvironmentParameters``, give the same job directory file by file;
the one difference is the module on the ``job`` script's last line
(``flexpart_tpu_torch`` for ``flexpart_tpu``).  ``configure_namelist``,
``select_files`` and ``generate_available`` give the same files and
selections on drawn inputs (numpy, from a seed).  A ``LocalStore``
upload and download round trip, ``s3_store`` refused without boto3,
``python -m flexpart_tpu_torch.service generate`` and ``upload`` end to
end, and the generated job's command line run on the CPU (``--device
cpu`` after the job script's call) over its two hours, eight steps of 900
s, to the banner and its one output, at 01:30.
"""
import os
import subprocess
import sys
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import service as jservice  # noqa: E402
from flexpart_tpu_torch import service as tservice  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.met.npzmet import save_eta_npz  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TEMPLATE = (ROOT / "flexpart_tpu_torch" / "service"
            / "runtime_configuration.example.yaml")
BANNER = ("CONGRATULATIONS: YOU HAVE SUCCESSFULLY COMPLETED A FLEXPART "
          "MODEL RUN!")

# one key a line: configure_namelist patches the first key of a line
COMMAND = """&COMMAND
 LDIRECT=1,
 IBDATE=20120101,
 IBTIME=000000,
 IEDATE=20120101,
 IETIME=030000,
 LOUTSTEP=3600,
 LOUTAVER=3600,
 LOUTSAMPLE=900,
 LSYNCTIME=900,
 CTL=-5.0,
 IFINE=4,
 IOUT=1,
 IPOUT=0,
 LSUBGRID=0,
 LCONVECTION=0,
 /
"""

RELEASES = """&RELEASES_CTRL
 NSPEC=1,
 SPECNUM_REL=24,
 /
&RELEASE
 IDATE1=20120101,
 ITIME1=000000,
 IDATE2=20120101,
 ITIME2=000000,
 LON1=-50.0,
 LON2=-48.0,
 LAT1=42.0,
 LAT2=44.0,
 Z1=100.0,
 Z2=500.0,
 ZKIND=1,
 MASS=1.0,
 PARTS=800,
 COMMENT="JOB",
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

GRID = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)


def _env(hours: int = 1):
    t0 = datetime(2020, 1, 1, 0)
    return tservice.EnvironmentParameters(
        emission_start=t0, emission_end=t0,
        simulation_end=t0 + timedelta(hours=hours))


@pytest.fixture(scope="module")
def job_inputs(tmp_path_factory):
    """An options tree and a met directory of npz archives (hourly from
    2020-01-01 00:00 over five hours, and a README that is no met file)."""
    root = tmp_path_factory.mktemp("service")
    opts = root / "options"
    (opts / "SPECIES").mkdir(parents=True)
    (opts / "COMMAND").write_text(COMMAND)
    (opts / "RELEASES").write_text(RELEASES)
    (opts / "SPECIES" / "SPECIES_024").write_text(SPECIES_024)
    (opts / "OUTGRID").write_text(OUTGRID)
    met = root / "met"
    met.mkdir()
    grid = make_grid(**GRID)
    backend = SyntheticMet(grid)
    for h in range(5):
        save_eta_npz(met / f"EN20200101{h:02d}.npz",
                     backend.fetch(h * 3600.0, "cpu"), grid)
    (met / "README").write_text("not a met file\n")
    return opts, met


def _tree(job: Path) -> dict:
    """{relative path: bytes} of a job directory's files, the data link
    as its target."""
    out = {}
    for f in sorted(job.rglob("*")):
        rel = f.relative_to(job)
        if rel.parts[0] == "data":
            if rel == Path("data"):
                out["data ->"] = os.readlink(f).encode()
            continue
        if f.is_file():
            out[str(rel)] = f.read_bytes()
        elif f.is_dir():
            out[str(rel) + "/"] = b""
    return out


@pytest.mark.parametrize("site", ["BEZ", "TEST"])
def test_prepare_job_directory_matches_jax(site, job_inputs, tmp_path):
    opts, met = job_inputs
    env = _env()
    jenv = jservice.EnvironmentParameters(*(getattr(env, f) for f in (
        "emission_start", "emission_end", "simulation_end")))
    jtemplate = (ROOT / "flexpart_tpu" / "service"
                 / "runtime_configuration.example.yaml")
    assert TEMPLATE.read_bytes() == jtemplate.read_bytes()
    jobs = tmp_path / "jobs"
    jjob = jservice.prepare_job_directory(jobs, opts, met, site, jtemplate,
                                          jenv)
    a = _tree(jjob)
    jobs.rename(tmp_path / "jobs_jax")
    tjob = tservice.prepare_job_directory(jobs, opts, met, site, TEMPLATE,
                                          env)
    assert tjob == jjob
    b = _tree(tjob)
    assert sorted(a) == sorted(b)
    for name in a:
        if name == "job":
            ja, jb = a[name].decode().splitlines(), b[name].decode()\
                .splitlines()
            assert ja[:-1] == jb[:-1]
            assert ja[-1].replace("-m flexpart_tpu ",
                                  "-m flexpart_tpu_torch ") == jb[-1]
        else:
            assert a[name] == b[name], name
    assert os.access(tjob / "job", os.X_OK)
    # the run's window reached COMMAND and the release's RELEASES
    command = (tjob / "input" / "COMMAND").read_text()
    assert " IBDATE=20200101," in command and " IETIME=010000," in command
    # the five archives are met files, the README is not
    assert len((tjob / "AVAILABLE").read_text().splitlines()) == 3 + 5


def test_unknown_site_raises(job_inputs, tmp_path):
    opts, met = job_inputs
    with pytest.raises(KeyError, match="NOPE"):
        tservice.prepare_job_directory(tmp_path / "jobs", opts, met, "NOPE",
                                       TEMPLATE, _env())


def _drawn_namelist(rs) -> tuple:
    """A namelist of 3-8 keys (some with comments, some several a line)
    and a patch of a drawn subset of them and of keys it lacks."""
    keys = [f"K{i}" for i in rs.choice(40, rs.integers(3, 9), replace=False)]
    lines = ["&GROUP\n"]
    for k in keys:
        v = rs.choice([str(rs.integers(0, 10 ** 6)),
                       f"{rs.uniform(-1e3, 1e3):.4f}", '"text"'])
        tail = rs.choice(["\n", " ! note\n", ", OTHER=1,\n"])
        lines.append(f" {k}{rs.choice(['=', ' = ', '= '])}{v},{tail}")
    lines.append("/\n")
    patch = {k: int(rs.integers(0, 99)) for k in keys
             if rs.uniform() < 0.5}
    patch.update({f"MISSING{i}": 1 for i in range(int(rs.integers(0, 3)))})
    return "".join(lines), patch


def _drawn_met_files(rs) -> list:
    """Met file names with times as 10-14 trailing digits, and some that
    carry none."""
    t0 = datetime(2021, 6, 20)
    names = []
    for _ in range(int(rs.integers(5, 30))):
        t = t0 + timedelta(hours=int(rs.integers(-24, 48)))
        names.append(rs.choice([f"EN{t:%Y%m%d%H}", f"dispf{t:%Y%m%d%H%M%S}",
                                f"x_{t:%Y%m%d%H%M}.npz", "README",
                                "checksums.md5"]))
    return [Path("/met") / n for n in dict.fromkeys(names)]


@pytest.mark.parametrize("seed", range(4))
def test_namelist_selection_and_available_match_jax(seed, tmp_path):
    rs = np.random.default_rng(seed)
    text, patch = _drawn_namelist(rs)
    for pkg, name in ((jservice, "jax"), (tservice, "port")):
        (tmp_path / name).write_text(text)
        pkg.configure_namelist(patch, tmp_path / name)
    assert (tmp_path / "jax").read_text() == (tmp_path / "port").read_text()
    files = _drawn_met_files(rs)
    start = datetime(2021, 6, 20) + timedelta(hours=int(rs.integers(0, 12)))
    end = start + timedelta(hours=int(rs.integers(0, 24)))
    margin = int(rs.integers(0, 6))
    assert tservice.select_files(files, start, end, margin_hours=margin) \
        == jservice.select_files(files, start, end, margin_hours=margin)
    for pkg, name in ((jservice, "jax_av"), (tservice, "port_av")):
        pkg.generate_available(tmp_path / name, files)
    assert (tmp_path / "jax_av").read_bytes() \
        == (tmp_path / "port_av").read_bytes()


def test_local_store_round_trip(tmp_path):
    out = tmp_path / "job" / "output"
    (out / "sub").mkdir(parents=True)
    (out / "grid_conc_x.npz").write_bytes(b"data1")
    (out / "sub" / "header").write_bytes(b"data2")
    store = tservice.LocalStore(tmp_path / "store")
    assert tservice.upload_output(store, tmp_path / "job", "results",
                                  prefix="run1") == 2
    keys = store.list_objects("results", "run1/")
    assert keys == ["run1/grid_conc_x.npz", "run1/sub/header"]
    back = tservice.download_keys(store, "results", keys, tmp_path / "dl")
    assert [f.read_bytes() for f in back] == [b"data1", b"data2"]
    assert store.list_objects("nothing") == []


def test_s3_store_needs_boto3(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError):
        tservice.s3_store()


def test_package_imports_without_yaml():
    """``import flexpart_tpu_torch.service`` reads no YAML module: PyYAML
    is imported only where a template is rendered."""
    code = ("import sys; sys.modules['yaml'] = None; "
            "import flexpart_tpu_torch.service as s; "
            "print(s.build_job_directory.__name__)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "build_job_directory"


def test_service_cli_generates_and_runs_a_job(job_inputs, tmp_path):
    """``python -m flexpart_tpu_torch.service generate`` builds the TEST
    site's job for two hours; its job script's command line, with
    ``--device cpu``, runs it to the banner; ``upload`` sends its output to a
    filesystem store, byte for byte."""
    opts, met = job_inputs
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2",
           "EMISSION_START": "2020010100", "EMISSION_END": "2020010100",
           "SIMULATION_END": "2020010102"}
    jobs = tmp_path / "jobs"
    res = subprocess.run(
        [sys.executable, "-m", "flexpart_tpu_torch.service", "generate",
         "-j", str(jobs), "-o", str(opts), "-m", str(met), "--site", "TEST",
         "--runtime-config", str(TEMPLATE)],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    job = Path(res.stdout.strip())
    assert job == jobs / "TEST"
    call = (job / "job").read_text().splitlines()[-1].split()
    assert call[:3] == ["python", "-m", "flexpart_tpu_torch"]
    run = subprocess.run([sys.executable, *call[1:], "--device", "cpu"],
                         capture_output=True, text=True, timeout=300,
                         cwd=job, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    assert BANNER in run.stdout
    out = job / "output"
    assert (out / "dates").read_text().split() == ["20200101013000"]
    d = np.load(out / "grid_conc_20200101013000.npz")
    assert np.isfinite(d["conc"]).all() and d["conc"].max() > 0.0
    up = subprocess.run(
        [sys.executable, "-m", "flexpart_tpu_torch.service", "upload",
         "-j", str(job), "--bucket", "results", "--prefix", "TEST",
         "--store-root", str(tmp_path / "store")],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert up.returncode == 0, up.stderr
    files = sorted(f for f in out.rglob("*") if f.is_file())
    assert up.stdout.strip() == f"uploaded {len(files)} objects"
    for f in files:
        obj = tmp_path / "store" / "results" / "TEST" / f.relative_to(out)
        assert obj.read_bytes() == f.read_bytes()

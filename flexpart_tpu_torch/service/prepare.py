"""Operational job preparation — the service layer of the reference
(utils/flexpart_ifs_utils/prepare_flexpart.py; a copy of
``flexpart_tpu/service/prepare.py``).

Builds a self-contained job directory for one release site: copies the
options/ tree, patches the COMMAND and RELEASES namelists from a per-site
runtime configuration (rendered from environment parameters), indexes the
met archive into an AVAILABLE file, writes the 4-line pathnames file and
a job script that invokes the port's command line (python -m
flexpart_tpu_torch).  ``build_job_directory`` does the same from a site's
configuration already rendered (a dict), with no YAML."""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import stat
from datetime import datetime, timedelta
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class EnvironmentParameters:
    """The operational run window, normally taken from environment
    variables (prepare_flexpart.py env contract / model.py)."""
    emission_start: datetime
    emission_end: datetime
    simulation_end: datetime

    @classmethod
    def from_env(cls, env=os.environ):
        """EMISSION_START / EMISSION_END / SIMULATION_END as
        YYYYMMDDHH (the reference splits these into *_YYYY/_MM/_DD/_ZZ
        template variables)."""
        def get(name):
            v = env[name]
            return datetime.strptime(v, "%Y%m%d%H")
        return cls(emission_start=get("EMISSION_START"),
                   emission_end=get("EMISSION_END"),
                   simulation_end=get("SIMULATION_END"))

    def template_vars(self) -> dict:
        out = {}
        for prefix, dt in (("EMISSION_START", self.emission_start),
                           ("EMISSION_END", self.emission_end),
                           ("SIMULATION_END", self.simulation_end)):
            out[f"{prefix}_YYYY"] = f"{dt.year:04d}"
            out[f"{prefix}_MM"] = f"{dt.month:02d}"
            out[f"{prefix}_DD"] = f"{dt.day:02d}"
            out[f"{prefix}_ZZ"] = f"{dt.hour:02d}"
        return out


_VAR = re.compile(r"\{\{\s*(?:data\.)?(\w+)\s*\}\}")


def render_runtime_configuration(template_path, env: EnvironmentParameters):
    """Render the runtime-configuration YAML (runtime_configuration.j2
    analog): substitute {{ data.VAR }} placeholders, parse, and return
    {site_name: {"command": {...}, "releases": {...}}}."""
    import yaml  # PyYAML: read only where a template is rendered

    text = Path(template_path).read_text()
    tv = env.template_vars()
    text = _VAR.sub(lambda m: tv.get(m.group(1), m.group(0)), text)
    cfg = yaml.safe_load(text)
    return {entry["name"]: entry for entry in cfg}


def configure_namelist(config: dict, namelist: Path) -> None:
    """Patch KEY=VALUE entries of an existing Fortran namelist file in
    place (prepare_flexpart.py _configure_namelist analog): every KEY
    present in ``config`` gets its value replaced, preserving comments
    and unknown keys."""
    lines = Path(namelist).read_text().splitlines(keepends=True)
    out = []
    for line in lines:
        m = re.match(r"(\s*)(\w+)(\s*=\s*)([^,!\n]*)(.*\n?)", line)
        if m and m.group(2).upper() in config:
            val = config[m.group(2).upper()]
            out.append(f"{m.group(1)}{m.group(2)}{m.group(3)}"
                       f"{val},{m.group(5).lstrip(', ')}"
                       if not m.group(5).startswith(",")
                       else f"{m.group(1)}{m.group(2)}{m.group(3)}"
                            f"{val}{m.group(5)}")
        else:
            out.append(line)
    Path(namelist).write_text("".join(out))


def generate_available(path: Path, met_files: list[Path],
                       time_of=None) -> None:
    """Write the AVAILABLE index (readavailable.f90 format: 3 header
    lines then 'YYYYMMDD HHMMSS filename ON DISK')."""
    if time_of is None:
        # default: trailing YYYYMMDDHH[MMSS] digits of the filename
        def time_of(p):
            digits = re.findall(r"(\d{10,14})", p.name)
            if not digits:
                return None          # not a met file (README, checksums…)
            return datetime.strptime(digits[-1].ljust(14, "0"),
                                     "%Y%m%d%H%M%S")
    lines = ["DATE     TIME        FILENAME\n",
             "YYYYMMDD HHMISS\n",
             "________ ______      __________________\n"]
    for f in sorted(met_files, key=lambda p: p.name):
        t = time_of(f)
        if t is None:
            continue
        lines.append(f"{t:%Y%m%d} {t:%H%M%S}      {f.name}      "
                     "ON DISK\n")
    Path(path).write_text("".join(lines))


def select_files(met_files, start: datetime, end: datetime, time_of=None,
                 margin_hours: int = 3):
    """Met files whose valid time falls in [start-margin, end+margin]
    (prepare_flexpart.py select_files / _select_keys_in_window)."""
    if time_of is None:
        def time_of(p):
            digits = re.findall(r"(\d{10,14})", Path(p).name)
            if not digits:
                return None          # skip stray non-met files
            return datetime.strptime(digits[-1].ljust(14, "0"),
                                     "%Y%m%d%H%M%S")
    lo = start - timedelta(hours=margin_hours)
    hi = end + timedelta(hours=margin_hours)
    out = []
    for f in met_files:
        t = time_of(f)
        if t is not None and lo <= t <= hi:
            out.append(f)
    return out


def write_pathnames(job_dir: Path, input_dir: Path, output_dir: Path,
                    data_dir: Path, available: Path) -> Path:
    p = job_dir / "pathnames"
    p.write_text(f"{input_dir}/\n{output_dir}/\n{data_dir}/\n"
                 f"{available}\n")
    return p


def write_job_script(job_dir: Path, pathnames: Path,
                     extra_env: dict | None = None) -> Path:
    """The 'job' shell script the container entrypoint runs
    (prepare_flexpart.py _write_job_script): env setup + model CLI."""
    lines = ["#!/bin/bash\nset -euo pipefail\n"]
    for k, v in (extra_env or {}).items():
        lines.append(f"export {k}={v}\n")
    lines.append(f"python -m flexpart_tpu_torch {pathnames}\n")
    script = job_dir / "job"
    script.write_text("".join(lines))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script


def prepare_job_directory(jobs_dir, options_dir, met_dir, site: str,
                          runtime_template, env: EnvironmentParameters,
                          met_glob: str = "*") -> Path:
    """Build one site's complete job directory; returns its path."""
    cfg = render_runtime_configuration(runtime_template, env)
    if site not in cfg:
        raise KeyError(f"release site {site!r} not in runtime "
                       f"configuration ({sorted(cfg)})")
    return build_job_directory(jobs_dir, options_dir, met_dir, site,
                               cfg[site], env, met_glob)


def build_job_directory(jobs_dir, options_dir, met_dir, site: str,
                        site_cfg: dict, env: EnvironmentParameters,
                        met_glob: str = "*") -> Path:
    """prepare_job_directory with the site's runtime configuration given
    rendered ({"command": {...}, "releases": {...}}); returns the job
    directory."""
    jobs_dir = Path(jobs_dir)
    job_dir = jobs_dir / site
    input_dir = job_dir / "input"
    output_dir = job_dir / "output"
    data_dir = job_dir / "data"
    output_dir.mkdir(parents=True)
    shutil.copytree(options_dir, input_dir)

    configure_namelist({k.upper(): v for k, v in
                        site_cfg.get("command", {}).items()},
                       input_dir / "COMMAND")
    configure_namelist({k.upper(): v for k, v in
                        site_cfg.get("releases", {}).items()},
                       input_dir / "RELEASES")

    met_dir = Path(met_dir)
    files = select_files(sorted(met_dir.glob(met_glob)),
                         env.emission_start, env.simulation_end)
    if not files:
        raise FileNotFoundError(f"no met files in {met_dir} covering "
                                f"{env.emission_start}..{env.simulation_end}")
    data_dir.symlink_to(met_dir)
    available = job_dir / "AVAILABLE"
    generate_available(available, files)
    pathnames = write_pathnames(job_dir, input_dir, output_dir,
                                data_dir, available)
    write_job_script(job_dir, pathnames)
    return job_dir

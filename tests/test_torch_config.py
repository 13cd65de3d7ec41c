"""Port parity for the configuration layer and the date helpers.

``flexpart_tpu_torch/config/`` and ``utils/dates.py`` are copies of the JAX
package's modules (none of them imports jax): each dataclass must equal the
reference's field for field on the same keyword arguments, with the same
derived properties, and ``interop``'s ``*_from_jax`` must rebuild each from
the reference's object.  The namelist parsers are exercised by the
reference's own parser tests on files that are not part of the repository;
here one COMMAND namelist written by the test goes through both.
"""
import dataclasses
from datetime import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu.utils import dates as jdates  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.utils import dates as tdates  # noqa: E402

COMMAND_KW = dict(ldirect=-1, ibdate=20200101, ibtime=30000, iedate=20200103,
                  ietime=120000, loutstep=7200, loutaver=3600, loutsample=900,
                  lsynctime=900, ctl=2.0, ifine=5, iout=9, cblflag=0,
                  lsubgrid=0, lconvection=0, ind_source=2, ind_receptor=2)
COMMAND_PROPS = ("bdate", "edate", "ideltas", "turbswitch", "ifine_eff",
                 "ctl_eff", "fine", "method", "mintime", "use_netcdf",
                 "iout_eff", "ind_rel", "ind_samp")
SPECIES_KW = dict(name="Cs-137", decay_halflife=9.5e8, crain_aero=1.0,
                  csnow_aero=1.0, ccn_aero=0.9, in_aero=0.1, density=2500.0,
                  dquer=0.6, dsigma=3.0e-1 + 1.0, weightmolar=137.0,
                  area_hour=(0.5,) * 12 + (1.5,) * 12)
BOX_KW = dict(idate1=20200101, itime1=0, idate2=20200101, itime2=13000,
              lon1=-3.5, lon2=2.0, lat1=40.0, lat2=42.5, z1=50.0, z2=500.0,
              zkind=2, mass=(1.0, 2.5), parts=777, comment="stack")
OUTGRID_KW = dict(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                  dxout=2.0, dyout=1.5, outheights=(500.0, 2000.0, 50000.0))


def _same_fields(t, j):
    tf = [(f.name, f.type, getattr(t, f.name)) for f in dataclasses.fields(t)]
    jf = [(f.name, f.type, getattr(j, f.name)) for f in dataclasses.fields(j)]
    assert tf == jf


CASES = {
    "Command": (COMMAND_KW, COMMAND_PROPS),
    "Command_defaults": ({}, COMMAND_PROPS),
    "Species": (SPECIES_KW, ("has_time_variation", "decay", "is_aerosol",
                             "drydep_gas", "drydep", "wetdep", "ohreact")),
    "Species_defaults": ({}, ("has_time_variation", "decay", "drydep",
                              "wetdep", "ohreact")),
    "ReleaseBox": (BOX_KW, ("start", "end")),
    "OutGrid": (OUTGRID_KW, ("numzgrid",)),
    "AgeClasses": (dict(lage=(3600, 86400)), ("nageclass", "max_age")),
    "AgeClasses_defaults": ({}, ("nageclass", "max_age")),
    "Receptor": (dict(name="R1", lon=1.0, lat=2.0), ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataclass_equals_the_reference(case):
    kw, props = CASES[case]
    name = case.split("_")[0]
    t, j = getattr(tconfig, name)(**kw), getattr(jconfig, name)(**kw)
    _same_fields(t, j)
    for prop in props:
        assert getattr(t, prop) == getattr(j, prop), prop


def test_size_classes_equal_the_reference():
    t = tconfig.Species(**SPECIES_KW).size_classes()
    j = jconfig.Species(**SPECIES_KW).size_classes()
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name),
                                      err_msg=f.name)
    assert tconfig.Species().size_classes() is None


def test_releases_equal_the_reference_and_cross_over():
    def build(c):
        return c.Releases(
            species=(c.Species(), c.Species(**SPECIES_KW)),
            boxes=(c.ReleaseBox(**BOX_KW),
                   c.ReleaseBox(**{**BOX_KW, "parts": 5, "comment": "b"})))
    t, j = build(tconfig), build(jconfig)
    for prop in ("nspec", "numpoint", "total_particles"):
        assert getattr(t, prop) == getattr(j, prop)
    for a, b in zip(t.species + t.boxes, j.species + j.boxes):
        _same_fields(a, b)
    crossed = interop.releases_from_jax(j)
    assert crossed == t and type(crossed.species[0]) is tconfig.Species


@pytest.mark.parametrize("name,kw,fn", [
    ("Command", COMMAND_KW, "command_from_jax"),
    ("OutGrid", OUTGRID_KW, "outgrid_from_jax"),
    ("AgeClasses", dict(lage=(3600, 86400)), "ageclasses_from_jax"),
])
def test_interop_rebuilds_the_reference_object(name, kw, fn):
    crossed = getattr(interop, fn)(getattr(jconfig, name)(**kw))
    assert type(crossed) is getattr(tconfig, name)
    assert crossed == getattr(tconfig, name)(**kw)


def test_command_validate_and_namelist(tmp_path):
    text = ("&COMMAND\n LDIRECT=1, IBDATE=20200101, IBTIME=000000,\n"
            " IEDATE=20200102, IETIME=060000, LOUTSTEP=3600, LOUTAVER=3600,\n"
            " LOUTSAMPLE=900, LSYNCTIME=900, CTL=-5.0, IFINE=4, IOUT=1,\n /\n")
    path = tmp_path / "COMMAND"
    path.write_text(text)
    t, j = tconfig.Command.from_file(path), jconfig.Command.from_file(path)
    _same_fields(t, j)
    assert t.ideltas == 30 * 3600
    t.validate()
    assert tconfig.parse_namelist(text) == jconfig.parse_namelist(text)
    bad = tconfig.Command(loutsample=7200, loutaver=3600)
    with pytest.raises(ValueError):
        bad.validate()
    with pytest.raises(ValueError):
        jconfig.Command(loutsample=7200, loutaver=3600).validate()


@pytest.mark.parametrize("ymd,hms,secs", [
    (20200101, 0, 0.0), (20200229, 235959, 1.0), (19991231, 120000, 86400.5),
    (20240630, 63000, -3600.0)])
def test_dates_equal_the_reference(ymd, hms, secs):
    t, j = (tdates.parse_yyyymmdd_hhmmss(ymd, hms),
            jdates.parse_yyyymmdd_hhmmss(ymd, hms))
    assert t == j and isinstance(t, datetime)
    assert tdates.format_yyyymmdd_hhmmss(t) == jdates.format_yyyymmdd_hhmmss(j)
    assert tdates.format_yyyymmdd_hhmmss(t) == (ymd, hms)
    assert tdates.datestamp(t) == jdates.datestamp(j)
    assert tdates.add_seconds(t, secs) == jdates.add_seconds(j, secs)
    assert tdates.julian(t) == jdates.julian(j)

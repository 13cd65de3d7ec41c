"""Species definitions.

Typed equivalent of the SPECIES_nnn namelists
(readspecies.f90; format at
options/SPECIES/SPECIES_024:1-21) including the
time-independent aerosol size-class tables (settling velocity, Schmidt
number, mass fraction per diameter bin) the reference precomputes in
``part0`` (part0.f90) at release read time
(readreleases.f90:328-340).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np

from .namelist import namelist_single
from ..constants import GA, NI, PI


@dataclasses.dataclass(frozen=True)
class SizeClasses:
    """Per-diameter-bin tables for aerosol species (part0.f90)."""
    fract: np.ndarray   # (NI,) mass fraction per bin
    schmi: np.ndarray   # (NI,) Schmidt^{-2/3} per bin
    vset: np.ndarray    # (NI,) settling velocity per bin [m/s] (positive down)
    cunningham: float   # fraction-weighted slip-flow correction
    vsetaver: float     # fraction-weighted mean settling velocity [m/s], <0


def part0(dquer_um: float, dsigma: float, density: float) -> SizeClasses:
    """Log-normal size distribution split into NI bins (part0.f90:60-120).

    dquer_um: geometric mass-mean diameter [um]; dsigma: geometric std.
    """
    tr = 293.15
    myl = 1.81e-5
    nyl = 0.15e-4
    lam = 6.53e-8
    kb = 1.38e-23
    eps = 1.2e-38

    dsig = dsigma
    if dsig == 1.0:
        dsig = 1.0 + 1e-9
    xdummy = math.sqrt(2.0) * abs(math.log(dsig))

    delta = 6.0 / NI
    fract = np.zeros(NI)
    schmi = np.zeros(NI)
    vsh = np.zeros(NI)
    cun_w = 0.0

    d01 = dquer_um * dsig ** (-3.0)
    for i in range(1, NI + 1):
        d02 = d01
        d01 = dquer_um * dsig ** (-3.0 + delta * i)
        x01 = math.log(d01 / dquer_um) / xdummy
        x02 = math.log(d02 / dquer_um) / xdummy
        fract[i - 1] = 0.5 * (math.erf(x01) - math.erf(x02))
        dmean = 1.0e-6 * math.exp(0.5 * math.log(d01 * d02))
        kn = 2.0 * lam / dmean
        if (-1.1 / kn) <= math.log10(eps) * math.log(10.0):
            alpha = 1.257
        else:
            alpha = 1.257 + 0.4 * math.exp(-1.1 / kn)
        cun = 1.0 + alpha * kn
        dc = kb * tr * cun / (3.0 * PI * myl * dmean)
        schmidt = nyl / dc
        schmi[i - 1] = schmidt ** (-2.0 / 3.0)
        vsh[i - 1] = GA * density * dmean * dmean * cun / (18.0 * myl)
        cun_w += cun * fract[i - 1]

    vsetaver = -float(np.sum(vsh * fract))
    return SizeClasses(fract=fract, schmi=schmi, vset=vsh,
                       cunningham=cun_w, vsetaver=vsetaver)


@dataclasses.dataclass(frozen=True)
class Species:
    name: str = "AIRTRACER"
    decay_halflife: float = -9.9      # PDECAY [s]; <=0 -> no decay
    weta_gas: float = -9.9e-10        # below-cloud gas scavenging A
    wetb_gas: float = -9.9            # below-cloud gas scavenging B
    crain_aero: float = -9.9          # below-cloud aerosol rain efficiency
    csnow_aero: float = -9.9          # below-cloud aerosol snow efficiency
    ccn_aero: float = -9.9            # in-cloud CCN activation efficiency
    in_aero: float = -9.9             # in-cloud IN activation efficiency
    density: float = -9.9e8           # particle density [kg/m3]; <=0 -> gas
    dquer: float = 0.0                # particle diameter [um] (converted)
    dsigma: float = 0.0
    dryvel: float = -9.99             # prescribed dry deposition velocity [m/s]
    reldiff: float = -9.9             # diffusivity ratio D_H2O/D_x (gases)
    henry: float = -9.9e-10           # Henry constant
    f0: float = -9.0                  # chemical reactivity 0..1
    weightmolar: float = 29.0         # molar weight [g/mol]
    ohcconst: float = -9.9e-10        # OH reaction C [cm3/molec/s]
    ohdconst: float = -9.9            # OH reaction D [K]
    ohnconst: float = 2.0             # OH reaction N
    specnum: int = 0                  # species file number
    # emission time variation (readspecies.f90:53-96: parea_dow/
    # parea_hour/ppoint_dow/ppoint_hour, default all 1.0); factors are
    # local-time hour-of-day (24) and day-of-week (7, Monday first)
    area_dow: tuple = (1.0,) * 7
    area_hour: tuple = (1.0,) * 24
    point_dow: tuple = (1.0,) * 7
    point_hour: tuple = (1.0,) * 24

    @property
    def has_time_variation(self) -> bool:
        return any(abs(f - 1.0) > 1e-12
                   for t in (self.area_dow, self.area_hour,
                             self.point_dow, self.point_hour)
                   for f in t)

    @property
    def decay(self) -> float:
        """Decay constant [1/s] (readspecies: decay=0.693147/halflife)."""
        if self.decay_halflife > 0.0:
            return 0.693147 / self.decay_halflife
        return -1.0

    @property
    def is_aerosol(self) -> bool:
        return self.dquer > 0.0

    @property
    def drydep_gas(self) -> bool:
        return self.reldiff > 0.0

    @property
    def drydep(self) -> bool:
        """Species subject to dry deposition (readreleases.f90:382)."""
        return self.reldiff > 0.0 or self.density > 0.0 or self.dryvel > 0.0

    @property
    def wetdep(self) -> bool:
        if self.dquer <= 0.0:
            return self.weta_gas > 0.0 or self.wetb_gas > 0.0
        return (self.crain_aero > 0.0 or self.csnow_aero > 0.0
                or self.ccn_aero > 0.0 or self.in_aero > 0.0)

    @property
    def ohreact(self) -> bool:
        return self.ohcconst > 0.0

    def size_classes(self) -> SizeClasses | None:
        if self.density > 0.0 and self.dquer > 0.0:
            if self.dsigma <= 1.0:
                # readspecies.f90:339-343: aerosol dsigma must exceed 1
                raise ValueError(
                    f"species {self.name}: PDSIGMA={self.dsigma} invalid; "
                    "must be > 1 for aerosols (readspecies.f90:339)")
            return part0(self.dquer, self.dsigma, self.density)
        return None

    @classmethod
    def from_file(cls, path: str | Path, specnum: int = 0) -> "Species":
        raw = namelist_single(Path(path).read_text(), "species_params")
        key_map = {
            "pspecies": "name", "pdecay": "decay_halflife",
            "pweta_gas": "weta_gas", "pwetb_gas": "wetb_gas",
            "pcrain_aero": "crain_aero", "pcsnow_aero": "csnow_aero",
            "pccn_aero": "ccn_aero", "pin_aero": "in_aero",
            "pdensity": "density", "pdquer": "dquer", "pdsigma": "dsigma",
            "pdryvel": "dryvel", "preldiff": "reldiff", "phenry": "henry",
            "pf0": "f0", "pweightmolar": "weightmolar",
            "pohcconst": "ohcconst", "pohdconst": "ohdconst",
            "pohnconst": "ohnconst",
            "parea_dow": "area_dow", "parea_hour": "area_hour",
            "ppoint_dow": "point_dow", "ppoint_hour": "point_hour",
        }
        vector_len = {"area_dow": 7, "area_hour": 24,
                      "point_dow": 7, "point_hour": 24}
        kwargs = {}
        for k, v in raw.items():
            if k in key_map:
                name = key_map[k]
                if name in vector_len:
                    vals = v if isinstance(v, list) else [v]
                    # Fortran repeat syntax "24*1.0" survives parsing as
                    # a string token
                    out: list[float] = []
                    for item in vals:
                        if isinstance(item, str) and "*" in item:
                            n, val = item.split("*", 1)
                            out.extend([float(val)] * int(n))
                        else:
                            out.append(float(item))
                    want = vector_len[name]
                    if len(out) < want:
                        out.extend([1.0] * (want - len(out)))
                    kwargs[name] = tuple(out[:want])
                else:
                    kwargs[name] = v.strip() if isinstance(v, str) else v
        # reference converts dquer m -> um at read (readreleases.f90:330)
        if "dquer" in kwargs and kwargs["dquer"] > 0:
            kwargs["dquer"] = float(kwargs["dquer"]) * 1.0e6
        kwargs["specnum"] = specnum
        return cls(**kwargs)

    @classmethod
    def from_directory(cls, species_dir: str | Path, specnum: int) -> "Species":
        path = Path(species_dir) / f"SPECIES_{specnum:03d}"
        return cls.from_file(path, specnum=specnum)

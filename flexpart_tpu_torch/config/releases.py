"""RELEASES configuration.

Typed equivalent of the RELEASES namelist file
(options/RELEASES:11-30, parsed by
readreleases.f90): a &RELEASES_CTRL header (species list)
followed by repeated &RELEASE boxes.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from pathlib import Path

from .namelist import namelist_groups, namelist_single
from .species import Species
from ..utils.dates import parse_yyyymmdd_hhmmss


@dataclasses.dataclass(frozen=True)
class ReleaseBox:
    idate1: int
    itime1: int
    idate2: int
    itime2: int
    lon1: float
    lon2: float
    lat1: float
    lat2: float
    z1: float
    z2: float
    zkind: int = 1          # 1 m AGL, 2 m ASL, 3 pressure hPa
    mass: tuple[float, ...] = (1.0,)   # per species
    parts: int = 10000
    comment: str = "RELEASE"

    @property
    def start(self) -> datetime:
        return parse_yyyymmdd_hhmmss(self.idate1, self.itime1)

    @property
    def end(self) -> datetime:
        return parse_yyyymmdd_hhmmss(self.idate2, self.itime2)


@dataclasses.dataclass(frozen=True)
class Releases:
    species: tuple[Species, ...]
    boxes: tuple[ReleaseBox, ...]

    @property
    def nspec(self) -> int:
        return len(self.species)

    @property
    def numpoint(self) -> int:
        return len(self.boxes)

    @property
    def total_particles(self) -> int:
        return sum(b.parts for b in self.boxes)

    @classmethod
    def from_file(cls, path: str | Path,
                  species_dir: str | Path | None = None) -> "Releases":
        path = Path(path)
        text = path.read_text()
        ctrl = namelist_single(text, "releases_ctrl")
        nspec = int(ctrl.get("nspec", 1))
        specnums = ctrl.get("specnum_rel", 24)
        if not isinstance(specnums, list):
            specnums = [specnums]
        specnums = [int(s) for s in specnums][:nspec]

        if species_dir is None:
            species_dir = path.parent / "SPECIES"
        species = tuple(Species.from_directory(species_dir, n) for n in specnums)

        boxes = []
        for g in namelist_groups(text, "release"):
            mass = g.get("mass", 1.0)
            if not isinstance(mass, list):
                mass = [mass]
            boxes.append(ReleaseBox(
                idate1=int(g["idate1"]), itime1=int(g["itime1"]),
                idate2=int(g["idate2"]), itime2=int(g["itime2"]),
                lon1=float(g["lon1"]), lon2=float(g["lon2"]),
                lat1=float(g["lat1"]), lat2=float(g["lat2"]),
                z1=float(g["z1"]), z2=float(g["z2"]),
                zkind=int(g.get("zkind", 1)),
                mass=tuple(float(m) for m in mass),
                parts=int(g.get("parts", 10000)),
                comment=str(g.get("comment", "RELEASE")).strip(),
            ))
        return cls(species=species, boxes=tuple(boxes))

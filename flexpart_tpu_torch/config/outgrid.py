"""OUTGRID / OUTGRID_NEST / AGECLASSES / RECEPTORS configuration.

Formats: options/OUTGRID:15-23 (readoutgrid.f90),
options/AGECLASSES:14-17 (readageclasses.f90),
options/RECEPTORS (readreceptors.f90).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from .namelist import namelist_groups, namelist_single


@dataclasses.dataclass(frozen=True)
class OutGrid:
    outlon0: float
    outlat0: float
    numxgrid: int
    numygrid: int
    dxout: float
    dyout: float
    outheights: tuple[float, ...]

    @property
    def numzgrid(self) -> int:
        return len(self.outheights)

    @classmethod
    def from_file(cls, path: str | Path, nest: bool = False) -> "OutGrid":
        group = "outgridn" if nest else "outgrid"
        text = Path(path).read_text()
        try:
            raw = namelist_single(text, group)
        except ValueError:
            # OUTGRID_NEST files sometimes use &OUTGRID too
            raw = namelist_single(text, "outgrid")
        if nest:
            # nest keys carry an N suffix (readoutgrid_nest.f90:
            # OUTLON0N/OUTLAT0N/NUMXGRIDN/...)
            raw = {(k[:-1] if k.endswith("n") and k != "outheights"
                    else k): v for k, v in raw.items()}
        hh = raw.get("outheights", [100.0])
        if not isinstance(hh, list):
            hh = [hh]
        return cls(
            outlon0=float(raw["outlon0"]), outlat0=float(raw["outlat0"]),
            numxgrid=int(raw["numxgrid"]), numygrid=int(raw["numygrid"]),
            dxout=float(raw["dxout"]), dyout=float(raw["dyout"]),
            outheights=tuple(float(h) for h in hh),
        )


@dataclasses.dataclass(frozen=True)
class AgeClasses:
    lage: tuple[int, ...] = ()

    @property
    def nageclass(self) -> int:
        return max(1, len(self.lage))

    @property
    def max_age(self) -> int | None:
        return self.lage[-1] if self.lage else None

    @classmethod
    def from_file(cls, path: str | Path) -> "AgeClasses":
        raw = namelist_single(Path(path).read_text(), "ageclass")
        lage = raw.get("lage", [])
        if not isinstance(lage, list):
            lage = [lage]
        n = int(raw.get("nageclass", len(lage)))
        return cls(lage=tuple(int(a) for a in lage[:n]))


@dataclasses.dataclass(frozen=True)
class Receptor:
    name: str
    lon: float
    lat: float


def read_receptors(path: str | Path) -> tuple[Receptor, ...]:
    path = Path(path)
    if not path.exists():
        return ()
    out = []
    for g in namelist_groups(path.read_text(), "receptors"):
        if "receptor" not in g:
            continue
        out.append(Receptor(name=str(g["receptor"]).strip(),
                            lon=float(g["lon"]), lat=float(g["lat"])))
    return tuple(out)

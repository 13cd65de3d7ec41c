"""pathnames + AVAILABLE readers.

Formats: pathnames:1-4 (readpaths.f90) and
AVAILABLE:3-5 (readavailable.f90).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from pathlib import Path

from ..utils.dates import parse_yyyymmdd_hhmmss


@dataclasses.dataclass(frozen=True)
class Pathnames:
    options: Path
    output: Path
    metdata: Path
    available: Path
    nests: tuple[tuple[Path, Path], ...] = ()  # (metdata, available) per nest

    @classmethod
    def from_file(cls, path: str | Path) -> "Pathnames":
        lines = [ln.strip() for ln in Path(path).read_text().splitlines()
                 if ln.strip() and not ln.strip().startswith("=")]
        base = Path(path).parent
        def p(s: str) -> Path:
            q = Path(s)
            return q if q.is_absolute() else (base / q)
        nests = []
        rest = lines[4:]
        for i in range(0, len(rest) - 1, 2):
            nests.append((p(rest[i]), p(rest[i + 1])))
        return cls(options=p(lines[0]), output=p(lines[1]),
                   metdata=p(lines[2]), available=p(lines[3]),
                   nests=tuple(nests))


@dataclasses.dataclass(frozen=True)
class WindFieldEntry:
    time: datetime
    filename: str


def read_available(path: str | Path) -> tuple[WindFieldEntry, ...]:
    """Parse the AVAILABLE index: 3 header lines then
    'YYYYMMDD HHMMSS   filename ...' rows (readavailable.f90)."""
    entries = []
    lines = Path(path).read_text().splitlines()
    for ln in lines[3:]:
        parts = ln.split()
        if len(parts) < 3:
            continue
        try:
            t = parse_yyyymmdd_hhmmss(int(parts[0]), int(parts[1]))
        except ValueError:
            continue
        entries.append(WindFieldEntry(time=t, filename=parts[2]))
    entries.sort(key=lambda e: e.time)
    return tuple(entries)

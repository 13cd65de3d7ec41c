"""Date/time helpers.

Replaces the reference's julian-date arithmetic (juldate.f90,
caldate.f90) with Python datetimes; simulation-internal time is integer seconds
relative to the simulation start, exactly like ``itime`` in the reference
scheduler (timemanager.f90:152).
"""

from __future__ import annotations

from datetime import datetime, timedelta


def parse_yyyymmdd_hhmmss(yyyymmdd: int, hhmmss: int) -> datetime:
    d = int(yyyymmdd)
    t = int(hhmmss)
    return datetime(d // 10000, (d // 100) % 100, d % 100,
                    t // 10000, (t // 100) % 100, t % 100)


def format_yyyymmdd_hhmmss(dt: datetime) -> tuple[int, int]:
    return (dt.year * 10000 + dt.month * 100 + dt.day,
            dt.hour * 10000 + dt.minute * 100 + dt.second)


def datestamp(dt: datetime) -> str:
    """YYYYMMDDhhmmss stamp used in output file names."""
    return dt.strftime("%Y%m%d%H%M%S")


def add_seconds(dt: datetime, secs: float) -> datetime:
    return dt + timedelta(seconds=float(secs))


def julian(dt: datetime) -> float:
    """Days since the reference epoch used by the Fortran juldate (for header
    compatibility only)."""
    epoch = datetime(1858, 11, 17)  # modified julian date epoch
    delta = dt - epoch
    return delta.days + delta.seconds / 86400.0 + 2400000.5

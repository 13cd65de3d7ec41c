"""COMMAND configuration.

Typed equivalent of the reference COMMAND namelist (33 keys,
readcommand.f90:69-101) plus the derived quantities the
reference computes at read time (turbswitch/ifine/fine/ctlinv/method/mintime,
readcommand.f90:244-271,376-384; ideltas/sign discipline, :620-640).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from pathlib import Path

from .namelist import namelist_single
from ..utils.dates import parse_yyyymmdd_hhmmss


@dataclasses.dataclass(frozen=True)
class Command:
    # raw namelist keys (defaults from readcommand.f90:105-137)
    ldirect: int = 1
    ibdate: int = 20120101
    ibtime: int = 60000
    iedate: int = 20120101
    ietime: int = 120000
    loutstep: int = 10800
    loutaver: int = 10800
    loutsample: int = 900
    itsplit: int = 999999999
    lsynctime: int = 900
    ctl: float = -5.0
    ifine: int = 4
    iout: int = 3
    ipout: int = 0
    lsubgrid: int = 1
    lconvection: int = 1
    lagespectra: int = 0
    ipin: int = 0               # warm start off by default (options/COMMAND:25)
    ioutputforeachrelease: int = 1
    iflux: int = 0
    mdomainfill: int = 0
    ind_source: int = 1
    ind_receptor: int = 1
    mquasilag: int = 0
    nested_output: int = 0
    linit_cond: int = 0
    linversionout: int = 0
    surf_only: int = 0
    cblflag: int = 0
    lnetcdfout: int = 0         # netCDF grid output (readcommand.f90:95)
    ohfields_path: str = "../../flexin/"
    ipoutfac: int = 1

    @property
    def bdate(self) -> datetime:
        """Simulation start (itime=0); for backward runs this is IEDATE/IETIME
        mirrored, matching readcommand.f90:620-640."""
        if self.ldirect == 1:
            return parse_yyyymmdd_hhmmss(self.ibdate, self.ibtime)
        return parse_yyyymmdd_hhmmss(self.iedate, self.ietime)

    @property
    def edate(self) -> datetime:
        if self.ldirect == 1:
            return parse_yyyymmdd_hhmmss(self.iedate, self.ietime)
        return parse_yyyymmdd_hhmmss(self.ibdate, self.ibtime)

    @property
    def ideltas(self) -> int:
        """Signed modelling period [s] (readcommand.f90:626,634)."""
        span = abs((parse_yyyymmdd_hhmmss(self.iedate, self.ietime)
                    - parse_yyyymmdd_hhmmss(self.ibdate, self.ibtime)).total_seconds())
        return int(round(span)) * self.ldirect

    # --- derived Markov-chain formulation (readcommand.f90:244-271) ---
    @property
    def turbswitch(self) -> bool:
        if self.cblflag == 1:
            return True
        return self.ctl >= 0.1

    @property
    def ifine_eff(self) -> int:
        ifine = max(self.ifine, 1)
        if self.cblflag == 1:
            ctl = max(self.ctl, 5.0)
            if ifine * ctl < 50.0:
                ifine = int(50.0 / ctl) + 1
        elif not self.turbswitch:
            ifine = 1
        return ifine

    @property
    def ctl_eff(self) -> float:
        """CTL after the CBL floor (still the TL/dt ratio, not its inverse)."""
        if self.cblflag == 1:
            return max(self.ctl, 5.0)
        return self.ctl

    @property
    def fine(self) -> float:
        return 1.0 / float(self.ifine_eff)

    @property
    def method(self) -> int:
        """1 = adaptive per-particle time stepping, 0 = fixed lsynctime step
        (readcommand.f90:379-384)."""
        return 1 if self.ctl_eff > 0.0 else 0

    @property
    def mintime(self) -> int:
        return 1 if self.method == 1 else self.lsynctime

    @property
    def use_netcdf(self) -> bool:
        """netCDF grid output: the LNETCDFOUT namelist key or the iout>=8
        convention (readcommand.f90:95,388-396)."""
        return self.lnetcdfout == 1 or self.iout >= 8

    @property
    def iout_eff(self) -> int:
        return self.iout - 8 if self.iout >= 8 else self.iout

    # units switches (readcommand.f90:396-420)
    @property
    def ind_rel(self) -> int:
        return 1 if self.ind_source == 2 else 0

    @property
    def ind_samp(self) -> int:
        return -1 if self.ind_receptor == 2 else 0

    def validate(self) -> None:
        if self.ldirect not in (1, -1):
            raise ValueError("LDIRECT must be 1 or -1")
        if self.loutaver <= 0 or self.loutaver > self.loutstep:
            raise ValueError("need 0 < LOUTAVER <= LOUTSTEP")
        if self.loutsample > self.loutaver:
            raise ValueError("LOUTSAMPLE must not exceed LOUTAVER")
        if self.loutstep % self.lsynctime != 0:
            raise ValueError("LOUTSTEP must be a multiple of LSYNCTIME")
        if self.ind_source not in (1, 2) or self.ind_receptor not in (1, 2, 3, 4):
            raise ValueError("bad IND_SOURCE/IND_RECEPTOR")

    @classmethod
    def from_file(cls, path: str | Path) -> "Command":
        text = Path(path).read_text()
        raw = namelist_single(text, "command")
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        cmd = cls(**kwargs)
        cmd.validate()
        return cmd

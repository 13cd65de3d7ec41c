"""Output writers.

The reference writes sparse Fortran binary records (concoutput.f90:355-385)
and CF netCDF-4 (netcdf_output_mod.f90).  We write:
  * netCDF-4/HDF5 (io/netcdf4.py, h5py-backed) with the reference's
    variable layout and attributes (netcdf_output_mod.f90:323-575:
    time/longitude/latitude/height dims, RELCOM/RELLNG*/RELLAT*/RELZZ*/
    RELKINDZ/RELSTART/RELEND/RELPART/RELXMASS release block, LAGE, ORO,
    spec###_mr / spec###_pptv + WD_spec###/DD_spec### with per-species
    physics attributes), deflate-compressed, appended in O(1) per
    output along the unlimited time axis;
  * .npz archives with the raw accumulator arrays (exact, for validation);
  * the `dates` index file (concoutput.f90:102-125).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from pathlib import Path

import numpy as np

from ..utils.dates import datestamp


@dataclasses.dataclass
class OutputWriter:
    outdir: Path
    outlon0: float
    outlat0: float
    dxout: float
    dyout: float
    outheights: tuple
    species_names: tuple
    start: datetime
    iout: int = 1
    write_netcdf: bool = True
    write_npz: bool = True
    # optional reference-layout metadata (netcdf_output_mod.f90):
    #   {"global": {...}, "releases": {...}, "species": [{...}, ...],
    #    "lage": [...], "oro": array|None, "units": "ng m-3",
    #    "prefix": "grid_conc_", "wetdep": bool, "drydep": bool}
    nc_meta: dict | None = None

    surf_only: bool = False      # write only the lowest output layer
    #                              (concoutput_surf.f90 / SURF_ONLY=1)

    #: dry-air molar weight [g/mol] for mixing-ratio conversion
    #: (concoutput.f90:84 `weightair=28.97`)
    WEIGHTAIR = 28.97

    def __post_init__(self):
        self.outdir = Path(self.outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        # the reference APPENDS to an existing `dates` index (a warm
        # start into the same output dir keeps the previous run's
        # entries, concoutput.f90:102-125)
        self._dates_path = self.outdir / "dates"
        if not self._dates_path.exists():
            self._dates_path.write_text("")
        self._nc = None
        self._nt = 0

    def _zslice(self, arr):
        """surf_only=1 keeps only the lowest output layer of a
        (..., nz, ny, nx) field (concoutput_surf.f90)."""
        if arr is not None and self.surf_only:
            return arr[..., :1, :, :]
        return arr

    def pptv_factor(self, rho_out: np.ndarray | None, nspec: int):
        """Per-species mass-concentration -> pptv factor
        weightair/weightmolar(ks)/densityoutgrid (concoutput.f90:583,
        netcdf_output_mod.f90 mixing-ratio branch): (nspec, nz, ny, nx),
        or None when no density field / molar weights are available."""
        if rho_out is None:
            return None
        sp = self._meta("species", None)
        if not sp:
            return None
        wm = np.asarray([s.get("weightmolar", 0.0) for s in sp], np.float32)
        if not (wm > 0).any():
            return None
        wfac = np.where(wm > 0, self.WEIGHTAIR / np.maximum(wm, 1e-30), 1.0)
        rho = np.maximum(np.asarray(rho_out, np.float32), 1e-30)
        return wfac[:, None, None, None] / rho[None]

    def write(self, when: datetime, conc: np.ndarray, unc: np.ndarray,
              wet: np.ndarray | None = None, dry: np.ndarray | None = None,
              rho_out: np.ndarray | None = None):
        """conc/unc: (nspec, npoint, nage, nz, ny, nx) mean field and
        class-std; wet/dry: (nspec, npoint, nage, ny, nx); rho_out:
        (nz, ny, nx) air density at the output-layer half-heights
        (concoutput.f90:156-196) for the pptv conversion."""
        stamp = datestamp(when)
        with self._dates_path.open("a") as f:
            f.write(stamp + "\n")
        conc = self._zslice(conc)
        unc = self._zslice(unc)
        pfac = self._zslice(self.pptv_factor(rho_out, conc.shape[0]))
        if self.write_npz:
            np.savez_compressed(
                self.outdir / f"grid_conc_{stamp}.npz",
                conc=conc, unc=unc,
                wet=(wet if wet is not None else np.zeros(0)),
                dry=(dry if dry is not None else np.zeros(0)),
                outlon0=self.outlon0, outlat0=self.outlat0,
                dxout=self.dxout, dyout=self.dyout,
                outheights=np.asarray(self.outheights))
        if self.write_netcdf:
            self._append_netcdf(when, conc, wet, dry, pfac)

    # --- netCDF-4 -----------------------------------------------------
    def _meta(self, key, default=None):
        return (self.nc_meta or {}).get(key, default)

    def _create_nc(self, conc, wet, dry):
        from .netcdf4 import Nc4File
        nspec, npoint, nage, nz, ny, nx = conc.shape
        prefix = self._meta("prefix", "grid_conc_")
        path = self.outdir / f"{prefix}{datestamp(self.start)}.nc"
        gattrs = {
            "Conventions": "CF-1.6",
            "title": "FLEXPART model output",
            "source": "flexpart_tpu model output",
            "references": ("Stohl et al., Atmos. Chem. Phys., 2005, "
                           "doi:10.5194/acp-5-2461-200"),
            "outlon0": float(self.outlon0), "outlat0": float(self.outlat0),
            "dxout": float(self.dxout), "dyout": float(self.dyout),
        }
        gattrs.update(self._meta("global", {}))
        nc = Nc4File(path, gattrs)
        nc.def_dim("time", None)
        nc.def_dim("longitude", nx)
        nc.def_dim("latitude", ny)
        nc.def_dim("height", nz)
        nc.def_dim("numspec", nspec)
        nc.def_dim("pointspec", npoint)
        nc.def_dim("nageclass", nage)
        nc.def_dim("nchar", 45)
        rel = self._meta("releases")
        numpoint = len(rel["names"]) if rel else npoint
        nc.def_dim("numpoint", numpoint)

        nc.def_var("time", "i4", ("time",), {
            "units": f"seconds since {self.start:%Y-%m-%d %H:%M}",
            "calendar": "proleptic_gregorian"})
        nc.def_var("longitude", "f4", ("longitude",), {
            "long_name": "longitude in degree east", "axis": "Lon",
            "units": "degrees_east", "standard_name": "grid_longitude",
            "description": "grid cell centers"},
            data=(self.outlon0 + (np.arange(nx) + 0.5) * self.dxout
                  ).astype(np.float32))
        nc.def_var("latitude", "f4", ("latitude",), {
            "long_name": "latitude in degree north", "axis": "Lat",
            "units": "degrees_north", "standard_name": "grid_latitude",
            "description": "grid cell centers"},
            data=(self.outlat0 + (np.arange(ny) + 0.5) * self.dyout
                  ).astype(np.float32))
        nc.def_var("height", "f4", ("height",), {
            "units": "meters", "positive": "up",
            "standard_name": "height",
            "long_name": "height above ground"},
            data=np.asarray(self.outheights[:nz], np.float32))

        if rel:
            names = np.zeros((numpoint, 45), "S1")
            for i, s in enumerate(rel["names"]):
                b = str(s)[:45].encode()
                names[i, :len(b)] = np.frombuffer(b, "S1")
            nc.def_var("RELCOM", "S1", ("numpoint", "nchar"),
                       {"long_name": "release point name"}, data=names)
            for nm, unit, lname in (
                    ("RELLNG1", "degrees_east",
                     "release longitude lower left corner"),
                    ("RELLNG2", "degrees_east",
                     "release longitude upper right corner"),
                    ("RELLAT1", "degrees_north",
                     "release latitude lower left corner"),
                    ("RELLAT2", "degrees_north",
                     "release latitude upper right corner"),
                    ("RELZZ1", "meters", "release height bottom"),
                    ("RELZZ2", "meters", "release height top")):
                nc.def_var(nm, "f4", ("numpoint",),
                           {"units": unit, "long_name": lname},
                           data=np.asarray(rel[nm], np.float32))
            nc.def_var("RELKINDZ", "i4", ("numpoint",),
                       {"long_name": "release kind"},
                       data=np.asarray(rel["RELKINDZ"], np.int32))
            nc.def_var("RELSTART", "i4", ("numpoint",),
                       {"units": "seconds", "long_name":
                        "release start relative to simulation start"},
                       data=np.asarray(rel["RELSTART"], np.int32))
            nc.def_var("RELEND", "i4", ("numpoint",),
                       {"units": "seconds", "long_name":
                        "release end relative to simulation start"},
                       data=np.asarray(rel["RELEND"], np.int32))
            nc.def_var("RELPART", "i4", ("numpoint",),
                       {"long_name": "number of release particles"},
                       data=np.asarray(rel["RELPART"], np.int32))
            nc.def_var("RELXMASS", "f4", ("numspec", "numpoint"),
                       {"long_name": "total release particle mass"},
                       data=np.asarray(rel["RELXMASS"], np.float32
                                       ).reshape(nspec, numpoint))

        lage = self._meta("lage", [999999999] * nage)
        nc.def_var("LAGE", "i4", ("nageclass",),
                   {"units": "seconds", "long_name": "age class"},
                   data=np.asarray(lage, np.int32))
        oro = self._meta("oro")
        if oro is not None:
            nc.def_var("ORO", "i4", ("latitude", "longitude"), {
                "standard_name": "surface altitude",
                "long_name": "outgrid surface altitude", "units": "m"},
                chunks=(ny, nx), deflate=4,
                data=np.asarray(oro, np.int32))

        units = self._meta("units", "ng m-3")
        spattrs = self._meta("species", [{}] * nspec)
        dims6 = ("nageclass", "pointspec", "time", "height", "latitude",
                 "longitude")
        dims5 = ("nageclass", "pointspec", "time", "latitude", "longitude")
        for ks, name in enumerate(self.species_names):
            at = {"units": units, "long_name": name}
            at.update({k: v for k, v in spattrs[ks].items()
                       if k in ("decay", "weightmolar", "ohcconst",
                                "ohdconst", "vsetaver")})
            if self.iout in (1, 3, 5):
                nc.def_var(f"spec{ks+1:03d}_mr", "f4", dims6, at,
                           chunks=(1, 1, 1, nz, ny, nx), deflate=4)
            if self.iout in (2, 3):
                atp = dict(at)
                atp["units"] = "pptv"
                nc.def_var(f"spec{ks+1:03d}_pptv", "f4", dims6, atp,
                           chunks=(1, 1, 1, nz, ny, nx), deflate=4)
            if wet is not None:
                wa = {"units": "1e-12 kg m-2"}
                wa.update({k: v for k, v in spattrs[ks].items()
                           if k in ("weta_gas", "wetb_gas", "ccn_aero",
                                    "in_aero", "dquer", "henry")})
                nc.def_var(f"WD_spec{ks+1:03d}", "f4", dims5, wa,
                           chunks=(1, 1, 1, ny, nx), deflate=4)
            if dry is not None:
                da = {"units": "1e-12 kg m-2"}
                da.update({k: v for k, v in spattrs[ks].items()
                           if k in ("dryvel", "reldiff", "henry", "f0",
                                    "dquer", "density", "dsigma")})
                nc.def_var(f"DD_spec{ks+1:03d}", "f4", dims5, da,
                           chunks=(1, 1, 1, ny, nx), deflate=4)
        return nc

    def _append_netcdf(self, when, conc, wet, dry, pfac=None):
        if self._nc is None:
            self._nc = self._create_nc(conc, wet, dry)
        nc = self._nc
        it = self._nt
        self._nt += 1
        nc.append("time", np.int32((when - self.start).total_seconds()),
                  axis=0, index=it)
        # conc: (nspec, npoint, nage, nz, ny, nx)
        #   -> var (nage, npoint, time, nz, ny, nx), one slab at time=it
        for ks in range(conc.shape[0]):
            slab = conc[ks].transpose(1, 0, 2, 3, 4).astype(np.float32)
            if self.iout in (1, 3, 5):
                nc.append(f"spec{ks+1:03d}_mr", slab, axis=2, index=it)
            if self.iout in (2, 3):
                # volume mixing ratio: multiply the mass concentration
                # by weightair/weightmolar(ks)/densityoutgrid
                # (netcdf_output_mod.f90 mixing-ratio branch,
                # concoutput.f90:583)
                pslab = slab * pfac[ks][None, None] \
                    if pfac is not None else slab
                nc.append(f"spec{ks+1:03d}_pptv", pslab, axis=2, index=it)
            if wet is not None:
                nc.append(f"WD_spec{ks+1:03d}",
                          wet[ks].transpose(1, 0, 2, 3).astype(np.float32),
                          axis=2, index=it)
            if dry is not None:
                nc.append(f"DD_spec{ks+1:03d}",
                          dry[ks].transpose(1, 0, 2, 3).astype(np.float32),
                          axis=2, index=it)
        nc.sync()

    def close(self):
        if self._nc is not None:
            self._nc.close()
            self._nc = None

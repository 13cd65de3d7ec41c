"""netCDF-4 (HDF5) writer with O(1) incremental appends.

The reference writes CF netCDF-4 via libnetcdf (netcdf_output_mod.f90).
libnetcdf is not available in this image, but netCDF-4 files ARE HDF5
files following a documented convention (dimension scales + reserved
attributes), so this module writes them directly with h5py:

  * every dimension is an HDF5 Dimension Scale; dimensions that have a
    coordinate variable use that dataset as the scale (NAME = the dim
    name), dimensions without one get a stub dataset whose NAME is the
    reserved "This is a netCDF dimension but not a netCDF variable."
    string — exactly what libnetcdf emits (netcdf-c nc4hdf.c);
  * every data variable attaches the scales of its axes (this writes
    the DIMENSION_LIST/REFERENCE_LIST attribute pairs);
  * `_Netcdf4Dimid` (creation-order dim id) is stored on each scale and
    `_Netcdf4Coordinates` (the per-axis dim ids) on each multi-dim
    variable, matching libnetcdf;
  * the root carries `_NCProperties`.

The unlimited `time` axis is a resizable (chunked) HDF5 dataset, so
each output step appends one hyperslab in O(slab) — unlike a
netCDF3-classic rewrite which is O(history).  Variables are deflate
(gzip) compressed with the reference's per-write chunk shape
(netcdf_output_mod.f90:478-481: one (nx,ny,nz) block per
time/pointspec/age).
"""

from __future__ import annotations

import numpy as np

_DIM_WO_VAR = "This is a netCDF dimension but not a netCDF variable."


class Nc4File:
    """Minimal netCDF-4 writer (define-then-append usage)."""

    def __init__(self, path, global_attrs: dict | None = None):
        import h5py
        self._h5py = h5py
        self.f = h5py.File(path, "w", libver="earliest")
        self.f.attrs.create(
            "_NCProperties",
            np.bytes_("version=2,netcdf=4.9.2,hdf5=1.14.3"))
        self._dims: dict[str, tuple[int | None, object]] = {}
        self._dimid: dict[str, int] = {}
        if global_attrs:
            self.set_attrs(self.f, global_attrs)

    # -- attributes ----------------------------------------------------
    @staticmethod
    def set_attrs(obj, attrs: dict):
        for k, v in attrs.items():
            if isinstance(v, str):
                obj.attrs[k] = v
            elif isinstance(v, float):
                obj.attrs.create(k, np.float32(v))
            elif isinstance(v, int):
                obj.attrs.create(k, np.int32(v))
            else:
                obj.attrs[k] = v

    # -- dimensions ----------------------------------------------------
    def def_dim(self, name: str, size: int | None):
        """size=None -> unlimited.  A stub scale dataset is created; if a
        same-named coordinate variable is defined later it replaces it."""
        self._dimid[name] = len(self._dimid)
        self._dims[name] = (size, None)

    def _ensure_scale(self, name: str):
        size, ds = self._dims[name]
        if ds is not None:
            return ds
        n = 0 if size is None else size
        ds = self.f.create_dataset(
            name, shape=(n,), maxshape=(None,) if size is None else (n,),
            dtype="f4", chunks=(max(n, 1024) if size is None else None))
        ds.make_scale(_DIM_WO_VAR)
        ds.attrs.create("_Netcdf4Dimid", np.int32(self._dimid[name]))
        self._dims[name] = (size, ds)
        return ds

    # -- variables -----------------------------------------------------
    def def_var(self, name: str, dtype, dims: tuple, attrs: dict | None
                = None, chunks: tuple | None = None, deflate: int = 0,
                data=None):
        shape = []
        maxshape = []
        unlimited = False
        for d in dims:
            size = self._dims[d][0]
            shape.append(0 if size is None else size)
            maxshape.append(None if size is None else size)
            unlimited = unlimited or size is None
        coord = len(dims) == 1 and dims[0] == name
        kw = {}
        if deflate > 0:
            kw = dict(compression="gzip", compression_opts=deflate,
                      shuffle=False)
        if chunks is not None or unlimited or deflate > 0:
            kw["chunks"] = chunks or tuple(max(s, 1) for s in shape)
        ds = self.f.create_dataset(name, shape=tuple(shape),
                                   maxshape=tuple(maxshape), dtype=dtype,
                                   **kw)
        if coord:
            ds.make_scale(name)
            ds.attrs.create("_Netcdf4Dimid",
                            np.int32(self._dimid[name]))
            self._dims[name] = (self._dims[name][0], ds)
        else:
            for i, d in enumerate(dims):
                ds.dims[i].attach_scale(self._ensure_scale(d))
            if len(dims) > 1:
                ds.attrs.create(
                    "_Netcdf4Coordinates",
                    np.asarray([self._dimid[d] for d in dims], np.int32))
        if attrs:
            self.set_attrs(ds, attrs)
        if data is not None:
            if unlimited:
                ds.resize(len(data), axis=0)
            ds[...] = data
        return ds

    def append(self, name: str, data, axis: int, index: int):
        """Write one hyperslab at `index` along the unlimited axis,
        growing the variable if needed."""
        ds = self.f[name]
        if ds.shape[axis] <= index:
            ds.resize(index + 1, axis=axis)
        sel = [slice(None)] * ds.ndim
        sel[axis] = index
        ds[tuple(sel)] = data

    def sync(self):
        self.f.flush()

    def close(self):
        self.f.close()


def open_nc4(path):
    """Read helper for tests: returns the h5py File (netCDF-4 files are
    HDF5 files; variables/dims are datasets)."""
    import h5py
    return h5py.File(path, "r")

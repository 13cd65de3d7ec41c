"""Reference-compatible Fortran unformatted output files (copy of
``flexpart_tpu/io/fortran_writer.py``: numpy and ``struct`` only).

Byte-exact layouts of the reference's post-processing formats so existing
FLEXPART toolchains can consume this framework's output directly:

  * ``header`` — run metadata + release points + topography
    (writeheader.f90:50-137: sequential unformatted records with 4-byte
    length markers, little-endian);
  * ``grid_conc_YYYYMMDDhhmmss_nnn`` / ``grid_time_*`` / ``grid_pptv_*`` —
    the run-length sparse dump (concoutput.f90:346-470): per species file,
    one itime record, then per (pointspec, ageclass) a wet-deposition,
    dry-deposition and 3-D concentration sparse block.  Each block is four
    records: count_i, start-indices of contiguous non-zero runs, count_r,
    and the non-zero values with the sign alternating per run (+ for the
    1st run, - for the 2nd, ...; sp_fact logic at concoutput.f90:355-447).

Readers for both formats are included (used by the tests, and the analog
of what flexpart's `readheader`-style post-processing tools do).

The header's first record carries a version string of 256 characters
(writeheader.f90:50-137).  ``write_header`` takes it as ``flexversion``; the
port's ``Simulation`` writes ``FLEXVERSION`` ("flexpart_tpu_torch 1.0"),
where the JAX package writes "flexpart_tpu 1.0".  Every other byte of the
files is the JAX package's on the same arrays.

The gross-flux file (``write_flux``, fluxoutput.f90) and the receptor
files (``write_receptor_header`` / ``append_receptor``, openreceptors.f90 +
concoutput.f90) follow, with their readers.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_SMALLNUM = np.finfo(np.float32).tiny  # concoutput.f90:83

FLEXVERSION = "flexpart_tpu_torch 1.0"   # the port's header version


def _rec(payload: bytes) -> bytes:
    """One Fortran sequential unformatted record (gfortran little-endian)."""
    return struct.pack("<i", len(payload)) + payload + \
        struct.pack("<i", len(payload))


def _chars(s: str, width: int) -> bytes:
    return s[:width].ljust(width).encode("latin-1")


def sparse_encode(flat: np.ndarray, index_offset: int = 0):
    """Run-length sparse encoding of concoutput.f90:427-470.

    Returns (start_indices int32, signed_values float32): the flat index of
    the first cell of each contiguous non-zero run, and every non-zero
    value with the run's alternating sign applied."""
    flat = np.asarray(flat, np.float32).ravel()
    nz = flat > _SMALLNUM
    if not nz.any():
        return (np.zeros(0, np.int32), np.zeros(0, np.float32))
    starts = nz & ~np.concatenate(([False], nz[:-1]))
    run_id = np.cumsum(starts)            # 1-based run number per cell
    idx = np.nonzero(starts)[0].astype(np.int32) + np.int32(index_offset)
    vals = flat[nz] * np.where(run_id[nz] % 2 == 1, 1.0,
                               -1.0).astype(np.float32)
    return idx, vals


def sparse_decode(starts: np.ndarray, vals: np.ndarray, size: int,
                  index_offset: int = 0) -> np.ndarray:
    """Inverse of sparse_encode back to a dense flat float32 array."""
    out = np.zeros(size, np.float32)
    runs = np.abs(np.diff(np.signbit(vals).astype(np.int8), prepend=127))
    run_of_val = np.cumsum(runs != 0) - 1          # 0-based run per value
    # position of each value: run start + offset within run
    pos_in_run = np.arange(len(vals)) - np.concatenate(
        ([0], np.nonzero(np.diff(run_of_val))[0] + 1)
    )[run_of_val]
    out_idx = starts[run_of_val] - index_offset + pos_in_run
    out[out_idx] = np.abs(vals)
    return out


def _sparse_block(flat: np.ndarray, index_offset: int = 0) -> bytes:
    idx, vals = sparse_encode(flat, index_offset)
    return (_rec(struct.pack("<i", len(idx))) + _rec(idx.tobytes()) +
            _rec(struct.pack("<i", len(vals))) + _rec(vals.tobytes()))


def write_header(path, *, ibdate: int, ibtime: int,
                 loutstep: int, loutaver: int, loutsample: int,
                 outlon0: float, outlat0: float,
                 numxgrid: int, numygrid: int,
                 dxout: float, dyout: float,
                 outheights, jjjjmmdd: int, ihmmss: int,
                 species_names, maxpointspec_act: int,
                 releases,    # sequence of dicts (see below)
                 method: int = 0, lsubgrid: int = 1, lconvection: int = 1,
                 ind_source: int = 1, ind_receptor: int = 1,
                 nageclass: int = 1, lage=(999999999,),
                 oroout: np.ndarray | None = None,
                 flexversion: str = FLEXVERSION):
    """writeheader.f90:50-137.  ``releases`` items need keys: start, end,
    kindz, xp1, yp1, xp2, yp2, zp1, zp2, npart, comment, xmass (per spec)."""
    out = bytearray()
    out += _rec(struct.pack("<ii", ibdate, ibtime) +
                _chars(flexversion, 256))
    out += _rec(struct.pack("<iii", loutstep, loutaver, loutsample))
    out += _rec(struct.pack("<ffiiff", outlon0, outlat0, numxgrid,
                            numygrid, dxout, dyout))
    oh = np.asarray(outheights, np.float32)
    out += _rec(struct.pack("<i", len(oh)) + oh.tobytes())
    out += _rec(struct.pack("<ii", jjjjmmdd, ihmmss))
    out += _rec(struct.pack("<ii", 3 * len(species_names),
                            maxpointspec_act))
    numzgrid = len(oh)
    for name in species_names:
        out += _rec(struct.pack("<i", 1) + _chars("WD_" + name[:7], 10))
        out += _rec(struct.pack("<i", 1) + _chars("DD_" + name[:7], 10))
        out += _rec(struct.pack("<i", numzgrid) + _chars(name, 10))
    out += _rec(struct.pack("<i", len(releases)))
    for r in releases:
        out += _rec(struct.pack("<iii", r["start"], r["end"], r["kindz"]))
        out += _rec(struct.pack("<ffffff", r["xp1"], r["yp1"], r["xp2"],
                                r["yp2"], r["zp1"], r["zp2"]))
        out += _rec(struct.pack("<ii", r["npart"], 1))
        out += _rec(_chars(r.get("comment", "RELEASE"), 45))
        for xm in r["xmass"]:
            out += _rec(struct.pack("<f", xm))
            out += _rec(struct.pack("<f", xm))
            out += _rec(struct.pack("<f", xm))
    out += _rec(struct.pack("<iiiii", method, lsubgrid, lconvection,
                            ind_source, ind_receptor))
    la = np.asarray(lage, np.int32)
    out += _rec(struct.pack("<i", nageclass) + la.tobytes())
    if oroout is None:
        oroout = np.zeros((numygrid, numxgrid), np.float32)
    for ix in range(numxgrid):       # per-column records (writeheader:130)
        out += _rec(np.asarray(oroout[:, ix], np.float32).tobytes())
    Path(path).write_bytes(bytes(out))


def write_grid_sparse(path, itime: int, conc: np.ndarray,
                      wet: np.ndarray | None, dry: np.ndarray | None):
    """One grid_conc_* (or grid_time_* / grid_pptv_*) file for ONE species.

    conc: (npoint, nage, nz, ny, nx) already in output units
    wet/dry: (npoint, nage, ny, nx) in 1e-12 kg/m2, or None.
    Record stream: itime, then per (kp, nage): wet, dry, conc sparse
    blocks (concoutput.f90:275-470)."""
    npoint, nage_n, nz, ny, nx = conc.shape
    out = bytearray(_rec(struct.pack("<i", itime)))
    zeroes2 = np.zeros(ny * nx, np.float32)
    for kp in range(npoint):
        for na in range(nage_n):
            w = wet[kp, na].ravel() if wet is not None else zeroes2
            out += _sparse_block(w)
            d = dry[kp, na].ravel() if dry is not None else zeroes2
            out += _sparse_block(d)
            # 3-D index is ix + jy*nx + kz*nx*ny with kz starting at 1
            # (concoutput.f90:439-441)
            out += _sparse_block(conc[kp, na].ravel(),
                                 index_offset=nx * ny)
    Path(path).write_bytes(bytes(out))


# ---------------------------------------------------------------- readers
class _RecReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def rec(self) -> bytes:
        n, = struct.unpack_from("<i", self.data, self.pos)
        payload = self.data[self.pos + 4:self.pos + 4 + n]
        self.pos += 8 + n
        return payload

    @property
    def eof(self):
        return self.pos >= len(self.data)


def read_header(path) -> dict:
    r = _RecReader(Path(path).read_bytes())
    h = {}
    b = r.rec()
    h["ibdate"], h["ibtime"] = struct.unpack_from("<ii", b)
    h["flexversion"] = b[8:].decode("latin-1").rstrip()
    h["loutstep"], h["loutaver"], h["loutsample"] = struct.unpack(
        "<iii", r.rec())
    (h["outlon0"], h["outlat0"], h["numxgrid"], h["numygrid"],
     h["dxout"], h["dyout"]) = struct.unpack("<ffiiff", r.rec())
    b = r.rec()
    nz, = struct.unpack_from("<i", b)
    h["outheights"] = np.frombuffer(b[4:], np.float32, nz)
    h["jjjjmmdd"], h["ihmmss"] = struct.unpack("<ii", r.rec())
    n3, h["maxpointspec_act"] = struct.unpack("<ii", r.rec())
    nspec = n3 // 3
    names = []
    for _ in range(nspec):
        r.rec()
        r.rec()
        b = r.rec()
        names.append(b[4:].decode("latin-1").rstrip())
    h["species"] = names
    numpoint, = struct.unpack("<i", r.rec())
    rel = []
    for _ in range(numpoint):
        start, end, kindz = struct.unpack("<iii", r.rec())
        xp1, yp1, xp2, yp2, zp1, zp2 = struct.unpack("<ffffff", r.rec())
        npart, _one = struct.unpack("<ii", r.rec())
        comment = r.rec().decode("latin-1").rstrip()
        xmass = [struct.unpack("<f", [r.rec(), r.rec(), r.rec()][0])[0]
                 for _ in range(nspec)]
        rel.append(dict(start=start, end=end, kindz=kindz, xp1=xp1,
                        yp1=yp1, xp2=xp2, yp2=yp2, zp1=zp1, zp2=zp2,
                        npart=npart, comment=comment, xmass=xmass))
    h["releases"] = rel
    (h["method"], h["lsubgrid"], h["lconvection"], h["ind_source"],
     h["ind_receptor"]) = struct.unpack("<iiiii", r.rec())
    b = r.rec()
    nage, = struct.unpack_from("<i", b)
    h["nageclass"] = nage
    h["lage"] = np.frombuffer(b[4:], np.int32, nage)
    oro = np.zeros((h["numygrid"], h["numxgrid"]), np.float32)
    for ix in range(h["numxgrid"]):
        oro[:, ix] = np.frombuffer(r.rec(), np.float32)
    h["oroout"] = oro
    return h


def read_grid_sparse(path, numxgrid: int, numygrid: int, numzgrid: int,
                     npoint: int = 1, nage: int = 1):
    """Decode one grid_conc_* file -> (itime, conc, wet, dry)."""
    r = _RecReader(Path(path).read_bytes())
    itime, = struct.unpack("<i", r.rec())
    conc = np.zeros((npoint, nage, numzgrid, numygrid, numxgrid),
                    np.float32)
    wet = np.zeros((npoint, nage, numygrid, numxgrid), np.float32)
    dry = np.zeros_like(wet)

    def block(size, offset=0):
        ni, = struct.unpack("<i", r.rec())
        idx = np.frombuffer(r.rec(), np.int32, ni)
        nr, = struct.unpack("<i", r.rec())
        vals = np.frombuffer(r.rec(), np.float32, nr)
        return sparse_decode(idx, vals, size, index_offset=offset)

    n2 = numygrid * numxgrid
    for kp in range(npoint):
        for na in range(nage):
            wet[kp, na] = block(n2).reshape(numygrid, numxgrid)
            dry[kp, na] = block(n2).reshape(numygrid, numxgrid)
            conc[kp, na] = block(n2 * numzgrid, offset=n2).reshape(
                numzgrid, numygrid, numxgrid)
    return itime, conc, wet, dry


# ---------------------------------------------------------------------------
# gross-flux output (fluxoutput.f90:52-268)
# ---------------------------------------------------------------------------

def write_flux(path, itime: int, flux: np.ndarray, areaeast: np.ndarray,
               areanorth: np.ndarray, area: np.ndarray, outstep: float):
    """grid_flux_YYYYMMDDhhmmss in the reference's unformatted layout.

    flux: (6, nage, kp, kz, jy, ix, ks) with faces (0=E,1=W,2=N,3=S,
    4=up,5=down) [kg]; divided here by face area and averaging interval
    to ng/m2/s.  Per (spec, pointspec, age) the six faces are written in
    the reference order E,W,S,N,U,D, each either sparse (one record per
    non-zero cell: linear index ix+jy*nxg+kz*nxg*nyg with 1-BASED kz,
    then a (-999, 999.) terminator) or dense (one record of numygrid
    values per (kz, ix)), chosen by the reference's 2/5-occupancy rule
    (fluxoutput.f90:98-133)."""
    _, nage, npnt, nzg, nyg, nxg, nspec = flux.shape
    ncell = nxg * nyg * nzg
    # face order E,W,S,N,U,D with per-face area divisor
    faces = ((0, areaeast), (1, areaeast), (3, areanorth),
             (2, areanorth), (4, area[None]), (5, area[None]))
    out = [_rec(struct.pack("<i", itime))]
    for ks in range(nspec):
        for kp in range(npnt):
            for na in range(nage):
                for f, fa in faces:
                    g = np.asarray(flux[f, na, kp, :, :, :, ks],
                                   np.float64)
                    val = (1.0e12 * g / np.broadcast_to(fa, g.shape)
                           / outstep).astype(np.float32)
                    nnz = int((g > 0.0).sum())
                    if 4 * nnz < ncell:
                        out.append(_rec(struct.pack("<i", 1)))
                        kzs, jys, ixs = np.nonzero(g > 0.0)
                        # Fortran loop order kz,jy,ix is exactly
                        # C-order of (kz,jy,ix) -> already sorted
                        lin = (ixs + jys * nxg
                               + (kzs + 1) * nxg * nyg).astype(np.int32)
                        v = val[kzs, jys, ixs]
                        for i in range(len(lin)):
                            out.append(_rec(struct.pack("<if", lin[i],
                                                        v[i])))
                        out.append(_rec(struct.pack("<if", -999, 999.0)))
                    else:
                        out.append(_rec(struct.pack("<i", 2)))
                        for kz in range(nzg):
                            for ix in range(nxg):
                                out.append(_rec(
                                    val[kz, :, ix].tobytes()))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def read_flux(path, shape):
    """Inverse of write_flux for tests: returns (itime, ng/m2/s array of
    `shape` = (6, nage, kp, kz, jy, ix, ks))."""
    buf = open(path, "rb").read()
    pos = 0

    def rec():
        nonlocal pos
        (n,) = struct.unpack_from("<i", buf, pos)
        payload = buf[pos + 4:pos + 4 + n]
        pos += 8 + n
        return payload

    (itime,) = struct.unpack("<i", rec())
    _, nage, npnt, nzg, nyg, nxg, nspec = shape
    out = np.zeros(shape, np.float32)
    order = (0, 1, 3, 2, 4, 5)
    for ks in range(nspec):
        for kp in range(npnt):
            for na in range(nage):
                for f in order:
                    (mode,) = struct.unpack("<i", rec())
                    if mode == 1:
                        while True:
                            lin, v = struct.unpack("<if", rec())
                            if lin == -999:
                                break
                            kz = lin // (nxg * nyg) - 1
                            jy = (lin // nxg) % nyg
                            ix = lin % nxg
                            out[f, na, kp, kz, jy, ix, ks] = v
                    else:
                        for kz in range(nzg):
                            for ix in range(nxg):
                                out[f, na, kp, kz, :, ix, ks] = \
                                    np.frombuffer(rec(), np.float32)
    return itime, out


# ---------------------------------------------------------------------------
# receptor output (openreceptors.f90 + concoutput.f90:660-676)
# ---------------------------------------------------------------------------

def write_receptor_header(path, names, lons, lats):
    """receptor_conc/receptor_pptv header: one record of 16-char names,
    one record of interleaved (lon, lat) pairs."""
    nb = b"".join(_chars(str(n), 16) for n in names)
    coords = np.empty(2 * len(names), np.float32)
    coords[0::2] = np.asarray(lons, np.float32)
    coords[1::2] = np.asarray(lats, np.float32)
    with open(path, "wb") as fh:
        fh.write(_rec(nb))
        fh.write(_rec(coords.tobytes()))


def append_receptor(path, itime: int, conc: np.ndarray):
    """Append one output time: record(itime), then one record of
    numreceptor values per species.  conc: (numreceptor, nspec)."""
    with open(path, "ab") as fh:
        fh.write(_rec(struct.pack("<i", itime)))
        for ks in range(conc.shape[1]):
            fh.write(_rec(np.asarray(conc[:, ks],
                                     np.float32).tobytes()))


def read_receptor(path, nspec: int):
    """Inverse of the receptor writers for tests: returns
    (names, lons, lats, [(itime, (nrec, nspec) array), ...])."""
    buf = open(path, "rb").read()
    pos = 0

    def rec():
        nonlocal pos
        (n,) = struct.unpack_from("<i", buf, pos)
        payload = buf[pos + 4:pos + 4 + n]
        pos += 8 + n
        return payload

    nb = rec()
    names = [nb[i:i + 16].decode().strip()
             for i in range(0, len(nb), 16)]
    coords = np.frombuffer(rec(), np.float32)
    lons, lats = coords[0::2], coords[1::2]
    steps = []
    while pos < len(buf):
        (itime,) = struct.unpack("<i", rec())
        cols = [np.frombuffer(rec(), np.float32) for _ in range(nspec)]
        steps.append((itime, np.stack(cols, 1)))
    return names, lons, lats, steps

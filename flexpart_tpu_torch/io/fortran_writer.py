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

Not here yet: the gross-flux file (``write_flux``) and the receptor files,
which come with the port's fluxes and receptors.
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

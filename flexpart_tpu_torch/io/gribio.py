"""ctypes binding for the native GRIB decoder (copy of
``flexpart_tpu/io/gribio.py``).

High-level API: iterate a GRIB file's messages with metadata, decode
fields into numpy arrays — the replacement for the reference's eccodes
dependency (readwind_ecmwf.f90:50).  The decode stays on the host.

The port builds its own decoder library from the repo's source,
``native/gribdec/gribdec.cpp``, at first use, into ``build/gribdec/``
beside the package, under a name that carries the hash of the source
and of the flags; it never loads a prebuilt binary.  The flags are
``native/gribdec/Makefile``'s: ``g++ -O2 -fPIC -std=c++17 -shared``, and
``-DHAVE_LIBAEC`` with the libaec it finds (CCSDS-packed GRIB2).  The
build is guarded by a lock: the met reader thread and the main thread
can both ask for the library first.  ``ctypes`` releases the GIL during
each call, so a decode in the reader thread overlaps the step loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "gribdec" / "gribdec.cpp"
BUILD_DIR = ROOT / "build" / "gribdec"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
# where the Makefile looks for libaec
AEC_GLOBS = ("/usr/lib/x86_64-linux-gnu/libaec.so*", "/usr/lib/libaec.so*")

_LOCK = threading.Lock()
_LIB = []


def _aec() -> str | None:
    for pattern in AEC_GLOBS:
        found = sorted(glob.glob(pattern))
        if found:
            return found[0]
    return None


def build_command(out: Path) -> list[str]:
    """The g++ command that builds the decoder library into ``out``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the GRIB decoder "
                           f"({SOURCE}) cannot be built")
    aec = _aec()
    extra = ["-DHAVE_LIBAEC"] if aec else []
    return [cxx, *CXX_FLAGS, *extra, "-o", str(out), str(SOURCE),
            *([aec] if aec else [])]


def library_path() -> Path:
    """The decoder library of this source and these flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(str(_aec()).encode())
    return BUILD_DIR / f"libgribdec-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the GRIB decoder failed:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)


def _lib():
    """The decoder library, built and loaded at the first call."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.gribdec_scan.restype = ctypes.c_long
        lib.gribdec_scan.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.c_long]
        lib.gribdec_info.restype = ctypes.c_long
        lib.gribdec_info.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.POINTER(ctypes.c_double),
                                     ctypes.POINTER(ctypes.c_double),
                                     ctypes.c_long]
        lib.gribdec_decode.restype = ctypes.c_long
        lib.gribdec_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                       ctypes.c_long,
                                       ctypes.POINTER(ctypes.c_double),
                                       ctypes.c_long]
        _LIB.append(lib)
        return lib


@dataclasses.dataclass
class GribMessage:
    path: str
    offset: int
    length: int
    edition: int
    param: int            # GRIB1: indicatorOfParameter;
                          # GRIB2: discipline*1000000+category*1000+number
    level_type: int
    level: int
    nx: int
    ny: int
    lat1: float
    lon1: float
    lat2: float
    lon2: float
    dlat: float
    dlon: float
    pv: np.ndarray        # hybrid coefficients (may be empty)
    date: int
    time: int
    step: int

    def values(self) -> np.ndarray:
        """Decode the field, (ny, nx), north-south order as stored."""
        lib = _lib()
        n = self.nx * self.ny
        out = np.empty(n, np.float64)
        rc = lib.gribdec_decode(
            self.path.encode(), self.offset, self.length,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        if rc < 0:
            raise ValueError(f"gribdec_decode failed ({rc}) for "
                             f"param {self.param} in {self.path}")
        return out.reshape(self.ny, self.nx)


def scan(path, max_messages: int = 8192) -> list[GribMessage]:
    """All messages of a GRIB file with metadata (no data decode)."""
    lib = _lib()
    offs = np.empty(max_messages, np.int64)
    lens = np.empty(max_messages, np.int64)
    n = lib.gribdec_scan(
        str(path).encode(),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        max_messages)
    msgs = []
    ivals = (ctypes.c_longlong * 10)()
    dvals = (ctypes.c_double * 6)()
    pvbuf = np.empty(1024, np.float64)
    for i in range(n):
        npv = lib.gribdec_info(
            str(path).encode(), int(offs[i]), int(lens[i]), ivals, dvals,
            pvbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 1024)
        if npv < 0:
            continue
        msgs.append(GribMessage(
            path=str(path), offset=int(offs[i]), length=int(lens[i]),
            edition=ivals[0], param=ivals[1], level_type=ivals[2],
            level=ivals[3], nx=ivals[4], ny=ivals[5],
            lat1=dvals[0], lon1=dvals[1], lat2=dvals[2], lon2=dvals[3],
            dlat=dvals[4], dlon=dvals[5],
            pv=pvbuf[:npv].copy(), date=ivals[7], time=ivals[8],
            step=ivals[9]))
    return msgs

"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``.  Nothing is
built when this module is imported: a kernel is built at its first launch
(or by ``build_all``, which starts one ``nvcc`` per source at once), into
``build/kernels/`` beside the package, under a name that carries the hash
of its source, of every ``csrc/`` header it includes and of the flags, so a
changed source or header is rebuilt.

Flags: ``-fmad=false`` keeps every ``a*b+c`` as two roundings, as the
plain PyTorch twins and XLA compute it (the double-single ``ds_add`` and
the bitwise table contract depend on it); ``--use_fast_math`` is never
used, so ``logf``/``cosf``/``sqrtf`` are the accurate versions.

Each ``Kernel`` counts its launches in ``launches`` (a plain integer), so
a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
U32 = ctypes.c_uint32
F = ctypes.c_float


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class Kernel:
    """One CUDA source, its exported C function and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def sources(self) -> list[Path]:
        """The ``.cu`` file and, after it, every ``csrc/`` header it
        includes with quotes (transitively), each once."""
        found = [self.source]
        for f in found:
            for name in _INCLUDE.findall(f.read_text()):
                inc = CSRC / name
                if inc not in found:
                    found.append(inc)
        return found

    def _lib_path(self) -> Path:
        h = hashlib.sha256()
        for f in self.sources():
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _compile_cmd(self, out: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                str(self.source)]

    def _load(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = I
        self._fn = fn

    def __call__(self, *args) -> None:
        """Launch on the current stream; raise if the launch failed."""
        if self._fn is None:
            build_all([self])
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


def build_all(kernels: list[Kernel]) -> float:
    """Build (or reuse) every kernel's library, one nvcc per source, all
    started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for k in kernels:
        if k._fn is not None:
            continue
        out = k._lib_path()
        if out.exists():
            k._load(out)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(k._compile_cmd(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((k, proc, tmp, out))
    failed = []
    for k, proc, tmp, out in pending:
        log, _ = proc.communicate()
        k.build_log = log
        if proc.returncode != 0:
            failed.append(f"{k.source.name}:\n{log}")
            continue
        os.replace(tmp, out)
        k._load(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


# --- the kernels of the run (argument lists match csrc/*.cu) ---

NORMALS = Kernel("normals", "fp_normals", [
    P,          # out (rows, cols) f32
    I, I,       # rows, cols
    U32, U32,   # philox key words
    I64,        # counter offset (global particle index of column 0)
    P,          # stream
])

QUAD_TABLES = Kernel("quad_tables", "fp_quad_tables", [
    P, P,       # f3d0, f3d1 (NF3, nz, ny, nx) f32
    P, P,       # f2d0, f2d1 (NF2, ny, nx) f32
    I, I, I,    # nz, ny, nx
    F, F, F, F,  # tw0, tw1, ew0, ew1
    I,          # out_bf16 (0: f32 rows)
    P, P,       # rows (R, 64), rowsE (R, 32)
    P,          # stream
])

CONCCALC = Kernel("conccalc", "fp_conccalc", [
    P, P, P, P, P,     # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P, P, P, P,        # itra, itramem, npoint, nclass (n,) i32
    P,                 # active (n,) bool
    P,                 # mass (n, nspec) f32
    P,                 # rhoi (n,) f32 or NULL (= 1)
    P, I,              # lage (nage,) i32, nage
    P, I,              # outheight (nzg,) f32, nzg
    I, I, I, I, I,     # n, nspec, nxg, nyg, npointspec
    I,                 # nclassunc
    F, F, F, F, F, F,  # dx_met, dy_met, xoutshift, youtshift, dxout, dyout
    I, F,              # itime, weight
    I, I, I,           # kernel_possible, use_kernel, ioutputforeachrelease
    I64,               # rows of the flat gridunc (index bound)
    P,                 # gridunc (rows, nspec) f32, accumulated into
    P,                 # stream
])

ADVANCE = Kernel("advance", "fp_advance", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P, P,                 # itra, itramem (n,) i32
    P, P, P, P, P, P,     # up, vp, wp, usig, vsig, wsig (n,) f32
    P, P,                 # cbt (n,) i8, active (n,) bool
    P, P, P, P, P,        # out: x_hi, x_lo, y_hi, y_lo, z
    P,                    # out: itra
    P, P, P, P, P, P,     # out: up, vp, wp, usig, vsig, wsig
    P, P,                 # out: cbt, active
    P, P, P, P, P,        # injected draws for tags 6, 1, 2, 3, 4, or all NULL
    P, P,                 # rows (R, 64), rowsE (R, 32) bf16 or f32
    P,                    # height (nz,) f32
    P,                    # counts (2,) i32: active, exited (accumulated into)
    P,                    # AdvanceArgs (host struct, core/advance.py)
    P,                    # stream
])

REORDER = Kernel("reorder", "fp_reorder", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P,                    # active (n,) bool
    P,                    # height (nz,) f32
    I, I, I, I,           # n, nx, ny, nz
    P, P, P, P,           # scratch: keys a, b and slots a, b, (n,) i32 each
    P, I,                 # scratch: digit counts (radix * blocks,) i32, length
    P, I,                 # scratch: tile sums of the scan, i32, length
    P,                    # out: perm (n,) i32
    P,                    # ReorderFields (host struct, core/reorder.py)
    P,                    # stream
])

CONVECTION = Kernel("convection", "fp_convection", [
    P, P, P, P, P,        # met time 0: ps (ny, nx), tth, qvh (nlev, ny, nx), tt2, td2
    P, P, P, P, P,        # met time 1: the same
    P, P, P, P,           # akz, bkz, akm, bkm (nlev,) f32
    P,                    # cbmf of the previous step (C,) f32
    I, I, I,              # C columns, nlev, nl (L1 = nl + 1 profile levels)
    F, F, F,              # tw0, tw1, delt
    P, P, P, P, P, P, P,  # out: fmassfrac, rlevmass, phconv, pconv, tconv, sub, uvzlev
    P, P, P,              # out: lconv (C,) bool, nctop (C,) i32, cbmf (C,) f32
    P,                    # stream
])

REDIST = Kernel("redist", "fp_redist", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P, P,                 # itra (n,) i32, active (n,) bool
    P, P, P, P, P, P, P,  # fmassfrac, rlevmass, phconv, sub, uvzlev, pconv, tconv
    P,                    # lconv (C,) bool
    P,                    # injected uniforms (n,) f32, or NULL: Philox in registers
    I, I, I, I, I,        # n, nx, ny, L1, itime
    F,                    # lsynctime
    U32, U32,             # philox key words
    P,                    # out: z (n,) f32
    P,                    # moved count (1,) i32, accumulated into
    P,                    # stream
])

KERNELS = (NORMALS, QUAD_TABLES, CONCCALC, ADVANCE, REORDER, CONVECTION,
           REDIST)

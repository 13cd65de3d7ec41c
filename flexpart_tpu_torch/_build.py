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

A kernel of many template instantiations can be built in ``parts``: one
``nvcc`` per part, all started together, each compiling the source with
``-DFP_PART=<k>`` into a library of its own that holds the part's
instantiations; the source's launcher returns ``NOT_IN_PART`` (and
launches nothing) for a configuration another part holds, and ``launch``
tries the parts in turn.  The instantiations' code is the same as in one
library; only the build's wall time shrinks (K4 and K11: by table type,
their ``NESTS`` and ``CBL`` ones apart, their ``TILE`` ones, K11's
``TILE`` x ``CBL`` ones, and K4's turbswitch crosses, ``CBL``, ``CBL`` x
``NESTS`` and ``TILE`` x ``CBL`` ones).

Each ``Kernel`` counts its launches in ``launches`` (a plain integer), so
a run can show that its main path went through the kernel.  A template
instantiation that a path launches on its own (K3's ``BKDEP`` and
``COUNT``, K7's ``BACKWARD``, K9's and K10's ``BKDEP``, K9's ``CLWC``
with and without ``BKDEP``, K4's and K11's ``TILE``, K11's ``TILE`` x
``CBL``, K4's ``CBL``, ``TILE`` x ``CBL`` and its turbswitch crosses) is
an ``Entry`` with a count of its own: the kernel's launcher, picked by its
arguments (``xscav`` given, ``ctwc`` given, ``count``, ``backward``,
``AdvanceArgs.tile``, ``cblflag``, ``turbswitch``), counted in the entry's
count and not in the kernel's; the sampling of the nested output grid is K3's stock
instantiation on the nest's grid, an entry too (``conccalc.nest``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
# what a part's launcher returns for a configuration of another part (no
# cudaError_t has this value)
NOT_IN_PART = -100

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
    """One CUDA source, its exported C function and its launch count; built
    as ``parts`` libraries (one unless said)."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 parts: int = 1, defines: tuple = ()):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.parts = parts
        self.defines = tuple(defines)   # -D flags of every part's nvcc
        self.launches = 0
        self.build_log = ""
        self.build_s = None   # from build_all's start to its last nvcc's end
        self._lib = None      # the first part's library and function
        self._fn = None
        self._libs = []
        self._fns = []
        self._disassembly = {}

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

    def _part_flags(self, part: int) -> tuple:
        return self.defines + ((f"-DFP_PART={part}",) if self.parts > 1
                               else ())

    def _lib_path(self, part: int = 0) -> Path:
        h = hashlib.sha256()
        for f in self.sources():
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS + self._part_flags(part)).encode())
        tag = f"-p{part}" if self.parts > 1 else ""
        return BUILD_DIR / f"lib{self.name}{tag}-{h.hexdigest()[:16]}.so"

    def _compile_cmd(self, out: Path, part: int = 0) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, *self._part_flags(part), "-I",
                str(CSRC), "-o", str(out), str(self.source)]

    def _load(self, paths: list) -> None:
        libs, fns = [], []
        for path in paths:
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = I
            libs.append(lib)
            fns.append(fn)
        self._libs, self._fns = libs, fns
        self._lib, self._fn = libs[0], fns[0]

    def query(self, symbol: str, argtypes: list):
        """Another exported function of this kernel's library, one that
        launches nothing (a layout or occupancy query): built on first
        use, not counted as a launch.  Of a kernel built in parts, each
        part's in turn, up to the first that does not answer
        NOT_IN_PART."""
        if self._fn is None:
            build_all([self])
        fns = []
        for lib in self._libs:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = I
            fns.append(fn)

        def call(*args) -> int:
            for fn in fns:
                err = fn(*args)
                if err != NOT_IN_PART:
                    break
            return err
        return call

    def cuobjdump(self, *flags: str, wait: bool = True) -> str | None:
        """``cuobjdump`` of this kernel's libraries (built on first use),
        their outputs in part order: ``-sass`` for the instructions the
        card runs, ``-elf`` for the cubin's symbol table.  Run once per
        library and flags, each in a background thread of its own (a
        library of many instantiations takes seconds): ``wait=False``
        starts them and returns None, and a later call takes their
        output."""
        if self._fn is None:
            build_all([self])
        jobs = []
        with _DISASSEMBLY_LOCK:
            for lib in self._libs:
                key = (lib._name, flags)
                job = self._disassembly.get(key)
                if job is None:
                    job = _disassembler().submit(_cuobjdump, lib._name,
                                                 flags)
                    self._disassembly[key] = job
                jobs.append(job)
        return "".join(job.result() for job in jobs) if wait else None

    def launch(self, *args) -> None:
        """Launch on the current stream; raise if the launch failed.
        Counts nothing: a call of the kernel, or of one of its entries,
        does."""
        if self._fn is None:
            build_all([self])
        for fn in self._fns:
            err = fn(*args)
            if err != NOT_IN_PART:
                break
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")

    def __call__(self, *args) -> None:
        """Launch on the current stream and count it; raise if the launch
        failed."""
        self.launch(*args)
        self.launches += 1


class Entry:
    """A template instantiation of a kernel that a path launches on its
    own: launched through the kernel's exported function, whose arguments
    pick it, and counted apart from the kernel."""

    def __init__(self, kernel: Kernel, name: str):
        self.kernel = kernel
        self.name = name
        self.launches = 0

    def __call__(self, *args) -> None:
        self.kernel.launch(*args)
        self.launches += 1


_DISASSEMBLY_LOCK = threading.Lock()
_DISASSEMBLER = []


def _disassembler() -> concurrent.futures.ThreadPoolExecutor:
    """The threads that run cuobjdump, made on first use."""
    if not _DISASSEMBLER:
        _DISASSEMBLER.append(concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="cuobjdump"))
    return _DISASSEMBLER[0]


def _cuobjdump(lib: str, flags: tuple) -> str:
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), *flags, lib], capture_output=True,
                          text=True, check=True).stdout


def build_all(kernels: list[Kernel], on_built=None) -> float:
    """Build (or reuse) every kernel's libraries, one nvcc per source and
    part, all started together (each kernel's ``build_s``: when its last
    nvcc ended; its ``build_log`` the parts' logs, in order).  A kernel is
    loaded as soon as all its parts are built, and ``on_built(kernel)``
    (if given) is then called, while other parts may still be building.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    todo = [k for k in kernels if k._fn is None]
    left = {}
    for k in todo:
        k.build_log, k.build_s = "", None
        left[k] = 0
        for part in range(k.parts):
            out = k._lib_path(part)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(k._compile_cmd(tmp, part),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending.append([k, proc, tmp, out, ""])
            left[k] += 1
    lock = threading.Lock()
    failed = []

    def finish(k):
        k._load([k._lib_path(part) for part in range(k.parts)])
        if on_built is not None:
            on_built(k)

    def wait(job):
        k, proc, tmp, out, _ = job
        job[4], _ = proc.communicate()
        with lock:
            k.build_s = max(k.build_s or 0.0, time.perf_counter() - t0)
            if proc.returncode != 0:
                failed.append(f"{k.source.name}:\n{job[4]}")
                return
            os.replace(tmp, out)
            left[k] -= 1
            done = left[k] == 0
        if done:
            finish(k)

    for k in todo:
        if left[k] == 0:
            finish(k)
    waiting = [threading.Thread(target=wait, args=(job,)) for job in pending]
    for t in waiting:
        t.start()
    for t in waiting:
        t.join()
    for job in pending:
        job[0].build_log += job[4]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


# --- the kernels of the run (argument lists match csrc/*.cu) ---

NORMALS = Kernel("normals", "fp_normals", [
    P,          # out (rows, cols) f32
    I, I,       # rows, cols
    U32, U32,   # philox key words
    I64,        # counter offset (global particle index of column 0)
    U32,        # pass of the adaptive advance (counter word 2; 0 elsewhere)
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
    P,                 # xscav (n, nspec) f32 or NULL: given, BKDEP
    I,                 # count: 1, the COUNT instantiation
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

# K4 in nine parts: the stock, POLAR and SETTLING instantiations on f32
# tables (0) and on bf16 tables (1), the NESTS ones (2) and the TILE ones
# (3), turbswitch off but in the stock step; TS with SETTLING or NESTS (4)
# and on a tile (5); the CBL (6), the CBL with NESTS (7) and on a tile (8)
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
    P, P, P,              # settling: mass0 (n, nspec), tt, rho (nz, ny, nx) f32, or NULL
    P,                    # counts (4,) i32: active, exited, the CBL's NaN
                          # redraws (accumulated into), the CBL's queue length
    P,                    # AdvanceArgs (host struct, core/advance.py)
    P,                    # the CBL's queue (K4_CBL_QUEUE_WORDS, n) f32 or NULL
    P,                    # stream
], parts=9)

# K11 in six parts: the HANNA1 and TS instantiations on f32 tables (0)
# and on bf16 tables (1), the CBL ones (2), the TILE ones on f32 tables
# (3) and on bf16 tables (4), and the TILE x CBL ones (5)
ADVANCE_ADAPTIVE = Kernel("advance_adaptive", "fp_advance_adaptive", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P, P,                 # itra, itramem (n,) i32
    P, P, P, P, P, P,     # up, vp, wp, usig, vsig, wsig (n,) f32
    P, P,                 # cbt (n,) i8, active (n,) bool
    P,                    # idt (n,) i32
    P, P, P, P, P,        # out: x_hi, x_lo, y_hi, y_lo, z
    P,                    # out: itra
    P, P, P, P, P, P,     # out: up, vp, wp, usig, vsig, wsig
    P, P,                 # out: cbt, active
    P,                    # out: idt
    P, P,                 # out: t_below (n,) f32, passes (n,) i32
    P, P,                 # rows (R, 64), rowsE (R, 32) bf16 or f32
    P,                    # height (nz,) f32
    P, P, P,              # settling: mass0 (n, nspec), tt, rho (nz, ny, nx) f32, or NULL
    P,                    # counts (2,) i32: active, exited (accumulated into)
    P,                    # work (2,) u64: passes executed, lane iterations
                          # issued (accumulated into)
    P,                    # AdvanceArgs (host struct, core/advance.py)
    P,                    # stream
], parts=6)

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
    I64,                  # offset: the global slot of particle 0 (the draws' counter)
    I,                    # backward: 1, the BACKWARD instantiation
    P,                    # out: z (n,) f32
    P,                    # moved count (1,) i32, accumulated into
    P,                    # stream
])

DEPO_SCATTER = Kernel("depo_scatter", "fp_depo_scatter", [
    P, P, P, P,           # x_hi, x_lo, y_hi, y_lo (n,) f32
    P, P, P,              # itramem, npoint, nclass (n,) i32
    P,                    # active (n,) bool
    P,                    # deposit (nspec, n) f32
    P, I,                 # lage (nage,) i32, nage
    I, I, I, I, I, I,     # n, nspec, nxg, nyg, npointspec, nclassunc
    F, F, F, F, F, F,     # dx_met, dy_met, xoutshift, youtshift, dxout, dyout
    I, I,                 # itime, ioutputforeachrelease
    I64,                  # rows of the flat grid (index bound)
    P,                    # grid (rows, nspec) f32, accumulated into
    P,                    # stream
])

WETDEPO = Kernel("wetdepo", "fp_wetdepo", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P,                    # active (n,) bool
    P,                    # mass (n, nspec) f32
    P,                    # xscav (n, nspec) f32 or NULL: given, BKDEP
    P, P, P,              # lsprec, convprec, tcc planes (ny, nx) f32
    P,                    # ctwc plane (ny, nx) f32 or NULL: given, CLWC
    P,                    # clouds (nz, ny, nx) i8
    P,                    # temperature plane of f3d (nz, ny, nx) f32
    P,                    # height (nz,) f32
    I, I, I,              # nz, ny, nx
    P,                    # WetSpec[MAX_SPECIES] (host array, physics/wetdepo.py)
    I, I,                 # n, nspec
    I, I,                 # |ltsample|, |ldeltat|
    F,                    # BKDEP: the released column's height [m]
    P, P,                 # out: mass (n, nspec), deposit (nspec, n) f32
    P,                    # out: BKDEP's xscav (n, nspec) f32, or NULL
    P,                    # stream
])

DRYDEPO = Kernel("drydepo", "fp_drydepo", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P,                    # active (n,) bool
    P, P,                 # mass, mass0 (n, nspec) f32
    P,                    # xscav (n, nspec) f32 or NULL: given, BKDEP
    P, I, I,              # vdep (nspec, ny, nx) f32 or NULL, ny, nx
    P,                    # t_below (n,) f32 or NULL (the fixed step's rule)
    P,                    # DrySpec[MAX_SPECIES] (host array, physics/massupdate.py)
    I, I,                 # n, nspec
    I, I, F,              # |lsynctime|, |ldeltat|, minmass
    P, P, P,              # out: mass (n, nspec), active (n,), deposit (nspec, n)
    P,                    # out: BKDEP's xscav (n, nspec) f32, or NULL
    P,                    # stream
])

OHREACTION = Kernel("ohreaction", "fp_ohreaction", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P,                    # active (n,) bool
    P,                    # mass (n, nspec) f32
    P, P,                 # tt (nz, ny, nx), height (nz,) f32
    I, I, I,              # nz, ny, nx
    F, F, F, F,           # xlon0, ylat0, dx, dy
    P, I, I, I,           # OH axes: lon, lat, alt_top concatenated, f32; their lengths
    P, P,                 # oh0, oh1 (nxo, nyo, nzo) f32
    I, I, I,              # itime, t0, t1
    P,                    # OHSpec[MAX_SPECIES] (host array, physics/ohchem.py)
    I, I,                 # n, nspec
    I,                    # |ltsample|
    I,                    # scan: an OH axis not finite and nondecreasing
    P,                    # out: mass (n, nspec) f32
    P,                    # stream
])

SPLIT = Kernel("split", "fp_split", [
    P,                    # the 22 field pointers of Particles (host array, FIELDS order), in place
    P,                    # origin (n,) i64, or NULL (the identity)
    I, I,                 # n, nspec
    I, I,                 # itime, ldirect
    P, P,                 # scratch (core/origin_rank.py::rank_plan): free then due bits, their word prefixes
    P, P,                 # scratch: tile states (tiles,) u64, ticket
    I64, I,               # bytes zeroed from the bits on, scan tiles of each bitmap
    P,                    # scratch: the slots free or due, bits in slot order
    P, P,                 # scratch: free and due slots by rank (n / 2 + 1,) i32; (n,) in a share
    I64, I64, I64,        # a rank's share of a group's split: due base, free base, granted (-1: alone)
    P,                    # out: counts (3,) i32: due, free, granted
    I,                    # multiprocessors (the copy's grid)
    P,                    # stream
])

DOMAINFILL = Kernel("domainfill", "fp_domainfill", [
    P,                    # the 22 field pointers of Particles (host array, FIELDS order), in place
    P,                    # origin (n,) i64, or NULL (the identity)
    I, I,                 # n, nspec
    P, I,                 # the 15 site pointers (host array, BOUNDARY_FIELDS[:15]), S sites
    P,                    # out: acc (S,) f32
    P, P, P,              # f3d0, f3d1 (NF3, nz, ny, nx), height (nz,) f32
    I, I, I,              # nz, ny, nx
    F, F, F,              # w0, w1, lsynctime
    F, F, F, F, F,        # xpp, window x lo, hi, y lo, hi
    I, I,                 # check_x, mdomainfill
    F, F,                 # ylat0, dy
    I, I, I,              # itime, the new particles' itrasplit, nclassunc
    U32, U32,             # philox key words
    P, P, P,              # injected u1, u2 (4, S) f32, nclass (4, S) i32, or all NULL
    P, P,                 # scratch (core/origin_rank.py::rank_plan): free then wish bits, their word prefixes
    P, P, P,              # scratch: tile states (tiles,) u64, ticket, killed count
    I64, I, I,            # bytes zeroed from the bits on, scan tiles of the free bits, of both
    P,                    # scratch: the free slots, bits in slot order
    P,                    # scratch: free slots by rank (4 S,) i32
    P, P, P, P, P,        # scratch: the wishes' class (4 S,) i32, x, y, z, mass (4 S,) f32
    P,                    # a rank's first free rank (1,) i64, or NULL (0)
    P,                    # out: counts (4,) i32: killed, free, wanted, granted
    P,                    # stream
])

RECEPTORS = Kernel("receptors", "fp_receptors", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P, P,                 # itra, itramem (n,) i32
    P,                    # active (n,) bool
    P,                    # mass (n, nspec) f32
    P, P, P,              # receptors' x, y, area (R,) f32
    I, I, I,              # n, nspec, R
    I,                    # itime
    F, F,                 # dx, dy
    F,                    # 2 weight
    P,                    # creceptor (R, nspec) f32
    P, I,                 # scratch: block partials (R nspec blocks,) f32, blocks
    P,                    # out: (R, nspec) f32
    P,                    # stream
])

FLUXES = Kernel("fluxes", "fp_fluxes", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P, P, P,              # xold, yold, zold (n,) f32
    P, P, P,              # itra, itramem, npoint (n,) i32
    P,                    # active (n,) bool
    P,                    # mass (n, nspec) f32
    P, I,                 # lage (nage,) i32, nage
    P, P, I,              # outheight (nzg,), its half levels (nzg + 1,) f32, nzg
    I, I, I, I, I,        # n, nspec, nxg, nyg, npointspec
    I,                    # ioutputforeachrelease
    F, F, F, F, F, F,     # dx_met, dy_met, xoutshift, youtshift, dxout, dyout
    F,                    # nx_met / 2
    I,                    # itime
    P,                    # flux (6, nage, npointspec, nzg, nyg, nxg, nspec) f32, accumulated into
    P,                    # stream
])

INITCOND = Kernel("initcond", "fp_initcond", [
    P, P, P, P, P,        # x_hi, x_lo, y_hi, y_lo, z (n,) f32
    P,                    # npoint (n,) i32
    P,                    # mass (n, nspec) f32
    P,                    # mask (n,) bool
    P, P,                 # rho (nz, ny, nx), height (nz,) f32
    I, I, I,              # nz, ny, nx
    I,                    # by_rho: linit_cond == 1
    P, I,                 # outheight (nzg,) f32, nzg
    I, I, I, I, I,        # n, nspec, nxg, nyg, npointspec
    I,                    # ioutputforeachrelease
    F, F, F, F, F, F,     # dx_met, dy_met, xoutshift, youtshift, dxout, dyout
    P,                    # grid (npointspec, nzg, nyg, nxg, nspec) f32, accumulated into
    I, I, I,              # plan (grid/initcond.py::k17_plan): blocks, span, slots
    P,                    # stream
])

# the instantiations of the backward runs (ldirect = -1)
CONCCALC_BKDEP = Entry(CONCCALC, "conccalc.bkdep")      # xscav given
CONCCALC_COUNT = Entry(CONCCALC, "conccalc.count")      # count = 1
REDIST_BACKWARD = Entry(REDIST, "redist.backward")      # backward = 1
WETDEPO_BKDEP = Entry(WETDEPO, "wetdepo.bkdep")         # xscav given
DRYDEPO_BKDEP = Entry(DRYDEPO, "drydepo.bkdep")         # xscav given
# the cloud-water instantiations of met that carries it (GFS: use_clwc)
WETDEPO_CLWC = Entry(WETDEPO, "wetdepo.clwc")           # ctwc given
WETDEPO_BKDEP_CLWC = Entry(WETDEPO, "wetdepo.bkdep_clwc")   # both given
# the sampling of the nested output grid (OUTGRID_NEST): K3's stock
# instantiation on the nest's grid, counted apart from the mother grid's
CONCCALC_NEST = Entry(CONCCALC, "conccalc.nest")
# a tile's advance in a tiles run (AdvanceArgs.tile): K4 TILE, K11 TILE,
# and K11 TILE x CBL (AdvanceArgs.tile and cblflag)
ADVANCE_TILE = Entry(ADVANCE, "advance.tile")
ADVANCE_ADAPTIVE_TILE = Entry(ADVANCE_ADAPTIVE, "advance_adaptive.tile")
ADVANCE_ADAPTIVE_TILE_CBL = Entry(ADVANCE_ADAPTIVE,
                                  "advance_adaptive.tile_cbl")
# the fixed step's crosses (AdvanceArgs.cblflag, turbswitch): K4 CBL (with
# or without settling, nests), K4 TILE x CBL, and K4 TS with SETTLING,
# NESTS or TILE
ADVANCE_CBL = Entry(ADVANCE, "advance.cbl")
ADVANCE_TILE_CBL = Entry(ADVANCE, "advance.tile_cbl")
ADVANCE_TS_CROSS = Entry(ADVANCE, "advance.ts_cross")

ENTRIES = (CONCCALC_BKDEP, CONCCALC_COUNT, REDIST_BACKWARD, WETDEPO_BKDEP,
           DRYDEPO_BKDEP, WETDEPO_CLWC, WETDEPO_BKDEP_CLWC, CONCCALC_NEST,
           ADVANCE_TILE, ADVANCE_ADAPTIVE_TILE, ADVANCE_ADAPTIVE_TILE_CBL,
           ADVANCE_CBL, ADVANCE_TILE_CBL, ADVANCE_TS_CROSS)

# fp_convection_layout(nl, out): out (4,) i32 gets K6's shared bytes per
# column, columns per block, resident blocks per SM and registers per thread
LAYOUT = [I, P]
# fp_ohreaction_layout(nxo, nyo, nzo, nz, scan, out): out (4,) i32 gets
# K12's shared bytes per block, resident blocks per SM, registers per
# thread and threads per block, of its search (scan 0) or SCAN (scan 1)
# instantiation
OH_LAYOUT = [I, I, I, I, I, P]

KERNELS = (NORMALS, QUAD_TABLES, CONCCALC, ADVANCE, REORDER, CONVECTION,
           REDIST, DEPO_SCATTER, WETDEPO, DRYDEPO, ADVANCE_ADAPTIVE,
           OHREACTION, SPLIT, DOMAINFILL, RECEPTORS, FLUXES, INITCOND)

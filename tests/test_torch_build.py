"""The ctypes bindings of the CUDA kernels agree with their sources.

A ``ctypes`` argument list that disagrees with the ``extern "C"``
signature corrupts memory silently, and no compiler runs on the CPU, so
the signatures are parsed from ``csrc/*.cu`` and held against
``_build.py``: the same number of arguments, each of the same kind
(pointer, int, int64, uint32, float).  The ``AdvanceArgs`` struct that K4
receives by pointer and the ``ReorderFields`` struct that K5 receives are
held field for field against their ctypes mirrors, and the lane counts of
the two quad tables against the strides that K2 writes and K4 reads.
A kernel's library name must change with its source and with every
header the source includes, or a changed header is never rebuilt.  K4's
``POLAR`` instantiation, K6's level limit and K7's uniform draw and
rounding are held against what the Python side assumes.
"""
import ctypes
import re
import shutil

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from flexpart_tpu_torch import _build  # noqa: E402
from flexpart_tpu_torch.core import advance, interp, reorder, rng, state  # noqa: E402
from flexpart_tpu_torch.grid import conccalc  # noqa: E402
from flexpart_tpu_torch.physics import convection  # noqa: E402

KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_int64: "int64", ctypes.c_uint32: "uint32",
         ctypes.c_float: "float"}
C_KINDS = {"int": "int", "long long": "int64", "uint32_t": "uint32",
           "float": "float"}
KERNEL_NAMES = [k.name for k in _build.KERNELS]


def _strip_comments(text):
    return re.sub(r"//[^\n]*", "", text)


def _c_kind(decl):
    if "*" in decl:
        return "pointer"
    words = [w for w in decl.split() if w != "const"]
    return C_KINDS[" ".join(words[:-1])]        # the last word is the name


def _signature(kernel):
    text = _strip_comments(kernel.source.read_text())
    m = re.search(r'extern\s+"C"\s+int\s+%s\s*\((.*?)\)\s*\{' % kernel.symbol,
                  text, re.S)
    assert m, f"no extern \"C\" int {kernel.symbol}(...) in {kernel.source}"
    return [_c_kind(d.strip()) for d in m.group(1).split(",")]


def _kernel(name):
    return next(k for k in _build.KERNELS if k.name == name)


def test_four_kernels():
    """The four kernels of the stock step, the cell-order sort, and the
    two of the convection: the columns (K6) and the redistribution (K7)."""
    assert KERNEL_NAMES == ["normals", "quad_tables", "conccalc", "advance",
                            "reorder", "convection", "redist"]
    for k in _build.KERNELS:
        assert k.source.is_file() and k.launches == 0 and k._fn is None


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_argtypes_match_the_source(name):
    k = _kernel(name)
    assert [KINDS[t] for t in k.argtypes] == _signature(k)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_library_name_follows_source_and_headers(name, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")    # none on the CPU
    k = _kernel(name)
    files = k.sources()
    assert files[0] == csrc / f"{name}.cu"
    includes = re.findall(r'#include\s+"([^"]+)"', files[0].read_text())
    assert [f.name for f in files[1:]] == includes
    assert f"-I {csrc}" in " ".join(k._compile_cmd(tmp_path / "x.so"))
    seen = {k._lib_path().name}
    for f in files:                       # the source, then each header
        f.write_text(f.read_text() + "\n// changed\n")
        seen.add(k._lib_path().name)
    assert len(seen) == len(files) + 1
    other = next(f for f in sorted(csrc.iterdir()) if f not in files)
    other.write_text(other.read_text() + "\n// changed\n")
    assert k._lib_path().name in seen     # another kernel's file: no rebuild


def test_build_directory_is_ignored_by_git():
    """Every kernel is built at first use into build/kernels/, which git
    ignores and which no import creates."""
    root = _build.BUILD_DIR.parent.parent
    assert _build.BUILD_DIR == root / "build" / "kernels"
    assert "build/" in (root / ".gitignore").read_text().split()
    for k in _build.KERNELS:
        assert k._lib_path().parent == _build.BUILD_DIR
        assert k._lib_path().name.startswith(f"lib{k.name}-")


def test_advance_and_reorder_share_the_cell_header():
    """K5's sort key is K4's row id: both take the cell of a particle from
    the device functions of one header, and neither keeps its own copy."""
    for name in ("advance", "reorder"):
        k = _kernel(name)
        assert _build.CSRC / "cell_index.cuh" in k.sources()
        text = _strip_comments(k.source.read_text())
        assert "fp::cell_row(" in text
        assert "vert_weights(" in text and "horiz_weights(" in text
        assert not re.search(r"__device__[^;{]*\b(horiz_weights|vert_weights"
                             r"|floor_index|cell_row)\s*\(", text)
    header = (_build.CSRC / "cell_index.cuh").read_text()
    for fn in ("horiz_weights", "vert_weights", "floor_index", "cell_row"):
        assert re.search(r"__device__[^;{]*\b%s\s*\(" % fn, header), fn


def test_table_strides_match_the_sources():
    """``rows`` has 64 lanes and ``rowsE`` 32: the strides K2 stores with,
    the strides K4 gathers with, and the shapes the wrappers allocate and
    check."""
    assert (interp.ROWS_LANES, interp.ROWS_E_LANES) == (64, 32)
    k2 = _strip_comments(_build.QUAD_TABLES.source.read_text())
    assert re.search(r"store8\(rows \+ \(row0 \+ c\) \* %d \+ v \* 8"
                     % interp.ROWS_LANES, k2)
    assert re.search(r"store8\(rowsE \+ \(row0 \+ c\) \* %d \+ v \* 8"
                     % interp.ROWS_E_LANES, k2)
    # 8 lanes per store: 8 stores fill a row of rows, 4 a row of rowsE
    assert "it < ncell * %d" % (interp.ROWS_LANES // 8) in k2
    assert "it < ncell * %d" % (interp.ROWS_E_LANES // 8) in k2
    k4 = _strip_comments(_build.ADVANCE.source.read_text())
    assert "load8<BF16, %d>(rows, row, k," % interp.ROWS_LANES in k4
    assert "load8<BF16, %d>(rowsE, row2, k," % interp.ROWS_E_LANES in k4
    assert "row * (2 * LANES)" in k4 and "row * (4 * LANES)" in k4
    # K4 reads 8 groups of 8 lanes of rows and 3 of rowsE (lanes 0-23)
    assert re.search(r"for \(int k = 0; k < 8; \+\+k\) load8<BF16, 64>", k4)
    assert re.search(r"for \(int k = 0; k < 3; \+\+k\) load8<BF16, 32>", k4)


def test_reorder_fields_struct_matches_the_source():
    text = _strip_comments(_build.REORDER.source.read_text())
    n = int(re.search(r"constexpr\s+int\s+NFIELDS\s*=\s*(\d+)\s*;",
                      text).group(1))
    assert n == len(state.FIELDS)
    body = re.search(r"struct\s+ReorderFields\s*\{(.*?)\};", text,
                     re.S).group(1)
    parsed = [re.fullmatch(r"(.+?)\s*(\w+)\[NFIELDS\]", d.strip()).groups()
              for d in body.split(";") if d.strip()]
    assert parsed == [("const void*", "src"), ("void*", "dst"),
                      ("int", "width")]
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int": ctypes.c_int}
    fields = [(name, t._type_, t._length_)
              for name, t in reorder.ReorderFields._fields_]
    assert fields == [(name, c_types[c], n) for c, name in parsed]
    # the scan tile of the wrapper's scratch is the kernel's
    m = re.search(r"constexpr\s+int\s+SCAN_ITEMS\s*=\s*(\d+)\s*;", text)
    t = re.search(r"constexpr\s+int\s+THREADS\s*=\s*(\d+)\s*;", text)
    assert int(m.group(1)) * int(t.group(1)) == reorder.SCAN_TILE
    assert "SCAN_TILE = THREADS * SCAN_ITEMS" in text


def test_reorder_radix_constants_match_the_source():
    """The wrapper sizes K5's digit counts by ``SORT_TILE`` and
    ``MAX_DIGIT_BITS`` and hands the kernel their length; the kernel plans
    its passes from the grid itself."""
    text = _strip_comments(_build.REORDER.source.read_text())

    def const(name):
        return int(re.search(r"constexpr\s+int\s+%s\s*=\s*(\d+)\s*;" % name,
                             text).group(1))
    threads, rounds = const("THREADS"), const("ROUNDS")
    assert "WARPS = THREADS / 32" in text
    assert "WARP_ITEMS = 32 * ROUNDS" in text
    assert "SORT_TILE = WARPS * WARP_ITEMS" in text
    assert "MAX_RADIX = 1 << MAX_DIGIT_BITS" in text
    assert reorder.SORT_TILE == threads // 32 * 32 * rounds
    assert reorder.MAX_DIGIT_BITS == const("MAX_DIGIT_BITS")
    # no atomic on device memory decides a place: the only atomic is the
    # block's shared-memory digit count
    assert text.count("atomicAdd(") == 1
    assert "atomicAdd(&sh_count[digit]" in text
    # the plan is made in one place, from the largest key, as the numpy
    # emulation of tests/test_torch_reorder.py makes it; no caller hands
    # one in, and scratch shorter than the plan needs is refused
    assert "while ((n_rows >> bits) != 0) ++bits;" in text
    assert "*passes = (bits + MAX_DIGIT_BITS - 1) / MAX_DIGIT_BITS;" in text
    assert "*digit_bits = (bits + *passes - 1) / *passes;" in text
    assert "radix_plan(n_rows, &passes, &digit_bits);" in text
    assert not re.search(r"fp_reorder\([^)]*\bint passes\b", text)
    assert "n_counts > counts_len || tiles > sums_len" in text
    assert not hasattr(reorder, "radix_plan")


def test_normals_and_advance_share_the_philox_header():
    for name in ("normals", "advance"):
        assert _build.CSRC / "philox_normal.cuh" in _kernel(name).sources()
    for name in ("normals", "advance"):
        text = _kernel(name).source.read_text()
        assert "philox4x32_10(" not in text.replace("fp::", "")
        assert "logf(" not in text and "sincosf(" not in text
        assert "fp::normal_words(" in text and "fp::normal_pair(" in text


def test_philox_lane_layout_matches_the_plain_version():
    """Four rows to a Philox call, two to a radius; words (0, 1) make the
    first pair of rows and (2, 3) the second, cos before sin: the header,
    the stand-alone kernel and ``core/rng.py`` say the same."""
    header = _strip_comments((_build.CSRC / "philox_normal.cuh").read_text())
    for name, value in (("ROWS_PER_BLOCK", rng.ROWS_PER_BLOCK),
                        ("ROWS_PER_PAIR", rng.ROWS_PER_PAIR)):
        m = re.search(r"constexpr\s+int\s+%s\s*=\s*(\d+)\s*;" % name, header)
        assert int(m.group(1)) == value, name
    assert (rng.ROWS_PER_BLOCK, rng.ROWS_PER_PAIR) == (4, 2)
    assert re.search(r"w\[1\] = block;", header)
    assert re.search(r"z_even = fminf\(fmaxf\(r \* c,", header)
    assert re.search(r"z_odd = fminf\(fmaxf\(r \* s,", header)
    assert "sincosf(two_pi * u2, &s, &c)" in header
    assert "cosf(" not in header.replace("sincosf(", "")
    k1 = _strip_comments(_build.NORMALS.source.read_text())
    assert "row += fp::ROWS_PER_BLOCK" in k1
    assert "row / fp::ROWS_PER_BLOCK" in k1
    assert "fp::normal_pair(w[0], w[1], z0, z1)" in k1
    assert "fp::normal_pair(w[2], w[3], z0, z1)" in k1


def test_conccalc_sums_per_warp():
    """K3 sums the pairs of one warp before its global atomics: one thread
    per particle, so ``K3_GROUP`` consecutive particles, which is what the
    count of (warp, target) pairs on the card assumes."""
    text = _strip_comments(_build.CONCCALC.source.read_text())
    assert conccalc.K3_GROUP == 32
    threads = int(re.search(r"constexpr\s+int\s+THREADS\s*=\s*(\d+)\s*;",
                            text).group(1))
    assert threads % conccalc.K3_GROUP == 0
    assert "blockIdx.x) * THREADS + threadIdx.x" in text
    assert "(n + THREADS - 1) / THREADS" in text
    assert "threadIdx.x & %du" % (conccalc.K3_GROUP - 1) in text
    assert "__match_any_sync(" in text and "__shfl_sync(" in text
    assert "__shared__" not in text
    assert "MAX_ROWS = 0x%Xll - 32;" % 0xFFFFFFFF in text
    assert conccalc.K3_MAX_ROWS == 0xFFFFFFFF - 32
    assert "rows > MAX_ROWS" in text
    assert text.count("atomicAdd(") == 1


def test_advance_args_struct_matches_the_source():
    text = _strip_comments(_build.ADVANCE.source.read_text())
    body = re.search(r"struct\s+AdvanceArgs\s*\{(.*?)\};", text, re.S).group(1)
    c_types = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
               "uint32_t": ctypes.c_uint32, "float": ctypes.c_float}
    parsed = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.fullmatch(r"(.+?)\s+(\w+)(?:\[(\d+)\])?", decl)
        ctype = c_types[m.group(1)]
        parsed.append((m.group(2), ctype, int(m.group(3) or 0)))
    fields = []
    for fname, ftype in advance.AdvanceArgs._fields_:
        if issubclass(ftype, ctypes.Array):
            fields.append((fname, ftype._type_, ftype._length_))
        else:
            fields.append((fname, ftype, 0))
    assert fields == parsed
    assert len(advance.DRAW_TAGS) * 2 == dict(
        (n, c) for n, _, c in parsed)["key"]


def test_advance_polar_is_an_instantiation_of_its_own():
    """The polar-cap update is compiled only into the ``POLAR``
    instantiations of K4, at the predictor and at the corrector, and the
    launcher picks them by ``AdvanceArgs.polar``; the update calls the
    six functions of the plain version's torch ops."""
    text = _strip_comments(_build.ADVANCE.source.read_text())
    assert "template <bool BF16, bool TS, bool POLAR>" in text
    assert text.count("if (POLAR) polar_update(") == 2
    assert "if (POLAR) polar_update(a, x, y, dxsave, dysave," in text
    assert "if (POLAR) polar_update(a, xn, yn, du * dt, dv * dt," in text
    assert "a.polar" in text
    # the four (table type, turbswitch) instantiations, with and without
    for polar in ("true", "false"):
        assert text.count(f", {polar}>") == 4
    body = re.search(r"void polar_update\((.*?)\n}\n", text, re.S).group(1)
    for fn in ("sinf(", "cosf(", "tanf(", "hypotf(", "atanf(", "atan2f("):
        assert fn in body, fn
    assert "sincosf(" not in body and "__sinf(" not in body
    assert ("polar", ctypes.c_int) in advance.AdvanceArgs._fields_
    assert ("xlon0", ctypes.c_float) in advance.AdvanceArgs._fields_


def test_convection_level_limit_matches_the_source():
    """K6 refuses a grid whose profile levels its shared memory cannot hold,
    and the wrapper states the same limit; at the limit a column's shared
    memory fits in the 232,448 bytes a block may have."""
    text = _strip_comments(_build.CONVECTION.source.read_text())
    m = re.search(r"constexpr\s+int\s+MAX_LEVELS\s*=\s*(\d+)\s*;", text)
    assert int(m.group(1)) == convection.K6_MAX_LEVELS
    nvec = int(re.search(r"constexpr\s+int\s+NVEC\s*=\s*(\d+)\s*;",
                         text).group(1))
    assert "(NVEC * L1 + 3 * (L1 + 1) + 3 * L1 * L1) * sizeof(float)" in text
    L1 = convection.K6_MAX_LEVELS
    shared = (nvec * L1 + 3 * (L1 + 1) + 3 * L1 * L1) * 4 + 4 * L1
    assert shared + 256 <= 232448
    assert "L1 > MAX_LEVELS" in text
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text


def test_redist_rounds_half_to_even_and_draws_word_zero():
    """K7 rounds a position to its column as ``jnp.round``/``torch.round``
    do (``rintf``, never ``roundf``), and its uniform is ``fp::uniform24``
    of word 0 of the particle's Philox call, as ``rng.uniforms_plain``
    makes it; ``philox_normal.cuh`` holds the one definition."""
    k7 = _kernel("redist")
    assert _build.CSRC / "philox_normal.cuh" in k7.sources()
    text = _strip_comments(k7.source.read_text())
    assert "rintf(" in text and "roundf(" not in text
    assert "fp::normal_words(w, k0, k1, i, 0u);" in text
    assert "rn = fp::uniform24(w[0]);" in text
    header = _strip_comments((_build.CSRC / "philox_normal.cuh").read_text())
    assert re.search(r"uniform24\(uint32_t w\) \{\s*return "
                     r"static_cast<float>\(w >> 8\) \* "
                     r"5\.9604644775390625e-08f;", header)
    assert rng._2M24 == 5.9604644775390625e-08
    assert convection.REDIST_TAG == 1000000

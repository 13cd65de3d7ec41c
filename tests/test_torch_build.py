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
rounding are held against what the Python side assumes, and so are the
species structs that K9 and K10 take by value, K8's row and species
limits, and K9's level search and light path.
``setup_drydep`` reads FLEXPART's landuse and Wesely files as the JAX
package does.
"""
import ctypes
import re
import shutil

import numpy as np

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu_torch import _build  # noqa: E402
from flexpart_tpu_torch.core import advance, interp, reorder, rng, state  # noqa: E402
from flexpart_tpu_torch.grid import conccalc  # noqa: E402
from flexpart_tpu_torch.physics import convection, massupdate, wetdepo  # noqa: E402

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


def _all_sources(kernel):
    """A kernel's source and the headers it includes, comments stripped."""
    return "\n".join(_strip_comments(f.read_text()) for f in kernel.sources())


def test_four_kernels():
    """The four kernels of the stock step, the cell-order sort, the two of
    the convection: the columns (K6) and the redistribution (K7), the
    three of deposition: the deposit scatter (K8), the wet pass (K9) and
    the decay and dry pass (K10), the adaptive step (K11), the OH
    reaction (K12), the particle splitting (K13), the domain fill's
    boundary (K14), the receptors (K15), the gross fluxes (K16) and the
    initial-condition sensitivity (K17)."""
    assert KERNEL_NAMES == ["normals", "quad_tables", "conccalc", "advance",
                            "reorder", "convection", "redist",
                            "depo_scatter", "wetdepo", "drydepo",
                            "advance_adaptive", "ohreaction", "split",
                            "domainfill", "receptors", "fluxes", "initcond"]
    for k in _build.KERNELS:
        assert k.source.is_file() and k.launches == 0 and k._fn is None


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_argtypes_match_the_source(name):
    k = _kernel(name)
    assert [KINDS[t] for t in k.argtypes] == _signature(k)


@pytest.mark.parametrize("entry", [e.name for e in _build.ENTRIES])
def test_entries_launch_their_instantiations(entry):
    """Each instantiation of a backward run, and K9's cloud-water ones, is
    an entry of its kernel with a launch count of its own, launched
    through the kernel's exported
    function and picked there by one of its arguments, which the source
    reads; the nested output grid's sampling is K3's stock instantiation,
    the one that none of those arguments picks."""
    e = next(x for x in _build.ENTRIES if x.name == entry)
    assert e.name.split(".")[0] == e.kernel.name and e.launches == 0
    assert e.kernel in _build.KERNELS
    text = _strip_comments(e.kernel.source.read_text())
    pick = {"conccalc.bkdep": "if (!count && xscav != nullptr)\n"
                              "    return launch_bkdep(",
            "conccalc.count": "count ? conccalc_kernel<true>",
            "redist.backward": "backward ? redist_kernel<true>",
            "wetdepo.bkdep": "bkdep ? (clwc ? wetdepo_kernel<true, true>\n"
                             "                            : "
                             "wetdepo_kernel<true, false>)",
            "drydepo.bkdep": "bkdep ? drydepo_kernel<false, true>",
            "wetdepo.clwc": ": (clwc ? wetdepo_kernel<false, true>",
            "wetdepo.bkdep_clwc": "bkdep ? (clwc ? wetdepo_kernel<true, "
                                  "true>",
            "conccalc.nest": ": conccalc_kernel<false>;",
            "advance.tile": "if (a.tile) {\n#if FP_HAS(3)\n    return "
                            "launch(a.settling",
            "advance_adaptive.tile": "if (a.tile) {\n    if (a.table_bf16) "
                                     "{\n#if FP_HAS(4)",
            "advance_adaptive.tile_cbl": "if (a.tile && a.cblflag) {\n"
                                         "#if FP_HAS(5)",
            "advance.cbl": "#if FP_HAS(6)\n  return a.table_bf16 ? "
                           "by(Yes{}, No{}, No{})",
            "advance.tile_cbl": "if (a.tile) {\n#if FP_HAS(8)\n    return "
                                "a.table_bf16 ? by(Yes{}, No{}, Yes{})",
            "advance.ts_cross": "if (a.turbswitch && a.tile) {\n"
                                "#if FP_HAS(5)\n    return a.table_bf16 ? "
                                "launch(ts_tile(Yes{}))"}[entry]
    assert pick in text
    if entry.endswith("bkdep") and entry != "conccalc.bkdep":
        assert "const bool bkdep = xscav != nullptr;" in text
    if entry.endswith("clwc"):
        assert "const bool clwc = ctwc != nullptr;" in text


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
        # the kernel's source and its own headers (K4's start is in
        # advance_common.cuh)
        text = "\n".join(_strip_comments(f.read_text()) for f in k.sources()
                         if f.name != "cell_index.cuh")
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
    k4 = _all_sources(_build.ADVANCE)
    assert "load8<BF16, %d>(rows, row, k," % interp.ROWS_LANES in k4
    assert "load8<BF16, %d>(rowsE, row2, k," % interp.ROWS_E_LANES in k4
    assert "row * (2 * LANES)" in k4 and "row * (4 * LANES)" in k4
    # K4 reads 8 groups of 8 lanes of rows and 3 of rowsE (lanes 0-23)
    assert re.search(r"for \(int k = 0; k < 8; \+\+k\) load8<BF16, 64>", k4)
    assert re.search(r"for \(int k = 0; k < 3; \+\+k\) load8<BF16, 32>", k4)
    # K11: the whole row at the start, per pass lanes 0-39 (wind10_quad's
    # five fields), lanes 0-23 for the free troposphere, group 7 (lanes
    # 56-63, the sigmas 60-62) at the end, and K4's corrector
    k11 = _all_sources(_build.ADVANCE_ADAPTIVE)
    assert "step_start<BF16, TILE>(a, io.rows, sh_height, x, y, z)" in k11
    assert re.search(r"for \(int k = 0; k < 8; \+\+k\) load8<BF16, 64>"
                     r"\(rows, row, k,", k11)
    assert re.search(r"for \(int q = 0; q < 5; \+\+q\) load8<BF16, 64>"
                     r"\(io\.rows, rk, q,", k11)
    assert re.search(r"for \(int q = 0; q < 3; \+\+q\) load8<BF16, 64>"
                     r"\(io\.rows, rf, q,", k11)
    assert re.search(r"load8<BF16, 64>\(io\.rows, fp::cell_row\(ize, "
                     r"L\.hw\.jy, L\.hw\.ix, table_ny<TILE>\(a\),\s+"
                     r"table_nx<TILE>\(a\)\),\s+7, ge\);", k11)
    assert re.search(r"ge\[4\], ge\[5\],\s+ge\[6\],", k11)
    assert "finish_step<BF16, POLAR, SETTLING, false, TILE>(" in k11


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
    for name in ("normals", "advance", "advance_adaptive"):
        assert _build.CSRC / "philox_normal.cuh" in _kernel(name).sources()
    for name in ("normals", "advance", "advance_adaptive"):
        # the kernel's source and its own headers (K4 and K11 draw through
        # the device functions of advance_common.cuh)
        text = "\n".join(f.read_text() for f in _kernel(name).sources()
                         if f.name != "philox_normal.cuh")
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
    count of (warp, target) pairs on the card assumes.  That is the stock
    and COUNT body's design; the BKDEP body after it groups by warp too,
    over K8's tables in shared memory (warp_groups.cuh)."""
    whole = _strip_comments(_build.CONCCALC.source.read_text())
    text, bkdep = whole.split("constexpr int WARPS = THREADS / 32;")
    assert "__shared__" in bkdep and "fp::group_sums(" in bkdep
    assert "launch_bkdep(" in whole
    assert conccalc.K3_GROUP == 32
    threads = int(re.search(r"constexpr\s+int\s+THREADS\s*=\s*(\d+)\s*;",
                            text).group(1))
    assert threads % conccalc.K3_GROUP == 0
    assert "blockIdx.x) * THREADS + threadIdx.x" in text
    assert "(n + THREADS - 1) / THREADS" in whole
    assert "threadIdx.x & %du" % (conccalc.K3_GROUP - 1) in text
    assert "__match_any_sync(" in text and "__shfl_sync(" in text
    assert "__shared__" not in text
    assert "MAX_ROWS = 0x%Xll - 32;" % 0xFFFFFFFF in text
    assert conccalc.K3_MAX_ROWS == 0xFFFFFFFF - 32
    assert "rows > MAX_ROWS" in whole
    assert whole.count("atomicAdd(") == 1


def test_advance_args_struct_matches_the_source():
    """K4 and K11 take the one ``AdvanceArgs`` of their shared header."""
    for k in (_build.ADVANCE, _build.ADVANCE_ADAPTIVE):
        assert _build.CSRC / "advance_common.cuh" in k.sources()
        assert "struct AdvanceArgs" not in k.source.read_text()
    text = _strip_comments((_build.CSRC / "advance_common.cuh").read_text())
    body = re.search(r"struct\s+AdvanceArgs\s*\{(.*?)\};", text, re.S).group(1)
    c_types = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
               "uint32_t": ctypes.c_uint32, "float": ctypes.c_float,
               "const void*": ctypes.c_void_p}
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
    m = re.search(r"constexpr int MAX_SPECIES = (\d+);", text)
    assert int(m.group(1)) == advance.MAX_SPECIES
    counts = dict((n, c) for n, _, c in parsed)
    for f in advance.SPECIES_PARAMS:
        assert counts[f] == advance.MAX_SPECIES
    # the nests' windows, shapes and tables: MAX_NESTS of each; the CBL's
    # keys: two words for each of MAX_CBL_SUBSTEPS tags and tags 7 and 8
    m = re.search(r"constexpr int MAX_NESTS = (\d+);", text)
    assert int(m.group(1)) == advance.MAX_NESTS
    for f in advance.NEST_PARAMS + ("nest_nx", "nest_ny", "nest_xmax",
                                    "nest_ymax", "nest_rows", "nest_rows_e"):
        assert counts[f] == advance.MAX_NESTS, f
    m = re.search(r"constexpr int MAX_CBL_SUBSTEPS = (\d+);", text)
    assert int(m.group(1)) == advance.MAX_CBL_SUBSTEPS
    assert counts["key_cbl"] == 2 * advance.MAX_CBL_SUBSTEPS
    assert counts["key_fresh"] == 2 * len(advance.CBL_FRESH_TAGS)


def test_advance_polar_is_an_instantiation_of_its_own():
    """The polar-cap update is compiled only into the ``POLAR``
    instantiations of K4, at the predictor and at the corrector, and the
    launcher picks them by ``AdvanceArgs.polar``; the update calls the
    six functions of the plain version's torch ops.  K4's turbulence is a
    template int (0 HANNA1, 1 TS, 2 CBL), as K11's."""
    text = _all_sources(_build.ADVANCE)
    assert ("template <bool BF16, int TURB, bool POLAR, bool SETTLING, "
            "bool NESTS>") in text
    assert text.count("if (POLAR) polar_update(") == 2
    assert "if (POLAR) polar_update(a, x, y, dxsave, dysave," in text
    assert "if (POLAR) polar_update(a, xn, yn, du * dt, dv * dt," in text
    assert "a.polar" in text
    inst = re.findall(r"advance_kernel<(\w+), (\w+), (\w+), (\w+), (\w+)>",
                      text)
    assert len(set(inst)) == len(inst)
    # named: the four (table type, turbulence) instantiations of the stock
    # step with and without the caps, settling's two table types with and
    # without, the nests' (table type, settling) with and without, HANNA1
    # all but the stock step's TS and the turbswitch crosses' settling
    # ones (part 4)
    named = [i for i in inst if i[0] in ("true", "false")]
    assert len(named) == 24
    for polar in ("true", "false"):
        assert sum(i[2] == polar for i in named) == 12
    assert {i[1] for i in named} == {"HANNA1", "TS"}
    assert sum(i[1] == "TS" for i in named if "true" in (i[3], i[4])) == 4
    assert sum(i[4] == "true" for i in named) == 8
    # the turbswitch crosses' pick with nests (ts_nests): every (polar,
    # settling) for the table type its caller gives
    generic = [i for i in inst if i[0] == "B"]
    assert sorted(i[2:4] for i in generic) == [
        ("false", "false"), ("false", "true"), ("true", "false"),
        ("true", "true")]
    assert all(i[1] == "TS" and i[4] == "true" for i in generic)
    body = re.search(r"void polar_update\((.*?)\n}\n", text, re.S).group(1)
    for fn in ("sinf(", "cosf(", "tanf(", "hypotf(", "atanf(", "atan2f("):
        assert fn in body, fn
    assert "sincosf(" not in body and "__sinf(" not in body
    assert ("polar", ctypes.c_int) in advance.AdvanceArgs._fields_
    assert ("xlon0", ctypes.c_float) in advance.AdvanceArgs._fields_


def test_convection_level_limit_matches_the_source():
    """K6 refuses a grid whose profile levels its shared memory cannot hold,
    and the wrapper states the same limit.  The shared memory of a column
    (its profiles and one L1 x L1 tile at an odd row stride), the columns
    per block and the limit that the Python side states are the source's
    constants; the kernel carves exactly those profiles out of its shared
    memory; and for every L1 up to the limit a block of its columns fits
    in the 232,448 bytes a block may have."""
    text = _strip_comments(_build.CONVECTION.source.read_text())

    def const(name):
        m = re.search(r"constexpr\s+int\s+%s\s*=\s*(\d+)\s*;" % name, text)
        return int(m.group(1))

    assert const("MAX_LEVELS") == convection.K6_MAX_LEVELS == 128
    assert const("WARPS") == convection.K6_WARPS
    assert const("MAX_SHARED") == convection.BLOCK_SHARED_BYTES == 232448
    assert (const("NPROF"), const("NHALF")) == convection.K6_PROFILES
    assert "(NPROF * L1 + NHALF * (L1 + 1) + L1 * tile_stride(L1))" in text
    assert re.search(r"int tile_stride\(int L1\) \{ return L1 \| 1; \}", text)
    body = re.search(r"convection_kernel\(.*?\n}\n", text, re.S).group(0)
    assert len(re.findall(r"float\* \w+ = \w+ \+ L1;", body)) \
        == convection.K6_PROFILES[0]
    assert len(re.findall(r"float\* \w+ = \w+ \+ L1 \+ 1;", body)) \
        == convection.K6_PROFILES[1]
    assert "float* tile = uvz + L1 + 1;" in body
    assert "__syncthreads" not in text            # one warp per column
    for L1 in range(3, convection.K6_MAX_LEVELS + 1):
        per, cols = (convection.k6_shared_bytes(L1),
                     convection.k6_columns_per_block(L1))
        assert 1 <= cols <= convection.K6_WARPS, L1
        assert cols * per <= 232448 and per <= 227 * 1024, L1
    assert convection.k6_shared_bytes(26) == 5628
    assert convection.k6_columns_per_block(26) == 4
    assert convection.k6_columns_per_block(128) == 2
    assert "L1 > MAX_LEVELS" in text
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text


def test_layout_query_matches_the_source():
    """K6's layout query (shared bytes, columns per block, resident blocks
    per SM, registers) takes the ctypes arguments of ``_build.LAYOUT`` and
    launches nothing; K7 has none (no shared memory)."""
    text = _strip_comments(_kernel("convection").source.read_text())
    m = re.search(r'extern\s+"C"\s+int\s+fp_convection_layout\s*\((.*?)\)'
                  r'\s*\{(.*?)\n}', text, re.S)
    assert m
    assert [_c_kind(d.strip()) for d in m.group(1).split(",")] \
        == [KINDS[t] for t in _build.LAYOUT]
    assert "<<<" not in m.group(2)
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in m.group(2)
    assert "_layout" not in _kernel("redist").source.read_text()


@pytest.mark.parametrize("entry", ["fp_convection", "fp_convection_layout"])
def test_k6_shared_cap_is_set_in_one_place(entry):
    """Both K6 entry points raise the kernel's shared-memory cap through
    ``allow_shared``, which never sets it at or below the default 48 KB:
    a query at a small L1 cannot cap a later launch that needs more (the
    card's side of this is tests/test_torch_cuda.py)."""
    text = _strip_comments(_kernel("convection").source.read_text())
    assert text.count("cudaFuncSetAttribute") == 1
    helper = re.search(r"cudaError_t allow_shared\(size_t shmem\) \{(.*?)\n}",
                       text, re.S).group(1)
    assert "if (shmem <= 48 * 1024) return cudaSuccess;" in helper
    body = re.search(r'extern\s+"C"\s+int\s+%s\s*\(.*?\)\s*\{(.*?)\n}'
                     % entry, text, re.S).group(1)
    assert "allow_shared(shmem)" in body


def test_redist_rounds_half_to_even_and_draws_word_zero():
    """K7 rounds a position to its column as ``jnp.round``/``torch.round``
    do (``rintf``, never ``roundf``), and its uniform is ``fp::uniform24``
    of word 0 of the particle's Philox call at its global slot (``offset``
    + slot), as ``rng.uniforms_plain`` makes it; ``philox_normal.cuh``
    holds the one definition."""
    k7 = _kernel("redist")
    assert _build.CSRC / "philox_normal.cuh" in k7.sources()
    text = _strip_comments(k7.source.read_text())
    assert "rintf(" in text and "roundf(" not in text
    assert "fp::normal_words(w, k0, k1, offset + i, 0u);" in text
    assert "rn = fp::uniform24(w[0]);" in text
    header = _strip_comments((_build.CSRC / "philox_normal.cuh").read_text())
    assert re.search(r"uniform24\(uint32_t w\) \{\s*return "
                     r"static_cast<float>\(w >> 8\) \* "
                     r"5\.9604644775390625e-08f;", header)
    assert rng._2M24 == 5.9604644775390625e-08
    assert convection.REDIST_TAG == 1000000


def _struct_fields(text, name):
    """[(field, ctypes type)] of ``struct name { ... };`` in a source,
    declarations like ``float a, b;`` spread into their fields."""
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % name, text, re.S).group(1)
    c_types = {"int": ctypes.c_int, "float": ctypes.c_float}
    out = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        out += [(n.strip(), c_types[ctype]) for n in names.split(",")]
    return out


@pytest.mark.parametrize("kernel,struct,mirror", [
    ("wetdepo", "WetSpec", wetdepo.WetSpec),
    ("drydepo", "DrySpec", massupdate.DrySpec)])
def test_species_structs_match_the_sources(kernel, struct, mirror):
    """K9 and K10 copy MAX_SPECIES of these host structs into their
    parameters: the ctypes mirror must match field for field, and both
    sides must agree on MAX_SPECIES."""
    text = _strip_comments(_kernel(kernel).source.read_text())
    assert _struct_fields(text, struct) == list(mirror._fields_)
    m = re.search(r"constexpr int MAX_SPECIES = (\d+);", text)
    assert int(m.group(1)) == massupdate.MAX_SPECIES


def test_deposition_kernels_call_the_plain_versions_functions():
    """K9 and K10 call the accurate expf/powf/sqrtf that torch's
    elementwise kernels call on the card, never the fast intrinsics."""
    for name, calls in (("wetdepo", ("expf(", "powf(", "sqrtf(")),
                        ("drydepo", ("expf(",))):
        text = _strip_comments(_kernel(name).source.read_text())
        for c in calls:
            assert c in text, (name, c)
        assert not re.search(r"__(exp|pow|log|sqrt)f?\w*\(", text), name
    wet = _strip_comments(_build.WETDEPO.source.read_text())
    # the column of the cloud lookup is a truncation, not a floor
    assert "static_cast<int>(x)" in wet


def test_depo_scatter_rows_corners_and_limits_match_the_wrapper():
    """K8 matches the lanes of a warp on the 32-bit grid row, refuses a grid
    of more rows than ``K8_MAX_ROWS`` (K3's limit), takes the reference's
    corners and weights in its order, and takes at most the wrapper's
    ``MAX_SPECIES`` species (its tables in shared memory hold nspec values
    a row); the key of a free slot and of a lane without a pair lies above
    every row.  The row limit and the keys are in ``warp_groups.cuh``, the
    header that K8, K16 and K17 include."""
    assert _build.CSRC / "warp_groups.cuh" in _build.DEPO_SCATTER.sources()
    text = _all_sources(_build.DEPO_SCATTER)
    assert "__match_any_sync(FULL, valid ? row : EMPTY)" in text
    assert "const unsigned row = static_cast<unsigned>(lin);" in text
    m = re.search(r"MAX_ROWS = (0x[0-9A-F]+)ll - (\d+);", text)
    assert int(m.group(1), 16) - int(m.group(2)) == wetdepo.K8_MAX_ROWS \
        == conccalc.K3_MAX_ROWS
    assert "rows > MAX_ROWS" in text
    assert "constexpr unsigned EMPTY = 0xFFFFFFFFu;" in text
    assert wetdepo.K8_MAX_ROWS < 0xFFFFFFFF
    m = re.search(r"constexpr int MAX_SPECIES = (\d+);", text)
    assert int(m.group(1)) == massupdate.MAX_SPECIES == wetdepo.MAX_SPECIES
    # corner j takes ixp where hx and jyp where hy, and the other weight
    hx = re.search(r"const bool hx = j == (\d) \|\| j == (\d);", text)
    hy = re.search(r"const bool hy = j == (\d) \|\| j == (\d);", text)
    assert "const int cx = hx ? ixp : ix;" in text
    assert "const int cy = hy ? jyp : jy;" in text
    assert "const float wj = (hx ? 1.0f - wx : wx) * (hy ? 1.0f - wy : wy);" \
        in text
    corners = [("ixp" if str(j) in hx.groups() else "ix",
                "jyp" if str(j) in hy.groups() else "jy") for j in range(4)]
    assert corners == [("ix", "jy"), ("ixp", "jyp"), ("ixp", "jy"),
                       ("ix", "jyp")]
    assert "for (int j = 0; j < 4; ++j)" in text


def _kernel_level(height, z):
    """K9's level search, step for step: torch.searchsorted's binary search
    (right=True) on the card, then the clamp of ``vert_weights``."""
    lo, hi = 0, len(height)
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if not height[mid] > z:
            lo = mid + 1
        else:
            hi = mid
    return min(max(lo - 1, 0), len(height) - 2)


def test_wetdepo_level_search_is_the_plain_versions():
    """K9 finds the level below z by the same binary search as
    ``torch.searchsorted(height, z, right=True)`` and clamps it as
    ``interp.vert_weights`` does: the same level for ascending heights and
    for z below, above, on and between the levels and NaN."""
    text = _strip_comments(_build.WETDEPO.source.read_text())
    assert "int lo = 0, hi = c.nz;" in text
    assert "const int mid = lo + ((hi - lo) >> 1);" in text
    assert "if (!(in.height[mid] > z)) lo = mid + 1; else hi = mid;" in text
    assert "hz = hz < 0 ? 0 : (hz > c.nz - 2 ? c.nz - 2 : hz);" in text
    rs = np.random.default_rng(3)
    for nz in (2, 3, 15, 30):
        height = np.concatenate([[0.0], np.cumsum(rs.uniform(5, 500, nz - 1))]
                                ).astype(np.float32)
        z = np.concatenate([rs.uniform(-10.0, height[-1] + 100.0, 200),
                            height, [np.nan, -np.inf, np.inf]]
                           ).astype(np.float32)
        want, _ = interp.vert_weights(torch.as_tensor(z),
                                      torch.as_tensor(height))
        got = [_kernel_level(height, v) for v in z]
        assert got == want.tolist()


def test_wetdepo_light_path_is_the_plain_value_without_lambda():
    """A particle K9 does not scavenge takes the light path: the removed
    mass is ``(m * 0.0f) * grf``, the plain chain's value with lambda = 0,
    bit for bit, also for a negative, infinite or NaN mass and a NaN or
    infinite fraction; the rest and the deposit follow as in the plain
    chain."""
    text = _strip_comments(_build.WETDEPO.source.read_text())
    assert text.count("(m * 0.0f) * grf") == 2
    vals = np.float32([0.0, -0.0, 1e-30, 0.5, 3.0, -2.0, np.inf, -np.inf,
                       np.nan, 1e38])
    m, grf = (torch.as_tensor(a.ravel()) for a in np.meshgrid(
        vals, np.float32([0.05, 0.7, 1.0, np.nan, np.inf, 20.0])))
    n = m.numel()
    p = state.empty_particles(n, 1, device="cpu").replace(
        mass=m[:, None].clone(), active=torch.ones(n, dtype=torch.bool))
    sp = massupdate.MassSpecies(decay=(0.0,), drydep=(False,))
    q, dep = massupdate.apply_wetdepo_plain(
        p, torch.zeros((1, n)), grf, 900, 2700, sp)
    light = (m * 0.0) * grf
    rest = m - light
    kept = torch.where(rest > massupdate.TINY, rest, torch.zeros_like(rest))
    assert torch.equal(q.mass[:, 0].view(torch.int32), kept.view(torch.int32))
    assert torch.equal(dep[0].view(torch.int32), (light * 1.0).view(torch.int32))


def test_sass_paths_counts_each_function_from_the_symbol_table():
    """K9's operation count reads the compiled kernel: the kernel's own code
    up to its first function, each named function's byte range from the
    cubin's symbol table, NOPs aside; the toolkit's slow paths in none."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    elf = """.section .symtab
 index           value           size      info    other  shndx    name
   0               0               0        0        0      0     (null)
 0x1               0           0x100      0x2     0x10    0xa     _Z6kernelv
 0x7            0x60            0x30      0x2        0    0xa     $_Z6kernelv$_ZN2ns13lam_below_gasEfff
 0x8            0x90            0x20     0x22        0    0xa     $__internal_0_$__cuda_sm20_rcp_rn_f32_slowpath
"""
    ops = ["MOV R1, c[0x0][0x28]", "@!P0 BRA 0x50", "FADD R2, R3, R4",
           "NOP", "CALL.REL.NOINC 0x60", "EXIT",
           "FMUL R2, R2, R5", "@P1 MUFU.EX2 R2, R2", "RET.REL.NODEC R4 0x0",
           "FFMA R2, R2, R3, R4", "RET.REL.NODEC R4 0x0"]
    sass = "\n".join("        /*%04x*/                   %s ;  /* 0x0 */"
                      % (16 * i, op) for i, op in enumerate(ops))

    class Kernel:
        name = "k"

        def cuobjdump(self, flag):
            return elf if flag == "-elf" else sass

    assert chip_smoke.sass_paths(Kernel(), ("lam_below_gas",)) == {
        "kernel": 5, "lam_below_gas": 3}
    with pytest.raises(AssertionError, match="cloud_water"):
        chip_smoke.sass_paths(Kernel(), ("cloud_water",))


def test_function_paths_take_the_cheapest_way_to_a_ret():
    """K11 CBL's skewed calls are charged the cheapest path through each
    function of the run's instantiation: from the function's first byte
    (the cubin's symbol table) to the nearest RET it reaches, a branch of
    the data on its cheaper side, a CALL one instruction; its static
    instructions (NOPs aside), its stores and loads of local memory (none
    here) and CALLs beside it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    entry = "_Z23advance_adaptive_kernelILb1ELi2ELb1ELb1EEvv"
    elf = f""".section .symtab
 index           value           size      info    other  shndx    name
 0x1               0            0x40      0x2     0x10    0xa     {entry}
 0x7            0x40            0x70      0x2        0    0xa     ${entry}$_ZN2fp8cbl_skewEff
"""
    ops = ["MOV R1, c[0x0][0x28]", "CALL.REL.NOINC 0x40", "EXIT", "NOP",
           "FMUL R2, R2, R5",            # 0x40: cbl_skew
           "@P0 BRA 0x90",               # a branch of the data
           "CALL.REL.NOINC 0x200",       # the dearer side
           "FADD R2, R2, R3", "RET.REL.NODEC R4 0x0",
           "FFMA R2, R2, R3, R4",        # 0x90: the cheaper side
           "RET.REL.NODEC R4 0x0"]

    class Kernel:
        name = "advance_adaptive"

        def cuobjdump(self, flag):
            return elf if flag == "-elf" else _sass_function(entry, ops)

    flags = (True, 2, True, True)
    assert chip_smoke.function_paths(Kernel(), "advance_adaptive_kernel",
                                     flags, ("cbl_skew",)) == {
        "cbl_skew": {"cheapest": 4, "static": 7, "local_memory": 0,
                     "calls": 1}}
    with pytest.raises(AssertionError, match="cbl_fresh_wp"):
        chip_smoke.function_paths(Kernel(), "advance_adaptive_kernel", flags,
                                  ("cbl_fresh_wp",))


def _sass_function(name, ops):
    lines = ["\t\tFunction : %s" % name]
    lines += ["        /*%04x*/                   %s ;  /* 0x0 */"
              % (16 * i, op) for i, op in enumerate(ops)]
    return "\n".join(lines)


_K11_OPS = ["MOV R1, c[0x0][0x28]", "S2R R0, SR_TID.X",
            "BAR.SYNC.DEFER_BLOCKING 0x0",   # 0x20: the loop of iterations
            "VOTE.ANY R2, PT, P0",      # the particles still in the loop
            "BAR.SYNC.DEFER_BLOCKING 0x0",
            "@P1 BRA 0x270",            # none left: to the ends
            "@P2 BRA 0x80",             # a branch of the dealing
            "STS.U16 [R3], R0",         # the order
            "BAR.SYNC.DEFER_BLOCKING 0x0",
            "@!P3 VIADD R9, R9, 0x1",   # thread 0's sums
            "@P4 BRA 0x250",            # a thread past the count: no pass
            "LDS.U16 R8, [R8]",         # 0xb0, the pass body: order[t]
            "PRMT R8, R8, 0x9910, RZ",
            "IMAD R6, R8, 0x4, R7",     # the slot's row in the pool
            "LDS R10, [R6]",            # its first word
            "LDS R12, [R13+0x4]",       # a height
            "LDS R11, [R6+0x400]",      # its second word
            "BRA.DIV UR4, 0x290",       # taken only by a diverged warp
            "@P6 BRA 0x140",            # a branch of the data
            "FMUL R10, R10, R11",
            "FADD R10, R10, R11",       # 0x140: the substep loop
            "@P0 BRA 0x1d0",            # the last substep leaves it
            "MUFU.EX2 R4, R4", "FMUL R4, R4, R2",
            "@P1 BRA 0x1a0",            # a branch of the data
            "FADD R4, R4, R2",
            "FMUL R4, R4, R4", "NOP",
            "BRA 0x140",                # 0x1c0: the substeps' back edge
            "FADD R5, R5, R3",
            "MOV R6, R12",              # no longer the slot's row
            "LDS R15, [R6]",            # a height
            "LEA R16, R8, R7, 0x2",
            "STS [R16], R10",           # the words a pass changes
            "STS [R16+0x400], R5",
            "STS.U8 [R8+UR5], R4",      # in the loop or not
            "NOP", "BSYNC B0",
            "BRA 0x20",                 # 0x260: the loop's back edge
            "REDG.E.ADD.STRONG.GPU [R4.64], R5",   # the ends, the counts
            "EXIT",
            "WARPSYNC.COLLECTIVE R22, 0x2c0",   # 0x290: a slow path
            "VOTE.ANY R2, PT, P4", "ENDCOLLECTIVE",
            "BRA 0x10"]                 # 0x2c0: wider than the loop
_K11_OTHER = ["MOV R1, c[0x0][0x28]", "BRA 0x0", "EXIT"]
_K11_PRE = "_ZN52_GLOBAL__N__x_advance_adaptive_cu_y23advance_adaptive_kernel"


def _k11_sass(ops):
    """A K11 library of two instantiations: a stock one (_K11_OTHER) and
    the one the tests read (``ops``)."""
    return "\n".join([
        _sass_function(_K11_PRE + "ILb1ELb0ELb1ELb1EEvN_2IoEPiPyN_11Advance"
                       "ArgsE", _K11_OTHER),
        _sass_function(_K11_PRE + "ILb1ELb1ELb1ELb1EEvN_2IoEPiPyN_11Advance"
                       "ArgsE", ops)])


class _K11Kernel:
    name = "advance_adaptive"
    sass = _k11_sass(_K11_OPS)

    def cuobjdump(self, flag):
        return self.sass


def test_k11_instructions_count_the_cheapest_pass():
    """K11's operations per pass read the instantiation a run takes: the
    widest backward branch of the kernel's body (a vote's slow path after
    the EXIT is not one) is the loop of iterations, the widest loop inside
    it the substep loop; after the dealing of the particles (a ballot, the
    block's last barrier) a branch takes a thread past the count over the
    pass, and the pass body opens after it; a pass is the cheapest path
    from there to the substep loop's head, on through it by its exit (the
    last substep) to the loop's back edge, plus ifine - 1 times the
    substep loop's cheapest body; NOPs aside, each branch of the data on
    its cheaper side, a BRA.DIV falling through.  Neither the dealing nor
    the pool's moves count: the load of order[t], the loads and stores
    addressed from the slot it gives, the store of the in-loop flag; a
    load of the heights does, also from a register that held the slot's
    address before it was written anew."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    ops, Kernel, sass_of = _K11_OPS, _K11Kernel, _k11_sass
    flags = (True, True, True, True)
    _, code = chip_smoke.sass_instantiation(
        Kernel(), "advance_adaptive_kernel", flags)
    assert [c[2] for c in code if c[0] in (0x50, 0x110, 0x260)] == [
        True, True, False]              # BRA.DIV falls through
    pool = chip_smoke.k11_pool_traffic(code, 0xb0, 0x260)
    assert sorted(pool["addresses"]) == [0xb0, 0xe0, 0x100, 0x210, 0x220,
                                         0x230]
    assert (pool["stored"], pool["loaded"]) == ([0, 1], [0, 1])
    got = chip_smoke.k11_instructions(Kernel(), flags, 4)
    assert (got["kernel"], got["iteration_loop"], got["dealing"],
            got["pass_body"], got["substep_loop"]) == (43, 35, 9, 26, 8)
    assert (got["pool_moves_in_pass_body"], got["pool_words_stored"],
            got["pool_words_loaded"], got["calls_in_pass_body"]) == (
        6, 2, 2, 0)
    assert (got["substep_cheapest"], got["substep_dearest"]) == (7, 8)
    assert got["per_pass_cheapest"] == (6 + 8 - 1) + 3 * 7
    assert got["per_pass_cheapest_with_pool_moves"] == (9 + 11 - 1) + 3 * 7
    assert got["per_pass_dearest"] == (7 + 8 - 1) + 3 * 8
    assert got["per_pass_dearest_with_pool_moves"] == (10 + 11 - 1) + 3 * 8
    with pytest.raises(AssertionError, match="Lb0ELb0E"):
        chip_smoke.k11_instructions(Kernel(), (True, False, False, True), 4)
    # a store of the slot off a row of the pool is not the pool's
    k = Kernel()
    k.sass = sass_of([o.replace("[R16+0x400]", "[R16+0x404]") for o in ops])
    with pytest.raises(AssertionError, match="off a row"):
        chip_smoke.k11_instructions(k, flags, 4)

    # without the ballot no particle is dealt before the pass body
    k.sass = sass_of([o.replace("VOTE.ANY R2, PT, P0", "MOV R2, R0")
                      for o in ops])
    with pytest.raises(AssertionError, match="no ballot"):
        chip_smoke.k11_instructions(k, flags, 4)
    # without the branch past the pass no thread skips it
    k.sass = sass_of([o.replace("@P4 BRA 0x250", "MOV R9, R9") for o in ops])
    with pytest.raises(AssertionError, match="past the pass body"):
        chip_smoke.k11_instructions(k, flags, 4)


def test_k11_instructions_leave_the_stack_out():
    """The stores and loads of local memory in K11's pass body (STL, LDL:
    the registers the compiler spills to the stack and reloads) count on
    a pass's paths as NOPs do, as the pool's moves do not count, and are
    reported beside them: a spill in the substep loop and its reload after
    the substeps read the same per-pass counts as NOPs there."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    spilled = list(_K11_OPS)
    assert spilled[27] == spilled[36] == "NOP"
    spilled[27] = "STL [R1+0x8], R4"     # 0x1b0: in the substep loop
    spilled[36] = "LDL R4, [R1+0x8]"     # 0x240: after the substeps
    k = _K11Kernel()
    k.sass = _k11_sass(spilled)
    flags = (True, True, True, True)
    base = chip_smoke.k11_instructions(_K11Kernel(), flags, 4)
    got = chip_smoke.k11_instructions(k, flags, 4)
    assert (base["local_memory_in_pass_body"],
            got["local_memory_in_pass_body"]) == (0, 2)
    assert (got["pass_body"], got["substep_loop"]) == (
        base["pass_body"] + 2, base["substep_loop"] + 1)
    for key in ("per_pass_cheapest", "per_pass_dearest",
                "per_pass_cheapest_with_pool_moves",
                "per_pass_dearest_with_pool_moves", "substep_cheapest",
                "substep_dearest"):
        assert got[key] == base[key], key


def test_k11_work_counters_and_pool_match_the_source():
    """K11's counters: the wrapper zeroes K11_WORK_WORDS int64 words, which
    the kernel takes as ``unsigned long long* work`` after the counts and
    indexes 0 (passes executed), 1 (lane iterations issued) and 2 (the
    CBL's passes with a NaN redraw); StepDiag.lane_work is all three, and
    the third is its nan_count.  The pool's two field lists name every
    field of a Lane but its slot index once (the compiler holds the count
    by the size of a Lane and refuses a field named twice), a pass stores
    the first list back, and the block's order indexes fit a short."""
    text = _strip_comments(_build.ADVANCE_ADAPTIVE.source.read_text())
    sig = re.search(r'extern\s+"C"\s+int\s+fp_advance_adaptive\s*\((.*?)\)',
                    text, re.S).group(1)
    decls = [d.strip() for d in sig.split(",")]
    at = decls.index("int* counts")
    assert decls[at + 1] == "unsigned long long* work"
    assert advance.K11_WORK_WORDS == 3
    used = {int(k) for k in re.findall(r"work\[(\d)\]", text)}
    assert used == set(range(advance.K11_WORK_WORDS))
    threads = int(re.search(r"constexpr int THREADS = (\d+);", text)[1])
    assert threads % 32 == 0 and threads <= 1024
    assert "short order[THREADS]" in text

    def fields(macro):
        body = re.search(r"#define %s\(X\)(.*?)\n(?!\s*X\()" % macro,
                         text.replace("\\\n", "\n"), re.S).group(1)
        return re.findall(r"X\(\w+, ([\w.\[\]]+)\)", body)

    members = []
    lane = re.search(r"struct Lane \{(.*?)\};", text, re.S).group(1)
    nested = {"Horiz": ["ix", "jy"] + [f"p4[{q}]" for q in range(4)],
              "Settle": ["col", "sp"]}
    for typ, names in re.findall(r"(\w+) ([\w, ]+);", lane):
        for nm in (n.strip() for n in names.split(",")):
            members += ([f"{nm}.{f}" for f in nested[typ]] if typ in nested
                        else [nm])
    pass_fields, held = fields("PASS_FIELDS"), fields("HELD_FIELDS")
    assert len(pass_fields) == 16
    assert sorted(pass_fields + held) == sorted(
        m for m in members if m != "i")
    for fn, lists in (("store_pass", ["PASS_FIELDS"]),
                      ("store_lane", ["HELD_FIELDS"]),
                      ("load_lane", ["PASS_FIELDS", "HELD_FIELDS"])):
        body = re.search(r"void %s\(.*?\n}\n" % fn, text, re.S).group(0)
        assert re.findall(r"([A-Z_]+_FIELDS)\(POOL_(?:PUT|GET)\)", body) \
            == lists
    assert "getenv" not in text


def test_settling_instructions_are_the_instantiations_difference():
    """Settling's instructions in K4: the SETTLING instantiation's beyond
    the stock one of the same table type and polar flag, NOPs aside."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    pre = "_ZN52_GLOBAL__N__x_advance_cu_y14advance_kernel"
    sass = "\n".join([
        _sass_function(pre + "ILb1ELi0ELb1ELb0ELb0EEvN_3PInE",
                       ["MOV R1, R2", "NOP", "EXIT"]),
        _sass_function(pre + "ILb1ELi0ELb1ELb1ELb0EEvN_3PInE",
                       ["MOV R1, R2", "MUFU.LG2 R3, R3", "FMUL R3, R3, R4",
                        "NOP", "EXIT"]),
        _sass_function(pre + "ILb0ELi0ELb1ELb1ELb0EEvN_3PInE",
                       ["MOV R1, R2", "EXIT"]),
        _sass_function(pre + "ILb1ELi0ELb1ELb1ELb1EEvN_3PInE",
                       ["MOV R1, R2", "LDG R3, [R4]", "EXIT"])])

    class Kernel:
        name = "advance"

        def cuobjdump(self, flag):
            return sass

    assert chip_smoke.settling_instructions(Kernel(), True, True) == {
        "stock": 2, "settling": 4, "per_particle": 2}


def _write_options(d, rs):
    """IGBP_int1.dat, surfdata.t and surfdepo.t in FLEXPART's formats."""
    raw = rs.integers(0, 256, (1200, 600, 3)).astype(np.uint8)
    raw[:5] = 0                               # cells without inventory
    raw.tofile(d / "IGBP_int1.dat")
    lines = ["surface data: roughness length per landuse class"] * 4
    for k in range(13):
        lines.append(f"{'class %d' % (k + 1):<45}{rs.uniform(0.001, 1.5):.4f}")
    (d / "surfdata.t").write_text("\n".join(lines) + "\n")
    lines = [f"header line {k}" for k in range(16)]
    for season in range(5):
        lines.append(f"season {season + 1}")
        for row in ("ri", "rluh", "rac", "rgssh", "rgsoh", "rclsh", "rcloh"):
            vals = rs.uniform(1.0, 5000.0, 13).round()
            vals[rs.uniform(size=13) < 0.2] = 9999.0
            lines.append(f"{row:<8}" + "".join(f"{v:8.0f}." for v in vals))
    (d / "surfdepo.t").write_text("\n".join(lines) + "\n")


def test_setup_drydep_reads_flexpart_files_like_jax(tmp_path):
    from flexpart_tpu.config import Species
    from flexpart_tpu.met import make_grid
    from flexpart_tpu.physics import setup_drydep as jax_setup_drydep
    from flexpart_tpu_torch import physics
    rs = np.random.default_rng(4)
    _write_options(tmp_path, rs)
    grid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    species = (Species(name="SO2", reldiff=1.9, henry=1.0e5, f0=0.1),
               Species(name="AERO", density=2500.0, dquer=0.8, dsigma=1.8),
               Species(name="CONST", dryvel=0.004))
    lsm = (rs.uniform(size=(19, 37)) < 0.4).astype(np.float32)
    j = jax_setup_drydep(tmp_path, grid, species, lsm, 715)
    t = physics.setup_drydep(tmp_path, grid, species, lsm, 715)
    assert type(t).__module__ == "flexpart_tpu_torch.physics.drydepo"
    for f in j.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    # the files were read: infinite resistances, several classes a cell
    assert (t.rac == 1.0e25).any() and (t.xlanduse > 0).sum(-1).max() > 1
    assert not hasattr(physics, "wetdepo") or isinstance(
        physics.wetdepo, type(physics))      # a submodule, never shadowed


def test_k11_entry_names_the_turbulence_by_int():
    """K11's second template argument is the turbulence as an int (0
    Hanna1, 1 TS, 2 CBL): chip_smoke.k11_entry gives it from the config,
    sass_instantiation mangles it as an int and ptxas_by_entry names the
    CBL instantiation advance_adaptive_kernel<1,2,1,1>."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    base = dict(nx=10, ny=10, nz=5, xglobal=True, ldirect=1, ifine=11,
                method=1, settling=True, polar=True)
    cbl = advance.StepConfig(turbswitch=True, cblflag=True, **base)
    ts = advance.StepConfig(turbswitch=True, **base)
    assert chip_smoke.k11_entry(cbl) == (True, 2, True, True)
    assert chip_smoke.k11_entry(ts) == (True, 1, True, True)
    pre = "_ZN52_GLOBAL__N__x_advance_adaptive_cu_y23advance_adaptive_kernel"
    sass = "\n".join([
        _sass_function(pre + "ILb1ELi1ELb1ELb1EEvN_2IoE", ["EXIT"]),
        _sass_function(pre + "ILb1ELi2ELb1ELb1EEvN_2IoE",
                       ["MOV R1, R2", "EXIT"])])

    class Kernel:
        name = "advance_adaptive"

        def cuobjdump(self, flag):
            return sass

    name, code = chip_smoke.sass_instantiation(
        Kernel(), "advance_adaptive_kernel", chip_smoke.k11_entry(cbl))
    assert "ILb1ELi2ELb1ELb1E" in name and len(code) == 2
    log = ("ptxas info    : Compiling entry function '%sILb1ELi2ELb1ELb1EEv"
           "N_2IoE' for 'sm_90a'\nptxas info    : Function properties for "
           "%sILb1ELi2ELb1ELb1EEvN_2IoE\n    160 bytes stack frame, 82 bytes "
           "spill stores, 84 bytes spill loads\nptxas info    : Used 80 "
           "registers" % (pre, pre))
    assert chip_smoke.ptxas_by_entry(log) == {
        "advance_adaptive_kernel<1,2,1,1>": dict(
            stack=160, spill_stores=82, spill_loads=84, registers=80)}


@pytest.mark.parametrize("name", ["advance", "advance_adaptive"])
def test_parted_kernels_build_each_part_apart(name, tmp_path, monkeypatch):
    """K4 and K11 are built as libraries of parts, one nvcc each with
    -DFP_PART=<k>: the stock instantiations on f32 tables (0), on bf16
    tables (1), the nests' (K4) or the CBL's (K11) (2), and the tile's
    (K4: 3; K11: 3 on f32 tables, 4 on bf16 tables, 5 its CBL), and K4's
    crosses: TS with settling or nests (4), TS on a tile (5), the CBL (6),
    the CBL with nests (7) and on a tile (8), named apart; the
    source's launcher returns the wrapper's NOT_IN_PART for the other
    parts' configurations, each part's instantiations inside its own
    preprocessor guard."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")    # none on the CPU
    k = _kernel(name)
    assert k.parts == (9 if name == "advance" else 6)
    cmds = [k._compile_cmd(tmp_path / "x.so", part)
            for part in range(k.parts)]
    assert [c.count(f"-DFP_PART={p}") for p, c in enumerate(cmds)] == \
        [1] * k.parts
    names = {k._lib_path(part).name for part in range(k.parts)}
    assert len(names) == k.parts and all(f"lib{name}-p" in n for n in names)
    text = _strip_comments(k.source.read_text())
    m = re.search(r"constexpr int NOT_IN_PART = (-?\d+);", text)
    assert int(m.group(1)) == _build.NOT_IN_PART
    assert "#define FP_PART -1" in text
    assert "#define FP_HAS(part) (FP_PART < 0 || FP_PART == (part))" in text
    launcher = text[text.index(f'extern "C" int {k.symbol}('):]
    if name == "advance":
        # K4 CBL's parts (6-8) are picked by with_cbl, which the launcher
        # calls, before it
        launcher = text[text.index("int with_cbl("):]
    guarded = [launcher.split(f"#if FP_HAS({part})")[1].split("#else")[0]
               for part in range(k.parts)]
    assert all(("by(" if name == "advance" and part >= 6 else "launch(") in g
               for part, g in enumerate(guarded))
    if name == "advance":
        assert all("advance_kernel<" in g for g in guarded[:3])
        assert "true>" in guarded[2] and "true>" not in "".join(guarded[:2])
        assert "advance_tile_kernel<" in guarded[3]
        assert "advance_tile_kernel<" not in "".join(guarded[:3])
        assert all("HANNA1" in g for g in guarded[:4])
        assert "launch(ts_nests(Yes{}))" in guarded[4]
        assert "TS, true, true, false>" in launcher.split(
            "#if FP_HAS(4)")[2].split("#else")[0]
        assert "launch(ts_tile(Yes{}))" in guarded[5]
        assert "by(Yes{}, No{}, No{})" in guarded[6]
        assert "by(Yes{}, Yes{}, No{})" in guarded[7]
        assert "by(Yes{}, No{}, Yes{})" in guarded[8]
        assert "by(" not in "".join(guarded[:6])
        assert "return with_cbl(a, [&](auto k) -> int {" in launcher
    else:
        assert "Cbl{}" in guarded[2]
        assert "std::false_type" in guarded[0] and "true_type" in guarded[1]
        assert "tile_by_turb(std::false_type{})" in guarded[3]
        assert "tile_by_turb(std::true_type{})" in guarded[4]
        assert "pick_tile(std::true_type{}, Cbl{})" in guarded[5]
        assert "pick_tile(std::false_type{}, Cbl{})" in guarded[5]
    for other in _build.KERNELS:
        assert other.parts == {"advance": 9, "advance_adaptive": 6}.get(
            other.name, 1)


def test_a_parted_launch_goes_to_the_part_that_holds_it():
    """``Kernel.launch`` tries the parts in order and stops at the first
    that does not answer NOT_IN_PART; a failure of that part raises, and
    one count is taken per launch."""
    k = _build.Kernel("x", "fp_x", [], parts=2)
    calls = []

    def part(i, rc):
        return lambda *a: (calls.append(i), rc)[1]

    k._fns = [part(0, _build.NOT_IN_PART), part(1, 0)]
    k._fn = k._fns[0]
    k(1, 2)
    assert calls == [0, 1] and k.launches == 1
    k._fns = [part(0, 0), part(1, 0)]
    calls.clear()
    k(1, 2)
    assert calls == [0] and k.launches == 2
    k._fns = [part(0, _build.NOT_IN_PART), part(1, 700)]
    with pytest.raises(RuntimeError, match="cudaError 700"):
        k(1, 2)
    assert k.launches == 2


def test_boundary_receptor_flux_constants_match_the_sources():
    """What the boundary (K14), receptor (K15) and flux (K16) kernels share
    with their Python sides: the emission rounds, the tile of the origin
    scans (K13's and K14's header), the met field planes they read, the
    receptor limits, the candidate faces per direction."""
    from flexpart_tpu_torch.core import domainfill, origin_rank
    from flexpart_tpu_torch.grid import fluxes, receptors
    from flexpart_tpu_torch.met import fields

    def const(kernel, name):
        text = _all_sources(_kernel(kernel))
        m = re.search(r"constexpr (?:int|float) %s = ([^;,]+)[;,]" % name,
                      text)
        assert m, (kernel, name)
        return m.group(1).strip()

    assert int(const("domainfill", "KMAX_EMIT")) == domainfill.KMAX_EMIT
    for kernel in ("domainfill", "split"):
        assert _build.CSRC / "origin_rank.cuh" in _kernel(kernel).sources()
        assert int(const(kernel, "RANK_THREADS")) \
            == origin_rank.RANK_THREADS
        assert int(const(kernel, "RANK_ITEMS")) == origin_rank.RANK_ITEMS
        assert const(kernel, "RANK_TILE_WORDS") \
            == "RANK_THREADS * RANK_ITEMS"
        # the slot launches' blocks, which size the slot-order bitmap
        assert int(const(kernel, "THREADS")) == origin_rank.RANK_THREADS
    for plane in ("F3_U", "F3_V", "F3_RHO", "F3_PV"):
        text = _strip_comments(_kernel("domainfill").source.read_text())
        assert f"{plane} = {getattr(fields, plane)}" in text, plane
    assert float(const("domainfill", "PVCRIT").rstrip("f")) \
        == domainfill.PVCRIT
    assert float(const("domainfill", "OZONESCALE").rstrip("f")) \
        == domainfill.OZONESCALE
    assert int(const("receptors", "MAX_RECEPTORS")) \
        == receptors.MAX_RECEPTORS
    assert int(const("receptors", "MAX_VALUES")) \
        == receptors.MAX_RECEPTOR_VALUES
    assert int(const("receptors", "THREADS")) == receptors.THREADS
    assert int(const("receptors", "REDUCE_THREADS")) == receptors.THREADS
    assert float(const("receptors", "EPANECHNIKOV").rstrip("f")) \
        == receptors.EPANECHNIKOV
    assert float(const("receptors", "HZMAX").rstrip("f")) \
        == receptors.HZMAX
    assert int(const("fluxes", "MAX_SPAN")) == fluxes.MAX_SPAN
    # K16 groups the lanes of a warp by their 32-bit flux row, K8's helpers
    flux_text = _all_sources(_build.FLUXES)
    assert _build.CSRC / "warp_groups.cuh" in _build.FLUXES.sources()
    assert "__match_any_sync(FULL, valid ? row : EMPTY)" in flux_text
    m = re.search(r"MAX_ROWS = (0x[0-9A-F]+)ll - (\d+);", flux_text)
    assert int(m.group(1), 16) - int(m.group(2)) == fluxes.K16_MAX_ROWS


def test_k11_cbl_blocks_and_pass_rows_match_the_source():
    """K11's blocks per SM: the source's THREADS, MIN_BLOCKS (the stock
    instantiations') and MIN_BLOCKS_CBL (the CBL's, 4) are what
    chip_smoke.k11_blocks reads, from which k11_cbl_layout makes the
    register cap it checks, and the CBL takes its own launch bound.  A CBL
    pass (lane_pass_cbl) writes to the pool exactly the rows of
    PASS_FIELDS, the first ones, as a stock pass stores them back: the
    pool keeps NWORDS words a particle, no row of its own for the CBL, and
    chip_smoke's pool-traffic reader finds the pass's stores on the first
    rows."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    text = _strip_comments(_build.ADVANCE_ADAPTIVE.source.read_text())
    shape = chip_smoke.k11_blocks(_build.ADVANCE_ADAPTIVE)
    assert shape == {"THREADS": 256, "MIN_BLOCKS": 4, "MIN_BLOCKS_CBL": 4}
    for name in shape:
        assert len(re.findall(r"constexpr int %s = (\d+);" % name,
                              text)) == 1
    assert "__launch_bounds__(THREADS" in text
    assert "TURB == CBL ? MIN_BLOCKS_CBL : MIN_BLOCKS" in text
    body = re.search(r"bool lane_pass_cbl\(.*?\n}\n", text, re.S).group(0)
    flat = text.replace("\\\n", "\n")
    pass_rows = re.findall(r"X\((\w+), ", re.search(
        r"#define PASS_FIELDS\(X\)(.*?)\n(?!\s*X\()", flat, re.S).group(1))
    stored = set(re.findall(r"put\(s, ROW_(\w+), p,", body))
    assert stored == set(pass_rows)
    loaded = set(re.findall(r"get\(s, ROW_(\w+), p,", body))
    held = re.findall(r"X\((\w+), ", re.search(
        r"#define HELD_FIELDS\(X\)(.*?)\n(?!\s*X\()", flat, re.S).group(1))
    assert loaded <= set(pass_rows) | set(held)
    # the CBL's pass runs its own substeps, with the column hoisted
    assert "skew_column(h, wst, ol)" in body and "cbl_substeps(" in body


def test_cbl_skewed_substep_is_inlined_and_a_call_only_in_the_calls_build():
    """The skewed substep (cbl_skewed_wp) is inlined into the CBL's
    substep loop unless FP_CBL_CALLS is set, and the fresh draw
    (cbl_fresh_wp) is a call in every build; the bound reads both from
    chip_smoke.cbl_calls_build, the CBL part (FP_PART 2) built with
    FP_CBL_CALLS=1; the bi-Gaussian parameters (cbl_skew) are inlined into
    both, the column's part (skew_column) computed once a pass."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    common = _strip_comments(
        (_build.CSRC / "advance_common.cuh").read_text())
    assert re.search(r"#if defined\(FP_CBL_CALLS\) && FP_CBL_CALLS\s*\n"
                     r"#define FP_CBL_SUBSTEP __noinline__\s*\n#else\s*\n"
                     r"#define FP_CBL_SUBSTEP __forceinline__", common)
    assert "__device__ FP_CBL_SUBSTEP float cbl_skewed_wp(" in common
    assert "__device__ __noinline__ float cbl_fresh_wp(" in common
    assert "__device__ __forceinline__ Skew cbl_skew(" in common
    assert "__device__ __forceinline__ SkewColumn skew_column(" in common
    k = chip_smoke.cbl_calls_build()
    assert k is chip_smoke.cbl_calls_build()
    assert k.source == _build.ADVANCE_ADAPTIVE.source and k.parts == 1
    assert set(k.defines) == {"-DFP_PART=2", "-DFP_CBL_CALLS=1"}
    assert k._lib_path() != _build.ADVANCE_ADAPTIVE._lib_path(2)
    assert chip_smoke.CBL_SKEWED_FUNCTIONS == ("cbl_skewed_wp",
                                               "cbl_fresh_wp")


def test_cbl_bound_reader_finds_the_skewed_work_or_refuses():
    """The CBL bound's reader (function_paths over CBL_SKEWED_FUNCTIONS) in
    a listing shaped like cbl_calls_build's: cbl_skewed_wp a function whose
    cheapest path holds the inlined parameters, cbl_fresh_wp one of its
    own, each found by its symbol, its spills and reloads (STL, LDL) not
    counted on its path.  In a listing shaped like the kernel
    that runs (cbl_skewed_wp inlined, only cbl_fresh_wp a function) it
    refuses by name instead of dropping the skewed work."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    entry = "_Z23advance_adaptive_kernelILb1ELi2ELb1ELb1EEvv"
    calls_elf = f""".section .symtab
 index           value           size      info    other  shndx    name
 0x1               0            0x40      0x2     0x10    0xa     {entry}
 0x7            0x40            0x80      0x2        0    0xa     ${entry}$_ZN2fp13cbl_skewed_wpEfff
 0x8            0xc0            0x30      0x2        0    0xa     ${entry}$_ZN2fp12cbl_fresh_wpEfff
"""
    ops = ["MOV R1, c[0x0][0x28]", "CALL.REL.NOINC 0x40", "EXIT", "NOP",
           "FMUL R2, R2, R5",            # 0x40: cbl_skewed_wp, cbl_skew in it
           "STL [R1+0x4], R2",           # a spill: not counted
           "MUFU.RSQ R3, R2",
           "@P0 BRA 0xb0",               # the redraw
           "LDL R2, [R1+0x4]",           # its reload: not counted
           "FADD R2, R2, R3",
           "RET.REL.NODEC R4 0x0",
           "FFMA R2, R2, R3, R4",        # 0xb0
           "FMUL R2, R2, R5",            # 0xc0: cbl_fresh_wp
           "FADD R2, R2, R3",
           "RET.REL.NODEC R4 0x0"]
    inline_elf = "\n".join(ln for ln in calls_elf.splitlines()
                           if "cbl_skewed_wp" not in ln) + "\n"

    class Kernel:
        name = "advance_adaptive"
        elf = calls_elf

        def cuobjdump(self, flag):
            return self.elf if flag == "-elf" else _sass_function(entry, ops)

    flags = (True, 2, True, True)
    paths = chip_smoke.function_paths(Kernel(), "advance_adaptive_kernel",
                                      flags, chip_smoke.CBL_SKEWED_FUNCTIONS)
    assert paths == {"cbl_skewed_wp": {"cheapest": 5, "static": 8,
                                       "local_memory": 2, "calls": 0},
                     "cbl_fresh_wp": {"cheapest": 3, "static": 3,
                                      "local_memory": 0, "calls": 0}}
    k = Kernel()
    k.elf = inline_elf
    with pytest.raises(AssertionError, match="cbl_skewed_wp"):
        chip_smoke.function_paths(k, "advance_adaptive_kernel", flags,
                                  chip_smoke.CBL_SKEWED_FUNCTIONS)


def test_k17_plan_matches_the_source():
    """K17's launch plan (grid/initcond.py::k17_plan) is made from
    csrc/initcond.cu's constants: blocks of THREADS threads, MIN_BLOCKS of
    them resident an SM, each warp a span of slots that is a multiple of
    ROUND (the mask of 128 slots a round, four bytes a lane), its queue
    room for 31 left over and a round; a warp table of a power of two
    slots, at least MIN_SLOTS, within TABLE_BYTES where that allows; the
    species and row limits refused by the wrapper as by the launcher; the
    plan covers every slot."""
    from flexpart_tpu_torch.grid import initcond as ic
    # the row limit and the warp groups from warp_groups.cuh
    assert _build.CSRC / "warp_groups.cuh" in _build.INITCOND.sources()
    text = _all_sources(_build.INITCOND)

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name, text)[1])

    assert const("THREADS") == ic.K17_THREADS
    assert re.search(r"constexpr int WARPS = THREADS / 32;", text)
    assert const("MIN_BLOCKS") == ic.K17_MIN_BLOCKS
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in text
    assert const("ROUND") == ic.K17_ROUND == 4 * 32
    assert const("QUEUE") >= 31 + ic.K17_ROUND
    assert const("TABLE_BYTES") == ic.K17_TABLE_BYTES
    assert const("MIN_SLOTS") == ic.K17_MIN_SLOTS
    assert const("MAX_SPECIES") == ic.K17_MAX_SPECIES
    m = re.search(r"MAX_ROWS = (0x[0-9A-F]+)ll - (\d+);", text)
    assert int(m.group(1), 16) - int(m.group(2)) == ic.K17_MAX_ROWS
    assert "rows > MAX_ROWS" in text and "nspec > MAX_SPECIES" in text
    assert "span % ROUND != 0" in text and "(1 << log2s) != slots" in text
    assert "static_cast<long long>(blocks) * WARPS * span < n" in text
    assert "__match_any_sync(FULL, valid ? row : EMPTY)" in text
    for nspec, slots in ((1, 256), (2, 256), (3, 128), (32, 64)):
        for n, sms in ((10 * 2 ** 20, 132), (1000, 132), (1, 8)):
            plan = ic.k17_plan(n, nspec, sms)
            assert plan.slots == slots
            assert plan.span % ic.K17_ROUND == 0 and plan.span >= ic.K17_ROUND
            assert plan.blocks * ic.K17_WARPS * plan.span >= n
            assert (plan.blocks - 1) * ic.K17_WARPS * plan.span < n
            assert plan.blocks <= max(
                1, sms * ic.K17_MIN_BLOCKS * ic.K17_WAVES)
    # the launcher takes the plan after the grid, as _build passes it
    sig = re.search(r'extern\s+"C"\s+int\s+fp_initcond\s*\((.*?)\)', text,
                    re.S).group(1)
    assert [d.split()[-1] for d in sig.split(",")][-5:] == [
        "grid", "blocks", "span", "slots", "stream"]


def test_k17_bound_charges_each_cell_hit_once():
    """K17's bound (chip_smoke.k17_bound, on the kernels cases and on each
    call of sim_initcond) reads the mask of every slot and each masked
    particle's state and density once, and reads and writes each grid row
    its pairs hit once (8 bytes a species), however many pairs pile onto
    it: a plume of a million particles in 120 cells moves 120 rows."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    cap, m, nspec = 10 * 2 ** 20, 1_000_000, 2
    plume = chip_smoke.k17_bound(cap, m, nspec, 120)
    assert plume["bound_bytes"] == cap + m * (24 + 4 * nspec + 32) \
        + 120 * 8 * nspec
    assert plume["bound_operations"] == m * chip_smoke.K17_OPS_PER_PARTICLE
    spread = chip_smoke.k17_bound(cap, m, nspec, 760_000)
    assert spread["bound_bytes"] - plume["bound_bytes"] \
        == (760_000 - 120) * 8 * nspec
    assert spread["bound_ms"] > plume["bound_ms"]
    empty = chip_smoke.k17_bound(cap, 0, nspec, 0)
    assert (empty["bound_bytes"], empty["bound_operations"]) == (cap, 0)


def test_advance_cbl_is_a_kernel_of_its_own():
    """K4's CBL instantiations are three kernels of their own: the start
    (advance_cbl_kernel: cbl_one's START stage), the
    skewed substeps (advance_cbl_skewed_kernel, one for all) and the
    deferred particles' end (advance_cbl_finish_kernel: the FINISH stage),
    each with the run scalars a __grid_constant__ parameter (the substeps
    index key_cbl by the substep; a by-value parameter would be copied to
    the thread's stack), the NaN redraws counted in counts[2], injected
    draws and more than MAX_CBL_SUBSTEPS substeps refused by the launcher;
    the stock and TILE kernels keep their by-value parameter."""
    text = _strip_comments(_build.ADVANCE.source.read_text())
    for kernel, call in (
            ("advance_cbl_kernel", "cbl_one<BF16, POLAR, SETTLING, NESTS, "
                                   "TILE, START>("),
            ("advance_cbl_skewed_kernel", "skewed_substeps(q, k, a)"),
            ("advance_cbl_finish_kernel", "cbl_one<BF16, POLAR, SETTLING, "
                                          "NESTS, TILE, FINISH>(")):
        body = re.search(r"\b%s\(.*?\n}\n" % kernel, text, re.S).group(0)
        assert "const __grid_constant__ AdvanceArgs a)" in body, kernel
        assert call in body, kernel
    for k in ("advance_kernel(", "advance_tile_kernel("):
        sig = re.search(re.escape(k) + r"[^)]*\)", text).group(0)
        assert "const AdvanceArgs a)" in sig and "__grid_constant__" not in sig
    assert "atomicAdd(&counts[2], __popc(nans))" in text
    assert ("a.cblflag && (a.ifine > MAX_CBL_SUBSTEPS || d6 != nullptr)"
            in text)
    # the stock body reads injected draws, the CBL's draws none
    assert "const bool injected = dr.d[0] != nullptr;" in text
    assert "fresh_state<CBL>(a, dr, false, i," in text
    assert "meso_draws(a, dr, false, i, m0, m1, m2);" in text
    common = _strip_comments((_build.CSRC / "advance_common.cuh").read_text())
    assert "a.key_cbl[2 * s]" in common
    assert advance.MAX_CBL_SUBSTEPS == int(re.search(
        r"constexpr int MAX_CBL_SUBSTEPS = (\d+);", common).group(1))

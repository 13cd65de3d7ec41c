"""The ctypes bindings of the CUDA kernels agree with their sources.

A ``ctypes`` argument list that disagrees with the ``extern "C"``
signature corrupts memory silently, and no compiler runs on the CPU, so
the signatures are parsed from ``csrc/*.cu`` and held against
``_build.py``: the same number of arguments, each of the same kind
(pointer, int, int64, uint32, float).  The ``AdvanceArgs`` struct that K4
receives by pointer is held field for field against its ctypes mirror.
A kernel's library name must change with its source and with every
header the source includes, or a changed header is never rebuilt.
"""
import ctypes
import re
import shutil

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from flexpart_tpu_torch import _build  # noqa: E402
from flexpart_tpu_torch.core import advance  # noqa: E402

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
    assert KERNEL_NAMES == ["normals", "quad_tables", "conccalc", "advance"]


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


def test_normals_and_advance_share_the_philox_header():
    for name in ("normals", "advance"):
        assert _build.CSRC / "philox_normal.cuh" in _kernel(name).sources()
    for name in ("normals", "advance"):
        text = _kernel(name).source.read_text()
        assert "philox4x32_10(" not in text.replace("fp::", "")
        assert "fp::normal_at(" in text


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

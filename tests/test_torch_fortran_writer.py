"""Port parity for the reference's unformatted output files
(``io/fortran_writer.py``): byte for byte against the JAX package's writer
on the same numpy-seeded arrays.

The header's version string is the one difference the port makes on
purpose (``FLEXVERSION``, "flexpart_tpu_torch 1.0"): every other byte of a
header is compared, and with the JAX package's string passed in, the
whole file.  The sparse grid files and blocks are compared whole: empty
grids, a grid whose last cell is non-zero (a run that touches the end),
runs of alternating sign, the 3-D index offset, several release points
and age classes, wet and dry absent or present.  The readers of both
packages decode what either wrote to the same arrays.
"""
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexpart_tpu.io import fortran_writer as jfw  # noqa: E402
from flexpart_tpu_torch.io import fortran_writer as tfw  # noqa: E402

VERSION_AT = slice(4 + 8, 4 + 8 + 256)   # the first record's string


def _header_kwargs(rng, nspec=2, npoint=3, nx=7, ny=5):
    rels = [dict(start=int(rng.integers(0, 3600)),
                 end=int(rng.integers(3600, 7200)), kindz=1 + k % 3,
                 xp1=float(rng.uniform(-10, 0)), yp1=float(rng.uniform(40, 45)),
                 xp2=float(rng.uniform(0, 10)), yp2=float(rng.uniform(45, 50)),
                 zp1=float(rng.uniform(0, 100)), zp2=float(rng.uniform(100, 900)),
                 npart=int(rng.integers(1, 10 ** 6)), comment=f"BOX {k}",
                 xmass=list(rng.uniform(0, 2, nspec)))
            for k in range(npoint)]
    return dict(ibdate=20200101, ibtime=60000, loutstep=3600, loutaver=3600,
                loutsample=900, outlon0=-60.0, outlat0=0.5, numxgrid=nx,
                numygrid=ny, dxout=2.0, dyout=1.5,
                outheights=(100.0, 500.0, 50000.0), jjjjmmdd=20200101,
                ihmmss=120000, species_names=["AIRTRACER", "CS-137-LONGNAME"][:nspec],
                maxpointspec_act=npoint, releases=rels, method=1, lsubgrid=0,
                lconvection=1, ind_source=1, ind_receptor=2, nageclass=2,
                lage=(3600, 999999999),
                oroout=rng.uniform(0, 3000, (ny, nx)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_header_bytes_equal_jax_but_the_version(seed, tmp_path):
    kw = _header_kwargs(np.random.default_rng(seed))
    jfw.write_header(tmp_path / "j", **kw)
    tfw.write_header(tmp_path / "t", **kw)
    j, t = (tmp_path / "j").read_bytes(), (tmp_path / "t").read_bytes()
    assert len(t) == len(j)
    assert t[:VERSION_AT.start] == j[:VERSION_AT.start]
    assert t[VERSION_AT.stop:] == j[VERSION_AT.stop:]
    assert t[VERSION_AT].decode("latin-1").rstrip() == tfw.FLEXVERSION \
        == "flexpart_tpu_torch 1.0"
    tfw.write_header(tmp_path / "same", flexversion="flexpart_tpu 1.0", **kw)
    assert (tmp_path / "same").read_bytes() == j
    # each package's reader reads the other's file to the same values
    hj, ht = jfw.read_header(tmp_path / "t"), tfw.read_header(tmp_path / "j")
    for k in hj:
        if k == "flexversion":
            continue
        if isinstance(hj[k], np.ndarray):
            np.testing.assert_array_equal(ht[k], hj[k], err_msg=k)
        else:
            assert ht[k] == hj[k], k


def _sparse_cases():
    rng = np.random.default_rng(3)
    dense = rng.uniform(0, 1, 60).astype(np.float32)
    runs = np.zeros(60, np.float32)
    runs[[0, 1, 2, 7, 8, 20, 41, 42, 43, 44]] = rng.uniform(0.1, 1, 10)
    last = np.zeros(60, np.float32)
    last[-3:] = [1e-3, 0.0, 2.5]                     # touches the last cell
    tiny = np.zeros(60, np.float32)
    tiny[[5, 6]] = [np.finfo(np.float32).tiny, 1e-30]  # at / above smallnum
    return {"empty": np.zeros(60, np.float32), "dense": dense, "runs": runs,
            "last": last, "tiny": tiny}


@pytest.mark.parametrize("case", list(_sparse_cases()))
@pytest.mark.parametrize("offset", [0, 35])
def test_sparse_block_bytes_equal_jax(case, offset):
    flat = _sparse_cases()[case]
    assert tfw._sparse_block(flat, offset) == jfw._sparse_block(flat, offset)
    ti, tv = tfw.sparse_encode(flat, offset)
    ji, jv = jfw.sparse_encode(flat, offset)
    assert ti.dtype == ji.dtype and tv.dtype == jv.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    back = tfw.sparse_decode(ti, tv, flat.size, offset)
    np.testing.assert_array_equal(
        back, np.where(flat > np.finfo(np.float32).tiny, flat, 0))
    np.testing.assert_array_equal(back, jfw.sparse_decode(ji, jv, flat.size,
                                                          offset))


@pytest.mark.parametrize("depo", ["none", "wet_dry"])
def test_grid_sparse_bytes_equal_jax(depo, tmp_path):
    """A (npoint, nage, nz, ny, nx) grid with empty age classes, a cell at
    the very end and float64 input (the Simulation hands the writer float64
    products), read back by both readers."""
    rng = np.random.default_rng(5)
    npoint, nage, nz, ny, nx = 2, 2, 3, 4, 6
    conc = rng.uniform(0, 1, (npoint, nage, nz, ny, nx))
    conc[rng.uniform(size=conc.shape) < 0.6] = 0.0
    conc[0, 1] = 0.0                                 # an empty class
    conc[1, 1, -1, -1, -1] = 7.0                     # the last cell
    wet = dry = None
    if depo == "wet_dry":
        wet = rng.uniform(0, 1, (npoint, nage, ny, nx)).astype(np.float32)
        dry = np.zeros((npoint, nage, ny, nx), np.float32)
        dry[1, 0, 2, 3] = 0.25
    jfw.write_grid_sparse(tmp_path / "j", 3600, conc, wet, dry)
    tfw.write_grid_sparse(tmp_path / "t", 3600, conc, wet, dry)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    for reader in (jfw.read_grid_sparse, tfw.read_grid_sparse):
        itime, c, w, d = reader(tmp_path / "t", nx, ny, nz, npoint, nage)
        assert itime == 3600
        np.testing.assert_array_equal(c, conc.astype(np.float32))
        if wet is not None:
            np.testing.assert_array_equal(w, wet)
            np.testing.assert_array_equal(d, dry)
        else:
            assert not w.any() and not d.any()


def test_record_framing_is_gfortran_little_endian(tmp_path):
    """Every record is <len><payload><len> with 4-byte little-endian
    lengths, and the grid file starts with the itime record."""
    tfw.write_grid_sparse(tmp_path / "g", -7200,
                          np.ones((1, 1, 1, 2, 2), np.float32), None, None)
    b = (tmp_path / "g").read_bytes()
    assert b[:12] == struct.pack("<iii", 4, -7200, 4)
    assert tfw._rec(b"abc") == b"\x03\x00\x00\x00abc\x03\x00\x00\x00"

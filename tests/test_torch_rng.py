"""The port's Philox normals meet the draw contract of tests/test_rng.py.

The TPU stream (and JAX's threefry) cannot be reproduced, so parity is by
contract: deterministic for (key, tag, shape), distinct streams per tag
and per step, |z| <= 3, mean 0 and std 1 to 0.02 at 8x4096.  On top, the
port's counter is the global particle index: one call over n columns
equals the concatenation of calls over chunks with their offsets.  Rows
come four to a Philox call and two to a Box-Muller radius: a pair of rows
lies on the circle its two words name, a row count that is no multiple of
four takes the leading rows, and rows that share a radius are still
independent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from flexpart_tpu_torch.core import rng  # noqa: E402


def test_contract():
    k = rng.Key(11, 3)
    a = rng.normals(k, (8, 4096), tag=5, device="cpu").numpy()
    b = rng.normals(k, (8, 4096), tag=5, device="cpu").numpy()
    c = rng.normals(k, (8, 4096), tag=6, device="cpu").numpy()
    d = rng.normals(rng.Key(11, 4), (8, 4096), tag=5, device="cpu").numpy()
    assert a.dtype == np.float32 and a.shape == (8, 4096)
    np.testing.assert_array_equal(a, b)          # deterministic
    assert not np.array_equal(a, c)              # tag-separated
    assert not np.array_equal(a, d)              # step-separated
    assert np.abs(a).max() <= 3.0                # gasdev1 clip
    assert abs(a.mean()) < 0.02 and abs(a.std() - 1.0) < 0.02
    # rows are independent streams too
    assert abs(np.corrcoef(a[0], a[1])[0, 1]) < 0.05


def test_chunk_offsets_compose():
    k = rng.Key(2 ** 40 + 7, 9)
    full = rng.normals(k, (3, 1000), tag=4, device="cpu")
    parts = [rng.normals(k, (3, 250), tag=4, offset=o, device="cpu")
             for o in range(0, 1000, 250)]
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(),
                                  full.numpy())


def test_philox_known_answer():
    """Random123's published Philox4x32-10 known-answer vectors."""
    def run(ctr, key):
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        out = rng.philox4x32_10(*c, *key)
        return [int(t.item()) for t in out]

    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D,
                                         0xBC57AC4C, 0x9B00DBD8]
    ff = 0xFFFFFFFF
    assert run((ff, ff, ff, ff), (ff, ff)) == [0x408F276D, 0x41C83B0E,
                                               0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [0xD16CFE09, 0x94FDCCEB,
                                             0x5001E420, 0x24126EA1]


def test_one_dim_shape_and_device_rule():
    z = rng.normals(rng.Key(1), 17, tag=0, device="cpu")
    assert z.shape == (17,)
    with pytest.raises(ValueError):
        rng.normals(rng.Key(1), 17, tag=0, device="meta")


def _words(key, tag, cols, block, offset=0):
    """The four Philox words of rows 4 * block .. 4 * block + 3."""
    k0, k1 = key.philox_key(tag)
    col = torch.arange(cols, dtype=torch.int64) + offset
    blk = torch.full((cols,), block, dtype=torch.int64)
    zero = torch.zeros(cols, dtype=torch.int64)
    return [w.numpy() for w in rng.philox4x32_10(col, blk, zero, zero, k0, k1)]


@pytest.mark.parametrize("block", [0, 1])
def test_four_rows_come_from_one_philox_block(block):
    """Rows 4q + 2j and 4q + 2j + 1 are the cos and sin branch of one
    radius: z0^2 + z1^2 = -2 log(u1), u1 from word 2j of block q, and their
    angle is 2 pi u2, u2 from word 2j + 1."""
    key = rng.Key(77, 2)
    z = rng.normals(key, (8, 4096), tag=3, offset=100, device="cpu").numpy()
    w = _words(key, 3, 4096, block, offset=100)
    for j in (0, 1):
        z0, z1 = z[4 * block + 2 * j], z[4 * block + 2 * j + 1]
        u1 = 1.0 - (w[2 * j] >> 8).astype(np.float64) * 2.0 ** -24
        u2 = (w[2 * j + 1] >> 8).astype(np.float64) * 2.0 ** -24
        inside = (np.abs(z0) < 3.0) & (np.abs(z1) < 3.0)      # not clipped
        assert inside.mean() > 0.98
        r2 = -2.0 * np.log(u1)
        np.testing.assert_allclose((z0.astype(np.float64) ** 2
                                    + z1.astype(np.float64) ** 2)[inside],
                                   r2[inside], rtol=1e-5, atol=1e-9)
        far = inside & (r2 > 1e-3)
        np.testing.assert_allclose(z0[far], (np.sqrt(r2) * np.cos(
            2.0 * np.pi * u2))[far], rtol=0, atol=1e-5)
        np.testing.assert_allclose(z1[far], (np.sqrt(r2) * np.sin(
            2.0 * np.pi * u2))[far], rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 3, 5, 6])
def test_row_count_takes_the_leading_rows(rows):
    k = rng.Key(5, 1)
    full = rng.normals(k, (8, 777), tag=6, offset=31, device="cpu")
    part = rng.normals(k, (rows, 777), tag=6, offset=31, device="cpu")
    assert part.shape == (rows, 777)
    np.testing.assert_array_equal(part.numpy(), full[:rows].numpy())


@pytest.mark.parametrize("rows", [2, 6, 9])
def test_chunk_offsets_compose_for_any_row_count(rows):
    k = rng.Key(3, 12)
    full = rng.normals(k, (rows, 600), tag=1, device="cpu")
    parts = [rng.normals(k, (rows, 200), tag=1, offset=o, device="cpu")
             for o in range(0, 600, 200)]
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(),
                                  full.numpy())


def test_rows_of_one_radius_are_independent():
    """Rows 0 and 1 share a radius and rows 0-3 a Philox call: neither the
    rows nor their squares correlate, and every row has the moments."""
    a = rng.normals(rng.Key(19, 7), (4, 65536), tag=2, device="cpu").numpy()
    sq = a * a
    for i in range(4):
        assert abs(a[i].mean()) < 0.02 and abs(a[i].std() - 1.0) < 0.02
        for j in range(i + 1, 4):
            assert abs(np.corrcoef(a[i], a[j])[0, 1]) < 0.05, (i, j)
            assert abs(np.corrcoef(sq[i], sq[j])[0, 1]) < 0.05, (i, j)

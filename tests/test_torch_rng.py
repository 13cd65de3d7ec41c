"""The port's Philox normals meet the draw contract of tests/test_rng.py.

The TPU stream (and JAX's threefry) cannot be reproduced, so parity is by
contract: deterministic for (key, tag, shape), distinct streams per tag
and per step, |z| <= 3, mean 0 and std 1 to 0.02 at 8x4096.  On top, the
port's counter is the global particle index: one call over n columns
equals the concatenation of calls over chunks with their offsets.
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

"""Port parity: quad-corner tables and the quad-row sampling against JAX.

Both sides get the SAME processed met (the JAX ZFields, carried across by
``interop``), so the comparison isolates the table build (the plain twin
of kernel K2 here) and the row sampling.

Tolerances:
  * ``rowsE`` has 32 lanes in the port (24 used, 8 zero) and 64 in JAX
    (24 used, 40 zero): lanes 0-23 are compared, JAX's lanes 24-63 and
    the port's 24-31 must be zero;
  * table lanes 0-59 and ``rowsE``: bitwise in float32 — one blend
    ``z0*tw0 + z1*tw1`` per value on both sides.  Two XLA:CPU habits are
    factored out, not tolerated: it flushes subnormal operands and results
    to zero (near the poles the synthetic v wind is ~1e-38), which moves a
    value by less than the smallest normal float, so values are compared
    with ``atol`` = that smallest normal and ``rtol`` = 0 (bitwise for every
    |value| > 1e-31, where one ulp exceeds it); and it contracts
    the blend into ``fma(z1, tw1, z0*tw0)``.  With tw1 = 0.25 the product
    z1*tw1 is exact, so the contraction cannot change a bit and the test
    is exact; ``test_quad_tables_general_weights`` bounds the contraction
    for general weights at one rounding of the blend;
  * lanes 60-62 (per-cell sigmas): at most 4 float32 ulp — XLA orders and
    contracts the 4-corner sums of squares its own way;
  * the bfloat16 tables: bitwise (both round to nearest even);
  * sampling at random positions: f32 round-off (rtol 1e-6), the 4-corner
    dot products may be summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import interp as jinterp  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import interp as tinterp  # noqa: E402

TW = (0.75, 0.25, 0.5, 0.5)


@pytest.fixture(scope="module")
def met_pair():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (0.0, 10800.0):
        eta = m.fetch(t)
        h = jmet.compute_heights(grid, eta)
        zs.append(jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h)))
    tz = [interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                      z._asdict().items()}, "cpu") for z in zs]
    return grid, zs, tz


def _tables(met_pair, dtype_j, dtype_t):
    grid, (j0, j1), (t0, t1) = met_pair
    jt = jinterp.build_step_tables_quad(j0, j1, *(jnp.float32(w) for w in TW),
                                        dtype=dtype_j)
    tt = tinterp.build_step_tables_quad(t0, t1, *TW, dtype=dtype_t)
    return jt, tt


def _ulp_diff(a, b):
    ai = a.astype(np.float32).view(np.int32).astype(np.int64)
    bi = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _assert_equal_ftz(actual, desired):
    """Bitwise, except for what XLA's subnormal flush moves (< tiny)."""
    np.testing.assert_allclose(np.asarray(actual).astype(np.float32),
                               np.asarray(desired).astype(np.float32),
                               rtol=0, atol=np.finfo(np.float32).tiny)


def _assert_rows_e(tt, jt):
    """The port's (R, 32) end-time table against JAX's (R, 64) one."""
    te, je = interop.to_numpy(tt.rowsE), np.asarray(jt.rowsE).astype(np.float32)
    assert je.shape == (te.shape[0], 64) and te.shape[1] == 32
    assert tt.rowsE.is_contiguous()
    _assert_equal_ftz(te[:, :24], je[:, :24])
    assert not je[:, 24:].any() and not te[:, 24:].any()


def test_quad_tables_f32(met_pair):
    jt, tt = _tables(met_pair, jnp.float32, torch.float32)
    jr, tr = np.asarray(jt.rows), tt.rows.numpy()
    assert tr.shape == jr.shape == (14 * 19 * 37, 64)
    _assert_equal_ftz(tr[:, :60], jr[:, :60])
    np.testing.assert_array_equal(tr[:, 63], jr[:, 63])
    assert _ulp_diff(tr[:, 60:63], jr[:, 60:63]).max() <= 4
    _assert_rows_e(tt, jt)


def test_quad_tables_bf16(met_pair):
    jt, tt = _tables(met_pair, jnp.bfloat16, torch.bfloat16)
    _assert_equal_ftz(interop.to_numpy(tt.rows), jt.rows)
    _assert_rows_e(tt, jt)


def test_quad_tables_general_weights(met_pair):
    """Weights whose products round: the port's blend has two roundings
    (no FMA, as the CUDA kernel is built), XLA's contracted blend one, so
    they differ by at most one rounding of the blend's terms."""
    _, (j0, j1), (t0, t1) = met_pair
    tw = (0.3, 0.7, 0.15, 0.85)
    twf = [float(np.float32(w)) for w in tw]
    jt = jinterp.build_step_tables_quad(j0, j1, *(jnp.float32(w) for w in tw))
    tt = tinterp.build_step_tables_quad(t0, t1, *twf)
    f0, f1 = t0.f3d.numpy(), t1.f3d.numpy()
    scale = np.abs(f0).max(axis=(1, 2, 3)) + np.abs(f1).max(axis=(1, 2, 3))
    spacing = np.float32(2.0 ** -23)
    for lanes, field in ((slice(0, 8), 0), (slice(8, 16), 1),
                         (slice(16, 24), 2), (slice(24, 32), 3)):
        d = np.abs(tt.rows.numpy()[:, lanes] - np.asarray(jt.rows)[:, lanes])
        assert d.max() <= spacing * scale[field], field


@pytest.mark.parametrize("bf16", [False, True])
def test_sampling_matches_jax(met_pair, bf16):
    grid = met_pair[0]
    jt, _ = _tables(met_pair, jnp.bfloat16 if bf16 else jnp.float32, None)
    tt = interop.tables_from_numpy({"rows": np.asarray(jt.rows),
                                    "rowsE": np.asarray(jt.rowsE)}, "cpu")
    rs = np.random.default_rng(3)
    n = 2000
    x = rs.uniform(-1.0, grid.nx, n).astype(np.float32)
    y = rs.uniform(-1.0, grid.ny, n).astype(np.float32)
    z = rs.uniform(0.0, 20000.0, n).astype(np.float32)
    height = np.array(met_pair[1][0].height)

    hw_j = jinterp.horiz_weights(jnp.asarray(x), jnp.asarray(y), grid.nx,
                                 grid.ny, grid.xglobal)
    iz_j, dz_j = jinterp.vert_weights(jnp.asarray(z), jnp.asarray(height))
    out_j = jinterp.sample_all_quad(jt, hw_j, iz_j, dz_j, jnp.asarray(x),
                                    jnp.asarray(y), grid.nx, grid.ny)
    short_j = jinterp.interp_wind_short_quad(jt.rowsE, hw_j, iz_j, dz_j,
                                             grid.nx, grid.ny)

    xt, yt, zt = map(torch.as_tensor, (x, y, z))
    hw_t = tinterp.horiz_weights(xt, yt, grid.nx, grid.ny, grid.xglobal)
    iz_t, dz_t = tinterp.vert_weights(zt, torch.as_tensor(height))
    np.testing.assert_array_equal(iz_t.numpy(), np.asarray(iz_j))
    np.testing.assert_array_equal(hw_t.ix.numpy(), np.asarray(hw_j.ix))
    np.testing.assert_array_equal(hw_t.p4.numpy(), np.asarray(hw_j.p4).T)
    out_t = tinterp.sample_all_quad(tt, hw_t, iz_t, dz_t, xt, yt, grid.nx,
                                    grid.ny)
    short_t = tinterp.interp_wind_short_quad(tt.rowsE, hw_t, iz_t, dz_t,
                                             grid.nx, grid.ny)
    for a, b, name in zip(out_t[:5], out_j[:5], ("h", "tropop", "ust",
                                                  "wst", "ol")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    wj, wt = out_j[5], out_t[5]
    for name in ("u", "v", "w", "rho", "drhodz", "usig", "vsig", "wsig"):
        b = np.asarray(getattr(wj, name))
        np.testing.assert_allclose(getattr(wt, name).numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)
    for a, b in zip(short_t, short_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())

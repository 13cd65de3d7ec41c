"""Port parity: the polar-stereographic update inside the polar caps
(``core/advance.py::_polar_update`` and its two call sites in
``advance_all_plain``, the plain version of K4's ``POLAR`` instantiation)
against ``flexpart_tpu/core/advance.py``.

* ``_polar_update`` alone, on the same positions and displacements in
  both caps and outside them: x and y within 2e-4 grid units (sin, cos,
  tan, hypot, atan and atan2 of XLA and of torch's CPU kernels differ by
  an ulp or two, and the inverse map divides by the map factor near the
  pole; measured 7.6e-6 in x, 3.8e-6 in y), the cap masks exactly.
* The four cases of ``tests/test_polar.py`` on the port's advance, with
  the JAX package's assertions.  The JAX tests switch turbulence off
  (``turboff``), which the port refuses; the port is fed draws that are all
  zero instead, which at 5 km in the free troposphere of a wind field
  without variance gives the same deterministic advection.  After the
  steps, the port's positions are also held against the JAX run's, within
  1e-3 grid units (40 steps of the transcendentals' ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from flexpart_tpu.constants import R_EARTH  # noqa: E402
from flexpart_tpu.core import StepConfig as JStepConfig  # noqa: E402
from flexpart_tpu.core import StepParams as JStepParams  # noqa: E402
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import advance_all as jadvance_all  # noqa: E402
from flexpart_tpu.core.state import empty_particles as jempty  # noqa: E402
from flexpart_tpu.met import (calcpar, compute_heights, make_grid,  # noqa: E402
                              process_eta, solid_rotation_met,
                              uniform_wind_met)
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import rng  # noqa: E402

MEM1 = 36000000


def setup(u=10.0, v=0.0, met_factory=None):
    """``tests/test_polar.py::setup``: both packages' configuration and the
    JAX met fields, carried over to the port."""
    grid = make_grid(nx=73, ny=37, nlev=12, dx=5.0, dy=5.0,
                     xlon0=-180.0, ylat0=-90.0, xglobal=True)
    met = (met_factory(grid) if met_factory is not None
           else uniform_wind_met(grid, u=u, v=v))
    eta = met.fetch(0.0)
    zf = calcpar(grid, eta, process_eta(grid, eta, compute_heights(grid,
                                                                   eta)))
    jcfg = JStepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                       ldirect=1, turbswitch=False, ifine=1, method=0,
                       turboff=True, polar=True)
    jprm = JStepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                            xlon0=grid.xlon0, dxconst=grid.dxconst,
                            dyconst=grid.dyconst, lsynctime=900, fine=1.0)
    tcfg = interop.step_config_from_jax(jcfg._replace(turboff=False))
    tprm = interop.step_params_from_numpy(jprm)
    tz = interop.zfields_from_numpy(
        {k: np.asarray(v) for k, v in zf._asdict().items()}, "cpu")
    return grid, zf, jcfg, jprm, tz, tcfg, tprm


def run_steps(p, tz, cfg, prm, nsteps):
    """The port's advance with every draw zero (deterministic advection)."""
    n = p.capacity
    zero = {t: torch.zeros((r, n)) for t, r in
            {**tadv.DRAW_ROWS, 2: cfg.ifine}.items()}
    for i in range(nsteps):
        p, _ = tadv.advance_all(p, tz, tz, i * 900, 0, MEM1, rng.Key(0, i),
                                cfg, prm, draws=zero)
    return p


def run_steps_jax(p, zf, cfg, prm, nsteps):
    key = jax.random.PRNGKey(0)
    for i in range(nsteps):
        p, _ = jadvance_all(p, zf, zf, jnp.int32(i * 900), jnp.int32(0),
                            jnp.int32(MEM1), jax.random.fold_in(key, i),
                            cfg, prm)
    return p


def place(grid, lons, lats, z=5000.0):
    """(port particles, JAX particles) at the given positions."""
    n = len(lons)
    xs = ((np.asarray(lons) - grid.xlon0) / grid.dx).astype(np.float32)
    ys = ((np.asarray(lats) - grid.ylat0) / grid.dy).astype(np.float32)
    jp = jempty(n)._replace(x_hi=jnp.asarray(xs), y_hi=jnp.asarray(ys),
                            z=jnp.full(n, z, jnp.float32),
                            itra=jnp.zeros(n, jnp.int32),
                            mass=jnp.ones((n, 1), jnp.float32),
                            active=jnp.ones(n, bool))
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    return tp, jp


def _lonlat(grid, p):
    return (grid.xlon0 + p.x.numpy() * grid.dx,
            grid.ylat0 + p.y.numpy() * grid.dy)


def _same_positions(tp, jp, grid, atol=1e-3):
    xt, yt = tp.x.numpy(), tp.y.numpy()
    xj, yj = (np.asarray(jp.x_hi) + np.asarray(jp.x_lo),
              np.asarray(jp.y_hi) + np.asarray(jp.y_lo))
    dx = np.abs(xt - xj)
    dx = np.minimum(dx, (grid.nx - 1) - dx)      # cyclic in x
    assert dx.max() <= atol and np.abs(yt - yj).max() <= atol, (dx, yt, yj)
    np.testing.assert_array_equal(tp.active.numpy(), np.asarray(jp.active))


@pytest.mark.parametrize("cap", ["north", "south", "both and outside"])
def test_polar_update_matches_jax(cap):
    grid, _, jcfg, jprm, _, tcfg, tprm = setup()
    rs = np.random.default_rng({"north": 1, "south": 2}.get(cap, 3))
    n = 4096
    lat = {"north": rs.uniform(75.01, 89.99, n),
           "south": rs.uniform(-89.99, -75.01, n)}.get(
        cap, rs.uniform(-89.99, 89.99, n))
    x = rs.uniform(0.0, grid.nx - 1.0, n).astype(np.float32)
    y = ((lat - grid.ylat0) / grid.dy).astype(np.float32)
    # up to 30 m/s for 900 s in each direction
    dxs = rs.uniform(-27000.0, 27000.0, n).astype(np.float32)
    dys = rs.uniform(-27000.0, 27000.0, n).astype(np.float32)
    nxm = jnp.float32(grid.nx - 1)
    xj, yj, nj, sj = jadv._polar_update(jprm, *(jnp.asarray(a) for a in
                                                (x, y, dxs, dys)),
                                        jnp.float32(1.0), nxm)
    a = tadv.advance_args(tcfg, tprm, 0, 0, MEM1)
    assert a.polar == 1 and a.xlon0 == -180.0
    xt, yt, nt, st = tadv._polar_update(a, *(torch.as_tensor(v) for v in
                                             (x, y, dxs, dys)))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    pol = nt.numpy() | st.numpy()
    assert pol.any() and (cap != "both and outside" or not pol.all())
    d = np.abs(xt.numpy() - np.asarray(xj))[pol]
    d = np.minimum(d, (grid.nx - 1) - d)
    assert d.max() <= 2e-4
    assert np.abs(yt.numpy() - np.asarray(yj))[pol].max() <= 2e-4


def test_zonal_transport_stays_on_latitude_circle():
    grid, zf, jcfg, jprm, tz, tcfg, tprm = setup(u=10.0, v=0.0)
    p, jp = place(grid, [0.0, 90.0, -120.0], [85.0, 82.0, 78.0])
    lon0, lat0 = _lonlat(grid, p)
    q = run_steps(p, tz, tcfg, tprm, 40)   # 10 h
    lon1, lat1 = _lonlat(grid, q)
    np.testing.assert_allclose(lat1, lat0, atol=0.4)
    t = 40 * 900.0
    expect = np.degrees(10.0 * t / (R_EARTH * np.cos(np.radians(lat0))))
    dlon = (lon1 - lon0 + 540.0) % 360.0 - 180.0
    np.testing.assert_allclose(dlon, expect, rtol=0.05)
    assert q.active.all()
    _same_positions(q, run_steps_jax(jp, zf, jcfg, jprm, 40), grid)


def test_great_circle_flow_crosses_pole():
    grid, zf, jcfg, jprm, tz, tcfg, tprm = setup(
        met_factory=lambda g: solid_rotation_met(g, vmax=20.0,
                                                 axis_lon=-80.0))
    p, jp = place(grid, [10.0], [88.0])
    q = run_steps(p, tz, tcfg, tprm, 32)   # 8 h -> ~5.2 deg of arc
    lon1, lat1 = (float(v[0]) for v in _lonlat(grid, q))
    arc = np.degrees(20.0 * 32 * 900.0 / R_EARTH)
    assert abs(lat1 - (90.0 - (arc - 2.0))) < 0.5      # past the pole
    dlon = (lon1 - (-170.0) + 540.0) % 360.0 - 180.0
    assert abs(dlon) < 12.0                            # far-side meridian
    assert q.active.all()
    _same_positions(q, run_steps_jax(jp, zf, jcfg, jprm, 32), grid)


def test_uniform_northward_wind_converges_at_pole():
    grid, zf, jcfg, jprm, tz, tcfg, tprm = setup(u=0.0, v=20.0)
    p, jp = place(grid, [10.0], [88.0])
    q = run_steps(p, tz, tcfg, tprm, 32)
    lat1 = float(_lonlat(grid, q)[1][0])
    step_deg = np.degrees(20.0 * 900.0 / R_EARTH)
    assert lat1 > 90.0 - 2.0 * step_deg
    assert torch.isfinite(q.x).all()
    assert q.active.all()
    _same_positions(q, run_steps_jax(jp, zf, jcfg, jprm, 32), grid)


def test_polar_off_matches_away_from_caps():
    """The stereographic branch does not touch mid-latitude particles:
    with it and without it the port's particles are bitwise equal."""
    grid, _, _, _, tz, tcfg, tprm = setup(u=10.0, v=3.0)
    p, _ = place(grid, [0.0, 40.0], [45.0, -30.0])
    q_pol = run_steps(p, tz, tcfg, tprm, 10)
    q_off = run_steps(p, tz, type(tcfg)(**{**tcfg.__dict__, "polar": False}),
                      tprm, 10)
    for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z"):
        assert torch.equal(getattr(q_pol, f), getattr(q_off, f)), f


def test_polar_grid_gets_the_polar_args():
    """``advance_args`` carries the polar flag and the grid's lon origin
    to K4 (the ``POLAR`` instantiation and its projection)."""
    grid, _, _, jprm, _, tcfg, tprm = setup()
    assert tprm.xlon0 == float(np.asarray(jprm.xlon0_pol)) == -180.0
    a = tadv.advance_args(tcfg, tprm, 900, 0, MEM1)
    assert (a.polar, a.xlon0) == (1, -180.0)
    off = tadv.advance_args(type(tcfg)(**{**tcfg.__dict__, "polar": False}),
                            tprm, 900, 0, MEM1)
    assert off.polar == 0

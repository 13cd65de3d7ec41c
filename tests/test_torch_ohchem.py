"""Port parity for the OH chemistry (``physics/ohchem.py``; kernel K12 on
a card, its plain version here).

The host functions are copies and must give the JAX package's numbers
bit for bit: ``zenith_angle``, ``photo_o1d``, the synthetic climatology,
``HourlyOH.fields_for`` forward and backward, ``read_oh_field`` on a file
the test writes in the reference's record layout.

The per-particle reaction (the reference's ``make_ohreaction`` body fed
its ``Simulation._cell_temps``) against JAX's on the same particles, made
with numpy: the cell temperatures bitwise, the masses within rtol 1e-6
(torch's CPU ``pow`` and ``exp`` and XLA:CPU's round differently in the
last bit, and ``exp(-rate * dt)`` carries that into the mass times rate *
dt: the species are chosen so that it stays below 3 even at the
synthetic climatology's terminator cells, whose hourly correction
divides by the 1e-12 floor of a monthly mean; at 32 an ulp of the rate
is 4e-6 of the mass), on random
particles and on particles at the midpoints between OH cells, where the
nearest-cell search must keep the first of equal distances as
``jnp.argmin`` does; a species without OH keeps its mass, an inactive
particle too.

A 6 h run as ``tests/test_physics.py:124-145`` (the REACT species, 3008
particles from 120-110 W, 40-55 N, the default Command with convection)
through both packages, JAX's draws injected into the port as in
``tests/test_torch_default_run.py``: the airborne mass within rtol 1e-5
of JAX's and both in the reference's bounds (0.2, 0.999); every
particle's mass, mapped back to its schedule slot, within rtol 1e-5 for
all but 0.5% of the particles (a particle whose height has drifted an
ulp across a level, ``tests/test_torch_sim.py``, takes another cell
temperature).
"""
from datetime import datetime
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.physics import ohchem as joh  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import reorder  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.core.state import ITRA_INACTIVE  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.physics import ohchem as toh  # noqa: E402
from flexpart_tpu_torch.run.simulation import Simulation  # noqa: E402

GRID = dict(nx=73, ny=37, nlev=15, dx=5.0, dy=5.0, xlon0=-180.0,
            ylat0=-90.0)
REACT = dict(name="REACT", ohcconst=1.0e-11, ohdconst=500.0, ohnconst=0.0)
N2 = dict(name="N2", ohcconst=1.0e-19, ohdconst=300.0, ohnconst=2.0)
INERT = dict(name="INERT")
BDATE = datetime(2020, 7, 1)


def test_zenith_angle_and_photolysis_equal_jax():
    lat = np.linspace(-90.0, 90.0, 37)[:, None]
    lon = np.linspace(-180.0, 180.0, 73)[None, :]
    for when in (datetime(2020, 1, 1, 0), datetime(2020, 3, 21, 12, 30),
                 datetime(2021, 7, 15, 18, 45)):
        a = joh.zenith_angle(lat, lon, when)
        b = toh.zenith_angle(lat, lon, when)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(toh.photo_o1d(b), joh.photo_o1d(a))
    sza = np.array([-5.0, 0.0, 10.0, 45.0, 78.0, 89.99, 90.0, 95.0])
    np.testing.assert_array_equal(toh.photo_o1d(sza), joh.photo_o1d(sza))


def _fields_equal(a, b):
    for k in ("lon", "lat", "alt", "oh", "lonjr", "latjr", "jrate_avg"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                      err_msg=k)
    np.testing.assert_array_equal(b.alt_top, a.alt_top)


@pytest.mark.parametrize("ldirect", [1, -1])
def test_hourly_fields_equal_jax(ldirect):
    jf, tf = joh.synthetic_oh_field(), toh.synthetic_oh_field()
    _fields_equal(jf, tf)
    j = joh.HourlyOH(jf, BDATE, ldirect)
    t = toh.HourlyOH(tf, BDATE, ldirect, device="cpu")
    for itime in (0, 900 * ldirect, 3600 * ldirect, 40500 * ldirect):
        a0, a1, at0, at1 = j.fields_for(itime)
        b0, b1, bt0, bt1 = t.fields_for(itime)
        assert (bt0, bt1) == (at0, at1)
        for a, b in ((a0, b0), (a1, b1)):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _write_oh_file(path, nx=8, ny=6, nz=3, seed=0):
    """OH_variables.bin in the reference's record layout
    (readOHfield.f90:43-77)."""
    rng = np.random.default_rng(seed)

    def rec(a):
        b = np.ascontiguousarray(a).tobytes()
        n = np.int32(len(b)).astype("<i4").tobytes()
        return n + b + n

    lon = np.linspace(-157.5, 157.5, nx).astype("<f4")
    parts = [np.array([nx], "<i4"), np.array([ny], "<i4"),
             np.array([nz], "<i4"), (np.arange(360) - 179.5).astype("<f4"),
             (np.arange(180) - 89.5).astype("<f4"),
             rng.random((12, 180, 360)).astype("<f4"), lon,
             np.linspace(-75.0, 75.0, ny).astype("<f4"), lon,
             np.array([500.0, 3000.0, 9000.0][:nz], "<f4"),
             (rng.random((12, nz, ny, nx)) * 1e6).astype("<f4")]
    path.write_bytes(b"".join(rec(a) for a in parts))


def test_read_oh_field_equals_jax(tmp_path):
    path = tmp_path / "OH_variables.bin"
    _write_oh_file(path)
    a, b = joh.read_oh_field(path), toh.read_oh_field(path)
    _fields_equal(a, b)
    assert b.oh.shape == (8, 6, 3, 12) and b.jrate_avg.shape == (360, 180, 12)
    j = joh.HourlyOH(a, BDATE).fields_for(43200)[0]
    t = toh.HourlyOH(b, BDATE).fields_for(43200)[0]
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _particles(x, y, z, nspec, seed):
    """numpy particles at (x, y, z), one in 16 inactive, masses from a
    seed."""
    rng = np.random.default_rng(seed)
    n = len(x)
    f32 = np.float32
    zero = np.zeros(n, f32)
    mass = (rng.random((n, nspec)) + 0.5).astype(f32)
    return dict(
        x_hi=x.astype(f32), x_lo=zero, y_hi=y.astype(f32), y_lo=zero,
        z=z.astype(f32), itra=np.full(n, 900, np.int32),
        itramem=np.zeros(n, np.int32), npoint=np.zeros(n, np.int32),
        nclass=np.zeros(n, np.int32), idt=np.zeros(n, np.int32),
        itrasplit=np.full(n, ITRA_INACTIVE, np.int32), up=zero, vp=zero,
        wp=zero, usig=zero, vsig=zero, wsig=zero, cbt=np.ones(n, np.int8),
        mass=mass, mass0=mass.copy(), xscav=np.ones((n, nspec), f32),
        active=np.arange(n) % 16 != 5)


def _random_particles(n, seed):
    rng = np.random.default_rng(seed)
    return _particles(rng.random(n) * 72.0, rng.random(n) * 36.0,
                      rng.random(n) * 17000.0, 3, seed)


def _tie_particles(field):
    """Particles on the midpoints between OH cells in longitude, latitude
    and height at once."""
    gx = (np.asarray(field.lon[:-1], np.float64) + field.lon[1:]) / 2.0
    gy = (np.asarray(field.lat[:-1], np.float64) + field.lat[1:]) / 2.0
    top = field.alt_top
    gz = (top[:-1] + top[1:]) / 2.0
    xs = (gx + 180.0) / 5.0
    ys = (gy + 90.0) / 5.0
    k = np.arange(16 * 64)
    return _particles(xs[k % len(xs)], ys[(k // 3) % len(ys)],
                      gz[(k // 7) % len(gz)], 3, 1)


def _met(device="cpu"):
    grid = make_grid(**GRID)
    from flexpart_tpu_torch.met import calcpar, verttransform
    eta = SyntheticMet(grid).fetch(0.0, device)
    height = verttransform.compute_heights(grid, eta)
    zf = calcpar.calcpar(grid, eta, verttransform.process_eta(grid, eta,
                                                              height))
    return grid, zf


@pytest.mark.parametrize("case", ["random", "midpoints"])
def test_ohreaction_equals_jax(case):
    from flexpart_tpu_torch.met.fields import F3_TT
    # 72 x 36 OH cells of 5 degrees: the midpoints between their centres
    # are multiples of 5 degrees, which the met grid's x * 5 - 180 hits
    # exactly
    fj = joh.synthetic_oh_field(nx=72, ny=36)
    ft = toh.synthetic_oh_field(nx=72, ny=36)
    pop = _random_particles(4096, 3) if case == "random" \
        else _tie_particles(ft)
    grid, zf = _met()
    jgrid = jmet.make_grid(**GRID)
    sp = [jconfig.Species(**REACT), jconfig.Species(**INERT),
          jconfig.Species(**N2)]
    itime, lt = 43200 + 1800, 900
    j_oh = joh.HourlyOH(fj, BDATE).fields_for(itime)
    t_oh = toh.HourlyOH(ft, BDATE).fields_for(itime)
    jp = JParticles(**{f: jnp.asarray(v) for f, v in pop.items()})
    tp = interop.particles_from_numpy(pop, "cpu")
    tt = zf.f3d[F3_TT]
    jz = SimpleNamespace(f3d=jnp.asarray(zf.f3d.numpy()),
                         height=jnp.asarray(zf.height.numpy()))
    jtemps = JaxSimulation._cell_temps(
        SimpleNamespace(particles=jp, grid=jgrid), jz)
    ttemps = toh.cell_temps_plain(tp, tt, zf.height, grid.nx, grid.ny)
    np.testing.assert_array_equal(ttemps.numpy(), np.asarray(jtemps))
    jout = joh.make_ohreaction(fj, jgrid, sp)(
        jp, j_oh[0], j_oh[1], jnp.int32(j_oh[2]), jnp.int32(j_oh[3]),
        jnp.int32(itime), jtemps, jnp.int32(lt))
    fn = toh.make_ohreaction(ft, grid, [tconfig.Species(**s) for s in
                                        (REACT, INERT, N2)], "cpu")
    tout = fn(tp, t_oh[0], t_oh[1], t_oh[2], t_oh[3], itime, tt, zf.height,
              lt)
    a, b = np.asarray(jout.mass), tout.mass.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(b[:, 1], pop["mass"][:, 1])
    live = pop["active"]
    np.testing.assert_array_equal(b[~live], pop["mass"][~live])
    # the day side of the globe loses mass
    assert (b[live, 0] < pop["mass"][live, 0]).mean() > 0.3
    if case == "midpoints":
        # the nearest cells: the first of two equal distances
        g = fn.grid
        xlon = tp.x * g.dx + g.xlon0
        ix = toh._nearest(torch.as_tensor(g.lon), xlon)
        jix = np.argmin(np.abs(np.asarray(fj.lon, np.float32)[None, :]
                               - xlon.numpy()[:, None]), axis=1)
        np.testing.assert_array_equal(ix.numpy(), jix)
        d = np.abs(g.lon[ix.numpy()] - xlon.numpy())
        d1 = np.abs(g.lon[np.minimum(ix.numpy() + 1, 71)] - xlon.numpy())
        assert (d == d1).mean() > 0.9


N = 3008
NSTEPS = 24
ROWS = {**DRAW_ROWS, 2: 1}          # ctl=-5: ifine_eff = 1
FEW_SHARE = 0.005


def _oh_run(c, grid_mod, outdir, **kw):
    """tests/test_physics.py's _depo_sim with the REACT species, 6 h."""
    grid = grid_mod.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=60000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                       lon1=-120.0, lon2=-110.0, lat1=40.0, lat2=55.0,
                       z1=50.0, z2=2000.0, mass=(1.0,), parts=N)
    rel = c.Releases(species=(c.Species(**REACT),), boxes=(box,))
    og = c.OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=90, numygrid=45,
                   dxout=4.0, dyout=4.0, outheights=(500.0, 2000.0, 50000.0))
    return dict(cmd=cmd, releases=rel, grid=grid,
                met_backend=grid_mod.SyntheticMet(grid), outgrid=og,
                outdir=str(outdir), write_netcdf=False, seed=11, **kw)


class _PortGrid:
    make_grid = staticmethod(make_grid)
    SyntheticMet = SyntheticMet


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jsim = JaxSimulation(**_oh_run(jconfig, jmet,
                                   tmp_path_factory.mktemp("jax")))
    jsim.run()
    key = jax.random.PRNGKey(jsim.seed)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS)]
    uniforms = [torch.as_tensor(np.array(jax.random.uniform(
        jax.random.fold_in(key, 1000000 + i), (N,))))
        for i in range(NSTEPS + 1)]
    sim = Simulation(**_oh_run(tconfig, _PortGrid,
                               tmp_path_factory.mktemp("port"),
                               device="cpu"))
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim._redist_hook = lambda istep, origin: uniforms[istep][origin]
    sim.run()
    return jsim, sim


def test_six_hour_oh_run_equals_jax(runs):
    jsim, sim = runs
    assert "ohchem" in sim.timings
    a = float(np.sum(np.asarray(jsim.particles.mass), dtype=np.float64))
    b = float(sim.particles.mass.sum(dtype=torch.float64))
    assert 0.2 < a < 0.999 and 0.2 < b < 0.999
    np.testing.assert_allclose(b, a, rtol=1e-5)
    back = reorder.apply_perm(sim.particles, torch.argsort(sim._origin))
    mt = back.mass[:, 0].numpy()
    mj = np.asarray(jsim.particles.mass)[:, 0]
    err = np.abs(mt - mj) - 1e-5 * np.abs(mj)
    assert int((err > 0).sum()) <= FEW_SHARE * N, err.max()
    assert err.max() <= 1e-3 * np.abs(mj).max()
    for f in ("active", "itra"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jsim.particles, f)))


def test_simulation_from_jax_carries_the_oh_field_and_checkpoint(runs,
                                                                tmp_path):
    """``interop.simulation_from_jax`` carries the OH climatology the JAX
    Simulation holds, its capacity and its checkpoint settings."""
    jsim, _ = runs
    sim = interop.simulation_from_jax(jsim, "cpu", outdir=str(tmp_path))
    assert type(sim.oh_field) is toh.OHField and sim.any_ohreact
    _fields_equal(jsim.oh_field, sim.oh_field)
    assert sim.capacity == jsim.capacity
    assert (sim.checkpoint_at, sim.checkpoint_path) \
        == (jsim.checkpoint_at, jsim.checkpoint_path) == (None,
                                                           "checkpoint.npz")
    jsim.checkpoint_at, jsim.checkpoint_path = 3600, str(tmp_path / "c")
    try:
        sim = interop.simulation_from_jax(jsim, "cpu", outdir=str(tmp_path))
    finally:
        jsim.checkpoint_at, jsim.checkpoint_path = None, "checkpoint.npz"
    assert (sim.checkpoint_at, sim.checkpoint_path) == (3600,
                                                        str(tmp_path / "c"))


# ---- K12's nearest-cell search: its plain mirror against the argmin ----

F32 = np.float32
SEARCH_AXES = {
    "lon": toh.synthetic_oh_field().lon,
    "lat": toh.synthetic_oh_field().lat,
    "alt_top": toh.synthetic_oh_field().alt_top,
    # repeated entries: plateaus of equal distances
    "plateaus": np.array([-5.0, -5.0, -5.0, 0.0, 0.0, 1.0, 7.5, 7.5, 30.0]),
    "one_entry": np.array([3.0]),
    # differences that are subnormal or zero of either sign
    "subnormal": np.array([-0.0, 0.0, 1e-45, 2e-45, 1e-38]),
    "wide": np.array([-3.0e38, -1.0, 0.0, 1.0, 3.0e38]),
}


def _edge_values(axis):
    """What the search has edges at: the midpoints between two entries,
    each entry and a float on either side of it, beyond both ends, +-0,
    +-inf, NaN, the largest floats and subnormals."""
    a = np.asarray(axis, F32)
    mids = ((a[:-1].astype(np.float64) + a[1:]) / 2.0).astype(F32)
    return np.concatenate([
        mids, a, np.nextafter(a, F32(np.inf)), np.nextafter(a, F32(-np.inf)),
        np.nextafter(mids, F32(np.inf)), np.nextafter(mids, F32(-np.inf)),
        [a.min() - 1000.0, a.max() + 1000.0, 0.0, -0.0, np.inf, -np.inf,
         np.nan, 3.0e38, -3.0e38, 1e-45, -1e-45, 1.0e30, -1.0e30]]).astype(F32)


def _argmins(axis, v):
    """(_nearest's index, the search mirror's).  JAX's argmin is not a
    reference here: XLA on the CPU flushes subnormal differences to zero,
    torch and the card do not."""
    at, vt = torch.as_tensor(axis), torch.as_tensor(v)
    return toh._nearest(at, vt).numpy(), toh.nearest_sorted(at, vt).numpy()


@pytest.mark.parametrize("name", sorted(SEARCH_AXES))
def test_nearest_sorted_equals_argmin_on_edges(name):
    """K12's search (``nearest_sorted``, the kernel's in plain torch) finds
    the argmin's index, the first of equal distances, on the search's edge
    values: ties, entries and a float from them, beyond the ends, +-0,
    +-inf, NaN, subnormal differences, plateaus of repeated entries."""
    axis = np.asarray(SEARCH_AXES[name], F32)
    assert toh.sorted_axis(axis)
    ref, got = _argmins(axis, _edge_values(axis))
    np.testing.assert_array_equal(got, ref)
    if name == "plateaus":
        # a plateau's first entry wins: never the second of two equal ones
        assert not np.isin(got, [1, 2, 4, 7]).any()


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(axis=hnp.arrays(F32, st.integers(1, 80),
                       elements=st.floats(-1e6, 1e6, width=32)),
       v=hnp.arrays(F32, 64, elements=st.floats(width=32)))
def test_nearest_sorted_equals_argmin_drawn(axis, v):
    """The same on drawn axes (sorted, so repeated entries come up) and
    drawn values, NaN and +-inf among them."""
    axis = np.sort(axis)
    ref, got = _argmins(axis, np.concatenate([v, _edge_values(axis)]))
    np.testing.assert_array_equal(got, ref)


def test_host_check_sends_unsorted_axes_to_scan():
    """``make_ohreaction`` checks the axes once: the synthetic and a file's
    climatology (sorted, repeated entries allowed) take the search; an
    axis in descending order, with a NaN or an infinity takes K12's SCAN
    instantiation."""
    assert toh.sorted_axis(np.array([1.0, 1.0, 2.0]))
    for bad in ([2.0, 1.0], [0.0, np.nan], [0.0, np.inf], [-np.inf, 0.0]):
        assert not toh.sorted_axis(np.array(bad))
    grid = make_grid(**GRID)
    sp = [tconfig.Species(**REACT)]
    f = toh.synthetic_oh_field()
    assert not toh.make_ohreaction(f, grid, sp, "cpu").grid.scan
    import dataclasses
    for changed in (dict(lon=f.lon[::-1].copy()),
                    dict(lat=np.where(np.arange(len(f.lat)) == 3, np.nan,
                                      f.lat)),
                    dict(alt=f.alt[::-1].copy())):
        g = toh.make_ohreaction(dataclasses.replace(f, **changed), grid, sp,
                                "cpu").grid
        assert g.scan, list(changed)

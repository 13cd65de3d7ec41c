"""Port parity: the dry-deposition velocity field (``make_vdep_kernel``)
and the calcpar hook that fills ``ZFields.vdep``.

Both packages get one ``DrydepTables``, built by the JAX package's
``build_drydep_tables`` from a ``WeselyTables`` and an ``xlanduse`` made
here from a numpy seed (the reference's IGBP and surfdepo files are not in
the repository), and the port's ``build_drydep_tables`` must build the
same one.  Species: a Wesely gas (``reldiff > 0``, a Henry constant and a
reactivity), a sized aerosol (density, diameter, spread: the partdep
branch), a species with only a constant velocity and one without dry
deposition.  The surface fields (ust, T2, rh, ps, 1/L, radiation,
precipitation, snow) come from the same seed with snow-covered cells,
cells wet by rain or by rh > 0.9, and temperatures on both sides of the
stomatal window 0-40 C.

Tolerance: rtol 2e-5 on every cell.  The chain is some 80 float32
operations deep, XLA:CPU contracts products and sums into FMAs, its
``pow``/``log``/``exp`` are not torch's, and the two packages add the 13
landuse classes in different orders; every cell agrees to a few ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.config import Species  # noqa: E402
from flexpart_tpu.physics import drydepo as jdd  # noqa: E402
from flexpart_tpu.physics import landuse as jlu  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.met import calcpar as tcp  # noqa: E402
from flexpart_tpu_torch.met.fields import eta_from_numpy  # noqa: E402
from flexpart_tpu_torch.physics import drydepo as tdd  # noqa: E402
from flexpart_tpu_torch.physics import landuse as tlu  # noqa: E402

NY, NX = 19, 37
SPECIES = (
    Species(name="SO2", reldiff=1.9, henry=1.0e5, f0=0.1, dryvel=-9.99),
    Species(name="AERO", density=2500.0, dquer=0.8, dsigma=1.8),
    Species(name="CONST", dryvel=0.004),
    Species(name="NONE"),
)


def _wesely(rs):
    rows = {k: rs.uniform(50.0, 5000.0, (5, 13)) for k in
            ("ri", "rluh", "rac", "rgssh", "rgsoh", "rclsh", "rcloh")}
    rows["ri"][:, 6] = 1.0e25                 # water: no stomata
    rows["rac"][:, 11] = 0.001                # the floor
    return rows


def _tables(rs, lu):
    xl = rs.uniform(0.0, 1.0, (NY, NX, 13))
    xl[rs.uniform(size=(NY, NX, 13)) < 0.6] = 0.0
    xl /= np.maximum(xl.sum(-1, keepdims=True), 1e-30)
    z0 = rs.uniform(0.001, 1.0, 13)
    wt = lu.WeselyTables(**_wesely(rs))
    return xl, z0, wt


def _surface(rs):
    tt2 = rs.uniform(250.0, 320.0, (NY, NX))
    f = dict(ust=rs.uniform(0.0, 0.8, (NY, NX)), tt2=tt2,
             rh=rs.uniform(0.3, 1.0, (NY, NX)),
             ps=rs.uniform(7.0e4, 1.03e5, (NY, NX)),
             oli=rs.uniform(-0.05, 0.05, (NY, NX)),
             ssr=rs.uniform(0.0, 800.0, (NY, NX)),
             precip=np.where(rs.uniform(size=(NY, NX)) < 0.3,
                             rs.uniform(0.0, 5.0, (NY, NX)), 0.0),
             sd=np.where(rs.uniform(size=(NY, NX)) < 0.2, 0.05, 0.0))
    f["ust"][0, :3] = 0.0                     # calm: the aerosol's vs only
    return {k: v.astype(np.float32) for k, v in f.items()}


def test_build_drydep_tables_matches_jax():
    rs = np.random.default_rng(0)
    xl, z0, wt = _tables(rs, jlu)
    j = jdd.build_drydep_tables(SPECIES, xl, z0, wt, 715, -90.0, 10.0, NY)
    t = tdd.build_drydep_tables(SPECIES, xl, z0,
                                tlu.WeselyTables(**wt.__dict__), 715, -90.0,
                                10.0, NY)
    for f in j.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert list(t.gas_mask) == [True, False, False, False]
    assert list(t.aero_mask) == [False, True, False, False]
    assert len(set(t.season.tolist())) > 1


def test_vdep_field_matches_jax():
    rs = np.random.default_rng(1)
    xl, z0, wt = _tables(rs, jlu)
    td = jdd.build_drydep_tables(SPECIES, xl, z0, wt, 115, -90.0, 10.0, NY)
    f = _surface(rs)
    args = ("ust", "tt2", "rh", "ps", "oli", "ssr", "precip", "sd")
    j = np.asarray(jdd.make_vdep_kernel(td)(
        *(jnp.asarray(f[k]) for k in args)))
    t = tdd.make_vdep_kernel(interop.drydep_tables_from_jax(td))(
        *(torch.as_tensor(f[k]) for k in args)).numpy()
    assert t.shape == j.shape == (len(SPECIES), NY, NX)
    assert t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=2e-5, atol=0)
    snow, wet = f["sd"] > 0.001, (f["rh"] > 0.9) | (f["precip"] > 0)
    assert snow.any() and wet.any() and (~wet & ~snow).any()
    assert (t[:2] >= 0).all() and (t[:2] > 0).mean() > 0.9
    np.testing.assert_array_equal(t[2], np.float32(0.004))
    assert (t[3] == 0).all()


def test_constant_vdep_kernel_is_a_contiguous_field():
    k = tdd.constant_vdep_kernel(SPECIES)
    ust = torch.zeros(NY, NX)
    v = k(ust, ust, ust, ust, ust, ust, ust, ust)
    assert v.shape == (4, NY, NX) and v.is_contiguous()
    assert v[2].unique().tolist() == [np.float32(0.004)]
    assert float(v[[0, 1, 3]].abs().sum()) == 0.0    # max(dryvel, 0)


def test_calcpar_fills_vdep_like_jax():
    grid = jmet.make_grid(nx=NX, ny=NY, nlev=15, dx=10.0, dy=10.0)
    eta = jmet.SyntheticMet(grid).fetch(3600.0)
    h = jmet.compute_heights(grid, eta)
    rs = np.random.default_rng(2)
    xl, z0, wt = _tables(rs, jlu)
    td = jdd.build_drydep_tables(SPECIES, xl, z0, wt, 101, grid.ylat0,
                                 grid.dy, grid.ny)
    jz = jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h),
                      vdep_kernel=jdd.make_vdep_kernel(td))
    tgrid = interop.metgrid_from_jax(grid)
    teta = eta_from_numpy({k: np.asarray(v) for k, v in eta._asdict().items()},
                          "cpu")
    tz0 = interop.zfields_from_numpy(
        {k: np.asarray(v) for k, v in
         jmet.process_eta(grid, eta, h)._asdict().items()}, "cpu")
    tz = tcp.calcpar(tgrid, teta, tz0, vdep_kernel=tdd.make_vdep_kernel(
        interop.drydep_tables_from_jax(td)))
    jv = np.asarray(jz.vdep)
    tv = tz.vdep.numpy()
    assert tv.shape == jv.shape == (len(SPECIES), NY, NX)
    np.testing.assert_allclose(tv, jv, rtol=2e-5, atol=0)
    assert (tv[:2] > 0).mean() > 0.9

"""Port parity: wet scavenging (``wetscav_all``, the twin of kernel K9's
first half) and the deposit scatter (``make_depokernel``, the twin of
kernel K8) against the JAX package.

``wetscav_all`` runs on ``ZFields`` that the JAX package made from one
``SyntheticMet`` field on the 37x19x15 grid and handed to the port as
numpy arrays.  SyntheticMet's clouds start at level 1 and carry the
classes 0-3 only, and its temperatures at the cloud levels stay above
273 K, so both packages get the same field with two parts replaced from
a numpy seed: the cloud class of every cell (0-5, so every branch of
in-cloud, below-cloud and no cloud is met) and its temperature (245-280 K,
across the 253-273 K ice/liquid ramp and the rain/snow switch at 273 K);
for ``use_clouds_water`` also the column cloud water.  The particles lie
in SyntheticMet's rain bands and anywhere else, at 0-3000 m.

One species per branch: a below-cloud gas (A * P**B); a below-cloud
aerosol, rain and snow; an in-cloud aerosol (CCN/IN); a gas with the
in-cloud Henry rule (below cloud it takes A * P**B: a gas without A or B
does not deposit wet); a species with no wet deposition.

Held: the particles with lambda > 0 are the same in both packages, per
species, so the masks ``raining & in_cloudy & below`` (below-cloud rules)
and ``raining & in_cloudy & ~below`` (in-cloud rules) agree; lambda and
grfraction within rtol 1e-5: XLA:CPU contracts products and sums into
FMAs (``cc * (lsp * lfr + convp * cfr)``, the bilinear sums) and its
``pow`` and ``exp`` are not torch's, so the same float32 operations agree
to a few ulps, which the powers of ``prec`` widen.  The deposit of the
chain within rtol 1e-5 plus two ulps of 1 times mass x grfraction: 1 -
exp(-lambda dt) cancels where lambda dt is small.

The deposit scatter: particles with nage, nclass and release index > 1,
inactive ones, on a 2**-12 lattice so that XLA's FMA in ``x * dx_met +
xoutshift`` changes no bit; spread over the output grid and past its
edges, or as a plume in a handful of output cells with mostly zero
deposits (K8's hard case); rtol 1e-6 (only the order of the float
additions into a cell differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.config import OutGrid, Species  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.grid import outgrid as jog  # noqa: E402
from flexpart_tpu.met.fields import F2_CTWC, F3_TT  # noqa: E402
from flexpart_tpu.physics import massupdate as jmu  # noqa: E402
from flexpart_tpu.physics import wetdepo as jwd  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.grid import conccalc as tcc  # noqa: E402
from flexpart_tpu_torch.physics import massupdate as tmu  # noqa: E402
from flexpart_tpu_torch.physics import wetdepo as twd  # noqa: E402

N = 4096
SPECIES = {
    "below_gas": Species(weta_gas=1.0e-4, wetb_gas=0.62),
    "below_aerosol": Species(dquer=0.4, crain_aero=1.0, csnow_aero=0.5),
    "in_cloud_aerosol": Species(dquer=0.4, ccn_aero=0.9, in_aero=0.1),
    "in_cloud_gas": Species(weta_gas=1.0e-4, wetb_gas=0.62, henry=1.0e5),
    "none": Species(),
}


@pytest.fixture(scope="module")
def fields():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    eta = jmet.SyntheticMet(grid).fetch(3600.0)
    h = jmet.compute_heights(grid, eta)
    z = jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h))
    rs = np.random.default_rng(11)
    clouds = rs.integers(0, 6, np.asarray(z.clouds).shape).astype(np.int8)
    f3d = np.array(z.f3d)
    f3d[F3_TT] = rs.uniform(245.0, 280.0, f3d[F3_TT].shape)
    f2d = np.array(z.f2d)
    f2d[F2_CTWC] = rs.uniform(0.0, 2.0, f2d[F2_CTWC].shape)
    jz = z._replace(clouds=jnp.asarray(clouds), f3d=jnp.asarray(f3d),
                    f2d=jnp.asarray(f2d))
    tz = interop.zfields_from_numpy(
        {k: np.asarray(v) for k, v in jz._asdict().items()}, "cpu")
    return grid, jz, tz


def _particles(grid, seed=0):
    rs = np.random.default_rng(seed)
    # half in the storm bands around 50 N/S, half anywhere
    band = rs.uniform(size=N) < 0.5
    lat = np.where(band, rs.choice([-1.0, 1.0], N) * rs.uniform(40, 60, N),
                   rs.uniform(-89.0, 89.0, N))
    lon = rs.uniform(-179.0, 179.0, N)
    x = ((lon - grid.xlon0) / grid.dx).astype(np.float32)
    y = ((lat - grid.ylat0) / grid.dy).astype(np.float32)
    p = jstate.empty_particles(N, nspec=len(SPECIES))
    return p._replace(
        x_hi=jnp.asarray(x), y_hi=jnp.asarray(y),
        z=jnp.asarray(rs.uniform(0.0, 3000.0, N).astype(np.float32)),
        active=jnp.asarray(rs.uniform(size=N) < 0.95),
        mass=jnp.asarray(rs.uniform(0.5, 1.5, (N, len(SPECIES)))
                         .astype(np.float32)))


def _port(p):
    return interop.particles_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p._fields}, "cpu")


@pytest.mark.parametrize("use_clouds_water", [False, True])
def test_wetscav_all_matches_jax(fields, use_clouds_water):
    grid, jz, tz = fields
    p = _particles(grid)
    jsp = tuple(jwd.WetSpecies.from_species(s) for s in SPECIES.values())
    tsp = tuple(twd.WetSpecies.from_species(s) for s in SPECIES.values())
    assert tuple(tuple(w) for w in jsp) == tuple(tuple(w) for w in tsp)
    jlam, jgrf = jwd.wetscav_all(p, jz, jnp.int32(3600), jnp.int32(900),
                                 jsp, use_clouds_water)
    tlam, tgrf = twd.wetscav_all_plain(_port(p), tz, tsp, use_clouds_water)
    jlam, jgrf = np.asarray(jlam), np.asarray(jgrf)
    tlam, tgrf = tlam.numpy(), tgrf.numpy()
    assert tlam.shape == jlam.shape == (len(SPECIES), N)
    np.testing.assert_allclose(tgrf, jgrf, rtol=1e-5)
    for k, name in enumerate(SPECIES):
        np.testing.assert_array_equal(tlam[k] > 0, jlam[k] > 0, err_msg=name)
        np.testing.assert_allclose(tlam[k], jlam[k], rtol=1e-5, atol=0,
                                   err_msg=name)
    # every branch was met, on both sides of the rain/snow switch
    hit = {name: int((tlam[k] > 0).sum()) for k, name in enumerate(SPECIES)}
    assert hit["none"] == 0 and min(v for k, v in hit.items()
                                    if k != "none") >= 20, hit
    cold = np.asarray(jz.f3d[F3_TT]) < 273.0
    assert cold.any() and (~cold).any()


def test_wet_deposition_is_the_plain_chain_on_the_cpu(fields):
    """The device dispatch takes wetscav_all_plain + apply_wetdepo_plain
    for CPU tensors, and the chain equals the JAX pair."""
    grid, jz, tz = fields
    p = _particles(grid, seed=1)
    decay = tuple(0.693147 / 3600.0 if k % 2 else -1.0
                  for k in range(len(SPECIES)))
    msp = dict(decay=decay, drydep=(False,) * len(SPECIES))
    jsp = tuple(jwd.WetSpecies.from_species(s) for s in SPECIES.values())
    tsp = tuple(twd.WetSpecies.from_species(s) for s in SPECIES.values())
    jlam, jgrf = jwd.wetscav_all(p, jz, jnp.int32(3600), jnp.int32(900),
                                 jsp, False)
    jp, jdep = jmu.apply_wetdepo(p, jlam, jgrf, jnp.int32(900),
                                 jnp.int32(2700), jmu.MassSpecies(**msp))
    tp, tdep = twd.wet_deposition(_port(p), tz, 900, 2700, tsp,
                                  tmu.MassSpecies(**msp))
    np.testing.assert_allclose(tp.mass.numpy(), np.asarray(jp.mass),
                               rtol=1e-6)
    # 1 - exp(-lambda dt) cancels where lambda dt is small: the two exp
    # may differ by an ulp near 1 (6e-8), which the deposit carries as an
    # absolute error of up to two ulps of 1 times mass x grfraction
    cancel = 2.0 ** -22 * (np.asarray(p.mass) * np.asarray(jgrf)[:, None]).T
    err = np.abs(tdep.numpy() - np.asarray(jdep))
    assert (err <= 1e-5 * np.abs(np.asarray(jdep)) + cancel).all(), err.max()
    assert float(tdep.sum()) > 0.0
    meta = type(tp)(**{f: getattr(tp, f).to("meta")
                       for f in tp.__dataclass_fields__})
    with pytest.raises(ValueError, match="backend"):
        twd.wet_deposition(meta, tz, 900, 2700, tsp, tmu.MassSpecies(**msp))


def test_wet_deposition_with_clwc_is_the_plain_chain_on_the_cpu(fields):
    """``use_clwc``: the in-cloud rules take the column cloud water (the
    fixture's seeded ``ctwc``); the device dispatch takes the plain chain
    with it for CPU tensors, and the chain equals the JAX pair with
    ``use_clouds_water=True``, to the tolerances of the test above.  The
    in-cloud particles' deposits differ from those of the rate's cloud
    water."""
    grid, jz, tz = fields
    p = _particles(grid, seed=2)
    msp = dict(decay=(-1.0,) * len(SPECIES), drydep=(False,) * len(SPECIES))
    jsp = tuple(jwd.WetSpecies.from_species(s) for s in SPECIES.values())
    tsp = tuple(twd.WetSpecies.from_species(s) for s in SPECIES.values())
    jlam, jgrf = jwd.wetscav_all(p, jz, jnp.int32(3600), jnp.int32(900),
                                 jsp, True)
    jp, jdep = jmu.apply_wetdepo(p, jlam, jgrf, jnp.int32(900),
                                 jnp.int32(2700), jmu.MassSpecies(**msp))
    tp, tdep = twd.wet_deposition(_port(p), tz, 900, 2700, tsp,
                                  tmu.MassSpecies(**msp), use_clwc=True)
    np.testing.assert_allclose(tp.mass.numpy(), np.asarray(jp.mass),
                               rtol=1e-6)
    cancel = 2.0 ** -22 * (np.asarray(p.mass) * np.asarray(jgrf)[:, None]).T
    err = np.abs(tdep.numpy() - np.asarray(jdep))
    assert (err <= 1e-5 * np.abs(np.asarray(jdep)) + cancel).all(), err.max()
    _, rate = twd.wet_deposition(_port(p), tz, 900, 2700, tsp,
                                 tmu.MassSpecies(**msp))
    k = list(SPECIES).index("in_cloud_aerosol")
    assert float(tdep[k].sum()) > 0.0
    assert not torch.equal(tdep[k], rate[k])


def test_below_cloud_constants_fold_like_jax():
    """The aerosol polynomial's base is float64 on the host and float32 in
    the arithmetic, in both packages; the Henry factor likewise."""
    for coeffs in (twd.BCLR, twd.BCLS):
        for d in (0.05, 0.4, 3.0, 20.0):
            prec = jnp.asarray(np.float32([0.5, 2.0]))
            j = np.asarray(jwd._below_cloud_aerosol(coeffs, 1.0, d, prec))
            t = twd._below_cloud_aerosol(coeffs, 1.0, d,
                                         torch.tensor(np.asarray(prec)))
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)
    specs = twd.wet_specs(tuple(twd.WetSpecies.from_species(s)
                                for s in SPECIES.values()),
                          tmu.MassSpecies(decay=(1e-5,) * 5,
                                          drydep=(False,) * 5))
    assert [specs[k].below for k in range(5)] == [1, 2, 0, 1, 0]
    assert [specs[k].incloud for k in range(5)] == [0, 0, 1, 2, 0]
    assert specs[3].henry_r == np.float32(1.0e5 * (287.05 / 3500.0))
    assert specs[1].rain_base == np.float32(
        twd._below_cloud_base(twd.BCLR, 0.4))


OG = OutGrid(outlon0=-60.0, outlat0=-30.0, numxgrid=48, numygrid=30,
             dxout=2.5, dyout=2.0, outheights=(300.0, 2000.0, 10000.0))


@pytest.mark.parametrize("layout", ["spread", "plume"])
def test_depo_scatter_matches_jax(fields, layout):
    grid = fields[0]
    jgeo = jog.OutputGridGeometry(OG, grid)
    rs = np.random.default_rng(5)
    nage, nclass, npoint = 2, 2, 3
    if layout == "spread":
        lon = rs.uniform(-65.0, 65.0, N)      # straddles every edge
        lat = rs.uniform(-35.0, 35.0, N)
    else:                                     # a plume in a few output cells
        lon = rs.uniform(10.0, 12.4, N)
        lat = rs.uniform(4.2, 7.8, N)
    x = (np.round((lon - grid.xlon0) / grid.dx * 4096) / 4096).astype(np.float32)
    y = (np.round((lat - grid.ylat0) / grid.dy * 4096) / 4096).astype(np.float32)
    p = jstate.empty_particles(N, nspec=2)._replace(
        x_hi=jnp.asarray(x), y_hi=jnp.asarray(y),
        nclass=jnp.asarray(rs.integers(0, nclass, N).astype(np.int32)),
        npoint=jnp.asarray(rs.integers(0, npoint, N).astype(np.int32)),
        active=jnp.asarray(rs.uniform(size=N) < 0.9))
    deposit = rs.uniform(0.0, 1.0, (2, N)).astype(np.float32)
    if layout == "plume":                     # mostly zero: the tracer and 95%
        deposit[0] = 0.0
        deposit[1] *= rs.uniform(size=N) < 0.05
    nage_idx = rs.integers(0, nage, N).astype(np.int32)
    kp = np.array(p.npoint)
    scatter = jwd.make_depokernel(
        jgeo.nxg, jgeo.nyg, npoint, nclass, nage, OG.dxout, OG.dyout,
        jgeo.xoutshift, jgeo.youtshift, grid.dx, grid.dy)
    shape = (nage, nclass, npoint, jgeo.nyg, jgeo.nxg, 2)
    jgrid = np.asarray(scatter(jnp.zeros(shape, jnp.float32),
                               jnp.asarray(deposit), p, jnp.asarray(nage_idx),
                               jnp.asarray(kp)))
    cfg = tcc.ConcConfig(nxg=jgeo.nxg, nyg=jgeo.nyg, nzg=jgeo.nzg,
                         npointspec=npoint, nclassunc=nclass, nage=nage,
                         dxout=OG.dxout, dyout=OG.dyout,
                         xoutshift=jgeo.xoutshift, youtshift=jgeo.youtshift,
                         dx_met=grid.dx, dy_met=grid.dy, ind_samp=0)
    tp = _port(p)
    tgrid = torch.zeros(shape, dtype=torch.float32)
    twd.depo_scatter_plain(tgrid.view(-1, 2), torch.as_tensor(deposit), tp,
                           torch.as_tensor(nage_idx).long(),
                           torch.as_tensor(kp).long(), cfg)
    np.testing.assert_allclose(tgrid.numpy(), jgrid, rtol=1e-6, atol=1e-12)
    # pairs outside the grid and of inactive particles were dropped
    lin, valid, _ = twd.depo_pairs(tgrid.numel() // 2,
                                   torch.as_tensor(deposit), tp,
                                   torch.as_tensor(nage_idx).long(),
                                   torch.as_tensor(kp).long(), cfg)
    assert not bool(valid[~tp.active].any())
    active = tp.active.numpy()
    if layout == "spread":
        assert 0 < int(valid.sum()) < 4 * int(active.sum())
        assert 0.0 < float(tgrid.sum()) < float(deposit.sum())
    else:                 # every corner in the grid, a handful of cells hit
        assert int(valid.sum()) == 4 * int(active.sum())
        assert 0 < int((tgrid != 0).any(-1).sum()) <= 2 * 2 * 3 * 25
        assert float(tgrid[..., 0].abs().sum()) == 0.0
        np.testing.assert_allclose(float(tgrid.sum()),
                                   float(deposit[:, active].sum()), rtol=1e-5)

    # the dispatch on the CPU: the age class from itime and lage, as the JAX
    # Simulation's _scatter_depo takes it
    itramem = rs.integers(0, 3 * 3600, N).astype(np.int32)
    tp = tp.replace(itramem=torch.as_tensor(itramem))
    lage = np.asarray([3600, 999999], np.int32)
    itime = 3 * 3600
    jage = np.clip(np.searchsorted(lage, np.abs(itime - itramem),
                                   side="right"), 0, nage - 1)
    jgrid = np.asarray(scatter(jnp.zeros(shape, jnp.float32),
                               jnp.asarray(deposit), p,
                               jnp.asarray(jage.astype(np.int32)),
                               jnp.asarray(kp)))
    tgrid = torch.zeros(shape, dtype=torch.float32)
    cfg = cfg.replace(ioutputforeachrelease=True)
    out = twd.depo_scatter(tgrid, torch.as_tensor(deposit), tp, itime,
                           torch.as_tensor(lage), cfg)
    assert out is tgrid
    np.testing.assert_allclose(tgrid.numpy(), jgrid, rtol=1e-6, atol=1e-12)
    assert float(tgrid[0].sum()) > 0.0 and float(tgrid[1].sum()) > 0.0


def test_k9_path_counts_follow_the_plain_chain(fields):
    """The operation count of K9's bound (``chip_smoke.k9_path_calls``):
    the (particle, species) that take each scavenging rule, counted from
    the cell lookup, are those the plain chain gives a lambda > 0, rule by
    rule; the removal runs once for each."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    grid, _, tz = fields
    tp = _port(_particles(grid, seed=3))
    tsp = tuple(twd.WetSpecies.from_species(s) for s in SPECIES.values())
    msp = tmu.MassSpecies(decay=(0.0,) * len(SPECIES),
                          drydep=(False,) * len(SPECIES))
    calls = chip_smoke.k9_path_calls(tp, tz, tsp, msp)
    lam, _ = twd.wetscav_all_plain(tp, tz, tsp, False)
    hit = (lam > 0).sum(1).tolist()
    # below_gas, below_aerosol, in_cloud_aerosol, in_cloud_gas (A * P**B
    # below cloud, Henry in cloud), none
    assert calls["lam_below_aerosol"] == hit[1] > 0
    assert calls["lam_in_cloud_aerosol"] == hit[2] == calls["cloud_water"] > 0
    assert calls["lam_below_gas"] + calls["lam_in_cloud_gas"] \
        == hit[0] + hit[3]
    assert calls["lam_below_gas"] == 2 * hit[0] > 0
    assert hit[4] == 0
    assert calls["wet_removal"] == int((lam > 0).sum())
    assert calls["active_raining"] >= int((lam > 0).any(0).sum())


def test_depo_scatter_kernel_takes_at_most_max_species(fields):
    """K8's tables in shared memory hold a row's species: its wrapper
    refuses more than MAX_SPECIES before it launches anything."""
    n = 64
    tp = interop.particles_from_numpy(
        {f: np.asarray(getattr(jstate.empty_particles(n, nspec=1), f))
         for f in jstate.Particles._fields}, "cpu")
    nspec = tmu.MAX_SPECIES + 1
    cfg = tcc.ConcConfig(nxg=4, nyg=3, nzg=1, npointspec=1, nclassunc=1,
                         nage=1, dxout=1.0, dyout=1.0, xoutshift=0.0,
                         youtshift=0.0, dx_met=1.0, dy_met=1.0, ind_samp=0)
    with pytest.raises(ValueError, match="species"):
        twd.depo_scatter_cuda(torch.zeros((12, nspec)),
                              torch.zeros((nspec, n)), tp, 0,
                              torch.zeros(1, dtype=torch.int32), cfg)

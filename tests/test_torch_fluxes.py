"""Port parity for the gross fluxes (``iflux=1``; ``grid/fluxes.py``,
kernel K16 on a card, its plain version here).

``write_flux`` / ``read_flux`` (numpy in both packages) byte for byte on
the same flux arrays, with faces in the sparse and in the dense layout.

The plain version against JAX's ``make_calcfluxes`` on the same particles
(old and new positions, made with numpy): the same faces crossed (the
non-zero cells equal) and the sums within rtol 1e-6 (index_add_ and
XLA's scatter add in other orders).

One JAX ``Simulation`` run with ``iflux=1`` that crosses the sort of step
16 and releases on several steps (the two events after which the slots
of ``xold``, ``yold``, ``zold`` would be stale if they were taken before
the sort), against the port's with JAX's draws injected: the same files,
the npz flux sums within 1e-3 of the largest cell of their face and the
same total per face within rtol 1e-3 (a particle a hair apart in the two
packages can cross one face more or less; the advance's positions agree
within 1e-4 grid units, tests/test_torch_sim.py); the reference's files
read back by both packages' readers into the same arrays.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core.state import Particles as JParticles  # noqa: E402
from flexpart_tpu.grid import fluxes as jflux  # noqa: E402
from flexpart_tpu.io import fortran_writer as jfw  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.grid import fluxes as tflux  # noqa: E402
from flexpart_tpu_torch.io import fortran_writer as tfw  # noqa: E402

GRID = dict(nx=37, ny=15, nlev=15, dx=10.0, dy=10.0, ylat0=-70.0)
N = 1008
SEED = 6
NSTEPS = 20
ROWS = {**DRAW_ROWS, 2: 1}
HEIGHTS = (150.0, 500.0, 2000.0, 50000.0)


def _config(c):
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=50000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    lsubgrid=0, iflux=1)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=10000, lon1=0.0, lon2=2.0, lat1=40.0,
                       lat2=42.0, z1=50.0, z2=3000.0, mass=(1.0,), parts=N)
    rel = c.Releases(species=(c.Species(),), boxes=(box,))
    og = c.OutGrid(outlon0=-10.0, outlat0=30.0, numxgrid=40, numygrid=25,
                   dxout=1.0, dyout=1.0, outheights=HEIGHTS)
    return cmd, rel, og


def _flux_config(c, nage=2):
    return c.FluxConfig(nxg=40, nyg=25, nzg=4, npointspec=2, nage=nage,
                        dxout=1.0, dyout=1.0, xoutshift=-170.0,
                        youtshift=-100.0, dx_met=10.0, dy_met=10.0,
                        nx_met=37)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cmd, rel, og = _config(jconfig)
    grid = jmet.make_grid(**GRID)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=jmet.SyntheticMet(grid), outgrid=og,
                        outdir=str(tmp_path_factory.mktemp("jax_flux")),
                        seed=SEED, write_netcdf=False, write_npz=False)
    sim.run()
    key = jax.random.PRNGKey(SEED)
    draws = [{t: torch.as_tensor(np.array(jrng.normals(
        jax.random.fold_in(key, i), (r, N), tag=t))) for t, r in ROWS.items()}
        for i in range(NSTEPS)]
    return sim, draws


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    jsim, draws = jax_run
    sim = interop.simulation_from_jax(
        jsim, "cpu", outdir=str(tmp_path_factory.mktemp("port_flux")))
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    return sim


def test_flux_config_is_jaxs():
    assert tflux.FluxConfig._fields == jflux.FluxConfig._fields
    assert tflux.MAX_SPAN == jflux.MAX_SPAN
    np.testing.assert_array_equal(
        tflux.half_levels(HEIGHTS),
        np.concatenate([np.zeros(1), 0.5 * (np.float32(HEIGHTS[:-1])
                                            + np.float32(HEIGHTS[1:])),
                        np.float32(HEIGHTS[-1:]) * 2.0]).astype(np.float32))


@pytest.mark.parametrize("dense", [False, True])
def test_flux_file_is_the_references_bytes(dense, tmp_path):
    """A sparse and a dense face layout (fluxoutput.f90's 2/5 rule)."""
    rs = np.random.default_rng(3)
    shape = (6, 2, 1, 3, 5, 7, 2)
    flux = rs.random(shape).astype(np.float32)
    if not dense:
        flux *= rs.random(shape) < 0.1
    area = rs.uniform(1e9, 2e9, (5, 7))
    ae = rs.uniform(1e8, 2e8, (3, 5, 7))
    an = rs.uniform(1e8, 2e8, (3, 5, 7))
    jfw.write_flux(tmp_path / "j", 3600, flux, ae, an, area, 3600.0)
    tfw.write_flux(tmp_path / "t", 3600, flux, ae, an, area, 3600.0)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    it, back = tfw.read_flux(tmp_path / "t", shape)
    jt, jback = jfw.read_flux(tmp_path / "j", shape)
    assert it == jt == 3600
    np.testing.assert_array_equal(back, jback)
    assert (back > 0).sum() == (flux > 0).sum()


def _pairs(n, seed, itime):
    rs = np.random.default_rng(seed)
    f32 = np.float32
    x = rs.uniform(16.0, 22.0, n).astype(f32)
    y = rs.uniform(9.0, 12.0, n).astype(f32)
    z = rs.uniform(0.0, 3000.0, n).astype(f32)
    pop = dict(
        x_hi=(x + rs.uniform(-0.4, 0.4, n)).astype(f32),
        x_lo=rs.uniform(-1e-6, 1e-6, n).astype(f32),
        y_hi=(y + rs.uniform(-0.3, 0.3, n)).astype(f32),
        y_lo=np.zeros(n, f32),
        z=np.maximum(z + rs.uniform(-800.0, 800.0, n), 0.0).astype(f32),
        itra=np.where(rs.random(n) < 0.9, itime, 0).astype(np.int32),
        itramem=rs.integers(0, itime, n).astype(np.int32),
        npoint=rs.integers(0, 2, n).astype(np.int32),
        nclass=np.zeros(n, np.int32), idt=np.zeros(n, np.int32),
        itrasplit=np.zeros(n, np.int32),
        up=np.zeros(n, f32), vp=np.zeros(n, f32), wp=np.zeros(n, f32),
        usig=np.zeros(n, f32), vsig=np.zeros(n, f32), wsig=np.zeros(n, f32),
        cbt=np.ones(n, np.int8),
        mass=rs.uniform(0.5, 1.5, (n, 2)).astype(f32),
        mass0=np.ones((n, 2), f32), xscav=np.ones((n, 2), f32),
        active=rs.random(n) < 0.95)
    return pop, x, y, z


def test_flux_twin_equals_jax():
    itime = 10800
    pop, xold, yold, zold = _pairs(6000, 4, itime)
    lage = np.asarray([3600, 7200], np.int32)
    calc = jflux.make_calcfluxes(HEIGHTS)
    jcfg, tcfg = _flux_config(jflux), _flux_config(tflux)
    jp = JParticles(**{k: jnp.asarray(v) for k, v in pop.items()})
    itage = jnp.abs(jnp.int32(itime) - jp.itramem)
    nage_idx = jnp.clip(jnp.searchsorted(jnp.asarray(lage), itage,
                                         side="right"), 0, 1)
    j = np.asarray(calc(jflux.zero_flux(jcfg, 2), jp, jnp.asarray(xold),
                        jnp.asarray(yold), jnp.asarray(zold), nage_idx,
                        jp.npoint, jnp.int32(itime), jcfg))
    p = interop.particles_from_numpy(pop, "cpu")
    t = tflux.zero_flux(tcfg, 2)
    run = tflux.make_calcfluxes(HEIGHTS, "cpu")
    run(t, p, torch.as_tensor(xold), torch.as_tensor(yold),
        torch.as_tensor(zold), itime, torch.as_tensor(lage), tcfg)
    t = t.numpy()
    assert t.shape == j.shape
    for face in range(6):
        assert j[face].sum() > 0, face
    np.testing.assert_array_equal(t != 0, j != 0)
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_fluxes_in_simulation_equal_jax(jax_run, port_run):
    jsim, sim = jax_run[0], port_run
    jout, tout = Path(jsim.outdir), Path(sim.outdir)
    names = sorted(p.name for p in jout.iterdir())
    assert sorted(p.name for p in tout.iterdir()) == names
    assert sim.n_sorts >= 2 and len(sim._release_times) > 1
    jnpz = sorted(jout.glob("grid_flux_*.npz"))
    assert len(jnpz) == 4
    shape = np.load(jnpz[0])["flux"].shape
    crossed = np.zeros(6)
    for f in jnpz:
        j, t = np.load(f)["flux"], np.load(tout / f.name)["flux"]
        assert t.shape == j.shape == shape
        for face in range(6):
            jf, tf = j[face], t[face]
            crossed[face] += jf.sum()
            np.testing.assert_allclose(tf.sum(), jf.sum(), rtol=1e-3)
            np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3 * jf.max())
        stem = f.name[:-4]
        it, a = tfw.read_flux(tout / stem, shape)
        jt, b = jfw.read_flux(jout / stem, shape)
        assert it == jt
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * b.max())
    # SyntheticMet's westerlies: every face but the west one is crossed
    assert crossed[0] > crossed[1] and (np.delete(crossed, 1) > 0).all()


def test_flux_rows_above_the_limit_are_refused_by_name():
    """K16 matches flux rows on 32 bits (csrc/warp_groups.cuh's MAX_ROWS,
    K3's, K8's and K17's limit): its wrapper refuses a flux array of more
    rows by name before it touches the card; one at the limit passes that
    check."""
    import re
    from flexpart_tpu_torch import _build
    text = (_build.CSRC / "warp_groups.cuh").read_text()
    m = re.search(r"MAX_ROWS = (0x[0-9A-F]+)ll - (\d+);", text)
    assert int(m.group(1), 16) - int(m.group(2)) == tflux.K16_MAX_ROWS \
        == 2 ** 32 - 33
    assert "MAX_ROWS" in _build.FLUXES.source.read_text()
    big = _flux_config(tflux)._replace(nxg=7200, nyg=3600, nzg=30)
    assert tflux.flux_rows(big) > tflux.K16_MAX_ROWS
    pop, xold, yold, zold = _pairs(64, 5, 10800)
    p = interop.particles_from_numpy(pop, "cpu")
    lage = torch.as_tensor(np.asarray([3600, 7200], np.int32))
    oh = torch.as_tensor(np.asarray(HEIGHTS, np.float32))
    ohh = torch.as_tensor(tflux.half_levels(HEIGHTS))
    with pytest.raises(ValueError, match="K16_MAX_ROWS"):
        tflux.calcfluxes_cuda(torch.zeros(1), p, torch.as_tensor(xold),
                              torch.as_tensor(yold), torch.as_tensor(zold),
                              10800, lage, oh, ohh, big)
    # at the limit the row check passes: the wrapper then refuses the
    # placeholder flux array, not the rows
    edge = big._replace(nxg=1, nyg=1, nzg=1, npointspec=1,
                        nage=tflux.K16_MAX_ROWS // 6)
    assert tflux.flux_rows(edge) <= tflux.K16_MAX_ROWS
    with pytest.raises(ValueError, match="flux does not match") as err:
        tflux.calcfluxes_cuda(torch.zeros(1), p, torch.as_tensor(xold),
                              torch.as_tensor(yold), torch.as_tensor(zold),
                              10800, lage, oh, ohh, edge)
    assert "K16_MAX_ROWS" not in str(err.value)


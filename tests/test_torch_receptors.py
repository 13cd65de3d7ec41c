"""Port parity for receptor sampling (``grid/receptors.py``; kernel K15 on
a card, its plain version here) and the nested output grid (OUTGRID_NEST:
K3 on the nest).

``build_receptors`` (numpy in both packages) bitwise; the receptor files'
writers and readers byte for byte on the same arrays.

The sampling's plain version against JAX's ``sample_receptors`` on the
same particles, made with numpy: JAX sums an (R, N) matrix product, the
port in K15's fixed order, so the two agree within rtol 1e-5; the order's
emulation (``ordered_sum``) within 1e-6 of a float64 sum.

One JAX ``Simulation`` run with two receptors (one in the plume, one far
from it), a nested output grid and ``iout=3``, against the port's with
JAX's draws injected: the same files (receptor_conc, receptor_pptv, the
npz per output time, the nest's npz); names, coordinates and times
bitwise; the receptor values within 2e-3 of the largest (the
particles' heights agree within 1 m for 98% of them, and the kernel's
vertical half width is 50-150 m: measured, 6e-4); the nest's mass within
1e-5 and each cell within rtol 1e-5 plus 3% of the largest cell (the
nest's cells are 0.5 degrees and its lowest layer 150 m: a particle a
hair apart in the two packages, or one of the 2% whose height the
boundary layer's Langevin equation has moved apart, crosses a wall;
measured: the first output equal, then 2 and 37 of 1536 cells beyond
1e-5, by at most 0.8% and 1.4% of the largest).
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
from flexpart_tpu.grid import receptors as jrec  # noqa: E402
from flexpart_tpu.io import fortran_writer as jfw  # noqa: E402
from flexpart_tpu.run.simulation import Simulation as JaxSimulation  # noqa: E402
from flexpart_tpu_torch import make_grid  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core.advance import DRAW_ROWS  # noqa: E402
from flexpart_tpu_torch.grid import receptors as trec  # noqa: E402
from flexpart_tpu_torch.io import fortran_writer as tfw  # noqa: E402

GRID = dict(nx=37, ny=15, nlev=15, dx=10.0, dy=10.0, ylat0=-70.0)
N = 1008
SEED = 4
NSTEPS = 16
ROWS = {**DRAW_ROWS, 2: 1}
RECEPTORS = (("NEAR", 1.0, 41.0), ("FAR", 100.0, -60.0))


def _receptors(c):
    return tuple(c.Receptor(name=n, lon=lon, lat=lat)
                 for n, lon, lat in RECEPTORS)


def _config(c):
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                    ietime=40000, lsynctime=900, loutstep=3600,
                    loutaver=3600, loutsample=900, lconvection=0,
                    lsubgrid=0, iout=3)
    box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                       itime2=0, lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0,
                       z1=20.0, z2=200.0, mass=(1.0,), parts=N)
    rel = c.Releases(species=(c.Species(weightmolar=64.0),), boxes=(box,))
    heights = (150.0, 500.0, 2000.0, 50000.0)
    og = c.OutGrid(outlon0=-60.0, outlat0=10.0, numxgrid=30, numygrid=20,
                   dxout=4.0, dyout=4.0, outheights=heights)
    ogn = c.OutGrid(outlon0=-4.0, outlat0=36.0, numxgrid=24, numygrid=16,
                    dxout=0.5, dyout=0.5, outheights=heights)
    return cmd, rel, og, ogn


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cmd, rel, og, ogn = _config(jconfig)
    grid = jmet.make_grid(**GRID)
    sim = JaxSimulation(cmd=cmd, releases=rel, grid=grid,
                        met_backend=jmet.SyntheticMet(grid), outgrid=og,
                        outdir=str(tmp_path_factory.mktemp("jax_rec")),
                        seed=SEED, write_netcdf=False,
                        receptors=_receptors(jconfig), outgrid_nest=ogn)
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
        jsim, "cpu", outdir=str(tmp_path_factory.mktemp("port_rec")))
    sim._draws_hook = lambda istep, origin: {
        t: v[:, origin].contiguous() for t, v in draws[istep].items()}
    sim.run()
    return sim


def test_build_receptors_equals_jax():
    grid = make_grid(**GRID)
    jr, jn = jrec.build_receptors(_receptors(jconfig),
                                  jmet.make_grid(**GRID))
    tr, tn = trec.build_receptors(_receptors(tconfig), grid)
    assert tn == jn == ("NEAR", "FAR")
    for f in ("x", "y", "area"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    assert trec.build_receptors((), grid) == (None, ())


def test_receptor_limit_is_refused_by_name():
    many = tuple(tconfig.Receptor(f"R{i}", 0.0, 40.0)
                 for i in range(trec.MAX_RECEPTORS + 1))
    with pytest.raises(ValueError, match="MAX_RECEPTORS"):
        trec.build_receptors(many, make_grid(**GRID))


def test_receptor_files_are_the_references_bytes(tmp_path):
    rs = np.random.default_rng(1)
    names = ["NEAR", "FAR", "THIRD"]
    lons = rs.uniform(-180, 180, 3).astype(np.float32)
    lats = rs.uniform(-90, 90, 3).astype(np.float32)
    vals = [rs.random((3, 2)).astype(np.float32) for _ in range(2)]
    for w, d in ((jfw, tmp_path / "jax2"), (tfw, tmp_path / "port2")):
        d.mkdir()
        w.write_receptor_header(d / "receptor_conc", names, lons, lats)
        for it, v in zip((3600, 7200), vals):
            w.append_receptor(d / "receptor_conc", it, v)
    a = (tmp_path / "jax2" / "receptor_conc").read_bytes()
    assert (tmp_path / "port2" / "receptor_conc").read_bytes() == a
    n, lo, la, steps = tfw.read_receptor(tmp_path / "port2" / "receptor_conc",
                                         2)
    assert n == names and [s[0] for s in steps] == [3600, 7200]
    np.testing.assert_array_equal(steps[1][1], vals[1])
    np.testing.assert_array_equal(lo, lons)


def _particles(n, nspec, seed, itime):
    rs = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x_hi=rs.uniform(17.0, 19.5, n).astype(f32),
        x_lo=rs.uniform(-1e-6, 1e-6, n).astype(f32),
        y_hi=rs.uniform(10.5, 12.5, n).astype(f32),
        y_lo=np.zeros(n, f32), z=rs.uniform(0.0, 300.0, n).astype(f32),
        itra=np.where(rs.random(n) < 0.9, itime, itime - 900)
        .astype(np.int32),
        itramem=rs.integers(0, itime, n).astype(np.int32),
        npoint=np.zeros(n, np.int32), nclass=np.zeros(n, np.int32),
        idt=np.zeros(n, np.int32), itrasplit=np.zeros(n, np.int32),
        up=np.zeros(n, f32), vp=np.zeros(n, f32), wp=np.zeros(n, f32),
        usig=np.zeros(n, f32), vsig=np.zeros(n, f32), wsig=np.zeros(n, f32),
        cbt=np.ones(n, np.int8),
        mass=rs.uniform(0.5, 1.5, (n, nspec)).astype(f32),
        mass0=np.ones((n, nspec), f32), xscav=np.ones((n, nspec), f32),
        active=rs.random(n) < 0.95)


@pytest.mark.parametrize("nspec", [1, 2])
def test_sampling_twin_equals_jax(nspec):
    itime = 10800
    pop = _particles(5000, nspec, nspec, itime)
    grid = make_grid(**GRID)
    jr, _ = jrec.build_receptors(_receptors(jconfig),
                                 jmet.make_grid(**GRID))
    tr, _ = trec.build_receptors(_receptors(tconfig), grid)
    # an open window's sums so far, of the order of one sample's
    c0 = (np.random.default_rng(9).random((2, nspec))
          * 1e-12).astype(np.float32)
    j = np.asarray(jrec.sample_receptors(
        jnp.asarray(c0), jr, JParticles(**{k: jnp.asarray(v)
                                           for k, v in pop.items()}),
        jnp.int32(itime), jnp.float32(0.5), dx=grid.dx, dy=grid.dy))
    t = trec.sample_receptors(torch.as_tensor(c0), tr,
                              interop.particles_from_numpy(pop, "cpu"),
                              itime, 0.5, grid.dx, grid.dy).numpy()
    assert (j[0] > c0[0]).all() and (j[1] == c0[1]).all()
    np.testing.assert_allclose(t, j, rtol=1e-5)


def test_ordered_sum_is_a_sum():
    v = torch.as_tensor(np.random.default_rng(2).random(100003)
                        .astype(np.float32))
    s = float(trec.ordered_sum(v))
    assert abs(s - float(v.double().sum())) <= 1e-6 * s
    assert float(trec.ordered_sum(torch.ones(70000))) == 70000.0
    assert float(trec.ordered_sum(torch.zeros(0))) == 0.0


def test_receptors_in_simulation_equal_jax(jax_run, port_run):
    jsim, sim = jax_run[0], port_run
    jout, tout = Path(jsim.outdir), Path(sim.outdir)
    jnames = sorted(p.name for p in jout.iterdir())
    assert sorted(p.name for p in tout.iterdir()) == jnames
    assert "receptor_conc" in jnames and "receptor_pptv" in jnames
    for name in ("receptor_conc", "receptor_pptv"):
        jn, jlo, jla, js = jfw.read_receptor(jout / name, 1)
        tn, tlo, tla, ts = tfw.read_receptor(tout / name, 1)
        assert tn == jn == ["NEAR", "FAR"]
        np.testing.assert_array_equal(tlo, jlo)
        np.testing.assert_array_equal(tla, jla)
        assert [s[0] for s in ts] == [s[0] for s in js] \
            == [5400, 9000, 12600]
        for (_, a), (_, b) in zip(ts, js):
            assert b[0, 0] > 0 and b[1, 0] == a[1, 0] == 0
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * b.max())
    for jf in sorted(jout.glob("receptor_conc_*.npz")):
        j, t = np.load(jf), np.load(tout / jf.name)
        assert list(t["names"]) == list(j["names"])
        np.testing.assert_allclose(t["conc"], j["conc"], rtol=0,
                                   atol=2e-3 * j["conc"].max())


def test_nested_output_equals_jax(jax_run, port_run):
    jsim, sim = jax_run[0], port_run
    jn, tn = Path(jsim.outdir) / "nest", Path(sim.outdir) / "nest"
    jf = sorted(jn.glob("grid_conc_*.npz"))
    assert len(jf) == 3 and sorted(p.name for p in tn.iterdir()) \
        == sorted(p.name for p in jn.iterdir())
    for f in jf:
        j, t = np.load(f), np.load(tn / f.name)
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        jc = j["conc"]
        assert jc.shape == (1, 1, 1, 4, 16, 24) and jc.max() > 0
        vol = sim.geo_n.volume[None, None, None]
        np.testing.assert_allclose((t["conc"] * vol).sum(),
                                   (jc * vol).sum(), rtol=1e-5)
        err = np.abs(t["conc"] - jc) - 1e-5 * np.abs(jc)
        assert err.max() <= 0.03 * jc.max()


GATE_N = 4096


def _steps(v, k):
    """v moved k floats (float32) up (k > 0) or down, elementwise."""
    v = v.astype(np.float32)
    for i in range(int(np.abs(k).max(initial=0))):
        go = np.abs(k) > i
        v = np.where(go, np.nextafter(v, np.where(k > 0, np.inf, -np.inf)
                                      .astype(np.float32)), v)
    return v.astype(np.float32)


def _gate_particles(kind, seed):
    """GATE_N live particles, particle i at receptor i mod 2 of RECEPTORS
    (in grid units), on and around the edges of its kernel: ``x``, ``y``:
    x - rx (y - ry) within 4 floats of +-hx (+-hy), the other two
    coordinates at the centre or a random share of the way out; ``z``: z
    within 4 floats of +-hz; ``corner``: the three quotients on a sphere of
    radius 1 +- 1e-6; ``special``: NaN, +-0, +-inf and exact edges in each
    coordinate.  Returns (particles, receptor set, receptor of each)."""
    grid = make_grid(**GRID)
    rec, _ = trec.build_receptors(_receptors(tconfig), grid)
    rs = np.random.default_rng(seed)
    n, f32 = GATE_N, np.float32
    pop = _particles(n, 1, seed, 10800)
    pop.update(active=np.ones(n, bool), itra=np.full(n, 10800, np.int32),
               x_lo=np.zeros(n, f32), y_lo=np.zeros(n, f32))
    p = interop.particles_from_numpy(pop, "cpu")
    hx, hy, hz = (t.numpy() for t in trec.kernel_widths(p, grid.dx, grid.dy))
    j = np.arange(n) % 2
    rx, ry = rec.x.numpy()[j], rec.y.numpy()[j]
    side = np.where(rs.random(n) < 0.5, -1.0, 1.0).astype(f32)
    ulps = rs.integers(-4, 5, n)
    share = rs.random(n).astype(f32) * (rs.random(n) < 0.5)
    x, y, z = rx.copy(), ry.copy(), np.zeros(n, f32)
    if kind == "x":
        x = _steps((rx + side * hx).astype(f32), ulps)
        y = (ry + share * hy * side).astype(f32)
        z = (share * hz).astype(f32)
    elif kind == "y":
        y = _steps((ry + side * hy).astype(f32), ulps)
        x = (rx + share * hx).astype(f32)
    elif kind == "z":
        z = _steps((side * hz).astype(f32), ulps)
        x = (rx + share * hx * side).astype(f32)
    elif kind == "corner":
        u = rs.normal(size=(3, n))
        u *= (1.0 + rs.uniform(-1e-6, 1e-6, n)) / np.linalg.norm(u, axis=0)
        x = (rx + u[0] * hx).astype(f32)
        y = (ry + u[1] * hy).astype(f32)
        z = (u[2] * hz).astype(f32)
    else:
        picks = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0], f32)
        c = rs.integers(0, len(picks), (3, n))
        x = np.where(c[0] == 5, rx + hx, rx + picks[c[0]] * (c[0] > 2))
        x = np.where(c[0] == 0, np.nan, x).astype(f32)
        y = np.where(c[1] == 5, ry - hy, ry + picks[c[1]] * (c[1] > 2))
        y = np.where(c[1] == 0, np.nan, y).astype(f32)
        z = np.where(c[2] == 5, hz, picks[c[2]]).astype(f32)
    pop.update(x_hi=x, y_hi=y, z=z)
    return interop.particles_from_numpy(pop, "cpu"), rec, j


@pytest.mark.parametrize("kind", ["x", "y", "z", "corner", "special"])
def test_gate_drops_no_inside_pair(kind):
    """K15 divides only where ``may_be_inside`` holds: every pair inside
    (r2 < 1, float32 on the CPU, as the kernel computes it) passes the
    gate, elementwise, on particles a few floats either side of each edge
    of the kernel, and NaN, +-0 and +-inf."""
    p, rec, j = _gate_particles(kind, {"x": 1, "y": 2, "z": 3, "corner": 4,
                                       "special": 5}[kind])
    grid = make_grid(**GRID)
    hx, hy, hz = trec.kernel_widths(p, grid.dx, grid.dy)
    own = torch.as_tensor(j)
    for r in range(2):
        r2 = trec.receptor_r2(rec, p, r, hx, hy, hz)
        inside = (r2 < 1.0) & p.active
        gate = trec.may_be_inside(rec, p, 10800, r, hx, hy, hz)
        assert not bool((inside & ~gate).any()), (kind, r)
        assert bool((gate & ~inside).any()) or kind == "special", (kind, r)
        mine = own == r
        assert bool((inside & mine).any()), (kind, r)
        if kind in ("x", "y", "z"):
            # the edge itself is crossed: pairs on both sides of it
            assert bool((~inside & mine).any()), (kind, r)


def _warp_box_reach(p, rec, itime, hx, hy, hz):
    """(warps, R) csrc/receptors.cu's box test, float32 on the CPU: the
    near lanes' x and y extents (a NaN left out, as fminf / fmaxf leave
    it), their widest |hx| and |hy|, against each receptor."""
    n = p.capacity
    w = -(-n // 32) * 32
    live = p.active & (p.itra == itime)
    near = live & (p.z.abs() < hz)
    inf = torch.tensor(float("inf"))

    def lanes(v, fill):
        out = torch.full((w,), float(fill), dtype=torch.float32)
        out[:n] = torch.where(near & ~torch.isnan(v), v, fill)
        return out.view(-1, 32)

    x, y = p.x, p.y
    xmin, xmax = lanes(x, inf).amin(1), lanes(x, -inf).amax(1)
    ymin, ymax = lanes(y, inf).amin(1), lanes(y, -inf).amax(1)
    hxm, hym = lanes(hx.abs(), 0.0).amax(1), lanes(hy.abs(), 0.0).amax(1)
    reach = [(xmin - rec.x[r] < hxm) & (xmax - rec.x[r] > -hxm)
             & (ymin - rec.y[r] < hym) & (ymax - rec.y[r] > -hym)
             for r in range(rec.x.shape[0])]
    return torch.stack(reach, dim=1)


@pytest.mark.parametrize("kind", ["x", "corner", "special", "spread"])
def test_warp_box_keeps_every_candidate(kind):
    """K15's warp box (csrc/receptors.cu) passes every (warp, receptor)
    with a lane past the gate: fl(x - rx) is monotone in x, so a box whose
    nearest edge is at least the widest half width away holds no
    candidate.  On the gate cases' particles in warps of 32, grouped by
    receptor (as cell order groups them), and shuffled (``spread``: the
    ``x`` case's particles in random order)."""
    p, rec, j = _gate_particles("x" if kind == "spread" else kind, 7)
    order = (np.random.default_rng(8).permutation(GATE_N) if kind == "spread"
             else np.argsort(j, kind="stable"))
    perm = torch.as_tensor(order)
    p = p.replace(**{f: getattr(p, f)[perm] for f in ("x_hi", "y_hi", "z",
                                                      "itramem")})
    grid = make_grid(**GRID)
    hx, hy, hz = trec.kernel_widths(p, grid.dx, grid.dy)
    reach = _warp_box_reach(p, rec, 10800, hx, hy, hz)
    for r in range(2):
        gate = trec.may_be_inside(rec, p, 10800, r, hx, hy, hz)
        cand = gate.view(-1, 32).any(1)
        assert bool(cand.any()), (kind, r)
        assert not bool((cand & ~reach[:, r]).any()), (kind, r)
    # grouped by receptor, the box turns each warp away from the other
    assert bool(reach.all()) == (kind == "spread")

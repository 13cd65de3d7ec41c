"""Port parity for the whole stock step, and the no-jax guarantee.

The slice — met (uniform-wind backend, verttransform, calcpar) -> quad
tables -> ``advance_chunked`` -> ``conccalc`` — runs in both packages,
each from its own met, on a reduced global grid with JAX's draws
injected.  Three steps at itime 0 (fresh particles), 9000 and 9900 (the
last samples with the 4-point kernel, as the main path does after 3 h).

Tolerances: positions as in test_torch_advance (x, y atol 1e-4 grid
units; z rtol 1e-4, atol 1e-2 m); the mask and counters exactly; gridunc
within rtol 1e-5 per cell plus an atol of 1e-5 of the largest cell (the
4-point weights move linearly with positions that differ in the last
bits), and its total to 1e-6 (mass is conserved on both sides).

One case sorts the port's particles by met cell before every step
(``core/reorder.py``), with JAX's draws carried along with their
particles: the sort is a layout step, so every particle must end where
JAX puts it, to the same tolerances, once the slots are mapped back.
"""
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.config import OutGrid  # noqa: E402
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.grid import conccalc as jcc  # noqa: E402
from flexpart_tpu.grid import outgrid as jog  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import reorder as treorder  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.grid import conccalc as tcc  # noqa: E402
from flexpart_tpu_torch.grid import outgrid as tog  # noqa: E402
from flexpart_tpu_torch.met import calcpar as tcalcpar  # noqa: E402
from flexpart_tpu_torch.met import synthetic as tsyn  # noqa: E402
from flexpart_tpu_torch.met import verttransform as tvt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 4096
N_CHUNKS = 4
GRID = dict(nx=73, ny=37, nlev=30, dx=5.0, dy=5.0, xlon0=-180.0,
            ylat0=-90.0, xglobal=True)
OG = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=72, numygrid=36,
             dxout=5.0, dyout=5.0, outheights=(100.0, 1000.0, 50000.0))
STEPS = (0, 9000, 9900)


def _jax_slice(p0):
    grid = jmet.make_grid(**GRID)
    eta = jmet.uniform_wind_met(grid, u=10.0, v=1.0).fetch(0.0)
    z0 = jmet.calcpar(grid, eta, jmet.process_eta(
        grid, eta, jmet.compute_heights(grid, eta)))
    cfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                          xglobal=True, ldirect=1, turbswitch=False, ifine=1,
                          method=0)
    prm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                               dxconst=grid.dxconst, dyconst=grid.dyconst,
                               lsynctime=900, fine=1.0)
    geo = jog.OutputGridGeometry(OG, grid)
    ccfg = jcc.ConcConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg,
                          npointspec=1, nclassunc=1, nage=1, dxout=OG.dxout,
                          dyout=OG.dyout, xoutshift=geo.xoutshift,
                          youtshift=geo.youtshift, dx_met=grid.dx,
                          dy_met=grid.dy, ind_samp=0)
    conc = jcc.make_conccalc(OG.outheights)
    acc = jog.zero_accumulators(geo, 1, 1, 1, 1)
    lage = jnp.asarray(np.asarray([999999999], np.int32))
    p, draws, out = p0, [], []
    b = N // N_CHUNKS
    for i, it in enumerate(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(2), i)
        rows = {6: 6, 1: 2, 2: 1, 3: 3, 4: 3}
        per = [{t: np.asarray(jrng.normals(jax.random.fold_in(key, c),
                                           (r, b), tag=t))
                for t, r in rows.items()} for c in range(N_CHUNKS)]
        draws.append({t: np.concatenate([d[t] for d in per], axis=1)
                      for t in rows})
        p, diag = jadv.advance_chunked(p, z0, z0, jnp.int32(it), jnp.int32(0),
                                       jnp.int32(86400), key, cfg, prm,
                                       N_CHUNKS)
        cc = ccfg._replace(kernel_possible=jcc.kernel_possible_at(it + 900, 0))
        acc = conc(acc, p, z0, jnp.int32(it + 900), lage, jnp.float32(1.0), cc)
        out.append((p, diag))
    return out, np.asarray(acc.gridunc), draws


def _port_slice(p0, draws, reorder=False):
    """The port's three steps.  With ``reorder`` the particles are sorted
    by cell before every step; ``order[slot]`` is then the slot the
    particle started in, the draws follow their particles, and the
    returned particles are mapped back to the starting slots."""
    grid = tsyn.make_grid(**GRID)
    eta = tsyn.uniform_wind_met(grid, u=10.0, v=1.0).fetch(0.0, "cpu")
    z0 = tcalcpar.calcpar(grid, eta, tvt.process_eta(
        grid, eta, tvt.compute_heights(grid, eta)))
    cfg = tadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                          xglobal=True, ldirect=1, turbswitch=False, ifine=1,
                          method=0)
    prm = tadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                               dxconst=grid.dxconst, dyconst=grid.dyconst,
                               lsynctime=900, fine=1.0)
    geo = tog.OutputGridGeometry(OG, grid)
    ccfg = tcc.ConcConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg,
                          npointspec=1, nclassunc=1, nage=1, dxout=OG.dxout,
                          dyout=OG.dyout, xoutshift=geo.xoutshift,
                          youtshift=geo.youtshift, dx_met=grid.dx,
                          dy_met=grid.dy, ind_samp=0)
    conc = tcc.make_conccalc(OG.outheights)
    acc = tog.zero_accumulators(geo, 1, 1, 1, 1, device="cpu")
    lage = torch.tensor([999999999], dtype=torch.int32)
    p, out = p0, []
    order = torch.arange(N)
    for i, it in enumerate(STEPS):
        if reorder:
            p, perm = treorder.reorder_by_cell(p, z0.height, cfg)
            order = order[perm.long()]
        d = {t: torch.as_tensor(v)[:, order].contiguous()
             for t, v in draws[i].items()}
        p, diag = tadv.advance_chunked(p, z0, z0, it, 0, 86400,
                                       trng.Key(2, i), cfg, prm, N_CHUNKS,
                                       draws=d)
        cc = ccfg.replace(kernel_possible=tcc.kernel_possible_at(it + 900, 0))
        acc = conc(acc, p, z0, it + 900, lage, 1.0, cc)
        out.append((treorder.apply_perm(p, torch.argsort(order)), diag))
    if reorder:     # the sort did move particles, and kept them in key order
        assert int((order != torch.arange(N)).sum()) > N // 2
    return out, acc.gridunc.numpy()


@pytest.fixture(scope="module")
def jax_run():
    rs = np.random.default_rng(0)
    p = jstate.empty_particles(N)
    p = p._replace(
        x_hi=jnp.asarray(rs.uniform(6.0, 66.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(6.0, 30.0, N), jnp.float32),
        z=jnp.asarray(rs.uniform(10.0, 8000.0, N), jnp.float32),
        active=jnp.ones(N, bool), itra=jnp.zeros(N, jnp.int32),
        mass=jnp.full((N, 1), 1.0 / N, jnp.float32))
    jout, jgrid, draws = _jax_slice(p)
    tp0 = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    return tp0, jout, jgrid, draws


def _assert_port_matches_jax(jax_run, reorder):
    tp0, jout, jgrid, draws = jax_run
    tout, tgrid = _port_slice(tp0, draws, reorder)
    for k, ((jp, jd), (tp, td)) in enumerate(zip(jout, tout)):
        a = interop.particles_to_numpy(tp)
        b = {f: np.asarray(v) for f, v in jp._asdict().items()}
        np.testing.assert_allclose(a["x_hi"] + a["x_lo"],
                                   b["x_hi"] + b["x_lo"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(a["y_hi"] + a["y_lo"],
                                   b["y_hi"] + b["y_lo"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(a["z"], b["z"], rtol=1e-4, atol=1e-2)
        for f in ("active", "cbt", "itra"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {k}")
        assert int(td.n_active) == int(jd.n_active) == N
        assert int(td.nan_count) == int(jd.nan_count) == 0
    np.testing.assert_allclose(tgrid, jgrid, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrid).max())
    assert abs(tgrid.sum() - jgrid.sum()) <= 1e-6 * jgrid.sum()
    # every particle is in the global grid below 50 km: all mass sampled
    assert abs(tgrid.sum() - len(STEPS)) < 1e-3 * len(STEPS)


def test_stock_step_matches_jax(jax_run):
    _assert_port_matches_jax(jax_run, reorder=False)


def test_stock_step_with_reorder_matches_jax(jax_run):
    _assert_port_matches_jax(jax_run, reorder=True)


def test_port_runs_without_jax():
    """A fresh interpreter imports the port, runs one CPU step from the
    port's own draws, and never loads jax or the JAX package."""
    code = r"""
import sys, torch
from flexpart_tpu_torch.core import advance, rng, state
from flexpart_tpu_torch.met import calcpar, synthetic, verttransform
from flexpart_tpu_torch.grid import conccalc, outgrid
from flexpart_tpu_torch.config import OutGrid
g = synthetic.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
eta = synthetic.SyntheticMet(g).fetch(0.0, "cpu")
z0 = calcpar.calcpar(g, eta, verttransform.process_eta(
    g, eta, verttransform.compute_heights(g, eta)))
p = state.empty_particles(256, device="cpu")
gen = torch.Generator().manual_seed(0)
p = p.replace(x_hi=torch.rand(256, generator=gen) * 30 + 2,
              y_hi=torch.rand(256, generator=gen) * 14 + 2,
              z=torch.rand(256, generator=gen) * 5000,
              active=torch.ones(256, dtype=torch.bool),
              itra=torch.zeros(256, dtype=torch.int32),
              mass=torch.full((256, 1), 1.0 / 256))
cfg = advance.StepConfig(nx=g.nx, ny=g.ny, nz=g.nlev, xglobal=True, ldirect=1,
                         turbswitch=False, ifine=1, method=0)
prm = advance.StepParams.make(g.dx, g.dy, g.ylat0, g.dxconst, g.dyconst, 900, 1.0)
p, d = advance.advance_chunked(p, z0, z0, 0, 0, 86400, rng.Key(0, 0), cfg, prm, 2)
og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=36, numygrid=18,
             dxout=10.0, dyout=10.0, outheights=(100.0, 1000.0, 50000.0))
geo = outgrid.OutputGridGeometry(og, g)
acc = outgrid.zero_accumulators(geo, 1, 1, device="cpu")
cc = conccalc.ConcConfig(nxg=36, nyg=18, nzg=3, npointspec=1, nclassunc=1,
                         nage=1, dxout=10.0, dyout=10.0,
                         xoutshift=geo.xoutshift, youtshift=geo.youtshift,
                         dx_met=g.dx, dy_met=g.dy, ind_samp=0,
                         kernel_possible=False)
acc = conccalc.make_conccalc(og.outheights)(
    acc, p, z0, 900, torch.tensor([999999], dtype=torch.int32), 1.0, cc)
assert int(d.n_active) == 256 and abs(float(acc.gridunc.sum()) - 1.0) < 1e-5
assert torch.isfinite(p.z).all()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert "flexpart_tpu" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_no_jax_import_in_port():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    files = sorted((ROOT / "flexpart_tpu_torch").rglob("*.py"))
    assert files
    jaxpkg = re.compile(r"^\s*(import|from)\s+flexpart_tpu\b(?!_torch)", re.M)
    offenders = [str(f) for f in files
                 if pat.search(f.read_text()) or jaxpkg.search(f.read_text())]
    assert not offenders
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pat.search(smoke)
    assert "flexpart_tpu." not in smoke.replace("flexpart_tpu_torch", "")


def test_cbl_nests_and_legacy_modules_run_without_jax():
    """core/cbl.py, core/legacy.py and validation/ import and run in a
    fresh interpreter with neither jax nor flexpart_tpu loaded: the CBL
    terms, the legacy table and a release, the oracle's parameters."""
    for f in ("core/cbl.py", "core/legacy.py", "validation/oracle.py",
              "validation/legacy_rng.py", "validation/depo_oracle.py"):
        assert (ROOT / "flexpart_tpu_torch" / f).is_file(), f
    code = """
import sys, torch
from flexpart_tpu_torch.core import cbl, legacy
from flexpart_tpu_torch.validation import depo_oracle, legacy_rng, oracle
n = 8
z, h, wst = torch.full((n,), 500.0), torch.full((n,), 1500.0), torch.full((n,), 1.8)
sig, ds, tl = torch.full((n,), 1.0), torch.full((n,), -1e-3), torch.full((n,), 200.0)
ath, bth, rein = cbl.cbl_terms(torch.zeros(n), z, wst, h, torch.ones(n),
                               torch.full((n,), -1e-4), sig, ds, tl,
                               torch.full((n,), -25.0), 1)
assert torch.isfinite(ath).all() and torch.isfinite(bth).all()
tab = legacy_rng.make_rannumb(1000, -7)
x, y, nc, zz = depo_oracle.legacy_release(
    dict(lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0, z1=50.0, z2=500.0), 4, 1,
    -180.0, -90.0, 1.0, 1.0)
assert len(x) == 4 and tab.shape == (1001,)
assert oracle.OracleParams(nx=3, ny=3, nz=3, xglobal=False, ldirect=1,
                           turbswitch=True, ifine=1, lsynctime=900,
                           lwindinterv=3600, dx=1.0, dy=1.0, ylat0=0.0,
                           dxconst=1.0, dyconst=1.0).method == 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert "flexpart_tpu" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_parallel_modules_run_without_jax():
    """parallel/ (sharding.py, launch.py) imports and shards in a fresh
    interpreter with neither jax nor flexpart_tpu loaded: a capacity of 100
    padded over 3 ranks, a rank's rows, a split's shares over them, and a
    Simulation(distributed='dp') outside a process group refused by what
    it needs."""
    for f in ("parallel/__init__.py", "parallel/sharding.py",
              "parallel/launch.py"):
        assert (ROOT / "flexpart_tpu_torch" / f).is_file(), f
    code = """
import sys, torch
from flexpart_tpu_torch import parallel
from flexpart_tpu_torch.parallel import launch, sharding
from flexpart_tpu_torch.core.state import empty_particles
p = sharding.pad_particles(empty_particles(100, device="cpu"), 3)
assert p.capacity == 102
rows = sharding.shard_particles(p, sharding.Layout(3, 1))
assert rows.capacity == 34
shares, moves = sharding.split_shares([[10, 0], [5, 2], [0, 20]])
assert [s.limits()[0] for s in shares] == [10, 5, 0]
assert moves.tolist() == [[0, 2, 8], [0, 0, 5], [0, 0, 0]]
from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox, Releases,
                                       Species)
from flexpart_tpu_torch.met import SyntheticMet, make_grid
from flexpart_tpu_torch.run.simulation import Simulation
g = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                 lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0, z1=50.0,
                 z2=500.0, mass=(1.0,), parts=10)
try:
    Simulation(cmd=Command(), releases=Releases(species=(Species(),),
                                                boxes=(box,)), grid=g,
               met_backend=SyntheticMet(g),
               outgrid=OutGrid(-180.0, -90.0, 36, 18, 10.0, 10.0, (100.0,)),
               distributed="dp", device="cpu")
    raise SystemExit("not refused")
except RuntimeError as e:
    assert "process group" in str(e), e
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert "flexpart_tpu" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_grib_modules_run_without_jax(tmp_path):
    """io/gribio.py, met/gribmet.py, met/gfsmet.py and met/pblprofile.py
    import and read GRIB files (written here by the tests' encoders) in a
    fresh interpreter with neither jax nor flexpart_tpu loaded, and the
    pressure-level and cloud-water preprocessing runs there."""
    from test_gfs import make_gfs_file
    from test_gribdec import _full_windfield_grib
    for f in ("io/gribio.py", "met/gribmet.py", "met/gfsmet.py",
              "met/pblprofile.py"):
        assert (ROOT / "flexpart_tpu_torch" / f).is_file(), f
    _full_windfield_grib(tmp_path / "EN", 0)
    make_gfs_file(tmp_path, name="GF")
    code = f"""
import sys
from pathlib import Path
from flexpart_tpu_torch.met import calcpar, gfsmet, gribmet, pblprofile
from flexpart_tpu_torch.met.fields import F2_CTWC
from flexpart_tpu_torch.met.verttransform import compute_heights, process_eta
d = Path({str(tmp_path)!r})
g = gribmet.grid_from_grib(d / "EN")
eta = gribmet.eta_from_grib(d / "EN", g, device="cpu")
assert (g.nx, g.nlev) == (37, 9) and float(eta.ps.min()) > 9e4
assert gfsmet.looks_like_gfs(d / "GF") and not gfsmet.looks_like_gfs(d / "EN")
gg = gfsmet.grid_from_gfs_grib(d / "GF")
e = gfsmet.eta_from_gfs_grib(d / "GF", gg, device="cpu")
z = calcpar.calcpar(gg, e, process_eta(gg, e, compute_heights(gg, e),
                                       use_clwc=True))
assert gg.pressure_levels and float(z.f2d[F2_CTWC].max()) > 0.0
assert pblprofile.R1 == 0.74
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert "flexpart_tpu" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_tiles_modules_run_without_jax():
    """parallel/domain.py and parallel/tiles.py import and run in a fresh
    interpreter with neither jax nor flexpart_tpu loaded: a 2 x 2 layout
    of a global grid, every rank's tiled step in one process (each tile's
    plain advance on its tile of the fields, then the migration), nothing
    lost; the tiles entry points default to the card (Simulation's device
    and the CLI's --device)."""
    for f in ("parallel/domain.py", "parallel/tiles.py"):
        assert (ROOT / "flexpart_tpu_torch" / f).is_file(), f
    code = r"""
import dataclasses, sys, torch
from flexpart_tpu_torch.core import advance, rng, state
from flexpart_tpu_torch.met import calcpar, synthetic, verttransform
from flexpart_tpu_torch.parallel import domain, tiles
from flexpart_tpu_torch.parallel.sharding import Layout
from flexpart_tpu_torch.run.simulation import Simulation
from flexpart_tpu_torch import main
g = synthetic.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
eta = synthetic.SyntheticMet(g).fetch(0.0, "cpu")
z0 = calcpar.calcpar(g, eta, verttransform.process_eta(
    g, eta, verttransform.compute_heights(g, eta)))
cfg = advance.StepConfig(nx=g.nx, ny=g.ny, nz=g.nlev, xglobal=True, ldirect=1,
                         turbswitch=False, ifine=1, method=0, polar=True)
prm = advance.StepParams.make(g.dx, g.dy, g.ylat0, g.dxconst, g.dyconst, 900, 1.0)
assert tiles.choose_tile_mesh(4, g.ny, g.nxfield) == (1, 4)
nty, ntx = 2, 2
engs = [tiles.TiledEngine(Layout(4, r), cfg, g, nty, ntx, 3) for r in range(4)]
gen = torch.Generator().manual_seed(0)
n = 256
p = state.empty_particles(n, device="cpu")
p = p.replace(x_hi=torch.rand(n, generator=gen) * 35,
              y_hi=torch.rand(n, generator=gen) * 17,
              z=torch.rand(n, generator=gen) * 5000,
              active=torch.ones(n, dtype=torch.bool),
              itra=torch.zeros(n, dtype=torch.int32),
              itramem=torch.zeros(n, dtype=torch.int32))
sched = {f: getattr(p, f).numpy() for f in state.FIELDS}
placed = [e.shard_initial(sched) for e in engs]
from flexpart_tpu_torch import interop
shards = [interop.particles_from_numpy(a, "cpu") for a, _ in placed]
origins = [torch.as_tensor(o) for _, o in placed]
for i in range(3):
    diags, mig = tiles.step_in_process(engs, shards, origins, z0, z0, i * 900,
                                       0, 86400, rng.Key(0, i), prm)
    assert mig["deferred"] == 0
live = sum(int(q.active.sum()) for q in shards)
assert live == n, live
o = torch.cat(origins)
assert sorted(o[o >= 0].tolist()) == list(range(n))
for q, e in zip(shards, engs):
    own = domain.tile_of(q.x[q.active], q.y[q.active], e.field_tiles())
    assert (own == e.index).all()
import inspect
assert inspect.signature(Simulation).parameters["device"].default == "cuda"
ap_src = inspect.getsource(main.main)
assert 'ap.add_argument("--device", default="cuda"' in ap_src
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert "flexpart_tpu" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_step_config_from_jax_drops_no_field():
    """``interop.step_config_from_jax`` carries every JAX StepConfig field
    the port has (``legacy_quad`` among them), maps the single nest's
    ``nest_nx``/``nest_ny`` onto ``nests``, ignores by name ``maxsubsteps``
    and ``nspec``, and raises ValueError naming any other field, from a
    NamedTuple or a dict."""
    from flexpart_tpu_torch import interop
    from flexpart_tpu_torch.core.advance import StepConfig
    jcfg = jadv.StepConfig(nx=9, ny=7, nz=5, xglobal=False, ldirect=-1,
                           turbswitch=True, ifine=3, method=0, turboff=True,
                           nspec=2, settling=True, cblflag=True,
                           maxsubsteps=4, mintime=2.0, nest_nx=5, nest_ny=4,
                           polar=True, tile_mode=True, met_bf16=False,
                           legacy_quad=True)
    t = interop.step_config_from_jax(jcfg)
    for f in dataclasses.fields(StepConfig):
        if f.name != "nests":
            assert getattr(t, f.name) == getattr(jcfg, f.name), f.name
    assert t.nests == ((5, 4),)
    assert interop.step_config_from_jax(
        jcfg._replace(nests=((6, 6), (3, 3)))).nests == ((6, 6), (3, 3))
    # every field of either side is accounted for
    known = ({f.name for f in dataclasses.fields(StepConfig)}
             | set(interop._STEP_CONFIG_MAPPED)
             | set(interop._STEP_CONFIG_IGNORED))
    assert set(jadv.StepConfig._fields) <= known
    d = jcfg._asdict()
    assert interop.step_config_from_jax(d) == t
    with pytest.raises(ValueError, match="unknown_flag"):
        interop.step_config_from_jax({**d, "unknown_flag": True})

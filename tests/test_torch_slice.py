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

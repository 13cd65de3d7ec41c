"""Matched-RNG validation of the port: its legacy-RNG advance against the
scalar advance.f90 oracle.

The mirror of ``tests/test_matched_rng.py`` for ``flexpart_tpu_torch``:
the port's ``advance_all`` with ``leg`` (``core/legacy.py``: every draw a
read of the rannumb table at the index the Fortran uses, through the
per-particle nrand chase, and the met interpolated per time level) against
the copied oracle (``flexpart_tpu_torch/validation/oracle.py``, a scalar
transcription of advance.f90, initialize.f90, cbl.f90 and the
interpolation routines) on the port's own SyntheticMet fields.  Both sides
consume the same table (``validation/legacy_rng.make_rannumb``) in the
same order, so every draw is the same number and a difference is a
difference of arithmetic.  The sizes, step counts and tolerances are the
JAX tests': positions within 5e-3 grid units and z within 2 m + 1e-4
relative per step (2e-2 and 5 m for the adaptive step and across wind
intervals), 80% of the adaptive step's idt equal, gridded concentrations
within 2% relative L1; the CBL (skewed and weak branches and the
dtftlw >= 0.5 quirk, the fresh particle's ran3/gasdev draws), settling and
the adaptive step included.

``test_legacy_advance_matches_jax`` holds the port's legacy advance against
the JAX package's on one shared table and the same nrand bases: the same
function in float32 on both sides, to 1e-4 grid units and 1e-2 m + 1e-4
relative (XLA's and torch's transcendentals and the corner sums' order
differ in the last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.advance import (StepConfig, StepParams,  # noqa: E402
                                             advance_all)
from flexpart_tpu_torch.core.legacy import LegacyRnd  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.met.calcpar import calcpar  # noqa: E402
from flexpart_tpu_torch.met.fields import F2_HMIX, F2_OLI, F2_WSTAR  # noqa: E402
from flexpart_tpu_torch.met.verttransform import (compute_heights,  # noqa: E402
                                                  process_eta)
from flexpart_tpu_torch.validation.legacy_rng import (MAXRAND,  # noqa: E402
                                                      NrandStream,
                                                      make_rannumb)
from flexpart_tpu_torch.validation.oracle import (OracleParams,  # noqa: E402
                                                  _Interp, run_oracle)

SEED = -7
LSYNC = 900
MEMTIME = (0, 10800)


class _NpZ:
    """Numpy view of a ZFields for the scalar oracle."""

    def __init__(self, zf):
        self.f3d = zf.f3d.numpy()
        self.f2d = zf.f2d.numpy()
        self.height = zf.height.numpy()


@pytest.fixture(scope="module")
def met_setup():
    grid = make_grid(nx=61, ny=31, nlev=20, dx=1.0, dy=1.0,
                     xlon0=0.0, ylat0=10.0, xglobal=False)
    met = SyntheticMet(grid)
    height = compute_heights(grid, met.fetch(0.0, "cpu"))
    zs = []
    for t in (0.0, float(MEMTIME[1])):
        eta = met.fetch(t, "cpu")
        zs.append(calcpar(grid, eta, process_eta(grid, eta, height)))
    return grid, zs[0], zs[1], height


@pytest.fixture(scope="module")
def table():
    return torch.from_numpy(make_rannumb(MAXRAND, SEED))


def _start_positions(n):
    """Positions spread over the domain; z spans PBL / troposphere /
    tropopause transition / stratosphere, away from branch boundaries."""
    rs = np.random.RandomState(42)
    x = rs.uniform(8.0, 50.0, n)
    y = rs.uniform(5.0, 25.0, n)
    z = np.concatenate([
        rs.uniform(20.0, 400.0, n - 3 * (n // 4)),
        rs.uniform(3000.0, 7000.0, n // 4),
        rs.uniform(11300.0, 11700.0, n // 4),
        rs.uniform(16000.0, 19000.0, n // 4),
    ])
    return x, y, z


def _run_port_legacy(z0, z1, x, y, z, nsteps, cfg, prm, table,
                     memtime=MEMTIME, itime0=0, stream=None, p=None,
                     first=True, cbl_probe=None):
    """Drive the port's advance_all in legacy-RNG mode, drawing the
    per-particle nrand bases on the host in the reference's order
    (timemanager.f90:553-611); with ``cbl_probe`` (the oracle's params)
    also initialize_cbl_vel.f90's ran3/gasdev draws of a fresh particle in
    a strongly convective column, found with the oracle's interpolator."""
    n = len(x)
    if p is None:
        p = empty_particles(n, device="cpu")
        p = p.replace(x_hi=torch.tensor(x, dtype=torch.float32),
                      y_hi=torch.tensor(y, dtype=torch.float32),
                      z=torch.tensor(z, dtype=torch.float32),
                      itra=torch.zeros(n, dtype=torch.int32),
                      itramem=torch.full((n,), -1, dtype=torch.int32),
                      mass=torch.ones((n, 1)), mass0=torch.ones((n, 1)),
                      active=torch.ones(n, dtype=torch.bool))
    if stream is None:
        stream = NrandStream(SEED, MAXRAND)
    traj = []
    for kk in range(nsteps):
        k = kk if first else kk + 1
        itime = itime0 + kk * LSYNC
        active = p.active.numpy()
        ni = np.ones(n, np.int64)
        na = np.ones(n, np.int64)
        dcas = np.zeros(n, np.float32)
        dcas1 = np.zeros(n, np.float32)
        if cbl_probe is not None and k == 0:
            itp0 = _Interp(cbl_probe, _NpZ(z0), _NpZ(z1), itime0, memtime)
        xs, ys = p.x.double().numpy(), p.y.double().numpy()
        zs = p.z.double().numpy()
        for j in range(n):
            if not active[j]:
                continue
            if k == 0:
                ni[j] = stream.next_nrand()
                if cbl_probe is not None:
                    ix, jy, ixp, jyp, _, _, _ = itp0.corners(xs[j], ys[j])
                    h = max(itp0.hmix_max(ix, jy, ixp, jyp), 1.0)
                    if zs[j] / h <= 1.0:
                        _, _, ol, _, _, _, _ = itp0.profiles(
                            xs[j], ys[j], np.float32(zs[j]))
                        if -h / ol > 5.0:
                            dcas[j] = stream.uniform()
                            dcas1[j] = stream.gasdev()
            na[j] = stream.next_nrand()
        leg = LegacyRnd(table=table, nrand_init=torch.from_numpy(ni),
                        nrand=torch.from_numpy(na),
                        cbl_dcas=(torch.from_numpy(dcas)
                                  if cbl_probe is not None else None),
                        cbl_dcas1=(torch.from_numpy(dcas1)
                                   if cbl_probe is not None else None))
        p, _ = advance_all(p, z0, z1, itime, memtime[0], memtime[1],
                           trng.Key(0, 0), cfg, prm, leg=leg)
        traj.append(np.stack([p.x.double().numpy(), p.y.double().numpy(),
                              p.z.double().numpy()], 1))
    return p, traj


def _run_oracle(z0, z1, x, y, z, nsteps, oprm):
    parts = [dict(xt=np.float64(x[j]), yt=np.float64(y[j]),
                  zt=np.float32(z[j])) for j in range(len(x))]
    states, nstops, trace = run_oracle(
        oprm, _NpZ(z0), _NpZ(z1), MEMTIME, parts, nsteps, itime0=0,
        seed=SEED)
    return states, nstops, [np.asarray(t, np.float64) for t in trace]


def _params(grid, turbswitch, ifine, settling=False, method=0, ctl=-5.0,
            cblflag=False, **sp):
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                     xglobal=grid.xglobal, ldirect=1, turbswitch=turbswitch,
                     ifine=ifine, method=method, settling=settling,
                     cblflag=cblflag)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=1.0 / ifine, ctl=ctl,
                          lwindinterv=abs(MEMTIME[1] - MEMTIME[0]), **sp)
    oprm = OracleParams(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                        xglobal=grid.xglobal, ldirect=1,
                        turbswitch=turbswitch, ifine=ifine,
                        lsynctime=LSYNC, method=method, ctl=ctl,
                        lwindinterv=abs(MEMTIME[1] - MEMTIME[0]),
                        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                        dxconst=float(grid.dxconst),
                        dyconst=float(grid.dyconst), settling=settling,
                        cblflag=cblflag,
                        sp_density=sp.get("sp_density", -1.0),
                        sp_dquer=sp.get("sp_dquer", 0.0),
                        sp_cunningham=sp.get("sp_cunningham", 0.0),
                        sp_vsetaver=sp.get("sp_vsetaver", 0.0))
    return cfg, prm, oprm


def _compare(traj_k, trace_o, nstops, atol_xy=5e-3, atol_z=2.0):
    for k in range(len(traj_k)):
        alive = np.asarray(nstops) == 0
        ok, oo = traj_k[k], trace_o[k]
        np.testing.assert_allclose(ok[alive, 0], oo[alive, 0], atol=atol_xy,
                                   rtol=0, err_msg=f"x step {k}")
        np.testing.assert_allclose(ok[alive, 1], oo[alive, 1], atol=atol_xy,
                                   rtol=0, err_msg=f"y step {k}")
        np.testing.assert_allclose(ok[alive, 2], oo[alive, 2], atol=atol_z,
                                   rtol=1e-4, err_msg=f"z step {k}")


@pytest.mark.parametrize("turbswitch,ifine", [(True, 1), (False, 1),
                                              (True, 4)])
def test_matched_positions(met_setup, table, turbswitch, ifine):
    grid, z0, z1, _ = met_setup
    cfg, prm, oprm = _params(grid, turbswitch, ifine)
    x, y, z = _start_positions(28)
    pk, traj_k = _run_port_legacy(z0, z1, x, y, z, 4, cfg, prm, table)
    _, nstops, trace_o = _run_oracle(z0, z1, x, y, z, 4, oprm)
    assert all(s == 0 for s in nstops)
    assert bool(pk.active.all())
    _compare(traj_k, trace_o, nstops)


def test_matched_positions_settling(met_setup, table):
    grid, z0, z1, _ = met_setup
    sp = dict(sp_density=2500.0, sp_dquer=10.0, sp_cunningham=1.02,
              sp_vsetaver=-0.02)
    cfg, prm, oprm = _params(grid, True, 1, settling=True, **sp)
    x, y, z = _start_positions(20)
    z = np.clip(z, 50.0, 9000.0)
    pk, traj_k = _run_port_legacy(z0, z1, x, y, z, 4, cfg, prm, table)
    _, nstops, trace_o = _run_oracle(z0, z1, x, y, z, 4, oprm)
    assert all(s == 0 for s in nstops)
    _compare(traj_k, trace_o, nstops)


def test_matched_positions_adaptive(met_setup, table):
    grid, z0, z1, _ = met_setup
    cfg, prm, oprm = _params(grid, True, 2, method=1, ctl=5.0)
    x, y, z = _start_positions(24)
    pk, traj_k = _run_port_legacy(z0, z1, x, y, z, 4, cfg, prm, table)
    states, nstops, trace_o = _run_oracle(z0, z1, x, y, z, 4, oprm)
    assert all(s == 0 for s in nstops)
    assert bool(pk.active.all())
    _compare(traj_k, trace_o, nstops, atol_xy=2e-2, atol_z=5.0)
    idt_o = np.asarray([s["idt"] for s in states])
    assert (pk.idt.numpy() == idt_o).mean() > 0.8


def test_matched_concentrations(met_setup, table):
    grid, z0, z1, _ = met_setup
    cfg, prm, oprm = _params(grid, True, 1)
    n = 60
    rs = np.random.RandomState(7)
    x = rs.uniform(20.0, 30.0, n)
    y = rs.uniform(12.0, 18.0, n)
    z = rs.uniform(20.0, 600.0, n)
    _, traj_k = _run_port_legacy(z0, z1, x, y, z, 12, cfg, prm, table)
    _, nstops, trace_o = _run_oracle(z0, z1, x, y, z, 12, oprm)
    assert all(s == 0 for s in nstops)

    def gridded(traj):
        acc = np.zeros((grid.ny, grid.nx))
        for step in traj:
            ix = np.clip(np.round(step[:, 0]).astype(int), 0, grid.nx - 1)
            iy = np.clip(np.round(step[:, 1]).astype(int), 0, grid.ny - 1)
            low = step[:, 2] < 3000.0
            np.add.at(acc, (iy[low], ix[low]), 1.0 / n)
        return acc

    ck, co = gridded(traj_k), gridded(trace_o)
    assert np.abs(ck - co).sum() / max(co.sum(), 1e-12) < 0.02


def test_matched_across_wind_intervals(met_setup, table):
    grid, z0, z1, _ = met_setup
    z2 = z0
    cfg, prm, oprm = _params(grid, True, 1)
    n = 16
    x, y, z = _start_positions(n)
    per = MEMTIME[1] // LSYNC
    pk, traj1 = _run_port_legacy(z0, z1, x, y, z, per, cfg, prm, table)
    stream_k = NrandStream(SEED, MAXRAND)
    for _ in range(n):
        stream_k.next_nrand()
        stream_k.next_nrand()
    for _ in range(per - 1):
        for _ in range(n):
            stream_k.next_nrand()
    pk, traj2 = _run_port_legacy(z1, z2, x, y, z, per, cfg, prm, table,
                                 memtime=(MEMTIME[1], 2 * MEMTIME[1]),
                                 itime0=MEMTIME[1], stream=stream_k, p=pk,
                                 first=False)
    parts = [dict(xt=np.float64(x[j]), yt=np.float64(y[j]),
                  zt=np.float32(z[j])) for j in range(n)]
    stream_o = NrandStream(SEED, MAXRAND)
    states, nstops, trace1 = run_oracle(
        oprm, _NpZ(z0), _NpZ(z1), MEMTIME, parts, per, itime0=0, seed=SEED,
        stream=stream_o)
    states, nstops, trace2 = run_oracle(
        oprm, _NpZ(z1), _NpZ(z2), (MEMTIME[1], 2 * MEMTIME[1]), states, per,
        itime0=MEMTIME[1], seed=SEED, stream=stream_o, nstops=nstops,
        do_init=False)
    assert all(s == 0 for s in nstops)
    assert bool(pk.active.all())
    _compare(traj1 + traj2,
             [np.asarray(t, np.float64) for t in trace1 + trace2], nstops,
             atol_xy=2e-2, atol_z=5.0)


def _make_convective(zf, split_x=30):
    """hmix 1500 m, w* 1.8 m/s, L = -25 m (-h/L = 60, the skewed branch)
    east of split_x and L = -1200 m (-h/L = 1.25, the weak branch) west of
    it."""
    f2 = zf.f2d.clone()
    ny, nx = f2.shape[-2:]
    oli = torch.full((ny, nx), 1.0 / -1200.0)
    oli[:, split_x:] = 1.0 / -25.0
    f2[F2_HMIX] = 1500.0
    f2[F2_WSTAR] = 1.8
    f2[F2_OLI] = oli
    return zf.replace(f2d=f2)


def test_matched_positions_cbl(met_setup, table):
    """The skewed CBL (cblflag=1) on the fixed step: the bi-Gaussian drift,
    the re_initialize retry loop and the weak-zone Gaussian on the raw wp
    against cbl.f90 / re_initialize_particle.f90, the fresh particle's
    initialize_cbl_vel draw and the reference's mesoscale base quirk
    (advance.f90:499), ifine 8: particles near the top take the
    dtftlw < 0.5 path, lower ones the reference's dtftlw >= 0.5 quirk."""
    grid, z0, z1, _ = met_setup
    z0c, z1c = _make_convective(z0), _make_convective(z1)
    cfg, prm, oprm = _params(grid, True, 8, cblflag=True)
    n = 24
    rs = np.random.RandomState(11)
    x = np.concatenate([rs.uniform(12.0, 26.0, n // 2),
                        rs.uniform(34.0, 50.0, n // 2)])
    y = rs.uniform(6.0, 24.0, n)
    z = np.concatenate([rs.uniform(100.0, 1100.0, n // 2),
                        rs.uniform(1300.0, 1450.0, n // 2)])
    pk, traj_k = _run_port_legacy(z0c, z1c, x, y, z, 4, cfg, prm, table,
                                  cbl_probe=oprm)
    _, nstops, trace_o = _run_oracle(z0c, z1c, x, y, z, 4, oprm)
    assert all(s == 0 for s in nstops)
    assert bool(pk.active.all())
    _compare(traj_k, trace_o, nstops)


def test_legacy_advance_matches_jax(met_setup, table):
    """One shared table and the same nrand bases through the JAX package's
    legacy advance and the port's, fixed step with turbswitch and ifine 4,
    4 steps; the same met (the port's fields carried into JAX)."""
    import jax.numpy as jnp
    from flexpart_tpu.core import advance as jadv
    from flexpart_tpu.core import state as jstate
    from flexpart_tpu.met.fields import ZFields as JZ
    import jax
    grid, z0, z1, _ = met_setup
    cfg, prm, _ = _params(grid, True, 4)
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=grid.xglobal, ldirect=1, turbswitch=True,
                           ifine=4, method=0)
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=0.25,
                                lwindinterv=MEMTIME[1])
    jz = [JZ(**{f: jnp.asarray(getattr(zf, f).numpy())
                for f in JZ._fields}) for zf in (z0, z1)]
    n = 64
    x, y, z = _start_positions(n)
    jtab = jnp.asarray(table.numpy())
    stream = NrandStream(SEED, MAXRAND)
    jp = jstate.empty_particles(n)._replace(
        x_hi=jnp.asarray(x, jnp.float32), y_hi=jnp.asarray(y, jnp.float32),
        z=jnp.asarray(z, jnp.float32), itra=jnp.zeros(n, jnp.int32),
        itramem=jnp.full(n, -1, jnp.int32), mass=jnp.ones((n, 1)),
        active=jnp.ones(n, bool))
    tp = empty_particles(n, device="cpu").replace(
        x_hi=torch.tensor(x, dtype=torch.float32),
        y_hi=torch.tensor(y, dtype=torch.float32),
        z=torch.tensor(z, dtype=torch.float32),
        itra=torch.zeros(n, dtype=torch.int32),
        itramem=torch.full((n,), -1, dtype=torch.int32),
        mass=torch.ones((n, 1)), active=torch.ones(n, dtype=torch.bool))
    for k in range(4):
        ni = np.array([stream.next_nrand() if k == 0 else 1
                       for _ in range(n)])
        na = np.array([stream.next_nrand() for _ in range(n)])
        jp, _ = jadv.advance_all(
            jp, jz[0], jz[1], jnp.int32(k * LSYNC), jnp.int32(0),
            jnp.int32(MEMTIME[1]), jax.random.PRNGKey(0), jcfg, jprm,
            leg=jadv.LegacyRnd(table=jtab,
                               nrand_init=jnp.asarray(ni, jnp.int32),
                               nrand=jnp.asarray(na, jnp.int32)))
        tp, _ = advance_all(
            tp, z0, z1, k * LSYNC, 0, MEMTIME[1], trng.Key(0, 0), cfg, prm,
            leg=LegacyRnd(table=table, nrand_init=torch.from_numpy(ni),
                          nrand=torch.from_numpy(na)))
        np.testing.assert_allclose(tp.x.numpy(), np.asarray(jp.x),
                                   rtol=0, atol=1e-4, err_msg=f"x {k}")
        np.testing.assert_allclose(tp.y.numpy(), np.asarray(jp.y),
                                   rtol=0, atol=1e-4, err_msg=f"y {k}")
        np.testing.assert_allclose(tp.z.numpy(), np.asarray(jp.z),
                                   rtol=1e-4, atol=1e-2, err_msg=f"z {k}")

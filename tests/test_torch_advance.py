"""Port parity: the fixed-step advance against JAX, with JAX's draws.

Both packages advance the same 4096 particles on the same synthetic met
(the JAX ZFields, carried across), and the port consumes exactly the
numbers JAX draws: ``flexpart_tpu.core.rng.normals(key, shape, tag)``
with the key JAX's ``advance_all`` receives (per chunk
``fold_in(key, i)`` for ``advance_chunked``), injected by tag.

Configs: the stock step (turbswitch off, ifine=1, bf16 tables) and the
turbulent one (turbswitch on, ifine=4, f32 tables), 1 and 4 steps.

Tolerances (float32 transcendentals differ by an ulp or two between XLA
and torch, and a 900 s step multiplies velocity differences by 900):
  * x, y: atol 1e-4 grid units;
  * z: rtol 1e-4, atol 1e-2 m;
  * velocities and mesoscale memories: rtol 1e-4, atol 1e-5 m/s;
  * cbt, active, itra and the StepDiag counts: exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import advance as jadv  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402

N = 4096
LSYNC = 900
MEM1 = 10800
CONFIGS = {"stock": dict(turbswitch=False, ifine=1, met_bf16=True),
           "turb_ifine4": dict(turbswitch=True, ifine=4, met_bf16=False)}
TAGS = {6: 6, 1: 2, 3: 3, 4: 3}


@pytest.fixture(scope="module")
def setup():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (0.0, float(MEM1)):
        eta = m.fetch(t)
        h = jmet.compute_heights(grid, eta)
        zs.append(jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h)))
    tz = [interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                      z._asdict().items()}, "cpu") for z in zs]
    rs = np.random.default_rng(42)
    p = jstate.empty_particles(N)
    p = p._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, grid.nx - 1.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.3, grid.ny - 1.3, N), jnp.float32),
        z=jnp.asarray(rs.uniform(5.0, 14000.0, N), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.zeros(N, jnp.int32),
        mass=jnp.full((N, 1), 1.0 / N, jnp.float32))
    return grid, zs, tz, p


def _cfgs(grid, kw):
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=1, method=0, **kw)
    jprm = jadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                dxconst=grid.dxconst, dyconst=grid.dyconst,
                                lsynctime=LSYNC, fine=1.0 / kw["ifine"])
    tcfg = interop.step_config_from_jax(jcfg)
    tprm = interop.step_params_from_numpy(jprm)
    return jcfg, jprm, tcfg, tprm


def _draws(key, n, ifine):
    rows = {**TAGS, 2: ifine}
    return {t: np.asarray(jrng.normals(key, (r, n), tag=t))
            for t, r in rows.items()}


def _to_torch(d):
    return {t: torch.from_numpy(np.array(v)) for t, v in d.items()}


def _compare(tp, jp, tdiag, jdiag, where):
    a = interop.particles_to_numpy(tp)
    b = {k: np.asarray(v) for k, v in jp._asdict().items()}
    x_a, x_b = a["x_hi"] + a["x_lo"], b["x_hi"] + b["x_lo"]
    y_a, y_b = a["y_hi"] + a["y_lo"], b["y_hi"] + b["y_lo"]
    np.testing.assert_allclose(x_a, x_b, rtol=0, atol=1e-4, err_msg=f"x {where}")
    np.testing.assert_allclose(y_a, y_b, rtol=0, atol=1e-4, err_msg=f"y {where}")
    np.testing.assert_allclose(a["z"], b["z"], rtol=1e-4, atol=1e-2,
                               err_msg=f"z {where}")
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{f} {where}")
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {where}")
    for f in ("n_active", "n_exited", "nan_count"):
        assert int(getattr(tdiag, f)) == int(getattr(jdiag, f)), (f, where)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_advance_all_matches_jax(setup, name):
    grid, (j0, j1), (t0, t1), p = setup
    kw = CONFIGS[name]
    jcfg, jprm, tcfg, tprm = _cfgs(grid, kw)
    jp = p
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    base = jax.random.PRNGKey(5)
    for step in range(4):
        itime = step * LSYNC
        key = jax.random.fold_in(base, step)
        draws = _draws(key, N, kw["ifine"])
        jp, jdiag = jadv.advance_all(jp, j0, j1, jnp.int32(itime),
                                     jnp.int32(0), jnp.int32(MEM1), key,
                                     jcfg, jprm)
        tp, tdiag = tadv.advance_all(tp, t0, t1, itime, 0, MEM1,
                                     trng.Key(5, step), tcfg, tprm,
                                     draws=_to_torch(draws))
        if step in (0, 3):          # after 1 and after 4 steps
            _compare(tp, jp, tdiag, jdiag, f"{name} step {step + 1}")


def test_advance_chunked_matches_jax(setup):
    grid, (j0, j1), (t0, t1), p = setup
    kw = CONFIGS["stock"]
    jcfg, jprm, tcfg, tprm = _cfgs(grid, kw)
    n_chunks = 4
    b = N // n_chunks
    jp = p
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    base = jax.random.PRNGKey(9)
    for step in range(2):
        itime = step * LSYNC
        key = jax.random.fold_in(base, step)
        per_chunk = [_draws(jax.random.fold_in(key, i), b, 1)
                     for i in range(n_chunks)]
        draws = {t: np.concatenate([d[t] for d in per_chunk], axis=1)
                 for t in per_chunk[0]}
        jp, jdiag = jadv.advance_chunked(jp, j0, j1, jnp.int32(itime),
                                         jnp.int32(0), jnp.int32(MEM1), key,
                                         jcfg, jprm, n_chunks)
        tp, tdiag = tadv.advance_chunked(tp, t0, t1, itime, 0, MEM1,
                                         trng.Key(9, step), tcfg, tprm,
                                         n_chunks, draws=_to_torch(draws))
        _compare(tp, jp, tdiag, jdiag, f"chunked step {step + 1}")


def test_chunking_does_not_change_the_port(setup):
    """Without injected draws the port's stream is keyed by the global
    particle index, so 1 and 4 chunks give bitwise the same particles."""
    grid, _, (t0, t1), p = setup
    _, _, tcfg, tprm = _cfgs(grid, CONFIGS["stock"])
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    outs = []
    for n_chunks in (1, 4):
        q = tp
        for step in range(2):
            q, diag = tadv.advance_chunked(q, t0, t1, step * LSYNC, 0, MEM1,
                                           trng.Key(77, step), tcfg, tprm,
                                           n_chunks)
        outs.append((interop.particles_to_numpy(q), int(diag.n_active)))
    (a, na), (b, nb) = outs
    assert na == nb
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_outside_slice_raises(setup):
    """What the port's advance does not take raises by name: tile mode
    with nests, or without its tile (``StepConfig.check``,
    ``advance_args``), injected draws with the CBL on a CUDA tensor (K4's
    CBL makes its draws in registers; ``advance_all_cuda`` refuses them
    before it looks at the tensors), and nests with the adaptive step (as
    the reference)."""
    grid = setup[0]
    _, _, tcfg, tprm = _cfgs(grid, CONFIGS["stock"])
    cfg = type(tcfg)(**{**tcfg.__dict__, "tile_mode": True})
    cfg.check()
    with pytest.raises(ValueError, match="Tile"):
        tadv.advance_args(cfg, tprm, 0, 0, 3600)
    # the skewed CBL on a tile is K11 TILE x CBL's (the adaptive step)
    type(tcfg)(**{**cfg.__dict__, "cblflag": True, "method": 1}).check()
    with pytest.raises(ValueError, match="nested"):
        type(tcfg)(**{**cfg.__dict__, "nests": ((5, 5),)}).check()
    cbl = type(tcfg)(**{**tcfg.__dict__, "cblflag": True})
    cbl.check()
    with pytest.raises(ValueError, match="cblflag"):
        tadv.advance_all_cuda(None, None, None, None, None, cbl, {}, 0)
    nested = type(tcfg)(**{**tcfg.__dict__, "nests": ((5, 5),)})
    nested.check()
    with pytest.raises(ValueError, match="nested"):
        type(tcfg)(**{**nested.__dict__, "method": 1}).check()


def _port_particles(p):
    return interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")


@pytest.mark.parametrize("offset", [0, 3 * N + 17])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_own_draws_are_rng_normals_by_tag_row_and_global_index(setup, name,
                                                               offset):
    """With ``draws=None`` the plain advance consumes exactly
    ``rng.normals(key, (rows, n), tag, offset)`` per tag: the (tag, row,
    global particle index) map that the CUDA kernel reproduces in
    registers.  Bitwise."""
    grid, _, (t0, t1), p = setup
    kw = CONFIGS[name]
    _, _, tcfg, tprm = _cfgs(grid, kw)
    tp = _port_particles(p)
    key = trng.Key(31, 2)
    rows = {**tadv.DRAW_ROWS, 2: kw["ifine"]}
    assert set(rows) == set(tadv.DRAW_TAGS)
    injected = {t: trng.normals(key, (r, N), t, offset, device="cpu")
                for t, r in rows.items()}
    a, da = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                             offset=offset)
    b, db = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                             draws=injected, offset=offset)
    a, b = interop.particles_to_numpy(a), interop.particles_to_numpy(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert int(da.n_active) == int(db.n_active)
    other = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                             offset=offset + 1)[0]
    assert not np.array_equal(interop.particles_to_numpy(other)["up"], a["up"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_advance_args_are_the_plain_path_scalars(setup, name):
    """``advance_args`` holds exactly the float32 values the reference
    expressions give (each computed here anew, in numpy float32 where the
    reference computes in float32 and in double where it rounds once)."""
    grid = setup[0]
    kw = CONFIGS[name]
    jcfg, jprm, tcfg, tprm = _cfgs(grid, kw)
    f32 = np.float32
    itime = 2 * LSYNC
    a = tadv.advance_args(tcfg, tprm, itime, 0, MEM1)
    dt = f32(LSYNC)
    r = f32(np.exp(f32(-2.0) * dt / f32(3600)))
    nxm = grid.nx - 1
    eps = f32(grid.nx / 3.0e5)
    want = dict(
        dt=dt, dtf=dt * f32(1.0 / kw["ifine"]), ldirf=f32(1.0),
        htop_eps=f32(100.0 * grid.nx / 3.0e5),
        c_trop=f32(2.0 * 50.0) / dt, c_strat=f32(2.0 * 0.1) / dt,
        uxscale_t=np.sqrt(f32(2.0 * 50.0) / dt),
        wpscale_s=np.sqrt(f32(2.0 * 0.1) / dt),
        d_strat_1000=f32(0.1 / 1000.0), r_meso=r,
        rs_meso=np.sqrt(f32(1.0) - r * r), turbmeso=f32(0.16),
        pi180=f32(np.pi / 180.0), dx=f32(grid.dx), dy=f32(grid.dy),
        ylat0=f32(grid.ylat0), xlon0=f32(grid.xlon0),
        dxconst=f32(grid.dxconst),
        dyconst=f32(grid.dyconst), nxm=f32(nxm), nym=f32(grid.ny - 1),
        two_nym=f32(2.0 * (grid.ny - 1)), eps_bc=eps,
        nxm_eps=f32(nxm) - eps, fine=f32(1.0 / kw["ifine"]), ctl=f32(-5.0),
        mintime=f32(1.0), two_d_trop=f32(2.0 * 50.0),
        two_d_strat=f32(2.0 * 0.1), eps_nest=eps)
    floats = [n for n, t in a._fields_ if t is tadv.ctypes.c_float]
    assert sorted(want) == sorted(floats)
    for k, v in want.items():
        assert isinstance(v, np.floating) and v.dtype == f32, k
        assert f32(getattr(a, k)) == v and getattr(a, k) == float(v), k
    ints = dict(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=1,
                turbswitch=int(kw["turbswitch"]), ifine=kw["ifine"],
                table_bf16=int(kw["met_bf16"]), polar=0, can_pett=1,
                itime=itime,
                itra_new=itime + LSYNC, n=0, offset=0, method=0, turboff=0,
                settling=0, nspec=1, cblflag=0, nnest=0)
    for k, v in ints.items():
        assert getattr(a, k) == v, k
    assert list(a.key) == [0] * 10
    # one species without settling parameters (a gas: density -1)
    assert (a.sp_density[0], a.sp_dquer[0], a.sp_cunningham[0],
            a.sp_vsetaver[0]) == (-1.0, 0.0, 0.0, 0.0)
    # the interval that ends after the met window takes no corrector
    assert tadv.advance_args(tcfg, tprm, MEM1, 0, MEM1).can_pett == 0
    # the same constants as the JAX package's
    from flexpart_tpu import constants as jconst
    assert (jconst.D_TROP, jconst.D_STRAT, jconst.TURBMESOSCALE) == (
        50.0, 0.1, 0.16)
    tw = tadv._time_weights(itime, 0, MEM1, tprm, tcfg)
    dt1, dt2 = f32(itime), f32(MEM1 - itime)
    assert tw[:2] == (float(dt2 * (f32(1.0) / (dt1 + dt2))),
                      float(dt1 * (f32(1.0) / (dt1 + dt2))))
    assert tw[4] == a.itra_new


def test_unknown_device_raises(setup):
    """A tensor that is neither on the CPU nor on a CUDA device raises; it
    does not fall to the plain version."""
    grid, _, (t0, t1), p = setup
    _, _, tcfg, tprm = _cfgs(grid, CONFIGS["stock"])
    tp = _port_particles(p)
    meta = type(tp)(**{f: getattr(tp, f).to("meta") for f in
                       tp.__dataclass_fields__})
    for fn in (tadv.advance_all,
               lambda *a: tadv.advance_chunked(*a, 2)):
        with pytest.raises(ValueError, match="device"):
            fn(meta, t0, t1, 0, 0, MEM1, trng.Key(1, 0), tcfg, tprm)


def test_cuda_particles_never_take_the_plain_version(setup, monkeypatch):
    """The dispatch is by device type alone: ``cuda`` goes to the kernel
    launcher (which raises here, where no kernel can be built), never to
    ``advance_all_plain``."""
    grid, _, (t0, t1), p = setup
    _, _, tcfg, tprm = _cfgs(grid, CONFIGS["stock"])
    tp = _port_particles(p)
    calls = []

    class FakeCuda:
        type = "cuda"

    monkeypatch.setattr(type(tp), "device", property(lambda self: FakeCuda()))
    monkeypatch.setattr(tadv, "advance_all_plain",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(tadv, "advance_all_cuda",
                        lambda *a, **k: calls.append("cuda") or (None, None))
    tables = tadv.build_step_tables_quad(t0, t1, 0.5, 0.5, 0.5, 0.5)
    tadv.advance_all(tp, t0, t1, 0, 0, MEM1, trng.Key(1, 0), tcfg, tprm,
                     tables=tables)
    tadv.advance_chunked(tp, t0, t1, 0, 0, MEM1, trng.Key(1, 0), tcfg, tprm, 4)
    assert calls == ["cuda", "cuda"]     # chunked: one launch, not four


@pytest.mark.parametrize("name", list(CONFIGS))
def test_own_draws_equal_injected_normals(setup, name):
    """The plain advance drawing for itself equals the plain advance fed
    ``rng.normals`` of the same key, tag by tag, with the rows each site
    reads (as the advance kernel's draws in registers must equal the
    normals kernel's): bitwise, at a chunk offset."""
    grid, _, (t0, t1), p = setup
    kw = CONFIGS[name]
    _, _, tcfg, tprm = _cfgs(grid, kw)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    key = trng.Key(31, 6)
    offset = 3 * N
    rows = {**tadv.DRAW_ROWS, 2: kw["ifine"]}
    assert set(rows) == set(tadv.DRAW_TAGS)
    draws = {t: trng.normals(key, (r, N), t, offset, device="cpu")
             for t, r in rows.items()}
    own, d_own = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg,
                                  tprm, offset=offset)
    fed, d_fed = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg,
                                  tprm, draws=draws, offset=offset)
    for f in tadv.OUT_FIELDS:
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      getattr(fed, f).numpy(), err_msg=f)
    assert int(d_own.n_active) == int(d_fed.n_active)
    other, _ = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                                offset=0)
    assert not np.array_equal(other.up.numpy(), own.up.numpy())

"""Port parity: the skewed convective boundary layer (``cblflag=1``).

``flexpart_tpu_torch/core/cbl.py`` against ``flexpart_tpu/core/cbl.py`` on
the same seeded numpy inputs, and the plain advance with the CBL against
JAX's ``advance_all``, fixed and adaptive, with JAX's draws injected (tags
6, 1, 2, 3, 4; the CBL's 7 (a uniform), 8 and 40 + i; in the adaptive step
tags 1, 2 and 40 + i per pass, drawn with ``fold_in(key, 9000 + k)``).

Inputs are physical: sigw, dsigwdz and tlw from JAX's Hanna (turbswitch
form) at the particle, wp a draw of sigw; -h/L either side of 5 (where the
skewed scheme starts) and of 15 (where the skewness stops being tapered),
w* down to 0.02 m/s (skewness near 0), wp of both signs and zero.  The
bi-Gaussian functions are compared where they apply, -h/L > 5: below it
the parameters are ill-conditioned (the updraft area tends to 0) and the
advance never reads them.

Tolerances.  The two packages round ``erf``, ``sin``, ``pow`` and ``exp``
differently on the CPU (XLA's and torch's float32 kernels), and the port
writes the integer and ``-2`` powers as products; so nothing here is
bitwise:
  * the bi-Gaussian parameters, drift, redraws and fresh velocities: rtol
    1e-3 with atol 1e-5 (measured: 1.6e-4 relative at most, on dsb near
    -h/L = 5, the redraw 1.3e-6 absolute); the redraw flag and the legacy
    redraw's table indices exactly;
  * the fixed step (4 substeps of 225 s: both sides of the dtftlw < 0.5
    switch; half the particles skewed): as ``tests/test_torch_advance.py`` for x, y
    (1e-4 grid units), z within 1e-2 m + 1e-4 relative and the velocities
    within 1e-4 m/s + 1e-3 relative for 99% of the particles, every
    particle within 1 m and 1e-2 m/s; cbt, active, the counts and
    ``nan_count`` equal;
  * the adaptive step (ctl 2, ifine 4: a substep of about half a tlw, so
    both sides of the switch again; JAX's compile time grows with ifine,
    and chip_smoke.py runs Command's ctl 5, ifine 11 on the card): at
    least 98% of the particles
    with JAX's idt and pass count, and over those x, y within 1e-4, z
    within 1e-2 m + 1e-4 relative (``trunc(lim * ctl)`` is a cliff, as
    ``tests/test_torch_adaptive.py`` states).
With the port's own Philox draws the plain advance consumes exactly
``rng.uniforms`` (tag 7) and ``rng.normals`` (tags 8 and 40 + i, in the
adaptive step with the pass in the counter): bitwise, which is the stream
K11's CBL instantiation makes in registers.
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
from flexpart_tpu.core import cbl as jcbl  # noqa: E402
from flexpart_tpu.core import hanna as jhanna  # noqa: E402
from flexpart_tpu.core import rng as jrng  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.met.fields import F2_HMIX, F2_OLI, F2_WSTAR  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import cbl as tcbl  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402

N = 2048
LSYNC = 900
MEM1 = 10800
RTOL, ATOL = 1e-3, 1e-5
FIXED_IFINE = 4
ADAPTIVE_IFINE = 4
ADAPTIVE_CTL = 2.0
PASSES = 40


def _inputs(seed=3, n=N):
    """Physical inputs of the bi-Gaussian functions, -h/L > 5."""
    rs = np.random.default_rng(seed)
    h = rs.uniform(300.0, 2500.0, n).astype(np.float32)
    z = (rs.uniform(0.01, 1.0, n) * h).astype(np.float32)
    q = n // 4
    mhol = np.concatenate([rs.uniform(5.1, 5.5, q), rs.uniform(5.5, 14.9, q),
                           rs.uniform(15.1, 80.0, n - 2 * q)])
    ol = (-h / mhol).astype(np.float32)
    wst = rs.uniform(0.3, 2.5, n).astype(np.float32)
    wst[:64] = 0.02                          # skewness near 0
    ust = rs.uniform(0.1, 0.6, n).astype(np.float32)
    t = jhanna.hanna(*(jnp.asarray(a) for a in (z, h, ust, wst, ol)))
    sigw, dsig, tlw = (np.asarray(v) for v in (t.sigw, t.dsigwdz, t.tlw))
    wp = (rs.normal(0.0, 1.0, n) * sigw).astype(np.float32)
    wp[100:140] = 0.0
    return dict(z=z, h=h, wst=wst, ol=ol, sigw=sigw, dsig=dsig, tlw=tlw,
                wp=wp, rho=rs.uniform(0.9, 1.2, n).astype(np.float32),
                drho=rs.uniform(-1.2e-4, -0.8e-4, n).astype(np.float32),
                r1=rs.normal(size=n).astype(np.float32),
                r2=rs.normal(size=n).astype(np.float32),
                u=rs.uniform(size=n).astype(np.float32))


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("fn", ["skew_params", "cbl_terms", "reinit_wp",
                                "init_cbl_wp", "legacy_reinit_wp"])
def test_cbl_functions_match_jax(fn):
    d = _inputs()
    geo = ("z", "wst", "h", "sigw", "dsig", "ol")
    if fn == "skew_params":
        order = ("z", "h", "wst", "sigw", "dsig", "ol")
        jo = jcbl._skew_params(*(_j(d[k]) for k in order))
        to = tcbl._skew_params(*(_t(d[k]) for k in order))
        for i, (a, b) in enumerate(zip(to, jo)):
            _close(a, b, f"skew parameter {i}")
    elif fn == "cbl_terms":
        order = ("wp", "z", "wst", "h", "rho", "drho", "sigw", "dsig",
                 "tlw", "ol")
        ja = jcbl.cbl_terms(*(_j(d[k]) for k in order), 1)
        ta = tcbl.cbl_terms(*(_t(d[k]) for k in order), 1)
        _close(ta[0], ja[0], "ath")
        _close(ta[1], ja[1], "bth")
        np.testing.assert_array_equal(ta[2].numpy(), np.asarray(ja[2]))
    elif fn == "reinit_wp":
        args = ("r1", "r2", "wp") + geo
        _close(tcbl.reinit_wp(*(_t(d[k]) for k in args), 1),
               jcbl.reinit_wp(*(_j(d[k]) for k in args), 1), "reinit_wp")
    elif fn == "init_cbl_wp":
        args = ("u", "r1") + geo
        _close(tcbl.init_cbl_wp(*(_t(d[k]) for k in args), 1),
               jcbl.init_cbl_wp(*(_j(d[k]) for k in args), 1), "init_cbl_wp")
    else:
        from flexpart_tpu_torch.validation.legacy_rng import make_rannumb
        tab = make_rannumb(100000, -7)
        nr = np.random.default_rng(9).integers(1, 99000, N).astype(np.int32)
        args = ("wp",) + geo
        jw, ji = jcbl.legacy_reinit_wp(_j(tab), _j(nr),
                                       *(_j(d[k]) for k in args), 1)
        tw, ti = tcbl.legacy_reinit_wp(_t(tab), _t(nr).long(),
                                       *(_t(d[k]) for k in args), 1)
        _close(tw, jw, "legacy_reinit_wp")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _skew_params_unsplit(z, h, wst, sigw, dsigwdz, ol):
    """The bi-Gaussian parameters in one function, core/cbl.py's code
    before the column's part (skew_column) was split off: -h/L, the taper
    and wst**3 computed at every call."""
    zeta = z / h
    mhol = -h / ol
    taper = torch.sin((mhol + 10.0) / torch.full_like(mhol, 10.0) * np.pi) \
        / torch.full_like(mhol, 2.0) + 0.5
    transition = torch.where(mhol < tcbl.SKEW_TRANSITION, taper,
                             torch.ones_like(taper))
    w2 = sigw * sigw
    dw2 = 2.0 * sigw * dsigwdz
    omz = torch.clamp(1.0 - zeta, min=0.0)
    omz15 = torch.pow(omz, 1.5)
    wst3 = wst * wst * wst
    w3 = ((1.2 * zeta * omz15) + tcbl.EPS_C) * wst3 * transition
    dw3 = (1.2 * (omz15 - zeta * 1.5 * torch.sqrt(omz))) * wst3 / h \
        * transition
    w2_15 = torch.pow(w2, 1.5)
    skew = w3 / w2_15
    skew2 = skew * skew
    dskew = (dw3 * w2_15 - w3 * 1.5 * torch.sqrt(w2) * dw2) / (w2 * w2 * w2)
    radw2 = torch.sqrt(w2)
    dradw2 = 0.5 * dw2 / torch.sqrt(w2)
    fluarw = tcbl.COSTLUAR4 * tcbl._cuberoot(skew)
    fluarw2 = fluarw * fluarw
    nz = skew != 0.0
    one = torch.ones_like(skew)
    zero = torch.zeros_like(skew)
    safe = torch.where(nz, skew, one)
    dfluarw = torch.where(
        nz, tcbl.COSTLUAR4 / 3.0 * tcbl._cuberoot(tcbl._div(1.0, safe * safe)) * dskew, zero)
    f2p1 = 1.0 + fluarw2
    f2p3 = 3.0 + fluarw2
    fl_s = torch.where(nz, fluarw, one)
    f2p1_3 = f2p1 * f2p1 * f2p1
    f2p3_2 = f2p3 * f2p3
    f2p1_15 = torch.pow(f2p1, 1.5)
    rluarw = torch.where(nz, f2p1_3 * skew2 / (f2p3_2 * fluarw2), zero)
    xluarw = torch.where(nz, f2p1_15 * skew / (f2p3 * fl_s), zero)
    den_r = f2p3_2 * fluarw2
    drluarw = torch.where(nz, (
        ((3.0 * (f2p1 * f2p1) * (2.0 * fluarw * dfluarw) * skew2)
         + f2p1_3 * 2.0 * skew * dskew) * f2p3_2 * fluarw2
        - f2p1_3 * skew2
        * ((2.0 * f2p3 * (2.0 * fluarw * dfluarw) * fluarw2)
           + f2p3_2 * 2.0 * fluarw * dfluarw))
        / torch.clamp(den_r * den_r, min=1e-30), zero)
    den_x = f2p3 * fl_s
    dxluarw = torch.where(nz, (
        ((1.5 * torch.sqrt(f2p1) * (2.0 * fluarw * dfluarw) * skew)
         + f2p1_15 * dskew) * f2p3 * fl_s
        - f2p1_15 * skew * (3.0 * dfluarw + 3.0 * fluarw2 * dfluarw))
        / torch.clamp(den_x * den_x, min=1e-30), zero)

    s4r = torch.sqrt(4.0 + rluarw)
    aluarw = 0.5 * (1.0 - xluarw / s4r)
    bluarw = 1.0 - aluarw
    daluarw = -0.5 * ((dxluarw * s4r) - (0.5 * xluarw * drluarw / s4r)) \
        / (4.0 + rluarw)
    dbluarw = -daluarw
    al_s = torch.clamp(aluarw, min=1e-6)
    bl_s = torch.clamp(bluarw, min=1e-6)
    af = al_s * f2p1
    bf = bl_s * f2p1
    qa = torch.sqrt(bl_s / af)
    qb = torch.sqrt(al_s / bf)
    sigmawa = radw2 * qa
    sigmawb = radw2 * qb
    dsigmawa = dradw2 * qa + radw2 * (
        tcbl._div(0.5, qa)
        * ((dbluarw * af - bl_s * (daluarw * f2p1 + al_s * 2.0 * fluarw
                                   * dfluarw)) / (af * af)))
    dsigmawb = dradw2 * qb + radw2 * (
        tcbl._div(0.5, qb)
        * ((daluarw * bf - al_s * (dbluarw * f2p1 + bl_s * 2.0 * fluarw
                                   * dfluarw)) / (bf * bf)))
    wa = fluarw * sigmawa
    wb = fluarw * sigmawb
    dwa = dfluarw * sigmawa + fluarw * dsigmawa
    dwb = dfluarw * sigmawb + fluarw * dsigmawb
    return (aluarw, bluarw, daluarw, dbluarw, sigmawa, sigmawb,
            dsigmawa, dsigmawb, wa, wb, dwa, dwb)


@pytest.mark.parametrize("half", ["column", "at_height"])
def test_skew_split_is_the_unsplit_form_bitwise(half):
    """The plain version splits the bi-Gaussian parameters as K11 does:
    the column's part (skew_column: the taper, wst**3 and the zone test,
    from h, w* and L only, once a pass) and the part at the substep's
    height (skew_at).  Composed they are the unsplit parameters bit for
    bit, the column once for many heights as the substeps of a pass take
    it; and the drift with the column handed in equals the drift that
    computes it (cbl_terms), bitwise.  Against JAX: as
    test_cbl_functions_match_jax."""
    d = _inputs()
    t = {k: _t(v) for k, v in d.items()}
    col = tcbl.skew_column(t["h"], t["wst"], t["ol"])
    if half == "column":
        mhol = -t["h"] / t["ol"]
        assert torch.equal(col.zone, mhol > tcbl.CBL_ZONE)
        assert torch.equal(col.wst3, t["wst"] * t["wst"] * t["wst"])
        order = ("wp", "z", "wst", "h", "rho", "drho", "sigw", "dsig",
                 "tlw", "ol")
        whole = tcbl.cbl_terms(*(t[k] for k in order), 1)
        split = tcbl.cbl_terms(*(t[k] for k in order), 1, col)
        for a, b in zip(whole, split):
            assert torch.equal(a, b)
        ja = jcbl.cbl_terms(*(_j(d[k]) for k in order), 1)
        _close(split[0], ja[0], "ath")
        _close(split[1], ja[1], "bth")
        return
    # the same column at heights through the layer, as a pass's substeps
    for frac in (0.05, 0.3, 0.6, 0.95):
        z = (t["h"] * frac).to(torch.float32)
        got = tcbl.skew_at(z, t["h"], t["sigw"], t["dsig"], col)
        want = _skew_params_unsplit(z, t["h"], t["wst"], t["sigw"],
                                    t["dsig"], t["ol"])
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        jo = jcbl._skew_params(_j(z.numpy()), *(_j(d[k]) for k in (
            "h", "wst", "sigw", "dsig", "ol")))
        for i, (a, b) in enumerate(zip(got, jo)):
            _close(a, b, f"skew parameter {i} at {frac} h")


def test_zero_velocity_sign_conventions():
    """A particle at wp = 0 is a downdraft to ``reinit_wp`` (jnp.sign(0) *
    timedir > 0 is false) and an updraft to the legacy redraw (Fortran's
    sign(1., 0.) is +1); both ports keep their reference's convention."""
    d = _inputs(n=16)
    geo = [_t(d[k]) for k in ("z", "wst", "h", "sigw", "dsig", "ol")]
    zero = torch.zeros(16)
    # normals far in the updraft's tail: an updraft would take them as drawn
    up = torch.full((16,), 3.0)
    w = tcbl.reinit_wp(up, up, zero, *geo, 1)
    assert bool((w <= 0.0).all())
    from flexpart_tpu_torch.validation.legacy_rng import make_rannumb
    tab = torch.from_numpy(make_rannumb(1000, -7))
    wl, _ = tcbl.legacy_reinit_wp(tab, torch.full((16,), 5), zero, *geo, 1)
    assert bool((wl >= 0.0).all())


def _convective(zf, split_x):
    """tests/test_matched_rng.py::_make_convective on a JAX ZFields: hmix
    1500 m, w* 1.8 m/s, L = -25 m east of split_x (-h/L = 60) and -1200 m
    west of it (-h/L = 1.25)."""
    f2 = np.array(np.asarray(zf.f2d))
    ny, nx = f2.shape[-2:]
    oli = np.full((ny, nx), 1.0 / -1200.0, np.float32)
    oli[:, split_x:] = 1.0 / -25.0
    f2[F2_HMIX] = 1500.0
    f2[F2_WSTAR] = 1.8
    f2[F2_OLI] = oli
    return zf._replace(f2d=jnp.asarray(f2))


@pytest.fixture(scope="module")
def met():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (0.0, float(MEM1)):
        eta = m.fetch(t)
        h = jmet.compute_heights(grid, eta)
        zs.append(_convective(jmet.calcpar(grid, eta, jmet.process_eta(
            grid, eta, h)), grid.nx // 2))
    tz = [interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                      z._asdict().items()}, "cpu") for z in zs]
    return grid, zs, tz


def _particles(grid, seed=42):
    """Boundary-layer particles over the whole grid (half in the skewed
    east), some fresh, some with an idt of an earlier step."""
    rs = np.random.default_rng(seed)
    p = jstate.empty_particles(N)
    return p._replace(
        x_hi=jnp.asarray(rs.uniform(0.0, grid.nx - 1.0, N), jnp.float32),
        y_hi=jnp.asarray(rs.uniform(0.3, grid.ny - 1.3, N), jnp.float32),
        z=jnp.asarray(np.where(rs.uniform(size=N) < 0.85,
                               rs.uniform(5.0, 1450.0, N),
                               rs.uniform(1500.0, 4000.0, N)), jnp.float32),
        active=jnp.asarray(rs.uniform(size=N) < 0.97),
        itra=jnp.zeros(N, jnp.int32),
        itramem=jnp.asarray(np.where(rs.uniform(size=N) < 0.5, LSYNC, -3600),
                            jnp.int32),
        idt=jnp.asarray(rs.integers(0, 300, N), jnp.int32),
        up=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        vp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        wp=jnp.asarray(rs.uniform(-1, 1, N), jnp.float32),
        mass=jnp.full((N, 1), 1.0 / N, jnp.float32))


def _cfgs(grid, method, ifine):
    jcfg = jadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                           xglobal=True, ldirect=1, turbswitch=True,
                           ifine=ifine, method=method, cblflag=True)
    jprm = jadv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0 / ifine,
        ctl=ADAPTIVE_CTL if method == 1 else -5.0)
    return (jcfg, jprm, interop.step_config_from_jax(jcfg),
            interop.step_params_from_numpy(jprm))


def _jax_draws(key, ifine, method):
    """JAX's draws of one step, keyed by tag: (rows, n), the uniforms and
    normals of tags 7 and 8 (n,), and in the adaptive step tags 1, 2 and
    40 + i stacked over the passes."""
    out = {t: np.asarray(jrng.normals(key, (r, N), tag=t))
           for t, r in ((6, 6), (3, 3), (4, 3))}
    out[7] = np.asarray(jrng.uniforms(key, (N,), tag=7))
    out[8] = np.asarray(jrng.normals(key, (N,), tag=8))
    per_pass = [(1, 2), (2, ifine)] + [(40 + i, 2) for i in range(ifine)]
    for tag, rows in per_pass:
        if method == 0:
            out[tag] = np.asarray(jrng.normals(key, (rows, N), tag=tag))
        else:
            out[tag] = np.asarray(jax.vmap(lambda k: jrng.normals(
                jax.random.fold_in(key, 9000 + k), (rows, N), tag=tag))(
                    jnp.arange(PASSES)))
    return {t: torch.from_numpy(np.array(v)) for t, v in out.items()}


def _port(p):
    return interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")


def _step(met, method, ifine, seed=42):
    grid, (j0, j1), (t0, t1) = met
    jcfg, jprm, tcfg, tprm = _cfgs(grid, method, ifine)
    p = _particles(grid, seed)
    key = jax.random.PRNGKey(seed)
    itime = LSYNC
    jp, jd = jadv.advance_all(p, j0, j1, jnp.int32(itime), jnp.int32(0),
                              jnp.int32(MEM1), key, jcfg, jprm)
    tp, td = tadv.advance_all(_port(p), t0, t1, itime, 0, MEM1,
                              trng.Key(1, 0), tcfg, tprm,
                              draws=_jax_draws(key, ifine, method))
    return p, jp, jd, tp, td, tcfg


def _skewed(p, met):
    """The share of the particles that start in a skewed column of the
    boundary layer (the east half, z below 1500 m)."""
    grid = met[0]
    x = np.asarray(p.x_hi)
    return float(((x >= grid.nx // 2) & (np.asarray(p.z) <= 1500.0)).mean())


def test_cbl_fixed_step_matches_jax(met):
    p, jp, jd, tp, td, _ = _step(met, 0, FIXED_IFINE)
    assert 0.3 < _skewed(p, met) < 0.6
    a = interop.particles_to_numpy(tp)
    b = {k: np.asarray(v) for k, v in jp._asdict().items()}
    np.testing.assert_allclose(a["x_hi"] + a["x_lo"], b["x_hi"] + b["x_lo"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(a["y_hi"] + a["y_lo"], b["y_hi"] + b["y_lo"],
                               rtol=0, atol=1e-4)
    dz = np.abs(a["z"] - b["z"])
    assert np.mean(dz <= 1e-2 + 1e-4 * np.abs(b["z"])) >= 0.99
    assert dz.max() <= 1.0
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        dv = np.abs(a[f] - b[f])
        assert np.mean(dv <= 1e-4 + 1e-3 * np.abs(b[f])) >= 0.99, f
        assert dv.max() <= 1e-2, f
    for f in ("cbt", "active", "itra"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("n_active", "n_exited", "nan_count"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f


def test_cbl_adaptive_step_matches_jax(met):
    p, jp, jd, tp, td, _ = _step(met, 1, ADAPTIVE_IFINE)
    a = interop.particles_to_numpy(tp)
    b = {k: np.asarray(v) for k, v in jp._asdict().items()}
    same = (a["idt"] == b["idt"]) & a["active"]
    assert same.mean() >= 0.98 * a["active"].mean()
    np.testing.assert_allclose((a["x_hi"] + a["x_lo"])[same],
                               (b["x_hi"] + b["x_lo"])[same], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose((a["y_hi"] + a["y_lo"])[same],
                               (b["y_hi"] + b["y_lo"])[same], rtol=0,
                               atol=1e-4)
    dz = np.abs(a["z"] - b["z"])[same]
    assert np.mean(dz <= 1e-2 + 1e-4 * np.abs(b["z"][same])) >= 0.99
    for f in ("x_hi", "y_hi", "z", "wp"):
        assert np.isfinite(a[f]).all(), f
    for f in ("n_active", "n_exited", "nan_count"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f
    np.testing.assert_allclose(td.t_below.numpy()[same],
                               np.asarray(jd.t_below)[same], atol=1e-3)


@pytest.mark.parametrize("method", [0, 1])
def test_cbl_own_draws_are_the_philox_stream(met, method):
    """With draws=None the plain advance with the CBL consumes exactly the
    port's Philox stream: rng.uniforms (tag 7), rng.normals (tags 8 and
    40 + i; in the adaptive step 1, 2 and 40 + i with the pass in the
    counter), at an offset: bitwise."""
    grid, _, (t0, t1) = met
    ifine = FIXED_IFINE if method == 0 else ADAPTIVE_IFINE
    _, _, tcfg, tprm = _cfgs(grid, method, ifine)
    tp = _port(_particles(grid, 7))
    key, off = trng.Key(31, 2), 3 * N + 5
    draws = {t: trng.normals(key, (r, N) if r else (N,), t, off,
                             device="cpu")
             for t, r in tadv.draw_tags(tcfg).items()}
    draws[7] = trng.uniforms(key, N, 7, off, device="cpu")
    if method == 1:
        for t in tadv.pass_tags(tcfg):
            rows = tadv.draw_tags(tcfg)[t]
            draws[t] = torch.stack([trng.normals(
                key, (rows, N), t, off, device="cpu", pass_index=k)
                for k in range(PASSES)])
    a, da = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                             offset=off)
    b, db = tadv.advance_all(tp, t0, t1, LSYNC, 0, MEM1, key, tcfg, tprm,
                             draws=draws, offset=off)
    for f in tadv.OUT_FIELDS + (("idt",) if method else ()):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f
    assert int(da.nan_count) == int(db.nan_count)


@pytest.mark.parametrize("nested", [False, True])
def test_cbl_and_nested_runs_configure_as_jax(tmp_path, nested):
    """``Command(cblflag=1)`` and a nested met grid build in both packages'
    ``Simulation`` (no run) with the same StepConfig and StepParams: the
    CBL forces the adaptive step, turbswitch and ifine 11 (ctl 5); a nest
    gives its shape and window."""
    from flexpart_tpu import config as jconfig
    from flexpart_tpu.run.simulation import Simulation as JaxSimulation
    from flexpart_tpu_torch import config as tconfig
    from flexpart_tpu_torch import met as tmet
    from flexpart_tpu_torch.run.simulation import Simulation
    sims = []
    for c, m, extra in ((jconfig, jmet, {}), (tconfig, tmet,
                                              dict(device="cpu"))):
        grid = m.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
        cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                        ietime=20000, lsynctime=900, loutstep=3600,
                        loutaver=3600, loutsample=900,
                        cblflag=0 if nested else 1)
        box = c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                           itime2=10000, lon1=0.0, lon2=2.0, lat1=40.0,
                           lat2=42.0, z1=50.0, z2=500.0, mass=(1.0,),
                           parts=100)
        if nested:
            ng = m.make_grid(nx=33, ny=17, nlev=15, dx=2.5, dy=2.5,
                             xlon0=-70.0, ylat0=30.0, xglobal=False)
            extra = dict(extra, met_nests=(m.SyntheticMet(ng),))
        og = c.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60,
                       numygrid=40, dxout=2.0, dyout=2.0,
                       outheights=(500.0, 2000.0, 50000.0))
        sims.append((JaxSimulation if c is jconfig else Simulation)(
            cmd=cmd, releases=c.Releases(species=(c.Species(),),
                                         boxes=(box,)),
            grid=grid, met_backend=m.SyntheticMet(grid), outgrid=og,
            outdir=str(tmp_path / c.__name__), **extra))
    jsim, sim = sims
    assert interop.step_config_from_jax(jsim.step_cfg) == sim.step_cfg
    jprm = interop.step_params_from_numpy(jsim.step_prm)
    for f in ("ctl", "fine", "lsynctime") + (tadv.NEST_PARAMS if nested
                                             else ()):
        assert getattr(sim.step_prm, f) == getattr(jprm, f), f
    if nested:
        assert sim.step_cfg.nests == ((33, 17),) and sim.step_cfg.method == 0
    else:
        assert (sim.step_cfg.cblflag, sim.step_cfg.method,
                sim.step_cfg.ifine, sim.step_cfg.turbswitch) == (
                    True, 1, 11, True)


def test_small_cbl_run(tmp_path):
    """The port's run recipe with ``Command(cblflag=1)`` on the CPU (two
    hours, 1000 particles at 40-42 N, where SyntheticMet's columns are
    strongly convective): every particle active and finite, the skewed
    scheme taken by most of them, the tracer's mass recovered from the
    output (within 1e-3), the NaN redraws counted (an int)."""
    from flexpart_tpu_torch import config as tconfig
    from flexpart_tpu_torch import met as tmet
    from flexpart_tpu_torch.core.interp import (build_step_tables_quad,
                                                horiz_weights,
                                                sample_all_quad,
                                                vert_weights)
    from flexpart_tpu_torch.run.simulation import Simulation
    grid = tmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    cmd = tconfig.Command(ibdate=20200101, ibtime=0, iedate=20200101,
                          ietime=20000, lsynctime=900, loutstep=3600,
                          loutaver=3600, loutsample=900, cblflag=1)
    box = tconfig.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                             itime2=0, lon1=0.0, lon2=2.0, lat1=40.0,
                             lat2=42.0, z1=50.0, z2=500.0, mass=(1.0,),
                             parts=1000)
    og = tconfig.OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60,
                         numygrid=40, dxout=2.0, dyout=2.0,
                         outheights=(500.0, 2000.0, 50000.0))
    sim = Simulation(cmd=cmd, releases=tconfig.Releases(
        species=(tconfig.Species(),), boxes=(box,)), grid=grid,
        met_backend=tmet.SyntheticMet(grid), outgrid=og,
        outdir=str(tmp_path), device="cpu")
    z0 = sim._get_field(0)
    tabs = build_step_tables_quad(z0, z0, 1.0, 0.0, 1.0, 0.0)
    p = sim.particles
    hw = horiz_weights(p.x, p.y, grid.nx, grid.ny, True)
    h, _, _, _, ol, _ = sample_all_quad(tabs, hw, *vert_weights(p.z,
                                                                z0.height),
                                        p.x, p.y, grid.nx, grid.ny)
    assert float(((-h / ol) > 5.0).float().mean()) > 0.9
    sim.run()
    p = sim.particles
    assert int(p.active.sum()) == 1000
    for f in ("x_hi", "y_hi", "z", "up", "vp", "wp"):
        assert bool(torch.isfinite(getattr(p, f)).all()), f
    assert isinstance(sim.nan_count, int) and sim.nan_count >= 0
    d = np.load(sorted(tmp_path.glob("grid_conc_*.npz"))[-1])
    mass = (d["conc"][0, 0, 0] * sim.geo.volume).sum() / 1e12
    assert abs(mass - 1.0) < 1e-3

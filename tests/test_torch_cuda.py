"""Tests of the port that need an NVIDIA card (marker ``cuda``).  Without
one they skip.  On a card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use.)"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    return torch.device("cuda")


def test_k6_layout_query_leaves_a_larger_launch_running(card):
    """K6's layout query at L1 = 26 (22,512 B a block) does not cap the
    shared memory of a later launch that needs more but no more than the
    default 48 KB (L1 = 38: 40,176 B a block); that launch runs and equals
    the plain pipeline bitwise."""
    from flexpart_tpu_torch.met import synthetic
    from flexpart_tpu_torch.physics import convection as cv
    lay = cv.k6_layout(25)
    assert lay["shared_bytes_per_column"] * lay["columns_per_block"] == 22512
    grid = synthetic.make_grid(nx=73, ny=37, nlev=44)
    kern = cv.make_convection_kernel(grid)
    assert kern.L1 == 38
    need = cv.k6_columns_per_block(kern.L1) * cv.k6_shared_bytes(kern.L1)
    assert 22512 < need <= 48 * 1024
    met = synthetic.SyntheticMet(grid)
    eta = ("ps", "tth", "qvh", "tt2", "td2")
    e0, e1 = (met.fetch(t, card) for t in (0.0, 3600.0))
    fields = tuple(getattr(e0, n) for n in eta) \
        + tuple(getattr(e1, n) for n in eta)
    cbmf = torch.zeros(grid.nx * grid.ny, dtype=torch.float32, device=card)
    k = cv.convection_cuda(kern, fields, 0.75, 0.25, cbmf, 900.0)
    p = cv.convection_plain(kern, fields, 0.75, 0.25, cbmf, 900.0)
    torch.cuda.synchronize()
    assert int(k.lconv.sum()) > 0
    for f in cv.ConvectionFields._fields:
        a, b = getattr(k, f), getattr(p, f)
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def _advance_inputs(card, method: int, n: int = 2 ** 16):
    """The advance of a settling, polar step on SyntheticMet's 37 x 19 x 15
    grid: K4's SETTLING instantiation (method 0) or K11 (method 1,
    turbswitch, ifine 4, ctl 5), ``n`` particles of two species at 5-2500
    m, 97% scheduled, half fresh.  Returns (particles, ZFields of the two
    met times, cfg, tables, args, key, settling fields, the generator,
    grid)."""
    from flexpart_tpu_torch.core import advance as adv
    from flexpart_tpu_torch.core import interp, rng
    from flexpart_tpu_torch.core.state import empty_particles
    from flexpart_tpu_torch.met import calcpar, synthetic, verttransform
    grid = synthetic.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    met = synthetic.SyntheticMet(grid)
    zs = []
    for t in (0.0, 10800.0):
        eta = met.fetch(t, card)
        h = verttransform.compute_heights(grid, eta)
        zs.append(calcpar.calcpar(grid, eta,
                                  verttransform.process_eta(grid, eta, h)))
    gen = torch.Generator(device=card).manual_seed(5)

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=card) * (hi - lo) + lo

    mass0 = torch.zeros((n, 2), device=card)
    first = u(0.0, 1.0) < 0.5
    mass0[first, 0] = 1.0
    mass0[~first, 1] = 1.0
    p = empty_particles(n, 2, device=card).replace(
        x_hi=u(0.0, grid.nx - 1.0), y_hi=u(0.0, grid.ny - 1.0),
        z=u(5.0, 2500.0), active=u(0.0, 1.0) < 0.97,
        itra=torch.zeros(n, dtype=torch.int32, device=card),
        itramem=torch.where(u(0.0, 1.0) < 0.5, 900, -3600).to(torch.int32),
        mass=mass0.clone(), mass0=mass0)
    cfg = adv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                         ldirect=1, turbswitch=method == 1,
                         ifine=4 if method else 1, method=method,
                         settling=True, polar=True)
    prm = adv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=900, fine=1.0 / cfg.ifine,
        ctl=5.0 if method else -5.0, sp_density=[2500.0, -1.0],
        sp_dquer=[10.0, 0.0], sp_cunningham=[1.02, 0.0],
        sp_vsetaver=[-0.007, 0.0])
    tw = adv._time_weights(900, 0, 10800, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(zs[0], zs[1], *tw,
                                           dtype=cfg.table_dtype)
    a = adv.advance_args(cfg, prm, 900, 0, 10800)
    return (p, zs, cfg, tables, a, rng.Key(11, 3), adv.settle_met(zs[0], cfg),
            gen, grid)


@pytest.mark.parametrize("method", [0, 1])
def test_settling_and_adaptive_kernels_equal_their_plain_versions(card,
                                                                  method):
    """K4's SETTLING instantiation (method 0) and K11 (method 1, settling
    and the polar caps on) against ``advance_all_plain`` on the card, which
    draws with K1 (the adaptive step's pass by pass): every output bitwise,
    K4 also fed K1's draws (K11 reads none and refuses them); K10's
    T_BELOW instantiation on K11's window."""
    import copy
    from flexpart_tpu_torch.core import advance as adv
    from flexpart_tpu_torch.core import rng
    from flexpart_tpu_torch.physics import massupdate as mu
    p, zs, cfg, tables, a, key, settle, gen, grid = _advance_inputs(card,
                                                                    method)
    n = p.capacity
    kernel = adv.advance_adaptive_cuda if method else adv.advance_all_cuda
    rows = {**adv.DRAW_ROWS, 2: cfg.ifine}
    draws = {t: rng.normals(key, (r, n), t, device=card)
             for t, r in rows.items()}
    if method:
        with pytest.raises(ValueError, match="in registers"):
            kernel(p, zs[0].height, tables, copy.copy(a), key, cfg, draws, 0,
                   settle)
    runs = [kernel(p, zs[0].height, tables, copy.copy(a), key, cfg, d, 0,
                   settle) for d in ((None,) if method else (None, draws))]
    pp, dp = adv.advance_all_plain(p, zs[0].height, tables, copy.copy(a), key,
                                   cfg, None, 0, settle)
    torch.cuda.synchronize()
    for pk, dk in runs:
        for f in adv.ADAPTIVE_OUT_FIELDS:
            x, y = getattr(pk, f), getattr(pp, f)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f
        if method:
            assert torch.equal(dk.t_below, dp.t_below)
            assert torch.equal(dk.passes, dp.passes)
    if method:
        vdep = torch.rand((2, grid.ny, grid.nx), generator=gen,
                          device=card) * 0.01
        sp = mu.MassSpecies(decay=(0.0, 1e-6), drydep=(True, True))
        k10 = mu.decay_drydep_cuda(p, vdep, 900, 600, sp, True, dp.t_below)
        pl = mu.apply_decay_drydep_plain(p, vdep, 900, 600, sp, True,
                                         dp.t_below)
        assert torch.equal(k10[0].mass.view(torch.int32),
                           pl[0].mass.view(torch.int32))
        assert torch.equal(k10[1].view(torch.int32), pl[1].view(torch.int32))


K11_RAGGED = ("n17", "n257", "n10000", "above_h", "one_long_among_idle")


@pytest.mark.parametrize("case", K11_RAGGED)
def test_k11_refill_edges_equal_the_plain_version(card, case):
    """K11's refilled lanes on ragged ensembles cut from the adaptive
    step's inputs: fewer particles than a warp (17), a block and one (257),
    fewer than the card holds at once (10,000), particles that all start
    above h (no pass), and the particle with the most passes on slot 5
    among 63 that take none (the draw counter's offset keeps its global
    index).
    Every output, t_below, the passes and the counts equal the plain
    version's bit for bit; the kernel counts the passes its particles
    took."""
    import copy
    from flexpart_tpu_torch.core import advance as adv
    from flexpart_tpu_torch.core.state import FIELDS, Particles
    p, zs, cfg, tables, a, key, settle, _, _ = _advance_inputs(card, 1)
    height = zs[0].height
    passes = adv.advance_adaptive_cuda(p, height, tables, copy.copy(a), key,
                                       cfg, None, 0, settle)[1].passes
    idle = torch.nonzero(p.active & (passes == 0)).flatten()
    top = int(torch.argmax(passes))
    pos = min(5, top)
    offset = 0
    if case.startswith("n"):
        idx = torch.arange(int(case[1:]), device=card)
    elif case == "above_h":
        idx = idle[:4096]
    else:
        idx = torch.cat([idle[:pos], torch.tensor([top], device=card),
                         idle[pos:63]])
        offset = top - pos
    q = Particles(**{f: getattr(p, f)[idx] for f in FIELDS})
    pk, dk = adv.advance_adaptive_cuda(q, height, tables, copy.copy(a), key,
                                       cfg, None, offset, settle)
    pp, dp = adv.advance_all_plain(q, height, tables, copy.copy(a), key, cfg,
                                   None, offset, settle)
    torch.cuda.synchronize()
    for f in adv.ADAPTIVE_OUT_FIELDS:
        x, y = getattr(pk, f), getattr(pp, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f
    assert torch.equal(dk.t_below.view(torch.int32),
                       dp.t_below.view(torch.int32))
    assert torch.equal(dk.passes, dp.passes)
    assert int(dk.n_active) == int(dp.n_active)
    assert int(dk.n_exited) == int(dp.n_exited)
    # lane_work: passes executed, lane iterations issued, and the CBL's
    # NaN redraws (none without the CBL)
    executed, issued, nans = (int(v) for v in dk.lane_work)
    assert executed == int(dk.passes.sum()) and issued >= executed
    assert nans == 0 == int(dk.nan_count)
    if case == "above_h":
        assert idx.numel() == 4096 and executed == 0
    if case == "one_long_among_idle":
        assert int(dk.passes[pos]) == int(passes[top]) > 0
        assert int(dk.passes.sum()) == int(passes[top])


def test_k11_cbl_equals_the_plain_version(card):
    """K11's CBL instantiation (turbswitch, ifine 11, settling and the polar
    caps) against ``advance_all_plain`` on the card, on _advance_inputs'
    particles with the skewed scheme over the eastern half (hmix 1500 m,
    w* 1.8 m/s, L = -25 m; -1200 m in the west): every output, t_below,
    the passes and nan_count bitwise."""
    import copy
    import dataclasses
    from flexpart_tpu_torch.core import advance as adv
    from flexpart_tpu_torch.core import interp
    from flexpart_tpu_torch.met.fields import F2_HMIX, F2_OLI, F2_WSTAR
    p, zs, cfg, _, _, key, settle, _, grid = _advance_inputs(card, 1)
    conv = []
    for zf in zs:
        f2 = zf.f2d.clone()
        f2[F2_HMIX] = 1500.0
        f2[F2_WSTAR] = 1.8
        f2[F2_OLI] = 1.0 / -1200.0
        f2[F2_OLI][:, grid.nx // 2:] = 1.0 / -25.0
        conv.append(zf.replace(f2d=f2))
    cfg = dataclasses.replace(cfg, cblflag=True, ifine=11)
    prm = adv.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=900, fine=1.0 / 11, ctl=5.0,
        sp_density=[2500.0, -1.0], sp_dquer=[10.0, 0.0],
        sp_cunningham=[1.02, 0.0], sp_vsetaver=[-0.007, 0.0])
    tw = adv._time_weights(900, 0, 10800, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(conv[0], conv[1], *tw,
                                           dtype=cfg.table_dtype)
    a = adv.advance_args(cfg, prm, 900, 0, 10800)
    settle = adv.settle_met(conv[0], cfg)
    pk, dk = adv.advance_adaptive_cuda(p, conv[0].height, tables,
                                       copy.copy(a), key, cfg, None, 0, settle)
    pp, dp = adv.advance_all_plain(p, conv[0].height, tables, copy.copy(a),
                                   key, cfg, None, 0, settle)
    torch.cuda.synchronize()
    for f in adv.ADAPTIVE_OUT_FIELDS:
        x, y = getattr(pk, f), getattr(pp, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f
    assert torch.equal(dk.t_below, dp.t_below)
    assert torch.equal(dk.passes, dp.passes)
    assert int(dk.nan_count) == int(dp.nan_count)
    assert int(dk.lane_work[0]) == int(dk.passes.sum())


def test_k4_nests_equal_the_plain_version(card):
    """K4's NESTS instantiation with two nests of SyntheticMet on the 37 x
    19 x 15 grid's levels (5 degrees over 40 W-60 E, 10-70 N and 2.5
    degrees over 10 W-30 E, 30-60 N) against ``advance_all_plain`` with
    K1's draws injected, and K4 with its draws in registers against the
    same: every output bitwise; more than MAX_NESTS nests raise by name."""
    import copy
    import dataclasses
    from flexpart_tpu_torch.core import advance as adv
    from flexpart_tpu_torch.core import interp, rng
    from flexpart_tpu_torch.met import calcpar, calcpv, synthetic
    from flexpart_tpu_torch.met import verttransform
    from flexpart_tpu_torch.run.simulation import nest_windows
    p, zs, cfg, _, _, key, _, gen, grid = _advance_inputs(card, 0)
    nests = (synthetic.make_grid(nx=21, ny=13, nlev=15, dx=5.0, dy=5.0,
                                 xlon0=-40.0, ylat0=10.0, xglobal=False),
             synthetic.make_grid(nx=17, ny=13, nlev=15, dx=2.5, dy=2.5,
                                 xlon0=-10.0, ylat0=30.0, xglobal=False))
    height = verttransform.compute_heights(
        grid, synthetic.SyntheticMet(grid).fetch(0.0, card))
    zn = []
    # each nest's jet differs from the mother's and from the other nest's,
    # so that a particle sampled from the wrong grid moves differently
    for k, g in enumerate(nests):
        met = synthetic.SyntheticMet(g, u_jet=35.0 + 10.0 * k)
        zn.append([calcpar.calcpar(g, e, verttransform.process_eta(
            g, e, height, pvh=calcpv.calcpv(g, e)))
            for e in (met.fetch(t, card) for t in (0.0, 10800.0))])
    cfg = dataclasses.replace(cfg, settling=False,
                              nests=tuple((g.nx, g.ny) for g in nests))
    prm = adv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                              dxconst=grid.dxconst, dyconst=grid.dyconst,
                              lsynctime=900, fine=1.0,
                              **nest_windows(grid, nests))
    n = p.capacity
    u = torch.rand(n, generator=gen, device=card)
    p = p.replace(x_hi=torch.where(u < 0.6, 14.0 + u * 10.0, p.x_hi),
                  y_hi=torch.where(u < 0.6, 10.5 + u * 7.0, p.y_hi))
    tw = adv._time_weights(900, 0, 10800, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(zs[0], zs[1], *tw,
                                           dtype=cfg.table_dtype)
    tables_n = tuple(interp.build_step_tables_quad(z[0], z[1], *tw,
                                                   dtype=cfg.table_dtype)
                     for z in zn)
    a = adv.advance_args(cfg, prm, 900, 0, 10800)
    assert int((adv.nest_index(cfg, a, p.x, p.y) == 1).sum()) > n // 10
    draws = {t: rng.normals(key, (r, n), t, device=card)
             for t, r in adv.draw_tags(cfg).items()}
    args = (p, zs[0].height, tables)
    runs = [adv.advance_all_cuda(*args, copy.copy(a), key, cfg, d, 0,
                                 tables_n=tables_n) for d in (None, draws)]
    pp, _ = adv.advance_all_plain(*args, copy.copy(a), key, cfg, draws, 0,
                                  tables_n=tables_n)
    torch.cuda.synchronize()
    for pk, _ in runs:
        for f in adv.OUT_FIELDS:
            x, y = getattr(pk, f), getattr(pp, f)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f
    many = dataclasses.replace(cfg, nests=cfg.nests * 3)
    with pytest.raises(ValueError, match="MAX_NESTS"):
        adv.advance_all_cuda(*args, copy.copy(a), key, many, None, 0,
                             tables_n=tables_n * 3)


def test_legacy_draws_on_the_card_are_refused(card):
    """``advance_all`` refuses the legacy-RNG draws on CUDA tensors by name:
    no kernel takes them, and the plain version is not run in their
    place."""
    import dataclasses
    from flexpart_tpu_torch.core import advance as adv
    from flexpart_tpu_torch.core.legacy import LegacyRnd
    p, zs, cfg, _, _, key, _, _, grid = _advance_inputs(card, 0, n=1024)
    cfg = dataclasses.replace(cfg, settling=False)
    prm = adv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                              dxconst=grid.dxconst, dyconst=grid.dyconst,
                              lsynctime=900, fine=1.0)
    ones = torch.ones(p.capacity, dtype=torch.int32, device=card)
    leg = LegacyRnd(table=torch.zeros(101, device=card), nrand_init=ones,
                    nrand=ones)
    with pytest.raises(NotImplementedError, match="legacy"):
        adv.advance_all(p, zs[0], zs[1], 900, 0, 10800, key, cfg, prm,
                        leg=leg)


BACKWARD_CASES = ("redist_backward", "conccalc_bkdep", "conccalc_count",
                  "wetbkdep", "drybkdep", "advance_backward", "wetdepo_clwc",
                  "wetbkdep_clwc")


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_backward_instantiations_equal_their_plain_versions(card, case):
    """The instantiations of a backward run, and K9's cloud-water ones,
    against their plain versions, each launched through its own entry (its
    count goes up by one): K7 BACKWARD (z and the moved count), K9 and K10
    BKDEP (mass and xscav), K9 CLWC (mass and deposit) and K9 BKDEP x CLWC
    on a seeded column cloud water, and the advance at ldirect = -1 with
    injected draws, bitwise; K3 BKDEP and COUNT within K3's rtol 1e-5
    (float atomics)."""
    import dataclasses
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.config import OutGrid, Species
    from flexpart_tpu_torch.core import advance as adv
    from flexpart_tpu_torch.core import rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import (OutputGridGeometry,
                                                 zero_accumulators)
    from flexpart_tpu_torch.physics import bkdep as bk
    from flexpart_tpu_torch.physics import convection as cv
    from flexpart_tpu_torch.physics import wetdepo as wd
    p, zs, cfg, tables, a, key, _, gen, grid = _advance_inputs(card, 0)
    n = p.capacity
    fresh = torch.rand(n, generator=gen, device=card) < 0.5
    p = p.replace(xscav=torch.where(fresh[:, None], -1.0, 0.5)
                  .expand(n, 2).contiguous())

    def same(x, y, what):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), what

    entry = {"redist_backward": _build.REDIST_BACKWARD,
             "conccalc_bkdep": _build.CONCCALC_BKDEP,
             "conccalc_count": _build.CONCCALC_COUNT,
             "wetbkdep": _build.WETDEPO_BKDEP,
             "drybkdep": _build.DRYDEPO_BKDEP,
             "advance_backward": _build.ADVANCE,
             "wetdepo_clwc": _build.WETDEPO_CLWC,
             "wetbkdep_clwc": _build.WETDEPO_BKDEP_CLWC}[case]
    before = entry.launches
    if case == "redist_backward":
        from flexpart_tpu_torch.met import synthetic
        kern = cv.make_convection_kernel(grid)
        eta = ("ps", "tth", "qvh", "tt2", "td2")
        e = synthetic.SyntheticMet(grid).fetch(0.0, card)
        fields = tuple(getattr(e, f) for f in eta) * 2
        conv = cv.convection_cuda(kern, fields, 0.75, 0.25, torch.zeros(
            grid.nx * grid.ny, device=card), 900.0)
        args = (conv.fmassfrac, conv.rlevmass, conv.phconv, conv.sub,
                conv.uvzlev, conv.pconv, conv.tconv, conv.lconv, 900, 0,
                kern.nl, grid.nx, grid.ny)
        qk, mk = cv.redist_cuda(p, key, *args, ldirect=-1)
        qp, mp = cv.redist_plain(p, key, *args, ldirect=-1)
        same(qk.z, qp.z, "z")
        assert int(mk) == int(mp)
    elif case.startswith("conccalc"):
        og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=90,
                     numygrid=45, dxout=4.0, dyout=4.0,
                     outheights=(500.0, 2000.0, 50000.0))
        geo = OutputGridGeometry(og, grid)
        flag = "bkdep" if case.endswith("bkdep") else "particle_count_output"
        ccfg = cc.ConcConfig(
            nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg, npointspec=1,
            nclassunc=1, nage=1, dxout=og.dxout, dyout=og.dyout,
            xoutshift=geo.xoutshift, youtshift=geo.youtshift,
            dx_met=grid.dx, dy_met=grid.dy, ind_samp=0, **{flag: True})
        lage = torch.tensor([999999999], dtype=torch.int32, device=card)
        oh = torch.tensor(og.outheights, device=card)
        for kp in (False, True):
            gk = zero_accumulators(geo, 2, 1, device=card).gridunc
            gp = torch.zeros_like(gk)
            args = (p, 0, lage, oh, 1.0, None,
                    ccfg.replace(kernel_possible=kp))
            cc.conccalc_cuda(gk.view(-1, 2), *args)
            cc.conccalc_plain(gp.view(-1, 2), *args)
            torch.cuda.synchronize()
            assert float(gp.sum()) > 0.0
            assert bool(torch.all((gk - gp).abs() <= 1e-5 * gp.abs()))
        before += 1                     # two launches
    elif case in ("wetbkdep", "wetbkdep_clwc", "wetdepo_clwc"):
        from flexpart_tpu_torch.met.fields import F2_CTWC
        from flexpart_tpu_torch.physics import massupdate as mu
        wet = tuple(wd.WetSpecies.from_species(s) for s in (
            Species(crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                    in_aero=0.1, dquer=0.4),
            Species(weta_gas=1e-4, wetb_gas=0.62, henry=1.0e5)))
        clwc = case.endswith("clwc")
        zf = zs[0]
        if clwc:
            f2d = zf.f2d.clone()
            f2d[F2_CTWC] = torch.rand(f2d[F2_CTWC].shape, generator=gen,
                                      device=card) * 2.0
            zf = zf.replace(f2d=f2d)
        if case == "wetdepo_clwc":
            msp = mu.MassSpecies(decay=(1e-6, 0.0), drydep=(False, False))
            k, dk = wd.wetdepo_cuda(p, zf, 900, 2700, wet, msp, True)
            q, dq = mu.apply_wetdepo_plain(
                p, *wd.wetscav_all_plain(p, zf, wet, True), 900, 2700, msp)
            same(dk, dq, "deposit")
        else:
            k = bk.assign_wetbkdep_cuda(p, zf, wet, use_clwc=clwc)
            q = bk.assign_wetbkdep_plain(p, zf, wet, use_clwc=clwc)
            same(k.xscav, q.xscav, "xscav")
            assert bool((k.xscav[fresh & p.active] >= 0).all())
        same(k.mass, q.mass, "mass")
    elif case == "drybkdep":
        vdep = torch.rand((2, grid.ny, grid.nx), generator=gen,
                          device=card) * 0.022 - 0.002
        k = bk.assign_drybkdep_cuda(p, vdep)
        q = bk.assign_drybkdep_plain(p, vdep)
        same(k.mass, q.mass, "mass")
        same(k.xscav, q.xscav, "xscav")
    else:
        back = dataclasses.replace(cfg, settling=False, ldirect=-1)
        prm = adv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                                  dxconst=grid.dxconst, dyconst=grid.dyconst,
                                  lsynctime=900, fine=1.0)
        ab = adv.advance_args(back, prm, -900, -3600, 0)
        assert ab.ldirf == -1.0
        q = p.replace(itra=torch.full_like(p.itra, -900))
        draws = {t: rng.normals(key, (r, n), t, device=card)
                 for t, r in {**adv.DRAW_ROWS, 2: 1}.items()}
        (pk, _), (pp, _) = (
            adv.advance_all_cuda(q, zs[0].height, tables, ab, key, back,
                                 draws, 0),
            adv.advance_all_plain(q, zs[0].height, tables, ab, key, back,
                                  draws, 0))
        for f in adv.OUT_FIELDS:
            same(getattr(pk, f), getattr(pp, f), f)
    assert entry.launches == before + 1


def _chip_smoke():
    """chip_smoke.py, beside tests/: its K13 and K14 cases."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    return chip_smoke


EDGE_SIZES = (1, 31, 33, 4095, 4097, 2 ** 20 + 1)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_k13_edge_cases_equal_the_plain_version(card, n):
    """K13 at sizes around a warp, a 4096 tile and the origin bitmaps'
    131,072-flag scan tile: half live and half of them due, through the
    identity and a shuffled origin; no free slot; none due.  Every field
    and the counts bitwise (chip_smoke.held_split)."""
    cs = _chip_smoke()
    seen = 0
    for name, p, origin in cs.split_edge_inputs(card):
        if name.startswith(f"n{n}_"):
            counts = cs.held_split(p, origin, f"K13 {name}")[1]
            if name.endswith(("no_free", "none_due")):
                assert counts[2] == 0, (name, counts)
            seen += 1
    torch.cuda.synchronize()
    assert seen == 4


@pytest.fixture(scope="module")
def boundcond_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K14 has no CPU mode")
    cs = _chip_smoke()
    from flexpart_tpu_torch.met.synthetic import make_grid
    device = torch.device("cuda")
    return cs.boundcond_inputs(device, make_grid(**cs.BENCH_GRID))


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_k14_edge_cases_equal_the_plain_version(card, boundcond_case, n):
    """K14 at the sizes of K13's edge cases, slots drawn from
    chip_smoke.py's boundary case (its 694,479 sites): through the identity
    and a shuffled origin; every slot live inside the window (no free
    slot); an empty accumulator (no wish); no site, half the slots live
    outside the window (the kill alone).  Every field, the accumulator
    and the counts bitwise (chip_smoke.held_boundcond)."""
    cs = _chip_smoke()
    p, _, bs, step = boundcond_case
    _, xlo, xhi, ylo, yhi = bs.limits()
    seen = 0
    for name, q, origin, b in cs.boundcond_edge_inputs(
            p, bs, (xlo, xhi, ylo, yhi), card):
        if name.startswith(f"n{n}_"):
            counts = cs.held_boundcond(q, b, step, 1, origin,
                                       f"K14 {name}")[1]
            if name.endswith(("no_free", "no_wish", "no_site")):
                assert counts[3] == 0, (name, counts)
            if name.endswith("no_site"):
                assert counts[0] >= (n + 1) // 2, (name, counts)
            seen += 1
    torch.cuda.synchronize()
    assert seen == 5


K1516_EDGE_SIZES = (1, 31, 33, 2 ** 20 + 1)


@pytest.fixture(scope="module")
def receptor_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K15 has no CPU mode")
    cs = _chip_smoke()
    from flexpart_tpu_torch.met.synthetic import make_grid
    device = torch.device("cuda")
    grid = make_grid(**cs.BENCH_GRID)
    fill = next(cs.receptor_inputs(device, grid))[1]
    return fill, cs.df_receptors(grid, device), grid


@pytest.mark.parametrize("n", K1516_EDGE_SIZES)
def test_k15_edge_cases_equal_the_plain_version(card, receptor_case, n):
    """K15 on slots drawn from chip_smoke.py's fill case (its 32
    receptors): as drawn; no live particle (every sum +0); every particle
    on the edge of its receptor's kernel (|x - rx| at hx, |z| = hz) or a
    float inside it.  Bitwise (chip_smoke.held_receptors)."""
    cs = _chip_smoke()
    p, rec, grid = receptor_case
    seen = 0
    for name, q in cs.receptor_edge_inputs(p, rec, cs.K15_ITIME, grid.dx,
                                           grid.dy, card):
        if name.startswith(f"n{n}_"):
            c0 = torch.zeros((rec.x.shape[0], q.nspec), device=card)
            k = cs.held_receptors(c0, rec, q, cs.K15_ITIME, grid.dx,
                                  grid.dy, f"K15 {name}")
            if name.endswith("no_live"):
                assert not bool(k.any()), name
            seen += 1
    torch.cuda.synchronize()
    assert seen == 3


@pytest.fixture(scope="module")
def flux_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K16 has no CPU mode")
    cs = _chip_smoke()
    from flexpart_tpu_torch.met.synthetic import make_grid
    return cs.flux_inputs(torch.device("cuda"), make_grid(**cs.BENCH_GRID))


@pytest.mark.parametrize("n", K1516_EDGE_SIZES)
def test_k16_edge_cases_hold_k8s_rule(card, flux_case, n):
    """K16 on slots drawn from chip_smoke.py's flux case: as drawn, and
    with no live particle (nothing added).  Against the float64 sum of the
    pairs by K8's rule, as its plain version (chip_smoke.held_fluxes)."""
    cs = _chip_smoke()
    seen = 0
    for name, a in cs.flux_edge_inputs(flux_case, card):
        if name.startswith(f"n{n}_"):
            r = cs.held_fluxes(a, f"K16 {name}")[0]
            if name.endswith("no_live"):
                assert r["pairs"] == 0, name
            seen += 1
    torch.cuda.synchronize()
    assert seen == 2

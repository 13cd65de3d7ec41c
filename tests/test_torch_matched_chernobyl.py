"""The matched-RNG 48-h Chernobyl-style run through the port.

The mirror of ``tests/test_matched_chernobyl.py`` for ``flexpart_tpu_torch``:
CTL=5 adaptive stepping, ifine 4, turbswitch, wet and dry deposition and
decay of an aerosol, 36 particles released in the reference's ran1 order
(``validation/depo_oracle.legacy_release``), the port's legacy-RNG advance
(``core/legacy.py``), its plain wet-scavenging chain and mass update
against the copied scalar oracles (``flexpart_tpu_torch/validation``) under
one rannumb table and ran3 chain; the final gridded concentrations through
the port's own ``grid/conccalc.py``.  Sizes, steps and tolerances are the
JAX test's: per-particle masses within rtol 5e-3 for 90% (80% in the
second day) of the particles at four checkpoints and the ensemble mass
within 2%, the deposition removing more than 30% over the 48 h, the
gridded concentrations within 5% relative L1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu_torch.config import OutGrid  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.advance import (StepConfig, StepParams,  # noqa: E402
                                             advance_all)
from flexpart_tpu_torch.core.legacy import LegacyRnd  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.grid.conccalc import ConcConfig, make_conccalc  # noqa: E402
from flexpart_tpu_torch.grid.outgrid import (OutputGridGeometry,  # noqa: E402
                                             zero_accumulators)
from flexpart_tpu_torch.met import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.met.calcpar import calcpar  # noqa: E402
from flexpart_tpu_torch.met.verttransform import (compute_heights,  # noqa: E402
                                                  process_eta)
from flexpart_tpu_torch.physics.massupdate import (MassSpecies,  # noqa: E402
                                                   apply_decay_drydep_plain,
                                                   apply_wetdepo_plain)
from flexpart_tpu_torch.physics.wetdepo import (WetSpecies,  # noqa: E402
                                                wetscav_all_plain)
from flexpart_tpu_torch.validation.depo_oracle import (  # noqa: E402
    legacy_release, oracle_drydecay_mass, oracle_wetdepo_mass,
    oracle_wetscav)
from flexpart_tpu_torch.validation.legacy_rng import (MAXRAND,  # noqa: E402
                                                      NrandStream,
                                                      make_rannumb)
from flexpart_tpu_torch.validation.oracle import (OracleParams,  # noqa: E402
                                                  run_oracle)

SEED = -7
LSYNC = 900
WIND_IV = 10800                  # 3-h met interval
HOURS = 48
NSTEPS = HOURS * 3600 // LSYNC   # 192
N = 36
DRYVEL = 0.008                   # prescribed vdep [m/s]
DECAY = 0.693147 / (3.0 * 86400.0)   # 3-day half-life: visible decay


class _NpZ:
    def __init__(self, zf):
        self.f3d = zf.f3d.numpy()
        self.f2d = zf.f2d.numpy()
        self.clouds = zf.clouds.numpy()
        self.height = zf.height.numpy()


@pytest.fixture(scope="module")
def setup48():
    # global-in-x grid over the synthetic storm band (|lat|~50)
    grid = make_grid(nx=61, ny=31, nlev=20, dx=6.0, dy=1.0,
                     xlon0=-180.0, ylat0=35.0, xglobal=True)
    met = SyntheticMet(grid)
    height = compute_heights(grid, met.fetch(0.0, "cpu"))
    fields = []
    for k in range(HOURS * 3600 // WIND_IV + 1):
        eta = met.fetch(float(k * WIND_IV), "cpu")
        z = process_eta(grid, eta, height)
        fields.append(calcpar(grid, eta, z))
    return grid, fields, height


SP = dict(is_aerosol=True, dquer=0.4, crain_aero=1.0, csnow_aero=1.0,
          ccn_aero=0.9, in_aero=0.1, weta_gas=-9.9e-10, wetb_gas=-9.9,
          henry=-9.9e-10)


def _wet_species():
    return (WetSpecies(wetdep=True, is_aerosol=True, weta_gas=-9.9e-10,
                       wetb_gas=-9.9, crain_aero=1.0, csnow_aero=1.0,
                       ccn_aero=0.9, in_aero=0.1, henry=-9.9e-10,
                       dquer=0.4),)


def test_matched_chernobyl_48h(setup48):
    grid, fields, height = setup48
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                     xglobal=True, ldirect=1, turbswitch=True,
                     ifine=4, method=1)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=0.25, ctl=5.0,
                          lwindinterv=WIND_IV)
    oprm = OracleParams(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                        xglobal=True, ldirect=1, turbswitch=True,
                        ifine=4, lsynctime=LSYNC, lwindinterv=WIND_IV,
                        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                        dxconst=float(grid.dxconst),
                        dyconst=float(grid.dyconst),
                        method=1, ctl=5.0, vdep=DRYVEL)

    # release through the reference's ran1 draw order
    box = dict(lon1=-30.0, lon2=-20.0, lat1=48.0, lat2=52.0,
               z1=20.0, z2=1500.0)
    x0, y0, nclass0, zrel = legacy_release(
        box, N, nclassunc=1, xlon0=grid.xlon0, ylat0=grid.ylat0,
        dx=grid.dx, dy=grid.dy, seed=SEED)

    # ---------------- the port's side ----------------
    p = empty_particles(N, device="cpu")
    p = p.replace(x_hi=torch.tensor(x0, dtype=torch.float32),
                  y_hi=torch.tensor(y0, dtype=torch.float32),
                  z=torch.from_numpy(np.asarray(zrel, np.float32)),
                  itra=torch.zeros(N, dtype=torch.int32),
                  itramem=torch.full((N,), -1, dtype=torch.int32),
                  mass=torch.ones((N, 1)), mass0=torch.ones((N, 1)),
                  active=torch.ones(N, dtype=torch.bool))
    table = torch.from_numpy(make_rannumb(MAXRAND, SEED))
    stream = NrandStream(SEED, MAXRAND)
    key = trng.Key(0, 0)
    msp = MassSpecies(decay=(DECAY,), drydep=(True,), minmass=1e-4)
    wsp = _wet_species()
    vdep_field = torch.full((1, grid.ny, grid.nx), DRYVEL)
    mass_k_steps = []
    for k in range(NSTEPS):
        itime = k * LSYNC
        iv = itime // WIND_IV
        mt0, mt1 = iv * WIND_IV, (iv + 1) * WIND_IV
        zA, zB = fields[iv], fields[iv + 1]
        # wet deposition over the interval ENDING at itime
        # (timemanager.f90:164-169)
        if k > 0:
            interp_t = itime - LSYNC // 2
            ivw = interp_t // WIND_IV
            use0 = abs(ivw * WIND_IV - interp_t) \
                < abs((ivw + 1) * WIND_IV - interp_t)
            zw = fields[ivw] if use0 else fields[ivw + 1]
            lam, grfrac = wetscav_all_plain(p, zw, wsp, False)
            p, _wdep = apply_wetdepo_plain(p, lam, grfrac, LSYNC, 0, msp)
        active = p.active.numpy()
        ni = np.ones(N, np.int64)
        na = np.ones(N, np.int64)
        for j in range(N):
            if not active[j]:
                continue
            if k == 0:
                ni[j] = stream.next_nrand()
            na[j] = stream.next_nrand()
        leg = LegacyRnd(table=table, nrand_init=torch.from_numpy(ni),
                        nrand=torch.from_numpy(na))
        p, diag = advance_all(p, zA, zB, itime, mt0, mt1, key, cfg, prm,
                              leg=leg)
        # decay + dry deposition with the adaptive step's t_below window
        p, _ddep = apply_decay_drydep_plain(p, vdep_field, LSYNC, 0, msp,
                                            True, diag.t_below)
        mass_k_steps.append(p.mass[:, 0].numpy().copy())
    assert bool(p.active.all()), "the port lost particles"
    # ---------------- oracle side ----------------
    parts = [dict(xt=np.float64(x0[j]), yt=np.float64(y0[j]),
                  zt=np.float32(zrel[j]), mass=np.float32(1.0))
             for j in range(N)]
    stream_o = NrandStream(SEED, MAXRAND)
    states = [dict(s) for s in parts]
    nstops = [0] * N
    mass_o_steps = []
    trace_o = []
    for k in range(NSTEPS):
        itime = k * LSYNC
        iv = itime // WIND_IV
        mt0, mt1 = iv * WIND_IV, (iv + 1) * WIND_IV
        zA, zB = _NpZ(fields[iv]), _NpZ(fields[iv + 1])
        if k > 0:
            interp_t = itime - LSYNC // 2
            ivw = interp_t // WIND_IV
            use0 = abs(ivw * WIND_IV - interp_t) \
                < abs((ivw + 1) * WIND_IV - interp_t)
            zw = _NpZ(fields[ivw] if use0 else fields[ivw + 1])
            for j, s in enumerate(states):
                if nstops[j]:
                    continue
                lam, grf = oracle_wetscav(zw, float(s["xt"]),
                                          float(s["yt"]),
                                          float(s["zt"]), SP)
                s["mass"], _dep = oracle_wetdepo_mass(
                    s["mass"], lam, grf, LSYNC, 0, DECAY)
        # one advance step for all particles (shares run_oracle's
        # per-step ordering)
        states, nstops, tr = run_oracle(
            oprm, zA, zB, (mt0, mt1), states, 1, itime0=itime,
            seed=SEED, stream=stream_o, nstops=nstops,
            do_init=(k == 0))
        trace_o.append(np.asarray(tr[0], np.float64))
        for j, s in enumerate(states):
            if nstops[j]:
                continue
            s["mass"], _dd = oracle_drydecay_mass(
                s["mass"], s.get("prob", 0.0), LSYNC, 0, DECAY, True)
        mass_o_steps.append(np.asarray([s["mass"] for s in states]))
    assert all(s == 0 for s in nstops), "oracle lost particles"

    # ---------------- per-step mass comparison ----------------
    # matched streams keep trajectories within f32 roundoff; a particle
    # within roundoff of a DISCRETE branch boundary (the cell-based
    # cloud classification of get_wetscav, the ldt truncation, the z>h
    # exit) can flip it and diverge individually — so require near-all
    # particles to match tightly AND the ensemble mass to agree closely
    for k in (0, NSTEPS // 4, NSTEPS // 2, NSTEPS - 1):
        mk, mo = mass_k_steps[k], mass_o_steps[k]
        close = np.isclose(mk, mo, rtol=5e-3, atol=1e-7)
        # individual flips accumulate ~linearly with steps; a systematic
        # mass-path bug flips everything at once
        min_frac = 0.9 if k < NSTEPS // 2 else 0.8
        assert close.mean() >= min_frac, \
            f"step {k}: only {close.sum()}/{N} particle masses match"
        assert abs(mk.sum() - mo.sum()) <= 0.02 * mo.sum(), \
            f"step {k}: ensemble mass drift {mk.sum()} vs {mo.sum()}"
    # deposition must actually remove mass over the 48 h
    assert mass_k_steps[-1].sum() < 0.7 * N, \
        "deposition/decay did not act — test not exercising the mass path"

    # ------- gridded concentrations through the REAL conccalc kernel ----
    og = OutGrid(outlon0=-180.0, outlat0=35.0, numxgrid=90, numygrid=15,
                 dxout=4.0, dyout=2.0, outheights=(500.0, 2000.0, 20000.0))
    geo = OutputGridGeometry(og, grid)
    ccfg = ConcConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg,
                      npointspec=1, nclassunc=1, nage=1,
                      dxout=og.dxout, dyout=og.dyout,
                      xoutshift=geo.xoutshift, youtshift=geo.youtshift,
                      dx_met=grid.dx, dy_met=grid.dy, ind_samp=0)
    conccalc = make_conccalc(og.outheights)
    lage = torch.tensor([999999999], dtype=torch.int32)
    zlast = fields[-1]
    final_itime = NSTEPS * LSYNC

    def gridded(xs, ys, zs, masses):
        po = empty_particles(N, device="cpu")
        po = po.replace(
            x_hi=torch.tensor(np.asarray(xs), dtype=torch.float32),
            y_hi=torch.tensor(np.asarray(ys), dtype=torch.float32),
            z=torch.tensor(np.asarray(zs), dtype=torch.float32),
            itra=torch.full((N,), final_itime, dtype=torch.int32),
            itramem=torch.full((N,), -1, dtype=torch.int32),
            mass=torch.tensor(np.asarray(masses), dtype=torch.float32)[:, None],
            active=torch.ones(N, dtype=torch.bool))
        acc = zero_accumulators(geo, 1, 1, 1, 1, device="cpu")
        acc = conccalc(acc, po, zlast, final_itime, lage, 1.0, ccfg)
        return acc.gridunc.numpy()

    gk = gridded(p.x.numpy(), p.y.numpy(), p.z.numpy(), mass_k_steps[-1])
    go = gridded(trace_o[-1][:, 0], trace_o[-1][:, 1],
                 trace_o[-1][:, 2], mass_o_steps[-1])
    # matched streams keep trajectories within f32 roundoff of each
    # other; a particle within roundoff of a kernel-cell edge can land
    # one cell over, so compare as a relative L1 discrepancy
    l1 = np.abs(gk - go).sum() / max(go.sum(), 1e-12)
    assert l1 < 0.05, f"gridded concentration L1 mismatch {l1}"
    assert go.sum() > 0

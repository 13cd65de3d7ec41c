"""The particle advance: one lsynctime update for all particles.

Port of ``flexpart_tpu/core/advance.py`` in fixed-step mode (CTL<0,
``method=0``): quad-table met sampling, Hanna/Langevin PBL turbulence with
the exact OU discretization (turbswitch on and off, any ``ifine``, no
CBL), constant-diffusivity free troposphere / stratosphere, mesoscale
fluctuations, windalign, the double-single position update, the
polar-stereographic update inside the polar caps, cyclic and pole
boundary conditions and the Petterssen corrector.  Options outside this
slice (adaptive stepping, CBL, nests, tile mode, settling, turboff, the
legacy-RNG path) raise ``NotImplementedError``.

Two versions of the same function: ``advance_all_plain``, plain PyTorch
ops, runs for CPU tensors; ``advance_all_cuda`` launches kernel K4
(``csrc/advance.cu``), one thread per particle and one launch for all
particles, for CUDA tensors.  ``advance_all`` picks by the device of the
particles and never falls from one to the other.

Scalars (time weights, the interval, grid constants) are float32 values
computed with numpy ``float32`` arithmetic on the host and held in Python
floats, so the tensor ops see exactly the operands XLA sees;
``advance_args`` packs them into the struct both versions read.

Draws: every draw site takes its numbers either from ``draws`` (a dict
keyed by the JAX tags 6, 1, 2, 3, 4 with the JAX shapes), which the
parity tests fill with JAX's own draws, or from the Philox stream keyed by
(seed, step, tag) with the global particle index as counter.  On the CPU
that stream comes from ``rng.normals`` as tensors; on a CUDA device K4
makes the same numbers in registers at the draw sites (the device functions
of ``csrc/philox_normal.cuh`` that K1 is built from: four rows of a tag
from one Philox call, two from one Box-Muller radius), so they never touch
device memory, and a thread draws only what its branch consumes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..constants import D_STRAT, D_TROP, PI, PI180, R_EARTH, TURBMESOSCALE
from ..met.fields import ZFields
from . import rng
from .hanna import hanna, hanna1
from .interp import (ROWS_E_LANES, ROWS_LANES, StepTablesQuad,
                     build_step_tables_quad, horiz_weights,
                     interp_wind_short_quad, sample_all_quad, true_div,
                     vert_weights)
from .state import Particles, ds_add

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of the advance (the JAX fields; only the
    fixed-step values of this slice are accepted, see ``check``)."""
    nx: int
    ny: int
    nz: int
    xglobal: bool
    ldirect: int
    turbswitch: bool
    ifine: int
    method: int
    turboff: bool = False
    settling: bool = False
    cblflag: bool = False
    nests: tuple = ()
    polar: bool = False
    tile_mode: bool = False
    met_bf16: bool = True

    def check(self) -> None:
        unsupported = {
            "method=1 (adaptive stepping)": self.method != 0,
            "cblflag (skewed CBL)": self.cblflag,
            "nests": bool(self.nests),
            "tile_mode": self.tile_mode,
            "settling": self.settling,
            "turboff": self.turboff,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                "not ported yet (outside the fixed-step slice): "
                + ", ".join(bad))
        if self.ifine < 1:
            raise ValueError("ifine must be >= 1")

    @property
    def table_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.met_bf16 else torch.float32


@dataclasses.dataclass(frozen=True)
class StepParams:
    """Run scalars of the advance, float32 values in Python floats."""
    dx: float
    dy: float
    ylat0: float
    dxconst: float
    dyconst: float
    lsynctime: float      # positive interval length [s]
    fine: float           # 1/ifine
    lwindinterv: float
    xlon0: float = -180.0  # grid lon origin (the polar-cap projection;
    #                        the JAX package's xlon0_pol)

    @classmethod
    def make(cls, dx, dy, ylat0, dxconst, dyconst, lsynctime, fine,
             lwindinterv=3600, xlon0=-180.0) -> "StepParams":
        def v(x):
            return float(f32(x))
        return cls(v(dx), v(dy), v(ylat0), v(dxconst), v(dyconst),
                   v(abs(lsynctime)), v(fine), v(lwindinterv), v(xlon0))


@dataclasses.dataclass
class StepDiag:
    n_active: torch.Tensor    # () int32
    n_exited: torch.Tensor
    nan_count: torch.Tensor


DRAW_ROWS = {6: 6, 1: 2, 3: 3, 4: 3}     # tag 2 has ifine rows
DRAW_TAGS = (6, 1, 2, 3, 4)               # K4's draw sites, in this order
# the particle fields the advance rewrites (K4's outputs, in its order)
OUT_FIELDS = ("x_hi", "x_lo", "y_hi", "y_lo", "z", "itra", "up", "vp", "wp",
              "usig", "vsig", "wsig", "cbt", "active")
_IN_FIELDS = ("x_hi", "x_lo", "y_hi", "y_lo", "z", "itra", "itramem", "up",
              "vp", "wp", "usig", "vsig", "wsig", "cbt", "active")


class AdvanceArgs(ctypes.Structure):
    """Run scalars of one advance, the ``AdvanceArgs`` struct of
    ``csrc/advance.cu`` field for field.  Floats are float32 values
    computed on the host; made by ``advance_args``."""
    _fields_ = [
        ("offset", ctypes.c_longlong),
        ("n", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("xglobal", ctypes.c_int),
        ("turbswitch", ctypes.c_int),
        ("ifine", ctypes.c_int),
        ("table_bf16", ctypes.c_int),
        ("polar", ctypes.c_int),
        ("can_pett", ctypes.c_int),
        ("itime", ctypes.c_int),
        ("itra_new", ctypes.c_int),
        ("key", ctypes.c_uint32 * 10),
        ("dt", ctypes.c_float),
        ("dtf", ctypes.c_float),
        ("ldirf", ctypes.c_float),
        ("htop_eps", ctypes.c_float),
        ("c_trop", ctypes.c_float),
        ("c_strat", ctypes.c_float),
        ("uxscale_t", ctypes.c_float),
        ("wpscale_s", ctypes.c_float),
        ("d_strat_1000", ctypes.c_float),
        ("r_meso", ctypes.c_float),
        ("rs_meso", ctypes.c_float),
        ("turbmeso", ctypes.c_float),
        ("pi180", ctypes.c_float),
        ("dx", ctypes.c_float),
        ("dy", ctypes.c_float),
        ("ylat0", ctypes.c_float),
        ("xlon0", ctypes.c_float),
        ("dxconst", ctypes.c_float),
        ("dyconst", ctypes.c_float),
        ("nxm", ctypes.c_float),
        ("nym", ctypes.c_float),
        ("two_nym", ctypes.c_float),
        ("eps_bc", ctypes.c_float),
        ("nxm_eps", ctypes.c_float),
    ]


def _time_weights(itime: int, memtime0: int, memtime1: int,
                  prm: StepParams, cfg: StepConfig):
    """(tw0, tw1, ew0, ew1, endtime): the interval-start and Petterssen
    end-time weights, in float32 as advance.f90:1278-1287 computes them."""
    dt1 = f32(itime - memtime0)
    dt2 = f32(memtime1 - itime)
    dtt = f32(1.0) / (dt1 + dt2)
    endtime = itime + int(prm.lsynctime) * cfg.ldirect
    edt1 = f32(endtime - memtime0)
    edt2 = f32(memtime1 - endtime)
    edtt = f32(1.0) / max(edt1 + edt2, f32(1e-6))
    return (float(dt2 * dtt), float(dt1 * dtt), float(edt2 * edtt),
            float(edt1 * edtt), endtime)


def advance_args(cfg: StepConfig, prm: StepParams, itime: int, memtime0: int,
                 memtime1: int) -> AdvanceArgs:
    """The run scalars of one advance, each rounded to float32 once, on
    the host, from the double or float32 expression the reference uses;
    both versions of the advance read them from here.  ``n``, ``offset``
    and ``key`` are left 0 for the launcher to fill."""
    dt = f32(prm.lsynctime)
    endtime = _time_weights(itime, memtime0, memtime1, prm, cfg)[4]
    c_trop = f32(2.0 * D_TROP) / dt
    c_strat = f32(2.0 * D_STRAT) / dt
    r = f32(np.exp(f32(-2.0) * dt / f32(prm.lwindinterv)))
    eps = f32(cfg.nx / 3.0e5)
    nxm = float(cfg.nx - 1)
    nym = float(cfg.ny - 1)
    return AdvanceArgs(
        nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, xglobal=int(cfg.xglobal),
        turbswitch=int(cfg.turbswitch), ifine=cfg.ifine,
        table_bf16=int(cfg.met_bf16), polar=int(cfg.polar),
        can_pett=int(abs(endtime) <= abs(memtime1)),
        itime=itime, itra_new=endtime,
        dt=float(dt), dtf=float(dt * f32(prm.fine)), ldirf=float(cfg.ldirect),
        htop_eps=float(f32(100.0 * cfg.nx / 3.0e5)),
        c_trop=float(c_trop), c_strat=float(c_strat),
        uxscale_t=float(np.sqrt(c_trop)), wpscale_s=float(np.sqrt(c_strat)),
        d_strat_1000=float(f32(D_STRAT / 1000.0)),
        r_meso=float(r), rs_meso=float(np.sqrt(f32(1.0) - r * r)),
        turbmeso=float(f32(TURBMESOSCALE)), pi180=float(f32(PI180)),
        dx=prm.dx, dy=prm.dy, ylat0=prm.ylat0, xlon0=prm.xlon0,
        dxconst=prm.dxconst,
        dyconst=prm.dyconst, nxm=nxm, nym=nym, two_nym=2.0 * nym,
        eps_bc=float(eps), nxm_eps=float(f32(nxm) - eps))


def _scalar_div(a: float, b: torch.Tensor) -> torch.Tensor:
    """a / b rounded once.  torch computes ``scalar / tensor`` as
    ``reciprocal(tensor) * scalar`` (two roundings); the reference and K4
    divide."""
    return torch.full_like(b, a) / b


def _ou_update(vel, rnd, sig, dt_over_tl):
    """Exact/linearized OU velocity update with the 0.5 switch
    (advance.f90:371-384)."""
    lin = (1.0 - dt_over_tl) * vel + rnd * sig * torch.sqrt(2.0 * dt_over_tl)
    r = torch.exp(-dt_over_tl)
    exact = r * vel + rnd * sig * torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    return torch.where(dt_over_tl < 0.5, lin, exact)


def _reflect_pbl(z, delz, h):
    """Ground/hmix reflection and forbidden-state flag
    (advance.f90:476-491); ``jnp.fmod`` is ``torch.fmod``."""
    delz = torch.where(torch.abs(delz) > h, torch.fmod(delz, h), delz)
    below = delz < -z
    above = delz > (h - z)
    znew = torch.where(below, -z - delz,
                       torch.where(above, -z - delz + 2.0 * h, z + delz))
    icbt = torch.where(below | above, -1, 1).to(torch.int8)
    return znew, icbt


def _pbl_vertical(cfg: StepConfig, z, wp, icbt, h, ust, wst, ol, rho, drhodz,
                  rnd_w, dtf: float):
    """The ifine vertical Langevin substeps (advance.f90:396-498), without
    CBL.  ``dtftlw`` and everything derived from it is computed once from
    the interval-start turbulence, as the reference does.
    Returns (z, wp, icbt)."""
    turb_fn = hanna if cfg.turbswitch else hanna1
    rhoaux = drhodz / rho
    turb = turb_fn(z, h, ust, wst, ol)
    dtftlw = _scalar_div(dtf, turb.tlw)
    rw = torch.exp(-dtftlw)
    rnd_exact = torch.sqrt(torch.clamp(1.0 - rw * rw, min=0.0))
    rnd_lin = torch.sqrt(2.0 * dtftlw)
    use_lin = dtftlw < 0.5
    for i in range(cfg.ifine):
        icbtf = icbt.to(torch.float32)
        if cfg.turbswitch:
            lin = ((1.0 - dtftlw) * wp + rnd_w[i] * rnd_lin
                   + dtf * (turb.dsigwdz + rhoaux * turb.sigw))
            exact = (rw * wp + rnd_w[i] * rnd_exact
                     + turb.tlw * (1.0 - rw) * (turb.dsigwdz + rhoaux * turb.sigw))
            wp_new = torch.where(use_lin, lin, exact) * icbtf
            delz = wp_new * turb.sigw * dtf
        else:
            wp_new = (rw * wp
                      + rnd_w[i] * rnd_exact * turb.sigw
                      + turb.tlw * (1.0 - rw)
                      * (turb.dsigw2dz + rhoaux * turb.sigw ** 2)) * icbtf
            delz = wp_new * dtf
        z, icbt = _reflect_pbl(z, delz, h)
        wp = wp_new
        if i != cfg.ifine - 1:
            turb = turb_fn(z, h, ust, wst, ol)   # hanna_short refresh
    return z, wp, icbt


def _apply_bcs(cfg: StepConfig, a: AdvanceArgs, x_hi, x_lo, y_hi, y_lo):
    """Cyclic longitude + pole mirroring for global grids; exit detection
    (advance.f90:784-808).  ``jnp.mod`` is ``torch.remainder``."""
    x = x_hi + x_lo
    y = y_hi + y_lo
    nxm, nym, eps = a.nxm, a.nym, a.eps_bc
    if cfg.xglobal:
        xw = torch.where(x >= nxm, x - nxm, x)
        xw = torch.where(x < 0.0, x + nxm, xw)
        xw = torch.where(xw <= eps, torch.full_like(xw, eps), xw)
        xw = torch.where(torch.abs(xw - nxm) <= eps,
                         torch.full_like(xw, a.nxm_eps), xw)
        crossed_s = y < 0.0
        crossed_n = y > nym
        xw = torch.where(crossed_s | crossed_n,
                         true_div(torch.remainder(xw * a.dx + 180.0, 360.0),
                                  a.dx),
                         xw)
        yw = torch.where(crossed_s, -y, y)
        yw = torch.where(crossed_n, a.two_nym - yw, yw)
        x_changed = xw != x
        y_changed = yw != y
        zero = torch.zeros_like(x_lo)
        x_hi = torch.where(x_changed, xw, x_hi)
        x_lo = torch.where(x_changed, zero, x_lo)
        y_hi = torch.where(y_changed, yw, y_hi)
        y_lo = torch.where(y_changed, zero, y_lo)
        exited = (xw < 0.0) | (xw >= nxm) | (yw < 0.0) | (yw > nym)
        return x_hi, x_lo, y_hi, y_lo, exited
    exited = (x < 0.0) | (x >= nxm) | (y < 0.0) | (y > nym)
    return x_hi, x_lo, y_hi, y_lo, exited


SWITCHNORTH = 75.0       # polar-cap latitude thresholds (par_mod.f90:123)
SWITCHSOUTH = -75.0


def _polar_update(a: AdvanceArgs, x, y, dxsave, dysave):
    """Polar-stereographic position update for particles poleward of
    +-75 deg (advance.f90:754-778; the JAX package's ``_polar_update``
    outside tiles mode): the geographic (east, north) displacement
    ``dxsave, dysave`` [m] is rotated into the plane of the tangent polar
    stereographic map at the particle's longitude, scaled by the map
    factor m = sec^2((90-|lat|)/2), applied in plane coordinates rho =
    2R tan((90-|lat|)/2) and mapped back.  Returns (x_new, y_new,
    north_mask, south_mask) in grid units; both caps are computed for
    every particle and the caller selects (K4 computes a particle's own
    cap only).  The six transcendentals are torch's sin, cos, tan, hypot,
    atan and atan2, which K4 calls as sinf, cosf, tanf, hypotf, atanf
    and atan2f; every division by a number is a true division."""
    ldirf = a.ldirf
    lon = (a.xlon0 + x * a.dx) * a.pi180
    lat = (a.ylat0 + y * a.dy) * a.pi180
    north = lat > SWITCHNORTH * PI180
    south = lat < SWITCHSOUTH * PI180

    sinl, cosl = torch.sin(lon), torch.cos(lon)
    two_r = 2.0 * R_EARTH

    # ---- north pole plane: X = rho sin(lon), Y = -rho cos(lon) ----
    half_n = (PI / 4.0) - lat / 2.0              # (90 - lat)/2
    rho_n = two_r * torch.tan(half_n)
    c_n = torch.cos(half_n)
    m_n = _scalar_div(1.0, c_n * c_n)            # map factor
    dxp = (dxsave * cosl - dysave * sinl) * m_n * ldirf
    dyp = (dxsave * sinl + dysave * cosl) * m_n * ldirf
    xpl = rho_n * sinl + dxp
    ypl = -rho_n * cosl + dyp
    rho2 = torch.hypot(xpl, ypl)
    lat_n = PI / 2.0 - 2.0 * torch.atan(true_div(rho2, two_r))
    lon_n = torch.atan2(xpl, -ypl)

    # ---- south pole plane: X = rho sin(lon), Y = +rho cos(lon) ----
    half_s = (PI / 4.0) + lat / 2.0              # (90 + lat)/2
    rho_s = two_r * torch.tan(half_s)
    c_s = torch.cos(half_s)
    m_s = _scalar_div(1.0, c_s * c_s)
    dxs = (dxsave * cosl + dysave * sinl) * m_s * ldirf
    dys = (-dxsave * sinl + dysave * cosl) * m_s * ldirf
    xps = rho_s * sinl + dxs
    yps = rho_s * cosl + dys
    rho2s = torch.hypot(xps, yps)
    lat_s = -(PI / 2.0) + 2.0 * torch.atan(true_div(rho2s, two_r))
    lon_s = torch.atan2(xps, yps)

    lat_new = true_div(torch.where(north, lat_n, lat_s), a.pi180)
    lon_new = true_div(torch.where(north, lon_n, lon_s), a.pi180)
    # back to grid units; wrap with the grid's cyclic width nx - 1, as
    # _apply_bcs does
    xg = true_div(lon_new - a.xlon0, a.dx)
    xg = torch.where(xg < 0.0, xg + a.nxm, xg)
    xg = torch.where(xg >= a.nxm, xg - a.nxm, xg)
    yg = true_div(lat_new - a.ylat0, a.dy)
    return xg, yg, north, south


def _apply_polar(cfg: StepConfig, a: AdvanceArgs, x, y, dxs, dys, x_hi, x_lo,
                 y_hi, y_lo):
    """The position of a particle inside a polar cap from ``_polar_update``
    (low parts zeroed), every other particle's untouched."""
    if not cfg.polar:
        return x_hi, x_lo, y_hi, y_lo
    xg, yg, north, south = _polar_update(a, x, y, dxs, dys)
    pol = north | south
    zero = torch.zeros_like(x_lo)
    return (torch.where(pol, xg, x_hi), torch.where(pol, zero, x_lo),
            torch.where(pol, yg, y_hi), torch.where(pol, zero, y_lo))


def _check_draws(draws: dict | None, n: int, device, ifine: int) -> None:
    if draws is None:
        return
    rows = {**DRAW_ROWS, 2: ifine}
    for tag in DRAW_TAGS:
        d = draws[tag]
        if tuple(d.shape) != (rows[tag], n) or d.device != torch.device(device) \
                or d.dtype != torch.float32:
            raise ValueError(f"injected draws for tag {tag}: expected "
                             f"float32 {(rows[tag], n)} on {device}, got "
                             f"{d.dtype} {tuple(d.shape)} on {d.device}")


def advance_all(p: Particles, z0: ZFields, z1: ZFields, itime: int,
                memtime0: int, memtime1: int, key: rng.Key,
                cfg: StepConfig, prm: StepParams,
                tables: StepTablesQuad | None = None,
                draws: dict | None = None, offset: int = 0):
    """Advance every scheduled particle by one lsynctime interval: K4 for
    particles on a CUDA device, the plain version for particles on the CPU.

    ``offset`` is the global index of particle 0 (the draw counter);
    ``tables`` may be shared across chunks (``advance_chunked`` does).
    Returns (particles, StepDiag); exited particles get active=False."""
    cfg.check()
    dev = p.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no advance backend for device {dev}")
    if tables is None:
        tw0, tw1, ew0, ew1, _ = _time_weights(itime, memtime0, memtime1,
                                              prm, cfg)
        tables = build_step_tables_quad(z0, z1, tw0, tw1, ew0, ew1,
                                        dtype=cfg.table_dtype)
    a = advance_args(cfg, prm, itime, memtime0, memtime1)
    run = advance_all_cuda if dev.type == "cuda" else advance_all_plain
    return run(p, z0.height, tables, a, key, cfg, draws, offset)


def advance_all_cuda(p: Particles, height: torch.Tensor,
                     tables: StepTablesQuad, a: AdvanceArgs, key: rng.Key,
                     cfg: StepConfig, draws: dict | None, offset: int):
    """K4 launch: the whole advance of all ``p.capacity`` particles in one
    kernel, out of place.  ``draws`` None: the kernel makes its draws in
    registers from ``key``; else it reads the injected (rows, n) arrays."""
    n = p.capacity
    dev = p.device
    i32 = torch.int32
    if n >= 2 ** 31:
        raise ValueError("K4 indexes particles with int32")
    want = {"itra": i32, "itramem": i32, "cbt": torch.int8,
            "active": torch.bool}
    for name in _IN_FIELDS:
        t = getattr(p, name)
        dt = want.get(name, torch.float32)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape != (n,):
            raise ValueError(f"K4: particle field {name} must be contiguous "
                             f"{dt} ({n},) on {dev}")
    r = (cfg.nz - 1) * cfg.ny * cfg.nx
    for name, lanes in (("rows", ROWS_LANES), ("rowsE", ROWS_E_LANES)):
        t = getattr(tables, name)
        if t.device != dev or t.dtype != cfg.table_dtype \
                or t.shape != (r, lanes) or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"K4: table {name} must be contiguous, 16-byte "
                             f"aligned {cfg.table_dtype} ({r}, {lanes}) on "
                             f"{dev}")
    if height.device != dev or height.dtype != torch.float32 \
            or height.shape != (cfg.nz,) or not height.is_contiguous():
        raise ValueError(f"K4: height must be float32 ({cfg.nz},) on {dev}")
    _check_draws(draws, n, dev, cfg.ifine)
    zero = torch.zeros((), dtype=i32, device=dev)
    if n == 0:
        return p, StepDiag(n_active=zero, n_exited=zero, nan_count=zero)

    a.n = n
    a.offset = offset
    for s, tag in enumerate(DRAW_TAGS):
        a.key[2 * s], a.key[2 * s + 1] = key.philox_key(tag)
    if draws is None:
        injected = [None] * len(DRAW_TAGS)
    else:
        held = [draws[tag].contiguous() for tag in DRAW_TAGS]
        injected = [d.data_ptr() for d in held]
    out = {f: torch.empty_like(getattr(p, f)) for f in OUT_FIELDS}
    counts = torch.zeros(2, dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.ADVANCE(*(getattr(p, f).data_ptr() for f in _IN_FIELDS),
                       *(out[f].data_ptr() for f in OUT_FIELDS),
                       *injected, tables.rows.data_ptr(),
                       tables.rowsE.data_ptr(), height.data_ptr(),
                       counts.data_ptr(), ctypes.addressof(a), stream)
    # only the CBL branch (not ported) can produce a non-finite wp
    return p.replace(**out), StepDiag(n_active=counts[0], n_exited=counts[1],
                                      nan_count=zero)


def advance_all_plain(p: Particles, height: torch.Tensor,
                      tables: StepTablesQuad, a: AdvanceArgs, key: rng.Key,
                      cfg: StepConfig, draws: dict | None, offset: int):
    """The plain PyTorch version of K4: the same function in eager tensor
    ops, both sides of every branch computed and selected."""
    n = p.capacity
    dev = p.device
    scheduled = p.active
    itime = a.itime
    rows = {**DRAW_ROWS, 2: cfg.ifine}
    _check_draws(draws, n, dev, cfg.ifine)

    def draw(tag: int) -> torch.Tensor:
        if draws is not None:
            return draws[tag]
        return rng.normals(key, (rows[tag], n), tag, offset, device=dev)

    x = p.x
    y = p.y
    z = p.z
    hw = horiz_weights(x, y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, dz1 = vert_weights(z, height)
    h, tropop, ust, wst, ol, wind = sample_all_quad(tables, hw, indz, dz1,
                                                    x, y, cfg.nx, cfg.ny)
    u, v, w = wind.u, wind.v, wind.w

    dt = a.dt
    pbl = (z / h) <= 1.0
    htop = height[-1] - a.htop_eps
    in_trop = z < tropop
    in_trans = (~in_trop) & (z < tropop + 1000.0)
    turb_fn = hanna if cfg.turbswitch else hanna1

    # -------- newly released particles (initialize.f90:110-219) --------
    fresh = scheduled & ((p.itramem == itime) | (itime == 0))
    rnd_i = draw(6)
    turb_i = turb_fn(z, h, ust, wst, ol)
    up_i = torch.where(pbl, rnd_i[0] * turb_i.sigu, rnd_i[0] * 0.3)
    vp_i = torch.where(pbl, rnd_i[1] * turb_i.sigv, rnd_i[1] * 0.3)
    wp_raw = rnd_i[2] if cfg.turbswitch else rnd_i[2] * turb_i.sigw
    wp_i = torch.where(pbl, wp_raw, torch.zeros_like(wp_raw))
    usig_i = rnd_i[3] * wind.usig * a.turbmeso
    vsig_i = rnd_i[4] * wind.vsig * a.turbmeso
    wsig_i = rnd_i[5] * wind.wsig * a.turbmeso
    p_up = torch.where(fresh, up_i, p.up)
    p_vp = torch.where(fresh, vp_i, p.vp)
    p_wp = torch.where(fresh, wp_i, p.wp)
    p_usig = torch.where(fresh, usig_i, p.usig)
    p_vsig = torch.where(fresh, vsig_i, p.vsig)
    p_wsig = torch.where(fresh, wsig_i, p.wsig)
    p_cbt = torch.where(fresh, torch.ones_like(p.cbt), p.cbt)

    ldirf = a.ldirf

    # ---------------- fixed-step PBL branch (advance.f90:276-615) -------
    rnd_h = draw(1)
    rnd_w = draw(2)
    turb0 = turb_fn(z, h, ust, wst, ol)
    up_pbl = _ou_update(p_up, rnd_h[0], turb0.sigu,
                        _scalar_div(dt, turb0.tlu))
    vp_pbl = _ou_update(p_vp, rnd_h[1], turb0.sigv,
                        _scalar_div(dt, turb0.tlv))

    z_pbl, wp_pbl, icbt = _pbl_vertical(
        cfg, z, p_wp, p_cbt, h, ust, wst, ol, wind.rho, wind.drhodz, rnd_w,
        a.dtf)
    daw_pbl = up_pbl * dt
    dcw_pbl = vp_pbl * dt
    w_eff = w

    dxs_pbl = u * dt
    dys_pbl = v * dt
    z_pbl = z_pbl + w_eff * dt * ldirf
    z_pbl = torch.minimum(z_pbl, htop)
    hm = h - 1e-9
    z_pbl = torch.where(z_pbl < 0.0, torch.minimum(hm, -z_pbl), z_pbl)

    # ------ free troposphere / stratosphere (advance.f90:629-708) ------
    rnd_ft = draw(3)
    weight = torch.clamp(true_div(z - tropop, 1000.0), 0.0, 1.0)
    uxscale_tr = torch.sqrt(a.c_trop * (1.0 - weight))
    wpscale_tr = torch.sqrt(a.c_strat * weight)

    zero = torch.zeros_like(z)
    ux = torch.where(in_trop, rnd_ft[0] * a.uxscale_t,
                     torch.where(in_trans, rnd_ft[0] * uxscale_tr, zero))
    vy = torch.where(in_trop, rnd_ft[1] * a.uxscale_t,
                     torch.where(in_trans, rnd_ft[1] * uxscale_tr, zero))
    wp_ft = torch.where(in_trop, zero,
                        torch.where(in_trans,
                                    rnd_ft[2] * wpscale_tr + a.d_strat_1000,
                                    rnd_ft[2] * a.wpscale_s))

    dxs_ft = (u + ux) * dt
    dys_ft = (v + vy) * dt
    z_ft = z + (w_eff + wp_ft) * dt * ldirf
    z_ft = torch.where(z_ft < 0.0, torch.minimum(hm, -z_ft), z_ft)

    # ---------------- merge branches ----------------
    dxsave = torch.where(pbl, dxs_pbl, dxs_ft)
    dysave = torch.where(pbl, dys_pbl, dys_ft)
    dawsave = torch.where(pbl, daw_pbl, zero)
    dcwsave = torch.where(pbl, dcw_pbl, zero)
    z_new = torch.where(pbl, z_pbl, z_ft)
    up_new = torch.where(pbl, up_pbl, p_up)
    vp_new = torch.where(pbl, vp_pbl, p_vp)
    wp_new = torch.where(pbl, wp_pbl, wp_ft)
    icbt = torch.where(pbl, icbt, p_cbt)
    u_ref, v_ref, w_ref = u, v, w_eff

    # ------------ mesoscale fluctuations (advance.f90:720-738) ------------
    rnd_m = draw(4)
    r, rs = a.r_meso, a.rs_meso
    usig_new = r * p_usig + rs * rnd_m[0] * wind.usig * a.turbmeso
    vsig_new = r * p_vsig + rs * rnd_m[1] * wind.vsig * a.turbmeso
    wsig_new = r * p_wsig + rs * rnd_m[2] * wind.wsig * a.turbmeso
    dxsave = dxsave + usig_new * dt
    dysave = dysave + vsig_new * dt
    z_new = z_new + wsig_new * dt
    z_new = torch.abs(z_new)

    # ------- windalign + metric position update (advance.f90:747-799) -------
    ffinv = 1.0 / torch.clamp(torch.sqrt(u_ref * u_ref + v_ref * v_ref),
                              min=1e-30)
    sinphi, cosphi = v_ref * ffinv, u_ref * ffinv
    ux_t = cosphi * dawsave - sinphi * dcwsave
    vy_t = sinphi * dawsave + cosphi * dcwsave
    dxsave = dxsave + ux_t
    dysave = dysave + vy_t

    cosfact = _scalar_div(a.dxconst,
                          torch.cos((y * a.dy + a.ylat0) * a.pi180))
    x_hi, x_lo = ds_add(p.x_hi, p.x_lo, dxsave * cosfact * ldirf)
    y_hi, y_lo = ds_add(p.y_hi, p.y_lo, dysave * a.dyconst * ldirf)
    # stereographic update inside the polar caps (advance.f90:754-778)
    x_hi, x_lo, y_hi, y_lo = _apply_polar(cfg, a, x, y, dxsave, dysave,
                                          x_hi, x_lo, y_hi, y_lo)

    x_hi, x_lo, y_hi, y_lo, exited = _apply_bcs(cfg, a, x_hi, x_lo,
                                                y_hi, y_lo)
    z_new = torch.minimum(z_new, htop)

    # ---------------- Petterssen corrector (advance.f90:816-986) ------------
    can_pett = (~exited) if a.can_pett else torch.zeros_like(exited)
    xn = x_hi + x_lo
    yn = y_hi + y_lo
    hw2 = horiz_weights(xn, yn, cfg.nx, cfg.ny, cfg.xglobal)
    indz2, dz1_2 = vert_weights(z_new, height)
    u2, v2, w2 = interp_wind_short_quad(tables.rowsE, hw2, indz2, dz1_2,
                                        cfg.nx, cfg.ny)
    du = (u2 - u_ref) / 2.0
    dv = (v2 - v_ref) / 2.0
    dw = (w2 - w_ref) / 2.0
    dtl = dt

    z_corr = z_new + dw * dtl * ldirf
    z_corr = torch.where(z_corr < 0.0, torch.minimum(hm, -z_corr), z_corr)
    cosfact2 = _scalar_div(a.dxconst,
                           torch.cos((yn * a.dy + a.ylat0) * a.pi180))
    xc_hi, xc_lo = ds_add(x_hi, x_lo, du * cosfact2 * dtl * ldirf)
    yc_hi, yc_lo = ds_add(y_hi, y_lo, dv * a.dyconst * dtl * ldirf)
    xc_hi, xc_lo, yc_hi, yc_lo = _apply_polar(cfg, a, xn, yn, du * dtl,
                                              dv * dtl, xc_hi, xc_lo, yc_hi,
                                              yc_lo)
    xc_hi, xc_lo, yc_hi, yc_lo, exited2 = _apply_bcs(cfg, a, xc_hi, xc_lo,
                                                     yc_hi, yc_lo)

    x_hi = torch.where(can_pett, xc_hi, x_hi)
    x_lo = torch.where(can_pett, xc_lo, x_lo)
    y_hi = torch.where(can_pett, yc_hi, y_hi)
    y_lo = torch.where(can_pett, yc_lo, y_lo)
    z_new = torch.where(can_pett, z_corr, z_new)
    exited = exited | (can_pett & exited2)
    z_new = torch.minimum(z_new, htop)

    # ---------------- write back (masked on scheduled) ----------------
    keep = scheduled & (~exited)

    def sel(new, old):
        return torch.where(scheduled, new, old)

    itra_new = torch.full_like(p.itra, a.itra_new)
    new_p = p.replace(
        x_hi=sel(x_hi, p.x_hi), x_lo=sel(x_lo, p.x_lo),
        y_hi=sel(y_hi, p.y_hi), y_lo=sel(y_lo, p.y_lo),
        z=sel(z_new, p.z),
        up=sel(up_new, p_up), vp=sel(vp_new, p_vp), wp=sel(wp_new, p_wp),
        usig=sel(usig_new, p_usig), vsig=sel(vsig_new, p_vsig),
        wsig=sel(wsig_new, p_wsig),
        cbt=torch.where(scheduled, icbt, p_cbt).to(torch.int8),
        itra=torch.where(scheduled, itra_new, p.itra),
        active=torch.where(scheduled, keep, p.active),
    )
    i32 = torch.int32
    diag = StepDiag(
        n_active=new_p.active.sum(dtype=i32),
        n_exited=(scheduled & exited).sum(dtype=i32),
        # only the CBL branch (not ported) can produce a non-finite wp
        nan_count=torch.zeros((), dtype=i32, device=dev),
    )
    return new_p, diag


def advance_chunked(p: Particles, z0: ZFields, z1: ZFields, itime: int,
                    memtime0: int, memtime1: int, key: rng.Key,
                    cfg: StepConfig, prm: StepParams, n_chunks: int,
                    draws: dict | None = None):
    """``advance_all`` with the tables built once: one K4 launch over all
    particles on a CUDA device (the kernel holds no temporaries, so there
    is nothing to chunk), ``n_chunks`` calls of the plain version on the
    CPU, which bounds its temporaries.

    Unlike JAX's ``fold_in(key, chunk)``, the draw counter is the global
    particle index, so without injected draws the result does not depend
    on ``n_chunks``.  Injected draws are (rows, N) and sliced per chunk."""
    cfg.check()
    n = p.capacity
    if n % n_chunks:
        raise ValueError(f"capacity {n} not divisible by {n_chunks} chunks")
    b = n // n_chunks
    tw0, tw1, ew0, ew1, _ = _time_weights(itime, memtime0, memtime1, prm, cfg)
    tables = build_step_tables_quad(z0, z1, tw0, tw1, ew0, ew1,
                                    dtype=cfg.table_dtype)
    if p.device.type == "cuda":
        return advance_all(p, z0, z1, itime, memtime0, memtime1, key, cfg,
                           prm, tables=tables, draws=draws)
    parts, diags = [], []
    for i in range(n_chunks):
        lo = i * b
        d = None if draws is None else {t: v[:, lo:lo + b]
                                        for t, v in draws.items()}
        pi, di = advance_all(p.rows(lo, lo + b), z0, z1, itime, memtime0,
                             memtime1, key, cfg, prm, tables=tables, draws=d,
                             offset=lo)
        parts.append(pi)
        diags.append(di)
    p2 = parts[0] if n_chunks == 1 else Particles.cat(parts)

    def total(name):
        return torch.stack([getattr(d, name) for d in diags]).sum(
            dtype=torch.int32)

    return p2, StepDiag(n_active=total("n_active"),
                        n_exited=total("n_exited"),
                        nan_count=total("nan_count"))

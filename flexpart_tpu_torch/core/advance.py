"""The particle advance: one lsynctime update for all particles.

Port of ``flexpart_tpu/core/advance.py``, fixed step (CTL<0, ``method=0``)
and adaptive step (CTL>0, ``method=1``): quad-table met sampling,
Hanna/Langevin PBL turbulence with the exact OU discretization (turbswitch
on and off, any ``ifine``), the skewed convective boundary layer
(``cblflag``, ``core/cbl.py``), constant-diffusivity free troposphere /
stratosphere, mesoscale fluctuations, gravitational settling, ``turboff``,
nested met grids (the innermost nest that holds a particle supplies its
met), windalign, the double-single position update, the
polar-stereographic update inside the polar caps, cyclic and pole boundary
conditions and the Petterssen corrector.  The adaptive step runs the
boundary layer in a loop of passes of per-particle length
(``_adaptive_interval_plain``) and returns the seconds each particle spent
below 2 HREF (``StepDiag.t_below``).

Tile mode (``StepConfig.tile_mode``, a rank of a tiles run,
parallel/domain.py): the tables are a tile's (``Tile``: their first cell's
global column and row, and their dims), the positions stay global, and only
the corner of each gather moves by the tile's origin, clamped to the tile
(``interp.tile_weights``); the cyclic, pole and exit boundary conditions
run once, after the corrector, with the global grid's arguments, and with
the polar caps a particle that took the cap's update at the predictor
skips the corrector (its end may lie outside the tile).  So a particle
that the step neither wraps, mirrors, kills nor moves by the caps' update
takes the serial step bit for bit.  K4 ``TILE`` and K11 ``TILE`` are its
kernels (``_build.ADVANCE_TILE``, ``_build.ADVANCE_ADAPTIVE_TILE``), and
with the skewed CBL K11 ``TILE`` x ``CBL``
(``_build.ADVANCE_ADAPTIVE_TILE_CBL``).

Two versions of the same function: ``advance_all_plain``, plain PyTorch
ops, runs for CPU tensors; for CUDA tensors ``advance_all_cuda`` launches
kernel K4 (``csrc/advance.cu``, the fixed step; its ``NESTS``
instantiation with nests, its ``CBL`` one with the skewed boundary layer)
and ``advance_adaptive_cuda`` kernel K11 (``csrc/advance_adaptive.cu``,
the adaptive step; its ``CBL`` instantiation with the skewed boundary
layer), one launch for all particles.  ``advance_all`` picks by the device
of the particles and never falls from one to the other.  Every
``StepConfig`` the reference's step takes runs on a CUDA tensor: any
turbulence (turbswitch on or off, the CBL) with settling, nests, a tile,
the polar caps and either table type (the fixed step with the CBL, which
``Command`` never makes, included); what a kernel does not take (injected
draws or more than ``MAX_CBL_SUBSTEPS`` substeps with the CBL) is refused
by name with ValueError.

The legacy-RNG validation path (``leg``, ``core/legacy.py``) draws from
the reference's rannumb table and interpolates per time level, or with
``StepConfig.legacy_quad`` samples the quad tables as the production path
does; it is the reference's matched-stream mode, has no kernel, and runs
on CPU tensors only: ``advance_all`` raises NotImplementedError for it on
a CUDA tensor.

Scalars (time weights, the interval, grid constants) are float32 values
computed with numpy ``float32`` arithmetic on the host and held in Python
floats, so the tensor ops see exactly the operands XLA sees;
``advance_args`` packs them into the struct both versions read.

Draws: every draw site takes its numbers either from ``draws`` (a dict
keyed by the JAX tags 6, 1, 2, 3, 4 with the JAX shapes, and with the CBL
7 and 8 (n,) and 40 + i (2, n) for substep i; in the adaptive step tags 1,
2 and 40 + i carry a leading pass axis, (K, rows, n)), which the parity
tests fill with JAX's own draws, or from the Philox stream keyed by
(seed, step, tag) with the global particle index and, for the adaptive
step's per-pass tags, the pass as counter.  On the CPU
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
from ..constants import (D_STRAT, D_TROP, GA, PI, PI180, R_EARTH,
                         TURBMESOSCALE)
from ..met.fields import F3_RHO, F3_TT, ZFields
from . import rng
from .cbl import CBL_ZONE, init_cbl_wp, legacy_reinit_wp, reinit_wp
from .cbl import cbl_terms, skew_column
from .hanna import hanna, hanna1
from .legacy import (LegacyRnd, interp_wind_legacy, interp_wind_short,
                     legacy_draws, sample_met_legacy, vert_wind_legacy, wrap)
from .interp import (ROWS_E_LANES, ROWS_LANES, HorizWeights, StepTablesQuad,
                     _cell_rowid, build_step_tables_quad, horiz_weights,
                     interp_wind_short_quad, sample_all_quad, tile_weights,
                     true_div, vert_weights, wind10_quad)
from .state import Particles, ds_add

f32 = np.float32


# species whose settling parameters the kernels take (MAX_SPECIES of
# csrc/advance_common.cuh)
MAX_SPECIES = 32
# nested met grids K4 takes (MAX_NESTS of csrc/advance_common.cuh)
MAX_NESTS = 4
# CBL substeps K11 draws the redraw of (MAX_CBL_SUBSTEPS there)
MAX_CBL_SUBSTEPS = 32
CBL_TAG0 = 40        # the redraw of substep i draws tag 40 + i


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of the advance: the JAX StepConfig's fields
    but ``maxsubsteps`` (unused there), ``nspec`` (the port takes the
    species from the mass array) and the single nest's ``nest_nx``,
    ``nest_ny`` (``nests`` holds it; ``interop.step_config_from_jax``
    maps them)."""
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
    mintime: float = 1.0        # minimum adaptive substep [s] (par_mod)
    nests: tuple = ()
    polar: bool = False
    tile_mode: bool = False     # a tile of a tiles run: advance_all's tile
    met_bf16: bool = True
    #: the legacy-RNG path (``leg``) with the production interpolation:
    #: the draws still from the rannumb table in reference order, every met
    #: sample from the quad tables (built at ``table_dtype``) in place of
    #: the per-time-level interpolation
    legacy_quad: bool = False

    def check(self) -> None:
        if self.tile_mode and self.nests:
            raise ValueError("tile_mode with nested met grids is not "
                             "supported (the reference refuses nests on "
                             "tiles)")
        if self.method == 1 and self.nests:
            raise ValueError("adaptive stepping (method=1) with nested met "
                             "grids is not supported; use CTL<0 or the "
                             "mother grid only")
        if self.method not in (0, 1):
            raise ValueError("method must be 0 (fixed) or 1 (adaptive)")
        if self.ifine < 1:
            raise ValueError("ifine must be >= 1")
        if self.method == 1 and not self.mintime > 0.0:
            raise ValueError("the adaptive step needs mintime > 0")

    @property
    def table_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.met_bf16 else torch.float32


SPECIES_PARAMS = ("sp_density", "sp_dquer", "sp_cunningham", "sp_vsetaver")
# the nest windows in mother-grid units, one per nest, outermost first
NEST_PARAMS = ("xln", "yln", "xrn", "yrn", "xresoln", "yresoln")


@dataclasses.dataclass(frozen=True)
class Tile:
    """A rank's tile of a tiles run as the advance sees it: the global
    column and row of its tables' first cell, (x0 - halo, y0 - halo), and
    the tables' dims, (tx + 2 halo, ty + 2 halo)."""
    ox: int
    oy: int
    nx: int
    ny: int


@dataclasses.dataclass(frozen=True)
class StepParams:
    """Run scalars of the advance, float32 values in Python floats; the
    species' settling parameters are tuples of them, one per species
    (get_settling.f90; the settling species of a particle is the first one
    it carries release mass of, advance.f90:518-531)."""
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
    ctl: float = -5.0     # TL/dt ratio (> 0: the adaptive step)
    sp_density: tuple = (-1.0,)
    sp_dquer: tuple = (0.0,)          # [um]
    sp_cunningham: tuple = (0.0,)
    sp_vsetaver: tuple = (0.0,)
    # nested met grids, outermost first (com_mod xln/xrn...): the window of
    # each in mother-grid units and the mother's dx, dy over the nest's;
    # without nests one unused entry each, as the JAX package has them
    xln: tuple = (0.0,)
    yln: tuple = (0.0,)
    xrn: tuple = (0.0,)
    yrn: tuple = (0.0,)
    xresoln: tuple = (1.0,)
    yresoln: tuple = (1.0,)

    @classmethod
    def make(cls, dx, dy, ylat0, dxconst, dyconst, lsynctime, fine,
             lwindinterv=3600, xlon0=-180.0, ctl=-5.0, sp_density=-1.0,
             sp_dquer=0.0, sp_cunningham=0.0,
             sp_vsetaver=0.0, xln=0.0, yln=0.0, xrn=0.0, yrn=0.0,
             xresoln=1.0, yresoln=1.0) -> "StepParams":
        def v(x):
            return float(f32(x))

        def vec(x):   # species vectors: a number -> (1,), a sequence -> (nspec,)
            return tuple(float(s) for s in np.atleast_1d(
                np.asarray(x, np.float32)))
        return cls(v(dx), v(dy), v(ylat0), v(dxconst), v(dyconst),
                   v(abs(lsynctime)), v(fine), v(lwindinterv), v(xlon0),
                   v(ctl), vec(sp_density), vec(sp_dquer),
                   vec(sp_cunningham), vec(sp_vsetaver), vec(xln), vec(yln),
                   vec(xrn), vec(yrn), vec(xresoln), vec(yresoln))


@dataclasses.dataclass
class StepDiag:
    n_active: torch.Tensor    # () int32
    n_exited: torch.Tensor
    nan_count: torch.Tensor
    #: the adaptive step only: per particle the seconds spent below 2 HREF
    #: this interval (advance.f90:582-599), the dry-deposition window that
    #: apply_decay_drydep takes, and the passes of the substep loop that the
    #: particle took (0 outside the boundary layer and if not scheduled)
    t_below: torch.Tensor | None = None
    passes: torch.Tensor | None = None
    #: K11 only: (passes executed, lane iterations issued, NaN redraws)
    #: int64; the ratio of the first two is the lane efficiency of its
    #: refilled lanes, the third is ``nan_count``
    lane_work: torch.Tensor | None = None
    #: K4 CBL only: () int32, the particles its start deferred to the
    #: skewed launch (``k4_cbl_deferred``'s count)
    deferred: torch.Tensor | None = None


DRAW_ROWS = {6: 6, 1: 2, 3: 3, 4: 3}     # tag 2 has ifine rows
DRAW_TAGS = (6, 1, 2, 3, 4)               # K4's draw sites, in this order
PASS_TAGS = (1, 2)        # the adaptive step draws these once per pass
CBL_FRESH_TAGS = (7, 8)   # a fresh particle's skewed draw: uniform, normal


def draw_tags(cfg: "StepConfig") -> dict:
    """The draw tags of one advance and their rows: a dict tag -> rows
    (0 for the (n,) draws of tags 7 and 8)."""
    rows = {**DRAW_ROWS, 2: cfg.ifine}
    if cfg.cblflag:
        rows.update({7: 0, 8: 0})
        rows.update({CBL_TAG0 + i: 2 for i in range(cfg.ifine)})
    return rows


def pass_tags(cfg: "StepConfig") -> tuple:
    """The tags the adaptive step draws once per pass."""
    extra = tuple(CBL_TAG0 + i for i in range(cfg.ifine)) if cfg.cblflag \
        else ()
    return PASS_TAGS + extra
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
        ("method", ctypes.c_int),
        ("turboff", ctypes.c_int),
        ("settling", ctypes.c_int),
        ("nspec", ctypes.c_int),
        ("fine", ctypes.c_float),
        ("ctl", ctypes.c_float),
        ("mintime", ctypes.c_float),
        ("two_d_trop", ctypes.c_float),
        ("two_d_strat", ctypes.c_float),
        ("sp_density", ctypes.c_float * MAX_SPECIES),
        ("sp_dquer", ctypes.c_float * MAX_SPECIES),
        ("sp_cunningham", ctypes.c_float * MAX_SPECIES),
        ("sp_vsetaver", ctypes.c_float * MAX_SPECIES),
        ("cblflag", ctypes.c_int),
        ("key_cbl", ctypes.c_uint32 * (2 * MAX_CBL_SUBSTEPS)),
        ("key_fresh", ctypes.c_uint32 * 4),
        ("nnest", ctypes.c_int),
        ("eps_nest", ctypes.c_float),
        ("nest_nx", ctypes.c_int * MAX_NESTS),
        ("nest_ny", ctypes.c_int * MAX_NESTS),
        ("xln", ctypes.c_float * MAX_NESTS),
        ("yln", ctypes.c_float * MAX_NESTS),
        ("xrn", ctypes.c_float * MAX_NESTS),
        ("yrn", ctypes.c_float * MAX_NESTS),
        ("xresoln", ctypes.c_float * MAX_NESTS),
        ("yresoln", ctypes.c_float * MAX_NESTS),
        ("nest_xmax", ctypes.c_float * MAX_NESTS),
        ("nest_ymax", ctypes.c_float * MAX_NESTS),
        ("nest_rows", ctypes.c_void_p * MAX_NESTS),
        ("nest_rows_e", ctypes.c_void_p * MAX_NESTS),
        ("tile", ctypes.c_int),
        ("tile_ox", ctypes.c_int),
        ("tile_oy", ctypes.c_int),
        ("tile_nx", ctypes.c_int),
        ("tile_ny", ctypes.c_int),
    ]

    def __copy__(self) -> "AdvanceArgs":
        """A byte copy (ctypes cannot pickle a struct that holds
        pointers)."""
        out = type(self)()
        ctypes.memmove(ctypes.addressof(out), ctypes.addressof(self),
                       ctypes.sizeof(self))
        return out


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
                 memtime1: int, tile: Tile | None = None) -> AdvanceArgs:
    """The run scalars of one advance, each rounded to float32 once, on
    the host, from the double or float32 expression the reference uses;
    both versions of the advance read them from here.  ``n``, ``offset``
    and ``key`` are left 0 for the launcher to fill.  ``tile``: the tables'
    origin and dims in tile mode (without it the grid's: origin 0)."""
    if cfg.tile_mode != (tile is not None):
        raise ValueError("tile_mode takes a Tile, and a Tile tile_mode")
    if tile is not None and (tile.nx < 2 or tile.ny < 2):
        raise ValueError(f"a tile of {tile.ny} x {tile.nx} cells")
    tdims = dict(tile=0, tile_ox=0, tile_oy=0, tile_nx=cfg.nx,
                 tile_ny=cfg.ny) if tile is None else dict(
        tile=1, tile_ox=tile.ox, tile_oy=tile.oy, tile_nx=tile.nx,
        tile_ny=tile.ny)
    dt = f32(prm.lsynctime)
    endtime = _time_weights(itime, memtime0, memtime1, prm, cfg)[4]
    c_trop = f32(2.0 * D_TROP) / dt
    c_strat = f32(2.0 * D_STRAT) / dt
    r = f32(np.exp(f32(-2.0) * dt / f32(prm.lwindinterv)))
    eps = f32(cfg.nx / 3.0e5)
    nxm = float(cfg.nx - 1)
    nym = float(cfg.ny - 1)
    nspec = len(prm.sp_density)
    if any(len(getattr(prm, f)) != nspec for f in SPECIES_PARAMS):
        raise ValueError("the species' settling parameters differ in length")
    if cfg.settling and nspec > MAX_SPECIES:
        raise ValueError(f"settling takes at most {MAX_SPECIES} species")
    sp = {f: (ctypes.c_float * MAX_SPECIES)(*getattr(prm, f)[:MAX_SPECIES])
          for f in SPECIES_PARAMS}
    nnest = len(cfg.nests)
    if any(len(getattr(prm, f)) < nnest for f in NEST_PARAMS):
        raise ValueError(f"{nnest} nests but fewer nest windows in StepParams")
    # the nests' windows (zeros without nests); K4 takes MAX_NESTS of them,
    # the plain version any
    nest = {}
    if nnest:
        nest = {f: (ctypes.c_float * MAX_NESTS)(
            *getattr(prm, f)[:min(nnest, MAX_NESTS)]) for f in NEST_PARAMS}
        shapes = cfg.nests[:MAX_NESTS]
        nest["nest_nx"] = (ctypes.c_int * MAX_NESTS)(*(s[0] for s in shapes))
        nest["nest_ny"] = (ctypes.c_int * MAX_NESTS)(*(s[1] for s in shapes))
        # the clamp of a position inside a nest, nnx - 1.001 in float32
        nest["nest_xmax"] = (ctypes.c_float * MAX_NESTS)(
            *(float(f32(s[0] - 1.001)) for s in shapes))
        nest["nest_ymax"] = (ctypes.c_float * MAX_NESTS)(
            *(float(f32(s[1] - 1.001)) for s in shapes))
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
        eps_bc=float(eps), nxm_eps=float(f32(nxm) - eps),
        method=cfg.method, turboff=int(cfg.turboff),
        settling=int(cfg.settling), nspec=nspec, fine=prm.fine, ctl=prm.ctl,
        mintime=float(f32(cfg.mintime)),
        two_d_trop=float(f32(2.0 * D_TROP)),
        two_d_strat=float(f32(2.0 * D_STRAT)), **sp,
        cblflag=int(cfg.cblflag), nnest=nnest, eps_nest=float(eps), **nest,
        **tdims)


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


def _viscosity(t):
    """Sutherland's law (dynamic_viscosity.f90), in JAX's operation order."""
    return _scalar_div(1.827e-5 * (291.15 + 120.0), t + 120.0) \
        * torch.pow(true_div(t, 291.15), 1.5)


def _settling_velocity(dquer_um, density, cunningham, vsetaver, temp, rhoa):
    """Iterative Reynolds/Cd settling velocity (get_settling.f90:100-127),
    five fixed iterations; every species parameter is per particle (already
    gathered).  Negative (downward) [m/s]; 0 for gases (density <= 0)."""
    vis_kin = _viscosity(temp) / rhoa
    d_m = true_div(dquer_um, 1.0e6)

    def cd_of(re):
        re = torch.clamp(re, min=1e-12)
        return torch.where(re < 1.917, _scalar_div(24.0, re),
                           torch.where(re < 500.0,
                                       _scalar_div(18.5, torch.pow(re, 0.6)),
                                       torch.full_like(re, 0.44)))

    settl = vsetaver.expand_as(temp)
    reynolds = d_m * torch.abs(settl) / vis_kin
    dens_pos = torch.clamp(density, min=0.0)
    for _ in range(5):
        c_d = cd_of(reynolds)
        settl = -torch.sqrt((4.0 * GA) * d_m * dens_pos * cunningham
                            / (3.0 * c_d * rhoa))
        reynolds = d_m * torch.abs(settl) / vis_kin
    return torch.where(density > 0.0, settl, torch.zeros_like(settl))


def settling_species(mass0: torch.Tensor) -> torch.Tensor:
    """The settling species of each particle: the first species it carries
    release mass of (``argmax(mass0 > 1e-30)``), 0 if none."""
    return torch.argmax((mass0 > 1e-30).to(torch.int32), dim=1)


def _particle_settling(a: "AdvanceArgs", mass0, temp, rhoa):
    """Per-particle settling velocity with the parameters of its settling
    species (``_particle_settling`` of the JAX package)."""
    nsp = settling_species(mass0)
    dev = temp.device

    def gathered(name):
        vals = torch.tensor(list(getattr(a, name))[:a.nspec],
                            dtype=torch.float32, device=dev)
        return vals[nsp]
    return _settling_velocity(gathered("sp_dquer"), gathered("sp_density"),
                              gathered("sp_cunningham"),
                              gathered("sp_vsetaver"), temp, rhoa)


def _settle_fn(cfg: StepConfig, a: "AdvanceArgs", x, y, height, tt, rho,
               mass0):
    """Settling at a height ``zc`` in the particle's nearest grid column
    (round half to even, clipped), linear in z between the two levels of
    the temperature and air density of the interval's first met time,
    unblended (advance.py:966-981 of the JAX package; get_settling is
    called with the un-updated position)."""
    tnx, tny = a.tile_nx, a.tile_ny      # a tile's fields in tile mode
    nix = torch.clamp(torch.round(x).to(torch.int32) - a.tile_ox, 0,
                      tnx - 1).long()
    njy = torch.clamp(torch.round(y).to(torch.int32) - a.tile_oy, 0,
                      tny - 1).long()
    plane = tny * tnx
    col = njy * tnx + nix
    tt_f, rho_f = tt.reshape(-1), rho.reshape(-1)

    def fn(zc):
        indz, dz1 = vert_weights(zc, height)
        lin = indz.long() * plane + col
        temp = tt_f[lin] * (1.0 - dz1) + tt_f[lin + plane] * dz1
        rhoa = rho_f[lin] * (1.0 - dz1) + rho_f[lin + plane] * dz1
        return _particle_settling(a, mass0, temp, rhoa)
    return fn


def _sqrt_dtf(dtf):
    """sqrt(dtf) in float32: of the fixed step's number or the adaptive
    pass's per-particle tensor."""
    if isinstance(dtf, float):
        return float(np.sqrt(f32(dtf)))
    return torch.sqrt(dtf)


def _pbl_vertical(cfg: StepConfig, z, wp, icbt, h, ust, wst, ol, rho, drhodz,
                  rnd_w, dtf, cbl_draw=None, legacy_cbl=None):
    """The ifine vertical Langevin substeps (advance.f90:396-498).
    ``dtftlw`` and everything derived from it is computed once from the
    interval-start turbulence, as the reference does.  ``dtf`` is the
    fixed step's number or the adaptive pass's per-particle tensor.
    Returns (z, wp, icbt, the turbulence of the last refresh, nan_mask,
    nrand).

    With ``cfg.cblflag`` wp is the raw vertical velocity: in strongly
    convective columns (-h/L > 5) the skewed bi-Gaussian drift of
    ``core/cbl.py`` applies, with a redraw (``cbl_draw(i)``: tag 40 + i,
    two rows) of a particle that left the pdf; in the others the Gaussian
    drift on the raw velocity; a non-finite result is redrawn from the
    substep's normal and flagged in ``nan_mask`` (advance.f90:435-441).
    Where ``dtftlw >= 0.5`` the reference falls through to the exact-OU
    normalised update even with the CBL, wp still raw: a units quirk of
    advance.f90:403,446-455 kept on purpose.

    ``legacy_cbl`` = (table, nrand): the matched-RNG CBL, whose draws
    chase a per-particle cursor through the table (advance.f90:411,426;
    the redraw loop and the NaN redraw consume entries too); the final
    cursor is returned for the mesoscale draws."""
    cbl = cfg.cblflag
    turb_fn = hanna if (cfg.turbswitch or cbl) else hanna1
    rhoaux = drhodz / rho
    turb = turb_fn(z, h, ust, wst, ol)
    dtftlw = (_scalar_div(dtf, turb.tlw) if isinstance(dtf, float)
              else dtf / turb.tlw)
    rw = torch.exp(-dtftlw)
    rnd_exact = torch.sqrt(torch.clamp(1.0 - rw * rw, min=0.0))
    rnd_lin = torch.sqrt(2.0 * dtftlw)
    use_lin = dtftlw < 0.5
    nan_mask = torch.zeros_like(use_lin)
    tab = nrand = None
    if legacy_cbl is not None:
        tab, nrand = legacy_cbl
        rtab = tab.shape[0] - 1
    # the skewed scheme's column constants and zone (-h/L > CBL_ZONE), once
    # for the substeps, as K11 computes them once a pass
    col = skew_column(h, wst, ol) if cbl else None
    for i in range(cfg.ifine):
        icbtf = icbt.to(torch.float32)
        if cbl:
            zone = col.zone
            if tab is not None:
                # advance.f90:411/426: nrand = nrand + 1, then read, on the
                # dtftlw < 0.5 path only
                nrand = torch.where(use_lin, nrand + 1, nrand)
                dmain = tab[torch.clamp(nrand, 1, rtab).long()]
            else:
                dmain = rnd_w[i]
            ath_c, bth_c, rein = cbl_terms(
                wp, z, wst, h, rho, drhodz, turb.sigw, turb.dsigwdz,
                turb.tlw, ol, cfg.ldirect, col)
            wp_c = (wp + ath_c * dtf + bth_c * dmain * _sqrt_dtf(dtf)) \
                * icbtf
            if tab is not None:
                wp_re, idx_re = legacy_reinit_wp(
                    tab, nrand, wp, z, wst, h, turb.sigw, turb.dsigwdz, ol,
                    cfg.ldirect)
                nrand = torch.where(use_lin & zone & rein, idx_re, nrand)
            else:
                rr = cbl_draw(i)
                wp_re = reinit_wp(rr[0], rr[1], wp, z, wst, h, turb.sigw,
                                  turb.dsigwdz, ol, cfg.ldirect)
            wp_c = torch.where(rein, wp_re, wp_c)
            # weakly convective: the Gaussian drift on the raw velocity
            # (advance.f90:425-442)
            sig = torch.clamp(turb.sigw, min=1e-6)
            ath_g = (-wp / turb.tlw + sig * turb.dsigwdz
                     + wp * wp / sig * turb.dsigwdz
                     + sig * sig / rho * drhodz)
            wp_g = (wp + ath_g * dtf + sig * dmain * rnd_lin) * icbtf
            wp_new = torch.where(zone, wp_c, wp_g)
            nonfin = ~torch.isfinite(wp_new)
            nan_mask = nan_mask | (nonfin & use_lin)
            if tab is not None:
                # the reference redraws in the weak branch only, consuming
                # one entry (advance.f90:436-441)
                redraw = nonfin & ~zone & use_lin
                nrand = torch.where(redraw, nrand + 1, nrand)
                dnan = tab[torch.clamp(nrand, 1, rtab).long()]
                wp_new = torch.where(redraw, sig * dnan, wp_new)
            else:
                wp_new = torch.where(nonfin, sig * dmain, wp_new)
            delz = wp_new * dtf
            # dtftlw >= 0.5: the exact-OU normalised update on the raw wp
            wp_q = (rw * wp + rnd_w[i] * rnd_exact
                    + turb.tlw * (1.0 - rw)
                    * (turb.dsigwdz + rhoaux * turb.sigw)) * icbtf
            wp_new = torch.where(use_lin, wp_new, wp_q)
            delz = torch.where(use_lin, delz, wp_q * turb.sigw * dtf)
        elif cfg.turbswitch:
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
        if cfg.turboff:
            wp_new = torch.zeros_like(wp_new)
            delz = torch.zeros_like(delz)
        z, icbt = _reflect_pbl(z, delz, h)
        wp = wp_new
        if i != cfg.ifine - 1:
            turb = turb_fn(z, h, ust, wst, ol)   # hanna_short refresh
    return z, wp, icbt, turb, nan_mask, nrand


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 toward zero, saturating, NaN -> 0: the conversion
    the kernels make (``__float2int_rz``); a bare ``.to(int32)`` of a value
    out of range is undefined on the CPU."""
    big = x >= 2147483648.0
    small = x <= -2147483648.0
    safe = torch.where(big | small | torch.isnan(x), torch.zeros_like(x), x)
    out = safe.to(torch.int32)
    out = torch.where(big, torch.full_like(out, 2147483647), out)
    return torch.where(small, torch.full_like(out, -2147483648), out)


def _ldt_formula(cfg: StepConfig, a: "AdvanceArgs", turb, wp, h):
    """The next adaptive step: ldt = trunc(min(...) * ctl), at least
    mintime (advance.f90:504-510)."""
    if cfg.turbswitch:
        lim = torch.minimum(
            torch.minimum(turb.tlw,
                          h / torch.clamp(2.0 * torch.abs(wp * turb.sigw),
                                          min=1e-5)),
            _scalar_div(0.5, torch.clamp(torch.abs(turb.dsigwdz), min=1e-10)))
    else:
        lim = torch.minimum(turb.tlw,
                            h / torch.clamp(2.0 * torch.abs(wp), min=1e-5))
    return torch.clamp(torch.trunc(lim * a.ctl), min=a.mintime)


def _initial_idt(cfg: StepConfig, a: "AdvanceArgs", turb, wp, h, pbl):
    """The first adaptive step of a newly released particle
    (initialize.f90:155-162,191): the ldt formula at its start, capped by
    600 s in the hanna1 form; the whole interval above the boundary layer."""
    if cfg.turbswitch:
        lim = torch.minimum(
            torch.minimum(turb.tlw,
                          h / torch.clamp(2.0 * torch.abs(wp * turb.sigw),
                                          min=1e-5)),
            _scalar_div(0.5, torch.clamp(torch.abs(turb.dsigwdz), min=1e-10)))
    else:
        lim = torch.clamp(
            torch.minimum(turb.tlw,
                          h / torch.clamp(2.0 * torch.abs(wp), min=1e-5)),
            max=600.0)
    idt = torch.clamp(torch.trunc(lim * a.ctl), min=a.mintime)
    return _f32_to_i32(torch.where(pbl, idt, torch.full_like(idt, a.dt)))


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
    (low parts zeroed), every other particle's untouched; and the mask of
    the particles the update moved (None without the caps)."""
    if not cfg.polar:
        return x_hi, x_lo, y_hi, y_lo, None
    xg, yg, north, south = _polar_update(a, x, y, dxs, dys)
    pol = north | south
    zero = torch.zeros_like(x_lo)
    return (torch.where(pol, xg, x_hi), torch.where(pol, zero, x_lo),
            torch.where(pol, yg, y_hi), torch.where(pol, zero, y_lo), pol)


def _check_draws(draws: dict | None, n: int, device, cfg: StepConfig) -> int:
    """Check injected draws against the shapes the advance reads; return
    the passes they cover (the adaptive step's leading axis of its per-pass
    tags; 0 without draws)."""
    if draws is None:
        return 0
    passes = None
    per_pass = pass_tags(cfg)
    for tag, rows in draw_tags(cfg).items():
        d = draws.get(tag)
        want = (rows, n) if rows else (n,)
        if d is not None and cfg.method == 1 and tag in per_pass:
            k = d.shape[0] if d.dim() == 3 else -1
            passes = k if passes is None else min(passes, k)
            want = (k,) + want
        if d is None or tuple(d.shape) != want \
                or d.device != torch.device(device) \
                or d.dtype != torch.float32 or (passes is not None
                                                and passes < 1):
            got = "none" if d is None else \
                f"{d.dtype} {tuple(d.shape)} on {d.device}"
            raise ValueError(f"injected draws for tag {tag}: expected "
                             f"float32 {want} on {device}, got {got}")
    return passes or 0


def settle_met(z0: ZFields, cfg: StepConfig):
    """The two fields settling reads, the temperature and the air density
    of the interval's first met time, or None without settling."""
    if not cfg.settling:
        return None
    return z0.f3d[F3_TT], z0.f3d[F3_RHO]


def _as_tuple(zn) -> tuple:
    if zn is None:
        return ()
    return tuple(zn) if isinstance(zn, (tuple, list)) else (zn,)


def advance_all(p: Particles, z0: ZFields, z1: ZFields, itime: int,
                memtime0: int, memtime1: int, key: rng.Key,
                cfg: StepConfig, prm: StepParams,
                tables: StepTablesQuad | None = None,
                draws: dict | None = None, offset: int = 0,
                z0n=None, z1n=None, tables_n=None,
                leg: LegacyRnd | None = None, tile: Tile | None = None):
    """Advance every scheduled particle by one lsynctime interval: K4 (the
    fixed step) or K11 (the adaptive step) for particles on a CUDA device,
    the plain version for particles on the CPU.

    ``offset`` is the global index of particle 0 (the draw counter);
    ``tables`` may be shared across chunks (``advance_chunked`` does).
    ``z0n``, ``z1n``: the nests' fields at the two met times, one per
    ``cfg.nests`` entry, outermost first (``tables_n`` their quad tables,
    built here when absent: K2 once per nest).  ``leg``: the legacy-RNG
    validation draws (``core/legacy.py``), which no kernel takes: CPU
    tensors only.  ``tile``: with ``cfg.tile_mode``, the rank's tile, whose
    fields ``z0``, ``z1`` are (K4 ``TILE``, K11 ``TILE``).  Returns
    (particles, StepDiag); exited particles get active=False."""
    cfg.check()
    dev = p.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no advance backend for device {dev}")
    zn0, zn1 = _as_tuple(z0n), _as_tuple(z1n)
    if len(zn0) != len(cfg.nests) or len(zn1) != len(cfg.nests):
        raise ValueError(f"{len(cfg.nests)} nests configured, fields for "
                         f"{len(zn0)} and {len(zn1)} given")
    tw0, tw1, ew0, ew1, _ = _time_weights(itime, memtime0, memtime1, prm,
                                          cfg)
    a = advance_args(cfg, prm, itime, memtime0, memtime1, tile)
    if leg is not None:
        if dev.type == "cuda":
            raise NotImplementedError(
                "the legacy-RNG validation path (leg) has no kernel: run it "
                "on CPU tensors (Simulation(legacy_rng=True, device='cpu'))")
        if cfg.nests or cfg.tile_mode:
            raise ValueError("legacy RNG mode does not support nests or "
                             "tiles")
        if cfg.cblflag and cfg.method == 1:
            raise NotImplementedError(
                "matched-RNG CBL validation is fixed-step only (the "
                "adaptive legacy chase assumes static in-loop consumption)")
        if draws is not None:
            raise ValueError("the legacy path draws from its table; "
                             "injected draws do not apply")
        # legacy_quad: the production interpolation, through K2's tables
        if cfg.legacy_quad and tables is None:
            tables = build_step_tables_quad(z0, z1, tw0, tw1, ew0, ew1,
                                            dtype=cfg.table_dtype)
        return advance_all_plain(
            p, z0.height, tables if cfg.legacy_quad else None, a, key, cfg,
            None, offset, settle_met(z0, cfg),
            legacy=(leg, z0, z1, (tw0, tw1, ew0, ew1)))
    if tables is None:
        tables = build_step_tables_quad(z0, z1, tw0, tw1, ew0, ew1,
                                        dtype=cfg.table_dtype)
    if tables_n is None:
        tables_n = tuple(build_step_tables_quad(zn0[k], zn1[k], tw0, tw1,
                                                ew0, ew1,
                                                dtype=cfg.table_dtype)
                         for k in range(len(cfg.nests)))
    if dev.type == "cuda":
        run = advance_adaptive_cuda if cfg.method == 1 else advance_all_cuda
    else:
        run = advance_all_plain
    return run(p, z0.height, tables, a, key, cfg, draws, offset,
               settle_met(z0, cfg), tables_n=tuple(tables_n))


def _check_inputs(p: Particles, height, tables, cfg: StepConfig, settle,
                  fields, what: str, a: "AdvanceArgs") -> None:
    """The kernels' inputs: contiguous tensors of the right type and shape
    on the particles' device."""
    n = p.capacity
    dev = p.device
    i32 = torch.int32
    want = {"itra": i32, "itramem": i32, "idt": i32, "cbt": torch.int8,
            "active": torch.bool}
    for name in fields:
        t = getattr(p, name)
        dt = want.get(name, torch.float32)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape != (n,):
            raise ValueError(f"{what}: particle field {name} must be "
                             f"contiguous {dt} ({n},) on {dev}")
    tny, tnx = a.tile_ny, a.tile_nx       # the grid's, or the tile's
    r = (cfg.nz - 1) * tny * tnx
    for name, lanes in (("rows", ROWS_LANES), ("rowsE", ROWS_E_LANES)):
        t = getattr(tables, name)
        if t.device != dev or t.dtype != cfg.table_dtype \
                or t.shape != (r, lanes) or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: table {name} must be contiguous, "
                             f"16-byte aligned {cfg.table_dtype} ({r}, "
                             f"{lanes}) on {dev}")
    if height.device != dev or height.dtype != torch.float32 \
            or height.shape != (cfg.nz,) or not height.is_contiguous():
        raise ValueError(f"{what}: height must be float32 ({cfg.nz},) on "
                         f"{dev}")
    if cfg.settling:
        if settle is None:
            raise ValueError(f"{what}: settling needs the temperature and "
                             "density fields (settle_met)")
        for t in settle:
            if t.device != dev or t.dtype != torch.float32 \
                    or t.shape != (cfg.nz, tny, tnx) \
                    or not t.is_contiguous():
                raise ValueError(f"{what}: settling fields must be "
                                 f"contiguous float32 ({cfg.nz}, {tny}, "
                                 f"{tnx}) on {dev}")
        m0 = p.mass0
        if m0.device != dev or m0.dtype != torch.float32 \
                or not m0.is_contiguous() or m0.dim() != 2 \
                or m0.shape[0] != n:
            raise ValueError(f"{what}: mass0 must be contiguous float32 "
                             f"({n}, nspec) on {dev}")


def _settle_ptrs(p: Particles, a: AdvanceArgs, settle):
    """(mass0, temperature, density) pointers for the kernels, NULL without
    settling."""
    if not a.settling:
        return None, None, None
    if p.nspec != a.nspec:
        raise ValueError(f"{p.nspec} species of mass, {a.nspec} of settling "
                         "parameters")
    return p.mass0.data_ptr(), settle[0].data_ptr(), settle[1].data_ptr()


def _check_nest_tables(tables_n, cfg: StepConfig, dev, what: str) -> None:
    """The nests' quad tables: one per nest, of the nest's shape."""
    if len(tables_n) != len(cfg.nests):
        raise ValueError(f"{what}: {len(cfg.nests)} nests, {len(tables_n)} "
                         "nest tables")
    for t, (nnx, nny) in zip(tables_n, cfg.nests):
        r = (cfg.nz - 1) * nny * nnx
        for name, lanes in (("rows", ROWS_LANES), ("rowsE", ROWS_E_LANES)):
            tt = getattr(t, name)
            if tt.device != dev or tt.dtype != cfg.table_dtype \
                    or tt.shape != (r, lanes) or not tt.is_contiguous() \
                    or tt.data_ptr() % 16:
                raise ValueError(f"{what}: nest table {name} must be "
                                 f"contiguous, 16-byte aligned "
                                 f"{cfg.table_dtype} ({r}, {lanes}) on {dev}")


def advance_all_cuda(p: Particles, height: torch.Tensor,
                     tables: StepTablesQuad, a: AdvanceArgs, key: rng.Key,
                     cfg: StepConfig, draws: dict | None, offset: int,
                     settle=None, tables_n=()):
    """K4 launch: the whole fixed-step advance of all ``p.capacity``
    particles in one kernel, out of place.  ``draws`` None: the kernel makes
    its draws in registers from ``key``; else it reads the injected
    (rows, n) arrays.  ``settle``: ``settle_met``'s fields (K4's
    ``SETTLING`` instantiation).  ``tables_n``: the nests' quad tables,
    outermost first (K4's ``NESTS`` instantiation, at most
    ``MAX_NESTS``).  With ``cfg.cblflag`` K4's ``CBL`` instantiation runs
    the skewed boundary layer (turbswitch on or off) and counts its NaN
    redraws; it makes its draws in registers only.  Any turbulence takes
    settling, nests or a tile (``_build.ENTRIES`` counts each cross)."""
    if cfg.method != 0:
        raise ValueError("K4 is the fixed step; the adaptive step is K11 "
                         "(advance_adaptive_cuda)")
    _check_cbl(cfg, draws, "K4")
    if len(cfg.nests) > MAX_NESTS:
        raise ValueError(f"K4 takes at most MAX_NESTS = {MAX_NESTS} nests, "
                         f"not {len(cfg.nests)}")
    n = p.capacity
    dev = p.device
    i32 = torch.int32
    if n >= 2 ** 31:
        raise ValueError("K4 indexes particles with int32")
    _check_inputs(p, height, tables, cfg, settle, _IN_FIELDS, "K4", a)
    _check_nest_tables(tables_n, cfg, dev, "K4")
    _check_draws(draws, n, dev, cfg)
    zero = torch.zeros((), dtype=i32, device=dev)
    if n == 0:
        return p, StepDiag(n_active=zero, n_exited=zero, nan_count=zero)

    a.n = n
    a.offset = offset
    for s, tag in enumerate(DRAW_TAGS):
        a.key[2 * s], a.key[2 * s + 1] = key.philox_key(tag)
    set_cbl_keys(a, key, cfg)
    for k, t in enumerate(tables_n):
        a.nest_rows[k] = t.rows.data_ptr()
        a.nest_rows_e[k] = t.rowsE.data_ptr()
    if draws is None:
        injected = [None] * len(DRAW_TAGS)
    else:
        held = [draws[tag].contiguous() for tag in DRAW_TAGS]
        injected = [d.data_ptr() for d in held]
    out = {f: torch.empty_like(getattr(p, f)) for f in OUT_FIELDS}
    # active, exited, the CBL's NaN redraws and its queue's length
    counts = torch.zeros(K4_COUNT_WORDS, dtype=i32, device=dev)
    queue = k4_cbl_queue(n, dev) if cfg.cblflag else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        k4_entry(cfg)(*(getattr(p, f).data_ptr() for f in _IN_FIELDS),
                      *(out[f].data_ptr() for f in OUT_FIELDS),
                      *injected, tables.rows.data_ptr(),
                      tables.rowsE.data_ptr(), height.data_ptr(),
                      *_settle_ptrs(p, a, settle),
                      counts.data_ptr(), ctypes.addressof(a),
                      None if queue is None else queue.data_ptr(), stream)
    return p.replace(**out), StepDiag(
        n_active=counts[0], n_exited=counts[1], nan_count=counts[2],
        deferred=counts[3] if cfg.cblflag else None)


# K4's counts (int32): active, exited, the CBL's NaN redraws, the CBL's
# queue length
K4_COUNT_WORDS = 4
# the words of an entry of K4 CBL's queue (csrc/advance.cu's QUEUE_WORDS)
K4_CBL_QUEUE_WORDS = 11


def k4_cbl_queue(n: int, device) -> torch.Tensor:
    """K4 CBL's scratch: the queue of the particles whose substeps take the
    skewed branch (in the skewed zone, -h/L > CBL_ZONE, with dtf / TL_w <
    0.5 from the start's turbulence), K4_CBL_QUEUE_WORDS rows of ``n``
    words: room for every particle, since which of them go is known only
    on the card."""
    return torch.empty((K4_CBL_QUEUE_WORDS, n), dtype=torch.float32,
                       device=device)


def k4_cbl_deferred(p: Particles, height: torch.Tensor,
                    tables: StepTablesQuad, cfg: StepConfig,
                    a: AdvanceArgs) -> torch.Tensor:
    """(n,) bool: the particles whose substeps take the skewed branch, which
    K4 CBL's start defers to its skewed launch, by the plain rule of that
    branch (flexpart_tpu/core/advance.py:321-381): scheduled, in the
    boundary layer (z / h <= 1), in the skewed zone (-h/L > CBL_ZONE) and
    on the linear form (dtf / TL_w < 0.5, TL_w of the start's turbulence in
    Hanna's turbswitch form, whatever turbswitch).  The grid's own tables:
    no nests, no tile."""
    hw = horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, dz1 = vert_weights(p.z, height)
    h, _, ust, wst, ol, _ = sample_all_quad(tables, hw, indz, dz1, p.x, p.y,
                                            cfg.nx, cfg.ny)
    pbl = p.active & ((p.z / h) <= 1.0)
    zone = (-h / ol) > CBL_ZONE
    lin = _scalar_div(a.dtf, hanna(p.z, h, ust, wst, ol).tlw) < 0.5
    return pbl & zone & lin


def k4_entry(cfg: StepConfig):
    """What counts a K4 launch of ``cfg``: the entry of its cross (K4 CBL,
    K4 TILE x CBL, K4 TS with settling, nests or a tile, K4 TILE), else
    the kernel."""
    if cfg.cblflag:
        return _build.ADVANCE_TILE_CBL if cfg.tile_mode else _build.ADVANCE_CBL
    if cfg.turbswitch and (cfg.tile_mode or cfg.settling or cfg.nests):
        return _build.ADVANCE_TS_CROSS
    return _build.ADVANCE_TILE if cfg.tile_mode else _build.ADVANCE


def _check_cbl(cfg: StepConfig, draws: dict | None, what: str) -> None:
    """What K4's and K11's CBL refuse, before any tensor is read: injected
    draws (its substeps make theirs in registers; the plain version, on
    CPU tensors, takes them) and more than MAX_CBL_SUBSTEPS substeps."""
    if not cfg.cblflag:
        return
    if draws is not None:
        raise ValueError(f"{what} with cblflag makes its draws in "
                         "registers: injected draws are read by the plain "
                         "version (particles on the CPU)")
    if cfg.ifine > MAX_CBL_SUBSTEPS:
        raise ValueError(f"{what} with cblflag takes at most "
                         f"MAX_CBL_SUBSTEPS = {MAX_CBL_SUBSTEPS} substeps, "
                         f"not ifine = {cfg.ifine}")


# K11's particle fields: K4's and the adaptive step memory idt
ADAPTIVE_IN_FIELDS = _IN_FIELDS + ("idt",)
ADAPTIVE_OUT_FIELDS = OUT_FIELDS + ("idt",)
K11_WORK_WORDS = 3        # K11's work counters, unsigned 64-bit words


def set_cbl_keys(a: AdvanceArgs, key: rng.Key, cfg: StepConfig) -> None:
    """The Philox keys of the CBL's draws: tags 7 and 8 (a fresh particle's
    uniform and normal) and 40 + i (the redraw of substep i), for K4's and
    K11's CBL (their wrappers refuse more than MAX_CBL_SUBSTEPS substeps
    first, ``_check_cbl``)."""
    if not cfg.cblflag:
        return
    for s, tag in enumerate(CBL_FRESH_TAGS):
        a.key_fresh[2 * s], a.key_fresh[2 * s + 1] = key.philox_key(tag)
    for i in range(cfg.ifine):
        a.key_cbl[2 * i], a.key_cbl[2 * i + 1] = \
            key.philox_key(CBL_TAG0 + i)


def advance_adaptive_cuda(p: Particles, height: torch.Tensor,
                          tables: StepTablesQuad, a: AdvanceArgs,
                          key: rng.Key, cfg: StepConfig, draws: dict | None,
                          offset: int, settle=None, tables_n=()):
    """K11 launch: the whole adaptive-step advance of all ``p.capacity``
    particles in one kernel, out of place: a block starts and ends 256
    particles and, between, deals the ones still in the boundary layer's
    loop to its first lanes, one pass each, until none is left; the draws
    are made in registers (the per-pass tags with the pass in the Philox
    counter).  With ``cfg.cblflag`` K11's ``CBL`` instantiation runs the
    skewed boundary layer (turbswitch on, as ``Command`` sets it) and
    counts its NaN redraws, with turbswitch on (as ``Command`` sets it) or
    off (a uniform branch: hanna1 for the fresh state and the first step,
    hanna1's step formula).  K11 reads no injected draws: ``draws`` must
    be None (the plain version takes them)."""
    if cfg.method != 1:
        raise ValueError("K11 is the adaptive step; the fixed step is K4 "
                         "(advance_all_cuda)")
    if tables_n:
        raise ValueError("K11 takes no nests (the adaptive step refuses "
                         "them)")
    _check_cbl(cfg, draws, "K11")
    if draws is not None:
        raise ValueError("K11 makes its draws in registers; injected draws "
                         "are read by the plain version (particles on the "
                         "CPU)")
    n = p.capacity
    dev = p.device
    i32 = torch.int32
    if n >= 2 ** 31:
        raise ValueError("K11 indexes particles with int32")
    _check_inputs(p, height, tables, cfg, settle, ADAPTIVE_IN_FIELDS, "K11",
                  a)
    zero = torch.zeros((), dtype=i32, device=dev)
    out = {f: torch.empty_like(getattr(p, f)) for f in ADAPTIVE_OUT_FIELDS}
    t_below = torch.empty(n, dtype=torch.float32, device=dev)
    passes = torch.empty(n, dtype=i32, device=dev)
    if n == 0:
        return p, StepDiag(n_active=zero, n_exited=zero, nan_count=zero,
                           t_below=t_below, passes=passes)
    a.n = n
    a.offset = offset
    for s, tag in enumerate(DRAW_TAGS):
        a.key[2 * s], a.key[2 * s + 1] = key.philox_key(tag)
    set_cbl_keys(a, key, cfg)
    counts = torch.zeros(2, dtype=i32, device=dev)
    # the passes executed, the lane iterations issued and the NaN redraws
    # of the CBL (u64)
    work = torch.zeros(K11_WORK_WORDS, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel = (_build.ADVANCE_ADAPTIVE if not cfg.tile_mode
                  else _build.ADVANCE_ADAPTIVE_TILE_CBL if cfg.cblflag
                  else _build.ADVANCE_ADAPTIVE_TILE)
        kernel(
            *(getattr(p, f).data_ptr() for f in ADAPTIVE_IN_FIELDS),
            *(out[f].data_ptr() for f in ADAPTIVE_OUT_FIELDS),
            t_below.data_ptr(), passes.data_ptr(),
            tables.rows.data_ptr(), tables.rowsE.data_ptr(),
            height.data_ptr(), *_settle_ptrs(p, a, settle),
            counts.data_ptr(), work.data_ptr(), ctypes.addressof(a), stream)
    return p.replace(**out), StepDiag(
        n_active=counts[0], n_exited=counts[1],
        nan_count=work[2].to(i32), t_below=t_below, passes=passes,
        lane_work=work)


def _adaptive_interval_plain(cfg: StepConfig, a: AdvanceArgs, tables, hw,
                             height, h, tropop, ust, wst, ol, z, up, vp, wp,
                             icbt, idt, pbl0, scheduled, settle, draw,
                             draw_pass, inject_passes: int, legacy=None):
    """The adaptive interval (method=1; advance.f90:276-720;
    ``_adaptive_interval`` of the JAX package): a loop of passes that ends
    when no particle is active in it.  A particle is active while it is
    scheduled, started in the boundary layer, has time left and is not
    above h; each pass re-samples u, v, w, rho and drhodz at its z in the
    frozen horizontal stencil (``wind10_quad``), advances the horizontal OU
    velocities and the ifine vertical substeps with the pass's draws (with
    the CBL its redraws too, tags 40 + i), picks the next step, settles,
    clamps at the top, counts the time below 2 HREF before the ground
    reflection and reflects.  A particle that rose above h, or started
    above it, finishes the interval with one free-troposphere step.  Each
    pass computes every particle and keeps the results of the active
    ones, as JAX's masked loop does.

    ``legacy`` = (LegacyRnd, z0, z1, tw0, tw1): the matched-RNG path, whose
    draws come from the table through a per-particle cursor (the wrap
    checks of advance.f90 included) and whose met is interpolated per time
    level, or with ``cfg.legacy_quad`` sampled from the quad tables as the
    production path samples it.  Returns a dict of the interval's results, ``nan_count`` the
    CBL's NaN redraws of active particles summed over the passes."""
    n = z.shape[0]
    dev = z.device
    turb_fn = hanna if (cfg.turbswitch or cfg.cblflag) else hanna1
    f32t = torch.float32
    lsync = torch.full((n,), a.dt, dtype=f32t, device=dev)
    zero = torch.zeros(n, dtype=f32t, device=dev)
    legacy_interp = legacy is not None and not cfg.legacy_quad
    if legacy is not None:
        leg, lz0, lz1, ltw0, ltw1 = legacy
        tab = leg.table
        rtab = tab.shape[0] - 1
        nrand = leg.nrand.to(torch.int64)
    if legacy_interp:
        def vert_wind(zc):
            indz, dz1 = vert_weights(zc, height)
            return vert_wind_legacy(lz0, lz1, hw, indz, dz1, ltw0, ltw1)
    else:
        def vert_wind(zc):
            indz, dz1 = vert_weights(zc, height)
            return wind10_quad(tables.rows, hw, indz, dz1, a.tile_nx,
                               a.tile_ny)
    st = dict(remaining=torch.where(pbl0, lsync, zero),
              ldt=torch.clamp(idt.to(f32t), min=a.mintime),
              z=z, up=up, vp=vp, wp=wp, icbt=icbt,
              u=zero, v=zero, w=zero, daw=zero, dcw=zero, dxs=zero,
              dys=zero, t_below=zero)
    passes = torch.zeros(n, dtype=torch.int32, device=dev)
    nan_count = torch.zeros((), dtype=torch.int32, device=dev)
    htop = height[-1] - a.htop_eps
    k = 0
    while True:
        act = scheduled & pbl0 & (st["remaining"] > 0.0) & (st["z"] <= h)
        if not bool(act.any()):
            break
        if inject_passes and k >= inject_passes:
            raise ValueError(f"injected draws cover {inject_passes} passes; "
                             f"{int(act.sum())} particles need more")
        dt_i = torch.where(act, torch.minimum(st["ldt"], st["remaining"]),
                           zero)
        u, v, w, rhoa, drho = vert_wind(st["z"])
        turb = turb_fn(st["z"], h, ust, wst, ol)
        if legacy is not None:
            # advance.f90:369-384 then :391-398, the cursor's wrap checks
            nr = wrap(nrand, 1, rtab)
            rh = torch.stack([tab[nr], tab[nr + 1]], 0)
            nr = wrap(nr + 2, cfg.ifine, rtab)
            rw_k = torch.stack([tab[nr + 1 + i] for i in range(cfg.ifine)],
                               0)
            nrand3 = nr + cfg.ifine + 1
        else:
            rh = draw_pass(1, k)
            rw_k = draw_pass(2, k)
        up2 = _ou_update(st["up"], rh[0], turb.sigu, dt_i / turb.tlu)
        vp2 = _ou_update(st["vp"], rh[1], turb.sigv, dt_i / turb.tlv)
        z2, wp2, icbt2, turb_f, nm, _ = _pbl_vertical(
            cfg, st["z"], st["wp"], st["icbt"], h, ust, wst, ol, rhoa, drho,
            rw_k, dt_i * a.fine,
            cbl_draw=lambda i, k=k: draw_pass(CBL_TAG0 + i, k))
        nan_count = nan_count + (nm & act).sum(dtype=torch.int32)
        ldt2 = _ldt_formula(cfg, a, turb_f, wp2, h)
        w_eff = w if settle is None else w + settle(st["z"])
        z3 = z2 + w_eff * dt_i * a.ldirf
        z3 = torch.minimum(z3, htop)
        # the deposition window (advance.f90:582-599): after the vertical
        # update, before the ground reflection
        t_below2 = st["t_below"] + torch.where(z3 < 2.0 * 15.0, dt_i, zero)
        z3 = torch.where(z3 < 0.0, torch.minimum(h - 1e-9, -z3), z3)
        new = dict(remaining=torch.clamp(st["remaining"] - dt_i, min=0.0),
                   ldt=ldt2, z=z3, up=up2, vp=vp2, wp=wp2, icbt=icbt2,
                   u=u, v=v, w=w_eff, daw=st["daw"] + up2 * dt_i,
                   dcw=st["dcw"] + vp2 * dt_i, dxs=st["dxs"] + u * dt_i,
                   dys=st["dys"] + v * dt_i, t_below=t_below2)
        # every field of the carry is taken where the particle is active,
        # kept where it is not (the JAX loop's sel)
        for f, val in new.items():
            st[f] = torch.where(act, val, st[f])
        if legacy is not None:
            nrand = torch.where(act, nrand3, nrand)
        passes = passes + act.to(torch.int32)
        k += 1

    # ---- free-troposphere completion (advance.f90:629-708, goto 700):
    # particles that started above the boundary layer (the whole interval)
    # or left it with time to spare
    zc = st["z"]
    dt_ft = torch.where(pbl0, st["remaining"], lsync)
    ft = dt_ft > 0.0
    u_f, v_f, w_f, _, _ = vert_wind(zc)
    in_trop = zc < tropop
    in_trans = (~in_trop) & (zc < tropop + 1000.0)
    dt_s = torch.clamp(dt_ft, min=1e-6)
    c_trop = _scalar_div(a.two_d_trop, dt_s)
    c_strat = _scalar_div(a.two_d_strat, dt_s)
    weight = torch.clamp(true_div(zc - tropop, 1000.0), 0.0, 1.0)
    uxscale_tr = torch.sqrt(c_trop * (1.0 - weight))
    wpscale_tr = torch.sqrt(c_strat * weight)
    if legacy is not None:
        t_b = wrap(nrand, 1, rtab)
        tr_b = wrap(nrand, 2, rtab)
        s_b = wrap(nrand, 0, rtab)
        rft = torch.stack([
            torch.where(in_trans, tab[tr_b], tab[t_b]),
            torch.where(in_trans, tab[tr_b + 1], tab[t_b + 1]),
            torch.where(in_trans, tab[tr_b + 2], tab[s_b])], 0)
        nrand_ft = torch.where(in_trop, t_b + 2,
                               torch.where(in_trans, tr_b + 3, s_b + 1))
        nrand = torch.where(ft, nrand_ft, nrand)
    else:
        rft = draw(3)
    ux = torch.where(in_trop, rft[0] * torch.sqrt(c_trop),
                     torch.where(in_trans, rft[0] * uxscale_tr, zero))
    vy = torch.where(in_trop, rft[1] * torch.sqrt(c_trop),
                     torch.where(in_trans, rft[1] * uxscale_tr, zero))
    wp_ft = torch.where(in_trop, zero,
                        torch.where(in_trans,
                                    rft[2] * wpscale_tr + a.d_strat_1000,
                                    rft[2] * torch.sqrt(c_strat)))
    if cfg.turboff:
        ux, vy, wp_ft = zero, zero, zero
    w_eff_f = w_f if settle is None else w_f + settle(zc)
    dxs = torch.where(ft, st["dxs"] + (u_f + ux) * dt_ft, st["dxs"])
    dys = torch.where(ft, st["dys"] + (v_f + vy) * dt_ft, st["dys"])
    z_ft = zc + (w_eff_f + wp_ft) * dt_ft * a.ldirf
    z_ft = torch.where(z_ft < 0.0, torch.minimum(h - 1e-9, -z_ft), z_ft)
    ldt = torch.where(ft, torch.clamp(dt_ft, min=a.mintime), st["ldt"])
    zc = torch.where(ft, z_ft, zc)

    # ---- the mesoscale sigmas at the final z (advance.f90:601-605) and,
    # in the legacy path, the mesoscale draws from the cursor
    indz_f, dz1_f = vert_weights(zc, height)
    rnd_m = None
    if legacy_interp:
        wind_e, sig16 = interp_wind_legacy(lz0, lz1, hw, indz_f, dz1_f,
                                           ltw0, ltw1)
        sig = [torch.where(ft, s16, s8) for s16, s8 in
               zip(sig16, (wind_e.usig, wind_e.vsig, wind_e.wsig))]
    else:
        rowid = _cell_rowid(hw, indz_f, a.tile_nx, a.tile_ny)
        g = tables.rows[rowid][:, 60:63].to(f32t)
        sig = [g[:, 0], g[:, 1], g[:, 2]]
    if legacy is not None:
        mb = wrap(nrand, 2, rtab)
        rnd_m = torch.stack([tab[mb], tab[mb + 1], tab[mb + 2]], 0)
    return dict(z=zc, up=st["up"], vp=st["vp"],
                wp=torch.where(ft, wp_ft, st["wp"]), icbt=st["icbt"],
                idt=_f32_to_i32(ldt), dxs=dxs, dys=dys, daw=st["daw"],
                dcw=st["dcw"], u=torch.where(ft, u_f, st["u"]),
                v=torch.where(ft, v_f, st["v"]),
                w=torch.where(ft, w_eff_f, st["w"]),
                usig=sig[0], vsig=sig[1], wsig=sig[2],
                t_below=st["t_below"], passes=passes, nan_count=nan_count,
                rnd_m=rnd_m)


def nest_index(cfg: StepConfig, a: AdvanceArgs, x, y) -> torch.Tensor:
    """Per particle the innermost nest whose window holds it (the last
    match of the outermost-first scan, advance.f90:167-175 scanning
    j=numbnests,1,-1), -1 for the mother grid."""
    idx = torch.full(x.shape, -1, dtype=torch.int32, device=x.device)
    for k in range(len(cfg.nests)):
        idx = torch.where(_in_nest(a, k, x, y),
                          torch.full_like(idx, k), idx)
    return idx


def _in_nest(a: AdvanceArgs, k: int, x, y):
    """Inside nest k's window shrunk by eps = nx / 3e5 (float32 sums, as
    the reference's)."""
    eps = f32(a.eps_nest)
    return ((x > float(f32(a.xln[k]) + eps))
            & (x < float(f32(a.xrn[k]) - eps))
            & (y > float(f32(a.yln[k]) + eps))
            & (y < float(f32(a.yrn[k]) - eps)))


def _nest_coords(a: AdvanceArgs, k: int, x, y):
    """Nest k's grid coordinates of mother-grid (x, y), clamped to
    [0, n - 1.001]."""
    xt = torch.clamp((x - a.xln[k]) * a.xresoln[k], 0.0, a.nest_xmax[k])
    yt = torch.clamp((y - a.yln[k]) * a.yresoln[k], 0.0, a.nest_ymax[k])
    return xt, yt


def _sample_nests(cfg: StepConfig, a: AdvanceArgs, tables_n, x, y, indz,
                  dz1, met):
    """The nests' met for the particles in their windows, outermost first,
    so that the innermost nest that holds a particle wins
    (advance.f90:161-175): ``met`` = (h, tropop, ust, wst, ol, wind) of the
    mother, returned with the selected values."""
    h, tropop, ust, wst, ol, wind = met
    for k, (nnx, nny) in enumerate(cfg.nests):
        inn = _in_nest(a, k, x, y)
        xt, yt = _nest_coords(a, k, x, y)
        hw_n = horiz_weights(xt, yt, nnx, nny, False)
        h_n, trop_n, ust_n, wst_n, ol_n, wind_n = sample_all_quad(
            tables_n[k], hw_n, indz, dz1, xt, yt, nnx, nny)
        h = torch.where(inn, h_n, h)
        tropop = torch.where(inn, trop_n, tropop)
        ust = torch.where(inn, ust_n, ust)
        wst = torch.where(inn, wst_n, wst)
        ol = torch.where(inn, ol_n, ol)
        for f in dataclasses.fields(wind):
            setattr(wind, f.name, torch.where(inn, getattr(wind_n, f.name),
                                              getattr(wind, f.name)))
    return h, tropop, ust, wst, ol, wind


def _weights(cfg: StepConfig, a: AdvanceArgs, x, y) -> HorizWeights:
    """The corner and weights of a gather: the grid's, or in tile mode the
    tile's corner of the global position (``tile_weights``)."""
    if cfg.tile_mode:
        return tile_weights(x, y, a.tile_ox, a.tile_oy, a.tile_nx, a.tile_ny)
    return horiz_weights(x, y, cfg.nx, cfg.ny, cfg.xglobal)


def advance_all_plain(p: Particles, height: torch.Tensor,
                      tables: StepTablesQuad, a: AdvanceArgs, key: rng.Key,
                      cfg: StepConfig, draws: dict | None, offset: int,
                      settle=None, tables_n=(), legacy=None):
    """The plain PyTorch version of K4 and K11: the same function in eager
    tensor ops, both sides of every branch computed and selected.
    ``tables_n``: the nests' quad tables.  ``legacy`` = (LegacyRnd, z0, z1,
    (tw0, tw1, ew0, ew1)): the matched-RNG validation path
    (``core/legacy.py``), on the particles' device, CPU or card: its draws
    from the rannumb table, its met interpolated per time level, or with
    ``cfg.legacy_quad`` from ``tables`` as the production path samples it
    (the reference's ``legacy`` and ``legacy_interp``)."""
    n = p.capacity
    dev = p.device
    scheduled = p.active
    itime = a.itime
    rows = draw_tags(cfg)
    inject_passes = _check_draws(draws, n, dev, cfg)
    if cfg.settling and settle is None:
        raise ValueError("settling needs the temperature and density "
                         "fields (settle_met)")

    legacy_d = None          # the legacy path's draws from its table

    def draw(tag: int) -> torch.Tensor:
        if legacy_d is not None:
            return legacy_d[tag]
        if draws is not None:
            return draws[tag]
        shape = (rows[tag], n) if rows[tag] else (n,)
        return rng.normals(key, shape, tag, offset, device=dev)

    def draw_pass(tag: int, k: int) -> torch.Tensor:
        if draws is not None:
            return draws[tag][k]
        return rng.normals(key, (rows[tag], n), tag, offset, device=dev,
                           pass_index=k)

    x = p.x
    y = p.y
    z = p.z
    hw = _weights(cfg, a, x, y)
    indz, dz1 = vert_weights(z, height)
    leg = None
    legacy_interp = legacy is not None and not cfg.legacy_quad
    if legacy is not None:
        leg, lz0, lz1, (tw0, tw1, ew0, ew1) = legacy
    if legacy_interp:
        h, tropop, ust, wst, ol, wind, sig16 = sample_met_legacy(
            lz0, lz1, tw0, tw1, x, y, hw, indz, dz1)
    else:
        h, tropop, ust, wst, ol, wind = sample_all_quad(
            tables, hw, indz, dz1, x, y, a.tile_nx, a.tile_ny)
        if cfg.nests:
            h, tropop, ust, wst, ol, wind = _sample_nests(
                cfg, a, tables_n, x, y, indz, dz1,
                (h, tropop, ust, wst, ol, wind))
    u, v, w = wind.u, wind.v, wind.w

    dt = a.dt
    pbl = (z / h) <= 1.0
    htop = height[-1] - a.htop_eps
    in_trop = z < tropop
    in_trans = (~in_trop) & (z < tropop + 1000.0)
    turb_fn = hanna if cfg.turbswitch else hanna1
    settle_at = None
    if cfg.settling:
        settle_at = _settle_fn(cfg, a, x, y, height, settle[0], settle[1],
                               p.mass0)
    usig_w, vsig_w, wsig_w = wind.usig, wind.vsig, wind.wsig
    if leg is not None:
        legacy_d, (l_b2, l_ft_meso) = legacy_draws(leg, cfg.ifine, pbl,
                                                    in_trop, in_trans)
    if legacy_interp:
        # the 16-sample sigmas above the boundary layer
        # (interpol_wind.f90 against interpol_all.f90)
        usig_w = torch.where(pbl, usig_w, sig16[0])
        vsig_w = torch.where(pbl, vsig_w, sig16[1])
        wsig_w = torch.where(pbl, wsig_w, sig16[2])

    # -------- newly released particles (initialize.f90:110-219) --------
    fresh = scheduled & ((p.itramem == itime) | (itime == 0))
    rnd_i = draw(6)
    turb_i = turb_fn(z, h, ust, wst, ol)
    up_i = torch.where(pbl, rnd_i[0] * turb_i.sigu, rnd_i[0] * 0.3)
    vp_i = torch.where(pbl, rnd_i[1] * turb_i.sigv, rnd_i[1] * 0.3)
    if cfg.cblflag:
        # initialize.f90:139-150: the raw wp, from the skewed pdf in
        # strongly convective columns (initialize_cbl_vel.f90), Gaussian
        # times sigw elsewhere
        if leg is not None and leg.cbl_dcas is not None:
            dcas, dcas1 = leg.cbl_dcas, leg.cbl_dcas1
        elif draws is not None:
            dcas, dcas1 = draws[7], draws[8]
        else:
            dcas = rng.uniforms(key, n, 7, offset, device=dev)
            dcas1 = rng.normals(key, (n,), 8, offset, device=dev)
        wp_cbl = init_cbl_wp(dcas, dcas1, z, wst, h, turb_i.sigw,
                             turb_i.dsigwdz, ol, cfg.ldirect)
        wp_raw = torch.where((-h / ol) > CBL_ZONE, wp_cbl,
                             rnd_i[2] * turb_i.sigw)
    else:
        wp_raw = rnd_i[2] if cfg.turbswitch else rnd_i[2] * turb_i.sigw
    wp_i = torch.where(pbl, wp_raw, torch.zeros_like(wp_raw))
    if cfg.turboff:
        up_i, vp_i, wp_i = (torch.zeros_like(up_i), torch.zeros_like(vp_i),
                            torch.zeros_like(wp_i))
    # the legacy path draws the mesoscale memory from the full wind sigma
    # (initialize.f90:215-217), the production one from the OU process'
    # stationary sigma
    meso_f = 1.0 if leg is not None else a.turbmeso
    usig_i = rnd_i[3] * usig_w * meso_f
    vsig_i = rnd_i[4] * vsig_w * meso_f
    wsig_i = rnd_i[5] * wsig_w * meso_f
    p_up = torch.where(fresh, up_i, p.up)
    p_vp = torch.where(fresh, vp_i, p.vp)
    p_wp = torch.where(fresh, wp_i, p.wp)
    p_usig = torch.where(fresh, usig_i, p.usig)
    p_vsig = torch.where(fresh, vsig_i, p.vsig)
    p_wsig = torch.where(fresh, wsig_i, p.wsig)
    p_cbt = torch.where(fresh, torch.ones_like(p.cbt), p.cbt)
    p_idt = p.idt
    if cfg.method == 1:
        p_idt = torch.where(fresh, _initial_idt(cfg, a, turb_i, wp_i, h, pbl),
                            p.idt)

    ldirf = a.ldirf
    zero = torch.zeros_like(z)
    hm = h - 1e-9
    t_below = passes = None
    rnd_m = None
    if cfg.method == 1:
        # ------------ the adaptive interval (advance.f90:276-720) ---------
        res = _adaptive_interval_plain(
            cfg, a, tables, hw, height, h, tropop, ust, wst, ol, z, p_up,
            p_vp, p_wp, p_cbt, p_idt, pbl, scheduled, settle_at, draw,
            draw_pass, inject_passes,
            legacy=None if leg is None else (leg, lz0, lz1, tw0, tw1))
        z_new = torch.minimum(res["z"], htop)
        up_new, vp_new, wp_new = res["up"], res["vp"], res["wp"]
        icbt = res["icbt"]
        idt_new = res["idt"]
        dxsave, dysave = res["dxs"], res["dys"]
        dawsave, dcwsave = res["daw"], res["dcw"]
        if cfg.turboff:
            up_new, vp_new, dawsave, dcwsave = zero, zero, zero, zero
        # the last-interpolated wind (w with its settling) for windalign
        # and the corrector
        u_ref, v_ref, w_ref = res["u"], res["v"], res["w"]
        usig_w, vsig_w, wsig_w = res["usig"], res["vsig"], res["wsig"]
        settling = zero if settle_at is None else settle_at(z_new)
        # only a step of the whole interval takes the corrector (:829)
        pett_gate = idt_new.to(torch.float32) == dt
        t_below, passes = res["t_below"], res["passes"]
        nan_count = res["nan_count"]
        rnd_m = res["rnd_m"]
    else:
        # ---------------- fixed-step PBL branch (advance.f90:276-615) ---
        rnd_h = draw(1)
        rnd_w = draw(2)
        turb0 = turb_fn(z, h, ust, wst, ol)
        up_pbl = _ou_update(p_up, rnd_h[0], turb0.sigu,
                            _scalar_div(dt, turb0.tlu))
        vp_pbl = _ou_update(p_vp, rnd_h[1], turb0.sigv,
                            _scalar_div(dt, turb0.tlv))
        if cfg.turboff:
            up_pbl, vp_pbl = zero, zero

        z_pbl, wp_pbl, icbt, _, nan_mask, nrand_end = _pbl_vertical(
            cfg, z, p_wp, p_cbt, h, ust, wst, ol, wind.rho, wind.drhodz,
            rnd_w, a.dtf, cbl_draw=lambda i: draw(CBL_TAG0 + i),
            legacy_cbl=((leg.table, l_b2.to(torch.int64))
                        if (leg is not None and cfg.cblflag) else None))
        daw_pbl = up_pbl * dt
        dcw_pbl = vp_pbl * dt
        settling = zero if settle_at is None else settle_at(z)
        w_eff = w + settling

        dxs_pbl = u * dt
        dys_pbl = v * dt
        z_pbl = z_pbl + w_eff * dt * ldirf
        z_pbl = torch.minimum(z_pbl, htop)
        z_pbl = torch.where(z_pbl < 0.0, torch.minimum(hm, -z_pbl), z_pbl)

        # ------ free troposphere / stratosphere (advance.f90:629-708) ----
        rnd_ft = draw(3)
        weight = torch.clamp(true_div(z - tropop, 1000.0), 0.0, 1.0)
        uxscale_tr = torch.sqrt(a.c_trop * (1.0 - weight))
        wpscale_tr = torch.sqrt(a.c_strat * weight)

        ux = torch.where(in_trop, rnd_ft[0] * a.uxscale_t,
                         torch.where(in_trans, rnd_ft[0] * uxscale_tr, zero))
        vy = torch.where(in_trop, rnd_ft[1] * a.uxscale_t,
                         torch.where(in_trans, rnd_ft[1] * uxscale_tr, zero))
        wp_ft = torch.where(in_trop, zero,
                            torch.where(in_trans,
                                        rnd_ft[2] * wpscale_tr
                                        + a.d_strat_1000,
                                        rnd_ft[2] * a.wpscale_s))
        if cfg.turboff:
            ux, vy, wp_ft = zero, zero, zero

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
        pett_gate = None
        # the CBL's NaN redraws of scheduled boundary-layer particles (the
        # legacy path counts none, as the reference's)
        nan_count = ((nan_mask & scheduled & pbl).sum(dtype=torch.int32)
                     if leg is None else
                     torch.zeros((), dtype=torch.int32, device=dev))
        if leg is not None and cfg.cblflag:
            # with the CBL the reference skips the static advance after the
            # substeps (advance.f90:499): a boundary-layer particle's
            # mesoscale draws start at the last entry its chase consumed
            rtab = leg.table.shape[0] - 1
            mb = wrap(torch.where(pbl, nrand_end, l_ft_meso.to(torch.int64)),
                      2, rtab)
            rnd_m = torch.stack([leg.table[mb], leg.table[mb + 1],
                                 leg.table[mb + 2]], 0)

    # ------------ mesoscale fluctuations (advance.f90:720-738) ------------
    if rnd_m is None:
        rnd_m = draw(4)
    r, rs = a.r_meso, a.rs_meso
    usig_new = r * p_usig + rs * rnd_m[0] * usig_w * a.turbmeso
    vsig_new = r * p_vsig + rs * rnd_m[1] * vsig_w * a.turbmeso
    wsig_new = r * p_wsig + rs * rnd_m[2] * wsig_w * a.turbmeso
    if cfg.turboff:
        usig_new, vsig_new, wsig_new = zero, zero, zero
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
    x_hi, x_lo, y_hi, y_lo, pol = _apply_polar(cfg, a, x, y, dxsave, dysave,
                                               x_hi, x_lo, y_hi, y_lo)

    if cfg.tile_mode:
        # the boundary conditions run once, after the corrector
        exited = torch.zeros_like(scheduled)
    else:
        x_hi, x_lo, y_hi, y_lo, exited = _apply_bcs(cfg, a, x_hi, x_lo,
                                                    y_hi, y_lo)
    z_new = torch.minimum(z_new, htop)

    # ---------------- Petterssen corrector (advance.f90:816-986) ------------
    can_pett = (~exited) if a.can_pett else torch.zeros_like(exited)
    if pett_gate is not None:
        can_pett = can_pett & pett_gate
    if cfg.tile_mode and pol is not None:
        # a particle the caps' update moved may end outside the tile's
        # halo: no corrector (flexpart_tpu/core/advance.py:1156-1163)
        can_pett = can_pett & ~pol
    xn = x_hi + x_lo
    yn = y_hi + y_lo
    hw2 = _weights(cfg, a, xn, yn)
    indz2, dz1_2 = vert_weights(z_new, height)
    if legacy_interp:
        u2, v2, w2 = interp_wind_short(lz0, lz1, hw2, indz2, dz1_2, ew0, ew1)
    else:
        u2, v2, w2 = interp_wind_short_quad(tables.rowsE, hw2, indz2, dz1_2,
                                            a.tile_nx, a.tile_ny)
    for k, (nnx, nny) in enumerate(cfg.nests):
        inn2 = _in_nest(a, k, xn, yn)
        xt2, yt2 = _nest_coords(a, k, xn, yn)
        hw2n = horiz_weights(xt2, yt2, nnx, nny, False)
        u2n, v2n, w2n = interp_wind_short_quad(tables_n[k].rowsE, hw2n,
                                               indz2, dz1_2, nnx, nny)
        u2 = torch.where(inn2, u2n, u2)
        v2 = torch.where(inn2, v2n, v2)
        w2 = torch.where(inn2, w2n, w2)
    if settle_at is not None:
        w2 = w2 + settling
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
    xc_hi, xc_lo, yc_hi, yc_lo, _ = _apply_polar(cfg, a, xn, yn, du * dtl,
                                                 dv * dtl, xc_hi, xc_lo,
                                                 yc_hi, yc_lo)
    if not cfg.tile_mode:
        xc_hi, xc_lo, yc_hi, yc_lo, exited2 = _apply_bcs(cfg, a, xc_hi,
                                                         xc_lo, yc_hi, yc_lo)

    x_hi = torch.where(can_pett, xc_hi, x_hi)
    x_lo = torch.where(can_pett, xc_lo, x_lo)
    y_hi = torch.where(can_pett, yc_hi, y_hi)
    y_lo = torch.where(can_pett, yc_lo, y_lo)
    z_new = torch.where(can_pett, z_corr, z_new)
    if cfg.tile_mode:
        # wrap, mirror and exit once, on the global grid
        # (flexpart_tpu/parallel/domain.py:430-437)
        x_hi, x_lo, y_hi, y_lo, exited = _apply_bcs(cfg, a, x_hi, x_lo,
                                                    y_hi, y_lo)
    else:
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
    if cfg.method == 1:
        # the next adaptive step is stored back (timemanager passes idt
        # inout); t_below is the deposition window of scheduled particles
        new_p = new_p.replace(idt=torch.where(scheduled, idt_new, p.idt))
        t_below = torch.where(scheduled, t_below, zero)
    diag = StepDiag(
        n_active=new_p.active.sum(dtype=i32),
        n_exited=(scheduled & exited).sum(dtype=i32),
        nan_count=nan_count, t_below=t_below, passes=passes,
    )
    return new_p, diag


def advance_chunked(p: Particles, z0: ZFields, z1: ZFields, itime: int,
                    memtime0: int, memtime1: int, key: rng.Key,
                    cfg: StepConfig, prm: StepParams, n_chunks: int,
                    draws: dict | None = None):
    """``advance_all`` with the tables built once: one kernel launch over all
    particles on a CUDA device (the kernels hold no temporaries, so there
    is nothing to chunk), ``n_chunks`` calls of the plain version on the
    CPU, which bounds its temporaries.

    Unlike JAX's ``fold_in(key, chunk)``, the draw counter is the global
    particle index, so without injected draws the result does not depend
    on ``n_chunks``.  Injected draws are (rows, N) (the adaptive step's
    tags 1 and 2: (K, rows, N)) and sliced per chunk."""
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
        d = None if draws is None else {t: v[..., lo:lo + b]
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

    def joined(name):
        vals = [getattr(d, name) for d in diags]
        return None if vals[0] is None else torch.cat(vals)

    return p2, StepDiag(n_active=total("n_active"),
                        n_exited=total("n_exited"),
                        nan_count=total("nan_count"),
                        t_below=joined("t_below"), passes=joined("passes"))

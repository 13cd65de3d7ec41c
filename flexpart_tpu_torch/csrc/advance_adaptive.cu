// K11: the adaptive-step particle advance (CTL > 0, method = 1), one
// lsynctime update of every scheduled particle in ONE launch: a block
// starts 256 particles, one a thread, keeps them in a pool in shared memory
// and deals the ones still in the boundary layer's loop to its first lanes,
// one pass each, until none is left; then each thread ends its own.
//
// Replaces: flexpart_tpu/core/advance.py::advance_all with method=1
// (advance.py:768-1256), its _adaptive_interval (:430-660), _ldt_formula
// (:414-428) and the first step of a fresh particle (:936-954), which the
// JAX package leaves to XLA as a lax.while_loop over masked passes of every
// particle, and the plain version's loop of passes over the active particles
// (core/advance.py::_adaptive_interval_plain).
//
// What a particle goes through: its start (lane_start: K4's step_start,
// the row gather of the (R, 64) quad table and the 15-field stencil;
// fresh_state, a fresh particle's velocities, and its first step idt); if
// it starts in the boundary layer, passes while it has time left and is
// not above h (lane_pass: its z re-sampled in the frozen horizontal
// stencil, lanes 0-39 of its cell's row, interp.py's wind10_quad; Hanna at
// z; the horizontal OU update and K4's ifine vertical substeps,
// pbl_substeps, with the pass's draws over dt_i = min(ldt, remaining); the
// next ldt = max(trunc(min(...) * ctl), mintime); settling at the pass's z;
// the top clamp; the seconds below 2 HREF, before the ground reflection;
// the ground reflection); then its end (lane_end: K4's free troposphere,
// free_trop_terms, for the time left, which is the whole interval above
// the boundary layer; the mesoscale sigmas of the final cell, lanes 60-62;
// K4's finish_step: mesoscale memory, windalign, the position update, the
// polar caps, the boundary conditions, and the Petterssen corrector for a
// step of the whole interval only, idt == lsynctime), written to its own
// slot with idt, t_below and its pass count.  An unscheduled slot is
// copied through.  The shared device functions are in advance_common.cuh.
//
// Draws: in registers from fp::normal_words with the pass in the Philox
// counter, (global index, row / 4, pass, 0): a particle's numbers depend
// only on (seed, step, tag, particle, row, pass), never on the lane or the
// iteration that runs its pass, so the block makes what the plain
// version's loop over all particles makes (K1's draws of pass k).  Tags 6,
// 3 and 4 are drawn as in K4 (pass 0).  K11 has no parity mode: injected
// draws go to the plain version.
//
// Bound on the H100: chip_smoke.py's k11_bound, from the state bytes, the
// rows the passes gather and the instructions of the pass body's cheapest
// path in the compiled kernel (k11_instructions: the dealing of the
// particles, the starts, the ends and a pass's moves between the pool and
// the registers are not counted as pass work).
//
// Design.  A boundary-layer particle takes 3-4 passes on average and up
// to 8 or 9, a third of a run's particles none; one thread per particle
// kept every lane of a warp until its longest lane was done (a warp
// efficiency of 0.45 in a run).  Here the lanes that run a pass are
// refilled every iteration from the block's pool: the particles still in
// the loop, in slot order (a ballot per warp, the warps' counts summed),
// go to threads 0, 1, ..., so ceil(count / 32) warps run the iteration and
// the rest wait at the barrier, leaving the SM to other blocks.  Between
// passes a particle's state (NWORDS words) lives in the pool, not in a
// thread's registers; a pass loads it and stores the 16 words it changes.
// The start and the end stay one thread per slot, so they run at full
// width on neighbouring slots (coalesced, and in cell order the same few
// rows for a warp), and slot order survives the dealing, so the passes'
// gathers keep that locality too.  With the state out of the registers a
// thread needs 64 of them, no spill, and an SM holds four blocks (32
// warps; five or six spill and gain 2-4%).  Measured first and dropped
// (PERF.md, section 6): resident warps refilling lanes from a global pool of
// chunks, as the persistent threads of Aila and Laine, "Understanding the
// efficiency of ray traversal on GPUs" (HPG 2009), fetch new rays.  There
// a refill runs the whole start and end for the few lanes that take them,
// and a warp's lanes hold particles from chunks far apart in slot order:
// lane efficiency 0.8, but the spread ensemble twice as slow.  The active
// and exited counts are reduced per warp, the passes executed and the lane
// iterations issued (32 per warp that ran an iteration) per block: integer
// sums, deterministic.
//
// The turbulence is a template value of three (HANNA1, TS, CBL), so an
// instantiation holds one form of Hanna and of the substep; turboff is a
// runtime field (a uniform branch); the instantiations are (table type,
// turbulence, polar, settling), 24, and the tile's 24 (its CBL ones a part
// of their own).  The arithmetic is the plain version's, operation for
// operation, built with -fmad=false.
//
// The skewed convective boundary layer (the CBL instantiations; cblflag,
// which Command runs with turbswitch and the adaptive step, and which the
// Python API also runs without turbswitch: then the fresh state and the
// first step take hanna1, each next step hanna1's formula, and the passes
// Hanna's turbswitch form, a uniform branch on a.turbswitch;
// flexpart_tpu/core/advance.py:321-381 and :904-916, core/cbl.py:31-200):
// wp is the raw vertical velocity.  A fresh boundary-layer particle where
// -h/L > 5 takes its wp from the skewed pdf with a uniform (tag 7) and a
// normal (tag 8); in a pass, each substep with dtftlw < 0.5 runs the
// bi-Gaussian drift and diffusion in the zone -h/L > 5 (a particle more
// than six sigma from both Gaussians is redrawn with tag 40 + s of the
// pass, its sign kept), the Gaussian drift on the raw velocity outside it,
// and redraws a non-finite velocity from the substep's normal; each such
// pass counts one NaN redraw, summed per block beside the passes (work[2]:
// StepDiag.nan_count).  A CBL pass is lane_pass_cbl: it reads the pool
// and writes what it changes besides its height and velocity before the
// substeps, computes the skewed scheme's column constants once
// (skew_column: -h/L, its sine taper, wst^3, the zone test), and runs
// cbl_substeps, into which the skewed substep (cbl_skewed_wp) is inlined.
// Measured before (PERF.md, section 6): the same arithmetic as __noinline__
// calls of a dozen arguments each substep, with the column constants
// recomputed in each, at 3 blocks an SM: 80 registers, 152-160 B of stack
// and 78-82 B spilled, the skewed work at about a fifth of the
// instruction rate.  The pool stays 36 words a particle (raw wp in the wp
// word) and the stock instantiations do not see the CBL.
// Bound: chip_smoke.py reads the CBL pass body's instructions as it reads
// K11's, and charges each skewed substep and fresh draw the cheapest path
// through cbl_skewed_wp and cbl_fresh_wp, read from the CBL part built
// with FP_CBL_CALLS=1, where they are calls.
//
// A tile of a tiles run (advance_adaptive_tile_kernel, the TILE
// instantiations: table type x HANNA1, TS and CBL x POLAR x SETTLING; K4
// TILE's design, advance.cu): positions global, the start's corner, each
// pass's and the end's rows and the settling column the tile's, no
// boundary conditions inside the loop of passes and the global ones once
// at the end, after the corrector.  The CBL's pass (lane_pass_cbl) takes
// the same TILE flag: its row and settling column are the tile's, the
// rest is the stock CBL pass.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "cell_index.cuh"
#include "advance_common.cuh"
#include "philox_normal.cuh"

namespace {

// Particles a block holds: the pool its warps refill their lanes from.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Blocks an SM must hold (at most 64 registers a thread): 32 warps.  The
// CBL's instantiations hold as many: their skewed substep, some sixty
// values at once, then spills some 100 B, but the pass is bound by the
// latency of its chains of dependent operations, and 2 blocks (128
// registers, no spill) or 3 (80, no spill) run it slower (PERF.md,
// section 6).  chip_smoke.py's k11_blocks reads THREADS and these two.
constexpr int MIN_BLOCKS = 4;
constexpr int MIN_BLOCKS_CBL = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

// What a kernel reads and writes besides the run scalars.
struct Io {
  PIn in;
  const int* idt_in;
  POut out;
  int* idt_out;
  float* t_below;
  int* passes;
  const void* rows;
  const void* rowsE;
  const float* height;
  const float* mass0;
  const float* tt3;
  const float* rho3;
};

// A particle from its start to its end: the start's position, stencil and
// boundary-layer scalars, its velocities and settling column, the pass
// state and the sums of its displacements.
struct Lane {
  int i;
  float x_hi, x_lo, y_hi, y_lo;
  float up, vp, wp, usig, vsig, wsig;
  int cbt;
  Horiz hw;
  float h, tropop, ust, wst, ol;
  Settle st;
  float zc, ldt, remaining, t_below;
  uint32_t k;
  float u_l, v_l, w_l, daw, dcw, dxs, dys;
};

// A Lane in shared memory, one 32-bit word a field (ints by their bits),
// a row of THREADS words a field: what a block's particles keep between
// passes.  Each field is named once, here, with its row: first the fields
// a pass changes (PASS_FIELDS, which a pass stores back), then those it
// only reads, then the start's position and sigmas, which only the end
// reads (HELD_FIELDS).  Field `name` sits in row ROW_name, in the order of
// the two lists.
#define PASS_FIELDS(X)                                                     \
  X(ZC, zc) X(LDT, ldt) X(REMAINING, remaining) X(T_BELOW, t_below)        \
  X(K, k) X(UP, up) X(VP, vp) X(WP, wp) X(CBT, cbt) X(U_L, u_l)            \
  X(V_L, v_l) X(W_L, w_l) X(DAW, daw) X(DCW, dcw) X(DXS, dxs) X(DYS, dys)
#define HELD_FIELDS(X)                                                     \
  X(IX, hw.ix) X(JY, hw.jy) X(P4_0, hw.p4[0]) X(P4_1, hw.p4[1])            \
  X(P4_2, hw.p4[2]) X(P4_3, hw.p4[3]) X(H, h) X(UST, ust) X(WST, wst)     \
  X(OL, ol) X(ST_COL, st.col) X(ST_SP, st.sp) X(TROPOP, tropop)           \
  X(X_HI, x_hi) X(X_LO, x_lo) X(Y_HI, y_hi) X(Y_LO, y_lo) X(USIG, usig)  \
  X(VSIG, vsig) X(WSIG, wsig)

#define POOL_ROW(name, field) ROW_##name,
enum PoolRow : int { PASS_FIELDS(POOL_ROW) HELD_FIELDS(POOL_ROW) NWORDS };
#undef POOL_ROW
// a field of Lane without a row, or with two, does not compile
static_assert(sizeof(Lane) == (NWORDS + 1) * sizeof(float),
              "every field of a Lane but i has one row of the pool");

struct Pool {
  float w[NWORDS][THREADS];
};

// The block's static shared memory: the pool, the in-loop flags, the order
// of the particles in the loop and the per-warp counts.
constexpr size_t STATIC_SHARED =
    sizeof(Pool) + THREADS * (sizeof(unsigned char) + sizeof(short)) +
    WARPS * sizeof(int);

__device__ __forceinline__ void put(Pool& s, int f, int p, float v) { s.w[f][p] = v; }
__device__ __forceinline__ void put(Pool& s, int f, int p, int v) {
  s.w[f][p] = __int_as_float(v);
}
__device__ __forceinline__ void put(Pool& s, int f, int p, uint32_t v) {
  s.w[f][p] = __int_as_float(static_cast<int>(v));
}
__device__ __forceinline__ void get(const Pool& s, int f, int p, float& v) { v = s.w[f][p]; }
__device__ __forceinline__ void get(const Pool& s, int f, int p, int& v) {
  v = __float_as_int(s.w[f][p]);
}
__device__ __forceinline__ void get(const Pool& s, int f, int p, uint32_t& v) {
  v = static_cast<uint32_t>(__float_as_int(s.w[f][p]));
}

#define POOL_PUT(name, field) put(s, ROW_##name, p, L.field);
#define POOL_GET(name, field) get(s, ROW_##name, p, L.field);

__device__ __forceinline__ void store_pass(Pool& s, int p, const Lane& L) {
  PASS_FIELDS(POOL_PUT)
}

__device__ __forceinline__ void store_lane(Pool& s, int p, const Lane& L) {
  store_pass(s, p, L);
  HELD_FIELDS(POOL_PUT)
}

__device__ __forceinline__ void load_lane(const Pool& s, int p, int i, Lane& L) {
  L.i = i;
  PASS_FIELDS(POOL_GET)
  HELD_FIELDS(POOL_GET)
}

#undef POOL_PUT
#undef POOL_GET

// ldt = max(trunc(lim * ctl), mintime) (advance.f90:504-510); the first step
// of a fresh particle caps lim by 600 s in the hanna1 form.
template <bool TS>
__device__ __forceinline__ float ldt_formula(const AdvanceArgs& a, const Turb& t,
                                             float wp, float h, bool first) {
  float lim;
  if (TS) {
    lim = tmin(tmin(t.tlw, h / clamp_min(2.0f * fabsf(wp * t.sigw), F(1e-5))),
               0.5f / clamp_min(fabsf(t.dsigwdz), F(1e-10)));
  } else {
    lim = tmin(t.tlw, h / clamp_min(2.0f * fabsf(wp), F(1e-5)));
    if (first) lim = tmin(lim, 600.0f);
  }
  return clamp_min(truncf(lim * a.ctl), a.mintime);
}

// An unscheduled slot: its state copied through, no pass, not active.
__device__ __forceinline__ void copy_through(const Io& io, int i) {
  io.out.x_hi[i] = io.in.x_hi[i];
  io.out.x_lo[i] = io.in.x_lo[i];
  io.out.y_hi[i] = io.in.y_hi[i];
  io.out.y_lo[i] = io.in.y_lo[i];
  io.out.z[i] = io.in.z[i];
  io.out.itra[i] = io.in.itra[i];
  io.out.up[i] = io.in.up[i];
  io.out.vp[i] = io.in.vp[i];
  io.out.wp[i] = io.in.wp[i];
  io.out.usig[i] = io.in.usig[i];
  io.out.vsig[i] = io.in.vsig[i];
  io.out.wsig[i] = io.in.wsig[i];
  io.out.cbt[i] = io.in.cbt[i];
  io.out.active[i] = 0;
  io.idt_out[i] = io.idt_in[i];
  io.t_below[i] = 0.0f;
  io.passes[i] = 0;
}

// The start of scheduled particle i (advance.f90:276; initialize.f90:110-219
// and :155-162,191 for a fresh one).  Returns whether it takes a pass.  A
// particle outside the boundary layer keeps the whole interval in
// `remaining`, which its end spends in the free troposphere.
template <bool BF16, int TURB, bool SETTLING, bool TILE = false>
__device__ __forceinline__ bool lane_start(const AdvanceArgs& a, const Io& io,
                                           const float* sh_height, int i,
                                           Lane& L) {
  const Draws in_registers = {{nullptr, nullptr, nullptr, nullptr, nullptr}};
  L.i = i;
  L.x_hi = io.in.x_hi[i];
  L.x_lo = io.in.x_lo[i];
  L.y_hi = io.in.y_hi[i];
  L.y_lo = io.in.y_lo[i];
  L.up = io.in.up[i];
  L.vp = io.in.vp[i];
  L.wp = io.in.wp[i];
  L.usig = io.in.usig[i];
  L.vsig = io.in.vsig[i];
  L.wsig = io.in.wsig[i];
  L.cbt = io.in.cbt[i];
  int idt = io.idt_in[i];
  const float x = L.x_hi + L.x_lo;
  const float y = L.y_hi + L.y_lo;
  const float z = io.in.z[i];
  const Start s = step_start<BF16, TILE>(a, io.rows, sh_height, x, y, z);
  L.hw = s.hw;
  L.h = s.h;
  L.tropop = s.tropop;
  L.ust = s.ust;
  L.wst = s.wst;
  L.ol = s.ol;
  const bool pbl = (z / s.h) <= 1.0f;
  L.st = SETTLING ? settle_setup<TILE>(a, io.mass0, i, x, y) : Settle{0, 0};
  const bool fresh = (io.in.itramem[i] == a.itime) || (a.itime == 0);
  if (fresh) {
    constexpr bool TS = TURB != HANNA1;
    Turb t0;
    float ldt0 = a.dt;
    if constexpr (TURB == CBL) {
      // the CBL without turbswitch starts a particle from hanna1 and its
      // first step from hanna1's formula (flexpart_tpu/core/advance.py:900,
      // :939)
      if (pbl)
        t0 = a.turbswitch ? hanna<true>(z, s.h, s.ust, s.wst, s.ol)
                          : hanna<false>(z, s.h, s.ust, s.wst, s.ol);
      fresh_state<TURB>(a, in_registers, false, i, pbl, t0, s, z, L.up,
                        L.vp, L.wp, L.usig, L.vsig, L.wsig, L.cbt);
      if (pbl)
        ldt0 = a.turbswitch ? ldt_formula<true>(a, t0, L.wp, s.h, true)
                            : ldt_formula<false>(a, t0, L.wp, s.h, true);
      idt = __float2int_rz(ldt0);
    } else {
      if (pbl) t0 = hanna<TS>(z, s.h, s.ust, s.wst, s.ol);
      fresh_state<TURB>(a, in_registers, false, i, pbl, t0, s, z, L.up, L.vp,
                        L.wp, L.usig, L.vsig, L.wsig, L.cbt);
      idt = __float2int_rz(pbl ? ldt_formula<TS>(a, t0, L.wp, s.h, true)
                               : a.dt);
    }
  }
  L.remaining = a.dt;
  L.ldt = clamp_min(static_cast<float>(idt), a.mintime);
  L.zc = z;
  L.t_below = 0.0f;
  L.k = 0;
  L.u_l = 0.0f;
  L.v_l = 0.0f;
  L.w_l = 0.0f;
  L.daw = 0.0f;
  L.dcw = 0.0f;
  L.dxs = 0.0f;
  L.dys = 0.0f;
  return pbl && L.remaining > 0.0f && L.zc <= L.h;
}

// One pass of the boundary layer (advance.f90:276-620), HANNA1 or TS.
// Returns whether the particle takes another.
template <bool BF16, int TURB, bool SETTLING, bool TILE = false>
__device__ __forceinline__ bool lane_pass(const AdvanceArgs& a, const Io& io,
                                          const float* sh_height, Lane& L) {
  constexpr bool TS = TURB != HANNA1;
  const float htop = sh_height[a.nz - 1] - a.htop_eps;
  const float hm = L.h - F(1e-9);
  const float dt_i = tmin(L.ldt, L.remaining);
  int iz;
  float dz;
  vert_weights(sh_height, a.nz, L.zc, iz, dz);
  const size_t rk = fp::cell_row(iz, L.hw.jy, L.hw.ix, table_ny<TILE>(a),
                                 table_nx<TILE>(a));
  float gk[40];
#pragma unroll
  for (int q = 0; q < 5; ++q) load8<BF16, 64>(io.rows, rk, q, &gk[8 * q]);
  const float u = field2(gk, 0, L.hw.p4, dz);
  const float v = field2(gk, 1, L.hw.p4, dz);
  const float w = field2(gk, 2, L.hw.p4, dz);
  const float rhoa = field2(gk, 3, L.hw.p4, dz);
  const float drho = field2(gk, 4, L.hw.p4, dz);
  const Turb t0 = hanna<TS>(L.zc, L.h, L.ust, L.wst, L.ol);

  // the pass's draws: tag 1 rows 0, 1 (the horizontal OU update,
  // advance.f90:369-384) and tag 2 row 0 (the first substep)
  float d0, d1, d2, d2_odd;
  uint32_t pw[4];
  site_words(pw, a, 1, L.i, 0u, L.k);
  fp::normal_pair(pw[0], pw[1], d0, d1);
  site_words(pw, a, 2, L.i, 0u, L.k);
  fp::normal_pair(pw[0], pw[1], d2, d2_odd);
  const float up2 = ou_update(L.up, d0, t0.sigu, dt_i / t0.tlu);
  const float vp2 = ou_update(L.vp, d1, t0.sigv, dt_i / t0.tlv);

  // the ifine vertical substeps (advance.f90:391-498) over dt_i; the
  // next step from the turbulence of the last refresh
  float zz = L.zc;
  const Turb t = pbl_substeps<TURB>(a, nullptr, false, L.i, L.k, t0,
                                    drho / rhoa, dt_i * a.fine, d2, d2_odd,
                                    pw, L.h, L.ust, L.wst, L.ol, zz, L.wp,
                                    L.cbt);
  const float ldt2 = ldt_formula<TS>(a, t, L.wp, L.h, false);
  const float w_eff =
      SETTLING ? w + settle_at<TILE>(a, L.st, io.tt3, io.rho3, sh_height, L.zc)
               : w;
  float z3 = zz + (w_eff * dt_i) * a.ldirf;
  z3 = tmin(z3, htop);
  // the deposition window (advance.f90:582-599): after the vertical
  // update, before the ground reflection
  if (z3 < TWO_HREF) L.t_below = L.t_below + dt_i;
  z3 = reflect_ground(z3, hm);

  L.remaining = clamp_min(L.remaining - dt_i, 0.0f);
  L.ldt = ldt2;
  L.zc = z3;
  L.up = up2;
  L.vp = vp2;
  L.u_l = u;
  L.v_l = v;
  L.w_l = w_eff;
  L.daw = L.daw + up2 * dt_i;
  L.dcw = L.dcw + vp2 * dt_i;
  L.dxs = L.dxs + u * dt_i;
  L.dys = L.dys + v * dt_i;
  ++L.k;
  return L.remaining > 0.0f && L.zc <= L.h;
}

// One pass of the skewed CBL (TURB == CBL): lane_pass's arithmetic, read
// from and written to the pool directly, so that the substeps hold only
// what they use.  What the pass changes besides its height, velocity and
// next step (the horizontal velocities, the winds, the displacements, the
// time left and the pass count) is stored before the substeps; the column
// constants of the skewed scheme (skew_column) are computed once here.
// lane_pass with cbl_substeps in place of pbl_substeps, which holds the
// whole Lane across them, spills 166-182 B and runs 1.5% slower on the
// kernels case and 4.6% in sim_cbl (PERF.md, section 6).
// Returns whether the particle takes another pass.
template <bool BF16, bool SETTLING, bool TILE = false>
__device__ __forceinline__ bool lane_pass_cbl(const AdvanceArgs& a,
                                              const Io& io,
                                              const float* sh_height, Pool& s,
                                              int p, int i, bool& nan) {
  float zc, ldt, remaining, h, ust, wst, ol;
  uint32_t k;
  int cbt;
  Horiz hw;
  get(s, ROW_ZC, p, zc);
  get(s, ROW_LDT, p, ldt);
  get(s, ROW_REMAINING, p, remaining);
  get(s, ROW_K, p, k);
  get(s, ROW_IX, p, hw.ix);
  get(s, ROW_JY, p, hw.jy);
  get(s, ROW_P4_0, p, hw.p4[0]);
  get(s, ROW_P4_1, p, hw.p4[1]);
  get(s, ROW_P4_2, p, hw.p4[2]);
  get(s, ROW_P4_3, p, hw.p4[3]);
  get(s, ROW_H, p, h);
  get(s, ROW_UST, p, ust);
  get(s, ROW_WST, p, wst);
  get(s, ROW_OL, p, ol);
  const float dt_i = tmin(ldt, remaining);
  int iz;
  float dz;
  vert_weights(sh_height, a.nz, zc, iz, dz);
  const size_t rk = fp::cell_row(iz, hw.jy, hw.ix, table_ny<TILE>(a),
                                 table_nx<TILE>(a));
  float gk[40];
#pragma unroll
  for (int q = 0; q < 5; ++q) load8<BF16, 64>(io.rows, rk, q, &gk[8 * q]);
  const float u = field2(gk, 0, hw.p4, dz);
  const float v = field2(gk, 1, hw.p4, dz);
  const float w = field2(gk, 2, hw.p4, dz);
  const float rhoa = field2(gk, 3, hw.p4, dz);
  const float drho = field2(gk, 4, hw.p4, dz);
  const Turb t0 = hanna<true>(zc, h, ust, wst, ol);

  // the pass's draws, as lane_pass
  float d0, d1, d2, d2_odd;
  uint32_t pw[4];
  site_words(pw, a, 1, i, 0u, k);
  fp::normal_pair(pw[0], pw[1], d0, d1);
  site_words(pw, a, 2, i, 0u, k);
  fp::normal_pair(pw[0], pw[1], d2, d2_odd);
  {
    float up, vp, daw, dcw, dxs, dys;
    get(s, ROW_UP, p, up);
    get(s, ROW_VP, p, vp);
    const float up2 = ou_update(up, d0, t0.sigu, dt_i / t0.tlu);
    const float vp2 = ou_update(vp, d1, t0.sigv, dt_i / t0.tlv);
    get(s, ROW_DAW, p, daw);
    get(s, ROW_DCW, p, dcw);
    get(s, ROW_DXS, p, dxs);
    get(s, ROW_DYS, p, dys);
    put(s, ROW_UP, p, up2);
    put(s, ROW_VP, p, vp2);
    put(s, ROW_U_L, p, u);
    put(s, ROW_V_L, p, v);
    put(s, ROW_DAW, p, daw + up2 * dt_i);
    put(s, ROW_DCW, p, dcw + vp2 * dt_i);
    put(s, ROW_DXS, p, dxs + u * dt_i);
    put(s, ROW_DYS, p, dys + v * dt_i);
    put(s, ROW_K, p, k + 1u);
  }
  remaining = clamp_min(remaining - dt_i, 0.0f);
  put(s, ROW_REMAINING, p, remaining);
  float w_eff = w;
  if (SETTLING) {
    Settle st;
    get(s, ROW_ST_COL, p, st.col);
    get(s, ROW_ST_SP, p, st.sp);
    w_eff = w + settle_at<TILE>(a, st, io.tt3, io.rho3, sh_height, zc);
  }
  put(s, ROW_W_L, p, w_eff);

  // the ifine substeps over dt_i, the skewed scheme's column constants
  // computed once
  float zz = zc, wp;
  get(s, ROW_WP, p, wp);
  get(s, ROW_CBT, p, cbt);
  const Turb t = cbl_substeps(a, i, k, t0, dt_i * a.fine, d2, d2_odd, pw, h,
                              ust, wst, ol, skew_column(h, wst, ol), rhoa,
                              drho, zz, wp, cbt, nan);
  // the next step by turbswitch's formula (hanna1's without it), from the
  // substeps' Hanna, which the CBL takes in its turbswitch form
  put(s, ROW_LDT, p, a.turbswitch ? ldt_formula<true>(a, t, wp, h, false)
                                  : ldt_formula<false>(a, t, wp, h, false));
  put(s, ROW_WP, p, wp);
  put(s, ROW_CBT, p, cbt);
  // w_eff and the time left were stored before the substeps
  get(s, ROW_W_L, p, w_eff);
  get(s, ROW_REMAINING, p, remaining);
  const float htop = sh_height[a.nz - 1] - a.htop_eps;
  float z3 = zz + (w_eff * dt_i) * a.ldirf;
  z3 = tmin(z3, htop);
  // the deposition window: after the vertical update, before the ground
  // reflection
  if (z3 < TWO_HREF) {
    float t_below;
    get(s, ROW_T_BELOW, p, t_below);
    put(s, ROW_T_BELOW, p, t_below + dt_i);
  }
  z3 = reflect_ground(z3, h - F(1e-9));
  put(s, ROW_ZC, p, z3);
  return remaining > 0.0f && z3 <= h;
}

// The end of a particle: the free troposphere for the time left
// (advance.f90:629-708), the mesoscale sigmas of the final cell
// (:601-605), K4's end of the step, and its outputs.  Returns exited.
template <bool BF16, bool POLAR, bool SETTLING, bool TILE = false>
__device__ __forceinline__ bool lane_end(const AdvanceArgs& a, const Io& io,
                                         const float* sh_height, Lane& L) {
  const Draws in_registers = {{nullptr, nullptr, nullptr, nullptr, nullptr}};
  const int i = L.i;
  const float htop = sh_height[a.nz - 1] - a.htop_eps;
  const float hm = L.h - F(1e-9);
  float zc = L.zc;
  float ldt = L.ldt;
  float wp = L.wp;
  float u_l = L.u_l, v_l = L.v_l, w_l = L.w_l;
  float dxs = L.dxs, dys = L.dys;
  const float dt_ft = L.remaining;
  if (dt_ft > 0.0f) {
    int iz;
    float dz;
    vert_weights(sh_height, a.nz, zc, iz, dz);
    const size_t rf = fp::cell_row(iz, L.hw.jy, L.hw.ix, table_ny<TILE>(a),
                                   table_nx<TILE>(a));
    float gf[24];
#pragma unroll
    for (int q = 0; q < 3; ++q) load8<BF16, 64>(io.rows, rf, q, &gf[8 * q]);
    const float u_f = field2(gf, 0, L.hw.p4, dz);
    const float v_f = field2(gf, 1, L.hw.p4, dz);
    const float w_f = field2(gf, 2, L.hw.p4, dz);
    const bool in_trop = zc < L.tropop;
    const bool in_trans = !in_trop && (zc < L.tropop + 1000.0f);
    const float dt_s = clamp_min(dt_ft, F(1e-6));
    const float c_trop = a.two_d_trop / dt_s;
    const float c_strat = a.two_d_strat / dt_s;
    // tag 3 rows 0-2: one Philox call
    float f0, f1, f2, unused;
    uint32_t w3[4];
    site_words(w3, a, 3, i, 0u);
    fp::normal_pair(w3[0], w3[1], f0, f1);
    fp::normal_pair(w3[2], w3[3], f2, unused);
    float ux, vy, wp_ft;
    free_trop_terms(a, in_trop, in_trans, zc, L.tropop, f0, f1, f2, c_trop,
                    c_strat, sqrtf(c_trop), sqrtf(c_strat), ux, vy, wp_ft);
    const float w_eff_f =
        SETTLING ? w_f + settle_at<TILE>(a, L.st, io.tt3, io.rho3, sh_height, zc)
                 : w_f;
    dxs = dxs + (u_f + ux) * dt_ft;
    dys = dys + (v_f + vy) * dt_ft;
    zc = reflect_ground(zc + ((w_eff_f + wp_ft) * dt_ft) * a.ldirf, hm);
    wp = wp_ft;
    u_l = u_f;
    v_l = v_f;
    w_l = w_eff_f;
    ldt = clamp_min(dt_ft, a.mintime);
  }

  // the mesoscale sigmas of the final cell (advance.f90:601-605)
  int ize;
  float dze;
  vert_weights(sh_height, a.nz, zc, ize, dze);
  float ge[8];
  load8<BF16, 64>(io.rows, fp::cell_row(ize, L.hw.jy, L.hw.ix, table_ny<TILE>(a),
                                       table_nx<TILE>(a)),
                  7, ge);
  const int idt = __float2int_rz(ldt);
  float z_new = tmin(zc, htop);
  float up = L.up, vp = L.vp, daw = L.daw, dcw = L.dcw;
  if (a.turboff) {
    up = 0.0f;
    vp = 0.0f;
    daw = 0.0f;
    dcw = 0.0f;
  }
  const float settl =
      SETTLING ? settle_at<TILE>(a, L.st, io.tt3, io.rho3, sh_height, z_new)
               : 0.0f;

  float m0, m1, m2;
  meso_draws(a, in_registers, false, i, m0, m1, m2);
  float x_hi = L.x_hi, x_lo = L.x_lo, y_hi = L.y_hi, y_lo = L.y_lo;
  float usig = L.usig, vsig = L.vsig, wsig = L.wsig;
  // only a step of the whole interval takes the corrector
  // (advance.f90:829)
  const bool exited = finish_step<BF16, POLAR, SETTLING, false, TILE>(
      a, io.rowsE, sh_height, L.x_hi + L.x_lo, L.y_hi + L.y_lo, x_hi, x_lo,
      y_hi, y_lo, z_new, dxs, dys, daw, dcw, u_l, v_l, w_l, settl, usig, vsig,
      wsig, ge[4], ge[5], ge[6], m0, m1, m2, hm, htop,
      static_cast<float>(idt) == a.dt);
  io.out.x_hi[i] = x_hi;
  io.out.x_lo[i] = x_lo;
  io.out.y_hi[i] = y_hi;
  io.out.y_lo[i] = y_lo;
  io.out.z[i] = z_new;
  io.out.itra[i] = a.itra_new;
  io.out.up[i] = up;
  io.out.vp[i] = vp;
  io.out.wp[i] = wp;
  io.out.usig[i] = usig;
  io.out.vsig[i] = vsig;
  io.out.wsig[i] = wsig;
  io.out.cbt[i] = static_cast<int8_t>(L.cbt);
  io.out.active[i] = exited ? 0 : 1;
  io.idt_out[i] = idt;
  io.t_below[i] = L.t_below;
  io.passes[i] = static_cast<int>(L.k);
  return exited;
}

// counts: [0] += particles still active, [1] += particles that exited.
// work: [0] += passes executed, [1] += lane iterations issued, [2] +=
// passes in which the CBL redrew a non-finite velocity.
template <bool BF16, int TURB, bool POLAR, bool SETTLING, bool TILE>
__device__ __forceinline__ void adaptive_body(
    const Io& io, int* __restrict__ counts,
    unsigned long long* __restrict__ work, const AdvanceArgs& a) {
  extern __shared__ float sh_height[];
  __shared__ Pool pool;
  __shared__ unsigned char in_loop[THREADS];
  __shared__ short order[THREADS];
  __shared__ int warp_count[WARPS];
  for (int k = threadIdx.x; k < a.nz; k += blockDim.x) sh_height[k] = io.height[k];
  __syncthreads();

  const int t = threadIdx.x;
  const unsigned lane = t & 31;
  const int warp = t >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + t;
  // the start: thread t, slot i; its particle's state goes to the pool
  bool holding = false;
  bool looping = false;
  if (i < a.n) {
    if (io.in.active[i] == 0) {
      copy_through(io, static_cast<int>(i));
    } else {
      Lane L;
      looping = lane_start<BF16, TURB, SETTLING, TILE>(a, io, sh_height,
                                                       static_cast<int>(i), L);
      store_lane(pool, t, L);
      holding = true;
    }
  }
  in_loop[t] = looping ? 1 : 0;

  // the passes: each iteration the particles still in the loop, in slot
  // order, are dealt to the first lanes of the block, one pass each
  unsigned passes = 0, iters = 0;   // thread 0: the block's sums
  int nans = 0;                     // this thread's passes with a NaN redraw
  for (;;) {
    __syncthreads();
    const unsigned mine = __ballot_sync(FULL, in_loop[t] != 0);
    if (lane == 0) warp_count[warp] = __popc(mine);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_count[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (total == 0) break;
    if (in_loop[t]) order[before + __popc(mine & ((1u << lane) - 1u))] = t;
    if (t == 0) {
      passes += total;
      iters += (total + 31) / 32;
    }
    __syncthreads();
    if (t < total) {
      const int p = order[t];
      const long long ip = static_cast<long long>(blockIdx.x) * THREADS + p;
      bool more;
      if constexpr (TURB == CBL) {
        bool nan = false;
        more = lane_pass_cbl<BF16, SETTLING, TILE>(a, io, sh_height, pool,
                                                   p, static_cast<int>(ip),
                                                   nan);
        if (nan) ++nans;
      } else {
        Lane L;
        load_lane(pool, p, static_cast<int>(ip), L);
        more = lane_pass<BF16, TURB, SETTLING, TILE>(a, io, sh_height, L);
        store_pass(pool, p, L);
      }
      in_loop[p] = more ? 1 : 0;
    }
  }

  // the end: thread t, its own particle
  int kept = 0, gone = 0;
  if (holding) {
    Lane L;
    load_lane(pool, t, static_cast<int>(i), L);
    const bool exited = lane_end<BF16, POLAR, SETTLING, TILE>(a, io, sh_height,
                                                              L);
    kept = exited ? 0 : 1;
    gone = exited ? 1 : 0;
  }
  kept = __reduce_add_sync(FULL, kept);
  gone = __reduce_add_sync(FULL, gone);
  if (lane == 0) {
    if (kept) atomicAdd(&counts[0], kept);
    if (gone) atomicAdd(&counts[1], gone);
  }
  if (t == 0 && passes) {
    atomicAdd(&work[0], static_cast<unsigned long long>(passes));
    atomicAdd(&work[1], 32ull * iters);
  }
  if (TURB == CBL) {
    nans = __reduce_add_sync(FULL, nans);
    if (lane == 0 && nans)
      atomicAdd(&work[2], static_cast<unsigned long long>(nans));
  }
}

template <bool BF16, int TURB, bool POLAR, bool SETTLING>
__global__ void __launch_bounds__(THREADS,
                                  TURB == CBL ? MIN_BLOCKS_CBL : MIN_BLOCKS)
advance_adaptive_kernel(const __grid_constant__ Io io,
                        int* __restrict__ counts,
                        unsigned long long* __restrict__ work,
                        const __grid_constant__ AdvanceArgs a) {
  adaptive_body<BF16, TURB, POLAR, SETTLING, false>(io, counts, work, a);
}

// K11 TILE: a tile's adaptive step (HANNA1, TS or CBL)
template <bool BF16, int TURB, bool POLAR, bool SETTLING>
__global__ void __launch_bounds__(THREADS,
                                  TURB == CBL ? MIN_BLOCKS_CBL : MIN_BLOCKS)
advance_adaptive_tile_kernel(const __grid_constant__ Io io,
                             int* __restrict__ counts,
                             unsigned long long* __restrict__ work,
                             const __grid_constant__ AdvanceArgs a) {
  adaptive_body<BF16, TURB, POLAR, SETTLING, true>(io, counts, work, a);
}

// the part of the instantiations this library holds: -1 all, else a part
// of _build.Kernel's parts, which returns NOT_IN_PART for the others
#ifndef FP_PART
#define FP_PART -1
#endif
#define FP_HAS(part) (FP_PART < 0 || FP_PART == (part))
constexpr int NOT_IN_PART = -100;     // _build.NOT_IN_PART

}  // namespace

extern "C" int fp_advance_adaptive(
    const float* x_hi, const float* x_lo, const float* y_hi, const float* y_lo,
    const float* z, const int* itra, const int* itramem, const float* up,
    const float* vp, const float* wp, const float* usig, const float* vsig,
    const float* wsig, const int8_t* cbt, const uint8_t* active,
    const int* idt, float* o_x_hi, float* o_x_lo, float* o_y_hi,
    float* o_y_lo, float* o_z, int* o_itra, float* o_up, float* o_vp,
    float* o_wp, float* o_usig, float* o_vsig, float* o_wsig, int8_t* o_cbt,
    uint8_t* o_active, int* o_idt, float* t_below, int* passes,
    const void* rows, const void* rowsE, const float* height,
    const float* mass0, const float* tt, const float* rho, int* counts,
    unsigned long long* work, const AdvanceArgs* args, void* stream) {
  const AdvanceArgs a = *args;
  if (a.n <= 0) return 0;
  // the heights beside the pool, within the 48 KB a block has by default
  const size_t shmem = static_cast<size_t>(a.nz) * sizeof(float);
  if (a.nz < 2 || shmem + STATIC_SHARED > 48 * 1024 || a.ifine < 1 ||
      a.method != 1 || !(a.mintime > 0.0f) || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.settling && (a.nspec < 1 || a.nspec > MAX_SPECIES ||
                     mass0 == nullptr || tt == nullptr || rho == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Io io = {{x_hi, x_lo, y_hi, y_lo, z, itra, itramem, up, vp, wp, usig,
                  vsig, wsig, cbt, active},
                 idt,
                 {o_x_hi, o_x_lo, o_y_hi, o_y_lo, o_z, o_itra, o_up, o_vp,
                  o_wp, o_usig, o_vsig, o_wsig, o_cbt, o_active},
                 o_idt, t_below, passes, rows, rowsE, height, mass0, tt, rho};
  // the CBL's substeps draw with their own keys
  if (a.cblflag && a.ifine > MAX_CBL_SUBSTEPS)
    return static_cast<int>(cudaErrorInvalidValue);
  // a tile: no nests, tables of 2 x 2 cells at least
  if (a.tile && (a.nnest > 0 || a.tile_nx < 2 || a.tile_ny < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  // the (table type, turbulence, polar, settling) instantiations
  auto pick = [&](auto bf16, auto turb) {
    constexpr bool B = decltype(bf16)::value;
    constexpr int T = decltype(turb)::value;
    return a.settling
        ? (a.polar ? advance_adaptive_kernel<B, T, true, true>
                   : advance_adaptive_kernel<B, T, false, true>)
        : (a.polar ? advance_adaptive_kernel<B, T, true, false>
                   : advance_adaptive_kernel<B, T, false, false>);
  };
  const unsigned blocks = static_cast<unsigned>((a.n + THREADS - 1) / THREADS);
  auto launch = [&](auto kern) {
    kern<<<blocks, THREADS, shmem, static_cast<cudaStream_t>(stream)>>>(
        io, counts, work, a);
    return static_cast<int>(cudaGetLastError());
  };
  auto by_turb = [&](auto bf16) {
    return a.turbswitch ? pick(bf16, std::integral_constant<int, TS>{})
                        : pick(bf16, std::integral_constant<int, HANNA1>{});
  };
  // the tile's (table type, turbulence, polar, settling) instantiations
  auto pick_tile = [&](auto bf16, auto turb) {
    constexpr bool B = decltype(bf16)::value;
    constexpr int T = decltype(turb)::value;
    return a.settling
        ? (a.polar ? advance_adaptive_tile_kernel<B, T, true, true>
                   : advance_adaptive_tile_kernel<B, T, false, true>)
        : (a.polar ? advance_adaptive_tile_kernel<B, T, true, false>
                   : advance_adaptive_tile_kernel<B, T, false, false>);
  };
  auto tile_by_turb = [&](auto bf16) {
    return a.turbswitch
        ? pick_tile(bf16, std::integral_constant<int, TS>{})
        : pick_tile(bf16, std::integral_constant<int, HANNA1>{});
  };
  // a library built as one part (FP_PART, _build.Kernel's parts) holds
  // HANNA1 and TS on f32 tables (part 0) or on bf16 tables (part 1), the
  // CBL (part 2), the tile's HANNA1 and TS on f32 tables (part 3) or on
  // bf16 tables (part 4), or the tile's CBL (part 5), and launches nothing
  // for the others' configurations
  if (a.tile && a.cblflag) {
#if FP_HAS(5)
    using Cbl = std::integral_constant<int, CBL>;
    return a.table_bf16 ? launch(pick_tile(std::true_type{}, Cbl{}))
                        : launch(pick_tile(std::false_type{}, Cbl{}));
#else
    return NOT_IN_PART;
#endif
  }
  if (a.tile) {
    if (a.table_bf16) {
#if FP_HAS(4)
      return launch(tile_by_turb(std::true_type{}));
#else
      return NOT_IN_PART;
#endif
    }
#if FP_HAS(3)
    return launch(tile_by_turb(std::false_type{}));
#else
    return NOT_IN_PART;
#endif
  }
  if (a.cblflag) {
#if FP_HAS(2)
    using Cbl = std::integral_constant<int, CBL>;
    return a.table_bf16 ? launch(pick(std::true_type{}, Cbl{}))
                        : launch(pick(std::false_type{}, Cbl{}));
#else
    return NOT_IN_PART;
#endif
  }
  if (a.table_bf16) {
#if FP_HAS(1)
    return launch(by_turb(std::true_type{}));
#else
    return NOT_IN_PART;
#endif
  }
#if FP_HAS(0)
  return launch(by_turb(std::false_type{}));
#else
  return NOT_IN_PART;
#endif
}

// K4: the fixed-step particle advance, one lsynctime update of every
// scheduled particle in ONE launch, one thread per particle.
//
// Replaces: flexpart_tpu/core/advance.py::advance_all with method=0
// (advance.py:768-1256), which the JAX package leaves to XLA as one fused
// program, and the chain of several hundred eager tensor ops per particle
// chunk that the plain PyTorch version (core/advance.py::advance_all_plain)
// makes of it.  It also takes in the draws of K1: the Philox normals are
// made in registers through fp::normal_words and fp::normal_pair
// (philox_normal.cuh) at the draw sites, with the counters and keys
// core/rng.py::normals would use, so no draw is written to or read from
// device memory.
//
// What a thread does: load the particle's SoA state; bilinear and vertical
// weights; ONE row gather of the (R, 64) quad table and the 15-field
// stencil reduction; initialisation of a newly released particle; Hanna
// turbulence and the Langevin update with its ifine vertical substeps and
// reflection in the boundary layer, or the constant-diffusivity free
// troposphere / stratosphere above it; mesoscale memory; windalign and the
// metric factor; the double-single position update, the polar-stereographic
// update inside the polar caps (the POLAR instantiation only) and the
// cyclic / pole boundary conditions; the Petterssen corrector with a second
// gather from
// the (R, 32) end-time table (lanes 0-23); masked write-back into new arrays;
// and the active / exited counts by one ballot and one atomicAdd per warp.
// A thread branches where the plain version computes both sides and
// selects; the selected value is the same.  Its device functions live in
// advance_common.cuh, which the adaptive step (K11, advance_adaptive.cu)
// shares: the start, a fresh particle's velocities, the substeps, the free
// troposphere's terms, the mesoscale draws and the end of the step.
//
// Settling (the SETTLING instantiations, with any turbulence): the velocity
// of the particle's first species with mass, from the temperature and air
// density of the first met time at its nearest column and its start height,
// is added to w in the boundary layer, in the free troposphere and to the
// corrector's end-time w (advance.py:966-983, :1036-1038, :1190 of the JAX
// package).  turboff is a runtime field: a uniform branch that zeroes the
// fresh velocities, the horizontal OU, the vertical substeps, the free
// troposphere's terms and the mesoscale memory.
//
// The turbulence is a template int, as K11's (HANNA1, TS, CBL of
// advance_common.cuh): HANNA1 and TS in advance_kernel and
// advance_tile_kernel; the skewed convective boundary layer in
// advance_cbl_kernel (the CBL instantiations; cblflag, with turbswitch on
// or off; flexpart_tpu/core/advance.py:321-381, :904-916): wp is the raw
// vertical velocity, a fresh boundary-layer particle in the zone -h/L > 5
// draws it from the skewed pdf (cbl_fresh_wp: tags 7 and 8), elsewhere
// row 2 of tag 6 times sigw; the ifine substeps are K11's cbl_substeps over
// dtf = lsynctime / ifine with dtftlw from the turbulence at the interval's
// start, the column's constants (skew_column) once a particle, the redraws
// tags 40 + s of the unfolded stream (pass 0: the plain version's
// rng.normals of those tags), the particles with a NaN redraw counted in
// counts[2] (StepDiag.nan_count).  Without turbswitch the fresh state and
// the horizontal OU take hanna1 and the substeps Hanna's turbswitch form,
// as the reference (:308, :900, :1020): a uniform branch on a.turbswitch.
// The CBL makes its draws in registers only (the launcher refuses injected
// draws) and its kernels take the run scalars as a __grid_constant__
// parameter: the substeps index the redraws' keys by the substep, for which
// a by-value parameter is copied whole to the thread's stack.
//
// K4 CBL's design: three launches a call.  A substep in the skewed zone
// (cbl_skewed_wp: some sixty values live at once, powf, sqrtf, true
// divisions, expf, erff) costs about four times a Gaussian one, and which
// particles take it depends on each one's height (dtf / TL_w < 0.5 of its
// start's turbulence), so one thread a particle ran it with 0.69 of a
// warp's lanes in cell order and 0.26 as drawn, at 16 warps an SM (89-99
// registers).  Now (1) the start, advance_cbl_kernel, runs the step of
// every particle, a thread each, but defers the ones whose substeps take
// that branch: their substeps' state goes to a queue (QueueRow, a row a
// field, scratch from the wrapper), appended in lane order with one
// atomicAdd a warp on counts[3]; its own substeps compile no skewed code.
// (2) advance_cbl_skewed_kernel runs the queue's substeps, entry k on lane
// k of the blocks striding over it, so every lane takes the
// skewed branch, with its own register budget; it writes each entry's z,
// wp, cbt and NaN flag back.  (3) advance_cbl_finish_kernel, a thread an
// entry, recomputes its particle's start from the inputs (the same
// operations, so the same bits) and ends the step with the substeps'
// outcome.  A particle's draws are keyed by its slot, never by the lane,
// so the three launches give the one-thread step bit for bit.  The stock
// and TILE kernels keep advance_body, the whole step a thread, which
// compiles none of this.  Measured and dropped (PERF.md, section 6): the
// three stages in one block, the deferred entries in a pool in shared
// memory dealt to the block's first lanes, which left the block's other
// warps waiting at its barriers.
//
// Bound on the H100: bytes.  Per particle 54 B of state read and 50 B
// written, and each table row that some particle names read once: one
// 128 B row of the start table (256 B in f32) and 48 B, two 32 B sectors,
// of the 64 B row of the end-time table.  For 10,485,760 particles in
// 575,056 cells that is 1.19 GB, 0.36 ms at 3.35 TB/s.  Both tables (243
// and 121 MB in bf16) exceed the 50 MB L2, so what a gather costs depends
// on which rows the neighbouring threads name.  The arithmetic (two
// Philox calls of 10 rounds and three or four logf/sqrtf/sincosf for a
// steady particle, five and eight for a fresh one in the boundary layer,
// the expf/powf of Hanna) is one to two thousand operations per thread.
//
// Design.  Locality comes from the order of the particles, not from the
// kernel: the caller keeps them sorted by met cell (reorder.cu, every few
// steps), with the key this kernel gathers by (fp::cell_row of
// cell_index.cuh, shared with the sort).  A warp's 32 row ids then fall in
// a few rows, the gathers are served by L1 and L2, and the boundary-layer
// particles (low levels, the slowest key) fill whole warps, so Hanna and
// the substep loop no longer run for a few threads of many warps.  On an
// unordered ensemble the kernel gives the same particles, slower: each
// thread then pulls its six sectors from device memory alone.  Sharing a
// row inside the warp by hand (one loader per distinct row and shuffles)
// was tried and is not used: the cache does it without a single shuffle.
// Rows are read with 16-byte loads, a bf16 row widened to f32 by a
// 16-bit shift (exact); the height column sits in shared memory for the
// level search; every gather index is clamped first, NaN included.  The
// three draws that every particle takes, whatever its branch, are made at
// one place with the key chosen per thread, so a warp that holds boundary-
// layer and free-troposphere particles runs the generator once; a draw
// site asks for the rows of one tag together, since four rows cost one
// Philox call and two rows one Box-Muller radius.  The
// arithmetic follows the plain version operation for operation so that the
// two agree to rounding: the build uses -fmad=false, double-single sums use
// the non-contracting intrinsics, every Python float of the plain version
// is spelled F(<the same double>) (rounded once to f32, as torch rounds
// it) or arrives in AdvanceArgs, computed on the host by
// core/advance.py::advance_args.  A division by a scalar is a true
// division, as in the JAX reference and on the CPU.  min/max/clamp
// propagate NaN as torch's do.
//
// Parity mode: when the five draw pointers are given, the draws are read
// from those (rows, n) arrays instead of being made in registers.
//
// Polar caps: a grid that is cyclic and reaches beyond 75 degrees takes the
// POLAR instantiation, which replaces the position of a particle poleward
// of +-75 degrees, at the predictor and at the corrector, by the update on
// a tangent polar-stereographic plane (polar_update: sin, cos, tan, hypot,
// atan and atan2 of the longitude and half colatitude, as sinf, cosf, tanf,
// hypotf, atanf and atan2f, the functions torch's CUDA kernels call).  A
// thread computes its own cap only.  The stock instantiation compiles none
// of it and keeps its registers.
//
// Nested met grids (the NESTS instantiations, with any turbulence;
// flexpart_tpu/core/advance.py:841-866 and :1176-1189): a
// particle samples the innermost nest whose window (shrunk by nx / 3e5)
// holds it, the last such nest of the outermost-first list, or the mother.
// The grid is chosen first, by the window tests alone (nest_select), and
// its table, shape and the particle's coordinates there (the nest's
// clamped to n - 1.001) by selects over the unrolled nests (nest_pick);
// then ONE row gather from the chosen (R, 64) table gives h, the
// tropopause, u*, w*, L, the winds, density and sigmas of the start, and
// the corrector likewise takes ONE 48 B gather of the chosen (R, 32)
// end-time table at the predicted position.  So a particle reads one start
// row and at most one end row, wherever it lies, and only one Start is
// live at a time; lanes of a warp on both sides of a window's edge issue
// one gather with their own addresses.  The nests' tables and windows ride
// in AdvanceArgs (at most MAX_NESTS).  Every nest is on the mother's
// height grid, so the level and its weight are the mother's.  Bound: the
// stock one, each particle's start and end rows taken from the grid that
// holds it.  The particles stay in mother-cell order (K5): a warp's
// particles are close in the mother grid, so they are close in the nest
// too, and its nest rows are few and neighbouring.
//
// A tile of a tiles run (advance_tile_kernel and advance_cbl_kernel's TILE
// instantiations: table type x turbulence x POLAR x SETTLING;
// flexpart_tpu/core/advance.py's tile_mode and parallel/domain.py:377-437):
// the tables are the tile's, built by K2 from the tile's field stack, and
// the positions stay global.  Only the corner of each gather moves by the
// tile's origin (AdvanceArgs.tile_ox, tile_oy), clamped to the tile's
// tables as the reference's tile-local stencil is; the weights, the
// latitude, cosfact, the double-single update and the polar update run
// on the serial step's floats.  The boundary conditions run once, after
// the corrector, with the global grid's arguments (a particle that exits
// is killed there), and with POLAR a particle that took the caps' update
// skips the corrector.  So a tile's particle takes the serial step bit for
// bit unless the step wraps, mirrors, kills it or moves it by the caps'
// update.  Bound: the stock one (the same bytes).
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "cell_index.cuh"
#include "advance_common.cuh"
#include "philox_normal.cuh"

namespace {

// the part of the instantiations this library holds: -1 all, else a part
// of _build.Kernel's parts, which returns NOT_IN_PART for the others
#ifndef FP_PART
#define FP_PART -1
#endif
#define FP_HAS(part) (FP_PART < 0 || FP_PART == (part))
constexpr int NOT_IN_PART = -100;     // _build.NOT_IN_PART

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
// Blocks an SM must hold of K4 CBL's start and of its skewed launch
// (__launch_bounds__' second argument: a cap of 64 registers, 32 warps an
// SM).  Measured against 1 (PERF.md, section 6): the start then takes
// 70-94 registers, 16-24 warps, and is slower in cell order (faster as
// drawn); the skewed launch 71, 24 warps, 2% slower.
constexpr int MIN_BLOCKS_CBL_START = 4;
constexpr int MIN_BLOCKS_SKEWED = 4;

// The whole step of the particle in slot i, a thread a particle, HANNA1
// or TS.
template <bool BF16, int TURB, bool POLAR, bool SETTLING, bool NESTS,
          bool TILE>
__device__ __forceinline__ void advance_body(
    const PIn& in, const POut& out, const Draws& dr,
    const void* __restrict__ rows, const void* __restrict__ rowsE,
    const float* __restrict__ height, const float* __restrict__ mass0,
    const float* __restrict__ tt3, const float* __restrict__ rho3,
    int* __restrict__ counts, const AdvanceArgs& a) {
  extern __shared__ float sh_height[];
  for (int k = threadIdx.x; k < a.nz; k += blockDim.x) sh_height[k] = height[k];
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // parity mode: all five draw pointers are given, or none
  const bool injected = dr.d[0] != nullptr;
  bool keep = false;
  bool exited = false;
  if (i < a.n) {
    float x_hi = in.x_hi[i], x_lo = in.x_lo[i];
    float y_hi = in.y_hi[i], y_lo = in.y_lo[i];
    float z_new = in.z[i];
    float up = in.up[i], vp = in.vp[i], wp = in.wp[i];
    float usig = in.usig[i], vsig = in.vsig[i], wsig = in.wsig[i];
    int cbt = in.cbt[i];
    int itra = in.itra[i];
    const bool scheduled = in.active[i] != 0;
    if (scheduled) {
      const float x = x_hi + x_lo;
      const float y = y_hi + y_lo;
      const float z = z_new;
      const Start s = NESTS ? nest_start<BF16>(a, rows, sh_height, x, y, z)
                            : step_start<BF16, TILE>(a, rows, sh_height, x, y,
                                                     z);
      const float h = s.h;

      const float dt = a.dt;
      const bool pbl = (z / h) <= 1.0f;
      const float htop = sh_height[a.nz - 1] - a.htop_eps;
      const float hm = h - F(1e-9);
      // settling at the start height, in the boundary layer, in the free
      // troposphere and at the corrector
      float settl = 0.0f;
      if (SETTLING)
        settl = settle_at<TILE>(a, settle_setup<TILE>(a, mass0, i, x, y), tt3,
                                rho3, sh_height, z);
      const float w_eff = SETTLING ? s.w + settl : s.w;

      // the turbulence of the fresh state and the horizontal OU update
      Turb t0;
      if (pbl) t0 = hanna<TURB == TS>(z, h, s.ust, s.wst, s.ol);

      // newly released particles (initialize.f90:110-219)
      const bool fresh = (in.itramem[i] == a.itime) || (a.itime == 0);
      if (fresh)
        fresh_state<TURB>(a, dr, injected, i, pbl, t0, s, z, up, vp, wp,
                          usig, vsig, wsig, cbt);

      // Every particle takes up to three draws here: in the PBL tag 1 rows
      // 0, 1 and tag 2 row 0; above it tag 3 rows 0, 1 (below the
      // stratosphere) and row 2 (above the troposphere).  They are made at
      // one place with the site chosen per thread, so that a warp holding
      // both kinds of particle runs the generator once, not once per branch.
      // Above the boundary layer all three rows come from one Philox call
      // (tag 3, block 0); in it d0, d1 from tag 1's block 0 and d2 from tag
      // 2's, whose words `pw` the substep loop goes on reading.
      const bool in_trop = z < s.tropop;
      const bool in_trans = !in_trop && (z < s.tropop + 1000.0f);
      const bool need01 = pbl || in_trop || in_trans;
      const bool need2 = pbl || !in_trop;
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d2_odd = 0.0f;
      uint32_t pw[4] = {0u, 0u, 0u, 0u};
      if (injected) {
        const float* from = pbl ? dr.d[1] : dr.d[3];
        if (need01) {
          d0 = injected_at(from, a, i, 0);
          d1 = injected_at(from, a, i, 1);
        }
        if (need2)
          d2 = pbl ? injected_at(dr.d[2], a, i, 0) : injected_at(from, a, i, 2);
      } else {
        site_words(pw, a, pbl ? 1 : 3, i, 0u);
        if (need01) fp::normal_pair(pw[0], pw[1], d0, d1);
        if (need2) {
          if (pbl) site_words(pw, a, 2, i, 0u);
          fp::normal_pair(pbl ? pw[0] : pw[2], pbl ? pw[1] : pw[3], d2, d2_odd);
        }
      }

      float dxsave, dysave, dawsave, dcwsave;
      if (pbl) {
        // fixed-step PBL branch (advance.f90:276-615)
        up = ou_update(up, d0, t0.sigu, dt / t0.tlu);
        vp = ou_update(vp, d1, t0.sigv, dt / t0.tlv);
        if (a.turboff) {
          up = 0.0f;
          vp = 0.0f;
        }
        // the ifine vertical substeps; dtftlw and what derives from it
        // come from the interval start
        float zz = z;
        pbl_substeps<TURB>(a, dr.d[2], injected, i, 0u, t0, s.drhodz / s.rho,
                           a.dtf, d2, d2_odd, pw, h, s.ust, s.wst, s.ol, zz,
                           wp, cbt);
        dawsave = up * dt;
        dcwsave = vp * dt;
        dxsave = s.u * dt;
        dysave = s.v * dt;
        zz = zz + (w_eff * dt) * a.ldirf;
        zz = tmin(zz, htop);
        z_new = reflect_ground(zz, hm);
      } else {
        // free troposphere / stratosphere (advance.f90:629-708)
        float ux, vy, wp_ft;
        free_trop_terms(a, in_trop, in_trans, z, s.tropop, d0, d1, d2,
                        a.c_trop, a.c_strat, a.uxscale_t, a.wpscale_s, ux, vy,
                        wp_ft);
        dxsave = (s.u + ux) * dt;
        dysave = (s.v + vy) * dt;
        dawsave = 0.0f;
        dcwsave = 0.0f;
        wp = wp_ft;
        z_new = reflect_ground(z + ((w_eff + wp_ft) * dt) * a.ldirf, hm);
      }

      // mesoscale fluctuations (advance.f90:720-738)
      float m0, m1, m2;
      meso_draws(a, dr, injected, i, m0, m1, m2);
      exited = finish_step<BF16, POLAR, SETTLING, NESTS, TILE>(
          a, rowsE, sh_height, x, y, x_hi, x_lo, y_hi, y_lo, z_new, dxsave,
          dysave, dawsave, dcwsave, s.u, s.v, w_eff, settl, usig, vsig, wsig,
          s.usig_m, s.vsig_m, s.wsig_m, m0, m1, m2, hm, htop, true);
      keep = !exited;
      itra = a.itra_new;
    }
    out.x_hi[i] = x_hi;
    out.x_lo[i] = x_lo;
    out.y_hi[i] = y_hi;
    out.y_lo[i] = y_lo;
    out.z[i] = z_new;
    out.itra[i] = itra;
    out.up[i] = up;
    out.vp[i] = vp;
    out.wp[i] = wp;
    out.usig[i] = usig;
    out.vsig[i] = vsig;
    out.wsig[i] = wsig;
    out.cbt[i] = static_cast<int8_t>(cbt);
    out.active[i] = keep ? 1 : 0;
  }
  // counts[0] += particles still active, counts[1] += particles that
  // exited
  const unsigned kept = __ballot_sync(0xFFFFFFFFu, keep);
  const unsigned gone = __ballot_sync(0xFFFFFFFFu, exited);
  if ((threadIdx.x & 31) == 0) {
    if (kept) atomicAdd(&counts[0], __popc(kept));
    if (gone) atomicAdd(&counts[1], __popc(gone));
  }
}

template <bool BF16, int TURB, bool POLAR, bool SETTLING, bool NESTS>
__global__ void __launch_bounds__(THREADS)
advance_kernel(const PIn in, const POut out, const Draws dr,
               const void* __restrict__ rows, const void* __restrict__ rowsE,
               const float* __restrict__ height,
               const float* __restrict__ mass0, const float* __restrict__ tt3,
               const float* __restrict__ rho3, int* __restrict__ counts,
               const AdvanceArgs a) {
  advance_body<BF16, TURB, POLAR, SETTLING, NESTS, false>(
      in, out, dr, rows, rowsE, height, mass0, tt3, rho3, counts, a);
}

// K4 TILE: a tile's step (no nests), HANNA1 or TS
template <bool BF16, int TURB, bool POLAR, bool SETTLING>
__global__ void __launch_bounds__(THREADS)
advance_tile_kernel(const PIn in, const POut out, const Draws dr,
                    const void* __restrict__ rows,
                    const void* __restrict__ rowsE,
                    const float* __restrict__ height,
                    const float* __restrict__ mass0,
                    const float* __restrict__ tt3,
                    const float* __restrict__ rho3, int* __restrict__ counts,
                    const AdvanceArgs a) {
  advance_body<BF16, TURB, POLAR, SETTLING, false, true>(
      in, out, dr, rows, rowsE, height, mass0, tt3, rho3, counts, a);
}

// What a thread of K4 CBL does with its particle: its start (START: a
// particle whose substeps take the skewed branch is deferred, the
// substeps' state handed back in a SkewEntry and nothing written) or a
// deferred particle's end (FINISH: the start recomputed, bit for bit, and
// the substeps' outcome taken from its SkewEntry).
enum Stage : int { START = 1, FINISH = 2 };

// A deferred particle's substeps: their state at the start (z, raw wp,
// cbt, the start's h, u*, w*, L, rho, drho/dz) and, after the skewed
// substeps, their outcome (z, wp, cbt, nan).
struct SkewEntry {
  float z, wp, h, ust, wst, ol, rho, drhodz;
  int cbt;
  bool nan;
};

// What the step did with a particle.
struct Outcome {
  bool keep, exited, nan, deferred;
};

// The deferred particles (K4 CBL's scratch, core/advance.py's
// k4_cbl_queue: QUEUE_WORDS rows of `stride` words, K4_CBL_QUEUE_WORDS
// there, from torch.empty): entry k's field r at w[r * stride + k], ints
// by their bits; the queue's length in counts[3].
enum QueueRow : int {
  Q_SLOT, Q_Z, Q_WP, Q_CBT, Q_NAN, Q_H, Q_UST, Q_WST, Q_OL, Q_RHO, Q_DRHODZ,
  QUEUE_WORDS
};
struct Queue {
  float* w;
  long long stride;
};

__device__ __forceinline__ float& q_at(const Queue& q, int r, long long k) {
  return q.w[r * q.stride + k];
}

__device__ __forceinline__ void store_entry(const Queue& q, long long k,
                                            long long i, const SkewEntry& e) {
  q_at(q, Q_SLOT, k) = __int_as_float(static_cast<int>(i));
  q_at(q, Q_Z, k) = e.z;
  q_at(q, Q_WP, k) = e.wp;
  q_at(q, Q_CBT, k) = __int_as_float(e.cbt);
  q_at(q, Q_H, k) = e.h;
  q_at(q, Q_UST, k) = e.ust;
  q_at(q, Q_WST, k) = e.wst;
  q_at(q, Q_OL, k) = e.ol;
  q_at(q, Q_RHO, k) = e.rho;
  q_at(q, Q_DRHODZ, k) = e.drhodz;
}

// The slot of entry k, its state in e.
__device__ __forceinline__ long long load_entry(const Queue& q, long long k,
                                                SkewEntry& e) {
  e.z = q_at(q, Q_Z, k);
  e.wp = q_at(q, Q_WP, k);
  e.cbt = __float_as_int(q_at(q, Q_CBT, k));
  e.h = q_at(q, Q_H, k);
  e.ust = q_at(q, Q_UST, k);
  e.wst = q_at(q, Q_WST, k);
  e.ol = q_at(q, Q_OL, k);
  e.rho = q_at(q, Q_RHO, k);
  e.drhodz = q_at(q, Q_DRHODZ, k);
  return __float_as_int(q_at(q, Q_SLOT, k));
}

// The slot of entry k, its substeps' outcome in e.
__device__ __forceinline__ long long load_outcome(const Queue& q, long long k,
                                                  SkewEntry& e) {
  e.z = q_at(q, Q_Z, k);
  e.wp = q_at(q, Q_WP, k);
  e.cbt = __float_as_int(q_at(q, Q_CBT, k));
  e.nan = __float_as_int(q_at(q, Q_NAN, k)) != 0;
  return __float_as_int(q_at(q, Q_SLOT, k));
}

// The particle in slot i through the stage STAGE of K4 CBL's step: the
// step of advance_body with the skewed CBL's substeps, its draws in
// registers only (the launcher refuses injected draws).
template <bool BF16, bool POLAR, bool SETTLING, bool NESTS, bool TILE,
          int STAGE>
__device__ __forceinline__ Outcome cbl_one(
    const PIn& in, const POut& out, const Draws& dr,
    const void* __restrict__ rows, const void* __restrict__ rowsE,
    const float* sh_height, const float* __restrict__ mass0,
    const float* __restrict__ tt3, const float* __restrict__ rho3,
    const AdvanceArgs& a, long long i, SkewEntry& e) {
  bool keep = false;
  bool exited = false;
  bool nan = false;     // the CBL redrew a non-finite velocity
  float x_hi = in.x_hi[i], x_lo = in.x_lo[i];
  float y_hi = in.y_hi[i], y_lo = in.y_lo[i];
  float z_new = in.z[i];
  float up = in.up[i], vp = in.vp[i], wp = in.wp[i];
  float usig = in.usig[i], vsig = in.vsig[i], wsig = in.wsig[i];
  int cbt = in.cbt[i];
  int itra = in.itra[i];
  // a deferred particle is scheduled and in the boundary layer
  const bool scheduled = STAGE == FINISH || in.active[i] != 0;
  if (scheduled) {
    const float x = x_hi + x_lo;
    const float y = y_hi + y_lo;
    const float z = z_new;
    const Start s = NESTS ? nest_start<BF16>(a, rows, sh_height, x, y, z)
                          : step_start<BF16, TILE>(a, rows, sh_height, x, y,
                                                   z);
    const float h = s.h;

    const float dt = a.dt;
    const bool pbl = STAGE == FINISH || (z / h) <= 1.0f;
    const float htop = sh_height[a.nz - 1] - a.htop_eps;
    const float hm = h - F(1e-9);
    // settling at the start height, in the boundary layer, in the free
    // troposphere and at the corrector
    float settl = 0.0f;
    if (SETTLING)
      settl = settle_at<TILE>(a, settle_setup<TILE>(a, mass0, i, x, y), tt3,
                              rho3, sh_height, z);
    const float w_eff = SETTLING ? s.w + settl : s.w;

    // the turbulence of the fresh state and the horizontal OU update:
    // with the CBL, Hanna's turbswitch form or without turbswitch hanna1
    // (flexpart_tpu/core/advance.py:900, :1020)
    Turb t0;
    if (pbl)
      t0 = a.turbswitch ? hanna<true>(z, h, s.ust, s.wst, s.ol)
                        : hanna<false>(z, h, s.ust, s.wst, s.ol);

    // newly released particles (initialize.f90:110-219)
    const bool fresh = (in.itramem[i] == a.itime) || (a.itime == 0);
    if (fresh)
      fresh_state<CBL>(a, dr, false, i, pbl, t0, s, z, up, vp, wp, usig,
                       vsig, wsig, cbt);

    // Every particle takes up to three draws here: in the PBL tag 1 rows
    // 0, 1 and tag 2 row 0; above it tag 3 rows 0, 1 (below the
    // stratosphere) and row 2 (above the troposphere).  They are made at
    // one place with the site chosen per thread, so that a warp holding
    // both kinds of particle runs the generator once, not once per branch.
    // Above the boundary layer all three rows come from one Philox call
    // (tag 3, block 0); in it d0, d1 from tag 1's block 0 and d2 from tag
    // 2's, whose words `pw` the substep loop goes on reading.
    const bool in_trop = z < s.tropop;
    const bool in_trans = !in_trop && (z < s.tropop + 1000.0f);
    const bool need01 = pbl || in_trop || in_trans;
    const bool need2 = pbl || !in_trop;
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d2_odd = 0.0f;
    uint32_t pw[4] = {0u, 0u, 0u, 0u};
    site_words(pw, a, pbl ? 1 : 3, i, 0u);
    if (need01) fp::normal_pair(pw[0], pw[1], d0, d1);
    if (need2) {
      if (pbl) site_words(pw, a, 2, i, 0u);
      fp::normal_pair(pbl ? pw[0] : pw[2], pbl ? pw[1] : pw[3], d2, d2_odd);
    }

    float dxsave, dysave, dawsave, dcwsave;
    if (pbl) {
      // fixed-step PBL branch (advance.f90:276-615)
      up = ou_update(up, d0, t0.sigu, dt / t0.tlu);
      vp = ou_update(vp, d1, t0.sigv, dt / t0.tlv);
      if (a.turboff) {
        up = 0.0f;
        vp = 0.0f;
      }
      // the ifine vertical substeps; dtftlw and what derives from it
      // come from the interval start
      float zz = z;
      if constexpr (STAGE == FINISH) {
        zz = e.z;
        wp = e.wp;
        cbt = e.cbt;
        nan = e.nan;
      } else {
        // the skewed CBL's substeps take Hanna's turbswitch form whatever
        // turbswitch (flexpart_tpu/core/advance.py:308, :493), their
        // redraws tag 40 + s of the unfolded stream (pass 0) and the
        // column's constants once
        const Turb tw = a.turbswitch ? t0
                                     : hanna<true>(z, h, s.ust, s.wst, s.ol);
        const SkewColumn col = skew_column(h, s.wst, s.ol);
        // the skewed branch (cbl_substeps': in the zone, dtftlw < 0.5) is
        // deferred to the dense launch
        if (col.zone && a.dtf / tw.tlw < 0.5f) {
          e = SkewEntry{z, wp, h, s.ust, s.wst, s.ol, s.rho, s.drhodz, cbt,
                        false};
          return Outcome{false, false, false, true};
        }
        cbl_substeps<false>(a, i, 0u, tw, a.dtf, d2, d2_odd, pw, h, s.ust,
                            s.wst, s.ol, col, s.rho, s.drhodz, zz, wp, cbt,
                            nan);
      }
      dawsave = up * dt;
      dcwsave = vp * dt;
      dxsave = s.u * dt;
      dysave = s.v * dt;
      zz = zz + (w_eff * dt) * a.ldirf;
      zz = tmin(zz, htop);
      z_new = reflect_ground(zz, hm);
    } else {
      // free troposphere / stratosphere (advance.f90:629-708)
      float ux, vy, wp_ft;
      free_trop_terms(a, in_trop, in_trans, z, s.tropop, d0, d1, d2,
                      a.c_trop, a.c_strat, a.uxscale_t, a.wpscale_s, ux, vy,
                      wp_ft);
      dxsave = (s.u + ux) * dt;
      dysave = (s.v + vy) * dt;
      dawsave = 0.0f;
      dcwsave = 0.0f;
      wp = wp_ft;
      z_new = reflect_ground(z + ((w_eff + wp_ft) * dt) * a.ldirf, hm);
    }

    // mesoscale fluctuations (advance.f90:720-738)
    float m0, m1, m2;
    meso_draws(a, dr, false, i, m0, m1, m2);
    exited = finish_step<BF16, POLAR, SETTLING, NESTS, TILE>(
        a, rowsE, sh_height, x, y, x_hi, x_lo, y_hi, y_lo, z_new, dxsave,
        dysave, dawsave, dcwsave, s.u, s.v, w_eff, settl, usig, vsig, wsig,
        s.usig_m, s.vsig_m, s.wsig_m, m0, m1, m2, hm, htop, true);
    keep = !exited;
    itra = a.itra_new;
  }
  out.x_hi[i] = x_hi;
  out.x_lo[i] = x_lo;
  out.y_hi[i] = y_hi;
  out.y_lo[i] = y_lo;
  out.z[i] = z_new;
  out.itra[i] = itra;
  out.up[i] = up;
  out.vp[i] = vp;
  out.wp[i] = wp;
  out.usig[i] = usig;
  out.vsig[i] = vsig;
  out.wsig[i] = wsig;
  out.cbt[i] = static_cast<int8_t>(cbt);
  out.active[i] = keep ? 1 : 0;
  return Outcome{keep, exited, nan, false};
}



// counts[0] += particles still active, counts[1] += particles that exited,
// counts[2] += particles with a NaN redraw: a ballot each and one
// atomicAdd a warp.
__device__ __forceinline__ void count_outcome(const Outcome& o,
                                              int* __restrict__ counts) {
  const unsigned kept = __ballot_sync(FULL, o.keep);
  const unsigned gone = __ballot_sync(FULL, o.exited);
  if ((threadIdx.x & 31) == 0) {
    if (kept) atomicAdd(&counts[0], __popc(kept));
    if (gone) atomicAdd(&counts[1], __popc(gone));
  }
  const unsigned nans = __ballot_sync(FULL, o.nan);
  if ((threadIdx.x & 31) == 0 && nans) atomicAdd(&counts[2], __popc(nans));
}

__device__ __forceinline__ void load_height(float* sh_height,
                                            const float* __restrict__ height,
                                            int nz) {
  for (int k = threadIdx.x; k < nz; k += blockDim.x) sh_height[k] = height[k];
  __syncthreads();
}

// K4 CBL, on the grid or a tile, is three launches (the design in the
// header); each takes the run scalars as a __grid_constant__ parameter
// read in place (as K11's): the substeps index the redraws' keys
// (key_cbl) by the substep, for which a by-value parameter is first
// copied whole to the thread's stack (1336 B a thread, ptxas' stack
// frame).
//
// 1. The start (advance_cbl_kernel): a thread a particle, the whole step
// but for the particles whose substeps take the skewed branch, which are
// deferred: each warp appends its deferred particles' SkewEntry to the
// queue with one atomicAdd on counts[3], in lane order.
template <bool BF16, bool POLAR, bool SETTLING, bool NESTS, bool TILE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_CBL_START)
advance_cbl_kernel(const PIn in, const POut out, const Draws dr,
                   const void* __restrict__ rows,
                   const void* __restrict__ rowsE,
                   const float* __restrict__ height,
                   const float* __restrict__ mass0,
                   const float* __restrict__ tt3,
                   const float* __restrict__ rho3, int* __restrict__ counts,
                   const Queue q, const __grid_constant__ AdvanceArgs a) {
  extern __shared__ float sh_height[];
  load_height(sh_height, height, a.nz);
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  SkewEntry e;
  Outcome o{false, false, false, false};
  if (i < a.n)
    o = cbl_one<BF16, POLAR, SETTLING, NESTS, TILE, START>(
        in, out, dr, rows, rowsE, sh_height, mass0, tt3, rho3, a, i, e);
  const unsigned lane = threadIdx.x & 31;
  const unsigned deferred = __ballot_sync(FULL, o.deferred);
  int at = 0;
  if (lane == 0 && deferred) at = atomicAdd(&counts[3], __popc(deferred));
  at = __shfl_sync(FULL, at, 0) + __popc(deferred & ((1u << lane) - 1u));
  if (o.deferred) store_entry(q, at, i, e);
  count_outcome(o, counts);
}

// 2. The skewed substeps of queue entry k: the Hanna turbulence at the
// start height in its turbswitch form (which is the start's `tw` whatever
// turbswitch), the column's constants, row 0's Philox words of tag 2 and
// cbl_substeps, every substep in the skewed branch; the outcome back into
// the entry.
__device__ __forceinline__ void skewed_substeps(const Queue& q, long long k,
                                                const AdvanceArgs& a) {
  SkewEntry e;
  const long long i = load_entry(q, k, e);
  const Turb tw = hanna<true>(e.z, e.h, e.ust, e.wst, e.ol);
  uint32_t pw[4];
  site_words(pw, a, 2, i, 0u);
  float d2, d2_odd;
  fp::normal_pair(pw[0], pw[1], d2, d2_odd);
  float zz = e.z, wp = e.wp;
  int cbt = e.cbt;
  bool nan = false;
  cbl_substeps(a, i, 0u, tw, a.dtf, d2, d2_odd, pw, e.h, e.ust, e.wst, e.ol,
               skew_column(e.h, e.wst, e.ol), e.rho, e.drhodz, zz, wp, cbt,
               nan);
  q_at(q, Q_Z, k) = zz;
  q_at(q, Q_WP, k) = wp;
  q_at(q, Q_CBT, k) = __int_as_float(cbt);
  q_at(q, Q_NAN, k) = __int_as_float(nan ? 1 : 0);
}

// The skewed launch (advance_cbl_skewed_kernel): the queue's entries in
// order over consecutive lanes, the blocks striding over it, so
// every lane of a warp but the last warp's runs the skewed branch; one
// kernel for every instantiation (nothing in it depends on the table, the
// nests, settling, the polar caps or the tile), its own register budget.
#if FP_PART < 0 || FP_PART >= 6
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_SKEWED)
advance_cbl_skewed_kernel(const Queue q, const int* __restrict__ queued,
                          const __grid_constant__ AdvanceArgs a) {
  const long long n = *queued;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long k = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       k < n; k += step)
    skewed_substeps(q, k, a);
}
#endif

// 3. The end of the deferred particles (advance_cbl_finish_kernel): the
// queue's entries in order, a thread each, the blocks striding
// over it; each thread recomputes its particle's start and takes the
// substeps' outcome from the entry, then ends the step as the start
// ends the others.
template <bool BF16, bool POLAR, bool SETTLING, bool NESTS, bool TILE>
__global__ void __launch_bounds__(THREADS)
advance_cbl_finish_kernel(const PIn in, const POut out, const Draws dr,
                          const void* __restrict__ rows,
                          const void* __restrict__ rowsE,
                          const float* __restrict__ height,
                          const float* __restrict__ mass0,
                          const float* __restrict__ tt3,
                          const float* __restrict__ rho3,
                          int* __restrict__ counts, const Queue q,
                          const __grid_constant__ AdvanceArgs a) {
  extern __shared__ float sh_height[];
  load_height(sh_height, height, a.nz);
  const long long n = counts[3];
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS;
       base < n; base += step) {
    const long long k = base + threadIdx.x;
    SkewEntry e;
    Outcome o{false, false, false, false};
    if (k < n) {
      const long long i = load_outcome(q, k, e);
      o = cbl_one<BF16, POLAR, SETTLING, NESTS, TILE, FINISH>(
          in, out, dr, rows, rowsE, sh_height, mass0, tt3, rho3, a, i, e);
    }
    count_outcome(o, counts);
  }
}

#if FP_PART < 0 || FP_PART >= 6
// The skewed launch and the end stride over the queue with at most this
// many blocks: 8 of THREADS an SM of the H100's 132.
constexpr unsigned STRIDED_BLOCKS = 132 * (2048 / THREADS);

// An instantiation of K4 CBL's start and end: table type, polar,
// settling, nests, tile.
template <bool B_, bool P_, bool S_, bool N_, bool T_>
struct Cbl {
  static constexpr bool B = B_, P = P_, S = S_, N = N_, T = T_;
};

// f(Cbl<bf16, polar, settling, nests, tile>{}) for K4 CBL's
// instantiation of `a`: the skewed CBL (turbswitch on or off: a uniform
// branch) on the grid, with nests or on a tile, each by (table type,
// polar, settling).  A library built as one part (FP_PART) holds the CBL
// (part 6), the CBL with nests (part 7) or the CBL on a tile (part 8),
// and returns NOT_IN_PART for the others.
template <class F>
int with_cbl(const AdvanceArgs& a, F&& f) {
  using Yes = std::true_type;
  using No = std::false_type;
  auto by = [&](auto bf16, auto nests, auto on_tile) -> int {
    constexpr bool B = decltype(bf16)::value;
    constexpr bool N = decltype(nests)::value;
    constexpr bool T = decltype(on_tile)::value;
    return a.settling ? (a.polar ? f(Cbl<B, true, true, N, T>{})
                                 : f(Cbl<B, false, true, N, T>{}))
                      : (a.polar ? f(Cbl<B, true, false, N, T>{})
                                 : f(Cbl<B, false, false, N, T>{}));
  };
  if (a.tile) {
#if FP_HAS(8)
    return a.table_bf16 ? by(Yes{}, No{}, Yes{}) : by(No{}, No{}, Yes{});
#else
    return NOT_IN_PART;
#endif
  }
  if (a.nnest > 0) {
#if FP_HAS(7)
    return a.table_bf16 ? by(Yes{}, Yes{}, No{}) : by(No{}, Yes{}, No{});
#else
    return NOT_IN_PART;
#endif
  }
#if FP_HAS(6)
  return a.table_bf16 ? by(Yes{}, No{}, No{}) : by(No{}, No{}, No{});
#else
  return NOT_IN_PART;
#endif
}
#endif

}  // namespace

extern "C" int fp_advance(
    const float* x_hi, const float* x_lo, const float* y_hi, const float* y_lo,
    const float* z, const int* itra, const int* itramem, const float* up,
    const float* vp, const float* wp, const float* usig, const float* vsig,
    const float* wsig, const int8_t* cbt, const uint8_t* active,
    float* o_x_hi, float* o_x_lo, float* o_y_hi, float* o_y_lo, float* o_z,
    int* o_itra, float* o_up, float* o_vp, float* o_wp, float* o_usig,
    float* o_vsig, float* o_wsig, int8_t* o_cbt, uint8_t* o_active,
    const float* d6, const float* d1, const float* d2, const float* d3,
    const float* d4, const void* rows, const void* rowsE, const float* height,
    const float* mass0, const float* tt, const float* rho, int* counts,
    const AdvanceArgs* args, void* queue, void* stream) {
  const AdvanceArgs a = *args;
  if (a.n <= 0) return 0;
  const size_t shmem = static_cast<size_t>(a.nz) * sizeof(float);
  if (a.nz < 2 || shmem > 48 * 1024 || a.ifine < 1 || a.method != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // settling with the species' parameters and the two fields
  if (a.settling && (a.nspec < 1 || a.nspec > MAX_SPECIES ||
                     mass0 == nullptr || tt == nullptr || rho == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // nests, each with its tables
  if (a.nnest < 0 || a.nnest > MAX_NESTS)
    return static_cast<int>(cudaErrorInvalidValue);
  // a tile: no nests, tables of 2 x 2 cells at least
  if (a.tile && (a.nnest > 0 || a.tile_nx < 2 || a.tile_ny < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  // the CBL: its substeps draw with their own keys, in registers only
  if (a.cblflag && (a.ifine > MAX_CBL_SUBSTEPS || d6 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // and its queue of deferred particles: QUEUE_WORDS rows of a.n words
  if (a.cblflag && queue == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < a.nnest; ++k)
    if (a.nest_rows[k] == nullptr || a.nest_rows_e[k] == nullptr ||
        a.nest_nx[k] < 2 || a.nest_ny[k] < 2)
      return static_cast<int>(cudaErrorInvalidValue);
  const PIn in = {x_hi, x_lo, y_hi, y_lo, z, itra, itramem, up, vp, wp,
                  usig, vsig, wsig, cbt, active};
  const POut out = {o_x_hi, o_x_lo, o_y_hi, o_y_lo, o_z, o_itra, o_up, o_vp,
                    o_wp, o_usig, o_vsig, o_wsig, o_cbt, o_active};
  const Draws dr = {{d6, d1, d2, d3, d4}};
  const int threads = THREADS;
  const unsigned blocks = static_cast<unsigned>((a.n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kern) {
    kern<<<blocks, threads, shmem, st>>>(in, out, dr, rows, rowsE, height,
                                         mass0, tt, rho, counts, a);
    return static_cast<int>(cudaGetLastError());
  };
  // K4 CBL: the start, the skewed substeps and the deferred particles' end,
  // the last two striding over the queue (at most the start's blocks), each
  // launch's error returned
  if (a.cblflag) {
#if FP_PART < 0 || FP_PART >= 6
    const Queue q = {static_cast<float*>(queue), a.n};
    const unsigned strided = blocks < STRIDED_BLOCKS ? blocks : STRIDED_BLOCKS;
    return with_cbl(a, [&](auto k) -> int {
      using K = decltype(k);
      advance_cbl_kernel<K::B, K::P, K::S, K::N, K::T>
          <<<blocks, threads, shmem, st>>>(in, out, dr, rows, rowsE, height,
                                           mass0, tt, rho, counts, q, a);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      advance_cbl_skewed_kernel<<<strided, threads, 0, st>>>(q, counts + 3, a);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      advance_cbl_finish_kernel<K::B, K::P, K::S, K::N, K::T>
          <<<strided, threads, shmem, st>>>(in, out, dr, rows, rowsE, height,
                                            mass0, tt, rho, counts, q, a);
      return static_cast<int>(cudaGetLastError());
    });
#else
    return NOT_IN_PART;
#endif
  }
  // The crosses of TS with settling, nests and a tile, each by (table
  // type, polar, settling).  A library built as one part (FP_PART,
  // _build.Kernel's parts) holds TS with settling or nests (part 4) or TS
  // on a tile (part 5).
  using Yes = std::true_type;
  using No = std::false_type;
  auto ts_nests = [&](auto bf16) {
    constexpr bool B = decltype(bf16)::value;
    return a.settling
        ? (a.polar ? advance_kernel<B, TS, true, true, true>
                   : advance_kernel<B, TS, false, true, true>)
        : (a.polar ? advance_kernel<B, TS, true, false, true>
                   : advance_kernel<B, TS, false, false, true>);
  };
  auto ts_tile = [&](auto bf16) {
    constexpr bool B = decltype(bf16)::value;
    return a.settling
        ? (a.polar ? advance_tile_kernel<B, TS, true, true>
                   : advance_tile_kernel<B, TS, false, true>)
        : (a.polar ? advance_tile_kernel<B, TS, true, false>
                   : advance_tile_kernel<B, TS, false, false>);
  };
  if (a.turbswitch && a.tile) {
#if FP_HAS(5)
    return a.table_bf16 ? launch(ts_tile(Yes{})) : launch(ts_tile(No{}));
#else
    return NOT_IN_PART;
#endif
  }
  if (a.turbswitch && a.nnest > 0) {
#if FP_HAS(4)
    return a.table_bf16 ? launch(ts_nests(Yes{})) : launch(ts_nests(No{}));
#else
    return NOT_IN_PART;
#endif
  }
  if (a.turbswitch && a.settling) {
#if FP_HAS(4)
    return launch(a.table_bf16
        ? (a.polar ? advance_kernel<true, TS, true, true, false>
                   : advance_kernel<true, TS, false, true, false>)
        : (a.polar ? advance_kernel<false, TS, true, true, false>
                   : advance_kernel<false, TS, false, true, false>));
#else
    return NOT_IN_PART;
#endif
  }
  // the eight (table type, turbswitch, polar) instantiations of the stock
  // step, settling's four (table type, polar) with turbswitch off, the
  // nests' eight (table type, polar, settling) with turbswitch off and the
  // tile's eight (table type, polar, settling) with turbswitch off; a
  // library built as one part holds the first twelve on f32 tables (part
  // 0) or on bf16 tables (part 1), the nests' (part 2) or the tile's (part
  // 3), and launches nothing for the others' configurations
  if (a.tile) {
#if FP_HAS(3)
    return launch(a.settling
      ? (a.polar
             ? (a.table_bf16 ? advance_tile_kernel<true, HANNA1, true, true>
                             : advance_tile_kernel<false, HANNA1, true, true>)
             : (a.table_bf16 ? advance_tile_kernel<true, HANNA1, false, true>
                             : advance_tile_kernel<false, HANNA1, false, true>))
      : (a.polar
             ? (a.table_bf16 ? advance_tile_kernel<true, HANNA1, true, false>
                             : advance_tile_kernel<false, HANNA1, true, false>)
             : (a.table_bf16 ? advance_tile_kernel<true, HANNA1, false, false>
                             : advance_tile_kernel<false, HANNA1, false, false>)));
#else
    return NOT_IN_PART;
#endif
  }
  if (a.nnest > 0) {
#if FP_HAS(2)
    return launch(a.settling
      ? (a.polar
             ? (a.table_bf16 ? advance_kernel<true, HANNA1, true, true, true>
                             : advance_kernel<false, HANNA1, true, true, true>)
             : (a.table_bf16 ? advance_kernel<true, HANNA1, false, true, true>
                             : advance_kernel<false, HANNA1, false, true, true>))
      : (a.polar
             ? (a.table_bf16 ? advance_kernel<true, HANNA1, true, false, true>
                             : advance_kernel<false, HANNA1, true, false, true>)
             : (a.table_bf16 ? advance_kernel<true, HANNA1, false, false, true>
                             : advance_kernel<false, HANNA1, false, false, true>)));
#else
    return NOT_IN_PART;
#endif
  }
  if (a.table_bf16) {
#if FP_HAS(1)
    return launch(a.settling
        ? (a.polar ? advance_kernel<true, HANNA1, true, true, false>
                   : advance_kernel<true, HANNA1, false, true, false>)
        : a.polar
        ? (a.turbswitch ? advance_kernel<true, TS, true, false, false>
                        : advance_kernel<true, HANNA1, true, false, false>)
        : (a.turbswitch ? advance_kernel<true, TS, false, false, false>
                        : advance_kernel<true, HANNA1, false, false, false>));
#else
    return NOT_IN_PART;
#endif
  }
#if FP_HAS(0)
  return launch(a.settling
      ? (a.polar ? advance_kernel<false, HANNA1, true, true, false>
                 : advance_kernel<false, HANNA1, false, true, false>)
      : a.polar
      ? (a.turbswitch ? advance_kernel<false, TS, true, false, false>
                      : advance_kernel<false, HANNA1, true, false, false>)
      : (a.turbswitch ? advance_kernel<false, TS, false, false, false>
                      : advance_kernel<false, HANNA1, false, false, false>));
#else
  return NOT_IN_PART;
#endif
}

// K4 CBL's occupancy on this card for the instantiation of *args: the
// blocks of THREADS an SM holds of its start, its skewed launch and its
// end (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the start and the
// end with args->nz floats of shared memory) into blocks[0..2].  Launches
// nothing.
extern "C" int fp_advance_cbl_layout(const AdvanceArgs* args, int* blocks) {
#if FP_PART < 0 || FP_PART >= 6
  const size_t shmem = static_cast<size_t>(args->nz) * sizeof(float);
  return with_cbl(*args, [&](auto k) -> int {
    using K = decltype(k);
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[0], advance_cbl_kernel<K::B, K::P, K::S, K::N, K::T>,
        THREADS, shmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[1], advance_cbl_skewed_kernel, THREADS, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[2], advance_cbl_finish_kernel<K::B, K::P, K::S, K::N, K::T>,
          THREADS, shmem);
    return static_cast<int>(e);
  });
#else
  return NOT_IN_PART;
#endif
}

#if defined(FP_CBL_LANES) && FP_CBL_LANES
// The measurement build's lane counts (count_cbl_lanes, advance_common.cuh)
// into out (2,) u64 on the host: the warp entries of the skewed substep and
// their active lanes since the last read; zeroed after.  The caller
// synchronises the card first.
extern "C" int fp_cbl_lanes(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, cbl_lanes, 2 * sizeof(*out));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[2] = {0ull, 0ull};
  return static_cast<int>(cudaMemcpyToSymbol(cbl_lanes, zero, sizeof(zero)));
}
#endif

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
// selects; the selected value is the same.
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
#include <cstdint>
#include <cuda_runtime.h>

#include "cell_index.cuh"
#include "philox_normal.cuh"

#define F(x) static_cast<float>(x)

// Run scalars; mirrored field for field by core/advance.py::AdvanceArgs.
struct AdvanceArgs {
  long long offset;    // global index of particle 0 (the draw counter)
  int n;
  int nx;
  int ny;
  int nz;
  int xglobal;
  int turbswitch;
  int ifine;
  int table_bf16;
  int polar;           // the grid takes the polar-cap update (POLAR)
  int can_pett;        // host decision: the interval ends inside the met window
  int itime;
  int itra_new;
  uint32_t key[10];    // (k0, k1) for the draw tags 6, 1, 2, 3, 4
  float dt;            // lsynctime
  float dtf;           // f32(dt) * f32(fine)
  float ldirf;
  float htop_eps;
  float c_trop;        // f32(2 D_TROP) / f32(dt)
  float c_strat;       // f32(2 D_STRAT) / f32(dt)
  float uxscale_t;     // sqrt(c_trop)
  float wpscale_s;     // sqrt(c_strat)
  float d_strat_1000;  // D_STRAT / 1000
  float r_meso;
  float rs_meso;
  float turbmeso;
  float pi180;
  float dx;
  float dy;
  float ylat0;
  float xlon0;         // grid lon origin of the polar-cap projection
  float dxconst;
  float dyconst;
  float nxm;           // nx - 1
  float nym;           // ny - 1
  float two_nym;
  float eps_bc;
  float nxm_eps;       // f32(nxm) - f32(eps_bc)
};

namespace {

constexpr double PI = 3.14159265358979323846;
constexpr double PI180 = PI / 180.0;
constexpr double R_EARTH = 6.371e6;
constexpr double SWITCHNORTH = 75.0;    // polar-cap thresholds (par_mod.f90:123)
constexpr double SWITCHSOUTH = -75.0;

struct PIn {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const int *itra, *itramem;
  const float *up, *vp, *wp, *usig, *vsig, *wsig;
  const int8_t* cbt;
  const uint8_t* active;
};

struct POut {
  float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  int* itra;
  float *up, *vp, *wp, *usig, *vsig, *wsig;
  int8_t* cbt;
  uint8_t* active;
};

struct Draws {
  const float* d[5];   // tags 6, 1, 2, 3, 4; all null: draw in registers
};

struct Turb {
  float sigu, sigv, sigw, dsigwdz, dsigw2dz, tlu, tlv, tlw;
};

// torch.minimum / clamp semantics: a NaN operand comes through.
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
using fp::clamp;
using fp::Horiz;
using fp::horiz_weights;
using fp::vert_weights;

// Error-free two-sum accumulate (core/state.py::ds_add); the intrinsics
// are never contracted or reassociated.
__device__ __forceinline__ void ds_add(float& hi, float& lo, float d) {
  const float s = __fadd_rn(hi, d);
  const float bb = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(d, bb));
  const float lo2 = __fadd_rn(lo, err);
  const float hi2 = __fadd_rn(s, lo2);
  lo = __fsub_rn(lo2, __fsub_rn(hi2, s));
  hi = hi2;
}

// Lanes 8*group .. 8*group+7 of one row of a table of LANES lanes, as f32.
template <bool BF16, int LANES>
__device__ __forceinline__ void load8(const void* table, size_t row, int group,
                                      float* out) {
  if (BF16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const char*>(table) + row * (2 * LANES)) + group);
    out[0] = __uint_as_float(q.x << 16);
    out[1] = __uint_as_float(q.x & 0xFFFF0000u);
    out[2] = __uint_as_float(q.y << 16);
    out[3] = __uint_as_float(q.y & 0xFFFF0000u);
    out[4] = __uint_as_float(q.z << 16);
    out[5] = __uint_as_float(q.z & 0xFFFF0000u);
    out[6] = __uint_as_float(q.w << 16);
    out[7] = __uint_as_float(q.w & 0xFFFF0000u);
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const char*>(table) + row * (4 * LANES)) + 2 * group;
    const float4 a = __ldg(p);
    const float4 b = __ldg(p + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
}

// sum_c g[base+c] * p4[c], corners left to right.
__device__ __forceinline__ float dot4(const float* g, int base, const float* p4) {
  return ((g[base] * p4[0] + g[base + 1] * p4[1]) + g[base + 2] * p4[2])
         + g[base + 3] * p4[3];
}

// One wind-like field: two levels of four corners at g[8f..8f+7].
__device__ __forceinline__ float field2(const float* g, int f, const float* p4,
                                        float dz1) {
  const float lev0 = dot4(g, 8 * f, p4);
  const float lev1 = dot4(g, 8 * f + 4, p4);
  return lev0 * (1.0f - dz1) + lev1 * dz1;
}

__device__ __forceinline__ float small_ol(float ol) {
  if (fabsf(ol) < F(1e-6)) {
    const float s = ol > 0.0f ? 1.0f : (ol < 0.0f ? -1.0f : 0.0f);
    return s * F(1e-6) + F(1e-12);
  }
  return ol;
}

// Unstable-regime TL_w (hanna.f90:76-83).
__device__ __forceinline__ float tlw_unstable(float z, float zeta, float ol,
                                              float h, float sigw) {
  sigw = clamp_min(sigw, F(1.0e-6));
  if (z < fabsf(ol))
    return (F(0.1) * z) / (sigw * (F(0.55) - F(0.38) * fabsf(z / ol)));
  if (zeta < F(0.1)) return (F(0.59) * z) / sigw;
  return ((F(0.15) * h) / sigw) * (1.0f - expf(-5.0f * zeta));
}

// core/hanna.py::hanna (TS) and ::hanna1 (!TS): only the particle's own
// stability regime is computed.
template <bool TS>
__device__ Turb hanna(float z, float h, float ust, float wst, float ol) {
  const float zeta = clamp(z / h, 0.0f, 1.0f);
  ust = clamp_min(ust, F(1.0e-4));
  const float ols = small_ol(ol);
  const bool neutral = h / fabsf(ols) < 1.0f;
  const bool unstable = !neutral && ols < 0.0f;
  Turb t;
  t.dsigwdz = 0.0f;
  t.dsigw2dz = 0.0f;
  if (neutral) {
    const float corr = z / ust;
    float tl;
    if (TS) {
      t.sigu = F(1.0e-2) + (2.0f * ust) * expf(F(-3.0e-4) * corr);
      const float sigw_n0 = (F(1.3) * ust) * expf(F(-2.0e-4) * corr);
      t.dsigwdz = F(-2.0e-4) * sigw_n0;
      t.sigw = sigw_n0 + F(1.0e-2);
    } else {
      t.sigu = clamp_min((2.0f * ust) * expf(F(-3.0e-4) * corr), F(1.0e-5));
      t.sigw = clamp_min((F(1.3) * ust) * expf(F(-2.0e-4) * corr), F(1.0e-5));
      t.dsigw2dz = (F(-6.76e-4) * ust) * expf(F(-4.0e-4) * corr);
    }
    tl = ((0.5f * z) / t.sigw) / (1.0f + F(1.5e-3) * corr);
    t.sigv = t.sigw;
    t.tlu = tl;
    t.tlv = tl;
    t.tlw = tl;
  } else if (unstable) {
    const float base = 12.0f - (0.5f * h) / ols;
    if (TS) {
      const float zeta_c = clamp_min(zeta, F(1.0e-3));
      t.sigu = F(1.0e-2) + ust * powf(base, F(1.0 / 3.0));
      const float p23 = powf(zeta_c, F(2.0 / 3.0));
      t.sigw = sqrtf(clamp_min(
                   ((F(1.2) * (wst * wst)) * (1.0f - F(0.9) * zeta)) * p23
                       + (F(1.8) - F(1.4) * zeta) * (ust * ust),
                   F(1e-12))) + F(1.0e-2);
      t.dsigwdz = ((0.5f / t.sigw) / h)
                  * (F(-1.4) * (ust * ust)
                     + (wst * wst) * (F(0.8) * powf(zeta_c, F(-1.0 / 3.0))
                                      - F(1.8) * p23));
    } else {
      t.sigu = clamp_min(ust * powf(base, F(1.0 / 3.0)), F(1.0e-6));
      const float zeta_c = clamp_min(zeta, F(1.0e-4));
      const float a = clamp_min(3.0f * zeta_c - ols / h, F(1e-8));
      // sigw profile: s1 below 0.03, min(s1, s2) below 0.4, s3 below 0.96,
      // then the constant s4
      const bool low = zeta < F(0.03);
      const bool mid = !low && zeta < F(0.4);
      float fac = F(0.37);
      float ds = 0.0f;
      if (low || mid) {
        fac = F(0.96) * powf(a, F(1.0 / 3.0));
        const float s2 = mid ? F(0.763) * powf(zeta_c, F(0.175)) : 0.0f;
        if (low || fac < s2) {
          ds = (((F(1.8432) * wst) * wst) / h) * powf(a, F(-1.0 / 3.0));
        } else {
          fac = s2;
          ds = (((F(0.203759) * wst) * wst) / h) * powf(zeta_c, F(-0.65));
        }
      } else if (zeta < F(0.96)) {
        const float omz = clamp_min(1.0f - zeta, F(1e-6));
        fac = F(0.722) * powf(omz, F(0.207));
        ds = (((F(-0.215812) * wst) * wst) / h) * powf(omz, F(-0.586));
      }
      t.sigw = clamp_min(wst * fac, F(1.0e-6));
      t.dsigw2dz = ds;
    }
    t.sigv = t.sigu;
    t.tlu = (F(0.15) * h) / t.sigu;
    t.tlv = t.tlu;
    t.tlw = tlw_unstable(z, zeta, ols, h, t.sigw);
  } else {
    const float omz = 1.0f - zeta;
    float tlu_s;
    if (TS) {
      const float zeta_c = clamp_min(zeta, F(1.0e-3));
      t.sigu = F(1.0e-2) + (2.0f * ust) * omz;
      t.sigv = F(1.0e-2) + (F(1.3) * ust) * omz;
      t.dsigwdz = (F(-1.3) * ust) / h;
      tlu_s = ((F(0.15) * h) / clamp_min(t.sigu, F(1e-6))) * sqrtf(zeta_c);
      t.tlw = ((F(0.1) * h) / clamp_min(t.sigv, F(1e-6)))
              * powf(zeta_c, F(0.8));
    } else {
      const float zeta_c = clamp_min(zeta, F(1e-8));
      t.sigu = clamp_min((2.0f * ust) * omz, F(1.0e-6));
      t.sigv = clamp_min((F(1.3) * ust) * omz, F(1.0e-6));
      t.dsigw2dz = (((F(3.38) * ust) * ust) * (zeta - 1.0f)) / h;
      tlu_s = ((F(0.15) * h) / t.sigu) * sqrtf(zeta_c);
      t.tlw = ((F(0.1) * h) / t.sigv) * powf(zeta_c, F(0.8));
    }
    t.sigw = t.sigv;
    t.tlu = tlu_s;
    t.tlv = F(0.467) * tlu_s;
  }
  t.tlu = clamp_min(t.tlu, 10.0f);
  t.tlv = clamp_min(t.tlv, 10.0f);
  t.tlw = clamp_min(t.tlw, 30.0f);
  if (TS && t.dsigwdz == 0.0f) t.dsigwdz = F(1.0e-10);
  return t;
}

// Exact/linearized OU velocity update with the 0.5 switch
// (advance.f90:371-384).
__device__ __forceinline__ float ou_update(float vel, float rnd, float sig,
                                           float dt_over_tl) {
  if (dt_over_tl < 0.5f)
    return (1.0f - dt_over_tl) * vel
           + (rnd * sig) * sqrtf(2.0f * dt_over_tl);
  const float r = expf(-dt_over_tl);
  return r * vel + (rnd * sig) * sqrtf(clamp_min(1.0f - r * r, 0.0f));
}

// z < 0 -> min(hm, -z): the ground reflection of the position update.
__device__ __forceinline__ float reflect_ground(float z, float hm) {
  return z < 0.0f ? tmin(hm, -z) : z;
}

// Cyclic longitude + pole mirroring for global grids; exit detection
// (advance.f90:784-808).  Returns exited.
__device__ __forceinline__ bool apply_bcs(const AdvanceArgs& a, float& x_hi,
                                          float& x_lo, float& y_hi,
                                          float& y_lo) {
  const float x = x_hi + x_lo;
  const float y = y_hi + y_lo;
  if (!a.xglobal)
    return (x < 0.0f) || (x >= a.nxm) || (y < 0.0f) || (y > a.nym);
  float xw = x >= a.nxm ? x - a.nxm : x;
  xw = x < 0.0f ? x + a.nxm : xw;
  xw = xw <= a.eps_bc ? a.eps_bc : xw;
  xw = fabsf(xw - a.nxm) <= a.eps_bc ? a.nxm_eps : xw;
  const bool crossed_s = y < 0.0f;
  const bool crossed_n = y > a.nym;
  if (crossed_s || crossed_n) {
    // torch.remainder: fmod, then the divisor is added when the signs differ
    float m = fmodf(xw * a.dx + 180.0f, 360.0f);
    if (m != 0.0f && m < 0.0f) m += 360.0f;
    xw = m / a.dx;
  }
  float yw = crossed_s ? -y : y;
  yw = crossed_n ? a.two_nym - yw : yw;
  if (xw != x) { x_hi = xw; x_lo = 0.0f; }
  if (yw != y) { y_hi = yw; y_lo = 0.0f; }
  return (xw < 0.0f) || (xw >= a.nxm) || (yw < 0.0f) || (yw > a.nym);
}

// Polar-stereographic position update inside the caps (advance.f90:754-778;
// core/advance.py::_polar_update): a particle at (x, y) poleward of +-75
// degrees that moved (dxs, dys) metres east and north is moved on the
// tangent plane of its pole, and (x_hi, x_lo, y_hi, y_lo) become its new
// position with zero low parts.  Particles outside the caps are untouched.
__device__ __forceinline__ void polar_update(const AdvanceArgs& a, float x,
                                             float y, float dxs, float dys,
                                             float& x_hi, float& x_lo,
                                             float& y_hi, float& y_lo) {
  const float lat = (a.ylat0 + y * a.dy) * a.pi180;
  const bool north = lat > F(SWITCHNORTH * PI180);
  if (!north && !(lat < F(SWITCHSOUTH * PI180))) return;
  const float lon = (a.xlon0 + x * a.dx) * a.pi180;
  const float sinl = sinf(lon);
  const float cosl = cosf(lon);
  float lat_new, lon_new;
  if (north) {
    // X = rho sin(lon), Y = -rho cos(lon)
    const float half = F(PI / 4.0) - lat / 2.0f;
    const float rho = F(2.0 * R_EARTH) * tanf(half);
    const float ch = cosf(half);
    const float m = 1.0f / (ch * ch);
    const float dxp = ((dxs * cosl - dys * sinl) * m) * a.ldirf;
    const float dyp = ((dxs * sinl + dys * cosl) * m) * a.ldirf;
    const float xpl = rho * sinl + dxp;
    const float ypl = (-rho) * cosl + dyp;
    lat_new = F(PI / 2.0) - 2.0f * atanf(hypotf(xpl, ypl) / F(2.0 * R_EARTH));
    lon_new = atan2f(xpl, -ypl);
  } else {
    // X = rho sin(lon), Y = +rho cos(lon)
    const float half = F(PI / 4.0) + lat / 2.0f;
    const float rho = F(2.0 * R_EARTH) * tanf(half);
    const float ch = cosf(half);
    const float m = 1.0f / (ch * ch);
    const float dxp = ((dxs * cosl + dys * sinl) * m) * a.ldirf;
    const float dyp = (((-dxs) * sinl + dys * cosl) * m) * a.ldirf;
    const float xps = rho * sinl + dxp;
    const float yps = rho * cosl + dyp;
    lat_new = F(-(PI / 2.0)) + 2.0f * atanf(hypotf(xps, yps) / F(2.0 * R_EARTH));
    lon_new = atan2f(xps, yps);
  }
  lat_new = lat_new / a.pi180;
  lon_new = lon_new / a.pi180;
  // back to grid units, wrapped with the cyclic width nx - 1
  float xg = (lon_new - a.xlon0) / a.dx;
  xg = xg < 0.0f ? xg + a.nxm : xg;
  xg = xg >= a.nxm ? xg - a.nxm : xg;
  x_hi = xg;
  x_lo = 0.0f;
  y_hi = (lat_new - a.ylat0) / a.dy;
  y_lo = 0.0f;
}

// Draw `row` of particle i from an injected (rows, n) array.
__device__ __forceinline__ float injected_at(const float* d,
                                             const AdvanceArgs& a, long long i,
                                             int row) {
  return d[static_cast<size_t>(row) * a.n + i];
}

// The Philox words of rows 4 * block .. 4 * block + 3 of particle i at draw
// site `site` (0-4 for the tags 6, 1, 2, 3, 4), for fp::normal_pair.
__device__ __forceinline__ void site_words(uint32_t w[4], const AdvanceArgs& a,
                                           int site, long long i,
                                           uint32_t block) {
  fp::normal_words(w, a.key[2 * site], a.key[2 * site + 1], a.offset + i, block);
}

template <bool BF16, bool TS, bool POLAR>
__global__ void __launch_bounds__(256)
advance_kernel(const PIn in, const POut out, const Draws dr,
               const void* __restrict__ rows, const void* __restrict__ rowsE,
               const float* __restrict__ height, int* __restrict__ counts,
               const AdvanceArgs a) {
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
      const Horiz hw = horiz_weights(x, y, a.nx, a.ny);
      int indz;
      float dz1;
      vert_weights(sh_height, a.nz, z, indz, dz1);
      const size_t row = fp::cell_row(indz, hw.jy, hw.ix, a.ny, a.nx);
      float g[64];
#pragma unroll
      for (int k = 0; k < 8; ++k) load8<BF16, 64>(rows, row, k, &g[8 * k]);

      const float u = field2(g, 0, hw.p4, dz1);
      const float v = field2(g, 1, hw.p4, dz1);
      const float w = field2(g, 2, hw.p4, dz1);
      const float rho = field2(g, 3, hw.p4, dz1);
      const float drhodz = field2(g, 4, hw.p4, dz1);
      const float usig_m = g[60], vsig_m = g[61], wsig_m = g[62];
      const float h = clamp_min(
          tmax(tmax(tmax(g[40], g[41]), g[42]), g[43]), 1.0f);
      const bool ix_n = (x - static_cast<float>(hw.ix)) >= 0.5f;
      const bool iy_n = (y - static_cast<float>(hw.jy)) >= 0.5f;
      const float tropop = iy_n ? (ix_n ? g[47] : g[46]) : (ix_n ? g[45] : g[44]);
      const float ust = dot4(g, 48, hw.p4);
      const float wst = dot4(g, 52, hw.p4);
      const float oliaux = dot4(g, 56, hw.p4);
      const float ol = oliaux != 0.0f ? 1.0f / oliaux : 99999.0f;

      const float dt = a.dt;
      const bool pbl = (z / h) <= 1.0f;
      const float htop = sh_height[a.nz - 1] - a.htop_eps;
      const float hm = h - F(1e-9);

      Turb t0;
      if (pbl) t0 = hanna<TS>(z, h, ust, wst, ol);

      // newly released particles (initialize.f90:110-219)
      const bool fresh = (in.itramem[i] == a.itime) || (a.itime == 0);
      if (fresh) {
        // tag 6 rows 0-5: two Philox calls, three radii
        float r0, r1, r2, r3, r4, r5;
        if (injected) {
          r0 = injected_at(dr.d[0], a, i, 0);
          r1 = injected_at(dr.d[0], a, i, 1);
          r2 = injected_at(dr.d[0], a, i, 2);
          r3 = injected_at(dr.d[0], a, i, 3);
          r4 = injected_at(dr.d[0], a, i, 4);
          r5 = injected_at(dr.d[0], a, i, 5);
        } else {
          uint32_t w6[4];
          site_words(w6, a, 0, i, 0);
          fp::normal_pair(w6[0], w6[1], r0, r1);
          fp::normal_pair(w6[2], w6[3], r2, r3);
          site_words(w6, a, 0, i, 1);
          fp::normal_pair(w6[0], w6[1], r4, r5);
        }
        if (pbl) {
          up = r0 * t0.sigu;
          vp = r1 * t0.sigv;
          wp = TS ? r2 : r2 * t0.sigw;
        } else {
          up = r0 * F(0.3);
          vp = r1 * F(0.3);
          wp = 0.0f;
        }
        usig = (r3 * usig_m) * a.turbmeso;
        vsig = (r4 * vsig_m) * a.turbmeso;
        wsig = (r5 * wsig_m) * a.turbmeso;
        cbt = 1;
      }

      // Every particle takes up to three draws here: in the PBL tag 1 rows
      // 0, 1 and tag 2 row 0; above it tag 3 rows 0, 1 (below the
      // stratosphere) and row 2 (above the troposphere).  They are made at
      // one place with the site chosen per thread, so that a warp holding
      // both kinds of particle runs the generator once, not once per branch.
      // Above the boundary layer all three rows come from one Philox call
      // (tag 3, block 0); in it d0, d1 from tag 1's block 0 and d2 from tag
      // 2's, whose words `pw` the substep loop goes on reading.
      const bool in_trop = z < tropop;
      const bool in_trans = !in_trop && (z < tropop + 1000.0f);
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

        // the ifine vertical Langevin substeps (advance.f90:396-498);
        // dtftlw and what derives from it come from the interval start
        const float rhoaux = drhodz / rho;
        const float dtf = a.dtf;
        const float dtftlw = dtf / t0.tlw;
        const float rw = expf(-dtftlw);
        const float rnd_exact = sqrtf(clamp_min(1.0f - rw * rw, 0.0f));
        const float rnd_lin = sqrtf(2.0f * dtftlw);
        const bool use_lin = dtftlw < 0.5f;
        Turb t = t0;
        float zz = z;
        for (int s = 0; s < a.ifine; ++s) {
          // tag 2 row s: row 0 is d2; an odd row was made with the even
          // row before it; every fourth row starts a new Philox call
          float rnd = d2;
          if (s > 0) {
            if (injected) {
              rnd = injected_at(dr.d[2], a, i, s);
            } else if (s % fp::ROWS_PER_PAIR) {
              rnd = d2_odd;
            } else {
              if (s % fp::ROWS_PER_BLOCK == 0)
                site_words(pw, a, 2, i,
                           static_cast<uint32_t>(s / fp::ROWS_PER_BLOCK));
              const bool hi = (s % fp::ROWS_PER_BLOCK) != 0;
              fp::normal_pair(hi ? pw[2] : pw[0], hi ? pw[3] : pw[1], rnd, d2_odd);
            }
          }
          const float icbtf = static_cast<float>(cbt);
          float wp_new, delz;
          if (TS) {
            const float drift = t.dsigwdz + rhoaux * t.sigw;
            const float sel = use_lin
                ? ((1.0f - dtftlw) * wp + rnd * rnd_lin) + dtf * drift
                : (rw * wp + rnd * rnd_exact) + (t.tlw * (1.0f - rw)) * drift;
            wp_new = sel * icbtf;
            delz = (wp_new * t.sigw) * dtf;
          } else {
            wp_new = ((rw * wp + (rnd * rnd_exact) * t.sigw)
                      + (t.tlw * (1.0f - rw))
                            * (t.dsigw2dz + rhoaux * (t.sigw * t.sigw)))
                     * icbtf;
            delz = wp_new * dtf;
          }
          // ground/hmix reflection and forbidden-state flag
          // (advance.f90:476-491)
          if (fabsf(delz) > h) delz = fmodf(delz, h);
          const bool below = delz < -zz;
          const bool above = delz > (h - zz);
          zz = below ? (-zz - delz)
                     : (above ? ((-zz - delz) + 2.0f * h) : (zz + delz));
          cbt = (below || above) ? -1 : 1;
          wp = wp_new;
          if (s != a.ifine - 1) t = hanna<TS>(zz, h, ust, wst, ol);
        }
        dawsave = up * dt;
        dcwsave = vp * dt;
        dxsave = u * dt;
        dysave = v * dt;
        zz = zz + (w * dt) * a.ldirf;
        zz = tmin(zz, htop);
        z_new = reflect_ground(zz, hm);
      } else {
        // free troposphere / stratosphere (advance.f90:629-708)
        float ux = 0.0f, vy = 0.0f, wp_ft = 0.0f;
        if (in_trop) {
          ux = d0 * a.uxscale_t;
          vy = d1 * a.uxscale_t;
        } else if (in_trans) {
          const float weight = clamp((z - tropop) / 1000.0f, 0.0f, 1.0f);
          const float uxscale_tr = sqrtf(a.c_trop * (1.0f - weight));
          const float wpscale_tr = sqrtf(a.c_strat * weight);
          ux = d0 * uxscale_tr;
          vy = d1 * uxscale_tr;
          wp_ft = d2 * wpscale_tr + a.d_strat_1000;
        } else {
          wp_ft = d2 * a.wpscale_s;
        }
        dxsave = (u + ux) * dt;
        dysave = (v + vy) * dt;
        dawsave = 0.0f;
        dcwsave = 0.0f;
        wp = wp_ft;
        z_new = reflect_ground(z + ((w + wp_ft) * dt) * a.ldirf, hm);
      }

      // mesoscale fluctuations (advance.f90:720-738)
      // tag 4 rows 0-2: one Philox call, two radii
      float m0, m1, m2;
      if (injected) {
        m0 = injected_at(dr.d[4], a, i, 0);
        m1 = injected_at(dr.d[4], a, i, 1);
        m2 = injected_at(dr.d[4], a, i, 2);
      } else {
        uint32_t w4[4];
        float unused;
        site_words(w4, a, 4, i, 0u);
        fp::normal_pair(w4[0], w4[1], m0, m1);
        fp::normal_pair(w4[2], w4[3], m2, unused);
      }
      usig = a.r_meso * usig + ((a.rs_meso * m0) * usig_m) * a.turbmeso;
      vsig = a.r_meso * vsig + ((a.rs_meso * m1) * vsig_m) * a.turbmeso;
      wsig = a.r_meso * wsig + ((a.rs_meso * m2) * wsig_m) * a.turbmeso;
      dxsave = dxsave + usig * dt;
      dysave = dysave + vsig * dt;
      z_new = fabsf(z_new + wsig * dt);

      // windalign + metric position update (advance.f90:747-799)
      const float ffinv = 1.0f / clamp_min(sqrtf(u * u + v * v), F(1e-30));
      const float sinphi = v * ffinv;
      const float cosphi = u * ffinv;
      dxsave = dxsave + (cosphi * dawsave - sinphi * dcwsave);
      dysave = dysave + (sinphi * dawsave + cosphi * dcwsave);

      const float cosfact = a.dxconst / cosf((y * a.dy + a.ylat0) * a.pi180);
      ds_add(x_hi, x_lo, (dxsave * cosfact) * a.ldirf);
      ds_add(y_hi, y_lo, (dysave * a.dyconst) * a.ldirf);
      if (POLAR) polar_update(a, x, y, dxsave, dysave, x_hi, x_lo, y_hi, y_lo);
      exited = apply_bcs(a, x_hi, x_lo, y_hi, y_lo);
      z_new = tmin(z_new, htop);

      // Petterssen corrector (advance.f90:816-986)
      if (a.can_pett && !exited) {
        const float xn = x_hi + x_lo;
        const float yn = y_hi + y_lo;
        const Horiz hw2 = horiz_weights(xn, yn, a.nx, a.ny);
        int indz2;
        float dz2;
        vert_weights(sh_height, a.nz, z_new, indz2, dz2);
        const size_t row2 = fp::cell_row(indz2, hw2.jy, hw2.ix, a.ny, a.nx);
        float e[24];
#pragma unroll
        for (int k = 0; k < 3; ++k) load8<BF16, 32>(rowsE, row2, k, &e[8 * k]);
        const float du = (field2(e, 0, hw2.p4, dz2) - u) / 2.0f;
        const float dv = (field2(e, 1, hw2.p4, dz2) - v) / 2.0f;
        const float dw = (field2(e, 2, hw2.p4, dz2) - w) / 2.0f;
        const float z_corr = reflect_ground(z_new + (dw * dt) * a.ldirf, hm);
        const float cosfact2 = a.dxconst / cosf((yn * a.dy + a.ylat0) * a.pi180);
        ds_add(x_hi, x_lo, ((du * cosfact2) * dt) * a.ldirf);
        ds_add(y_hi, y_lo, ((dv * a.dyconst) * dt) * a.ldirf);
        if (POLAR) polar_update(a, xn, yn, du * dt, dv * dt, x_hi, x_lo, y_hi, y_lo);
        exited = apply_bcs(a, x_hi, x_lo, y_hi, y_lo);
        z_new = tmin(z_corr, htop);
      }
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
  // counts[0] += particles still active, counts[1] += particles that exited
  const unsigned kept = __ballot_sync(0xFFFFFFFFu, keep);
  const unsigned gone = __ballot_sync(0xFFFFFFFFu, exited);
  if ((threadIdx.x & 31) == 0) {
    if (kept) atomicAdd(&counts[0], __popc(kept));
    if (gone) atomicAdd(&counts[1], __popc(gone));
  }
}

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
    int* counts, const AdvanceArgs* args, void* stream) {
  const AdvanceArgs a = *args;
  if (a.n <= 0) return 0;
  const size_t shmem = static_cast<size_t>(a.nz) * sizeof(float);
  if (a.nz < 2 || shmem > 48 * 1024 || a.ifine < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const PIn in = {x_hi, x_lo, y_hi, y_lo, z, itra, itramem, up, vp, wp,
                  usig, vsig, wsig, cbt, active};
  const POut out = {o_x_hi, o_x_lo, o_y_hi, o_y_lo, o_z, o_itra, o_up, o_vp,
                    o_wp, o_usig, o_vsig, o_wsig, o_cbt, o_active};
  const Draws dr = {{d6, d1, d2, d3, d4}};
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((a.n + threads - 1) / threads);
  auto kern = a.polar
      ? (a.table_bf16
             ? (a.turbswitch ? advance_kernel<true, true, true>
                             : advance_kernel<true, false, true>)
             : (a.turbswitch ? advance_kernel<false, true, true>
                             : advance_kernel<false, false, true>))
      : (a.table_bf16
             ? (a.turbswitch ? advance_kernel<true, true, false>
                             : advance_kernel<true, false, false>)
             : (a.turbswitch ? advance_kernel<false, true, false>
                             : advance_kernel<false, false, false>));
  kern<<<blocks, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      in, out, dr, rows, rowsE, height, counts, a);
  return static_cast<int>(cudaGetLastError());
}

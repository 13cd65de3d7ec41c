// The device functions of the particle advance, shared by the fixed step
// (K4, advance.cu) and the adaptive step (K11, advance_adaptive.cu): the run
// scalars, the table loads and the stencil sums, Hanna turbulence, the OU
// update, the ground reflection, the polar-stereographic update, the cyclic
// and pole boundary conditions, gravitational settling, and the parts of a
// step that both advances share: its start (the row gather and the
// stencil), a fresh particle's velocities, the ifine vertical substeps of
// the boundary layer, the free troposphere's turbulent terms, the
// mesoscale draws and the end of the step (mesoscale memory, windalign,
// the double-single position update, the polar caps, the boundary
// conditions and the Petterssen corrector), the nests' sampling (K4's
// NESTS instantiation) and the skewed convective boundary layer (K11's
// CBL instantiation, core/cbl.py).  Each is the plain version's arithmetic
// in its order (core/advance.py, core/cbl.py, core/hanna.py,
// core/interp.py); the kernels build with -fmad=false.
#pragma once
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
  int method;          // 0: the fixed step (K4), 1: the adaptive step (K11)
  int turboff;         // every turbulent term zeroed
  int settling;        // gravitational settling (the SETTLING instantiations)
  int nspec;           // species of mass0 and of the settling parameters
  float fine;          // 1 / ifine
  float ctl;           // TL / dt of the adaptive step
  float mintime;       // shortest adaptive step [s]
  float two_d_trop;    // f32(2 D_TROP)
  float two_d_strat;   // f32(2 D_STRAT)
  float sp_density[32];     // per species (MAX_SPECIES) settling parameters
  float sp_dquer[32];
  float sp_cunningham[32];
  float sp_vsetaver[32];
  int cblflag;              // the skewed CBL (K11's CBL instantiations)
  uint32_t key_cbl[64];     // (k0, k1) of tags 40 + i, i < MAX_CBL_SUBSTEPS
  uint32_t key_fresh[4];    // (k0, k1) of tags 7 and 8
  int nnest;                // nested met grids, outermost first (NESTS)
  float eps_nest;           // f32(nx / 3e5): the nest windows' margin
  int nest_nx[4];           // per nest (MAX_NESTS) its shape,
  int nest_ny[4];
  float xln[4];             // its window in mother-grid units,
  float yln[4];
  float xrn[4];
  float yrn[4];
  float xresoln[4];         // the mother's dx, dy over its own,
  float yresoln[4];
  float nest_xmax[4];       // f32(nx - 1.001), f32(ny - 1.001)
  float nest_ymax[4];
  const void* nest_rows[4];     // and its quad tables
  const void* nest_rows_e[4];
};

constexpr int MAX_SPECIES = 32;       // the arrays of AdvanceArgs
constexpr int MAX_NESTS = 4;
constexpr int MAX_CBL_SUBSTEPS = 32;

// The three forms of the boundary layer's turbulence: Hanna without
// turbswitch, Hanna with it, and the skewed CBL (which Hanna's turbswitch
// form feeds; cblflag forces turbswitch).
enum Turbulence : int { HANNA1 = 0, TS = 1, CBL = 2 };

namespace {

constexpr double PI = 3.14159265358979323846;
constexpr double PI180 = PI / 180.0;
constexpr double R_EARTH = 6.371e6;
constexpr double SWITCHNORTH = 75.0;    // polar-cap thresholds (par_mod.f90:123)
constexpr double SWITCHSOUTH = -75.0;
constexpr double GA = 9.81;             // constants.py
constexpr float TWO_HREF = 30.0f;       // the deposition layer, 2 * 15 m
constexpr double USURAD2 = 0.7071067812;    // core/cbl.py
constexpr double USURAD2P = 0.3989422804;
constexpr double COSTLUAR4 = 0.66667;
constexpr float CBL_ZONE = 5.0f;            // -h/L of the skewed scheme

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

// Sutherland's law (dynamic_viscosity.f90), core/advance.py::_viscosity.
__device__ __forceinline__ float viscosity(float t) {
  return (F(1.827e-5 * (291.15 + 120.0)) / (t + 120.0f))
         * powf(t / F(291.15), 1.5f);
}

// The iterative Reynolds/Cd settling velocity of get_settling.f90:100-127,
// five fixed iterations (core/advance.py::_settling_velocity); negative, 0
// for a gas (density <= 0).
__device__ float settling_velocity(float dquer, float density, float cunningham,
                                   float vsetaver, float temp, float rhoa) {
  if (!(density > 0.0f)) return 0.0f;
  const float vis_kin = viscosity(temp) / rhoa;
  const float d_m = dquer / F(1.0e6);
  float settl = vsetaver;
  float reynolds = (d_m * fabsf(settl)) / vis_kin;
  const float dens_pos = density < 0.0f ? 0.0f : density;
  for (int it = 0; it < 5; ++it) {
    const float re = clamp_min(reynolds, F(1e-12));
    const float c_d = re < F(1.917) ? 24.0f / re
                      : (re < 500.0f ? F(18.5) / powf(re, F(0.6)) : F(0.44));
    settl = -sqrtf((((F(4.0 * GA) * d_m) * dens_pos) * cunningham)
                   / ((3.0f * c_d) * rhoa));
    reynolds = (d_m * fabsf(settl)) / vis_kin;
  }
  return settl;
}

// What settling needs of a particle for its whole step: its nearest grid
// column (round half to even, clipped) and its settling species, the
// first one it carries release mass of (core/advance.py::_settle_fn and
// settling_species).
struct Settle {
  int col;
  int sp;
};

__device__ __forceinline__ Settle settle_setup(const AdvanceArgs& a,
                                               const float* mass0, long long i,
                                               float x, float y) {
  Settle s;
  const int nix = min(max(__float2int_rn(x), 0), a.nx - 1);
  const int njy = min(max(__float2int_rn(y), 0), a.ny - 1);
  s.col = njy * a.nx + nix;
  s.sp = 0;
  for (int k = 0; k < a.nspec; ++k) {
    if (mass0[i * a.nspec + k] > F(1e-30)) { s.sp = k; break; }
  }
  return s;
}

// The settling velocity at height zc in the particle's column: temperature
// and density of the interval's first met time, linear in z.
__device__ __forceinline__ float settle_at(const AdvanceArgs& a, const Settle& s,
                                           const float* __restrict__ tt,
                                           const float* __restrict__ rho,
                                           const float* sh_height, float zc) {
  int indz;
  float dz1;
  vert_weights(sh_height, a.nz, zc, indz, dz1);
  const size_t plane = static_cast<size_t>(a.ny) * a.nx;
  const size_t lin = static_cast<size_t>(indz) * plane + s.col;
  const float temp = __ldg(tt + lin) * (1.0f - dz1) + __ldg(tt + lin + plane) * dz1;
  const float rhoa = __ldg(rho + lin) * (1.0f - dz1) + __ldg(rho + lin + plane) * dz1;
  return settling_velocity(a.sp_dquer[s.sp], a.sp_density[s.sp],
                           a.sp_cunningham[s.sp], a.sp_vsetaver[s.sp], temp,
                           rhoa);
}

// Draw `row` of particle i from an injected (rows, n) array (K4's parity
// mode).
__device__ __forceinline__ float injected_at(const float* d,
                                             const AdvanceArgs& a, long long i,
                                             int row) {
  return d[static_cast<size_t>(row) * a.n + i];
}

// The Philox words of rows 4 * block .. 4 * block + 3 of particle i at draw
// site `site` (0-4 for the tags 6, 1, 2, 3, 4) in pass `pass` (0 but in the
// adaptive step's loop), for fp::normal_pair.
__device__ __forceinline__ void site_words(uint32_t w[4], const AdvanceArgs& a,
                                           int site, long long i,
                                           uint32_t block, uint32_t pass = 0u) {
  fp::normal_words(w, a.key[2 * site], a.key[2 * site + 1], a.offset + i, block,
                   pass);
}

// What the start of a step reads of the particle's cell: ONE row gather of
// the (R, 64) quad table at (x, y, z) and the stencil sums.
struct Start {
  Horiz hw;
  float u, v, w, rho, drhodz;      // at z
  float usig_m, vsig_m, wsig_m;    // mesoscale sigmas of the cell
  float h, tropop, ust, wst, ol;
};

template <bool BF16>
__device__ __forceinline__ Start sample_start(const void* __restrict__ rows,
                                              const float* sh_height, int nz,
                                              int nx, int ny, float x, float y,
                                              float z) {
  Start s;
  s.hw = horiz_weights(x, y, nx, ny);
  int indz;
  float dz1;
  vert_weights(sh_height, nz, z, indz, dz1);
  const size_t row = fp::cell_row(indz, s.hw.jy, s.hw.ix, ny, nx);
  float g[64];
#pragma unroll
  for (int k = 0; k < 8; ++k) load8<BF16, 64>(rows, row, k, &g[8 * k]);

  s.u = field2(g, 0, s.hw.p4, dz1);
  s.v = field2(g, 1, s.hw.p4, dz1);
  s.w = field2(g, 2, s.hw.p4, dz1);
  s.rho = field2(g, 3, s.hw.p4, dz1);
  s.drhodz = field2(g, 4, s.hw.p4, dz1);
  s.usig_m = g[60];
  s.vsig_m = g[61];
  s.wsig_m = g[62];
  s.h = clamp_min(tmax(tmax(tmax(g[40], g[41]), g[42]), g[43]), 1.0f);
  const bool ix_n = (x - static_cast<float>(s.hw.ix)) >= 0.5f;
  const bool iy_n = (y - static_cast<float>(s.hw.jy)) >= 0.5f;
  s.tropop = iy_n ? (ix_n ? g[47] : g[46]) : (ix_n ? g[45] : g[44]);
  s.ust = dot4(g, 48, s.hw.p4);
  s.wst = dot4(g, 52, s.hw.p4);
  const float oliaux = dot4(g, 56, s.hw.p4);
  s.ol = oliaux != 0.0f ? 1.0f / oliaux : 99999.0f;
  return s;
}

template <bool BF16>
__device__ __forceinline__ Start step_start(const AdvanceArgs& a,
                                            const void* __restrict__ rows,
                                            const float* sh_height, float x,
                                            float y, float z) {
  return sample_start<BF16>(rows, sh_height, a.nz, a.nx, a.ny, x, y, z);
}

// Inside nest k's window shrunk by eps_nest, and the nest's coordinates of
// (x, y) clamped to [0, n - 1.001] (core/advance.py::_in_nest and
// _nest_coords).  k is a constant of an unrolled loop.
__device__ __forceinline__ bool in_nest(const AdvanceArgs& a, int k, float x,
                                        float y) {
  return (x > a.xln[k] + a.eps_nest) && (x < a.xrn[k] - a.eps_nest) &&
         (y > a.yln[k] + a.eps_nest) && (y < a.yrn[k] - a.eps_nest);
}

__device__ __forceinline__ void nest_coords(const AdvanceArgs& a, int k,
                                            float x, float y, float& xt,
                                            float& yt) {
  xt = clamp((x - a.xln[k]) * a.xresoln[k], 0.0f, a.nest_xmax[k]);
  yt = clamp((y - a.yln[k]) * a.yresoln[k], 0.0f, a.nest_ymax[k]);
}

// The nests' met at the particle (core/advance.py::_sample_nests): for
// each nest, outermost first, that holds (x, y), a second row gather from
// its (R_n, 64) table replaces everything the start read but the mother's
// stencil, so that the innermost nest that holds the particle wins.
template <bool BF16>
__device__ __forceinline__ void sample_nests(const AdvanceArgs& a,
                                             const float* sh_height, float x,
                                             float y, float z, Start& s) {
#pragma unroll
  for (int k = 0; k < MAX_NESTS; ++k) {
    if (k < a.nnest && in_nest(a, k, x, y)) {
      float xt, yt;
      nest_coords(a, k, x, y, xt, yt);
      const Start n = sample_start<BF16>(a.nest_rows[k], sh_height, a.nz,
                                         a.nest_nx[k], a.nest_ny[k], xt, yt,
                                         z);
      const Horiz hw = s.hw;
      s = n;
      s.hw = hw;
    }
  }
}

// ---- The skewed convective boundary layer (core/cbl.py; cbl.f90,
// re_initialize_particle.f90, initialize_cbl_vel.f90), K11's CBL
// instantiations.  Each line is core/cbl.py's expression with its
// left-to-right order made explicit; an integer power is products, the
// others powf with the float exponent, a division a true division.
//
// The bi-Gaussian parameters are split as core/cbl.py splits them: the
// column's part (skew_column: -h/L, the taper of the skewness and wst^3,
// and the zone test), which depends only on the particle's h, wst and L and
// is computed once a pass, and the part at the substep's height
// (cbl_skew).  The skewed substep (cbl_skewed_wp) is inlined into the
// substep loop (cbl_substeps): the parameters hold some sixty values at
// once, and as a call across which the pass kept its state they went
// through the stack in local memory.  Built with FP_CBL_CALLS=1 it is a
// __noinline__ call again, which the bound reads its instructions from
// (chip_smoke.py's cbl_skewed_calls and function_paths).  A fresh
// particle's draw (cbl_fresh_wp) is a call in every build: it runs once
// per particle, at its start, outside the loop of passes.

#if defined(FP_CBL_CALLS) && FP_CBL_CALLS
#define FP_CBL_SUBSTEP __noinline__
#else
#define FP_CBL_SUBSTEP __forceinline__
#endif

struct Skew {
  float alu, blu, dalu, dblu, sa, sb, dsa, dsb, wa, wb, dwa, dwb;
};

// The column's part of the parameters (core/cbl.py::skew_column).
struct SkewColumn {
  float transition;   // the skewness's taper below -h/L = 15
  float wst3;         // wst^3
  bool zone;          // -h/L > CBL_ZONE: the skewed scheme applies
};

__device__ __forceinline__ SkewColumn skew_column(float h, float wst,
                                                  float ol) {
  const float mhol = (-h) / ol;
  const float taper = sinf(((mhol + 10.0f) / 10.0f) * F(PI)) / 2.0f + 0.5f;
  SkewColumn c;
  c.transition = mhol < 15.0f ? taper : 1.0f;
  c.wst3 = (wst * wst) * wst;
  c.zone = mhol > CBL_ZONE;
  return c;
}

// torch.sign(x) * |x| ** (1/3)
__device__ __forceinline__ float cuberoot(float x) {
  const float sg = static_cast<float>((0.0f < x) - (x < 0.0f));
  return sg * powf(fabsf(x), F(1.0 / 3.0));
}

// The parameters at height z (core/cbl.py::skew_at) in a column whose
// skew_column gave transition and wst3.
__device__ __forceinline__ Skew cbl_skew(float z, float h, float sigw,
                                         float dsigwdz, float transition,
                                         float wst3) {
  const float zeta = z / h;
  const float w2 = sigw * sigw;
  const float dw2 = (2.0f * sigw) * dsigwdz;
  const float omz = clamp_min(1.0f - zeta, 0.0f);
  const float omz15 = powf(omz, 1.5f);
  const float w3 = ((((F(1.2) * zeta) * omz15) + F(1e-6)) * wst3) * transition;
  const float dw3 =
      (((F(1.2) * (omz15 - (zeta * 1.5f) * sqrtf(omz))) * wst3) / h) * transition;
  const float w2_15 = powf(w2, 1.5f);
  const float skew = w3 / w2_15;
  const float skew2 = skew * skew;
  const float dskew = ((dw3 * w2_15) - ((w3 * 1.5f) * sqrtf(w2)) * dw2)
                      / ((w2 * w2) * w2);
  const float radw2 = sqrtf(w2);
  const float dradw2 = (0.5f * dw2) / sqrtf(w2);
  const float fluarw = F(COSTLUAR4) * cuberoot(skew);
  const float fluarw2 = fluarw * fluarw;
  const bool nz = skew != 0.0f;
  const float safe = nz ? skew : 1.0f;
  const float dfluarw =
      nz ? (F(COSTLUAR4 / 3.0) * cuberoot(1.0f / (safe * safe))) * dskew : 0.0f;
  const float f2p1 = 1.0f + fluarw2;
  const float f2p3 = 3.0f + fluarw2;
  const float fl_s = nz ? fluarw : 1.0f;
  const float f2p1_3 = (f2p1 * f2p1) * f2p1;
  const float f2p3_2 = f2p3 * f2p3;
  const float f2p1_15 = powf(f2p1, 1.5f);
  const float tf = (2.0f * fluarw) * dfluarw;
  const float rluarw = nz ? (f2p1_3 * skew2) / (f2p3_2 * fluarw2) : 0.0f;
  const float xluarw = nz ? (f2p1_15 * skew) / (f2p3 * fl_s) : 0.0f;
  const float den_r = f2p3_2 * fluarw2;
  const float drluarw =
      nz ? ((((((3.0f * (f2p1 * f2p1)) * tf) * skew2
                + ((f2p1_3 * 2.0f) * skew) * dskew) * f2p3_2) * fluarw2
             - (f2p1_3 * skew2)
                   * ((((2.0f * f2p3) * tf) * fluarw2)
                      + (((f2p3_2 * 2.0f) * fluarw) * dfluarw)))
            / clamp_min(den_r * den_r, F(1e-30)))
         : 0.0f;
  const float den_x = f2p3 * fl_s;
  const float dxluarw =
      nz ? (((((1.5f * sqrtf(f2p1)) * tf) * skew + f2p1_15 * dskew) * f2p3) * fl_s
            - (f2p1_15 * skew) * ((3.0f * dfluarw) + (3.0f * fluarw2) * dfluarw))
               / clamp_min(den_x * den_x, F(1e-30))
         : 0.0f;
  const float s4r = sqrtf(4.0f + rluarw);
  Skew k;
  k.alu = 0.5f * (1.0f - xluarw / s4r);
  k.blu = 1.0f - k.alu;
  k.dalu = ((-0.5f) * ((dxluarw * s4r) - ((0.5f * xluarw) * drluarw) / s4r))
           / (4.0f + rluarw);
  k.dblu = -k.dalu;
  const float al_s = clamp_min(k.alu, F(1e-6));
  const float bl_s = clamp_min(k.blu, F(1e-6));
  const float af = al_s * f2p1;
  const float bf = bl_s * f2p1;
  const float qa = sqrtf(bl_s / af);
  const float qb = sqrtf(al_s / bf);
  k.sa = radw2 * qa;
  k.sb = radw2 * qb;
  k.dsa = dradw2 * qa
          + radw2 * ((0.5f / qa)
                     * ((k.dblu * af
                         - bl_s * (k.dalu * f2p1 + ((al_s * 2.0f) * fluarw) * dfluarw))
                        / (af * af)));
  k.dsb = dradw2 * qb
          + radw2 * ((0.5f / qb)
                     * ((k.dalu * bf
                         - al_s * (k.dblu * f2p1 + ((bl_s * 2.0f) * fluarw) * dfluarw))
                        / (bf * bf)));
  k.wa = fluarw * k.sa;
  k.wb = fluarw * k.sb;
  k.dwa = dfluarw * k.sa + fluarw * k.dsa;
  k.dwb = dfluarw * k.sb + fluarw * k.dsb;
  return k;
}

// One substep's velocity in the skewed zone, dtftlw < 0.5
// (core/advance.py::_pbl_vertical's CBL branch with core/cbl.py::cbl_terms):
// the drift and diffusion from the raw wp; a particle more than six sigma
// from both Gaussians is redrawn with its sign kept
// (core/cbl.py::reinit_wp), from the two normals of tag 40 + s, words
// (k0, k1), at `pass`.  transition and wst3: the column's skew_column.
__device__ FP_CBL_SUBSTEP float cbl_skewed_wp(
    float wp, float z, float h, float rho, float drhodz, float sigw,
    float dsigwdz, float tlw, float transition, float wst3, float timedir,
    float dtf, float rnd, float icbtf, uint32_t k0, uint32_t k1,
    long long global_index, uint32_t pass) {
  const Skew k = cbl_skew(z, h, sigw, dsigwdz, transition, wst3);
  const float dens = rho, ddens = drhodz;
  const float alfa = ((2.0f * sigw) * sigw) / (3.0f * tlw);
  const float wold = timedir * wp;
  const float deltawa = wold - k.wa;
  const float deltawb = wold + k.wb;
  const float wold2 = wold * wold;
  const float sa2 = k.sa * k.sa;
  const float sb2 = k.sb * k.sb;
  const bool rein = (fabsf(deltawa) > 6.0f * k.sa) && (fabsf(deltawb) > 6.0f * k.sb);
  if (rein) {
    float r0, r1;
    uint32_t w[4];
    fp::normal_words(w, k0, k1, global_index, 0u, pass);
    fp::normal_pair(w[0], w[1], r0, r1);
    const float sg = static_cast<float>((0.0f < wp) - (wp < 0.0f));
    const bool updraft = sg * timedir > 0.0f;
    const float u1 = r0 * k.sa + k.wa, d1 = r0 * k.sb - k.wb;
    const float u2 = r1 * k.sa + k.wa, d2 = r1 * k.sb - k.wb;
    const float w_up = u1 >= 0.0f ? u1 : (u2 >= 0.0f ? u2 : fabsf(u1));
    const float w_dn = d1 <= 0.0f ? d1 : (d2 <= 0.0f ? d2 : -fabsf(d1));
    return (updraft ? w_up : w_dn) * timedir;
  }
  const float ra = deltawa / k.sa;
  const float rb = deltawb / k.sb;
  const float pa = (F(USURAD2P) / k.sa) * expf(-0.5f * (ra * ra));
  const float pb = (F(USURAD2P) / k.sb) * expf(-0.5f * (rb * rb));
  const float ptot = clamp_min((dens * k.alu) * pa + (dens * k.blu) * pb, F(1e-30));
  const float aperfa = (deltawa * F(USURAD2)) / k.sa;
  const float aperfb = (deltawb * F(USURAD2)) / k.sb;
  const float p1 = ((-0.5f) * ((((k.alu * dens) * k.dwa) + ((dens * k.wa) * k.dalu))
                               + ((k.alu * k.wa) * ddens)))
                   * erff(aperfa);
  const float p2 =
      (k.sa * (((((k.alu * dens) * k.dsa) * ((wold2 / sa2) + 1.0f)
                 + (k.sa * dens) * k.dalu)
                + (k.sa * ddens) * k.alu)
               + (((k.alu * wold) * dens) / sa2) * ((k.sa * k.dwa) - (k.wa * k.dsa))))
      * pa;
  const float p3 = (0.5f * ((((k.blu * dens) * k.dwb) + ((k.wb * dens) * k.dblu))
                            + ((k.wb * k.blu) * ddens)))
                   * erff(aperfb);
  const float p4 =
      (k.sb * (((((k.blu * dens) * k.dsb) * ((wold2 / sb2) + 1.0f)
                 + (k.sb * dens) * k.dblu)
                + (k.sb * ddens) * k.blu)
               + (((k.blu * wold) * dens) / sb2) * (((-k.sb) * k.dwb) + (k.wb * k.dsb))))
      * pb;
  const float phi = ((p1 + p2) + p3) + p4;
  const float q = timedir * (((((k.alu * dens) * deltawa) / sa2) * pa)
                             + ((((k.blu * dens) * deltawb) / sb2) * pb));
  const float ath = (1.0f / ptot) * ((((-1.5f) * alfa) * q) + phi);
  const float bth = sqrtf(3.0f * alfa);
  return ((wp + ath * dtf) + (bth * rnd) * sqrtf(dtf)) * icbtf;
}

// A fresh particle's raw wp in the skewed zone (core/cbl.py::init_cbl_wp):
// the uniform of tag 7 picks the updraft or the downdraft, the normal of
// tag 8 draws in it.
__device__ __noinline__ float cbl_fresh_wp(const AdvanceArgs& a, long long i,
                                           float z, float h, float wst,
                                           float sigw, float dsigwdz, float ol) {
  const SkewColumn c = skew_column(h, wst, ol);
  const Skew k = cbl_skew(z, h, sigw, dsigwdz, c.transition, c.wst3);
  uint32_t w[4];
  fp::normal_words(w, a.key_fresh[0], a.key_fresh[1], a.offset + i, 0u);
  const float dcas = fp::uniform24(w[0]);
  fp::normal_words(w, a.key_fresh[2], a.key_fresh[3], a.offset + i, 0u);
  float dcas1, unused;
  fp::normal_pair(w[0], w[1], dcas1, unused);
  return (dcas <= k.alu ? dcas1 * k.sa + k.wa : dcas1 * k.sb - k.wb) * a.ldirf;
}

// A newly released particle (initialize.f90:110-219): its turbulent
// velocities from tag 6 rows 0-2 (in the boundary layer from the
// turbulence t0 at its height), its mesoscale memory from rows 3-5 and
// cbt = 1.  Tag 6 rows 0-5 are two Philox calls and three radii.  With the
// CBL wp is raw: in the skewed zone from tags 7 and 8 (cbl_fresh_wp), else
// row 2 times sigw.
template <int TURB>
__device__ __forceinline__ void fresh_state(const AdvanceArgs& a,
                                            const Draws& dr, bool injected,
                                            long long i, bool pbl,
                                            const Turb& t0, const Start& s,
                                            float z,
                                            float& up, float& vp, float& wp,
                                            float& usig, float& vsig,
                                            float& wsig, int& cbt) {
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
    if constexpr (TURB == CBL) {
      wp = ((-s.h) / s.ol) > CBL_ZONE
               ? cbl_fresh_wp(a, i, z, s.h, s.wst, t0.sigw, t0.dsigwdz, s.ol)
               : r2 * t0.sigw;
    } else {
      wp = TURB == TS ? r2 : r2 * t0.sigw;
    }
  } else {
    up = r0 * F(0.3);
    vp = r1 * F(0.3);
    wp = 0.0f;
  }
  if (a.turboff) {
    up = 0.0f;
    vp = 0.0f;
    wp = 0.0f;
  }
  usig = (r3 * s.usig_m) * a.turbmeso;
  vsig = (r4 * s.vsig_m) * a.turbmeso;
  wsig = (r5 * s.wsig_m) * a.turbmeso;
  cbt = 1;
}

// The draw of substep s > 0 of a pass (tag 2 row s at `pass`): an odd row
// was made with the even row before it (d2_odd); every fourth row starts a
// new Philox call into pw, which holds the words of row 0's call.
// `injected` reads row s from d2in instead (K4's parity mode).
__device__ __forceinline__ float substep_draw(const AdvanceArgs& a,
                                              const float* d2in,
                                              bool injected, long long i,
                                              uint32_t pass, int s,
                                              float& d2_odd, uint32_t pw[4]) {
  if (injected) return injected_at(d2in, a, i, s);
  if (s % fp::ROWS_PER_PAIR) return d2_odd;
  if (s % fp::ROWS_PER_BLOCK == 0)
    site_words(pw, a, 2, i, static_cast<uint32_t>(s / fp::ROWS_PER_BLOCK),
               pass);
  const bool hi = (s % fp::ROWS_PER_BLOCK) != 0;
  float rnd;
  fp::normal_pair(hi ? pw[2] : pw[0], hi ? pw[3] : pw[1], rnd, d2_odd);
  return rnd;
}

// A substep's move of zz by delz with the ground/hmix reflection and the
// forbidden-state flag (advance.f90:476-491).
__device__ __forceinline__ void reflect_substep(float delz, float h,
                                                float& zz, int& cbt) {
  if (fabsf(delz) > h) delz = fmodf(delz, h);
  const bool below = delz < -zz;
  const bool above = delz > (h - zz);
  zz = below ? (-zz - delz)
             : (above ? ((-zz - delz) + 2.0f * h) : (zz + delz));
  cbt = (below || above) ? -1 : 1;
}

// The ifine vertical Langevin substeps of the boundary layer
// (advance.f90:396-498) over dtf = dt / ifine each, from the turbulence t
// at the start height and the density gradient term rhoaux: zz, wp and cbt
// are advanced in place with the ground/hmix reflection.  Row 0 of tag 2
// at pass `pass` is d2, row s the substep's draw (substep_draw).  Hanna is
// refreshed at zz between substeps, not after the last; that last refresh
// is returned (the adaptive step's next ldt reads it).  TURB is HANNA1 or
// TS; the CBL's substeps are cbl_substeps.
template <int TURB>
__device__ __forceinline__ Turb pbl_substeps(
    const AdvanceArgs& a, const float* d2in, bool injected, long long i,
    uint32_t pass, Turb t, float rhoaux, float dtf, float d2, float d2_odd,
    uint32_t pw[4], float h, float ust, float wst, float ol, float& zz,
    float& wp, int& cbt) {
  constexpr bool TSH = TURB != HANNA1;   // Hanna's turbswitch form
  const float dtftlw = dtf / t.tlw;
  const float rw = expf(-dtftlw);
  const float rnd_exact = sqrtf(clamp_min(1.0f - rw * rw, 0.0f));
  const float rnd_lin = sqrtf(2.0f * dtftlw);
  const bool use_lin = dtftlw < 0.5f;
  for (int s = 0;; ++s) {
    const float rnd =
        s > 0 ? substep_draw(a, d2in, injected, i, pass, s, d2_odd, pw) : d2;
    const float icbtf = static_cast<float>(cbt);
    float wp_new, delz;
    if (TSH) {
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
    if (a.turboff) {
      wp_new = 0.0f;
      delz = 0.0f;
    }
    reflect_substep(delz, h, zz, cbt);
    wp = wp_new;
    if (s == a.ifine - 1) break;
    t = hanna<TSH>(zz, h, ust, wst, ol);
  }
  return t;
}

// The CBL's ifine substeps (K11's CBL instantiations): pbl_substeps with
// the raw wp.  Where dtftlw < 0.5 (from the pass's start turbulence, so
// the same for every substep) the skewed scheme runs in the column's zone
// (cbl_skewed_wp, with rho and drhodz) and the Gaussian drift on the raw
// velocity outside it, a non-finite result redrawn from the substep's
// normal, which sets `nan`; where dtftlw >= 0.5 the turbswitch form's
// exact update runs on the raw wp (the reference's quirk).  `col` is the
// particle's skew_column, computed once a pass.
__device__ __forceinline__ Turb cbl_substeps(
    const AdvanceArgs& a, long long i, uint32_t pass, Turb t, float dtf,
    float d2, float d2_odd, uint32_t pw[4], float h, float ust, float wst,
    float ol, SkewColumn col, float rho, float drhodz, float& zz, float& wp,
    int& cbt, bool& nan) {
  // what depends on dtftlw alone is computed where it is used (the exact
  // form's in every substep that takes it): fewer values held across the
  // substeps, the same values
  const float dtftlw = dtf / t.tlw;
  const float rnd_lin = sqrtf(2.0f * dtftlw);
  const bool use_lin = dtftlw < 0.5f;
  for (int s = 0;; ++s) {
    const float rnd =
        s > 0 ? substep_draw(a, nullptr, false, i, pass, s, d2_odd, pw) : d2;
    const float icbtf = static_cast<float>(cbt);
    float wp_new, delz;
    if (use_lin) {
      if (col.zone) {
        wp_new = cbl_skewed_wp(wp, zz, h, rho, drhodz, t.sigw, t.dsigwdz,
                               t.tlw, col.transition, col.wst3, a.ldirf, dtf,
                               rnd, icbtf, a.key_cbl[2 * s],
                               a.key_cbl[2 * s + 1], a.offset + i, pass);
      } else {
        const float sig = clamp_min(t.sigw, F(1e-6));
        const float ath_g = (((-wp) / t.tlw + sig * t.dsigwdz)
                             + ((wp * wp) / sig) * t.dsigwdz)
                            + ((sig * sig) / rho) * drhodz;
        wp_new = ((wp + ath_g * dtf) + (sig * rnd) * rnd_lin) * icbtf;
      }
      if (!isfinite(wp_new)) {
        nan = true;
        wp_new = clamp_min(t.sigw, F(1e-6)) * rnd;
      }
      delz = wp_new * dtf;
    } else {
      const float rw = expf(-dtftlw);
      const float rnd_exact = sqrtf(clamp_min(1.0f - rw * rw, 0.0f));
      const float drift = t.dsigwdz + (drhodz / rho) * t.sigw;
      wp_new = ((rw * wp + rnd * rnd_exact) + (t.tlw * (1.0f - rw)) * drift)
               * icbtf;
      delz = (wp_new * t.sigw) * dtf;
    }
    if (a.turboff) {
      wp_new = 0.0f;
      delz = 0.0f;
    }
    reflect_substep(delz, h, zz, cbt);
    wp = wp_new;
    if (s == a.ifine - 1) break;
    t = hanna<true>(zz, h, ust, wst, ol);
  }
  return t;
}

// The turbulent terms of a free-troposphere / stratosphere step
// (advance.f90:629-708) at height z from the draws d0-d2: (ux, vy) in the
// troposphere and the transition layer, wp_ft in the transition layer and
// the stratosphere; c_trop = 2 D_TROP / dt and c_strat = 2 D_STRAT / dt of
// the step, uxscale_t and wpscale_s their square roots.
__device__ __forceinline__ void free_trop_terms(
    const AdvanceArgs& a, bool in_trop, bool in_trans, float z, float tropop,
    float d0, float d1, float d2, float c_trop, float c_strat,
    float uxscale_t, float wpscale_s, float& ux, float& vy, float& wp_ft) {
  ux = 0.0f;
  vy = 0.0f;
  wp_ft = 0.0f;
  if (in_trop) {
    ux = d0 * uxscale_t;
    vy = d1 * uxscale_t;
  } else if (in_trans) {
    const float weight = clamp((z - tropop) / 1000.0f, 0.0f, 1.0f);
    const float uxscale_tr = sqrtf(c_trop * (1.0f - weight));
    const float wpscale_tr = sqrtf(c_strat * weight);
    ux = d0 * uxscale_tr;
    vy = d1 * uxscale_tr;
    wp_ft = d2 * wpscale_tr + a.d_strat_1000;
  } else {
    wp_ft = d2 * wpscale_s;
  }
  if (a.turboff) {
    ux = 0.0f;
    vy = 0.0f;
    wp_ft = 0.0f;
  }
}

// The mesoscale draws of a step, tag 4 rows 0-2: one Philox call, two
// radii.
__device__ __forceinline__ void meso_draws(const AdvanceArgs& a,
                                           const Draws& dr, bool injected,
                                           long long i, float& m0, float& m1,
                                           float& m2) {
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
}

// The end of a step, after the boundary layer or the free troposphere:
// the mesoscale memory (draws m0-m2), windalign with the reference wind
// (u_ref, v_ref, w_ref), the metric position update, the polar caps, the
// boundary conditions and the Petterssen corrector with the end-time
// table, whose vertical wind takes `settl_pett` in the SETTLING
// instantiations (the corrector runs where the interval ends in the met
// window, the particle stayed and `pett_gate`).  Returns exited.
template <bool BF16, bool POLAR, bool SETTLING, bool NESTS = false>
__device__ __forceinline__ bool finish_step(
    const AdvanceArgs& a, const void* __restrict__ rowsE, const float* sh_height,
    float x, float y, float& x_hi, float& x_lo, float& y_hi, float& y_lo,
    float& z_new, float dxsave, float dysave, float dawsave, float dcwsave,
    float u, float v, float w, float settl_pett, float& usig, float& vsig,
    float& wsig, float usig_m, float vsig_m, float wsig_m, float m0, float m1,
    float m2, float hm, float htop, bool pett_gate) {
  const float dt = a.dt;
  // mesoscale fluctuations (advance.f90:720-738)
  usig = a.r_meso * usig + ((a.rs_meso * m0) * usig_m) * a.turbmeso;
  vsig = a.r_meso * vsig + ((a.rs_meso * m1) * vsig_m) * a.turbmeso;
  wsig = a.r_meso * wsig + ((a.rs_meso * m2) * wsig_m) * a.turbmeso;
  if (a.turboff) {
    usig = 0.0f;
    vsig = 0.0f;
    wsig = 0.0f;
  }
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
  bool exited = apply_bcs(a, x_hi, x_lo, y_hi, y_lo);
  z_new = tmin(z_new, htop);

  // Petterssen corrector (advance.f90:816-986)
  if (a.can_pett && !exited && pett_gate) {
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
    float du, dv, w2;
    if (NESTS) {
      // the corrector's end-time wind from the innermost nest that holds
      // the predicted position (core/advance.py, the nests' rowsE)
      float u2 = field2(e, 0, hw2.p4, dz2);
      float v2 = field2(e, 1, hw2.p4, dz2);
      w2 = field2(e, 2, hw2.p4, dz2);
#pragma unroll
      for (int k = 0; k < MAX_NESTS; ++k) {
        if (k < a.nnest && in_nest(a, k, xn, yn)) {
          float xt, yt;
          nest_coords(a, k, xn, yn, xt, yt);
          const Horiz hn = horiz_weights(xt, yt, a.nest_nx[k], a.nest_ny[k]);
          const size_t rn = fp::cell_row(indz2, hn.jy, hn.ix, a.nest_ny[k],
                                         a.nest_nx[k]);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            load8<BF16, 32>(a.nest_rows_e[k], rn, q, &e[8 * q]);
          u2 = field2(e, 0, hn.p4, dz2);
          v2 = field2(e, 1, hn.p4, dz2);
          w2 = field2(e, 2, hn.p4, dz2);
        }
      }
      du = (u2 - u) / 2.0f;
      dv = (v2 - v) / 2.0f;
    } else {
      du = (field2(e, 0, hw2.p4, dz2) - u) / 2.0f;
      dv = (field2(e, 1, hw2.p4, dz2) - v) / 2.0f;
      w2 = field2(e, 2, hw2.p4, dz2);
    }
    if (SETTLING) w2 = w2 + settl_pett;
    const float dw = (w2 - w) / 2.0f;
    const float z_corr = reflect_ground(z_new + (dw * dt) * a.ldirf, hm);
    const float cosfact2 = a.dxconst / cosf((yn * a.dy + a.ylat0) * a.pi180);
    ds_add(x_hi, x_lo, ((du * cosfact2) * dt) * a.ldirf);
    ds_add(y_hi, y_lo, ((dv * a.dyconst) * dt) * a.ldirf);
    if (POLAR) polar_update(a, xn, yn, du * dt, dv * dt, x_hi, x_lo, y_hi, y_lo);
    exited = apply_bcs(a, x_hi, x_lo, y_hi, y_lo);
    z_new = tmin(z_corr, htop);
  }
  return exited;
}

}  // namespace

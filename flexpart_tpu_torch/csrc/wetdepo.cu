// K9: the wet-deposition pass, per particle the scavenging coefficient of
// every species, the mass it removes and the decay-corrected deposit.
//
// Replaces: flexpart_tpu/physics/wetdepo.py::wetscav_all (get_wetscav.f90)
// and flexpart_tpu/physics/massupdate.py::apply_wetdepo (wetdepo.f90:
// 102-138), which JAX leaves to XLA as some 80 elementwise operations over
// the particles and 15 over (particles, species).  For each particle the
// thread interpolates the large-scale and convective precipitation and the
// cloud cover bilinearly, reads the cloud class and the temperature of
// its cell (the column is the truncation of x, the level
// the one below z), finds the precipitating fraction of the cell, and for
// each species picks the below-cloud rule (gas A * P**B, or the aerosol
// rain / snow polynomial) or the in-cloud rule (aerosol CCN/IN activation,
// or gas Henry partitioning) that the species' constants select, as the
// Python `if`s of the JAX function select them.  It removes
// mass * (1 - exp(-lambda * dt)) * fraction, keeps the rest where it
// exceeds the smallest normal float, and writes the deposit times the decay
// correction exp(|ldeltat| * decay), zero for an inactive particle.
//
// Arithmetic: the plain version's operations in its order, one rounding
// each (built with -fmad=false), with the functions torch's elementwise
// kernels call on the card (expf, powf, sqrtf), so that the two agree bit
// for bit.  The host folds the constants as the JAX package folds them
// (WetSpec below).  x ** 2 of the ice fraction is x * x there and here.
//
// Bound on the H100: 45 B per particle at two species (positions, z,
// active, mass in and out, the deposit out), 0.14 ms for 10.5M particles;
// the met planes it gathers (4 surface planes, the cloud classes and the
// temperature) are a few MB that stay in the L2 cache.
//
// Design: one thread per particle, every species in a loop over a struct
// array passed by value (MAX_SPECIES of them); the mass is written out of
// place.  The work follows the data: where the plain version selects, the
// kernel branches.  A particle that is not scavenged (inactive, not
// raining, or not in or below a cloud: most of them) takes the light path:
// lambda = 0 there, so expf(-0 * dt) == 1 and the removed mass is
// (m * 0) * fraction, the plain version's value for every m and fraction;
// it reads no cloud class, temperature or level unless it is active and it
// rains, and calls no powf, sqrtf or expf.  A scavenged particle computes,
// per species, only the rule that its cell and the species select, and the
// cloud water once, where an in-cloud rule needs it.  Each rule, the cloud
// water and the removal are functions of their own (__noinline__), so
// that the compiled kernel shows each path's instructions apart (the
// bound's operation count reads them).  The decay corrections are the
// same for every particle: each block computes them once.  The level is
// torch.searchsorted's binary search (right=True), so it finds the plain
// version's level for any height and z.
//
// The BKDEP instantiation (fp_wetdepo with xscav given) replaces:
// flexpart_tpu/physics/bkdep.py::assign_wetbkdep, the scavenging factor of
// a backward wet-deposition run (ind_receptor = 3, timemanager.f90:
// 565-598).  For a fresh particle (active, xscav < 0) it takes the same
// lambda path per species and writes xscav = max(lambda * colh * fraction,
// 0), colh the released column's height, and zeroes the mass where that
// product is not above 0; it removes no mass and writes no deposit.  Every
// other particle keeps its xscav and its mass.
//
// The CLWC instantiation (fp_wetdepo with ctwc given; with or without
// BKDEP) replaces: flexpart_tpu/physics/wetdepo.py::wetscav_all with
// use_clouds_water (:118-121), the in-cloud rule of a run on met that
// carries cloud water (GFS: readwind_gfs.f90:553-570, get_wetscav.f90:
// 274-290).  The cloud water of the in-cloud rule is the column's total
// cloud water ctwc at the particle's truncated cell (jy, ix), not
// interpolated, scaled by the precipitating fraction over the cloud
// cover: ctwc * (fraction / cc), the division first, as the plain version
// computes it; everything else is K9's.  Its bound: K9's bytes and 4 B of
// ctwc per particle in cloud; cloud_water_column's instructions in place
// of cloud_water's.
#include <cstdint>
#include <cuda_runtime.h>

#include "at_least_zero.cuh"

namespace {

constexpr int THREADS = 256;
// resident blocks per SM that the registers must allow (32 registers: a
// full SM, which the gathers of a cell-ordered ensemble want)
constexpr int MIN_BLOCKS = 8;
constexpr int MAX_SPECIES = 32;
constexpr float TINY = 1.17549435e-38f;     // finfo(float32).tiny
constexpr float INCLOUD_RATIO = 6.2f;

// one species' constants, folded on the host (physics/wetdepo.py WetSpec)
struct WetSpec {
  int below;      // 0 none, 1 gas A * P**B, 2 aerosol rain / snow
  int incloud;    // 0 none, 1 aerosol CCN / IN, 2 gas Henry
  int rain, snow; // the aerosol's rain and snow terms exist
  float weta, wetb;
  float rain_eff, rain_base, rain_c5;
  float snow_eff, snow_base, snow_c5;
  float ccn, in_;
  float henry_r;  // float32(henry * (R_AIR / 3500)), folded in float64
  float dec;      // decay constant [1/s], <= 0 off
};

struct Specs {
  WetSpec s[MAX_SPECIES];
};

struct In {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const bool* active;
  const float* mass;                      // (n, nspec)
  const float* xscav;                     // (n, nspec): BKDEP only
  const float *lsp, *convp, *tcc;         // (ny, nx) planes of f2d
  const float* ctwc;                      // (ny, nx) plane of f2d: CLWC only
  const int8_t* clouds;                   // (nz, ny, nx)
  const float* tt;                        // (nz, ny, nx) plane of f3d
  const float* height;                    // (nz,)
};

struct Cfg {
  int nz, ny, nx, n, nspec, ltsample, ldeltat;
  float colh;                             // BKDEP: the released column [m]
};

// clamp(v, lo) and clamp(v, lo, hi) as torch's, a NaN passing through
__device__ __forceinline__ float at_least(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

// interp_2d's sum of the four corner terms, left to right
__device__ __forceinline__ float bilinear(const float* f, const int* idx,
                                          const float* p4) {
  return ((f[idx[0]] * p4[0] + f[idx[1]] * p4[1]) + f[idx[2]] * p4[2]) +
         f[idx[3]] * p4[3];
}

// --- the scavenged paths: one function each ---

// below cloud, a gas: A * P**B
__device__ __noinline__ float lam_below_gas(float weta, float wetb,
                                            float prec) {
  return weta * powf(prec, wetb);
}

// below cloud, an aerosol's rain or snow term: eff * 10**(base + c5 sqrt P)
__device__ __noinline__ float lam_below_aerosol(float eff, float base,
                                                float c5, float prec) {
  return eff * powf(10.0f, base + c5 * sqrtf(prec));
}

// the cloud water from the rate
__device__ __noinline__ float cloud_water(float prec) {
  return 0.2f * powf(prec, 0.36f);             // 1e6 * 2e-7
}

// CLWC: the column cloud water of readclouds at the particle's cell, per
// precipitating fraction of the cloud cover
__device__ __noinline__ float cloud_water_column(float ctwc, float grf,
                                                 float cc) {
  return ctwc * (grf / cc);
}

// in cloud, an aerosol: CCN / IN activation by the ice fraction
__device__ __noinline__ float lam_in_cloud_aerosol(float ccn, float in_,
                                                   float act_temp, float cl,
                                                   float prec) {
  const float t = (act_temp - 273.0f) / 20.0f;
  float ice = clamp01(t * t);
  ice = act_temp <= 253.0f ? 1.0f : ice;
  ice = act_temp >= 273.0f ? 0.0f : ice;
  const float liq = at_least(1.0f - ice, 0.0f);
  const float s_i = (liq * ccn + ice * in_) / at_least(cl, 1e-30f);
  return (INCLOUD_RATIO * s_i) * (prec / 3.6e6f);
}

// in cloud, a gas: Henry partitioning
__device__ __noinline__ float lam_in_cloud_gas(float henry_r, float act_temp,
                                               float cl, float prec) {
  const float cle = (1.0f - cl) / (henry_r * act_temp) + cl;
  const float s_i = 1.0f / cle;
  return (INCLOUD_RATIO * s_i) * (prec / 3.6e6f);
}

// the mass a scavenged species loses
__device__ __noinline__ float wet_removal(float m, float lam, float lts,
                                         float grf) {
  return (m * (1.0f - expf(-lam * lts))) * grf;
}

// BKDEP: the backward run's factor xscav of a fresh particle from lambda
// (0 without a rule); the mass stays, or is zeroed where xscav is not > 0
__device__ __forceinline__ void bkdep_factor(float lam, const Cfg& c,
                                             float grf, float m,
                                             float* mass_out, float* xs_out) {
  const float xs_new = (lam * c.colh) * grf;
  *xs_out = fp::at_least_zero(xs_new);
  *mass_out = xs_new <= 0.0f ? 0.0f : m;
}

template <bool BKDEP, bool CLWC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wetdepo_kernel(const In in, const Cfg c, const Specs sp,
               float* __restrict__ mass_out, float* __restrict__ deposit,
               float* __restrict__ xscav_out) {
  // exp(|ldeltat| * decay): the same for every particle, made once per
  // block while the particles' loads are in flight
  __shared__ float corr[MAX_SPECIES];
  if (static_cast<int>(threadIdx.x) < c.nspec) {
    const float dec = sp.s[threadIdx.x].dec;
    corr[threadIdx.x] =
        dec > 0.0f ? expf(static_cast<float>(c.ldeltat) * dec) : 1.0f;
  }
  // a thread past the end reads the last particle and stores nothing
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const bool inside = q < c.n;
  const int p = inside ? q : c.n - 1;
  const float x = in.x_hi[p] + in.x_lo[p];
  const float y = in.y_hi[p] + in.y_lo[p];
  // BKDEP: only a fresh particle takes the pass, the others keep their
  // values
  const bool active = in.active[p] &&
                      (!BKDEP || in.xscav[static_cast<long long>(p) * c.nspec] < 0.0f);

  // horiz_weights(x, y, nx, ny, xglobal=False)
  int ix = static_cast<int>(fminf(fmaxf(floorf(x), 0.0f),
                                  static_cast<float>(c.nx - 2)));
  int jy = static_cast<int>(fminf(fmaxf(floorf(y), 0.0f),
                                  static_cast<float>(c.ny - 2)));
  const float ddx = clamp01(x - static_cast<float>(ix));
  const float ddy = clamp01(y - static_cast<float>(jy));
  const float rddx = 1.0f - ddx;
  const float rddy = 1.0f - ddy;
  const float p4[4] = {rddx * rddy, ddx * rddy, rddx * ddy, ddx * ddy};
  const int jyp = jy + 1 < c.ny - 1 ? jy + 1 : c.ny - 1;
  const int idx[4] = {jy * c.nx + ix, jy * c.nx + ix + 1, jyp * c.nx + ix,
                      jyp * c.nx + ix + 1};
  const float lsp = bilinear(in.lsp, idx, p4);
  const float convp = bilinear(in.convp, idx, p4);
  const float cc = at_least(bilinear(in.tcc, idx, p4), 1e-10f);

  // the precipitating fraction of the cell
  const float LFR[5] = {0.5f, 0.65f, 0.8f, 0.9f, 0.95f};
  const float CFR[5] = {0.4f, 0.55f, 0.7f, 0.8f, 0.9f};
  const int i_l = (lsp >= 1.0f) + (lsp >= 3.0f) + (lsp >= 8.0f) + (lsp >= 20.0f);
  const int i_c =
      (convp >= 1.0f) + (convp >= 3.0f) + (convp >= 8.0f) + (convp >= 20.0f);
  const float tot = at_least(lsp + convp, 1e-30f);
  const float grf =
      at_least(cc * (lsp * LFR[i_l] + convp * CFR[i_c]) / tot, 0.05f);

  // the cell, where it matters: the column by truncation, the level below z
  const bool raining = (lsp >= 0.01f) || (convp >= 0.01f);
  int cell2 = 0, cell3 = 0, clouds_v = 0;
  if (active && raining) {
    const float z = in.z[p];
    int tx = static_cast<int>(x);
    int ty = static_cast<int>(y);
    tx = tx < 0 ? 0 : (tx > c.nx - 1 ? c.nx - 1 : tx);
    ty = ty < 0 ? 0 : (ty > c.ny - 1 ? c.ny - 1 : ty);
    int lo = 0, hi = c.nz;                   // searchsorted(side="right")
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(in.height[mid] > z)) lo = mid + 1; else hi = mid;
    }
    int hz = lo - 1;
    hz = hz < 0 ? 0 : (hz > c.nz - 2 ? c.nz - 2 : hz);
    cell3 = (hz * c.ny + ty) * c.nx + tx;
    if (CLWC) cell2 = ty * c.nx + tx;
    clouds_v = in.clouds[cell3];
  }
  const bool valid = clouds_v > 1;           // active, raining, in or below a cloud
  const long long row = static_cast<long long>(p) * c.nspec;
  __syncthreads();                           // corr
  if (!inside) return;

  if (BKDEP && !active) {
    for (int s = 0; s < c.nspec; ++s) {
      mass_out[row + s] = in.mass[row + s];
      xscav_out[row + s] = in.xscav[row + s];
    }
    return;
  }
  if (BKDEP && !valid) {
    for (int s = 0; s < c.nspec; ++s)
      bkdep_factor(0.0f, c, grf, in.mass[row + s], mass_out + row + s,
                   xscav_out + row + s);
    return;
  }
  if (!valid) {
    for (int s = 0; s < c.nspec; ++s) {
      const float m = in.mass[row + s];
      const float wetdep = (m * 0.0f) * grf;
      const float rest = m - wetdep;
      mass_out[row + s] = rest > TINY ? rest : 0.0f;
      deposit[static_cast<long long>(s) * c.n + p] =
          active ? wetdep * corr[s] : 0.0f;
    }
    return;
  }

  const float act_temp = in.tt[cell3];
  const bool below = clouds_v >= 4;
  const float prec = (lsp + convp) / grf;
  const float lts = static_cast<float>(c.ltsample);
  float cl = 0.0f;
  bool have_cl = false;
  for (int s = 0; s < c.nspec; ++s) {
    const WetSpec& w = sp.s[s];
    float lam = 0.0f;
    bool rule = false;
    if (below) {
      if (w.below == 1) {
        lam = lam_below_gas(w.weta, w.wetb, prec);
        rule = true;
      } else if (w.below == 2) {
        if (act_temp >= 273.0f) {
          if (w.rain) {
            lam = lam_below_aerosol(w.rain_eff, w.rain_base, w.rain_c5, prec);
            rule = true;
          }
        } else if (w.snow) {
          lam = lam_below_aerosol(w.snow_eff, w.snow_base, w.snow_c5, prec);
          rule = true;
        }
      }
    } else if (w.incloud != 0) {
      if (!have_cl) {
        cl = CLWC ? cloud_water_column(in.ctwc[cell2], grf, cc)
                  : cloud_water(prec);
        have_cl = true;
      }
      lam = w.incloud == 1
                ? lam_in_cloud_aerosol(w.ccn, w.in_, act_temp, cl, prec)
                : lam_in_cloud_gas(w.henry_r, act_temp, cl, prec);
      rule = true;
    }
    const float m = in.mass[row + s];
    if constexpr (BKDEP) {
      bkdep_factor(rule ? lam : 0.0f, c, grf, m, mass_out + row + s,
                   xscav_out + row + s);
      continue;
    }
    // without a rule lambda is 0: the light path's value
    const float wetdep = rule ? wet_removal(m, lam, lts, grf) : (m * 0.0f) * grf;
    const float rest = m - wetdep;
    mass_out[row + s] = rest > TINY ? rest : 0.0f;
    deposit[static_cast<long long>(s) * c.n + p] = wetdep * corr[s];
  }
}

// the species' structs from the host array (a void pointer: the struct's
// type is local to this file, and a C function with it in its signature is
// not exported)
Specs copy_specs(const void* specs_in, int nspec) {
  Specs sp{};
  const WetSpec* specs = static_cast<const WetSpec*>(specs_in);
  for (int s = 0; s < nspec; ++s) sp.s[s] = specs[s];
  return sp;
}

}  // namespace

// xscav NULL: the wet pass, the mass and the deposit out; xscav (n, nspec)
// given: the BKDEP instantiation, xscav in and out and the mass out, with
// the released column's height colh (ltsample, ldeltat and deposit unused).
// ctwc (ny, nx) given: the CLWC instantiation of either
extern "C" int fp_wetdepo(const float* x_hi, const float* x_lo,
                          const float* y_hi, const float* y_lo,
                          const float* z, const bool* active,
                          const float* mass, const float* xscav,
                          const float* lsp, const float* convp,
                          const float* tcc, const float* ctwc,
                          const int8_t* clouds,
                          const float* tt, const float* height, int nz,
                          int ny, int nx, const void* specs_in, int n,
                          int nspec, int ltsample, int ldeltat, float colh,
                          float* mass_out, float* deposit, float* xscav_out,
                          void* stream) {
  if (n <= 0) return 0;
  const bool bkdep = xscav != nullptr;
  const bool clwc = ctwc != nullptr;
  if (nspec < (bkdep ? 1 : 0) || nspec > MAX_SPECIES || nz < 2 || ny < 2 ||
      nx < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const In in = {x_hi, x_lo, y_hi, y_lo, z, active, mass, xscav, lsp,
                 convp, tcc, ctwc, clouds, tt, height};
  const Cfg c{nz, ny, nx, n, nspec, ltsample, ldeltat, colh};
  const int blocks = (n + THREADS - 1) / THREADS;
  auto kern = bkdep ? (clwc ? wetdepo_kernel<true, true>
                            : wetdepo_kernel<true, false>)
                    : (clwc ? wetdepo_kernel<false, true>
                            : wetdepo_kernel<false, false>);
  kern<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, c, copy_specs(specs_in, nspec), mass_out, deposit, xscav_out);
  return static_cast<int>(cudaGetLastError());
}

// K10: the decay and dry-deposition pass, per particle the deposition
// probability, decay, the decay-corrected deposit and minmass termination.
//
// Replaces: flexpart_tpu/physics/massupdate.py::apply_decay_drydep
// (timemanager.f90:643-686, interpol_vdep.f90), which JAX leaves to XLA as
// some 30 operations over (particles, species).  For each particle the
// thread interpolates each depositing species' velocity bilinearly
// (horiz_weights with xglobal = False), takes prob = 1 - exp(-vdep * dt /
// (2 HREF)) below 2 HREF and 0 above after a fixed step, or, after an
// adaptive step (the T_BELOW instantiation, massupdate.py:79-80), prob =
// 1 - exp(-vdep * t_below / (2 HREF)) with the seconds t_below the particle
// spent below 2 HREF and no height test; multiplies the mass by
// (1 - prob) * exp(-dt * decay), writes the
// removed part times the decay correction exp(|ldeltat| * decay) as the
// deposit (zero for an inactive particle), and ends the particle where no
// species keeps minmass of its released mass (a species released with no
// mass counts as kept).  An inactive particle keeps its mass.
//
// Arithmetic: the plain version's operations in its order, one rounding
// each (built with -fmad=false), with the expf that torch's elementwise
// kernels call on the card, so that the two agree bit for bit.
//
// Bound on the H100: 54 B per particle at two species (positions, z,
// active in and out, mass and mass0 in, mass out, the deposit out), 0.17 ms
// for 10.5M particles, 4 B more with t_below; the velocity field it
// gathers is a few MB in L2.
//
// Design: one thread per particle, every species in a loop over a struct
// array passed by value (MAX_SPECIES of them); all outputs out of place.
//
// The BKDEP instantiation (fp_drydepo with xscav given) replaces:
// flexpart_tpu/physics/bkdep.py::assign_drybkdep, the scavenging factor of
// a backward dry-deposition run (ind_receptor = 4, get_vdep_prob.f90:
// 43-61): the same vdep gather, for every species of a fresh particle
// (active, xscav < 0), writes xscav = max(vdep, 0) and zeroes the mass
// where vdep is not above 0; every other particle keeps its xscav and its
// mass.  It applies no decay and no deposition.  Its bytes by need: every
// slot's active flag and its mass and xscav rows in and out, and a fresh
// slot's positions; so it reads active and the first factor first, and
// loads the positions, builds the stencil and gathers the velocities only
// for a fresh slot (bkdep_row); a row moves as float2 pairs where nspec is
// even and the rows are 8-byte aligned (Cfg.pairs), else as scalars, and a
// row that is not fresh is a straight copy.
#include <cstdint>
#include <cuda_runtime.h>

#include "at_least_zero.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SPECIES = 32;
constexpr float TWO_HREF = 30.0f;          // 2 * HREF, HREF = 15 m

// one species' constants (physics/massupdate.py DrySpec)
struct DrySpec {
  float dec;      // decay constant [1/s], <= 0 off
  int drydep;     // the species deposits dry
};

struct Specs {
  DrySpec s[MAX_SPECIES];
};

struct In {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const bool* active;
  const float *mass, *mass0;               // (n, nspec)
  const float* vdep;                       // (nspec, ny, nx) or NULL
  const float* t_below;                    // (n,): the T_BELOW instantiation
  const float* xscav;                      // (n, nspec): BKDEP
};

struct Cfg {
  int ny, nx, n, nspec, lsynctime, ldeltat;
  float minmass;
  int pairs;      // BKDEP: nspec even and the mass and xscav rows 8-byte
                  // aligned, so a row moves as float2 pairs
};

__device__ __forceinline__ float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

// The BKDEP instantiation's slot p: a fresh slot (active, its first
// factor below 0) takes max(vdep, 0) for every species and its mass zeroed
// where vdep is not above 0; any other slot's row is copied.
__device__ __forceinline__ void bkdep_row(const In& in, const Cfg& c, int p,
                                          float* __restrict__ mass_out,
                                          float* __restrict__ xscav_out) {
  const long long row = static_cast<long long>(p) * c.nspec;
  const bool active = in.active[p];
  float2 xs = c.pairs ? *reinterpret_cast<const float2*>(in.xscav + row)
                      : make_float2(in.xscav[row], 0.0f);
  if (!(active && xs.x < 0.0f)) {
    if (c.pairs) {
      for (int s = 0; s < c.nspec; s += 2) {
        if (s > 0) xs = *reinterpret_cast<const float2*>(in.xscav + row + s);
        *reinterpret_cast<float2*>(xscav_out + row + s) = xs;
        *reinterpret_cast<float2*>(mass_out + row + s) =
            *reinterpret_cast<const float2*>(in.mass + row + s);
      }
    } else {
      for (int s = 0; s < c.nspec; ++s) {
        xscav_out[row + s] = s == 0 ? xs.x : in.xscav[row + s];
        mass_out[row + s] = in.mass[row + s];
      }
    }
    return;
  }
  // horiz_weights(x, y, nx, ny, xglobal=False)
  const float x = in.x_hi[p] + in.x_lo[p];
  const float y = in.y_hi[p] + in.y_lo[p];
  const int ix = static_cast<int>(fminf(fmaxf(floorf(x), 0.0f),
                                        static_cast<float>(c.nx - 2)));
  const int jy = static_cast<int>(fminf(fmaxf(floorf(y), 0.0f),
                                        static_cast<float>(c.ny - 2)));
  const float ddx = clamp01(x - static_cast<float>(ix));
  const float ddy = clamp01(y - static_cast<float>(jy));
  const float rddx = 1.0f - ddx;
  const float rddy = 1.0f - ddy;
  const float p0 = rddx * rddy, p1 = ddx * rddy, p2 = rddx * ddy,
              p3 = ddx * ddy;
  const int jyp = jy + 1 < c.ny - 1 ? jy + 1 : c.ny - 1;
  const int i0 = jy * c.nx + ix, i2 = jyp * c.nx + ix;
  const long long plane = static_cast<long long>(c.ny) * c.nx;
  for (int s = 0; s < c.nspec; s += c.pairs ? 2 : 1) {
    const int k = c.pairs ? 2 : 1;
    float vd[2], m[2];
    if (c.pairs) {
      const float2 mm = *reinterpret_cast<const float2*>(in.mass + row + s);
      m[0] = mm.x;
      m[1] = mm.y;
    } else {
      m[0] = in.mass[row + s];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= k) break;
      const float* f = in.vdep + (s + q) * plane;
      vd[q] = ((f[i0] * p0 + f[i0 + 1] * p1) + f[i2] * p2) + f[i2 + 1] * p3;
    }
    if (c.pairs) {
      *reinterpret_cast<float2*>(xscav_out + row + s) =
          make_float2(fp::at_least_zero(vd[0]), fp::at_least_zero(vd[1]));
      *reinterpret_cast<float2*>(mass_out + row + s) =
          make_float2(vd[0] <= 0.0f ? 0.0f : m[0],
                      vd[1] <= 0.0f ? 0.0f : m[1]);
    } else {
      xscav_out[row + s] = fp::at_least_zero(vd[0]);
      mass_out[row + s] = vd[0] <= 0.0f ? 0.0f : m[0];
    }
  }
}

template <bool T_BELOW, bool BKDEP>
__global__ void __launch_bounds__(THREADS)
drydepo_kernel(const In in, const Cfg c, const Specs sp,
               float* __restrict__ mass_out, bool* __restrict__ active_out,
               float* __restrict__ deposit, float* __restrict__ xscav_out) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= c.n) return;
  if constexpr (BKDEP) {
    bkdep_row(in, c, p, mass_out, xscav_out);
    return;
  }
  const bool active = in.active[p];

  // horiz_weights(x, y, nx, ny, xglobal=False), when there is a field
  int idx[4] = {0, 0, 0, 0};
  float p4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (in.vdep != nullptr) {
    const float x = in.x_hi[p] + in.x_lo[p];
    const float y = in.y_hi[p] + in.y_lo[p];
    const int ix = static_cast<int>(fminf(fmaxf(floorf(x), 0.0f),
                                          static_cast<float>(c.nx - 2)));
    const int jy = static_cast<int>(fminf(fmaxf(floorf(y), 0.0f),
                                          static_cast<float>(c.ny - 2)));
    const float ddx = clamp01(x - static_cast<float>(ix));
    const float ddy = clamp01(y - static_cast<float>(jy));
    const float rddx = 1.0f - ddx;
    const float rddy = 1.0f - ddy;
    p4[0] = rddx * rddy;
    p4[1] = ddx * rddy;
    p4[2] = rddx * ddy;
    p4[3] = ddx * ddy;
    const int jyp = jy + 1 < c.ny - 1 ? jy + 1 : c.ny - 1;
    idx[0] = jy * c.nx + ix;
    idx[1] = jy * c.nx + ix + 1;
    idx[2] = jyp * c.nx + ix;
    idx[3] = jyp * c.nx + ix + 1;
  }
  const long long plane = static_cast<long long>(c.ny) * c.nx;

  const float z = in.z[p];
  const float dt = static_cast<float>(c.lsynctime);
  const float ldt = static_cast<float>(c.ldeltat);
  const float tb = T_BELOW ? in.t_below[p] : 0.0f;
  bool keep = false;
  float xmax = 0.0f;
  for (int s = 0; s < c.nspec; ++s) {
    const DrySpec& w = sp.s[s];
    const float decf = w.dec > 0.0f ? expf(-dt * w.dec) : 1.0f;
    float prob = 0.0f;
    if (w.drydep && in.vdep != nullptr && (T_BELOW || z < TWO_HREF)) {
      const float* f = in.vdep + s * plane;
      const float vd = ((f[idx[0]] * p4[0] + f[idx[1]] * p4[1]) +
                        f[idx[2]] * p4[2]) + f[idx[3]] * p4[3];
      prob = 1.0f - expf((-vd * (T_BELOW ? tb : dt)) / TWO_HREF);
    }
    const long long k = static_cast<long long>(p) * c.nspec + s;
    const float m = in.mass[k];
    const float drydep = (m * prob) * decf;
    const float new_mass = (m * (1.0f - prob)) * decf;
    const float corr = w.dec > 0.0f ? expf(ldt * w.dec) : 1.0f;
    deposit[static_cast<long long>(s) * c.n + p] = active ? drydep * corr : 0.0f;
    mass_out[k] = active ? new_mass : m;
    // the largest share of the released mass left, as torch.amax: a NaN wins
    const float m0 = in.mass0[k];
    const float frac = m0 > 0.0f ? new_mass / m0 : 1.0f;
    if (s == 0 || frac != frac || (xmax == xmax && frac > xmax)) xmax = frac;
  }
  keep = xmax >= c.minmass;
  active_out[p] = active && keep;
}

}  // namespace

// xscav NULL: decay, dry deposition and minmass, the T_BELOW instantiation
// where t_below is given; xscav (n, nspec) given: the BKDEP instantiation,
// xscav in and out and the mass out, vdep required (z, mass0, t_below, the
// species, the times, minmass, active_out and deposit unused)
extern "C" int fp_drydepo(const float* x_hi, const float* x_lo,
                          const float* y_hi, const float* y_lo,
                          const float* z, const bool* active,
                          const float* mass, const float* mass0,
                          const float* xscav, const float* vdep, int ny,
                          int nx, const float* t_below, const void* specs_in,
                          int n, int nspec, int lsynctime, int ldeltat,
                          float minmass, float* mass_out, bool* active_out,
                          float* deposit, float* xscav_out, void* stream) {
  if (n <= 0) return 0;
  const bool bkdep = xscav != nullptr;
  if (nspec < 1 || nspec > MAX_SPECIES ||
      (vdep != nullptr && (ny < 2 || nx < 2)) || (bkdep && vdep == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Specs sp{};
  // the host array of DrySpec (a void pointer: the struct's type is local
  // to this file, and a C function with it in its signature is not exported)
  const DrySpec* specs = static_cast<const DrySpec*>(specs_in);
  if (!bkdep)
    for (int s = 0; s < nspec; ++s) sp.s[s] = specs[s];
  const In in = {x_hi, x_lo, y_hi, y_lo, z, active, mass, mass0, vdep,
                 t_below, xscav};
  const bool pairs =
      bkdep && nspec % 2 == 0 &&
      reinterpret_cast<uintptr_t>(mass) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(xscav) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(mass_out) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(xscav_out) % 8 == 0;
  const Cfg c{ny, nx, n, nspec, lsynctime, ldeltat, minmass, pairs ? 1 : 0};
  const int blocks = (n + THREADS - 1) / THREADS;
  auto kern = bkdep ? drydepo_kernel<false, true>
                    : (t_below != nullptr ? drydepo_kernel<true, false>
                                          : drydepo_kernel<false, false>);
  kern<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, c, sp, mass_out, active_out, deposit, xscav_out);
  return static_cast<int>(cudaGetLastError());
}

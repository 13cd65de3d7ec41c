// K12: the OH reaction, per particle the cell-centre temperature, the
// nearest OH cell, the hourly interpolation of the OH field, the Arrhenius
// rate and the mass decay of every OH-reactive species.
//
// Replaces: flexpart_tpu/physics/ohchem.py::make_ohreaction (its jitted
// body, ohchem.py:210-233; ohreaction.f90:100-160), which JAX leaves to
// XLA, fused with flexpart_tpu/run/simulation.py::_cell_temps (:1627-1635,
// ohreaction.f90:139).  For each particle the thread takes TT at
// (clip(int x), clip(int y), indz) of the wind field nearer the middle of
// the step, indz by torch.searchsorted's binary search (right=True) as
// core/interp.py::vert_weights; the nearest OH longitude, latitude and
// layer top, the first of equal distances (a NaN distance the least, as
// jnp.argmin and torch.argmin); oh_avg = oh0 * (1 - w) + oh1 * w with
// w = (itime - t0) / (t1 - t0), a true division, clamped at 0 (a NaN
// passing); and for each OH-reactive species
// rate = c * T**n * exp(-d / T) * oh_avg, fac = exp(-rate * |ltsample|),
// the mass times fac, 0 below FLT_MIN.  The mass is kept where the
// particle is inactive or oh_avg <= 0.
//
// Arithmetic: the plain version's operations in its order, one rounding
// each (built with -fmad=false), with the powf and expf that torch's
// elementwise kernels call on the card, so that the two agree bit for bit.
//
// Bound on the H100: 41 B per particle at two species (positions, z,
// active, the mass in and out, a 4 B temperature gather): 0.128 ms for
// 10 x 2**20 particles, 0.154 ms for 12 x 2**20.
//
// Design.
// * One blended field.  oh_avg depends on the particle only through its
//   cell, so each block blends the two hourly fields once per OH cell,
//   at_least_zero(oh0 * w1 + oh1 * w) in the plain version's order, while
//   it fills its shared memory: the same operations on the same values,
//   so the same bits, in half the shared bytes of the two fields (72 x 46
//   x 7 cells: 92,736 B, the axes and levels 620 B more).  Two blocks fit
//   on an SM.
// * The nearest index by search.  On an axis that is finite and
//   nondecreasing, e_i = fl(a_i - v) is nondecreasing in i (rounding is
//   monotone), so |e_i| falls to the first i with e_i >= 0 (j, found by
//   binary search; -0 counts) and rises from there: the least distance
//   lies at j or at j - 1, j - 1 winning a tie (the first of equal
//   distances), and where j - 1 wins, the first index of its value of e
//   (a plateau, where a_i - v rounds alike) by a second bounded binary
//   search.  v NaN takes 0 (every distance NaN, the first counts as the
//   least), v = +-inf too (every distance +inf).  7 / 6 / 3 probes for
//   72 / 46 / 7 entries in place of 125 steps.  The host checks each grid
//   once (physics/ohchem.py::make_ohreaction); a grid with an axis that is
//   not finite and nondecreasing takes the SCAN instantiation, the scan
//   of every entry, so every input the plain version takes is taken.
// * The layout: THREADS threads a block, MIN_BLOCKS blocks an SM, resident
//   blocks walking the particles with a grid stride.  A thread loads its
//   particle's fields in one round; an inactive particle writes its mass
//   through without the gather, the searches or the species loop.  The
//   layout (shared bytes, resident blocks) is planned once per device and
//   grid and kept for the launches that follow; an OH grid whose blended
//   field does not fit in a block's shared memory is refused
//   (cudaErrorInvalidValue): FLEXPART's climatology and the synthetic one
//   are both 72 x 46 x 7.
#include <cfloat>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "at_least_zero.cuh"
#include "cell_index.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MIN_BLOCKS = 2;
constexpr int MAX_SPECIES = 32;

// one species' constants (physics/ohchem.py OHSpec)
struct OHSpec {
  float c, d, n;  // rate = c * T**n * exp(-d / T) * [OH]
  int on;         // the species reacts with OH (ohcconst > 0)
};

struct Specs {
  OHSpec s[MAX_SPECIES];
};

struct In {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const bool* active;
  const float* mass;                       // (n, nspec)
  const float* tt;                         // (nz, ny, nx)
  const float* height;                     // (nz,)
  const float* axes;                       // lon (nxo), lat (nyo), alt_top (nzo)
  const float *oh0, *oh1;                  // (nxo, nyo, nzo)
};

struct Cfg {
  int nz, ny, nx;
  float xlon0, ylat0, dx, dy;
  int nxo, nyo, nzo;
  int itime, t0, t1;
  int n, nspec, ltsample;
};

// A block's shared memory: the blended field first (16 B aligned), then
// the three axes and the height levels.
struct Shared {
  float *oh, *lon, *lat, *alt, *h;
};

__device__ __forceinline__ Shared carve(float* sh, const Cfg& c) {
  Shared s;
  s.oh = sh;
  s.lon = s.oh + c.nxo * c.nyo * c.nzo;
  s.lat = s.lon + c.nxo;
  s.alt = s.lat + c.nyo;
  s.h = s.alt + c.nzo;
  return s;
}

// the hourly weight w = (itime - t0) / (t1 - t0), a true division
__device__ __forceinline__ float hour_weight(const Cfg& c) {
  return static_cast<float>(c.itime - c.t0) / static_cast<float>(c.t1 - c.t0);
}

// oh_avg of one cell: oh0 * (1 - w) + oh1 * w, clamped at 0 (NaN passing)
__device__ __forceinline__ float blend(float oh0, float oh1, float w1,
                                       float w) {
  const float a = oh0 * w1;
  const float b = oh1 * w;
  return fp::at_least_zero(a + b);
}

// argmin |axis[i] - v| by a scan: the first of equal distances, a NaN the
// least (the SCAN instantiation: an axis that is not finite and
// nondecreasing)
__device__ __forceinline__ int nearest_scan(const float* axis, int len,
                                            float v) {
  int best_i = 0;
  float best = fabsf(axis[0] - v);
  for (int i = 1; i < len; ++i) {
    const float d = fabsf(axis[i] - v);
    if (d < best || (d != d && best == best)) {
      best = d;
      best_i = i;
    }
  }
  return best_i;
}

// The first i in [lo, hi) with fl(axis[i] - v) >= t, hi where none: a
// binary search, since the difference is nondecreasing in i.
__device__ __forceinline__ int first_at_least(const float* axis, int lo,
                                              int hi, float v, float t) {
  int n = hi - lo;
  while (n > 0) {
    const int half = n >> 1;
    if (axis[lo + half] - v >= t) {
      n = half;
    } else {
      lo += half + 1;
      n -= half + 1;
    }
  }
  return lo;
}

// argmin |axis[i] - v| on a finite nondecreasing axis, the same index as
// nearest_scan (physics/ohchem.py::nearest_sorted is its plain mirror)
__device__ __forceinline__ int nearest_sorted(const float* axis, int len,
                                              float v) {
  if (v != v) return 0;
  const int j = first_at_least(axis, 0, len, v, 0.0f);
  if (j == 0) return 0;
  const float below = axis[j - 1] - v;        // < 0: |e| = -below
  if (j < len && axis[j] - v < -below) return j;
  if (j == 1 || axis[j - 2] - v != below) return j - 1;
  return first_at_least(axis, 0, j - 1, v, below);
}

template <bool SCAN>
__device__ __forceinline__ int nearest(const float* axis, int len, float v) {
  return SCAN ? nearest_scan(axis, len, v) : nearest_sorted(axis, len, v);
}

// One particle: its fields in one round, then (active) the temperature
// gather, the three nearest indices, the blended OH of the cell and the
// species' decay; the mass written out.
template <bool SCAN>
__device__ __forceinline__ void react(const In& in, const Cfg& c,
                                      const Specs& sp, const Shared& s,
                                      float dt, int p,
                                      float* __restrict__ mass_out) {
  const long long row = static_cast<long long>(p) * c.nspec;
  const bool active = in.active[p];
  const float x_hi = in.x_hi[p], x_lo = in.x_lo[p];
  const float y_hi = in.y_hi[p], y_lo = in.y_lo[p];
  const float z = in.z[p];
  if (!active) {
    for (int k = 0; k < c.nspec; ++k) mass_out[row + k] = in.mass[row + k];
    return;
  }
  const float x = x_hi + x_lo;
  const float y = y_hi + y_lo;

  // the cell-centre temperature (truncated column, the level below z)
  const int ix = min(max(__float2int_rz(x), 0), c.nx - 1);
  const int jy = min(max(__float2int_rz(y), 0), c.ny - 1);
  int indz;
  float dz1;
  fp::vert_weights(s.h, c.nz, z, indz, dz1);
  const float temp = in.tt[(static_cast<long long>(indz) * c.ny + jy) * c.nx
                           + ix];

  // the nearest OH cell and its blended field
  float xlon = x * c.dx + c.xlon0;
  if (xlon > 180.0f) xlon = xlon - 360.0f;
  const float ylat = y * c.dy + c.ylat0;
  const int io = nearest<SCAN>(s.lon, c.nxo, xlon);
  const int jo = nearest<SCAN>(s.lat, c.nyo, ylat);
  const int ko = nearest<SCAN>(s.alt, c.nzo, z);
  const float oh = s.oh[(io * c.nyo + jo) * c.nzo + ko];
  const bool reacts = oh > 0.0f;

  for (int k = 0; k < c.nspec; ++k) {
    float m = in.mass[row + k];
    const OHSpec& q = sp.s[k];
    if (reacts && q.on) {
      const float rate = ((q.c * powf(temp, q.n)) * expf((-q.d) / temp))
                         * oh;
      const float fac = expf((-rate) * dt);
      const float nm = m * fac;
      m = nm > FLT_MIN ? nm : 0.0f;
    }
    mass_out[row + k] = m;
  }
}

size_t shared_bytes(const Cfg& c) {
  const size_t cells = static_cast<size_t>(c.nxo) * c.nyo * c.nzo;
  return sizeof(float) * (cells + c.nxo + c.nyo + c.nzo + c.nz);
}

template <bool SCAN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ohreaction_kernel(const In in, const Cfg c, const Specs sp,
                  float* __restrict__ mass_out) {
  extern __shared__ float sh[];
  const Shared s = carve(sh, c);
  const int naxes = c.nxo + c.nyo + c.nzo;
  const int cells = c.nxo * c.nyo * c.nzo;
  const float w = hour_weight(c);
  const float w1 = 1.0f - w;
  for (int i = threadIdx.x; i < naxes; i += THREADS) s.lon[i] = in.axes[i];
  for (int i = threadIdx.x; i < c.nz; i += THREADS) s.h[i] = in.height[i];
  for (int i = threadIdx.x; i < cells; i += THREADS)
    s.oh[i] = blend(in.oh0[i], in.oh1[i], w1, w);
  __syncthreads();
  const float dt = static_cast<float>(c.ltsample);
  const int stride = gridDim.x * THREADS;
  for (int p = blockIdx.x * THREADS + threadIdx.x; p < c.n; p += stride)
    react<SCAN>(in, c, sp, s, dt, p, mass_out);
}

Cfg make_cfg(int nz, int ny, int nx, float xlon0, float ylat0, float dx,
             float dy, int nxo, int nyo, int nzo, int itime, int t0, int t1,
             int n, int nspec, int ltsample) {
  return Cfg{nz, ny, nx, xlon0, ylat0, dx, dy, nxo, nyo, nzo,
             itime, t0, t1, n, nspec, ltsample};
}

// A grid's shared bytes and the resident blocks of the card (blocks per SM
// times SMs) of an instantiation, planned once per device, byte count and
// instantiation: the attribute and occupancy queries are host calls that
// every step of an OH run would otherwise repeat.
struct Plan {
  size_t bytes = 0;
  int per_sm = 0, sms = 0;
};

constexpr int MAX_DEVICES = 64;

template <typename K>
int plan(K kernel, int which, const Cfg& c, Plan& out) {
  static std::mutex lock;
  static Plan cache[MAX_DEVICES][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  const size_t bytes = shared_bytes(c);
  std::lock_guard<std::mutex> guard(lock);
  Plan& slot = cache[dev][which];
  if (slot.bytes == bytes) {
    out = slot;
    return 0;
  }
  int optin = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);   // a finer OH grid
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, bytes);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return static_cast<int>(err);
  slot = Plan{bytes, per_sm, sms};
  out = slot;
  return 0;
}

int plan_of(bool scan, const Cfg& c, Plan& out) {
  return scan ? plan(ohreaction_kernel<true>, 1, c, out)
              : plan(ohreaction_kernel<false>, 0, c, out);
}

// blocks of a launch over n particles: all resident ones, or fewer
int blocks_for(const Plan& pl, int n) {
  const long long need = (static_cast<long long>(n) + THREADS - 1) / THREADS;
  const long long resident = static_cast<long long>(pl.sms) * pl.per_sm;
  return static_cast<int>(need < resident ? need : resident);
}

}  // namespace

// scan: 1 where an axis of the OH grid is not finite and nondecreasing
// (the SCAN instantiation), 0 where all three are (the search)
extern "C" int fp_ohreaction(const float* x_hi, const float* x_lo,
                             const float* y_hi, const float* y_lo,
                             const float* z, const bool* active,
                             const float* mass, const float* tt,
                             const float* height, int nz, int ny, int nx,
                             float xlon0, float ylat0, float dx, float dy,
                             const float* axes, int nxo, int nyo, int nzo,
                             const float* oh0, const float* oh1, int itime,
                             int t0, int t1, const void* specs_in, int n,
                             int nspec, int ltsample, int scan,
                             float* mass_out, void* stream) {
  if (n <= 0) return 0;
  if (nspec < 1 || nspec > MAX_SPECIES || nz < 2 || ny < 1 || nx < 1 ||
      nxo < 1 || nyo < 1 || nzo < 1 || t1 == t0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cfg c = make_cfg(nz, ny, nx, xlon0, ylat0, dx, dy, nxo, nyo, nzo,
                         itime, t0, t1, n, nspec, ltsample);
  Plan pl;
  const int err = plan_of(scan != 0, c, pl);
  if (err != 0) return err;
  // the host array of OHSpec (a void pointer: the struct's type is local to
  // this file, and a C function with it in its signature is not exported)
  Specs sp{};
  const OHSpec* specs = static_cast<const OHSpec*>(specs_in);
  for (int s = 0; s < nspec; ++s) sp.s[s] = specs[s];
  const In in = {x_hi, x_lo, y_hi, y_lo, z, active, mass, tt, height, axes,
                 oh0, oh1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scan)
    ohreaction_kernel<true><<<blocks_for(pl, n), THREADS, pl.bytes, st>>>(
        in, c, sp, mass_out);
  else
    ohreaction_kernel<false><<<blocks_for(pl, n), THREADS, pl.bytes, st>>>(
        in, c, sp, mass_out);
  return static_cast<int>(cudaGetLastError());
}

// out (4,) i32: the shared bytes of a block, resident blocks per SM, the
// registers of a thread and the threads of a block, of the search's
// instantiation (scan 0) or the SCAN one (scan 1), for an OH grid of nxo x
// nyo x nzo and nz levels
extern "C" int fp_ohreaction_layout(int nxo, int nyo, int nzo, int nz,
                                    int scan, int* out) {
  const Cfg c = make_cfg(nz, 1, 1, 0.0f, 0.0f, 1.0f, 1.0f, nxo, nyo, nzo,
                         0, 0, 1, 1, 1, 0);
  Plan pl;
  int err = plan_of(scan != 0, c, pl);
  if (err != 0) return err;
  cudaFuncAttributes attr{};
  err = static_cast<int>(scan ? cudaFuncGetAttributes(
                                    &attr, ohreaction_kernel<true>)
                              : cudaFuncGetAttributes(
                                    &attr, ohreaction_kernel<false>));
  if (err != 0) return err;
  out[0] = static_cast<int>(pl.bytes);
  out[1] = pl.per_sm;
  out[2] = attr.numRegs;
  out[3] = THREADS;
  return 0;
}

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
// layer top by a scan of the axes that keeps the first of equal distances
// (a NaN distance the least, as jnp.argmin and torch.argmin); oh_avg =
// oh0 * (1 - w) + oh1 * w with w = (itime - t0) / (t1 - t0), a true
// division, clamped at 0 (a NaN passing); and for each OH-reactive species
// rate = c * T**n * exp(-d / T) * oh_avg, fac = exp(-rate * |ltsample|),
// the mass times fac, 0 below FLT_MIN.  The mass is kept where the
// particle is inactive or oh_avg <= 0.
//
// Arithmetic: the plain version's operations in its order, one rounding
// each (built with -fmad=false), with the powf and expf that torch's
// elementwise kernels call on the card, so that the two agree bit for bit.
//
// Bound on the H100: 33 B per particle at two species (positions, z,
// active, the mass in and out) and a 4 B temperature gather: 0.12 ms for
// 12 x 2**20 particles.  The scans are 125 comparisons a particle.
//
// Design: resident blocks of 1024 threads, as many as fit on the card,
// walk the particles with a grid stride; each block first copies the OH
// grid's axes, the height levels and both hourly fields (2 x 72 x 46 x 7
// floats, 185 KB: under the 227 KB a block may take) into shared memory,
// so that the scans and the field lookups never leave the SM.  An OH grid
// whose fields do not fit is refused (cudaErrorInvalidValue): FLEXPART's
// climatology and the synthetic one are both 72 x 46 x 7.  The layout
// (shared bytes, resident blocks) is planned once per device and grid and
// kept for the launches that follow.
#include <cfloat>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "at_least_zero.cuh"
#include "cell_index.cuh"

namespace {

constexpr int THREADS = 1024;
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

// argmin |axis[i] - v|: the first of equal distances, a NaN the least
__device__ __forceinline__ int nearest(const float* axis, int len, float v) {
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

size_t shared_bytes(const Cfg& c) {
  const size_t cells = static_cast<size_t>(c.nxo) * c.nyo * c.nzo;
  return sizeof(float) * (c.nxo + c.nyo + c.nzo + c.nz + 2 * cells);
}

__global__ void __launch_bounds__(THREADS, 1)
ohreaction_kernel(const In in, const Cfg c, const Specs sp,
                  float* __restrict__ mass_out) {
  extern __shared__ float sh[];
  const int naxes = c.nxo + c.nyo + c.nzo;
  const int cells = c.nxo * c.nyo * c.nzo;
  float* s_lon = sh;
  float* s_lat = s_lon + c.nxo;
  float* s_alt = s_lat + c.nyo;
  float* s_h = s_alt + c.nzo;
  float* s_oh0 = s_h + c.nz;
  float* s_oh1 = s_oh0 + cells;
  for (int i = threadIdx.x; i < naxes; i += THREADS) sh[i] = in.axes[i];
  for (int i = threadIdx.x; i < c.nz; i += THREADS) s_h[i] = in.height[i];
  for (int i = threadIdx.x; i < cells; i += THREADS) {
    s_oh0[i] = in.oh0[i];
    s_oh1[i] = in.oh1[i];
  }
  __syncthreads();
  const float w = static_cast<float>(c.itime - c.t0) /
                  static_cast<float>(c.t1 - c.t0);
  const float w1 = 1.0f - w;
  const float dt = static_cast<float>(c.ltsample);
  const long long plane = static_cast<long long>(c.ny) * c.nx;
  const int stride = gridDim.x * THREADS;
  for (int p = blockIdx.x * THREADS + threadIdx.x; p < c.n; p += stride) {
    const float x = in.x_hi[p] + in.x_lo[p];
    const float y = in.y_hi[p] + in.y_lo[p];
    const float z = in.z[p];
    const long long row = static_cast<long long>(p) * c.nspec;
    const bool active = in.active[p];

    // the cell-centre temperature (truncated column, the level below z)
    const int ix = min(max(__float2int_rz(x), 0), c.nx - 1);
    const int jy = min(max(__float2int_rz(y), 0), c.ny - 1);
    int indz;
    float dz1;
    fp::vert_weights(s_h, c.nz, z, indz, dz1);
    const float temp = in.tt[indz * plane + static_cast<long long>(jy) * c.nx
                             + ix];

    // the nearest OH cell and the hourly interpolation
    float xlon = x * c.dx + c.xlon0;
    if (xlon > 180.0f) xlon = xlon - 360.0f;
    const float ylat = y * c.dy + c.ylat0;
    const int io = nearest(s_lon, c.nxo, xlon);
    const int jo = nearest(s_lat, c.nyo, ylat);
    const int ko = nearest(s_alt, c.nzo, z);
    const int cell = (io * c.nyo + jo) * c.nzo + ko;
    const float a = s_oh0[cell] * w1;
    const float b = s_oh1[cell] * w;
    const float oh = fp::at_least_zero(a + b);
    const bool react = active && oh > 0.0f;

    for (int s = 0; s < c.nspec; ++s) {
      float m = in.mass[row + s];
      const OHSpec& k = sp.s[s];
      if (react && k.on) {
        const float rate = ((k.c * powf(temp, k.n)) * expf((-k.d) / temp))
                           * oh;
        const float fac = expf((-rate) * dt);
        const float nm = m * fac;
        m = nm > FLT_MIN ? nm : 0.0f;
      }
      mass_out[row + s] = m;
    }
  }
}

Cfg make_cfg(int nz, int ny, int nx, float xlon0, float ylat0, float dx,
             float dy, int nxo, int nyo, int nzo, int itime, int t0, int t1,
             int n, int nspec, int ltsample) {
  return Cfg{nz, ny, nx, xlon0, ylat0, dx, dy, nxo, nyo, nzo,
             itime, t0, t1, n, nspec, ltsample};
}

// A grid's shared bytes and the resident blocks of the card (blocks per SM
// times SMs), planned once per device and byte count: the attribute and
// occupancy queries are host calls that every step of an OH run would
// otherwise repeat.
struct Plan {
  size_t bytes = 0;
  int per_sm = 0, sms = 0;
};

constexpr int MAX_DEVICES = 64;

int plan(const Cfg& c, Plan& out) {
  static std::mutex lock;
  static Plan cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  const size_t bytes = shared_bytes(c);
  std::lock_guard<std::mutex> guard(lock);
  if (cache[dev].bytes == bytes) {
    out = cache[dev];
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
  err = cudaFuncSetAttribute(ohreaction_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ohreaction_kernel, THREADS, bytes);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return static_cast<int>(err);
  cache[dev] = Plan{bytes, per_sm, sms};
  out = cache[dev];
  return 0;
}

}  // namespace

extern "C" int fp_ohreaction(const float* x_hi, const float* x_lo,
                             const float* y_hi, const float* y_lo,
                             const float* z, const bool* active,
                             const float* mass, const float* tt,
                             const float* height, int nz, int ny, int nx,
                             float xlon0, float ylat0, float dx, float dy,
                             const float* axes, int nxo, int nyo, int nzo,
                             const float* oh0, const float* oh1, int itime,
                             int t0, int t1, const void* specs_in, int n,
                             int nspec, int ltsample, float* mass_out,
                             void* stream) {
  if (n <= 0) return 0;
  if (nspec < 1 || nspec > MAX_SPECIES || nz < 2 || ny < 1 || nx < 1 ||
      nxo < 1 || nyo < 1 || nzo < 1 || t1 == t0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cfg c = make_cfg(nz, ny, nx, xlon0, ylat0, dx, dy, nxo, nyo, nzo,
                         itime, t0, t1, n, nspec, ltsample);
  Plan pl;
  const int err = plan(c, pl);
  if (err != 0) return err;
  // the host array of OHSpec (a void pointer: the struct's type is local to
  // this file, and a C function with it in its signature is not exported)
  Specs sp{};
  const OHSpec* specs = static_cast<const OHSpec*>(specs_in);
  for (int s = 0; s < nspec; ++s) sp.s[s] = specs[s];
  const In in = {x_hi, x_lo, y_hi, y_lo, z, active, mass, tt, height, axes,
                 oh0, oh1};
  const long long need = (static_cast<long long>(n) + THREADS - 1) / THREADS;
  const long long resident = static_cast<long long>(pl.sms) * pl.per_sm;
  const int blocks = static_cast<int>(need < resident ? need : resident);
  ohreaction_kernel<<<blocks, THREADS, pl.bytes,
                      static_cast<cudaStream_t>(stream)>>>(in, c, sp,
                                                           mass_out);
  return static_cast<int>(cudaGetLastError());
}

// out (3,) i32: the shared bytes of a block, resident blocks per SM and the
// registers of a thread, for an OH grid of nxo x nyo x nzo and nz levels
extern "C" int fp_ohreaction_layout(int nxo, int nyo, int nzo, int nz,
                                    int* out) {
  const Cfg c = make_cfg(nz, 1, 1, 0.0f, 0.0f, 1.0f, 1.0f, nxo, nyo, nzo,
                         0, 0, 1, 1, 1, 0);
  Plan pl;
  int err = plan(c, pl);
  if (err != 0) return err;
  cudaFuncAttributes attr{};
  err = static_cast<int>(cudaFuncGetAttributes(&attr, ohreaction_kernel));
  if (err != 0) return err;
  out[0] = static_cast<int>(pl.bytes);
  out[1] = pl.per_sm;
  out[2] = attr.numRegs;
  return 0;
}

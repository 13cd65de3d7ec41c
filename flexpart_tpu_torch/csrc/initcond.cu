// K17: the initial-condition sensitivity scatter (linit_cond), the mass of
// each masked particle (divided by the air density at it for linit_cond =
// 1) spread onto the output grid by conccalc's uniform 4-point kernel.
//
// Replaces: flexpart_tpu/grid/initcond.py::make_initcond_scatter's _run
// (:49-117; initial_cond_calc.f90:44-196), which JAX leaves to XLA as a
// gather of the density at four corners and two levels, and one masked
// scatter-add of (N, 4, nspec) values.
//
// Design: one thread per particle, as K3 and K8 began; a thread whose
// particle is not in the mask (not terminated this step, or not a survivor
// at the run's end) returns at once.  For linit_cond = 1 the density is
// the bilinear value at the particle's column (the grid taken as not
// cyclic, a corner beyond the last column clamped) at the two levels
// around it, linear in height: the plain version's
// (((g0 p0 + g1 p1) + g2 p2) + g3 p3) in each level.  The output cell is
// the layer searchsorted(outheights, z, side right), and the horizontal
// kernel is conccalc's: four cells with weights wx wy, ..., or the one
// cell where the particle is within half a cell of the grid's edge.  Each
// valid (cell, species) is a float atomic; every index is checked before
// it is used and rows are int64.
//
// Arithmetic: the plain version's float32 operations in its order
// (-fmad=false); the atomics' order of addition differs from run to run,
// and the result is held against the float64 sum of the pairs.
//
// Bound on the H100: the mask of every particle, and for each masked one
// its x, y (hi and lo), z, npoint and mass (24 + 4 nspec B), the density
// at eight points (32 B) and 8 nspec B (a read and a write) per valid cell.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 64;
constexpr int MAX_MET_LEVELS = 256;
constexpr float BIG = 1073741824.0f;      // 2**30: floats clamped before a cast

struct Inputs {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const int* npoint;
  const float* mass;                      // (n, nspec)
  const bool* mask;
  const float* rho;                       // (nz, ny, nx)
};

struct Grid {
  int nz, ny, nx, by_rho;
  int nzg, nxg, nyg, npointspec, per_release;
  float dx_met, dy_met, xoutshift, youtshift, dxout, dyout;
};

// the floor of v clipped to [0, hi] (core/interp.py::_floor_index)
__device__ __forceinline__ int floor_index(float v, int hi) {
  const float f = fminf(fmaxf(floorf(v), 0.0f), static_cast<float>(hi));
  int i = static_cast<int>(f);
  return i < 0 ? 0 : (i > hi ? hi : i);
}

__device__ __forceinline__ long long floor_int(float v) {
  return static_cast<long long>(fminf(fmaxf(floorf(v), -BIG), BIG));
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(THREADS)
initcond_kernel(const Inputs in, const float* __restrict__ height_g,
                const float* __restrict__ oh_g, int n, int nspec,
                const Grid g, float* __restrict__ grid) {
  __shared__ float height[MAX_MET_LEVELS];
  __shared__ float oh[MAX_LEVELS];
  for (int i = threadIdx.x; i < g.nz; i += THREADS) height[i] = height_g[i];
  for (int i = threadIdx.x; i < g.nzg; i += THREADS) oh[i] = oh_g[i];
  __syncthreads();
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= n || !in.mask[k]) return;
  const float x = in.x_hi[k] + in.x_lo[k];
  const float y = in.y_hi[k] + in.y_lo[k];
  const float z = in.z[k];
  float rhoi = 1.0f;
  if (g.by_rho) {
    // horizontal weights (core/interp.py::horiz_weights, not cyclic)
    const int ix = floor_index(x, g.nx - 2);
    const int jy = floor_index(y, g.ny - 2);
    const float ddx = clamp01(x - static_cast<float>(ix));
    const float ddy = clamp01(y - static_cast<float>(jy));
    const float rddx = 1.0f - ddx, rddy = 1.0f - ddy;
    const float p4[4] = {rddx * rddy, ddx * rddy, rddx * ddy, ddx * ddy};
    const int ixp = ix + 1;
    const int jyp = jy + 1 > g.ny - 1 ? g.ny - 1 : jy + 1;
    const long long nyx = static_cast<long long>(g.ny) * g.nx;
    const long long c4[4] = {static_cast<long long>(jy) * g.nx + ix,
                             static_cast<long long>(jy) * g.nx + ixp,
                             static_cast<long long>(jyp) * g.nx + ix,
                             static_cast<long long>(jyp) * g.nx + ixp};
    // vertical weights (vert_weights: searchsorted side right, minus one)
    int indz = 0;
    for (int i = 0; i < g.nz; ++i) indz += height[i] <= z ? 1 : 0;
    indz -= 1;
    indz = indz < 0 ? 0 : (indz > g.nz - 2 ? g.nz - 2 : indz);
    const float h0 = height[indz], h1 = height[indz + 1];
    const float dz1 = clamp01((z - h0) / (h1 - h0));
    const float* lo = in.rho + indz * nyx;
    const float* hi = lo + nyx;
    const float rho_lo =
        ((lo[c4[0]] * p4[0] + lo[c4[1]] * p4[1]) + lo[c4[2]] * p4[2]) +
        lo[c4[3]] * p4[3];
    const float rho_hi =
        ((hi[c4[0]] * p4[0] + hi[c4[1]] * p4[1]) + hi[c4[2]] * p4[2]) +
        hi[c4[3]] * p4[3];
    rhoi = rho_lo * (1.0f - dz1) + rho_hi * dz1;
  }
  int kz = 0;
  for (int i = 0; i < g.nzg; ++i) kz += oh[i] <= z ? 1 : 0;
  if (kz >= g.nzg) return;                // above the top layer
  const float xl = (x * g.dx_met + g.xoutshift) / g.dxout;
  const float yl = (y * g.dy_met + g.youtshift) / g.dyout;
  const long long ix = floor_int(xl);
  const long long jy = floor_int(yl);
  const bool near_edge = xl < 0.5f || yl < 0.5f ||
                         xl > static_cast<float>(g.nxg - 1) - 0.5f ||
                         yl > static_cast<float>(g.nyg - 1) - 0.5f;
  const float ddx = xl - static_cast<float>(ix);
  const float ddy = yl - static_cast<float>(jy);
  const bool hi_x = ddx > 0.5f, hi_y = ddy > 0.5f;
  const long long ixp = hi_x ? ix + 1 : ix - 1;
  const long long jyp = hi_y ? jy + 1 : jy - 1;
  const float wx = hi_x ? 1.5f - ddx : 0.5f + ddx;
  const float wy = hi_y ? 1.5f - ddy : 0.5f + ddy;
  const long long cx[4] = {ix, ix, ixp, ixp};
  const long long cy[4] = {jy, jyp, jy, jyp};
  float w4[4] = {wx * wy, wx * (1.0f - wy), (1.0f - wx) * wy,
                 (1.0f - wx) * (1.0f - wy)};
  if (near_edge) {
    w4[0] = 1.0f;
    w4[1] = w4[2] = w4[3] = 0.0f;
  }
  const long long kp = g.per_release ? in.npoint[k] : 0;
  const long long cell = kp * g.nzg + kz;
  const long long nyxg = static_cast<long long>(g.nyg) * g.nxg;
  const float* m = in.mass + static_cast<long long>(k) * nspec;
  for (int c = 0; c < 4; ++c) {
    if (!(w4[c] > 0.0f) || cx[c] < 0 || cx[c] >= g.nxg || cy[c] < 0 ||
        cy[c] >= g.nyg)
      continue;
    const float wr = w4[c] / rhoi;
    float* dst = grid + (cell * nyxg + cy[c] * g.nxg + cx[c]) * nspec;
    for (int s = 0; s < nspec; ++s) atomicAdd(dst + s, wr * m[s]);
  }
}

}  // namespace

// particles: x_hi, x_lo, y_hi, y_lo, z (n,) f32, npoint (n,) i32, mass
// (n, nspec) f32, mask (n,) bool; rho (nz, ny, nx) and height (nz,) f32 of
// the newer met time; by_rho: 1 for linit_cond = 1; outheight (nzg,) f32;
// grid (npointspec, nzg, nyg, nxg, nspec) f32, accumulated into
extern "C" int fp_initcond(const float* x_hi, const float* x_lo,
                           const float* y_hi, const float* y_lo,
                           const float* z, const int* npoint,
                           const float* mass, const bool* mask,
                           const float* rho, const float* height, int nz,
                           int ny, int nx, int by_rho,
                           const float* outheight, int nzg, int n, int nspec,
                           int nxg, int nyg, int npointspec, int per_release,
                           float dx_met, float dy_met, float xoutshift,
                           float youtshift, float dxout, float dyout,
                           float* grid, void* stream) {
  if (n <= 0) return 0;
  if (nz < 2 || nz > MAX_MET_LEVELS || ny < 2 || nx < 2 || nzg < 1 ||
      nzg > MAX_LEVELS || nspec < 1 || nxg < 1 || nyg < 1 ||
      npointspec < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in = {x_hi, x_lo, y_hi, y_lo, z, npoint, mass, mask, rho};
  const Grid g = {nz, ny, nx, by_rho, nzg, nxg, nyg, npointspec,
                  per_release, dx_met, dy_met, xoutshift, youtshift, dxout,
                  dyout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  initcond_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      in, height, outheight, n, nspec, g, grid);
  return static_cast<int>(cudaGetLastError());
}

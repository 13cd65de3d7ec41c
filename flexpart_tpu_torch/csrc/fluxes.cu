// K16: gross mass fluxes through the output cells' faces (iflux = 1), the
// mass of each live particle added to every east/west/north/south/up/down
// face it crossed in the step.
//
// Replaces: flexpart_tpu/grid/fluxes.py::make_calcfluxes (:46-134;
// calcfluxes.f90:40-169), which JAX leaves to XLA as 36 masked
// scatter-adds (six directions x MAX_SPAN candidate faces), each over every
// particle.
//
// Design: one thread per particle, as K3 and K8 began.  A live particle
// (active, itra == itime) finds its cell from the mean of its old and new
// position (the horizontal output cell) and its new height (the layer),
// then walks the candidate faces of each direction: up k1 .. k2 - 1 and
// down k2 .. k1 - 1 between the half levels of its old and new height,
// east ix1 .. ix2 - 1 and west ix2 .. ix1 - 1 (no crossing where it wrapped
// round the globe), north jy1 .. jy2 - 1 and south jy2 .. jy1 - 1, at most
// MAX_SPAN = 6 each; every crossing on the grid adds mass[k] to
// flux[face][age][kp][kz][jy][ix][k] by a float atomic.  Every index is
// checked before it is used (JAX drops its 2**30 sentinel; here a row
// outside the grid is never formed) and rows are int64.
//
// Arithmetic: the plain version's float32 operations in its order
// (-fmad=false), so both find the same faces; only the atomics' order of
// addition differs from run to run, and the result is held against the
// float64 sum of the pairs.
//
// Bound on the H100: x, y (hi and lo), z, the old x, y, z, itra, itramem,
// npoint, active and mass of every particle (45 + 4 nspec B), plus 8 nspec B
// (a read and a write) per crossing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SPAN = 6;               // grid/fluxes.py MAX_SPAN
constexpr int MAX_LEVELS = 64;
constexpr int MAX_AGES = 64;
constexpr float BIG = 1073741824.0f;      // 2**30: floats clamped before a cast

struct Inputs {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z, *xold, *yold, *zold;
  const int *itra, *itramem, *npoint;
  const bool* active;
  const float* mass;                      // (n, nspec)
};

struct Grid {
  int nage, nzg, nxg, nyg, npointspec, per_release;
  float dx_met, dy_met, xoutshift, youtshift, dxout, dyout, half_nx;
};

__device__ __forceinline__ long long floor_int(float v) {
  return static_cast<long long>(fminf(fmaxf(floorf(v), -BIG), BIG));
}

// the count of table entries <= v (searchsorted, side right)
template <typename T>
__device__ __forceinline__ int count_le(const T* t, int len, T v) {
  int k = 0;
  for (int i = 0; i < len; ++i) k += t[i] <= v ? 1 : 0;
  return k;
}

__device__ __forceinline__ void add_mass(float* flux, long long row,
                                         const float* m, int nspec) {
  float* dst = flux + row * nspec;
  for (int s = 0; s < nspec; ++s) atomicAdd(dst + s, m[s]);
}

__global__ void __launch_bounds__(THREADS)
fluxes_kernel(const Inputs in, const int* __restrict__ lage_g,
              const float* __restrict__ oh_g,
              const float* __restrict__ ohhalf_g, int n, int nspec,
              const Grid g, int itime, float* __restrict__ flux) {
  __shared__ int lage[MAX_AGES];
  __shared__ float oh[MAX_LEVELS], ohhalf[MAX_LEVELS + 1];
  for (int i = threadIdx.x; i < g.nage; i += THREADS) lage[i] = lage_g[i];
  for (int i = threadIdx.x; i < g.nzg; i += THREADS) oh[i] = oh_g[i];
  for (int i = threadIdx.x; i <= g.nzg; i += THREADS) ohhalf[i] = ohhalf_g[i];
  __syncthreads();
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= n) return;
  const int itra = in.itra[k];
  if (!in.active[k] || itra != itime) return;
  const float x = in.x_hi[k] + in.x_lo[k];
  const float y = in.y_hi[k] + in.y_lo[k];
  const float z = in.z[k];
  const float xold = in.xold[k], yold = in.yold[k], zold = in.zold[k];
  const int d = itime - in.itramem[k];
  const int itage = d < 0 ? -d : d;
  int nage_idx = count_le(lage, g.nage, itage);
  nage_idx = nage_idx > g.nage - 1 ? g.nage - 1 : nage_idx;
  const long long kp = g.per_release ? in.npoint[k] : 0;
  const float xmean = 0.5f * (xold + x);
  const float ymean = 0.5f * (yold + y);
  const long long ixave = floor_int((xmean * g.dx_met + g.xoutshift) / g.dxout);
  const long long jyave = floor_int((ymean * g.dy_met + g.youtshift) / g.dyout);
  int kzave = count_le(oh, g.nzg, z);
  kzave = kzave > g.nzg - 1 ? g.nzg - 1 : kzave;
  const bool in_x = ixave >= 0 && ixave < g.nxg;
  const bool in_y = jyave >= 0 && jyave < g.nyg;
  const long long base_cell =
      (static_cast<long long>(nage_idx) * g.npointspec + kp) * g.nzg;
  const long long nyx = static_cast<long long>(g.nyg) * g.nxg;
  const long long rows = static_cast<long long>(g.nage) * g.npointspec *
                         g.nzg * nyx;
  const float* m = in.mass + static_cast<long long>(k) * nspec;

  // vertical faces (4 up, 5 down)
  if (in_x && in_y) {
    int k1 = count_le(ohhalf, g.nzg + 1, zold);
    int k2 = count_le(ohhalf, g.nzg + 1, z);
    k1 = k1 > g.nzg ? g.nzg : k1;
    k2 = k2 > g.nzg ? g.nzg : k2;
    const long long col = jyave * g.nxg + ixave;
    for (int s = 0; s < MAX_SPAN; ++s) {
      const int kz_u = k1 - 1 + s;
      if (kz_u <= k2 - 2 && kz_u >= 0 && kz_u < g.nzg)
        add_mass(flux, 4 * rows + (base_cell + kz_u) * nyx + col, m, nspec);
      const int kz_d = k2 - 1 + s;
      if (kz_d <= k1 - 2 && kz_d >= 0 && kz_d < g.nzg)
        add_mass(flux, 5 * rows + (base_cell + kz_d) * nyx + col, m, nspec);
    }
  }
  // east/west faces (0 E, 1 W)
  if (in_y && fabsf(xold - x) < g.half_nx) {
    const long long ix1 =
        floor_int((xold * g.dx_met + g.xoutshift) / g.dxout + 0.5f);
    const long long ix2 =
        floor_int((x * g.dx_met + g.xoutshift) / g.dxout + 0.5f);
    const long long row = (base_cell + kzave) * nyx + jyave * g.nxg;
    for (int s = 0; s < MAX_SPAN; ++s) {
      const long long ix_e = ix1 + s;
      if (ix_e <= ix2 - 1 && ix_e >= 0 && ix_e < g.nxg)
        add_mass(flux, row + ix_e, m, nspec);
      const long long ix_w = ix2 + s;
      if (ix_w <= ix1 - 1 && ix_w >= 0 && ix_w < g.nxg)
        add_mass(flux, rows + row + ix_w, m, nspec);
    }
  }
  // north/south faces (2 N, 3 S)
  if (in_x) {
    const long long jy1 =
        floor_int((yold * g.dy_met + g.youtshift) / g.dyout + 0.5f);
    const long long jy2 =
        floor_int((y * g.dy_met + g.youtshift) / g.dyout + 0.5f);
    const long long row = (base_cell + kzave) * nyx + ixave;
    for (int s = 0; s < MAX_SPAN; ++s) {
      const long long jy_n = jy1 + s;
      if (jy_n <= jy2 - 1 && jy_n >= 0 && jy_n < g.nyg)
        add_mass(flux, 2 * rows + row + jy_n * g.nxg, m, nspec);
      const long long jy_s = jy2 + s;
      if (jy_s <= jy1 - 1 && jy_s >= 0 && jy_s < g.nyg)
        add_mass(flux, 3 * rows + row + jy_s * g.nxg, m, nspec);
    }
  }
}

}  // namespace

// particles: x_hi, x_lo, y_hi, y_lo, z, xold, yold, zold (n,) f32, itra,
// itramem, npoint (n,) i32, active (n,) bool, mass (n, nspec) f32; lage
// (nage,) i32, outheight (nzg,) and its half levels (nzg + 1,) f32; flux
// (6, nage, npointspec, nzg, nyg, nxg, nspec) f32, accumulated into
extern "C" int fp_fluxes(const float* x_hi, const float* x_lo,
                         const float* y_hi, const float* y_lo,
                         const float* z, const float* xold,
                         const float* yold, const float* zold,
                         const int* itra, const int* itramem,
                         const int* npoint, const bool* active,
                         const float* mass, const int* lage, int nage,
                         const float* outheight, const float* ohhalf,
                         int nzg, int n, int nspec, int nxg, int nyg,
                         int npointspec, int per_release, float dx_met,
                         float dy_met, float xoutshift, float youtshift,
                         float dxout, float dyout, float half_nx, int itime,
                         float* flux, void* stream) {
  if (n <= 0) return 0;
  if (nage < 1 || nage > MAX_AGES || nzg < 1 || nzg > MAX_LEVELS ||
      nspec < 1 || nxg < 1 || nyg < 1 || npointspec < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in = {x_hi, x_lo, y_hi, y_lo, z, xold, yold, zold, itra,
                     itramem, npoint, active, mass};
  const Grid g = {nage, nzg, nxg, nyg, npointspec, per_release, dx_met,
                  dy_met, xoutshift, youtshift, dxout, dyout, half_nx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fluxes_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      in, lage, outheight, ohhalf, n, nspec, g, itime, flux);
  return static_cast<int>(cudaGetLastError());
}

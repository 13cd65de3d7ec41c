// K16: gross mass fluxes through the output cells' faces (iflux = 1), the
// mass of each live particle added to every east/west/north/south/up/down
// face it crossed in the step.
//
// Replaces: flexpart_tpu/grid/fluxes.py::make_calcfluxes (:46-134;
// calcfluxes.f90:40-169), which JAX leaves to XLA as 36 masked
// scatter-adds (six directions x MAX_SPAN candidate faces), each over every
// particle.
//
// Design: one thread per particle.  A live particle (active, itra ==
// itime) finds its cell from the mean of its old and new position (the
// horizontal output cell) and its new height (the layer), then the
// candidate faces of each direction: up k1 .. k2 - 1 and down k2 .. k1 - 1
// between the half levels of its old and new height, east ix1 .. ix2 - 1
// and west ix2 .. ix1 - 1 (no crossing where it wrapped round the globe),
// north jy1 .. jy2 - 1 and south jy2 .. jy1 - 1, the s-th candidate
// (s < MAX_SPAN = 6) a crossing where its face lies on the grid; each
// crossing adds mass[k] to flux[face][age][kp][kz][jy][ix][k].  Every
// index is checked before it is used (JAX drops its 2**30 sentinel; here
// a row outside the grid is never formed).
//
// What held the first K16 back: one float atomic per crossing and species.
// The particles are in cell order and the output cells are as coarse as
// the met's, so the lanes of a warp name the same few rows and their
// atomics queued on one address.  Now a lane lists its crossings (a
// particle crosses one way on each axis: up or down, east or west, north
// or south) and the warp takes them in rounds, as many as the most that
// one lane has (__reduce_max_sync): in round j the lanes with a j-th
// crossing find the others of its row (__match_any_sync on the 32-bit row,
// warp_groups.cuh, as K8 and K17 do), each group's sums reach its first
// lane by pointer jumping, and that lane sends one atomic per species, a
// float2 where the species come in aligned pairs; a sum that is exactly 0
// is not sent.  A thread loads every field of its slot at once, and a warp
// with no live lane ends there.  The row is matched on 32 bits, so the
// flux array has at most MAX_ROWS rows (a larger one is refused), and rows
// are 32-bit arithmetic.
//
// Arithmetic: the plain version's float32 operations in its order
// (-fmad=false), so both find the same faces; the sums' order of addition
// differs from the plain version's and from run to run, and the result is
// held against the float64 sum of the pairs.
//
// Bound on the H100: x, y (hi and lo), z, the old x, y, z, itra, itramem,
// npoint, active and mass of every particle (45 + 4 nspec B), plus each
// flux row that the crossings hit read and written once (8 nspec B).
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_groups.cuh"

namespace {

// the warp groups (FULL, EMPTY, MAX_ROWS, group_sums, send)
using namespace fp;

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
  int step;              // species per atomic: 2 where nspec is even and
                         // the flux 8-byte aligned, else 1
};

// floor(v) clamped to +-2**30, as the plain version's floor before its cast
__device__ __forceinline__ int floor_int(float v) {
  return static_cast<int>(fminf(fmaxf(floorf(v), -BIG), BIG));
}

// the count of table entries <= v (searchsorted, side right)
template <typename T>
__device__ __forceinline__ int count_le(const T* t, int len, T v) {
  int k = 0;
  for (int i = 0; i < len; ++i) k += t[i] <= v ? 1 : 0;
  return k;
}

// One axis's crossings of a particle: candidate s crosses face i0 + s,
// where s < MAX_SPAN, i0 + s <= last and 0 <= i0 + s < ext; ``count`` of
// them (none where !ok), the j-th in row first + j * stride (face f lies
// in row base + f * stride; 32-bit: every row of the flux array lies below
// MAX_ROWS, so the arithmetic modulo 2**32 gives it exactly).
struct Crossings {
  unsigned first;
  int count;
};

__device__ __forceinline__ Crossings crossings_of(bool ok, unsigned base,
                                                  int i0, unsigned stride,
                                                  int last, int ext) {
  const long long b = i0 < 0 ? -static_cast<long long>(i0) : 0;
  long long e = static_cast<long long>(last) - i0 + 1;
  e = e < static_cast<long long>(ext) - i0 ? e
                                            : static_cast<long long>(ext) - i0;
  e = e < MAX_SPAN ? e : MAX_SPAN;
  const bool any = ok && b < e;
  return Crossings{
      base + static_cast<unsigned>(i0 + static_cast<int>(any ? b : 0)) *
                 stride,
      any ? static_cast<int>(e - b) : 0};
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
  const unsigned lane = threadIdx.x & 31u;
  // every field of the slot at once (a dead slot's too): one round of
  // loads, where a chain of active, itra and the rest held the first K16
  bool live = false;
  float x = 0.0f, y = 0.0f, z = 0.0f, xold = 0.0f, yold = 0.0f, zold = 0.0f;
  int itramem = 0, npoint = 0;
  if (k < n) {
    const bool active = in.active[k];
    const int itra = in.itra[k];
    x = in.x_hi[k] + in.x_lo[k];
    y = in.y_hi[k] + in.y_lo[k];
    z = in.z[k];
    xold = in.xold[k];
    yold = in.yold[k];
    zold = in.zold[k];
    itramem = in.itramem[k];
    npoint = g.per_release ? in.npoint[k] : 0;
    live = active && itra == itime;
  }
  if (!__any_sync(FULL, live)) return;

  // the cell of the mean position, the layer of the new height; a lane
  // that is not live crosses nothing
  const int d = itime - itramem;
  const int itage = d < 0 ? -d : d;
  int nage_idx = count_le(lage, g.nage, itage);
  nage_idx = nage_idx > g.nage - 1 ? g.nage - 1 : nage_idx;
  const float xmean = 0.5f * (xold + x);
  const float ymean = 0.5f * (yold + y);
  const int ixave = floor_int((xmean * g.dx_met + g.xoutshift) / g.dxout);
  const int jyave = floor_int((ymean * g.dy_met + g.youtshift) / g.dyout);
  int kzave = count_le(oh, g.nzg, z);
  kzave = kzave > g.nzg - 1 ? g.nzg - 1 : kzave;
  const bool in_x = live && ixave >= 0 && ixave < g.nxg;
  const bool in_y = live && jyave >= 0 && jyave < g.nyg;
  const unsigned nxg = static_cast<unsigned>(g.nxg);
  const unsigned nyx = static_cast<unsigned>(g.nyg) * nxg;
  const unsigned rows = static_cast<unsigned>(g.nage) * g.npointspec *
                        g.nzg * nyx;
  const unsigned base_cell =
      (static_cast<unsigned>(nage_idx) * g.npointspec + npoint) * g.nzg;
  const unsigned col = static_cast<unsigned>(jyave) * nxg + ixave;

  // a particle crosses one way on each axis: up k1 - 1 .. k2 - 2 (face 4)
  // or down k2 - 1 .. k1 - 2 (5), east ix1 .. ix2 - 1 (0) or west ix2 ..
  // ix1 - 1 (1), north jy1 .. jy2 - 1 (2) or south jy2 .. jy1 - 1 (3)
  int k1 = count_le(ohhalf, g.nzg + 1, zold);
  int k2 = count_le(ohhalf, g.nzg + 1, z);
  k1 = k1 > g.nzg ? g.nzg : k1;
  k2 = k2 > g.nzg ? g.nzg : k2;
  const bool up = k1 <= k2;
  const Crossings cz = crossings_of(
      in_x && in_y, (up ? 4u : 5u) * rows + base_cell * nyx + col,
      up ? k1 - 1 : k2 - 1, nyx, up ? k2 - 2 : k1 - 2, g.nzg);
  const int ix1 = floor_int((xold * g.dx_met + g.xoutshift) / g.dxout + 0.5f);
  const int ix2 = floor_int((x * g.dx_met + g.xoutshift) / g.dxout + 0.5f);
  const bool east = ix1 <= ix2;
  const Crossings cx = crossings_of(
      in_y && fabsf(xold - x) < g.half_nx,
      (east ? 0u : rows) + (base_cell + kzave) * nyx +
          static_cast<unsigned>(jyave) * nxg,
      east ? ix1 : ix2, 1u, east ? ix2 - 1 : ix1 - 1, g.nxg);
  const int jy1 = floor_int((yold * g.dy_met + g.youtshift) / g.dyout + 0.5f);
  const int jy2 = floor_int((y * g.dy_met + g.youtshift) / g.dyout + 0.5f);
  const bool north = jy1 <= jy2;
  const Crossings cy = crossings_of(
      in_x, (north ? 2u : 3u) * rows + (base_cell + kzave) * nyx + ixave,
      north ? jy1 : jy2, nxg, north ? jy2 - 1 : jy1 - 1, g.nyg);

  // the lane's crossings in turn, the vertical ones first: round j takes
  // each lane's j-th, the lanes of one row grouped (__match_any_sync on
  // the 32-bit row), each group's sums sent by its first lane.  Every lane
  // goes through every round: the match and the shuffles take all 32
  const float* m = in.mass + static_cast<long long>(live ? k : 0) * nspec;
  const int total = cz.count + cx.count + cy.count;
  const int rounds =
      static_cast<int>(__reduce_max_sync(FULL, static_cast<unsigned>(total)));
#pragma unroll 1
  for (int j = 0; j < rounds; ++j) {
    const bool valid = j < total;
    const int jx = j - cz.count, jy = jx - cx.count;
    const unsigned row = jx < 0 ? cz.first + static_cast<unsigned>(j) * nyx
                       : jy < 0 ? cx.first + static_cast<unsigned>(jx)
                                : cy.first + static_cast<unsigned>(jy) * nxg;
    const unsigned peers = __match_any_sync(FULL, valid ? row : EMPTY);
    const int most = __reduce_max_sync(FULL, valid ? __popc(peers) : 0);
    const bool leader =
        valid && lane == static_cast<unsigned>(__ffs(peers) - 1);
    float* dst = flux + static_cast<long long>(row) * nspec;
    if (g.step == 1) {
      for (int q = 0; q < nspec; ++q) {
        float a = valid ? m[q] : 0.0f;
        group_sums(peers, most, lane, a);
        if (leader && a != 0.0f) atomicAdd(dst + q, a);
      }
    } else {
      for (int q = 0; q < nspec; q += 2) {
        float a = valid ? m[q] : 0.0f;
        float b = valid ? m[q + 1] : 0.0f;
        group_sums(peers, most, lane, a, b);
        if (leader) send(dst + q, 2, a, b);
      }
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
      nspec < 1 || nxg < 1 || nyg < 1 || npointspec < 1 ||
      6ll * nage * npointspec * nzg * nyg * nxg > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in = {x_hi, x_lo, y_hi, y_lo, z, xold, yold, zold, itra,
                     itramem, npoint, active, mass};
  const Grid g = {nage, nzg, nxg, nyg, npointspec, per_release, dx_met,
                  dy_met, xoutshift, youtshift, dxout, dyout, half_nx,
                  nspec % 2 == 0 && reinterpret_cast<uintptr_t>(flux) % 8 == 0
                      ? 2 : 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fluxes_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      in, lage, outheight, ohhalf, n, nspec, g, itime, flux);
  return static_cast<int>(cudaGetLastError());
}

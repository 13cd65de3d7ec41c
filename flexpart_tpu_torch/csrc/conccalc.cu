// K3: concentration sampling, the scatter-add of particle mass onto gridunc.
//
// Replaces: flexpart_tpu/grid/conccalc.py::_conccalc_impl (conccalc.f90),
// which JAX leaves to XLA as one `.at[].add(mode="drop")`.  For each live
// particle (active and itra == itime) the thread computes its age class,
// output layer (first outheight above z), output cell and either one
// weight (kernel_possible == 0, or a young / near-edge particle) or the
// four uniform-kernel weights (conccalc.f90:171-260), and atomically adds
// weight * mass / rho * sample_weight for every species into the flat
// gridunc (rows = (nage, nclass, kp, nzg, nyg, nxg), species innermost).
// An index that falls outside the output grid or the accumulator is
// skipped, the kernel's form of JAX's mode="drop" with the 2**30 sentinel.
//
// Bound on the H100: the float atomics into gridunc (~10.5M particles x
// 1-4 cells per step on a 720x360x3 grid that stays in L2); the per-
// particle reads (~48 bytes) are coalesced SoA loads.  Design: one thread
// per particle, no staging; the atomics make the sum order vary from run
// to run, so the kernel agrees with the plain twin to a relative
// tolerance, not bitwise.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Cfg {
  int n, nspec, nxg, nyg, npointspec, nclassunc, nage, nzg;
  float dx_met, dy_met, xoutshift, youtshift, dxout, dyout;
  int itime;
  float weight;
  int kernel_possible, use_kernel, ioutputforeachrelease;
  long long rows;
};

__device__ __forceinline__ void add_cell(float* __restrict__ grid, const Cfg& c,
                                         long long cell, int cx, int cy, float w,
                                         const float* __restrict__ mass,
                                         long long p, float rho) {
  if (cx < 0 || cx >= c.nxg || cy < 0 || cy >= c.nyg || !(w > 0.0f)) return;
  const long long lin = cell * c.nyg * c.nxg + static_cast<long long>(cy) * c.nxg + cx;
  if (lin < 0 || lin >= c.rows) return;
  for (int s = 0; s < c.nspec; ++s) {
    // the two JAX paths round differently: mass / rho on the single-index
    // path, (w / rho) * mass on the kernel path
    const float m = mass[p * c.nspec + s];
    const float contrib = c.kernel_possible ? (w / rho) * m : m / rho;
    atomicAdd(grid + lin * c.nspec + s, contrib * c.weight);
  }
}

__global__ void conccalc_kernel(const float* __restrict__ x_hi,
                                const float* __restrict__ x_lo,
                                const float* __restrict__ y_hi,
                                const float* __restrict__ y_lo,
                                const float* __restrict__ zpos,
                                const int* __restrict__ itra,
                                const int* __restrict__ itramem,
                                const int* __restrict__ npoint,
                                const int* __restrict__ nclass,
                                const bool* __restrict__ active,
                                const float* __restrict__ mass,
                                const float* __restrict__ rhoi,
                                const int* __restrict__ lage,
                                const float* __restrict__ outheight, Cfg c,
                                float* __restrict__ grid) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= c.n) return;
  if (!active[p] || itra[p] != c.itime) return;
  const float x = x_hi[p] + x_lo[p];
  const float y = y_hi[p] + y_lo[p];
  const float z = zpos[p];
  if (z != z) return;  // NaN height: no output layer (as the twin's search)
  const int it = itra[p] - itramem[p];
  const int itage = it < 0 ? -it : it;
  // age class: searchsorted(lage, itage, side="right"), clipped
  int na = 0;
  for (int a = 0; a < c.nage; ++a) na += (lage[a] <= itage) ? 1 : 0;
  na = na > c.nage - 1 ? c.nage - 1 : na;
  // output layer: searchsorted(outheight, z, side="right")
  int kz = 0;
  for (int k = 0; k < c.nzg; ++k) kz += (outheight[k] <= z) ? 1 : 0;
  if (kz >= c.nzg) return;  // above the top output level
  const float rho = rhoi ? rhoi[p] : 1.0f;

  const float xl = (x * c.dx_met + c.xoutshift) / c.dxout;
  const float yl = (y * c.dy_met + c.youtshift) / c.dyout;
  const float fx = floorf(xl);
  const float fy = floorf(yl);
  // out-of-range floats never land in the grid; keep the int cast defined
  if (!(fx > -2.0f && fx < static_cast<float>(c.nxg) + 1.0f &&
        fy > -2.0f && fy < static_cast<float>(c.nyg) + 1.0f)) return;
  const int ix = static_cast<int>(fx);
  const int jy = static_cast<int>(fy);
  const int kp = c.ioutputforeachrelease ? npoint[p] : 0;
  const long long cell =
      ((static_cast<long long>(na) * c.nclassunc + nclass[p]) * c.npointspec + kp) *
          c.nzg + kz;

  if (!c.kernel_possible) {
    add_cell(grid, c, cell, ix, jy, 1.0f, mass, p, rho);
    return;
  }
  const bool near_edge = (xl < 0.5f) || (yl < 0.5f) ||
                         (xl > static_cast<float>(c.nxg - 1) - 0.5f) ||
                         (yl > static_cast<float>(c.nyg - 1) - 0.5f);
  const bool direct = !c.use_kernel || itage < 10800 || near_edge;
  if (direct) {
    add_cell(grid, c, cell, ix, jy, 1.0f, mass, p, rho);
    return;
  }
  // uniform-kernel weights (conccalc.f90:203-220)
  const float ddx = xl - static_cast<float>(ix);
  const float ddy = yl - static_cast<float>(jy);
  const int ixp = ddx > 0.5f ? ix + 1 : ix - 1;
  const int jyp = ddy > 0.5f ? jy + 1 : jy - 1;
  const float wx = ddx > 0.5f ? 1.5f - ddx : 0.5f + ddx;
  const float wy = ddy > 0.5f ? 1.5f - ddy : 0.5f + ddy;
  add_cell(grid, c, cell, ix, jy, wx * wy, mass, p, rho);
  add_cell(grid, c, cell, ix, jyp, wx * (1.0f - wy), mass, p, rho);
  add_cell(grid, c, cell, ixp, jy, (1.0f - wx) * wy, mass, p, rho);
  add_cell(grid, c, cell, ixp, jyp, (1.0f - wx) * (1.0f - wy), mass, p, rho);
}

}  // namespace

extern "C" int fp_conccalc(const float* x_hi, const float* x_lo,
                           const float* y_hi, const float* y_lo,
                           const float* z, const int* itra,
                           const int* itramem, const int* npoint,
                           const int* nclass, const bool* active,
                           const float* mass, const float* rhoi,
                           const int* lage, int nage, const float* outheight,
                           int nzg, int n, int nspec, int nxg, int nyg,
                           int npointspec, int nclassunc, float dx_met,
                           float dy_met, float xoutshift, float youtshift,
                           float dxout, float dyout, int itime, float weight,
                           int kernel_possible, int use_kernel,
                           int ioutputforeachrelease, long long rows,
                           float* gridunc, void* stream) {
  if (n <= 0) return 0;
  Cfg c{n, nspec, nxg, nyg, npointspec, nclassunc, nage, nzg,
        dx_met, dy_met, xoutshift, youtshift, dxout, dyout,
        itime, weight, kernel_possible, use_kernel, ioutputforeachrelease, rows};
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  conccalc_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x_hi, x_lo, y_hi, y_lo, z, itra, itramem, npoint, nclass, active, mass,
      rhoi, lage, outheight, c, gridunc);
  return static_cast<int>(cudaGetLastError());
}

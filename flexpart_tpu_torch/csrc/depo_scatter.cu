// K8: the deposit scatter, the 4-point uniform-kernel scatter-add of a
// per-particle deposit onto the 2-D wet or dry deposition grid.
//
// Replaces: flexpart_tpu/physics/wetdepo.py::make_depokernel(..).scatter
// (wetdepokernel.f90, drydepokernel.f90), which JAX leaves to XLA as one
// `.at[].add(mode="drop")`, with the age class of
// flexpart_tpu/run/simulation.py::_scatter_depo.  For each active particle
// the thread computes its age class at `itime` (searchsorted(lage,
// |itime - itramem|, side="right"), clipped), its release index, its output
// cell and the four uniform-kernel weights, and adds weight * deposit for
// every species into the flat grid (rows = (nage, nclass, kp, nyg, nxg),
// species innermost).  The corners come in the reference's order (ix, jy),
// (ixp, jyp), (ixp, jy), (ix, jyp).  A pair counts where the particle is
// active and the corner lies in the grid: unlike the sampling (K3) there
// is no weight test, no itra test, no layer and no single-index path.
//
// Bound on the H100: 37 B of particle state and deposit per particle at two
// species, coalesced (0.12 ms for 10.5M particles); what costs more is the
// float atomics into the grid, four per particle and species.
//
// Design: K3's.  One thread per particle; for each of its four corners a
// lane finds the lanes of its warp that name the same grid row
// (__match_any_sync on the 32-bit row), the first lane of the group sums
// the group's values in lane order through shuffles and sends one global
// atomic per species.  Particles kept in cell order (reorder.cu) make few
// groups per warp.  No table in shared memory: this card has no float add
// there (PERF.md, section 6).  The row is matched on 32 bits, so the grid may
// have at most MAX_ROWS rows; a larger one is refused.  The sums are ordered
// by the atomics, differently in every run: the kernel agrees with the
// float64 sum of its pairs to a relative tolerance, not bitwise.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
// a lane without a pair matches on ~lane, the 32 largest values
constexpr long long MAX_ROWS = 0xFFFFFFFFll - 32;

struct Cfg {
  int n, nspec, nxg, nyg, npointspec, nclassunc, nage;
  float dx_met, dy_met, xoutshift, youtshift, dxout, dyout;
  int itime, ioutputforeachrelease;
  long long rows;
};

struct PIn {
  const float *x_hi, *x_lo, *y_hi, *y_lo;
  const int *itramem, *npoint, *nclass;
  const bool* active;
  const float* deposit;   // (nspec, n)
  const int* lage;
};

// The sum of v over the lanes of `peers`, in lane order, on the group's
// first lane (other lanes: a partial sum).  `most` is the size of the
// warp's largest group.  All 32 lanes call.
__device__ __forceinline__ float group_sum(unsigned peers, int most, float v,
                                           unsigned lane) {
  unsigned rest = peers & (peers - 1);        // the group without its first lane
  float sum = v;
  for (int k = 1; k < most; ++k) {
    const float other = __shfl_sync(FULL, v, rest ? __ffs(rest) - 1 : lane);
    if (rest) sum += other;
    rest &= rest - 1;
  }
  return sum;
}

__global__ void __launch_bounds__(THREADS)
depo_grid_kernel(const PIn in, const Cfg c, float* __restrict__ grid) {
  const long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  int cx[4] = {0, 0, 0, 0}, cy[4] = {0, 0, 0, 0};
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  long long cell = 0;
  bool live = p < c.n && in.active[p];
  if (live) {
    const float x = in.x_hi[p] + in.x_lo[p];
    const float y = in.y_hi[p] + in.y_lo[p];
    const float xl = (x * c.dx_met + c.xoutshift) / c.dxout;
    const float yl = (y * c.dy_met + c.youtshift) / c.dyout;
    const float fx = floorf(xl);
    const float fy = floorf(yl);
    // no corner of a particle this far out lies in the grid (a NaN neither);
    // the int cast stays defined
    live = fx > -2.0f && fx < static_cast<float>(c.nxg) + 1.0f &&
           fy > -2.0f && fy < static_cast<float>(c.nyg) + 1.0f;
    if (live) {
      const int ix = static_cast<int>(fx);
      const int jy = static_cast<int>(fy);
      const int it = c.itime - in.itramem[p];
      const int itage = it < 0 ? -it : it;
      int na = 0;
      for (int a = 0; a < c.nage; ++a) na += (in.lage[a] <= itage) ? 1 : 0;
      na = na > c.nage - 1 ? c.nage - 1 : na;
      const int kp = c.ioutputforeachrelease ? in.npoint[p] : 0;
      cell = (static_cast<long long>(na) * c.nclassunc + in.nclass[p]) *
                 c.npointspec + kp;
      const float ddx = xl - static_cast<float>(ix);
      const float ddy = yl - static_cast<float>(jy);
      const int ixp = ddx > 0.5f ? ix + 1 : ix - 1;
      const int jyp = ddy > 0.5f ? jy + 1 : jy - 1;
      const float wx = ddx > 0.5f ? 1.5f - ddx : 0.5f + ddx;
      const float wy = ddy > 0.5f ? 1.5f - ddy : 0.5f + ddy;
      cx[0] = ix;  cy[0] = jy;  w[0] = wx * wy;
      cx[1] = ixp; cy[1] = jyp; w[1] = (1.0f - wx) * (1.0f - wy);
      cx[2] = ixp; cy[2] = jy;  w[2] = (1.0f - wx) * wy;
      cx[3] = ix;  cy[3] = jyp; w[3] = wx * (1.0f - wy);
    }
  }

  // every lane of the warp goes through every corner: the match and the
  // shuffles take all 32
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long lin =
        cell * c.nyg * c.nxg + static_cast<long long>(cy[j]) * c.nxg + cx[j];
    const bool valid = live && cx[j] >= 0 && cx[j] < c.nxg && cy[j] >= 0 &&
                       cy[j] < c.nyg && lin >= 0 && lin < c.rows;
    const unsigned peers =
        __match_any_sync(FULL, valid ? static_cast<unsigned>(lin) : ~lane);
    const int most = __reduce_max_sync(FULL, __popc(peers));
    const bool first = lane == static_cast<unsigned>(__ffs(peers) - 1);
    for (int s = 0; s < c.nspec; ++s) {
      const float contrib =
          valid ? w[j] * in.deposit[static_cast<long long>(s) * c.n + p] : 0.0f;
      const float sum = group_sum(peers, most, contrib, lane);
      if (valid && first) atomicAdd(grid + lin * c.nspec + s, sum);
    }
  }
}

}  // namespace

extern "C" int fp_depo_scatter(const float* x_hi, const float* x_lo,
                               const float* y_hi, const float* y_lo,
                               const int* itramem, const int* npoint,
                               const int* nclass, const bool* active,
                               const float* deposit, const int* lage, int nage,
                               int n, int nspec, int nxg, int nyg,
                               int npointspec, int nclassunc, float dx_met,
                               float dy_met, float xoutshift, float youtshift,
                               float dxout, float dyout, int itime,
                               int ioutputforeachrelease, long long rows,
                               float* grid, void* stream) {
  if (n <= 0) return 0;
  if (rows > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const Cfg c{n, nspec, nxg, nyg, npointspec, nclassunc, nage,
              dx_met, dy_met, xoutshift, youtshift, dxout, dyout,
              itime, ioutputforeachrelease, rows};
  const PIn in = {x_hi, x_lo, y_hi, y_lo, itramem, npoint, nclass,
                  active, deposit, lage};
  const int blocks = (n + THREADS - 1) / THREADS;
  depo_grid_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, c, grid);
  return static_cast<int>(cudaGetLastError());
}

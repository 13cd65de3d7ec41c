// K3: concentration sampling, the scatter-add of particle mass onto gridunc.
//
// Replaces: flexpart_tpu/grid/conccalc.py::_conccalc_impl (conccalc.f90),
// which JAX leaves to XLA as one `.at[].add(mode="drop")`.  For each live
// particle (active and itra == itime) the thread computes its age class,
// output layer (first outheight above z), output cell and either one
// weight (kernel_possible == 0, or a young / near-edge particle) or the
// four uniform-kernel weights (conccalc.f90:171-260), and adds
// weight * mass / rho * sample_weight for every species into the flat
// gridunc (rows = (nage, nclass, kp, nzg, nyg, nxg), species innermost).
// Two template flags add the reference's other contributions
// (conccalc.py:140-145,174-179): BKDEP multiplies each species' value by
// max(xscav, 0), the scavenging factor of a backward deposition run (where
// the launcher is given xscav); COUNT adds the particle count instead of
// the mass, 1 on the single-index path and the weight on the 4-point path
// (where it is given count = 1).  Neither changes the per-warp sums.
// An index that falls outside the output grid or the accumulator is
// skipped, the kernel's form of JAX's mode="drop" with the 2**30 sentinel.
//
// Bound on the H100: the 41 B of state per particle are coalesced SoA
// loads (0.13 ms for 10.5M particles); what costs more is the float
// atomics into gridunc, 1-4 per particle and species, which the L2 serves
// at about 100 G/s however they are ordered.
//
// Design: one thread per particle, and the sums are made in two levels.
// The caller keeps the particles in met-cell order (reorder.cu), which is
// also an output-cell order: the 32 particles of a warp then name a few
// output cells many times over.  For each of the up to four targets of its
// particle a lane finds the lanes of its warp that name the same gridunc
// row (__match_any_sync), the first lane of each such group sums the
// group's values in lane order through shuffles, in registers, and sends
// ONE global atomic whose result is not read; the L2's adders do the rest.
// On an unordered ensemble (step 0 of a run, fresh releases) the groups
// have one lane each and every pair takes its own atomic, as before.  The
// match is on the 32-bit row index, so gridunc may have at most MAX_ROWS
// rows (the reference indexes it with int32 and stops earlier); a larger
// one is refused.  A table per block in shared memory (claim a slot by
// atomicCAS, add there, flush once) was built first and is not used: this
// card has no float add in shared memory, atomicAdd compiles to a
// compare-and-swap loop that spins once per lane on the same slot, and the
// table cost as much as the global atomics it saved.  The float sums are
// grouped by warp and ordered by the atomics, differently in every run, so
// the kernel agrees with the plain twin to a relative tolerance, not
// bitwise.
#include <cstdint>
#include <cuda_runtime.h>

#include "at_least_zero.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
// a lane without a pair matches on ~lane, the 32 largest values
constexpr long long MAX_ROWS = 0xFFFFFFFFll - 32;

struct Cfg {
  int n, nspec, nxg, nyg, npointspec, nclassunc, nage, nzg;
  float dx_met, dy_met, xoutshift, youtshift, dxout, dyout;
  int itime;
  float weight;
  int kernel_possible, use_kernel, ioutputforeachrelease;
  long long rows;
};

struct PIn {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const int *itra, *itramem, *npoint, *nclass;
  const bool* active;
  const float *mass, *rhoi;
  const float* xscav;                     // (n, nspec): BKDEP only
  const int* lage;
  const float* outheight;
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

template <bool BKDEP, bool COUNT>
__global__ void __launch_bounds__(THREADS)
conccalc_kernel(const PIn in, const Cfg c, float* __restrict__ grid) {
  const long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  // up to four (cell, weight) pairs; a weight of 0 marks an unused one
  int cx[4] = {0, 0, 0, 0}, cy[4] = {0, 0, 0, 0};
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  long long cell = 0;
  float rho = 1.0f;
  bool live = p < c.n && in.active[p] && in.itra[p] == c.itime;
  if (live) {
    const float x = in.x_hi[p] + in.x_lo[p];
    const float y = in.y_hi[p] + in.y_lo[p];
    const float z = in.z[p];
    const int it = in.itra[p] - in.itramem[p];
    const int itage = it < 0 ? -it : it;
    // age class: searchsorted(lage, itage, side="right"), clipped
    int na = 0;
    for (int a = 0; a < c.nage; ++a) na += (in.lage[a] <= itage) ? 1 : 0;
    na = na > c.nage - 1 ? c.nage - 1 : na;
    // output layer: searchsorted(outheight, z, side="right")
    int kz = 0;
    for (int k = 0; k < c.nzg; ++k) kz += (in.outheight[k] <= z) ? 1 : 0;
    rho = in.rhoi ? in.rhoi[p] : 1.0f;

    const float xl = (x * c.dx_met + c.xoutshift) / c.dxout;
    const float yl = (y * c.dy_met + c.youtshift) / c.dyout;
    const float fx = floorf(xl);
    const float fy = floorf(yl);
    // a NaN height has no output layer (as the twin's search), nor has one
    // above the top output level; out-of-range floats never land in the
    // grid, and the int cast stays defined
    live = (z == z) && kz < c.nzg &&
           fx > -2.0f && fx < static_cast<float>(c.nxg) + 1.0f &&
           fy > -2.0f && fy < static_cast<float>(c.nyg) + 1.0f;
    if (live) {
      const int ix = static_cast<int>(fx);
      const int jy = static_cast<int>(fy);
      const int kp = c.ioutputforeachrelease ? in.npoint[p] : 0;
      cell = ((static_cast<long long>(na) * c.nclassunc + in.nclass[p]) *
                  c.npointspec + kp) * c.nzg + kz;
      const bool near_edge = (xl < 0.5f) || (yl < 0.5f) ||
                             (xl > static_cast<float>(c.nxg - 1) - 0.5f) ||
                             (yl > static_cast<float>(c.nyg - 1) - 0.5f);
      cx[0] = ix;
      cy[0] = jy;
      w[0] = 1.0f;
      if (c.kernel_possible && c.use_kernel && itage >= 10800 && !near_edge) {
        // uniform-kernel weights (conccalc.f90:203-220)
        const float ddx = xl - static_cast<float>(ix);
        const float ddy = yl - static_cast<float>(jy);
        const int ixp = ddx > 0.5f ? ix + 1 : ix - 1;
        const int jyp = ddy > 0.5f ? jy + 1 : jy - 1;
        const float wx = ddx > 0.5f ? 1.5f - ddx : 0.5f + ddx;
        const float wy = ddy > 0.5f ? 1.5f - ddy : 0.5f + ddy;
        w[0] = wx * wy;
        cx[1] = ix;
        cy[1] = jyp;
        w[1] = wx * (1.0f - wy);
        cx[2] = ixp;
        cy[2] = jy;
        w[2] = (1.0f - wx) * wy;
        cx[3] = ixp;
        cy[3] = jyp;
        w[3] = (1.0f - wx) * (1.0f - wy);
      }
    }
  }

  // every lane of the warp goes through every pair: the match and the
  // shuffles take all 32
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > 0 && !c.kernel_possible) break;   // the single-index path has one
    const long long lin =
        cell * c.nyg * c.nxg + static_cast<long long>(cy[j]) * c.nxg + cx[j];
    const bool valid = live && cx[j] >= 0 && cx[j] < c.nxg && cy[j] >= 0 &&
                       cy[j] < c.nyg && w[j] > 0.0f && lin >= 0 && lin < c.rows;
    // the lanes whose pair names the same row; one without a pair is alone
    const unsigned peers =
        __match_any_sync(FULL, valid ? static_cast<unsigned>(lin) : ~lane);
    const int most = __reduce_max_sync(FULL, __popc(peers));
    const bool first = lane == static_cast<unsigned>(__ffs(peers) - 1);
    for (int s = 0; s < c.nspec; ++s) {
      float contrib = 0.0f;
      if (valid) {
        if constexpr (COUNT) {
          // the particle count: ones on the single-index path, the
          // weight on the kernel path
          contrib = (c.kernel_possible ? w[j] : 1.0f) * c.weight;
        } else {
          // the two JAX paths round differently: mass / rho on the single-
          // index path, (w / rho) * mass on the kernel path
          const float m = in.mass[p * c.nspec + s];
          float v = c.kernel_possible ? (w[j] / rho) * m : m / rho;
          if constexpr (BKDEP)
            v = v * fp::at_least_zero(in.xscav[p * c.nspec + s]);
          contrib = v * c.weight;
        }
      }
      const float sum = group_sum(peers, most, contrib, lane);
      if (valid && first) atomicAdd(grid + lin * c.nspec + s, sum);
    }
  }
}

}  // namespace

extern "C" int fp_conccalc(const float* x_hi, const float* x_lo,
                           const float* y_hi, const float* y_lo,
                           const float* z, const int* itra,
                           const int* itramem, const int* npoint,
                           const int* nclass, const bool* active,
                           const float* mass, const float* rhoi,
                           const float* xscav, int count,
                           const int* lage, int nage, const float* outheight,
                           int nzg, int n, int nspec, int nxg, int nyg,
                           int npointspec, int nclassunc, float dx_met,
                           float dy_met, float xoutshift, float youtshift,
                           float dxout, float dyout, int itime, float weight,
                           int kernel_possible, int use_kernel,
                           int ioutputforeachrelease, long long rows,
                           float* gridunc, void* stream) {
  if (n <= 0) return 0;
  if (rows > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  Cfg c{n, nspec, nxg, nyg, npointspec, nclassunc, nage, nzg,
        dx_met, dy_met, xoutshift, youtshift, dxout, dyout,
        itime, weight, kernel_possible, use_kernel, ioutputforeachrelease, rows};
  const PIn in = {x_hi, x_lo, y_hi, y_lo, z, itra, itramem, npoint, nclass,
                  active, mass, rhoi, xscav, lage, outheight};
  const int blocks = (n + THREADS - 1) / THREADS;
  // the instantiation: COUNT where asked, else BKDEP where the scavenging
  // factors are given, else the mass
  auto kern = count ? conccalc_kernel<false, true>
                    : (xscav != nullptr ? conccalc_kernel<true, false>
                                        : conccalc_kernel<false, false>);
  kern<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(in, c,
                                                                  gridunc);
  return static_cast<int>(cudaGetLastError());
}

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
// The COUNT template flag adds the particle count instead of the mass, 1
// on the single-index path and the weight on the 4-point path (where the
// launcher is given count = 1; conccalc.py:140-141,174-175).  The BKDEP
// body (conccalc_bkdep_kernel, where the launcher is given xscav;
// conccalc.py:144-145,178-179) multiplies each species' value by
// max(xscav, 0), the scavenging factor of a backward deposition run.
// An index that falls outside the output grid or the accumulator is
// skipped, the kernel's form of JAX's mode="drop" with the 2**30 sentinel.
//
// Bound on the H100: the 41 B of state per particle are coalesced SoA
// loads (0.13 ms for 10.5M particles); what costs more is the float
// atomics into gridunc, 1-4 per particle and species, which the L2 serves
// at about 100 G/s however they are ordered.
//
// Design of the stock and COUNT body: one thread per particle, and the
// sums are made in two levels.
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
//
// Design of the BKDEP body: what a backward deposition run samples is a
// young plume, every particle released at the receptor time from one box
// (a few dozen output cells, some 10**4-10**5 pairs a cell), where the
// stock body's serial shuffle loop runs 32 rounds a species and every
// warp's atomic lands on the same few addresses.  So BKDEP takes K8's
// design (depo_scatter.cu) over warp_groups.cuh: a few resident blocks an
// SM, each warp walking a contiguous span of the slots (in the run's cell
// order), 32 particles a round; per target the lanes that name one row
// find each other (__match_any_sync on the 32-bit row, lanes without a
// pair under one key), the group's sums reach its first lane by pointer
// jumping (two species at a time), and that lane adds them into the
// warp's table in shared memory keyed by row (plain stores, one writer
// per slot; a free slot claimed by an integer atomicCAS), which the warp
// sends to gridunc when it is three quarters full; where a full table had
// taken fewer than REUSE additions a row (an ensemble spread over the
// grid) the leaders send directly for the next DIRECT_ROUNDS rounds.  At
// the end of the span the block sums each row over its warps' tables and
// sends one reduction per (block, row): a float2 atomic where the species
// come in aligned pairs, else one per species; a sum that is exactly 0 is
// not sent (g + 0 == g).  Each particle's mass and factor of the first two
// species are loaded once, before its targets; on the single-index path a
// particle whose every value is 0 (its factors 0: the WETBKDEP tracer, a
// factor that was not above 0) joins no group.  Each pair's value is the
// plain twin's, rounded as it rounds.
#include <cstdint>
#include <cuda_runtime.h>

#include "at_least_zero.cuh"
#include "warp_groups.cuh"
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
  const float* xscav;                     // (n, nspec): the BKDEP body
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

template <bool COUNT>
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
          const float v = c.kernel_possible ? (w[j] / rho) * m : m / rho;
          contrib = v * c.weight;
        }
      }
      const float sum = group_sum(peers, most, contrib, lane);
      if (valid && first) atomicAdd(grid + lin * c.nspec + s, sum);
    }
  }
}

// ---- the BKDEP body: K8's warp groups and tables (warp_groups.cuh) ----

constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPECIES = 32;
// a warp's table takes about TABLE_BYTES of shared memory, and at least
// MIN_SLOTS slots (a power of two)
constexpr int TABLE_BYTES = 3072;
constexpr int MIN_SLOTS = 64;
// resident blocks per SM that the registers must allow: 64 registers (at
// 6 blocks, 40 registers, the kernel spilled 178 B and ran 1.6-1.8x
// slower on the plumes of scripts/torch_k3b_k10b_ab.py on the H100; at 5,
// 48 registers, 1.2-1.4x on the young ones)
constexpr int MIN_BLOCKS = 4;
// a warp whose table took fewer than REUSE additions per row before it
// was full sends the next DIRECT_ROUNDS rounds from the leaders directly
// (K8's 16 rounds: 12-13% slower on a spread ensemble, the same on the
// plumes)
constexpr int REUSE = 8;
constexpr int DIRECT_ROUNDS = 64;

// the launch plan: made by fp_conccalc
struct BkPlan {
  int nspec;
  int span;              // particles per warp, a multiple of 32
  int slots, shift;      // slots per warp table, 32 - log2(slots)
  int flush_at;          // send the table before a target when more are used
  int step;              // species per atomic: 2 where nspec is even and
                         // the grid 8-byte aligned, else 1
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
conccalc_bkdep_kernel(const PIn in, const Cfg c, const BkPlan b,
                      float* __restrict__ grid) {
  extern __shared__ unsigned smem[];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  unsigned* keys = smem + warp * b.slots;
  float* const vals_all = reinterpret_cast<float*>(smem + WARPS * b.slots);
  float* vals = vals_all + warp * b.slots * b.nspec;
  for (int i = lane; i < b.slots; i += 32) {
    keys[i] = fp::EMPTY;
    for (int s = 0; s < b.nspec; ++s) vals[i * b.nspec + s] = 0.0f;
  }
  __syncwarp();
  // the same on every lane: the table's slots in use, the additions into
  // it since its last flush, the rounds left to send directly
  int used = 0, adds = 0, direct_rounds = 0;

  const long long first =
      (static_cast<long long>(blockIdx.x) * WARPS + warp) * b.span;
  const long long end = first + b.span < c.n ? first + b.span : c.n;
  for (long long base = first; base < end; base += 32) {
    // every field of the round's slots loaded at once, in one round trip
    // (a chain of loads, each behind the test of the last, costs a round
    // trip each, and a warp walks its span one round after another); a
    // lane past the span reads its warp's first slot and adds nothing
    const long long p = base + lane < end ? base + lane : first;
    const long long r = p * b.nspec;
    const bool active = in.active[p];
    const int itra = in.itra[p];
    const float x = in.x_hi[p] + in.x_lo[p];
    const float y = in.y_hi[p] + in.y_lo[p];
    const float z = in.z[p];
    const int itramem = in.itramem[p];
    const int npoint = c.ioutputforeachrelease ? in.npoint[p] : 0;
    const int nclass = in.nclass[p];
    const float rho = in.rhoi ? in.rhoi[p] : 1.0f;
    // the mass and the factor of the first two species, loaded once
    float m0, f0, m1 = 0.0f, f1 = 0.0f;
    if (b.step == 2) {
      const float2 m = *reinterpret_cast<const float2*>(in.mass + r);
      const float2 f = *reinterpret_cast<const float2*>(in.xscav + r);
      m0 = m.x;
      m1 = m.y;
      f0 = fp::at_least_zero(f.x);
      f1 = fp::at_least_zero(f.y);
    } else {
      m0 = in.mass[r];
      f0 = fp::at_least_zero(in.xscav[r]);
      if (b.nspec > 1) {
        m1 = in.mass[r + 1];
        f1 = fp::at_least_zero(in.xscav[r + 1]);
      }
    }
    bool live = base + lane < end && active && itra == c.itime;
    // the particle's cell, its corners and weights (the stock body's)
    int ix = 0, jy = 0, ixp = 0, jyp = 0;
    float wx = 1.0f, wy = 1.0f;
    bool four = false;
    long long row0 = 0;
    if (live) {
      const int it = itra - itramem;
      const int itage = it < 0 ? -it : it;
      int na = 0;
      for (int a = 0; a < c.nage; ++a) na += (in.lage[a] <= itage) ? 1 : 0;
      na = na > c.nage - 1 ? c.nage - 1 : na;
      int kz = 0;
      for (int k = 0; k < c.nzg; ++k) kz += (in.outheight[k] <= z) ? 1 : 0;
      const float xl = (x * c.dx_met + c.xoutshift) / c.dxout;
      const float yl = (y * c.dy_met + c.youtshift) / c.dyout;
      const float fx = floorf(xl);
      const float fy = floorf(yl);
      live = (z == z) && kz < c.nzg &&
             fx > -2.0f && fx < static_cast<float>(c.nxg) + 1.0f &&
             fy > -2.0f && fy < static_cast<float>(c.nyg) + 1.0f;
      if (live) {
        ix = static_cast<int>(fx);
        jy = static_cast<int>(fy);
        row0 = (((static_cast<long long>(na) * c.nclassunc + nclass) *
                     c.npointspec + npoint) * c.nzg + kz) *
               c.nyg * c.nxg;
        const bool near_edge = (xl < 0.5f) || (yl < 0.5f) ||
                               (xl > static_cast<float>(c.nxg - 1) - 0.5f) ||
                               (yl > static_cast<float>(c.nyg - 1) - 0.5f);
        four = c.kernel_possible && c.use_kernel && itage >= 10800 &&
               !near_edge;
        if (four) {
          const float ddx = xl - static_cast<float>(ix);
          const float ddy = yl - static_cast<float>(jy);
          ixp = ddx > 0.5f ? ix + 1 : ix - 1;
          jyp = ddy > 0.5f ? jy + 1 : jy - 1;
          wx = ddx > 0.5f ? 1.5f - ddx : 0.5f + ddx;
          wy = ddy > 0.5f ? 1.5f - ddy : 0.5f + ddy;
        }
        if (!c.kernel_possible) {
          // the one value of each species: a particle whose every value
          // is 0 adds nothing
          bool any = ((m0 / rho) * f0) * c.weight != 0.0f ||
                     ((m1 / rho) * f1) * c.weight != 0.0f;
          for (int s = 2; s < b.nspec && !any; ++s)
            any = ((in.mass[r + s] / rho) *
                   fp::at_least_zero(in.xscav[r + s])) * c.weight != 0.0f;
          live = any;
        }
      }
    }
    if (__ballot_sync(FULL, live) == 0u) continue;
    // a warp whose table took few additions per row sends directly for a
    // while (the table pays where rows repeat: a plume)
    const bool direct = direct_rounds > 0;
    direct_rounds -= direct ? 1 : 0;
    // a round whose particles all take one target (young ones: weight 1
    // on their own cell) runs that target alone
    const int targets = __any_sync(FULL, four) ? 4 : 1;

    // every lane of the warp goes through every target: the match, the
    // shuffles and the table's flush take all 32.  The targets in the
    // stock body's order: (ix, jy), (ix, jyp), (ixp, jy), (ixp, jyp),
    // weighted wx * wy, wx * (1 - wy), (1 - wx) * wy, (1 - wx) * (1 - wy),
    // or (ix, jy) alone with weight 1.
#pragma unroll 1
    for (int j = 0; j < targets; ++j) {
      const bool hx = j >= 2, hy = (j & 1) != 0;
      const int cx = hx ? ixp : ix;
      const int cy = hy ? jyp : jy;
      const float wj = four ? (hx ? 1.0f - wx : wx) * (hy ? 1.0f - wy : wy)
                            : (j == 0 ? 1.0f : 0.0f);
      const long long lin =
          row0 + static_cast<long long>(cy) * c.nxg + cx;
      const bool valid = live && cx >= 0 && cx < c.nxg && cy >= 0 &&
                         cy < c.nyg && wj > 0.0f && lin >= 0 && lin < c.rows;
      const unsigned row = static_cast<unsigned>(lin);
      const unsigned peers = __match_any_sync(FULL, valid ? row : fp::EMPTY);
      const int most = __reduce_max_sync(FULL, valid ? __popc(peers) : 0);
      if (most == 0) continue;
      const bool leader =
          valid && lane == static_cast<unsigned>(__ffs(peers) - 1);

      int slot = static_cast<int>((row * fp::HASH) >> b.shift);
      if (!direct) {
        if (used > b.flush_at) {             // room for 32 new rows
          fp::flush_table(keys, vals, b, grid, lane);
          direct_rounds = adds < REUSE * used ? DIRECT_ROUNDS : 0;
          used = 0;
          adds = 0;
        }
        adds += __popc(__ballot_sync(FULL, leader));
        bool miss = leader && keys[slot] != row;
        if (__any_sync(FULL, miss)) {
          bool claimed = false;
          while (miss) {
            unsigned k = *static_cast<volatile unsigned*>(keys + slot);
            if (k == fp::EMPTY) {
              k = atomicCAS(keys + slot, fp::EMPTY, row);
              claimed = k == fp::EMPTY;
            }
            miss = !claimed && k != row;
            if (miss) slot = (slot + 1) & (b.slots - 1);
          }
          used += __popc(__ballot_sync(FULL, claimed));
        }
      }
      // the pair's value of species s: the plain twin's roundings, mass /
      // rho on the single-index path, (w / rho) * mass on the kernel path
      const float wr = wj / rho;
      for (int s = 0; s < b.nspec; s += b.step) {
        float a = 0.0f, e = 0.0f;
        if (valid) {
          const float ma = s == 0 ? m0 : (s == 1 ? m1 : in.mass[r + s]);
          const float fa = s == 0 ? f0 : (s == 1 ? f1 :
                           fp::at_least_zero(in.xscav[r + s]));
          a = ((c.kernel_possible ? wr * ma : ma / rho) * fa) * c.weight;
          if (b.step == 2) {
            const float mb = s == 0 ? m1 : in.mass[r + s + 1];
            const float fb = s == 0 ? f1 :
                             fp::at_least_zero(in.xscav[r + s + 1]);
            e = ((c.kernel_possible ? wr * mb : mb / rho) * fb) * c.weight;
          }
        }
        fp::group_sums(peers, most, lane, a, e);
        if (leader) {
          if (direct) {
            fp::send(grid + static_cast<long long>(row) * b.nspec + s,
                     b.step, a, e);
          } else {
            float* v = vals + slot * b.nspec + s;
            v[0] += a;
            if (b.step == 2) v[1] += e;
          }
        }
      }
      __syncwarp();
    }
  }

  // the block's rows: each summed over the warps' tables by the thread
  // that meets it in the first warp holding it, and sent once
  __syncthreads();
  for (int e = threadIdx.x; e < WARPS * b.slots; e += THREADS) {
    const int wf = e / b.slots;
    const unsigned row = smem[e];
    if (row == fp::EMPTY) continue;
    bool mine = true;
    for (int u = 0; u < wf && mine; ++u)
      mine = fp::find_slot(smem + u * b.slots, b, row) < 0;
    if (!mine) continue;
    float* v = vals_all + e * b.nspec;
    for (int u = wf + 1; u < WARPS; ++u) {
      const int at = fp::find_slot(smem + u * b.slots, b, row);
      if (at < 0) continue;
      const float* o = vals_all + (u * b.slots + at) * b.nspec;
      for (int s = 0; s < b.nspec; ++s) v[s] += o[s];
    }
    fp::send_row(grid, row, v, b);
  }
}

// The BKDEP body's launch: as many blocks as stay resident, each a
// contiguous span of the particles (4 and 16 times as many blocks, each
// a shorter span, were 2-25% slower on the plumes and 17-40% on a spread
// ensemble), and a table of a power of two slots a warp.
int launch_bkdep(const PIn& in, const Cfg& c, float* grid,
                 cudaStream_t stream) {
  if (c.nspec < 1 || c.nspec > MAX_SPECIES)
    return static_cast<int>(cudaErrorInvalidValue);
  int slots = MIN_SLOTS, log2s = 6;
  while (2 * slots * (4 + 4 * c.nspec) <= TABLE_BYTES) {
    slots *= 2;
    ++log2s;
  }
  const size_t smem =
      static_cast<size_t>(WARPS) * slots * (4 + 4 * c.nspec);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(conccalc_bkdep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conccalc_bkdep_kernel, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long warps =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) * WARPS;
  long long span = (c.n + warps - 1) / warps;
  span = (span + 31) / 32 * 32;
  const long long blocks = (c.n + span * WARPS - 1) / (span * WARPS);
  // two species a float2 where they come in aligned pairs: in the grid
  // (the atomics) and in the mass and xscav rows (the loads)
  const bool pairs =
      c.nspec % 2 == 0 && reinterpret_cast<uintptr_t>(grid) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(in.mass) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(in.xscav) % 8 == 0;
  const BkPlan b{c.nspec, static_cast<int>(span), slots, 32 - log2s,
                 slots * 3 / 4 - 32, pairs ? 2 : 1};
  conccalc_bkdep_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                          stream>>>(in, c, b, grid);
  return static_cast<int>(cudaGetLastError());
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
  // the body: COUNT where asked, else BKDEP where the scavenging factors
  // are given, else the mass
  if (!count && xscav != nullptr)
    return launch_bkdep(in, c, gridunc, static_cast<cudaStream_t>(stream));
  const int blocks = (n + THREADS - 1) / THREADS;
  auto kern = count ? conccalc_kernel<true> : conccalc_kernel<false>;
  kern<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(in, c,
                                                                  gridunc);
  return static_cast<int>(cudaGetLastError());
}

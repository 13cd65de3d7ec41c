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
// species, coalesced (0.12 ms for 10.5M particles).  What cost more in the
// first design (one thread per particle, K3's per-warp sums, one global
// float atomic per (warp, row) and species) was a plume: some 10**5 atomics
// queued on each of a few hundred addresses, and the L2 serialises them.
//
// Design: a few resident blocks per SM, each walking a contiguous span of
// the particles (in the run's order: by met cell), each warp a contiguous
// part of it, 32 particles a round.  For each corner the lanes of a warp
// that name the same grid row find each other (__match_any_sync on the
// 32-bit row; the lanes without a pair share one key, because the match
// takes longer the more distinct values it meets) and the group's sums
// reach its first lane by pointer jumping along the group's lanes (log2 of
// the largest group's size in rounds of shuffles).  That lane adds the
// group's sums into the warp's own table in shared memory, keyed by row:
// the row is mostly found in its hash slot; a leader that does not find it
// there probes on and claims a free slot with an integer atomicCAS; the
// values are plain loads and stores with exactly one writer per slot (the
// group leaders of one corner name distinct rows; __syncwarp between
// corners).  This card has no float add in shared memory
// (ATOMS.CAST.SPIN), hence no shared float atomics.  A table is kept at
// most three quarters full: before a corner that could fill it further,
// the warp sends its table to the grid and empties it.  At the end of the
// span the block sums each row over its warps' tables (the thread that
// meets the row in the first warp holding it adds the later warps' values,
// looked up in their tables) and sends one global reduction per (block,
// row): a float2 atomic where the species come in aligned pairs, else one
// per species.  The table pays where rows repeat, as on a plume; where a
// full table had taken fewer than REUSE additions per row (an ensemble
// spread over the grid), the warp's leaders send their sums directly for
// the next DIRECT_ROUNDS rounds.  A particle that deposits nothing in any
// species joins no group, a round in which no lane deposits is skipped,
// and a sum that is exactly 0 is not sent: the grid starts at +0 and only
// ever receives non-negative terms, and g + 0 == g for every such g, so
// skipping it changes no bit.  The row is matched on 32 bits, so the grid
// may have at most MAX_ROWS rows; a larger one is refused.  The sums are
// ordered by the atomics, differently in every run: the kernel agrees with
// the float64 sum of its pairs to a relative tolerance, not bitwise.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
// K3's row limit; a row stays below EMPTY, the key of a lane without a
// pair and of a free slot in a table
constexpr long long MAX_ROWS = 0xFFFFFFFFll - 32;
constexpr unsigned EMPTY = 0xFFFFFFFFu;
constexpr int MAX_SPECIES = 32;
// a warp's table takes about TABLE_BYTES of shared memory, and at least
// MIN_SLOTS slots (a power of two)
constexpr int TABLE_BYTES = 3072;
constexpr int MIN_SLOTS = 64;
constexpr unsigned HASH = 0x9E3779B1u;
// resident blocks per SM that the registers must allow: 40 registers (at
// 32 the kernel spills)
constexpr int MIN_BLOCKS = 6;
// a warp whose table took fewer than REUSE additions per row before it
// was full sends the next DIRECT_ROUNDS rounds from the leaders directly
constexpr int REUSE = 8;
constexpr int DIRECT_ROUNDS = 16;

struct Cfg {
  int n, nspec, nxg, nyg, npointspec, nclassunc, nage;
  float dx_met, dy_met, xoutshift, youtshift, dxout, dyout;
  int itime, ioutputforeachrelease;
  long long rows;
  int span;              // particles per warp, a multiple of 32
  int slots, shift;      // slots per warp table, 32 - log2(slots)
  int flush_at;          // send the table before a corner when more are used
  int step;              // species per atomic: 2 where nspec is even and
                         // the grid 8-byte aligned, else 1
};

struct PIn {
  const float *x_hi, *x_lo, *y_hi, *y_lo;
  const int *itramem, *npoint, *nclass;
  const bool* active;
  const float* deposit;   // (nspec, n)
  const int* lage;
};

// The sums of a and b over the lanes of `peers` on the group's first lane,
// by pointer jumping along the group's lanes: each lane adds the partial
// sums of the next member and takes that member's next, so that after
// ceil(log2(most)) rounds every lane holds the sum from itself to the
// group's end.  `most` is the size of the warp's largest group.  All 32
// lanes call.
__device__ __forceinline__ void group_sums(unsigned peers, int most,
                                           unsigned lane, float& a, float& b) {
  const unsigned after = peers & ~((2u << lane) - 1u);
  int next = after ? __ffs(after) - 1 : 32;   // 32: the group's last lane
  for (int span = 1; span < most; span *= 2) {
    const int from = next < 32 ? next : static_cast<int>(lane);
    const float oa = __shfl_sync(FULL, a, from);
    const float ob = __shfl_sync(FULL, b, from);
    const int on = __shfl_sync(FULL, next, from);
    if (next < 32) {
      a += oa;
      b += ob;
      next = on;
    }
  }
}

// Add the sums a (species s) and, where step is 2, b (species s + 1) of
// a row into the grid, skipping every exact zero: one float2 atomic where
// both are non-zero.
__device__ __forceinline__ void send(float* g, int step, float a, float b) {
  if (step == 2 && a != 0.0f && b != 0.0f)
    atomicAdd(reinterpret_cast<float2*>(g), make_float2(a, b));
  else {
    if (a != 0.0f) atomicAdd(g, a);
    if (step == 2 && b != 0.0f) atomicAdd(g + 1, b);
  }
}

__device__ void send_row(float* grid, unsigned row, const float* v,
                         const Cfg& c) {
  float* g = grid + static_cast<long long>(row) * c.nspec;
  for (int s = 0; s < c.nspec; s += c.step)
    send(g + s, c.step, v[s], c.step == 2 ? v[s + 1] : 0.0f);
}

// The slot of `row` in a table, or -1.  The table is never full.
__device__ __forceinline__ int find_slot(const unsigned* keys, const Cfg& c,
                                         unsigned row) {
  int h = static_cast<int>((row * HASH) >> c.shift);
  for (;;) {
    const unsigned k = keys[h];
    if (k == row) return h;
    if (k == EMPTY) return -1;
    h = (h + 1) & (c.slots - 1);
  }
}

// The warp sends its table to the grid and empties it.  All 32 lanes call.
__device__ __forceinline__ void flush_table(unsigned* keys, float* vals,
                                            const Cfg& c, float* grid,
                                            unsigned lane) {
  for (int i = lane; i < c.slots; i += 32) {
    const unsigned key = keys[i];
    if (key == EMPTY) continue;
    float* v = vals + i * c.nspec;
    send_row(grid, key, v, c);
    for (int s = 0; s < c.nspec; ++s) v[s] = 0.0f;
    keys[i] = EMPTY;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
depo_grid_kernel(const PIn in, const Cfg c, float* __restrict__ grid) {
  extern __shared__ unsigned smem[];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  unsigned* keys = smem + warp * c.slots;
  float* const vals_all = reinterpret_cast<float*>(smem + WARPS * c.slots);
  float* vals = vals_all + warp * c.slots * c.nspec;
  for (int i = lane; i < c.slots; i += 32) {
    keys[i] = EMPTY;
    for (int s = 0; s < c.nspec; ++s) vals[i * c.nspec + s] = 0.0f;
  }
  __syncwarp();
  // the same on every lane: the table's slots in use, the additions into
  // it since its last flush, the rounds left to send directly
  int used = 0, adds = 0, direct_rounds = 0;
  const long long plane = c.n;               // species stride of the deposit

  const int first = (blockIdx.x * WARPS + warp) * c.span;
  const int end = first < c.n - c.span ? first + c.span : c.n;
  for (int base = first; base < end; base += 32) {
    const int p = base + static_cast<int>(lane);
    bool live = p < end && in.active[p];
    // the first species (pair) of the deposit; a particle that deposits
    // nothing adds nothing
    float d0 = 0.0f, d1 = 0.0f;
    if (live) {
      d0 = in.deposit[p];
      d1 = c.step == 2 ? in.deposit[plane + p] : 0.0f;
      bool any = d0 != 0.0f || d1 != 0.0f;
      for (int s = c.step; s < c.nspec; ++s)
        any = any || in.deposit[s * plane + p] != 0.0f;
      live = any;
    }
    if (__ballot_sync(FULL, live) == 0u) continue;

    // the lower-left cell, the cells beside it on the particle's side, the
    // weights and the first row of the particle's (age class, class,
    // release)
    int ix = 0, jy = 0, ixp = 0, jyp = 0;
    float wx = 0.0f, wy = 0.0f;
    long long row0 = 0;
    if (live) {
      const float x = in.x_hi[p] + in.x_lo[p];
      const float y = in.y_hi[p] + in.y_lo[p];
      const float xl = (x * c.dx_met + c.xoutshift) / c.dxout;
      const float yl = (y * c.dy_met + c.youtshift) / c.dyout;
      const float fx = floorf(xl);
      const float fy = floorf(yl);
      // no corner of a particle this far out lies in the grid (a NaN
      // neither); the int cast stays defined
      live = fx > -2.0f && fx < static_cast<float>(c.nxg) + 1.0f &&
             fy > -2.0f && fy < static_cast<float>(c.nyg) + 1.0f;
      if (live) {
        ix = static_cast<int>(fx);
        jy = static_cast<int>(fy);
        const int it = c.itime - in.itramem[p];
        const int itage = it < 0 ? -it : it;
        int na = 0;
        for (int a = 0; a < c.nage; ++a) na += (in.lage[a] <= itage) ? 1 : 0;
        na = na > c.nage - 1 ? c.nage - 1 : na;
        const int kp = c.ioutputforeachrelease ? in.npoint[p] : 0;
        row0 = ((static_cast<long long>(na) * c.nclassunc + in.nclass[p]) *
                    c.npointspec + kp) * c.nyg * c.nxg;
        const float ddx = xl - static_cast<float>(ix);
        const float ddy = yl - static_cast<float>(jy);
        ixp = ddx > 0.5f ? ix + 1 : ix - 1;
        jyp = ddy > 0.5f ? jy + 1 : jy - 1;
        wx = ddx > 0.5f ? 1.5f - ddx : 0.5f + ddx;
        wy = ddy > 0.5f ? 1.5f - ddy : 0.5f + ddy;
      }
    }
    // a warp whose table took few additions per row sends directly for a
    // while (the table pays where rows repeat: a plume)
    const bool direct = direct_rounds > 0;
    direct_rounds -= direct ? 1 : 0;

    // every lane of the warp goes through every corner: the match, the
    // shuffles and the table's flush take all 32.  The loop is not
    // unrolled, and keeps no array: the kernel stays in registers.
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      // the corners in the reference's order: (ix, jy), (ixp, jyp),
      // (ixp, jy), (ix, jyp), weighted wx * wy, (1 - wx) * (1 - wy),
      // (1 - wx) * wy, wx * (1 - wy)
      const bool hx = j == 1 || j == 2;
      const bool hy = j == 1 || j == 3;
      const int cx = hx ? ixp : ix;
      const int cy = hy ? jyp : jy;
      const float wj = (hx ? 1.0f - wx : wx) * (hy ? 1.0f - wy : wy);
      const long long lin = row0 + static_cast<long long>(cy) * c.nxg + cx;
      const bool valid = live && cx >= 0 && cx < c.nxg && cy >= 0 &&
                         cy < c.nyg && lin >= 0 && lin < c.rows;
      const unsigned row = static_cast<unsigned>(lin);
      // the lanes without a pair form one group of their own, which sends
      // nothing (the match takes longer the more distinct values it meets)
      const unsigned peers = __match_any_sync(FULL, valid ? row : EMPTY);
      const int most = __reduce_max_sync(FULL, valid ? __popc(peers) : 0);
      const bool leader =
          valid && lane == static_cast<unsigned>(__ffs(peers) - 1);

      int slot = static_cast<int>((row * HASH) >> c.shift);
      if (!direct) {
        if (used > c.flush_at) {             // room for 32 new rows
          flush_table(keys, vals, c, grid, lane);
          direct_rounds = adds < REUSE * used ? DIRECT_ROUNDS : 0;
          used = 0;
          adds = 0;
        }
        adds += __popc(__ballot_sync(FULL, leader));
        // a row is mostly found in its first slot; only a leader that
        // does not find it there probes on, claiming a free slot
        bool miss = leader && keys[slot] != row;
        if (__any_sync(FULL, miss)) {
          bool claimed = false;
          while (miss) {
            unsigned k = *static_cast<volatile unsigned*>(keys + slot);
            if (k == EMPTY) {
              k = atomicCAS(keys + slot, EMPTY, row);
              claimed = k == EMPTY;
            }
            miss = !claimed && k != row;
            if (miss) slot = (slot + 1) & (c.slots - 1);
          }
          used += __popc(__ballot_sync(FULL, claimed));
        }
      }
      for (int s = 0; s < c.nspec; s += c.step) {
        float a = 0.0f, b = 0.0f;
        if (valid) {
          a = wj * (s == 0 ? d0 : in.deposit[s * plane + p]);
          b = wj * (s == 0 ? d1 : c.step == 2 ? in.deposit[(s + 1) * plane + p]
                                              : 0.0f);
        }
        group_sums(peers, most, lane, a, b);
        if (leader) {
          if (direct) {
            send(grid + static_cast<long long>(row) * c.nspec + s, c.step, a,
                 b);
          } else {
            float* v = vals + slot * c.nspec + s;
            v[0] += a;
            if (c.step == 2) v[1] += b;
          }
        }
      }
      __syncwarp();
    }
  }

  // the block's rows: each summed over the warps' tables by the thread
  // that meets it in the first warp holding it, and sent once
  __syncthreads();
  for (int e = threadIdx.x; e < WARPS * c.slots; e += THREADS) {
    const int wf = e / c.slots;
    const unsigned row = smem[e];
    if (row == EMPTY) continue;
    bool mine = true;
    for (int u = 0; u < wf && mine; ++u)
      mine = find_slot(smem + u * c.slots, c, row) < 0;
    if (!mine) continue;
    float* v = vals_all + e * c.nspec;
    for (int u = wf + 1; u < WARPS; ++u) {
      const int at = find_slot(smem + u * c.slots, c, row);
      if (at < 0) continue;
      const float* o = vals_all + (u * c.slots + at) * c.nspec;
      for (int s = 0; s < c.nspec; ++s) v[s] += o[s];
    }
    send_row(grid, row, v, c);
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
  if (rows > MAX_ROWS || nspec < 1 || nspec > MAX_SPECIES)
    return static_cast<int>(cudaErrorInvalidValue);
  // the warp's table: a power of two of slots, a key and nspec values each
  int slots = MIN_SLOTS, log2s = 6;
  while (2 * slots * (4 + 4 * nspec) <= TABLE_BYTES) {
    slots *= 2;
    ++log2s;
  }
  const size_t smem =
      static_cast<size_t>(WARPS) * slots * (4 + 4 * nspec);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(depo_grid_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // as many blocks as stay resident, each a contiguous span of particles
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, depo_grid_kernel, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long warps =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) * WARPS;
  long long span = (n + warps - 1) / warps;
  span = (span + 31) / 32 * 32;
  const long long blocks = (n + span * WARPS - 1) / (span * WARPS);
  const Cfg c{n, nspec, nxg, nyg, npointspec, nclassunc, nage,
              dx_met, dy_met, xoutshift, youtshift, dxout, dyout,
              itime, ioutputforeachrelease, rows, static_cast<int>(span),
              slots, 32 - log2s, slots * 3 / 4 - 32,
              nspec % 2 == 0 && reinterpret_cast<uintptr_t>(grid) % 8 == 0
                  ? 2 : 1};
  const PIn in = {x_hi, x_lo, y_hi, y_lo, itramem, npoint, nclass,
                  active, deposit, lage};
  depo_grid_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(in, c, grid);
  return static_cast<int>(cudaGetLastError());
}

// K17: the initial-condition sensitivity scatter (linit_cond), the mass of
// each masked particle (divided by the air density at it for linit_cond =
// 1) spread onto the output grid by conccalc's uniform 4-point kernel.
//
// Replaces: flexpart_tpu/grid/initcond.py::make_initcond_scatter's _run
// (:49-117; initial_cond_calc.f90:44-196), which JAX leaves to XLA as a
// gather of the density at four corners and two levels, and one masked
// scatter-add of (N, 4, nspec) values.
//
// What a particle adds: for linit_cond = 1 the density is the bilinear
// value at the particle's column (the grid taken as not cyclic, a corner
// beyond the last column clamped) at the two levels around it, linear in
// height: the plain version's (((g0 p0 + g1 p1) + g2 p2) + g3 p3) in each
// level.  The output cell is the layer searchsorted(outheights, z, side
// right), and the horizontal kernel is conccalc's: four cells with weights
// wx wy, ..., or the one cell where the particle is within half a cell of
// the grid's edge.  A pair is a corner with a weight above 0 inside the
// grid, of a particle in the mask below the top layer; it adds
// (w / rho) * mass for every species.
//
// Bound on the H100: the mask of every particle, and for each masked one
// its x, y (hi and lo), z, npoint and mass (24 + 4 nspec B), the density
// at eight points (32 B) and 8 nspec B (a read and a write) per valid cell.
// What costs more than that: the mask is sparse on the calls of a step
// (the particles that ended in it), and a plume piles its pairs on a few
// cells (a backward run's retroplume at its end: 84 cells, up to 2.1 M
// pairs on one), where float atomics on one address queue in the L2.
//
// Design: depo_scatter.cu's (K8), which met the same plumes.  Blocks of
// a few waves of the resident ones (a block whose span a plume fills runs
// while the card takes others), each warp walking a contiguous span of the
// slots, in the run's order (by met cell).  A warp loads the mask of
// CHUNK rounds of 128 slots at once (four bytes a lane), and each round
// appends its masked slots to the warp's queue in shared memory, by
// ballot; whenever the queue holds 32, the warp takes them, one a lane, so
// its lanes work full however sparse the mask.  For each corner the lanes
// that name the same grid row find each other (__match_any_sync on the
// 32-bit row, the lanes without a pair under one key) and the group's sums
// reach its first lane by pointer jumping.  Where some group holds
// TABLE_MOST lanes (rows repeat: a plume), the leaders add their sums into
// the warp's table in shared memory keyed by row (the row mostly in its
// hash slot; a leader that misses probes on and claims a free slot with an
// integer atomicCAS; one writer per value), kept at most three quarters
// full (before a corner that could fill it further the warp sends it to
// the grid and empties it); else they send them to the grid directly.  A
// warp initialises its table at its first use, and at the end of the span
// the block sums each row over the tables of its warps that used one and
// sends one reduction per (block, row): a float2 atomic where the species
// come in aligned pairs, else one per species; a sum that is exactly 0 is
// not sent (g + 0 == g).  A block whose warps used no table, as on a call
// whose mask is empty, ends without reading shared memory.  The row is
// matched on 32 bits, so the grid has at most MAX_ROWS rows; a larger one
// is refused.  The helpers are K8's, from warp_groups.cuh (group_sums,
// send, send_row, find_slot, flush_table), with the species of a particle
// in a row of its mass.
//
// The launch plan (blocks, the span of a warp, the table's slots) is made
// by the wrapper (grid/initcond.py::k17_plan) from this file's constants.
//
// Arithmetic: the plain version's float32 operations in its order
// (-fmad=false) up to each pair's value; the sums' order of addition
// differs from run to run, and the result is held against the float64 sum
// of the pairs.
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_groups.cuh"

namespace {

// K8's warp groups and table (FULL, EMPTY, HASH, MAX_ROWS, group_sums,
// send, send_row, find_slot, flush_table)
using namespace fp;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 64;
constexpr int MAX_MET_LEVELS = 256;
constexpr float BIG = 1073741824.0f;      // 2**30: floats clamped before a cast
constexpr int MAX_SPECIES = 32;
// a warp's table takes about TABLE_BYTES of shared memory, and at least
// MIN_SLOTS slots (a power of two)
constexpr int TABLE_BYTES = 3072;
constexpr int MIN_SLOTS = 64;
// resident blocks per SM that the registers must allow (64 registers)
constexpr int MIN_BLOCKS = 4;
// slots whose mask a warp reads in a round: four bytes a lane; it loads
// CHUNK rounds at once
constexpr int ROUND = 128;
constexpr int CHUNK = 4;
// a warp's queue of masked slots: up to 31 left over and a round's 128
constexpr int QUEUE = 160;
// a corner goes through the warp's table where some TABLE_MOST lanes name
// one row, else from the group leaders directly to the grid
constexpr int TABLE_MOST = 4;

struct Inputs {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const int* npoint;
  const float* mass;                      // (n, nspec)
  const unsigned char* mask;              // bool, 4-byte aligned
  const float* rho;                       // (nz, ny, nx)
};

struct Grid {
  int nz, ny, nx, by_rho;
  int nzg, nxg, nyg, npointspec, per_release;
  float dx_met, dy_met, xoutshift, youtshift, dxout, dyout;
};

struct Plan {
  int n, nspec;
  int span;              // slots per warp, a multiple of ROUND
  int slots, shift;      // slots per warp table, 32 - log2(slots)
  int flush_at;          // send the table before a corner when more are used
  int step;              // species per atomic: 2 where nspec is even and
                         // the grid 8-byte aligned, else 1
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

// The first row of particle k's output cell (its release, its layer) and
// its weights over the density, or false where it adds nothing (above the
// top layer).  The corners follow the plain version's order: (ix, jy),
// (ix, jyp), (ixp, jy), (ixp, jyp).
struct Pairs {
  long long row0;
  long long ix, jy, ixp, jyp;
  float w0, w1, w2, w3;  // w4 / rho of each corner
  unsigned positive;     // bit c: w4 of corner c above 0
};

__device__ __forceinline__ bool particle_pairs(const Inputs& in,
                                               const Grid& g,
                                               const float* height,
                                               const float* oh, int k,
                                               Pairs& q) {
  const float x = in.x_hi[k] + in.x_lo[k];
  const float y = in.y_hi[k] + in.y_lo[k];
  const float z = in.z[k];
  int kz = 0;
  for (int i = 0; i < g.nzg; ++i) kz += __ldg(oh + i) <= z ? 1 : 0;
  if (kz >= g.nzg) return false;          // above the top layer
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
    for (int i = 0; i < g.nz; ++i) indz += __ldg(height + i) <= z ? 1 : 0;
    indz -= 1;
    indz = indz < 0 ? 0 : (indz > g.nz - 2 ? g.nz - 2 : indz);
    const float h0 = __ldg(height + indz), h1 = __ldg(height + indz + 1);
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
  const float xl = (x * g.dx_met + g.xoutshift) / g.dxout;
  const float yl = (y * g.dy_met + g.youtshift) / g.dyout;
  q.ix = floor_int(xl);
  q.jy = floor_int(yl);
  const bool near_edge = xl < 0.5f || yl < 0.5f ||
                         xl > static_cast<float>(g.nxg - 1) - 0.5f ||
                         yl > static_cast<float>(g.nyg - 1) - 0.5f;
  const float ddx = xl - static_cast<float>(q.ix);
  const float ddy = yl - static_cast<float>(q.jy);
  const bool hi_x = ddx > 0.5f, hi_y = ddy > 0.5f;
  q.ixp = hi_x ? q.ix + 1 : q.ix - 1;
  q.jyp = hi_y ? q.jy + 1 : q.jy - 1;
  const float wx = hi_x ? 1.5f - ddx : 0.5f + ddx;
  const float wy = hi_y ? 1.5f - ddy : 0.5f + ddy;
  float w4[4] = {wx * wy, wx * (1.0f - wy), (1.0f - wx) * wy,
                 (1.0f - wx) * (1.0f - wy)};
  if (near_edge) {
    w4[0] = 1.0f;
    w4[1] = w4[2] = w4[3] = 0.0f;
  }
  q.w0 = w4[0] / rhoi;
  q.w1 = w4[1] / rhoi;
  q.w2 = w4[2] / rhoi;
  q.w3 = w4[3] / rhoi;
  q.positive = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (w4[c] > 0.0f) q.positive |= 1u << c;
  const long long kp = g.per_release ? in.npoint[k] : 0;
  if (kp < 0 || kp >= g.npointspec) return false;
  q.row0 = (kp * g.nzg + kz) * static_cast<long long>(g.nyg) * g.nxg;
  return true;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
initcond_kernel(const Inputs in, const float* __restrict__ height,
                const float* __restrict__ oh, const Grid g, const Plan c,
                float* __restrict__ grid) {
  // the levels are read from the cache where a particle needs them: a
  // block whose slots hold no masked particle, as on most calls of a
  // step, reads its mask and ends
  extern __shared__ unsigned smem[];
  __shared__ int queue_all[WARPS][QUEUE];
  __shared__ int ready[WARPS];       // the warp's table is initialised
  const unsigned lane = threadIdx.x & 31u;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  unsigned* keys = smem + warp * c.slots;
  float* const vals_all = reinterpret_cast<float*>(smem + WARPS * c.slots);
  float* vals = vals_all + warp * c.slots * c.nspec;
  int* queue = queue_all[warp];
  // read only after the block's last barrier
  if (lane == 0) ready[warp] = 0;
  // the same on every lane: the masked slots queued, the table's slots in
  // use (-1: not initialised yet)
  int pending = 0, used = -1;

  const long long first =
      (static_cast<long long>(blockIdx.x) * WARPS + warp) * c.span;
  const long long end = first + c.span < c.n ? first + c.span : c.n;
  for (long long base = first;; base += CHUNK * ROUND) {
    // the mask of CHUNK rounds at once: slots base + r ROUND + 4 lane .. + 3
    unsigned words[CHUNK];
#pragma unroll
    for (int r = 0; r < CHUNK; ++r) {
      const long long s0 = base + r * ROUND + 4 * static_cast<long long>(lane);
      words[r] = 0u;
      if (s0 + 3 < end) {
        words[r] = *reinterpret_cast<const unsigned*>(in.mask + s0);
      } else {
        for (int b = 0; b < 4; ++b)
          if (s0 + b < end && in.mask[s0 + b]) words[r] |= 1u << (8 * b);
      }
    }
#pragma unroll 1
    for (int r = 0; r < CHUNK; ++r) {
      const long long s0 = base + r * ROUND + 4 * static_cast<long long>(lane);
      const bool last = base + (r + 1) * ROUND >= end;
      // the round's word first, the others moved down (no array indexed
      // by r: the words stay in registers)
      const unsigned word = words[0];
#pragma unroll
      for (int q = 0; q + 1 < CHUNK; ++q) words[q] = words[q + 1];
      // the round's masked slots appended to the queue by ballot
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const bool m = ((word >> (8 * b)) & 0xFFu) != 0u;
        const unsigned bal = __ballot_sync(FULL, m);
        if (m) queue[pending + __popc(bal & ((1u << lane) - 1u))] =
            static_cast<int>(s0 + b);
        pending += __popc(bal);
      }
      __syncwarp();
      // a batch: 32 queued particles from the top, one a lane, and at the
      // end of the span the rest
      while (pending >= 32 || (last && pending > 0)) {
        const int take = pending < 32 ? pending : 32;
        pending -= take;
        bool live = lane < static_cast<unsigned>(take);
        const int k = live ? queue[pending + lane] : 0;
        __syncwarp();
        Pairs q;
        q.row0 = 0;
        q.ix = q.jy = q.ixp = q.jyp = 0;
        q.w0 = q.w1 = q.w2 = q.w3 = 0.0f;
        q.positive = 0u;
        live = live && particle_pairs(in, g, height, oh, k, q);
        const float* m =
            in.mass + static_cast<long long>(live ? k : 0) * c.nspec;
        // every lane of the warp goes through every corner: the match, the
        // shuffles and the table take all 32; the corners in the plain
        // version's order (ix, jy), (ix, jyp), (ixp, jy), (ixp, jyp)
#pragma unroll 1
        for (int j = 0; j < 4; ++j) {
          const long long cx = j < 2 ? q.ix : q.ixp;
          const long long cy = (j & 1) ? q.jyp : q.jy;
          const float wj =
              j == 0 ? q.w0 : (j == 1 ? q.w1 : (j == 2 ? q.w2 : q.w3));
          const long long lin = q.row0 + cy * g.nxg + cx;
          const bool valid = live && ((q.positive >> j) & 1u) && cx >= 0 &&
                             cx < g.nxg && cy >= 0 && cy < g.nyg;
          const unsigned row = static_cast<unsigned>(lin);
          const unsigned peers = __match_any_sync(FULL, valid ? row : EMPTY);
          const int most = __reduce_max_sync(FULL, valid ? __popc(peers) : 0);
          if (most == 0) continue;
          const bool leader =
              valid && lane == static_cast<unsigned>(__ffs(peers) - 1);
          // the table where rows repeat (a plume), direct atomics where the
          // lanes' rows are nearly all distinct
          const bool direct = most < TABLE_MOST;
          int slot = static_cast<int>((row * HASH) >> c.shift);
          if (!direct) {
            if (used < 0) {                      // the warp's first use
              for (int i = lane; i < c.slots; i += 32) {
                keys[i] = EMPTY;
                for (int s = 0; s < c.nspec; ++s)
                  vals[i * c.nspec + s] = 0.0f;
              }
              if (lane == 0) ready[warp] = 1;
              __syncwarp();
              used = 0;
            } else if (used > c.flush_at) {      // room for 32 new rows
              flush_table(keys, vals, c, grid, lane);
              used = 0;
            }
            bool miss = leader && keys[slot] != row;
            if (__any_sync(FULL, miss)) {
              bool claimed = false;
              while (miss) {
                unsigned kk = *static_cast<volatile unsigned*>(keys + slot);
                if (kk == EMPTY) {
                  kk = atomicCAS(keys + slot, EMPTY, row);
                  claimed = kk == EMPTY;
                }
                miss = !claimed && kk != row;
                if (miss) slot = (slot + 1) & (c.slots - 1);
              }
              used += __popc(__ballot_sync(FULL, claimed));
            }
          }
          for (int s = 0; s < c.nspec; s += c.step) {
            float a = 0.0f, b = 0.0f;
            if (valid) {
              a = wj * m[s];
              b = c.step == 2 ? wj * m[s + 1] : 0.0f;
            }
            group_sums(peers, most, lane, a, b);
            if (leader) {
              if (direct) {
                send(grid + static_cast<long long>(row) * c.nspec + s,
                     c.step, a, b);
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
      if (last) break;
    }
    if (base + CHUNK * ROUND >= end) break;
  }

  // the block's rows: each summed over the warps' tables by the thread
  // that meets it in the first warp holding it, and sent once; the tables
  // of warps that never needed one are not read
  if (!__syncthreads_or(used >= 0)) return;
  for (int e = threadIdx.x; e < WARPS * c.slots; e += THREADS) {
    const int wf = e / c.slots;
    if (!ready[wf]) continue;
    const unsigned row = smem[e];
    if (row == EMPTY) continue;
    bool mine = true;
    for (int u = 0; u < wf && mine; ++u)
      mine = !ready[u] || find_slot(smem + u * c.slots, c, row) < 0;
    if (!mine) continue;
    float* v = vals_all + e * c.nspec;
    for (int u = wf + 1; u < WARPS; ++u) {
      if (!ready[u]) continue;
      const int at = find_slot(smem + u * c.slots, c, row);
      if (at < 0) continue;
      const float* o = vals_all + (u * c.slots + at) * c.nspec;
      for (int s = 0; s < c.nspec; ++s) v[s] += o[s];
    }
    send_row(grid, row, v, c);
  }
}

}  // namespace

// particles: x_hi, x_lo, y_hi, y_lo, z (n,) f32, npoint (n,) i32, mass
// (n, nspec) f32, mask (n,) bool, 4-byte aligned; rho (nz, ny, nx) and
// height (nz,) f32 of the newer met time; by_rho: 1 for linit_cond = 1;
// outheight (nzg,) f32; grid (npointspec, nzg, nyg, nxg, nspec) f32,
// accumulated into; the plan (k17_plan): blocks, the slots a warp walks
// (a multiple of ROUND) and a warp table's slots (a power of two)
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
                           float* grid, int blocks, int span, int slots,
                           void* stream) {
  if (n <= 0) return 0;
  const long long rows =
      static_cast<long long>(npointspec) * nzg * nyg * nxg;
  if (nz < 2 || nz > MAX_MET_LEVELS || ny < 2 || nx < 2 || nzg < 1 ||
      nzg > MAX_LEVELS || nspec < 1 || nspec > MAX_SPECIES || nxg < 1 ||
      nyg < 1 || npointspec < 1 || rows > MAX_ROWS ||
      reinterpret_cast<uintptr_t>(mask) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan: every slot in a warp's span, a table of a power of two slots
  int log2s = 0;
  while ((1 << log2s) < slots) ++log2s;
  if (blocks < 1 || span < ROUND || span % ROUND != 0 ||
      static_cast<long long>(blocks) * WARPS * span < n ||
      slots < MIN_SLOTS || (1 << log2s) != slots)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(WARPS) * slots * (4 + 4 * nspec);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        initcond_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Inputs in = {x_hi, x_lo, y_hi, y_lo, z, npoint, mass,
                     reinterpret_cast<const unsigned char*>(mask), rho};
  const Grid g = {nz, ny, nx, by_rho, nzg, nxg, nyg, npointspec,
                  per_release, dx_met, dy_met, xoutshift, youtshift, dxout,
                  dyout};
  const Plan c{n, nspec, span, slots, 32 - log2s, slots * 3 / 4 - 32,
               nspec % 2 == 0 && reinterpret_cast<uintptr_t>(grid) % 8 == 0
                   ? 2 : 1};
  initcond_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(in, height,
                                                         outheight, g, c,
                                                         grid);
  return static_cast<int>(cudaGetLastError());
}

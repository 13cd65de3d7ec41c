// Warp groups before the atomics, shared by the scatters that add many
// pairs onto few rows of an output grid: K8's deposit scatter, K16's
// fluxes and K17's initial-condition scatter.
//
// The lanes of a warp that name the same row find each other with
// __match_any_sync on the 32-bit row (the lanes without a pair under the
// one key EMPTY, because the match takes longer the more distinct values it
// meets); group_sums brings each group's sums to its first lane by pointer
// jumping, and that lane sends them (send, send_row) or adds them into the
// warp's table in shared memory keyed by row (find_slot, flush_table: K8
// and K17).  A row is matched on 32 bits, so an output grid has at most
// MAX_ROWS rows, each below EMPTY; the launchers refuse a larger one.
//
// The table's functions take the kernel's plan struct, which has nspec,
// step (species per atomic: 2 where nspec is even and the grid 8-byte
// aligned, else 1), slots (a power of two) and shift (32 - log2(slots)).
#pragma once

namespace fp {

constexpr unsigned FULL = 0xFFFFFFFFu;
// a row stays below EMPTY, the key of a lane without a pair and of a free
// slot in a table
constexpr long long MAX_ROWS = 0xFFFFFFFFll - 32;
constexpr unsigned EMPTY = 0xFFFFFFFFu;
constexpr unsigned HASH = 0x9E3779B1u;

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

// group_sums of one value (a row of one species).
__device__ __forceinline__ void group_sums(unsigned peers, int most,
                                           unsigned lane, float& a) {
  const unsigned after = peers & ~((2u << lane) - 1u);
  int next = after ? __ffs(after) - 1 : 32;
  for (int span = 1; span < most; span *= 2) {
    const int from = next < 32 ? next : static_cast<int>(lane);
    const float oa = __shfl_sync(FULL, a, from);
    const int on = __shfl_sync(FULL, next, from);
    if (next < 32) {
      a += oa;
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

template <typename Plan>
__device__ void send_row(float* grid, unsigned row, const float* v,
                         const Plan& c) {
  float* g = grid + static_cast<long long>(row) * c.nspec;
  for (int s = 0; s < c.nspec; s += c.step)
    send(g + s, c.step, v[s], c.step == 2 ? v[s + 1] : 0.0f);
}

// The slot of `row` in a table, or -1.  The table is never full.
template <typename Plan>
__device__ __forceinline__ int find_slot(const unsigned* keys, const Plan& c,
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
template <typename Plan>
__device__ __forceinline__ void flush_table(unsigned* keys, float* vals,
                                            const Plan& c, float* grid,
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

}  // namespace fp

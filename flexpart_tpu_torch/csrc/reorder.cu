// K5: sort the particles by met cell, a stable radix sort written by hand.
//
// Replaces: nothing in flexpart_tpu; it is the layout step that lets the
// advance kernel (advance.cu) find its table rows in the caches.  The JAX
// package keeps no particle order either (core/state.py has no identity
// field; parallel/domain.py moves particles between slots).  The plain
// version is core/reorder.py::reorder_by_cell_plain (stable argsort +
// gather), and perm equals its argsort bitwise on every input.
//
// The key is the advance's own row id, indz*ny*nx + jy*nx + ix, from the
// device functions of cell_index.cuh that the advance uses; a particle
// that is not scheduled gets the key R = (nz-1)*ny*nx and goes last.
//
// Bound on the H100: bytes.  Every field of every particle is read once
// and written once (82 B each way with one species), plus 4 B of perm per
// particle; keys, slot lists and digit counts are scratch.
//
// Why stable: the advance's draw counter is the slot index, so a run is a
// function of its seed only if perm is a function of its input.  No atomic
// decides a place anywhere below.
//
// Design: a least-significant-digit radix sort of (key, old slot) pairs in
// `passes` passes of `digit_bits` bits (radix_plan below takes both from R),
// then one gather.  A block owns SORT_TILE consecutive pairs
// in every pass, each of its warps WARP_ITEMS consecutive ones, read 32 at
// a time, so "earlier" always means "lower place in the input".  A pass:
//   1. digit counts per block (shared-memory counters; the first pass
//      computes the keys here and stores them), written as a
//      [digit][block] matrix;
//   2. exclusive scan of the matrix in three launches (a sum per 2048-entry
//      tile, a one-block scan of the tile sums, a scan inside each tile):
//      entry [d][b] becomes the place of block b's first pair of digit d;
//   3. scatter: a warp finds its lanes of equal digit with
//      __match_any_sync (once per 32 pairs; the masks stay in registers),
//      counts its digits into its own row of shared counters, the rows
//      are summed in warp order, and a pair's place is the matrix entry +
//      the pairs of its digit in earlier warps + in earlier rounds of its
//      warp + in lower lanes.  The last pass writes only the slots: perm.
// The gather is one thread per new slot: all fields of the source particle
// are loaded, then stored; the stores are coalesced, the loads are
// scattered unless the input was nearly ordered already (a shuffled
// ensemble pulls a 32 B sector per 4 B field: its bound is sectors, not
// bytes).  Every count is an integer sum, whatever order the blocks run in.
#include <cstdint>
#include <cuda_runtime.h>

#include "cell_index.cuh"

constexpr int NFIELDS = 22;   // core/state.py::FIELDS

// The particle arrays to move; mirrored by core/reorder.py::ReorderFields.
struct ReorderFields {
  const void* src[NFIELDS];
  void* dst[NFIELDS];
  int width[NFIELDS];   // bytes per particle: 1, or a multiple of 4
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;   // 2048 entries per block
constexpr int ROUNDS = 16;                        // 32 pairs per warp and round
constexpr int WARP_ITEMS = 32 * ROUNDS;
constexpr int SORT_TILE = WARPS * WARP_ITEMS;     // 4096 pairs per block
constexpr int MAX_DIGIT_BITS = 8;
constexpr int MAX_RADIX = 1 << MAX_DIGIT_BITS;

// The digit of the pair at place i of this pass's input, or -1 past the end.
__device__ __forceinline__ int digit_at(const int* __restrict__ keys, long long i,
                                        int n, int shift, int radix) {
  return i < n ? (keys[i] >> shift) & (radix - 1) : -1;
}

// Pass 0 only: the keys from the particles' cells.
__global__ void __launch_bounds__(THREADS)
key_kernel(const float* __restrict__ x_hi, const float* __restrict__ x_lo,
           const float* __restrict__ y_hi, const float* __restrict__ y_lo,
           const float* __restrict__ z, const uint8_t* __restrict__ active,
           const float* __restrict__ height, int n, int nx, int ny, int nz,
           int n_rows, int* __restrict__ keys) {
  extern __shared__ float sh_height[];
  for (int k = threadIdx.x; k < nz; k += blockDim.x) sh_height[k] = height[k];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int key = n_rows;
  if (active[i] != 0) {
    const fp::Horiz hw = fp::horiz_weights(x_hi[i] + x_lo[i],
                                           y_hi[i] + y_lo[i], nx, ny);
    int indz;
    float dz1;
    fp::vert_weights(sh_height, nz, z[i], indz, dz1);
    key = static_cast<int>(fp::cell_row(indz, hw.jy, hw.ix, ny, nx));
  }
  keys[i] = key;
}

// counts[d * n_blocks + b] = pairs of digit d in block b's tile
__global__ void __launch_bounds__(THREADS)
digit_count_kernel(const int* __restrict__ keys, int n, int shift, int radix,
                   int n_blocks, int* __restrict__ counts) {
  __shared__ int sh_count[MAX_RADIX];
  for (int d = threadIdx.x; d < radix; d += THREADS) sh_count[d] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * SORT_TILE;
#pragma unroll
  for (int r = 0; r < SORT_TILE / THREADS; ++r) {
    const int digit = digit_at(keys, base + r * THREADS + threadIdx.x, n,
                               shift, radix);
    // one shared atomic per group of equal digits of the warp: an integer
    // count, the same whatever order the adds arrive in
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, digit);
    const unsigned lane = threadIdx.x & 31;
    if (digit >= 0 && (peers & ((1u << lane) - 1u)) == 0)
      atomicAdd(&sh_count[digit], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += THREADS)
    counts[static_cast<long long>(d) * n_blocks + blockIdx.x] = sh_count[d];
}

// Exclusive scan of this thread's block-wide value; total in *block_total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* block_total) {
  __shared__ int warp_sums[THREADS / 32];
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= static_cast<unsigned>(d)) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int s = warp_sums[w];
    if (static_cast<unsigned>(w) < warp) before += s;
    total += s;
  }
  __syncthreads();   // warp_sums may be written again by the next call
  *block_total = total;
  return before + incl - v;
}

// scan pass 1: sums[b] = sum of tile b
__global__ void __launch_bounds__(THREADS)
scan_tile_sums_kernel(const int* __restrict__ bins, int n_bins,
                      int* __restrict__ sums) {
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE
                         + threadIdx.x * SCAN_ITEMS;
  int v = 0;
#pragma unroll
  for (int m = 0; m < SCAN_ITEMS; ++m)
    if (base + m < n_bins) v += bins[base + m];
  int total;
  block_exclusive_scan(v, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// scan pass 2: exclusive scan of the tile sums in place, one block
__global__ void __launch_bounds__(THREADS)
scan_sums_kernel(int* __restrict__ sums, int n_tiles) {
  int carry = 0;
  for (int start = 0; start < n_tiles; start += THREADS) {
    const int t = start + static_cast<int>(threadIdx.x);
    const int v = t < n_tiles ? sums[t] : 0;
    int total;
    const int excl = block_exclusive_scan(v, &total);
    if (t < n_tiles) sums[t] = carry + excl;
    carry += total;
  }
}

// scan pass 3: bins[i] = sum of the entries before i, in place
__global__ void __launch_bounds__(THREADS)
scan_tiles_kernel(int* __restrict__ bins, int n_bins,
                  const int* __restrict__ sums) {
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE
                         + threadIdx.x * SCAN_ITEMS;
  int c[SCAN_ITEMS];
  int v = 0;
#pragma unroll
  for (int m = 0; m < SCAN_ITEMS; ++m) {
    c[m] = base + m < n_bins ? bins[base + m] : 0;
    v += c[m];
  }
  int total;
  int run = sums[blockIdx.x] + block_exclusive_scan(v, &total);
#pragma unroll
  for (int m = 0; m < SCAN_ITEMS; ++m) {
    if (base + m < n_bins) bins[base + m] = run;
    run += c[m];
  }
}

// One pass's stable scatter.  offsets is the scanned [digit][block] matrix;
// slots_in NULL: the pair at place i carries slot i (first pass); keys_out
// NULL: the keys are not needed again (last pass).
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ slots_in,
               int n, int shift, int radix, int n_blocks,
               const int* __restrict__ offsets, int* __restrict__ keys_out,
               int* __restrict__ slots_out) {
  __shared__ int sh_place[WARPS][MAX_RADIX];
  for (int k = threadIdx.x; k < WARPS * MAX_RADIX; k += THREADS)
    (&sh_place[0][0])[k] = 0;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long base = static_cast<long long>(blockIdx.x) * SORT_TILE
                         + warp * WARP_ITEMS + lane;
  int key[ROUNDS];
  unsigned peers[ROUNDS];
  // this warp's digit counts; one lane per group of equal digits adds, and
  // the rounds follow each other, so no atomic is needed
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + r * 32;
    key[r] = i < n ? keys_in[i] : -1;
    const int digit = i < n ? (key[r] >> shift) & (radix - 1) : -1;
    peers[r] = __match_any_sync(0xFFFFFFFFu, digit);
    if (digit >= 0 && (peers[r] & lower) == 0)
      sh_place[warp][digit] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();
  // counts -> places: the block's first place of the digit, then the warps
  // in order
  for (int d = threadIdx.x; d < radix; d += THREADS) {
    int run = offsets[static_cast<long long>(d) * n_blocks + blockIdx.x];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = sh_place[w][d];
      sh_place[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + r * 32;
    const int digit = i < n ? (key[r] >> shift) & (radix - 1) : -1;
    int place = 0;
    if (digit >= 0) place = sh_place[warp][digit] + __popc(peers[r] & lower);
    __syncwarp();   // every lane has read before the group's first lane adds
    if (digit >= 0 && (peers[r] & lower) == 0)
      sh_place[warp][digit] += __popc(peers[r]);
    __syncwarp();
    if (digit >= 0) {
      if (keys_out != nullptr) keys_out[place] = key[r];
      slots_out[place] = slots_in != nullptr ? slots_in[i] : static_cast<int>(i);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const int* __restrict__ perm, int n, const ReorderFields f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long s = perm[i];
  // every load first, so that they are all in flight together
  uint32_t v[NFIELDS];
#pragma unroll
  for (int k = 0; k < NFIELDS; ++k) {
    if (f.width[k] == 4)
      v[k] = static_cast<const uint32_t*>(f.src[k])[s];
    else if (f.width[k] == 1)
      v[k] = static_cast<const uint8_t*>(f.src[k])[s];
  }
#pragma unroll
  for (int k = 0; k < NFIELDS; ++k) {
    if (f.width[k] == 4) {
      static_cast<uint32_t*>(f.dst[k])[i] = v[k];
    } else if (f.width[k] == 1) {
      static_cast<uint8_t*>(f.dst[k])[i] = static_cast<uint8_t>(v[k]);
    } else {
      const int words = f.width[k] >> 2;
      const uint32_t* src = static_cast<const uint32_t*>(f.src[k]) + s * words;
      uint32_t* dst = static_cast<uint32_t*>(f.dst[k]) + i * words;
      for (int w = 0; w < words; ++w) dst[w] = src[w];
    }
  }
}

// The fewest passes of at most MAX_DIGIT_BITS bits that cover the largest
// key, n_rows, with the bits spread evenly over them.  The last shift,
// (passes - 1) * digit_bits, stays below 31 for every int32 key.
void radix_plan(long long n_rows, int* passes, int* digit_bits) {
  int bits = 1;
  while ((n_rows >> bits) != 0) ++bits;
  *passes = (bits + MAX_DIGIT_BITS - 1) / MAX_DIGIT_BITS;
  *digit_bits = (bits + *passes - 1) / *passes;
}

}  // namespace

// counts_len and sums_len are the lengths of the scratch arrays `counts`
// and `sums` as the caller allocated them; too short is an error.
extern "C" int fp_reorder(const float* x_hi, const float* x_lo,
                          const float* y_hi, const float* y_lo, const float* z,
                          const uint8_t* active, const float* height, int n,
                          int nx, int ny, int nz,
                          int* keys_a, int* keys_b, int* slots_a, int* slots_b,
                          int* counts, int counts_len, int* sums, int sums_len,
                          int* perm,
                          const ReorderFields* fields, void* stream) {
  if (n <= 0) return 0;
  const long long n_rows = static_cast<long long>(nz - 1) * ny * nx;
  const size_t shmem = static_cast<size_t>(nz) * sizeof(float);
  if (nz < 2 || shmem > 48 * 1024 || n_rows + 1 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int passes, digit_bits;
  radix_plan(n_rows, &passes, &digit_bits);
  for (int k = 0; k < NFIELDS; ++k) {
    const int w = fields->width[k];
    if (w != 1 && (w < 4 || w % 4)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int radix = 1 << digit_bits;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  const int sort_blocks = (n + SORT_TILE - 1) / SORT_TILE;
  const long long n_counts = static_cast<long long>(radix) * sort_blocks;
  const long long tiles = (n_counts + SCAN_TILE - 1) / SCAN_TILE;
  if (n_counts > counts_len || tiles > sums_len)
    return static_cast<int>(cudaErrorInvalidValue);
  key_kernel<<<blocks, THREADS, shmem, s>>>(
      x_hi, x_lo, y_hi, y_lo, z, active, height, n, nx, ny, nz,
      static_cast<int>(n_rows), keys_a);
  int* keys[2] = {keys_a, keys_b};
  int* slots[2] = {slots_a, slots_b};
  for (int p = 0; p < passes; ++p) {
    const int shift = p * digit_bits;
    const bool last = p == passes - 1;
    const int* k_in = keys[p & 1];
    digit_count_kernel<<<sort_blocks, THREADS, 0, s>>>(k_in, n, shift, radix,
                                                      sort_blocks, counts);
    scan_tile_sums_kernel<<<static_cast<unsigned>(tiles), THREADS, 0, s>>>(
        counts, static_cast<int>(n_counts), sums);
    scan_sums_kernel<<<1, THREADS, 0, s>>>(sums, static_cast<int>(tiles));
    scan_tiles_kernel<<<static_cast<unsigned>(tiles), THREADS, 0, s>>>(
        counts, static_cast<int>(n_counts), sums);
    scatter_kernel<<<sort_blocks, THREADS, 0, s>>>(
        k_in, p == 0 ? nullptr : slots[(p - 1) & 1], n, shift, radix,
        sort_blocks, counts, last ? nullptr : keys[(p + 1) & 1],
        last ? perm : slots[p & 1]);
  }
  gather_kernel<<<blocks, THREADS, 0, s>>>(perm, n, *fields);
  return static_cast<int>(cudaGetLastError());
}

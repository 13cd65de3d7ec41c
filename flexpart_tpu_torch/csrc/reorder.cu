// K5: sort the particles by met cell, a counting sort written by hand.
//
// Replaces: nothing in flexpart_tpu; it is the layout step that lets the
// advance kernel (advance.cu) find its table rows in the caches.  The JAX
// package keeps no particle order either (core/state.py has no identity
// field; parallel/domain.py moves particles between slots).  The plain
// version is core/reorder.py::reorder_by_cell_plain (argsort + gather).
//
// The key is the advance's own row id, indz*ny*nx + jy*nx + ix, from the
// device functions of cell_index.cuh that the advance uses; a particle
// that is not scheduled gets the key R = (nz-1)*ny*nx and goes last.
//
// Bound on the H100: bytes.  Every field of every particle is read once
// and written once (82 B each way with one species), plus 4 B of perm per
// particle; the keys and the R+1 bins are scratch.
//
// Design, five small kernels behind one C function, launched in order on
// one stream:
//   1. key + histogram: one thread per particle, atomicAdd into R+1 bins;
//   2. exclusive scan of the bins in three passes (a sum per 2048-bin
//      tile, a one-block scan of the tile sums, a scan inside each tile);
//   3. rank: atomicAdd on the bin's running offset gives the particle's
//      new slot; perm[slot] = old slot;
//   4. gather: one thread per new slot loads all fields of its source
//      particle, then stores them; the stores are coalesced, the loads are
//      scattered unless the input was nearly ordered already.
// In 1 and 3 the lanes of a warp that name the same bin are found with
// __match_any_sync and served by one atomic of their count: on a nearly
// ordered ensemble a warp names a few bins, and 32 atomics on one address
// would serialise.  Order inside a cell is free, so the sort is not
// stable and perm may differ between two runs.
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
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;   // 2048 bins per block

// Lanes of the warp with the same key, this lane's rank among them, and
// whether it is the first of them.
struct Peers {
  unsigned mask;
  int rank;
  int leader;
};
__device__ __forceinline__ Peers peers_of(int key) {
  Peers p;
  p.mask = __match_any_sync(0xFFFFFFFFu, key);
  const unsigned lane = threadIdx.x & 31;
  p.rank = __popc(p.mask & ((1u << lane) - 1u));
  p.leader = __ffs(p.mask) - 1;
  return p;
}

__global__ void __launch_bounds__(THREADS)
key_hist_kernel(const float* __restrict__ x_hi, const float* __restrict__ x_lo,
                const float* __restrict__ y_hi, const float* __restrict__ y_lo,
                const float* __restrict__ z, const uint8_t* __restrict__ active,
                const float* __restrict__ height, int n, int nx, int ny, int nz,
                int n_rows, int* __restrict__ keys, int* __restrict__ bins) {
  extern __shared__ float sh_height[];
  for (int k = threadIdx.x; k < nz; k += blockDim.x) sh_height[k] = height[k];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int key = -1;   // past the end: no bin
  if (i < n) {
    key = n_rows;
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
  const Peers p = peers_of(key);
  if (key >= 0 && p.rank == 0) atomicAdd(&bins[key], __popc(p.mask));
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

// pass 1: sums[b] = sum of tile b
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

// pass 2: exclusive scan of the tile sums in place, one block
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

// pass 3: bins[i] = number of particles with a smaller key, in place
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

// perm[new slot] = old slot; offsets are the scanned bins, advanced here
__global__ void __launch_bounds__(THREADS)
rank_kernel(const int* __restrict__ keys, int n, int* __restrict__ offsets,
            int* __restrict__ perm) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int key = i < n ? keys[i] : -1;
  const Peers p = peers_of(key);
  int first = 0;
  if (key >= 0 && p.rank == 0) first = atomicAdd(&offsets[key], __popc(p.mask));
  first = __shfl_sync(0xFFFFFFFFu, first, p.leader);
  if (key >= 0) perm[first + p.rank] = static_cast<int>(i);
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

}  // namespace

extern "C" int fp_reorder(const float* x_hi, const float* x_lo,
                          const float* y_hi, const float* y_lo, const float* z,
                          const uint8_t* active, const float* height, int n,
                          int nx, int ny, int nz, int* keys, int* bins,
                          int* sums, int* perm, const ReorderFields* fields,
                          void* stream) {
  if (n <= 0) return 0;
  const long long n_rows = static_cast<long long>(nz - 1) * ny * nx;
  const size_t shmem = static_cast<size_t>(nz) * sizeof(float);
  if (nz < 2 || shmem > 48 * 1024 || n_rows + 1 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < NFIELDS; ++k) {
    const int w = fields->width[k];
    if (w != 1 && (w < 4 || w % 4)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_bins = static_cast<int>(n_rows) + 1;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  const unsigned tiles = static_cast<unsigned>((n_bins + SCAN_TILE - 1) / SCAN_TILE);
  key_hist_kernel<<<blocks, THREADS, shmem, s>>>(
      x_hi, x_lo, y_hi, y_lo, z, active, height, n, nx, ny, nz,
      static_cast<int>(n_rows), keys, bins);
  scan_tile_sums_kernel<<<tiles, THREADS, 0, s>>>(bins, n_bins, sums);
  scan_sums_kernel<<<1, THREADS, 0, s>>>(sums, static_cast<int>(tiles));
  scan_tiles_kernel<<<tiles, THREADS, 0, s>>>(bins, n_bins, sums);
  rank_kernel<<<blocks, THREADS, 0, s>>>(keys, n, bins, perm);
  gather_kernel<<<blocks, THREADS, 0, s>>>(perm, n, *fields);
  return static_cast<int>(cudaGetLastError());
}

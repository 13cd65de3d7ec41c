// K1: clipped N(0,1) draws from a counter-based Philox4x32-10.
//
// Replaces: flexpart_tpu/core/rng.py::_pallas_normals (the Pallas kernel
// seeded from the TPU hardware PRNG per 8192-column block).  The TPU's
// bits cannot be reproduced on the H100, so the port keeps the kernel's
// contract and its transform instead of its stream; both live in
// philox_normal.cuh as the device functions fp::normal_words and
// fp::normal_pair, which this stand-alone kernel (behind
// core/rng.py::normals on a CUDA device) shares with the fused advance
// kernel (advance.cu).  The advance makes its draws in registers through
// those functions, so on the main path no draw is written to device
// memory; this kernel serves callers that want the draws as a tensor (the
// parity mode of the advance, the tests).
//
// Key = (seed_lo, seed_hi ^ mix(step, tag)), made by the Python wrapper.
// Counter = (column + offset, row / 4, pass, 0): column is the particle
// index, so a draw depends only on (key, tag, global particle index, row,
// pass) and chunking the particles never changes the stream; `pass` is the
// adaptive advance's pass of the substep loop (0 for every other draw).
// One Philox call gives the four rows 4q .. 4q+3 of a column, one
// Box-Muller radius two of them (philox_normal.cuh has the layout).
//
// Bound on the H100: the 4 output bytes per draw (store bandwidth) and the
// generator's arithmetic are about level: a quarter of a Philox call and
// half a logf/sqrtf/sincosf per draw.  Design: one thread per column
// walks down the column four rows at a time, so each Philox call is
// followed by four store instructions and each store of a warp covers 32
// consecutive floats (coalesced); the last block of a row count that is
// no multiple of four makes only the pairs it stores.
#include <cstdint>
#include <cuda_runtime.h>

#include "philox_normal.cuh"

namespace {

__global__ void normals_kernel(float* __restrict__ out, int rows, int cols,
                               uint32_t k0, uint32_t k1, long long offset,
                               uint32_t pass) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float* __restrict__ o = out + col;
  const size_t stride = static_cast<size_t>(cols);
  for (int row = 0; row < rows; row += fp::ROWS_PER_BLOCK) {
    uint32_t w[4];
    fp::normal_words(w, k0, k1, col + offset,
                     static_cast<uint32_t>(row / fp::ROWS_PER_BLOCK), pass);
    float z0, z1;
    fp::normal_pair(w[0], w[1], z0, z1);
    o[row * stride] = z0;
    if (row + 1 < rows) o[(row + 1) * stride] = z1;
    if (row + 2 < rows) {
      fp::normal_pair(w[2], w[3], z0, z1);
      o[(row + 2) * stride] = z0;
      if (row + 3 < rows) o[(row + 3) * stride] = z1;
    }
  }
}

}  // namespace

extern "C" int fp_normals(float* out, int rows, int cols, uint32_t k0,
                          uint32_t k1, long long offset, uint32_t pass,
                          void* stream) {
  if (cols <= 0 || rows <= 0) return 0;
  const int threads = 256;
  const int blocks = (cols + threads - 1) / threads;
  normals_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, rows, cols, k0, k1, offset, pass);
  return static_cast<int>(cudaGetLastError());
}

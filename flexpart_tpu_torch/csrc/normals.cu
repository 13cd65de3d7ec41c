// K1: clipped N(0,1) draws from a counter-based Philox4x32-10.
//
// Replaces: flexpart_tpu/core/rng.py::_pallas_normals (the Pallas kernel
// seeded from the TPU hardware PRNG per 8192-column block).  The TPU's
// bits cannot be reproduced on the H100, so the port keeps the kernel's
// contract and its transform instead of its stream; both live in
// philox_normal.cuh as the device function fp::normal_at, which this
// stand-alone kernel (behind core/rng.py::normals on a CUDA device) shares
// with the fused advance kernel (advance.cu).  The advance makes its
// draws in registers through that function, so on the main path no draw
// is written to device memory; this kernel serves callers that want the
// draws as a tensor (the parity mode of the advance, the tests).
//
// Key = (seed_lo, seed_hi ^ mix(step, tag)), made by the Python wrapper.
// Counter = (column + offset, row, 0, 0): column is the particle index,
// so a draw depends only on (key, tag, global particle index, row) and
// chunking the particles never changes the stream.
//
// Bound on the H100: the 4 output bytes per draw (store bandwidth); the
// 10 Philox rounds are ~20 integer multiplies, far below the ALU limit.
// Design: one thread per column writes that column's rows, so each store
// instruction of a warp covers 32 consecutive floats (coalesced).
#include <cstdint>
#include <cuda_runtime.h>

#include "philox_normal.cuh"

namespace {

__global__ void normals_kernel(float* __restrict__ out, int rows, int cols,
                               uint32_t k0, uint32_t k1, long long offset) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  for (int row = 0; row < rows; ++row) {
    out[static_cast<long long>(row) * cols + col] =
        fp::normal_at(k0, k1, col + offset, static_cast<uint32_t>(row));
  }
}

}  // namespace

extern "C" int fp_normals(float* out, int rows, int cols, uint32_t k0,
                          uint32_t k1, long long offset, void* stream) {
  if (cols <= 0 || rows <= 0) return 0;
  const int threads = 256;
  const int blocks = (cols + threads - 1) / threads;
  normals_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, rows, cols, k0, k1, offset);
  return static_cast<int>(cudaGetLastError());
}

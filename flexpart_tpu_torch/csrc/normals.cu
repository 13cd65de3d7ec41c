// K1: clipped N(0,1) draws from a counter-based Philox4x32-10.
//
// Replaces: flexpart_tpu/core/rng.py::_pallas_normals (the Pallas kernel
// seeded from the TPU hardware PRNG per 8192-column block).  The TPU's
// bits cannot be reproduced on the H100, so the port keeps the kernel's
// contract and its transform instead of its stream: uniforms from the
// top 24 bits (exact int->float), u1 -> 1-u1 in (0, 1], the cos branch of
// Box-Muller with the accurate logf/cosf/sqrtf, clipped to +-3.
//
// Key = (seed_lo, seed_hi ^ mix(step, tag)), made by the Python wrapper.
// Counter = (column + offset, row, 0, 0): column is the particle index,
// so a draw depends only on (key, tag, global particle index, row) and
// chunking the particles never changes the stream.
//
// Bound on the H100: the 4 output bytes per draw (store bandwidth); the
// 10 Philox rounds are ~20 integer multiplies, far below the ALU limit.
// Design: one thread per column writes that column's rows, so each store
// instruction of a warp covers 32 consecutive floats (coalesced).  The
// plain twin in core/rng.py computes the same Philox words bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c[0]);
    const uint32_t lo0 = PHILOX_M0 * c[0];
    const uint32_t hi1 = __umulhi(PHILOX_M1, c[2]);
    const uint32_t lo1 = PHILOX_M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
}

__global__ void normals_kernel(float* __restrict__ out, int rows, int cols,
                               uint32_t k0, uint32_t k1, long long offset) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const uint32_t ctr0 = static_cast<uint32_t>(
      static_cast<unsigned long long>(col + offset) & 0xFFFFFFFFull);
  const float two_pi = 6.28318530717958647692f;
  for (int row = 0; row < rows; ++row) {
    uint32_t c[4] = {ctr0, static_cast<uint32_t>(row), 0u, 0u};
    philox4x32_10(c, k0, k1);
    // top 24 bits -> [0, 1) exactly; 1 - u1 in (0, 1] keeps the log finite
    const float u1 = 1.0f - static_cast<float>(c[0] >> 8) * 5.9604644775390625e-08f;
    const float u2 = static_cast<float>(c[1] >> 8) * 5.9604644775390625e-08f;
    const float r = sqrtf(-2.0f * logf(u1));
    const float z = r * cosf(two_pi * u2);
    out[static_cast<long long>(row) * cols + col] = fminf(fmaxf(z, -3.0f), 3.0f);
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

// One clipped N(0,1) draw from a counter-based Philox4x32-10, as a device
// function: the draw backend shared by the stand-alone normals kernel
// (normals.cu) and the fused advance kernel (advance.cu), which makes its
// draws in registers so that they never touch device memory.
//
// A draw depends on nothing but (key, global particle index, row):
// counter = (global index, row, 0, 0), key = (seed_lo, seed_hi ^
// mix(step, tag)) made by core/rng.py::Key.philox_key.  Skipping a draw
// therefore changes no other draw.
//
// Transform: uniforms from the top 24 bits (exact int->float), u1 -> 1-u1
// in (0, 1] so the log is finite, the cos branch of Box-Muller with the
// accurate logf/cosf/sqrtf (never --use_fast_math), clipped to +-3.  The
// plain twin core/rng.py::normals_plain computes the same Philox words bit
// for bit.
#pragma once
#include <cstdint>

namespace fp {

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

// Low 32 bits of the global particle index: the counter's first word.
__device__ __forceinline__ uint32_t counter_word(long long global_index) {
  return static_cast<uint32_t>(
      static_cast<unsigned long long>(global_index) & 0xFFFFFFFFull);
}

__device__ __forceinline__ float normal_at(uint32_t k0, uint32_t k1,
                                           long long global_index,
                                           uint32_t row) {
  uint32_t c[4] = {counter_word(global_index), row, 0u, 0u};
  philox4x32_10(c, k0, k1);
  const float two_pi = 6.28318530717958647692f;
  const float u1 = 1.0f - static_cast<float>(c[0] >> 8) * 5.9604644775390625e-08f;
  const float u2 = static_cast<float>(c[1] >> 8) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float z = r * cosf(two_pi * u2);
  return fminf(fmaxf(z, -3.0f), 3.0f);
}

}  // namespace fp

// Clipped N(0,1) draws from a counter-based Philox4x32-10, as device
// functions: the draw backend shared by the stand-alone normals kernel
// (normals.cu) and the fused advance kernel (advance.cu), which makes its
// draws in registers so that they never touch device memory; the
// redistribution kernel (redist.cu) takes its uniforms from it too.
//
// A draw depends on nothing but (key, global particle index, row).  Rows
// come four to a Philox call: rows 4q .. 4q+3 of a particle are made from
// the four words of counter = (global index, q, 0, 0) under key =
// (seed_lo, seed_hi ^ mix(step, tag)), which core/rng.py::Key.philox_key
// makes.  Words (0, 1) give rows 4q and 4q+1, words (2, 3) rows 4q+2 and
// 4q+3: each pair of words is one Box-Muller radius and angle, whose cos
// branch is the even row and whose sin branch is the odd row.  Skipping a
// draw therefore changes no other draw, one Philox call serves four rows
// and one logf/sqrtf/sincosf serves two.
//
// Transform: uniforms from the top 24 bits (exact int->float), u1 -> 1-u1
// in (0, 1] so the log is finite, Box-Muller with the accurate
// logf/sqrtf/sincosf (never --use_fast_math; sincosf is the one
// trigonometric call of every caller, so that all of them round alike),
// clipped to +-3.  The plain twin core/rng.py::normals_plain computes the
// same Philox words bit for bit.
#pragma once
#include <cstdint>

namespace fp {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

// The lane layout of a draw (core/rng.py holds the same two numbers).
constexpr int ROWS_PER_BLOCK = 4;  // rows made by one Philox call
constexpr int ROWS_PER_PAIR = 2;   // rows made by one Box-Muller radius

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

// The four words that make rows 4 * block .. 4 * block + 3 of one particle.
__device__ __forceinline__ void normal_words(uint32_t w[4], uint32_t k0,
                                             uint32_t k1,
                                             long long global_index,
                                             uint32_t block) {
  w[0] = counter_word(global_index);
  w[1] = block;
  w[2] = 0u;
  w[3] = 0u;
  philox4x32_10(w, k0, k1);
}

// One word -> a uniform in [0, 1) from its top 24 bits (exact int->float),
// as core/rng.py::uniforms_plain makes it.
__device__ __forceinline__ float uniform24(uint32_t w) {
  return static_cast<float>(w >> 8) * 5.9604644775390625e-08f;
}

// One pair of words -> the two clipped normals of a pair of rows.
__device__ __forceinline__ void normal_pair(uint32_t wa, uint32_t wb,
                                            float& z_even, float& z_odd) {
  const float two_pi = 6.28318530717958647692f;
  const float u1 = 1.0f - static_cast<float>(wa >> 8) * 5.9604644775390625e-08f;
  const float u2 = static_cast<float>(wb >> 8) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(two_pi * u2, &s, &c);
  z_even = fminf(fmaxf(r * c, -3.0f), 3.0f);
  z_odd = fminf(fmaxf(r * s, -3.0f), 3.0f);
}

}  // namespace fp

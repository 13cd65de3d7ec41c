// K7: convective redistribution of the particles, one thread per particle.
//
// Replaces: flexpart_tpu/physics/convection.py::redist_particles
// (convection.py:453-547, redist.f90), which the JAX package leaves to XLA
// as gathers of whole matrix rows and a cumulative sum per particle.  Its
// plain PyTorch twin is physics/convection.py::redist_plain.  A backward run
// (ldirect = -1) draws against the transposed matrix (convection.py:
// 479-480): its BACKWARD instantiation reads the column fmassfrac[col, :,
// levold], stride L1, where a forward run reads the row fmassfrac[col,
// levold, :]; the rest, the draw and the normalisation by the particle's
// own level mass included, is the same.
//
// What a thread does: the grid column from its rounded position (rintf
// rounds half to even, as jnp.round and torch.round do; roundf would not),
// the particle's level from the column's half-level heights, and, for a
// particle that is scheduled now, sits in a convecting column and below
// its top: a uniform draw (Philox4x32-10 of philox_normal.cuh under its
// own key, counter = the particle's global slot (offset + slot: a rank's
// first slot in a data-parallel run), top 24 bits of word 0, as
// core/rng.py::uniforms_plain makes it; or an injected array) against the
// cumulative row of the column's fmassfrac, summed in level order; the
// first level whose cumulative fraction reaches the draw is the new level,
// and the new height lies inside it, log-p interpolated.  A live particle
// that stays gets the compensating subsidence of its level instead.  Every
// index that the reference clamps is clamped the same way.  The moved
// count is one ballot and one atomic per warp.
//
// Bound on the H100: bytes.  Every particle reads 29 B of state and writes
// 4 B of z; a live particle reads one row of L1 floats of fmassfrac and a
// few dozen floats of its column besides.  Particles outside the
// convecting columns, most of a global ensemble, return after the state
// and one lconv byte.
//
// Staging a warp's columns and matrix rows in shared memory (lanes grouped
// by ballots, one cumulative sum per row) was built and measured against
// this kernel: bitwise the same, no faster on any input the run gives it,
// since the L1 cache already serves the lanes of one column from one line
// (PERF.md, section 6).  It is not kept.
#include <cstdint>
#include <cuda_runtime.h>

#include "philox_normal.cuh"

#define F(x) static_cast<float>(x)

namespace {

constexpr double GA = 9.81;
constexpr double R_AIR = 287.05;

__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct PIn {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const int* itra;
  const uint8_t* active;
};

// The convection kernel's outputs for every column (K6, convection.cu).
struct Conv {
  const float* fmassfrac;   // (C, L1, L1)
  const float* rlevmass;    // (C, L1)
  const float* phconv;      // (C, L1 + 1) hPa
  const float* sub;         // (C, L1)
  const float* uvzlev;      // (C, L1 + 1)
  const float* pconv;       // (C, L1) hPa
  const float* tconv;       // (C, L1)
  const uint8_t* lconv;     // (C,)
};

// rint(v) clamped to [0, hi]: jnp.round, then the int32 clip.
__device__ __forceinline__ int round_index(float v, int hi) {
  float r = rintf(v);
  r = r < 0.0f ? 0.0f : (r > static_cast<float>(hi) ? static_cast<float>(hi) : r);
  return static_cast<int>(r);
}

// -sub / (1 - sub/dpr g) R T(half) / p(half) at half level levi of the
// column (redist.f90:170-215; convection.py wsub_at).
__device__ float wsub_at(const Conv& cv, size_t c1, size_t c2, int levi) {
  const int levim = max(levi - 1, 0);
  const float tk = cv.tconv[c1 + levim];
  const float tk1 = cv.tconv[c1 + levi];
  const float pk = cv.pconv[c1 + levim];
  const float pk1 = cv.pconv[c1 + levi];
  const float phk = cv.phconv[c2 + levi];
  const float t_half = tk + ((tk1 - tk) * (pk - phk)) / tmax(pk - pk1, F(1e-3));
  const float s = cv.sub[c1 + levi];
  const float d = cv.rlevmass[c1 + levi] * F(GA);
  const float s_eff = s / tmax(1.0f - (s / d) * F(GA), F(1e-3));
  return (((-s_eff) * F(R_AIR)) * t_half) / tmax(phk * 100.0f, F(1e-3));
}

template <bool BACKWARD>
__global__ void __launch_bounds__(256)
redist_kernel(const PIn in, const Conv cv, const float* __restrict__ rn_in,
              int n, int nx, int ny, int L1, int itime, float lsync,
              uint32_t k0, uint32_t k1, long long offset,
              float* __restrict__ z_out, int* __restrict__ moved_count) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool moved = false;
  if (i < n) {
    const float z = in.z[i];
    float zo = z;
    if (in.active[i] && in.itra[i] == itime) {
      const float x = in.x_hi[i] + in.x_lo[i];
      const float y = in.y_hi[i] + in.y_lo[i];
      const int col = round_index(y, ny - 1) * nx + round_index(x, nx - 1);
      const size_t c1 = static_cast<size_t>(col) * L1;
      const size_t c2 = static_cast<size_t>(col) * (L1 + 1);
      const float* uvz = cv.uvzlev + c2;
      // levold: the cells whose lower boundary lies below z (redist.f90)
      int levold = 0;
      if (cv.lconv[col])
        for (int k = 1; k < L1; ++k) levold += uvz[k] < z ? 1 : 0;
      const int up_old = min(levold + 1, L1);
      if (cv.lconv[col] && z < uvz[up_old]) {
        // the matrix row of levold (forward), or its column (backward)
        const float* row = BACKWARD ? cv.fmassfrac + c1 * L1 + levold
                                    : cv.fmassfrac + (c1 + levold) * L1;
        const size_t stride = BACKWARD ? L1 : 1;
        const float totmass = tmax(cv.rlevmass[c1 + levold], F(1e-30));
        float rn;
        if (rn_in != nullptr) {
          rn = rn_in[i];
        } else {
          uint32_t w[4];
          fp::normal_words(w, k0, k1, offset + i, 0u);
          rn = fp::uniform24(w[0]);
        }
        // the cumulative row, in level order; the first level it reaches
        // the draw at, else the old level
        int levnew = -1;
        float frac = 0.0f, ffrac_at = 0.0f, f_at = 0.0f, ffrac_old = 0.0f;
        for (int k = 0; k < L1; ++k) {
          const float fk = row[k * stride] / totmass;
          frac = k == 0 ? fk : frac + fk;
          if (k == levold) ffrac_old = frac;
          if (levnew < 0 && frac >= rn) {
            levnew = k;
            ffrac_at = frac;
            f_at = row[k * stride];
          }
        }
        if (levnew < 0) {
          levnew = levold;
          ffrac_at = ffrac_old;
          f_at = row[levold * stride];
        }
        moved = levnew != levold;
        if (moved) {
          // inside the destination cell, uniform in mass, log-p
          // interpolated (redist.f90:140-152)
          float dlevfrac = ffrac_at > F(1e-20)
              ? ((ffrac_at - rn) * totmass) / tmax(f_at * totmass, F(1e-30))
              : 0.5f;
          dlevfrac = tmin(tmax(dlevfrac, 0.0f), 1.0f);
          const int up_new = min(levnew + 1, L1);
          const float log_lo = logf(cv.phconv[c2 + levnew]);
          const float log_hi = logf(cv.phconv[c2 + up_new]);
          const float dlogp = (1.0f - dlevfrac) * (log_hi - log_lo);
          const float pint = log_lo + dlogp;
          const float dz1 = pint - log_lo;
          const float dz2 = log_hi - pint;
          float dz = dz1 + dz2;
          dz = fabsf(dz) > F(1e-20) ? dz : F(-1e-20);
          zo = fabsf((uvz[levnew] * dz2 + uvz[up_new] * dz1) / dz);
        } else {
          // compensating subsidence (redist.f90:170-215)
          const float w_lo = levold > 0 ? wsub_at(cv, c1, c2, max(levold, 1)) : 0.0f;
          const float w_hi = wsub_at(cv, c1, c2, min(levold + 1, L1 - 1));
          const float d1 = z - uvz[levold];
          const float d2 = tmax(uvz[up_old] - z, 0.0f);
          const float wpart = (d2 * w_lo + d1 * w_hi) / tmax(d1 + d2, F(1e-30));
          zo = fabsf(z + wpart * lsync);
        }
      }
    }
    z_out[i] = zo;
  }
  const unsigned m = __ballot_sync(0xFFFFFFFFu, moved);
  if ((threadIdx.x & 31) == 0 && m) atomicAdd(moved_count, __popc(m));
}

}  // namespace

extern "C" int fp_redist(
    const float* x_hi, const float* x_lo, const float* y_hi, const float* y_lo,
    const float* z, const int* itra, const uint8_t* active,
    const float* fmassfrac, const float* rlevmass, const float* phconv,
    const float* sub, const float* uvzlev, const float* pconv,
    const float* tconv, const uint8_t* lconv, const float* rn, int n, int nx,
    int ny, int L1, int itime, float lsync, uint32_t k0, uint32_t k1,
    long long offset, int backward, float* z_out, int* moved, void* stream) {
  if (n <= 0) return 0;
  if (L1 < 2 || nx < 1 || ny < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PIn in = {x_hi, x_lo, y_hi, y_lo, z, itra, active};
  const Conv cv = {fmassfrac, rlevmass, phconv, sub, uvzlev, pconv, tconv, lconv};
  // a thread names its column with int32
  if (static_cast<long long>(nx) * ny >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  auto kern = backward ? redist_kernel<true> : redist_kernel<false>;
  kern<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, cv, rn, n, nx, ny, L1, itime, lsync, k0, k1, offset, z_out, moved);
  return static_cast<int>(cudaGetLastError());
}

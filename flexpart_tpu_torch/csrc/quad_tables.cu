// K2: the per-step quad-corner row tables (rows, rowsE).
//
// Replaces: flexpart_tpu/core/interp.py::build_step_tables_quad with
// blend_wind_stack, _corners4 and _cell_sigma8 (which JAX leaves to XLA).
// Row r = (k, y, x) over R = (nz-1)*ny*nx cells; lane = q*4 + c with q over
// (u0,u1,v0,v1,w0,w1,rho0,rho1,drho0,drho1, hmix-max, tropo(t0), ustar_t,
// wstar_t, oli_t) and c over the corners (y,x),(y,x+1),(y+1,x),(y+1,x+1)
// (x+1 cyclic, y+1 clamped).  Lanes 60-62 hold the per-cell 8-sample wind
// sigmas, lane 63 is zero; rowsE holds the end-time u,v,w pairs in lanes
// 0-23 and zeros in 24-63.
//
// Bound on the H100: the stores (2 x R x 64 values per step: 485 MB in
// bf16, 970 MB in f32 on the 361x181x30 grid); the inputs are two met
// levels (~70 MB each) read through L2.  Design: one thread per
// (row, lane) with the lane fastest, so a warp stores 32 consecutive
// lanes of one row; rows and rowsE are written by the same thread.
//
// Arithmetic is the plain twin's, in the same order and without FMA
// contraction (built with -fmad=false): z0*tw0 + z1*tw1 per value, the
// sigma sums left to right, f32 -> bf16 round-to-nearest-even.  Kernel
// and twin are therefore bitwise equal in f32 and in bf16.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int F3_U = 0;
constexpr int F2_HMIX = 1, F2_TROPO = 2, F2_USTAR = 3;

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geo {
  int nz, ny, nx;
  long long plane;  // ny * nx
};

// std over 4 corners x 2 time levels of one field at one level
// (interpol_all.f90:216-240), sums left to right as in the twin
__device__ __forceinline__ float sigma8(const float* a, const float* b,
                                        const long long* idx) {
  const float a0 = a[idx[0]], a1 = a[idx[1]], a2 = a[idx[2]], a3 = a[idx[3]];
  const float b0 = b[idx[0]], b1 = b[idx[1]], b2 = b[idx[2]], b3 = b[idx[3]];
  const float sa = ((a0 + a1) + a2) + a3;
  const float sb = ((b0 + b1) + b2) + b3;
  const float sl = sa + sb;
  const float qa = ((a0 * a0 + a1 * a1) + a2 * a2) + a3 * a3;
  const float qb = ((b0 * b0 + b1 * b1) + b2 * b2) + b3 * b3;
  const float sq = qa + qb;
  const float var = sq - sl * sl / 8.0f;
  return var < 1.0e-30f ? 0.0f : sqrtf(fmaxf(var, 0.0f) / 7.0f);
}

template <typename T>
__global__ void quad_tables_kernel(const float* __restrict__ f3d0,
                                   const float* __restrict__ f3d1,
                                   const float* __restrict__ f2d0,
                                   const float* __restrict__ f2d1, Geo g,
                                   float tw0, float tw1, float ew0, float ew1,
                                   T* __restrict__ rows, T* __restrict__ rowsE,
                                   long long n_rows) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_rows * 64) return;
  // row decomposition in 32-bit arithmetic (n_rows < 2^31 is checked by
  // the host function); 64-bit integer division is emulated and slow
  const unsigned r = static_cast<unsigned>(t >> 6);
  const int lane = static_cast<int>(t & 63);
  const unsigned plane = static_cast<unsigned>(g.plane);
  const unsigned nx = static_cast<unsigned>(g.nx);
  const unsigned k = r / plane;
  const unsigned rem = r - k * plane;
  const int j = static_cast<int>(rem / nx);
  const int i = static_cast<int>(rem - static_cast<unsigned>(j) * nx);
  const int ip = (i + 1 == g.nx) ? 0 : i + 1;
  const int jp = (j + 1 < g.ny) ? j + 1 : g.ny - 1;
  // corner offsets within one (ny, nx) plane, in lane order
  long long cidx[4] = {static_cast<long long>(j) * g.nx + i,
                       static_cast<long long>(j) * g.nx + ip,
                       static_cast<long long>(jp) * g.nx + i,
                       static_cast<long long>(jp) * g.nx + ip};
  const long long vol = static_cast<long long>(g.nz) * g.plane;

  float v = 0.0f;
  float e = 0.0f;
  if (lane < 60) {
    const int q = lane >> 2;
    const long long c = cidx[lane & 3];
    if (q < 10) {
      const int f = F3_U + (q >> 1);  // u, v, w, rho, drhodz
      const long long o = f * vol + static_cast<long long>(k + (q & 1)) * g.plane + c;
      v = f3d0[o] * tw0 + f3d1[o] * tw1;
    } else if (q == 10) {
      v = fmaxf(f2d0[F2_HMIX * g.plane + c], f2d1[F2_HMIX * g.plane + c]);
    } else if (q == 11) {
      v = f2d0[F2_TROPO * g.plane + c];
    } else {
      const long long o = (F2_USTAR + (q - 12)) * g.plane + c;  // ustar, wstar, oli
      v = f2d0[o] * tw0 + f2d1[o] * tw1;
    }
    if (q < 6) {  // end-time u, v, w pairs
      const long long o = (q >> 1) * vol + static_cast<long long>(k + (q & 1)) * g.plane + c;
      e = f3d0[o] * ew0 + f3d1[o] * ew1;
    }
  } else if (lane < 63) {
    // per-cell 8-sample sigma of u, v or w, averaged over levels k, k+1
    const long long fo = static_cast<long long>(lane - 60) * vol;
    long long lo[4], hi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = fo + static_cast<long long>(k) * g.plane + cidx[c];
      hi[c] = lo[c] + g.plane;
    }
    const float s0 = sigma8(f3d0, f3d1, lo);
    const float s1 = sigma8(f3d0, f3d1, hi);
    v = 0.5f * (s0 + s1);
  }
  rows[t] = to_out<T>(v);
  rowsE[t] = to_out<T>(e);
}

}  // namespace

extern "C" int fp_quad_tables(const float* f3d0, const float* f3d1,
                              const float* f2d0, const float* f2d1, int nz,
                              int ny, int nx, float tw0, float tw1, float ew0,
                              float ew1, int out_bf16, void* rows, void* rowsE,
                              void* stream) {
  Geo g{nz, ny, nx, static_cast<long long>(ny) * nx};
  const long long n_rows = static_cast<long long>(nz - 1) * g.plane;
  if (n_rows <= 0) return 0;
  if (n_rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (n_rows * 64 + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    quad_tables_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        f3d0, f3d1, f2d0, f2d1, g, tw0, tw1, ew0, ew1,
        static_cast<__nv_bfloat16*>(rows), static_cast<__nv_bfloat16*>(rowsE), n_rows);
  } else {
    quad_tables_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        f3d0, f3d1, f2d0, f2d1, g, tw0, tw1, ew0, ew1,
        static_cast<float*>(rows), static_cast<float*>(rowsE), n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

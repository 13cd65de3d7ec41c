// Block-wide helpers of the kernels that rank flags by a scan (K13's
// splitting, K14's boundary emission): the sum of 16 flag bytes, and an
// exclusive scan of two ints over a block.
#pragma once
#include <cstdint>

namespace fp {

// the 16 flag bytes of one thread, summed
__device__ __forceinline__ int byte_sum(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  int t = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) t += __popc(w[i]);   // bytes are 0 or 1
  return t;
}

// exclusive scan of (a, b) over the block; the block's totals in *ta, *tb
template <int NT>
__device__ __forceinline__ void block_scan2(int& a, int& b, int* ta, int* tb) {
  __shared__ int sa[NT / 32], sb[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;                      // inclusive within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int xa = __shfl_up_sync(0xffffffffu, ia, off);
    const int xb = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    sa[warp] = ia;
    sb[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int va = lane < NT / 32 ? sa[lane] : 0;
    int vb = lane < NT / 32 ? sb[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int xa = __shfl_up_sync(0xffffffffu, va, off);
      const int xb = __shfl_up_sync(0xffffffffu, vb, off);
      if (lane >= off) {
        va += xa;
        vb += xb;
      }
    }
    if (lane < NT / 32) {
      sa[lane] = va;                       // inclusive over the warps
      sb[lane] = vb;
    }
  }
  __syncthreads();
  const int wa = warp > 0 ? sa[warp - 1] : 0;
  const int wb = warp > 0 ? sb[warp - 1] : 0;
  *ta = sa[NT / 32 - 1];
  *tb = sb[NT / 32 - 1];
  a = wa + ia - a;
  b = wb + ib - b;
  __syncthreads();                         // sa, sb are reused by a caller
}

}  // namespace fp

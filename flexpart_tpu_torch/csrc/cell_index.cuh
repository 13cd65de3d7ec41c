// The met cell of a particle: horizontal corner and bilinear weights,
// bracketing level and its weight, and the row of the quad tables that
// the cell names.  Shared by the advance kernel (advance.cu), which
// gathers that row, and the cell-order sort (reorder.cu), whose key it
// is, so that both name the same row for the same particle.  The plain
// versions are core/interp.py::horiz_weights, vert_weights, _cell_rowid.
#pragma once
#include <cstddef>

namespace fp {

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int floor(x) clipped to [0, hi], total for any float input (NaN -> 0).
__device__ __forceinline__ int floor_index(float x, int hi) {
  const float f = fminf(fmaxf(floorf(x), 0.0f), static_cast<float>(hi));
  return min(max(static_cast<int>(f), 0), hi);
}

struct Horiz {
  int ix, jy;
  float p4[4];
};

__device__ __forceinline__ Horiz horiz_weights(float x, float y, int nx, int ny) {
  Horiz hw;
  hw.ix = floor_index(x, nx - 2);
  hw.jy = floor_index(y, ny - 2);
  const float ddx = clamp(x - static_cast<float>(hw.ix), 0.0f, 1.0f);
  const float ddy = clamp(y - static_cast<float>(hw.jy), 0.0f, 1.0f);
  const float rddx = 1.0f - ddx;
  const float rddy = 1.0f - ddy;
  hw.p4[0] = rddx * rddy;
  hw.p4[1] = ddx * rddy;
  hw.p4[2] = rddx * ddy;
  hw.p4[3] = ddx * ddy;
  return hw;
}

// searchsorted(height, z, right=True) - 1 clamped to [0, nz-2], and the
// upper-level weight.
__device__ __forceinline__ void vert_weights(const float* sh_height, int nz,
                                             float z, int& indz, float& dz1) {
  int lo = 0, hi = nz;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(sh_height[mid] > z)) lo = mid + 1; else hi = mid;
  }
  indz = min(max(lo - 1, 0), nz - 2);
  const float h0 = sh_height[indz];
  const float h1 = sh_height[indz + 1];
  dz1 = clamp((z - h0) / (h1 - h0), 0.0f, 1.0f);
}

// Row of the (R, lanes) quad tables for cell (indz, jy, ix), R = (nz-1)*ny*nx.
__device__ __forceinline__ size_t cell_row(int indz, int jy, int ix, int ny,
                                           int nx) {
  return static_cast<size_t>(indz) * (ny * nx)
         + static_cast<size_t>(jy) * nx + ix;
}

}  // namespace fp

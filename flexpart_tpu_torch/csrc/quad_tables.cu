// K2: the per-step quad-corner row tables (rows, rowsE).
//
// Replaces: flexpart_tpu/core/interp.py::build_step_tables_quad with
// blend_wind_stack, _corners4 and _cell_sigma8 (which JAX leaves to XLA).
// Row r = (k, y, x) over R = (nz-1)*ny*nx cells.  rows has 64 lanes,
// lane = q*4 + c with q over (u0,u1,v0,v1,w0,w1,rho0,rho1,drho0,drho1,
// hmix-max, tropo(t0), ustar_t, wstar_t, oli_t) and c over the corners
// (y,x),(y,x+1),(y+1,x),(y+1,x+1) (x+1 cyclic, y+1 clamped); lanes 60-62
// hold the per-cell 8-sample wind sigmas, lane 63 is zero.  rowsE has 32
// lanes: the end-time u,v,w pairs in lanes 0-23 and zeros in 24-31, so a
// bf16 row is the two 32 B sectors the advance kernel fetches.
//
// Bound on the H100: bytes.  Every grid value is a corner of 4 cells and a
// level of 2 rows, so the tables are 8 times their input: two met levels
// (81 MB on the 361x181x30 grid) in, 2 B x (64 + 32) lanes x R out (364 MB
// in bf16).  The stores are the work; the reads must not cost more.
//
// Design: a block owns one y and a strip of TX cells in x and marches up
// the levels.  For each level it loads rows y and y+1 of the five
// three-dimensional fields at both met times, TX+1 columns (the halo
// column is x+1), coalesced along x, and blends each grid point once into
// a tile in shared memory (interval start for all five, interval end for
// u, v, w); the raw u, v, w of both times go to shared memory too and give
// the 8-sample sigma of each cell at that level, once.  Two tiles are kept:
// the tile of level k+1 stays and is level k of the next row, so a grid
// value is read once per block (twice in all: by the blocks of y and y-1).
// The loads of level k+1 are started into registers before the rows of
// level k-1 are stored, so they fly during the stores.  A thread stores 8
// consecutive lanes at a time, 16 B in bf16 and 32 B in f32, eight threads
// to a row, so a warp writes four whole rows.  The five two-dimensional
// fields are loaded once per block.  Row starts of the grid (nx = 361
// floats) are not 16 B aligned, so the loads are 4 B each.
//
// Arithmetic is the plain version's, in the same order and without FMA
// contraction (built with -fmad=false): z0*tw0 + z1*tw1 per value, the
// sigma sums left to right with true divisions by 8 and 7, f32 -> bf16
// round-to-nearest-even.  Kernel and plain version are therefore bitwise
// equal in f32 and in bf16.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int F2_HMIX = 1, F2_TROPO = 2, F2_USTAR = 3;
constexpr int TX = 128;             // cells of one block's strip along x
constexpr int TC = TX + 1;          // columns: the strip and its x+1 halo
constexpr int THREADS = 256;
constexpr int N3 = 5;               // u, v, w, rho, drhodz
constexpr int N3E = 3;              // u, v, w: end-time blend and sigma
constexpr int N2 = 5;               // hmix-max, tropo, ustar, wstar, oli
constexpr int ITEMS3 = N3 * 2 * TC;   // (field, row y / y+1, column)
constexpr int ITEMS3E = N3E * 2 * TC;
constexpr int LOADS = (ITEMS3 + THREADS - 1) / THREADS;

struct Geo {
  int nz, ny, nx;
  long long plane;  // ny * nx
};

// One level of a block's strip, indexed (field * 2 + row) * TC + column.
struct Tile {
  float bl[ITEMS3];      // blend at the interval start
  float be[ITEMS3E];     // u, v, w blend at the interval end
  float sg[N3E * TX];    // 8-sample sigma of u, v, w per cell
};

struct Smem {
  Tile lev[2];             // level k in lev[k & 1]
  float raw[2][ITEMS3E];   // u, v, w at the two met times, newest level
  float s2[N2 * 2 * TC];   // the two-dimensional lanes
};

// std over 4 corners x 2 time levels of one field at one level
// (interpol_all.f90:216-240), sums left to right as in the plain version;
// a, b: the field's two rows of TC columns at the two met times
__device__ __forceinline__ float sigma8(const float* a, const float* b, int c) {
  const float a0 = a[c], a1 = a[c + 1], a2 = a[TC + c], a3 = a[TC + c + 1];
  const float b0 = b[c], b1 = b[c + 1], b2 = b[TC + c], b3 = b[TC + c + 1];
  const float sa = ((a0 + a1) + a2) + a3;
  const float sb = ((b0 + b1) + b2) + b3;
  const float sl = sa + sb;
  const float qa = ((a0 * a0 + a1 * a1) + a2 * a2) + a3 * a3;
  const float qb = ((b0 * b0 + b1 * b1) + b2 * b2) + b3 * b3;
  const float sq = qa + qb;
  const float var = sq - sl * sl / 8.0f;
  return var < 1.0e-30f ? 0.0f : sqrtf(fmaxf(var, 0.0f) / 7.0f);
}

// the 4 corners of cell c from two rows of TC columns
__device__ __forceinline__ void corners(const float* rows2, int c, float* out) {
  out[0] = rows2[c];
  out[1] = rows2[c + 1];
  out[2] = rows2[TC + c];
  out[3] = rows2[TC + c + 1];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16);
}

// 8 consecutive lanes of one row: 32 B in f32, 16 B in bf16
__device__ __forceinline__ void store8(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quad_tables_kernel(const float* __restrict__ f3d0, const float* __restrict__ f3d1,
                   const float* __restrict__ f2d0, const float* __restrict__ f2d1,
                   Geo g, int strips, float tw0, float tw1, float ew0, float ew1,
                   T* __restrict__ rows, T* __restrict__ rowsE) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int j = static_cast<int>(blockIdx.x) / strips;
  const int i0 = (static_cast<int>(blockIdx.x) - j * strips) * TX;
  const int ncell = min(TX, g.nx - i0);
  const int jp = (j + 1 < g.ny) ? j + 1 : g.ny - 1;
  const long long vol = static_cast<long long>(g.nz) * g.plane;

  // offset of item (field, row, column) inside level 0; column ncell of
  // the last strip is the cyclic x+1 of the last cell, column 0 of the grid
  auto in_plane = [&](int rc) -> long long {   // rc = row * TC + column
    const int r = rc / TC;
    const int c = rc - r * TC;
    int gi = i0 + c;
    if (gi >= g.nx) gi -= g.nx;
    return static_cast<long long>(r ? jp : j) * g.nx + gi;
  };

  // this thread's items of a level: tid, tid + THREADS, ...
  long long base[LOADS];
  float r0[LOADS], r1[LOADS];
#pragma unroll
  for (int n = 0; n < LOADS; ++n) {
    const int item = tid + n * THREADS;
    base[n] = -1;
    if (item < ITEMS3) {
      const int f = item / (2 * TC);
      const int rc = item - f * (2 * TC);
      if (rc % TC <= ncell) base[n] = f * vol + in_plane(rc);
    }
  }
  auto prefetch = [&](int k) {
#pragma unroll
    for (int n = 0; n < LOADS; ++n) {
      if (base[n] >= 0) {
        const long long o = base[n] + k * g.plane;
        r0[n] = f3d0[o];
        r1[n] = f3d1[o];
      }
    }
  };
  prefetch(0);

  // the two-dimensional lanes, once per block
  for (int item = tid; item < N2 * 2 * TC; item += THREADS) {
    const int q = item / (2 * TC);
    const int rc = item - q * (2 * TC);
    if (rc % TC > ncell) continue;
    const long long c = in_plane(rc);
    float v;
    if (q == 0) {
      v = fmaxf(f2d0[F2_HMIX * g.plane + c], f2d1[F2_HMIX * g.plane + c]);
    } else if (q == 1) {
      v = f2d0[F2_TROPO * g.plane + c];
    } else {
      const long long o = (F2_USTAR + (q - 2)) * g.plane + c;  // ustar, wstar, oli
      v = f2d0[o] * tw0 + f2d1[o] * tw1;
    }
    sm.s2[item] = v;
  }

  for (int k = 0; k < g.nz; ++k) {
    Tile& cur = sm.lev[k & 1];
    // blend level k once per grid point
#pragma unroll
    for (int n = 0; n < LOADS; ++n) {
      if (base[n] >= 0) {
        const int item = tid + n * THREADS;
        cur.bl[item] = r0[n] * tw0 + r1[n] * tw1;
        if (item < ITEMS3E) {
          cur.be[item] = r0[n] * ew0 + r1[n] * ew1;
          sm.raw[0][item] = r0[n];
          sm.raw[1][item] = r1[n];
        }
      }
    }
    __syncthreads();
    if (k + 1 < g.nz) prefetch(k + 1);   // in flight during the stores below

    for (int item = tid; item < N3E * TX; item += THREADS) {
      const int f = item / TX;
      const int c = item - f * TX;
      if (c < ncell)
        cur.sg[item] = sigma8(&sm.raw[0][f * 2 * TC], &sm.raw[1][f * 2 * TC], c);
    }
    __syncthreads();

    if (k >= 1) {
      // rows of level k-1: lower tile lo, upper tile cur
      const Tile& lo = sm.lev[(k - 1) & 1];
      const long long row0 =
          (static_cast<long long>(k - 1) * g.ny + j) * g.nx + i0;
      for (int it = tid; it < ncell * 8; it += THREADS) {
        const int c = it >> 3;
        const int v = it & 7;
        float val[8];
        if (v < N3) {
          corners(&lo.bl[v * 2 * TC], c, &val[0]);
          corners(&cur.bl[v * 2 * TC], c, &val[4]);
        } else {
          corners(&sm.s2[(2 * (v - N3)) * 2 * TC], c, &val[0]);
          if (v < 7) {
            corners(&sm.s2[(2 * (v - N3) + 1) * 2 * TC], c, &val[4]);
          } else {
            // per-cell sigmas of u, v, w averaged over the level pair
#pragma unroll
            for (int f = 0; f < N3E; ++f)
              val[4 + f] = 0.5f * (lo.sg[f * TX + c] + cur.sg[f * TX + c]);
            val[7] = 0.0f;
          }
        }
        store8(rows + (row0 + c) * 64 + v * 8, val);
      }
      for (int it = tid; it < ncell * 4; it += THREADS) {
        const int c = it >> 2;
        const int v = it & 3;
        float val[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (v < N3E) {
          corners(&lo.be[v * 2 * TC], c, &val[0]);
          corners(&cur.be[v * 2 * TC], c, &val[4]);
        }
        store8(rowsE + (row0 + c) * 32 + v * 8, val);
      }
    }
    __syncthreads();   // the next level overwrites lo and raw
  }
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
  const int strips = (nx + TX - 1) / TX;
  const long long blocks = static_cast<long long>(ny) * strips;
  if (n_rows >= (1LL << 31) || blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    quad_tables_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        f3d0, f3d1, f2d0, f2d1, g, strips, tw0, tw1, ew0, ew1,
        static_cast<__nv_bfloat16*>(rows), static_cast<__nv_bfloat16*>(rowsE));
  } else {
    quad_tables_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        f3d0, f3d1, f2d0, f2d1, g, strips, tw0, tw1, ew0, ew1,
        static_cast<float*>(rows), static_cast<float*>(rowsE));
  }
  return static_cast<int>(cudaGetLastError());
}

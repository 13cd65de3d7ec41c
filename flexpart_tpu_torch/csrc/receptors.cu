// K15: receptor sampling, the Epanechnikov kernel-density sum of the live
// particles' mass at R fixed receptor points, scaled by 2 weight / area.
//
// Replaces: flexpart_tpu/grid/receptors.py::sample_receptors (:52-75;
// conccalc.f90:430-498), which JAX leaves to XLA as an (R, N) matrix of
// kernel weights times the (N, nspec) mass: 1.3 GB at 10 x 2**20
// particles and 32 receptors.
//
// Design: one thread per particle; nothing of size N x R is stored.  A
// particle is live if active and itra == itime; its kernel's half widths
// grow with its age (hx, hy in grid units, hz in metres, capped at 6, 4 and
// 150), and it adds xkern * mass[k] to receptor r where
// r2 = ((x - rx) / hx)**2 + ((y - ry) / hy)**2 + (z / hz)**2 < 1, with
// xkern = 15 / (8 pi) (1 - r2) / (hx hy hz).
//
// Few pairs are inside (a receptor's kernel is 50-150 m deep and the air
// of a domain fill fills the column), so the kernel decides exactly,
// before any division, which pairs cannot be: r2 = (xd xd + yd yd) + zd zd
// has terms of at least 0 and rounding to nearest is monotone, so where
// one quotient has |q| >= 1, r2 >= 1.  With the float differences the
// division takes, |x - rx| >= |hx| gives |fl((x - rx) / hx)| >= 1, and so
// do y against hy and |z| >= hz (a NaN fails every test, as it fails
// r2 < 1).  A lane is near where its particle is live and |z| < hz (hz is
// at most HZMAX, so a particle at |z| >= HZMAX reads no age); a pair is a
// candidate where the lane is near and |x - rx| < |hx|, |y - ry| < |hy|
// (grid/receptors.py::may_be_inside is this gate in torch):
//  1. a block with no near lane writes its zero partials and ends; a warp
//     with none writes zero warp partials (particles in cell order share a
//     level, so most warps end here).  A thread loads active, itra and z at
//     once, a dead slot's z too;
//  2. a warp with near lanes takes the box of their x and y and their
//     widest |hx| and |hy|; lane j tests receptor j (and j + 32) against
//     it: where fl(xmin - rx) >= max |hx| or fl(xmax - rx) <= -max |hx| (or
//     the same in y), no lane is a candidate, because fl(x - rx) is
//     monotone in x.  No margin is needed;
//  3. for each receptor the box reaches, in order, each lane's two
//     horizontal tests and a ballot; the divisions, r2, xkern, the mass
//     load and the shuffle tree run only where the candidates' ballot and
//     then the inside ballot are not empty.
// Every skipped pair would have added exactly +0.0, which a warp with no
// lane inside writes, so the kernel adds what the first K15 added, in its
// order, bit for bit.
//
// The sum has a fixed order, so two runs agree bit for bit and the plain
// version (grid/receptors.py::ordered_sum) adds in the same order:
//  1. per (receptor, species), the 32 lanes of a warp by a shuffle-down
//     tree (offsets 16, 8, 4, 2, 1); a warp in which no lane is inside
//     writes 0;
//  2. the 8 warp partials of a block, in warp order, into the block's
//     partial (partials[(r * nspec + k) * blocks + block]);
//  3. a second launch, one block of 256 threads per (receptor, species):
//     thread t adds the partials t, t + 256, ... in order, then a
//     shared-memory tree over the 256 (offsets 128 ... 1);
//     out = creceptor + (2 weight) c / area.
// The warp partials of a block are in dynamic shared memory, 8 x R x nspec
// floats (at most 48 KiB: R x nspec <= 1536).
//
// Arithmetic: the plain version's float32 operations in its order; the
// build has -fmad=false and no fast math, so sqrtf and the divisions are
// the correctly rounded ones.
//
// Bound on the H100, by what the sampling needs: every slot's active and
// itra, a live one's z, its itramem where |z| < HZMAX, a near one's x and
// y (hi and lo), the mass of a particle inside some receptor's kernel and
// each block's partial of every (receptor, species) once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_RECEPTORS = 64;        // grid/receptors.py MAX_RECEPTORS
constexpr int MAX_VALUES = 1536;         // R x nspec, MAX_RECEPTOR_VALUES
constexpr float EPANECHNIKOV = 0.596831f;
constexpr float HZMAX = 150.0f;          // grid/receptors.py HZMAX: hz's cap
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Inputs {
  const float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  const int *itra, *itramem;
  const bool* active;
  const float* mass;                      // (n, nspec)
  const float *rx, *ry;                   // (R,)
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__global__ void __launch_bounds__(THREADS)
receptor_partials_kernel(const Inputs in, int n, int nspec, int nrec,
                         int itime, float dx, float dy,
                         float* __restrict__ partials, int blocks) {
  extern __shared__ float warp_part[];    // (WARPS, nrec * nspec)
  __shared__ float srx[MAX_RECEPTORS], sry[MAX_RECEPTORS];
  const int nv = nrec * nspec;
  for (int i = threadIdx.x; i < nrec; i += THREADS) {
    srx[i] = in.rx[i];
    sry[i] = in.ry[i];
  }
  const int k = blockIdx.x * THREADS + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  // near: live and |z| < hz, the only particles that can be inside.
  // active, itra and z are loaded at once (a dead slot's z too): one
  // round of loads, not a chain of three
  bool near = false;
  float z = 0.0f, hx = 1.0f, hy = 1.0f, hz = 1.0f;
  if (k < n) {
    const bool active = in.active[k];
    const int itra = in.itra[k];
    z = in.z[k];
    if (active && itra == itime && fabsf(z) < HZMAX) {
      const int d = itra - in.itramem[k];
      const float itage = static_cast<float>(d < 0 ? -d : d);
      const float s = sqrtf(itage);
      hz = fminf(50.0f + 0.3f * s, 150.0f);
      hx = fminf((0.29f + 2.222e-3f * s) * dx + itage * 1.2e-5f, 6.0f);
      hy = fminf((0.18f + 1.389e-3f * s) * dy + itage * 7.5e-6f, 4.0f);
      near = fabsf(z) < hz;
    }
  }
  // a block with no near lane adds nothing: its partials are +0
  if (!__syncthreads_or(near)) {
    for (int i = threadIdx.x; i < nv; i += THREADS)
      partials[static_cast<long long>(i) * blocks + blockIdx.x] = 0.0f;
    return;
  }
  float* mine = warp_part + warp * nv;
  for (int i = lane; i < nv; i += 32) mine[i] = 0.0f;
  __syncwarp();
  if (__any_sync(FULL, near)) {
    float x = 0.0f, y = 0.0f;
    if (near) {
      x = in.x_hi[k] + in.x_lo[k];
      y = in.y_hi[k] + in.y_lo[k];
    }
    // the near lanes' box and their widest half widths (a NaN x or y is
    // left out by fminf / fmaxf: such a lane is never a candidate)
    const float inf = __int_as_float(0x7f800000);
    const float xmin = warp_min(near ? x : inf);
    const float xmax = warp_max(near ? x : -inf);
    const float ymin = warp_min(near ? y : inf);
    const float ymax = warp_max(near ? y : -inf);
    const float hxm = warp_max(near ? fabsf(hx) : 0.0f);
    const float hym = warp_max(near ? fabsf(hy) : 0.0f);
    const float zd = z / hz;
    const float hxyz = hx * hy * hz;
    for (int h = 0; h * 32 < nrec; ++h) {
      // the receptors h * 32 .. h * 32 + 31 that the box reaches
      const int j = h * 32 + static_cast<int>(lane);
      bool reach = false;
      if (j < nrec)
        reach = xmin - srx[j] < hxm && xmax - srx[j] > -hxm &&
                ymin - sry[j] < hym && ymax - sry[j] > -hym;
      for (unsigned left = __ballot_sync(FULL, reach); left != 0u;
           left &= left - 1u) {
        const int r = h * 32 + __ffs(left) - 1;
        const float ex = x - srx[r];
        const float ey = y - sry[r];
        const bool cand =
            near && fabsf(ex) < fabsf(hx) && fabsf(ey) < fabsf(hy);
        if (!__any_sync(FULL, cand)) continue;
        float xkern = 0.0f;
        bool inside = false;
        if (cand) {
          const float xd = ex / hx;
          const float yd = ey / hy;
          const float r2 = xd * xd + yd * yd + zd * zd;
          inside = r2 < 1.0f;
          xkern = EPANECHNIKOV * (1.0f - r2) / hxyz;
        }
        if (!__any_sync(FULL, inside)) continue;
        for (int s = 0; s < nspec; ++s) {
          const long long at = static_cast<long long>(k) * nspec + s;
          float v = inside ? xkern * in.mass[at] : 0.0f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(FULL, v, off);
          if (lane == 0) mine[r * nspec + s] = v;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    float t = warp_part[i];
    for (int w = 1; w < WARPS; ++w) t += warp_part[w * nv + i];
    partials[static_cast<long long>(i) * blocks + blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
receptor_reduce_kernel(const float* __restrict__ partials, int blocks,
                       const float* __restrict__ area, int nspec,
                       const float* __restrict__ creceptor, float two_weight,
                       float* __restrict__ out) {
  __shared__ float sh[REDUCE_THREADS];
  const int i = blockIdx.x;               // r * nspec + k
  const float* row = partials + static_cast<long long>(i) * blocks;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += REDUCE_THREADS) acc += row[b];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    out[i] = creceptor[i] + two_weight * sh[0] / area[i / nspec];
}

}  // namespace

// particles: x_hi, x_lo, y_hi, y_lo, z (n,) f32, itra, itramem (n,) i32,
// active (n,) bool, mass (n, nspec) f32; receptors rx, ry, area (nrec,)
// f32; creceptor (nrec, nspec) f32 in; partials (nrec * nspec * blocks,)
// f32 scratch, blocks = ceil(n / 256); out (nrec, nspec) f32
extern "C" int fp_receptors(const float* x_hi, const float* x_lo,
                            const float* y_hi, const float* y_lo,
                            const float* z, const int* itra,
                            const int* itramem, const bool* active,
                            const float* mass, const float* rx,
                            const float* ry, const float* area, int n,
                            int nspec, int nrec, int itime, float dx,
                            float dy, float two_weight,
                            const float* creceptor, float* partials,
                            int blocks, float* out, void* stream) {
  if (nrec <= 0 || nspec <= 0) return 0;
  if (nrec > MAX_RECEPTORS || nrec * nspec > MAX_VALUES || n < 0 ||
      blocks != (n + THREADS - 1) / THREADS + (n == 0 ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in = {x_hi, x_lo, y_hi, y_lo, z, itra, itramem, active,
                     mass, rx, ry};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shared = sizeof(float) * WARPS * nrec * nspec;
  receptor_partials_kernel<<<blocks, THREADS, shared, st>>>(
      in, n, nspec, nrec, itime, dx, dy, partials, blocks);
  receptor_reduce_kernel<<<nrec * nspec, REDUCE_THREADS, 0, st>>>(
      partials, blocks, area, nspec, creceptor, two_weight, out);
  return static_cast<int>(cudaGetLastError());
}

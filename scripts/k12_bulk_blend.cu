// A variant of K12 (csrc/ohreaction.cu) for scripts/torch_k4n_k12_ab.py:
// the blended OH field written once per call by a launch of its own into
// a scratch buffer, and pulled by each block of the particle kernel with
// one bulk asynchronous copy (cp.async.bulk, completing on an mbarrier)
// while its threads fill the axes and prefetch their first particle's
// fields into L2.  The particle work is csrc/ohreaction.cu's (react), so
// the result is the same bits.  Exports fp_ohreaction_bulk: fp_ohreaction's
// arguments, then the scratch buffer (nxo * nyo * nzo floats, 16 B
// aligned), then the stream.
#include "ohreaction.cu"

namespace {

__global__ void blend_kernel(const float* __restrict__ oh0,
                             const float* __restrict__ oh1, const Cfg c,
                             float* __restrict__ out) {
  const int cells = c.nxo * c.nyo * c.nzo;
  const float w = hour_weight(c);
  const float w1 = 1.0f - w;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += gridDim.x * blockDim.x)
    out[i] = blend(oh0[i], oh1[i], w1, w);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <bool SCAN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bulk_kernel(const In in, const Cfg c, const Specs sp,
            const float* __restrict__ blended, float* __restrict__ mass_out) {
  extern __shared__ __align__(16) float bulk_sh[];
  __shared__ __align__(8) unsigned long long bar;
  const Shared s = carve(bulk_sh, c);
  const int naxes = c.nxo + c.nyo + c.nzo;
  const unsigned bytes = sizeof(float) * c.nxo * c.nyo * c.nzo;
  const unsigned bar_at = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_at));
    asm volatile("fence.proxy.async.shared::cta;");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_at),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(static_cast<unsigned>(
            __cvta_generic_to_shared(s.oh))),
        "l"(blended), "r"(bytes), "r"(bar_at)
        : "memory");
  }
  for (int i = threadIdx.x; i < naxes; i += THREADS) s.lon[i] = in.axes[i];
  for (int i = threadIdx.x; i < c.nz; i += THREADS) s.h[i] = in.height[i];
  const int first = blockIdx.x * THREADS + threadIdx.x;
  if (first < c.n) {
    prefetch_l2(in.x_hi + first);
    prefetch_l2(in.x_lo + first);
    prefetch_l2(in.y_hi + first);
    prefetch_l2(in.y_lo + first);
    prefetch_l2(in.z + first);
  }
  __syncthreads();
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar_at)
        : "memory");
  const float dt = static_cast<float>(c.ltsample);
  const int stride = gridDim.x * THREADS;
  for (int p = first; p < c.n; p += stride)
    react<SCAN>(in, c, sp, s, dt, p, mass_out);
}

int bulk_plan(bool scan, const Cfg& c, Plan& out) {
  return scan ? plan(bulk_kernel<true>, 1, c, out)
              : plan(bulk_kernel<false>, 0, c, out);
}

}  // namespace

extern "C" int fp_ohreaction_bulk(
    const float* x_hi, const float* x_lo, const float* y_hi,
    const float* y_lo, const float* z, const bool* active, const float* mass,
    const float* tt, const float* height, int nz, int ny, int nx,
    float xlon0, float ylat0, float dx, float dy, const float* axes, int nxo,
    int nyo, int nzo, const float* oh0, const float* oh1, int itime, int t0,
    int t1, const void* specs_in, int n, int nspec, int ltsample, int scan,
    float* mass_out, float* blended, void* stream) {
  if (n <= 0) return 0;
  if (nspec < 1 || nspec > MAX_SPECIES || nz < 2 || ny < 1 || nx < 1 ||
      nxo < 1 || nyo < 1 || nzo < 1 || t1 == t0 ||
      (reinterpret_cast<uintptr_t>(blended) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cfg c = make_cfg(nz, ny, nx, xlon0, ylat0, dx, dy, nxo, nyo, nzo,
                         itime, t0, t1, n, nspec, ltsample);
  if ((sizeof(float) * nxo * nyo * nzo) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = bulk_plan(scan != 0, c, pl);
  if (err != 0) return err;
  Specs sp{};
  const OHSpec* specs = static_cast<const OHSpec*>(specs_in);
  for (int s = 0; s < nspec; ++s) sp.s[s] = specs[s];
  const In in = {x_hi, x_lo, y_hi, y_lo, z, active, mass, tt, height, axes,
                 oh0, oh1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cells = nxo * nyo * nzo;
  blend_kernel<<<(cells + 255) / 256, 256, 0, st>>>(oh0, oh1, c, blended);
  if (scan)
    bulk_kernel<true><<<blocks_for(pl, n), THREADS, pl.bytes, st>>>(
        in, c, sp, blended, mass_out);
  else
    bulk_kernel<false><<<blocks_for(pl, n), THREADS, pl.bytes, st>>>(
        in, c, sp, blended, mass_out);
  return static_cast<int>(cudaGetLastError());
}

// K11: the adaptive-step particle advance (CTL > 0, method = 1), one
// lsynctime update of every scheduled particle in ONE launch, one thread
// per particle and a loop of passes inside the thread.
//
// Replaces: flexpart_tpu/core/advance.py::advance_all with method=1
// (advance.py:768-1256), its _adaptive_interval (:430-660), _ldt_formula
// (:414-428) and the first step of a fresh particle (:936-954), which the
// JAX package leaves to XLA as a lax.while_loop over masked passes of every
// particle, and the plain version's loop of passes over the active particles
// (core/advance.py::_adaptive_interval_plain).
//
// What a thread does: K4's start (step_start, the row gather of the (R, 64)
// quad table and the 15-field stencil; fresh_state, a fresh particle's
// velocities) and a fresh particle's first step idt; then, if the particle
// starts in the boundary layer, passes while it has time left and is not
// above h: its z re-sampled in the frozen horizontal stencil (lanes 0-39
// of its cell's row, interp.py's wind10_quad), Hanna at z, the horizontal
// OU update and K4's ifine vertical substeps (pbl_substeps) with the
// pass's draws over dt_i = min(ldt, remaining), the next ldt =
// max(trunc(min(...) * ctl), mintime), settling at the pass's z, the top
// clamp, the seconds below 2 HREF (before the ground reflection) and the
// ground reflection; then K4's free troposphere (free_trop_terms) for the
// time left (the whole interval above the boundary layer); the mesoscale
// sigmas of the final cell (lanes 60-62); and K4's end (finish_step:
// mesoscale memory, windalign, the position update, the polar caps, the
// boundary conditions, and the Petterssen corrector for a step of the whole
// interval only, idt == lsynctime).  idt, t_below and the pass count are
// written besides K4's outputs.  The shared device functions are in
// advance_common.cuh.
//
// Draws: in registers from fp::normal_words with the pass in the Philox
// counter, (global index, row / 4, pass, 0): a particle's numbers depend
// only on (seed, step, tag, particle, pass), so the thread's own loop makes
// what the plain version's loop over all particles makes (K1's draws of
// pass k).  Tags 6, 3 and 4 are drawn as in K4 (pass 0).  K11 has no
// parity mode: injected draws go to the plain version.
//
// Bound on the H100: chip_smoke.py's k11_bound, from the state bytes, the
// rows the passes gather and the instructions of the passes' cheapest path
// in the compiled loop (k11_instructions).
//
// Design: the simple form.  The lanes of a warp take different numbers of
// passes (warp divergence); chip_smoke.py measures the warp efficiency.
// turbswitch is a template flag, as in K4, so an instantiation holds one
// form of Hanna and of the substep; turboff is a runtime field (a uniform
// branch); the instantiations are (table type, turbswitch, polar,
// settling).  The arithmetic is the plain version's, operation for
// operation, built with -fmad=false.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "cell_index.cuh"
#include "advance_common.cuh"
#include "philox_normal.cuh"

namespace {

constexpr int THREADS = 256;

// ldt = max(trunc(lim * ctl), mintime) (advance.f90:504-510); the first step
// of a fresh particle caps lim by 600 s in the hanna1 form.
template <bool TS>
__device__ __forceinline__ float ldt_formula(const AdvanceArgs& a, const Turb& t,
                                             float wp, float h, bool first) {
  float lim;
  if (TS) {
    lim = tmin(tmin(t.tlw, h / clamp_min(2.0f * fabsf(wp * t.sigw), F(1e-5))),
               0.5f / clamp_min(fabsf(t.dsigwdz), F(1e-10)));
  } else {
    lim = tmin(t.tlw, h / clamp_min(2.0f * fabsf(wp), F(1e-5)));
    if (first) lim = tmin(lim, 600.0f);
  }
  return clamp_min(truncf(lim * a.ctl), a.mintime);
}

template <bool BF16, bool TS, bool POLAR, bool SETTLING>
__global__ void __launch_bounds__(THREADS)
advance_adaptive_kernel(const PIn in, const int* __restrict__ idt_in,
                        const POut out, int* __restrict__ idt_out,
                        float* __restrict__ t_below_out,
                        int* __restrict__ passes_out,
                        const void* __restrict__ rows,
                        const void* __restrict__ rowsE,
                        const float* __restrict__ height,
                        const float* __restrict__ mass0,
                        const float* __restrict__ tt3,
                        const float* __restrict__ rho3,
                        int* __restrict__ counts, const AdvanceArgs a) {
  extern __shared__ float sh_height[];
  for (int k = threadIdx.x; k < a.nz; k += blockDim.x) sh_height[k] = height[k];
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Draws in_registers = {{nullptr, nullptr, nullptr, nullptr, nullptr}};
  bool keep = false;
  bool exited = false;
  if (i < a.n) {
    float x_hi = in.x_hi[i], x_lo = in.x_lo[i];
    float y_hi = in.y_hi[i], y_lo = in.y_lo[i];
    float z_new = in.z[i];
    float up = in.up[i], vp = in.vp[i], wp = in.wp[i];
    float usig = in.usig[i], vsig = in.vsig[i], wsig = in.wsig[i];
    int cbt = in.cbt[i];
    int itra = in.itra[i];
    int idt = idt_in[i];
    float t_below = 0.0f;
    uint32_t k = 0;
    const bool scheduled = in.active[i] != 0;
    if (scheduled) {
      const float x = x_hi + x_lo;
      const float y = y_hi + y_lo;
      const float z = z_new;
      const Start s = step_start<BF16>(a, rows, sh_height, x, y, z);
      const Horiz& hw = s.hw;
      const float h = s.h;

      const float dt = a.dt;
      const bool pbl = (z / h) <= 1.0f;
      const float htop = sh_height[a.nz - 1] - a.htop_eps;
      const float hm = h - F(1e-9);
      Settle st{0, 0};
      if (SETTLING) st = settle_setup(a, mass0, i, x, y);

      // newly released particles (initialize.f90:110-219) and their first
      // adaptive step (initialize.f90:155-162,191)
      const bool fresh = (in.itramem[i] == a.itime) || (a.itime == 0);
      if (fresh) {
        Turb t0;
        if (pbl) t0 = hanna<TS>(z, h, s.ust, s.wst, s.ol);
        fresh_state<TS>(a, in_registers, false, i, pbl, t0, s, up, vp, wp,
                        usig, vsig, wsig, cbt);
        idt = __float2int_rz(pbl ? ldt_formula<TS>(a, t0, wp, h, true) : dt);
      }

      // ---- the passes of the boundary layer (advance.f90:276-620)
      float remaining = pbl ? dt : 0.0f;
      float ldt = clamp_min(static_cast<float>(idt), a.mintime);
      float zc = z;
      float u_l = 0.0f, v_l = 0.0f, w_l = 0.0f;
      float daw = 0.0f, dcw = 0.0f, dxs = 0.0f, dys = 0.0f;
      while (pbl && remaining > 0.0f && zc <= h) {
        const float dt_i = tmin(ldt, remaining);
        int iz;
        float dz;
        vert_weights(sh_height, a.nz, zc, iz, dz);
        const size_t rk = fp::cell_row(iz, hw.jy, hw.ix, a.ny, a.nx);
        float gk[40];
#pragma unroll
        for (int q = 0; q < 5; ++q) load8<BF16, 64>(rows, rk, q, &gk[8 * q]);
        const float u = field2(gk, 0, hw.p4, dz);
        const float v = field2(gk, 1, hw.p4, dz);
        const float w = field2(gk, 2, hw.p4, dz);
        const float rhoa = field2(gk, 3, hw.p4, dz);
        const float drho = field2(gk, 4, hw.p4, dz);
        const Turb t0 = hanna<TS>(zc, h, s.ust, s.wst, s.ol);

        // the pass's draws: tag 1 rows 0, 1 (the horizontal OU update,
        // advance.f90:369-384) and tag 2 row 0 (the first substep)
        float d0, d1, d2, d2_odd;
        uint32_t pw[4];
        site_words(pw, a, 1, i, 0u, k);
        fp::normal_pair(pw[0], pw[1], d0, d1);
        site_words(pw, a, 2, i, 0u, k);
        fp::normal_pair(pw[0], pw[1], d2, d2_odd);
        const float up2 = ou_update(up, d0, t0.sigu, dt_i / t0.tlu);
        const float vp2 = ou_update(vp, d1, t0.sigv, dt_i / t0.tlv);

        // the ifine vertical substeps (advance.f90:391-498) over dt_i; the
        // next step from the turbulence of the last refresh
        float zz = zc;
        const Turb t = pbl_substeps<TS>(a, nullptr, false, i, k, t0,
                                        drho / rhoa, dt_i * a.fine, d2,
                                        d2_odd, pw, h, s.ust, s.wst, s.ol, zz,
                                        wp, cbt);
        const float ldt2 = ldt_formula<TS>(a, t, wp, h, false);
        const float w_eff = SETTLING ? w + settle_at(a, st, tt3, rho3, sh_height, zc) : w;
        float z3 = zz + (w_eff * dt_i) * a.ldirf;
        z3 = tmin(z3, htop);
        // the deposition window (advance.f90:582-599): after the vertical
        // update, before the ground reflection
        if (z3 < TWO_HREF) t_below = t_below + dt_i;
        z3 = reflect_ground(z3, hm);

        remaining = clamp_min(remaining - dt_i, 0.0f);
        ldt = ldt2;
        zc = z3;
        up = up2;
        vp = vp2;
        u_l = u;
        v_l = v;
        w_l = w_eff;
        daw = daw + up2 * dt_i;
        dcw = dcw + vp2 * dt_i;
        dxs = dxs + u * dt_i;
        dys = dys + v * dt_i;
        ++k;
      }

      // ---- the free troposphere for the time left (advance.f90:629-708)
      const float dt_ft = pbl ? remaining : dt;
      if (dt_ft > 0.0f) {
        int iz;
        float dz;
        vert_weights(sh_height, a.nz, zc, iz, dz);
        const size_t rf = fp::cell_row(iz, hw.jy, hw.ix, a.ny, a.nx);
        float gf[24];
#pragma unroll
        for (int q = 0; q < 3; ++q) load8<BF16, 64>(rows, rf, q, &gf[8 * q]);
        const float u_f = field2(gf, 0, hw.p4, dz);
        const float v_f = field2(gf, 1, hw.p4, dz);
        const float w_f = field2(gf, 2, hw.p4, dz);
        const bool in_trop = zc < s.tropop;
        const bool in_trans = !in_trop && (zc < s.tropop + 1000.0f);
        const float dt_s = clamp_min(dt_ft, F(1e-6));
        const float c_trop = a.two_d_trop / dt_s;
        const float c_strat = a.two_d_strat / dt_s;
        // tag 3 rows 0-2: one Philox call
        float f0, f1, f2, unused;
        uint32_t w3[4];
        site_words(w3, a, 3, i, 0u);
        fp::normal_pair(w3[0], w3[1], f0, f1);
        fp::normal_pair(w3[2], w3[3], f2, unused);
        float ux, vy, wp_ft;
        free_trop_terms(a, in_trop, in_trans, zc, s.tropop, f0, f1, f2, c_trop,
                        c_strat, sqrtf(c_trop), sqrtf(c_strat), ux, vy, wp_ft);
        const float w_eff_f =
            SETTLING ? w_f + settle_at(a, st, tt3, rho3, sh_height, zc) : w_f;
        dxs = dxs + (u_f + ux) * dt_ft;
        dys = dys + (v_f + vy) * dt_ft;
        zc = reflect_ground(zc + ((w_eff_f + wp_ft) * dt_ft) * a.ldirf, hm);
        wp = wp_ft;
        u_l = u_f;
        v_l = v_f;
        w_l = w_eff_f;
        ldt = clamp_min(dt_ft, a.mintime);
      }

      // ---- the mesoscale sigmas of the final cell (advance.f90:601-605)
      int ize;
      float dze;
      vert_weights(sh_height, a.nz, zc, ize, dze);
      float ge[8];
      load8<BF16, 64>(rows, fp::cell_row(ize, hw.jy, hw.ix, a.ny, a.nx), 7, ge);
      idt = __float2int_rz(ldt);
      z_new = tmin(zc, htop);
      if (a.turboff) {
        up = 0.0f;
        vp = 0.0f;
        daw = 0.0f;
        dcw = 0.0f;
      }
      const float settl = SETTLING ? settle_at(a, st, tt3, rho3, sh_height, z_new) : 0.0f;

      float m0, m1, m2;
      meso_draws(a, in_registers, false, i, m0, m1, m2);
      // only a step of the whole interval takes the corrector
      // (advance.f90:829)
      exited = finish_step<BF16, POLAR, SETTLING>(
          a, rowsE, sh_height, x, y, x_hi, x_lo, y_hi, y_lo, z_new, dxs, dys,
          daw, dcw, u_l, v_l, w_l, settl, usig, vsig, wsig, ge[4], ge[5],
          ge[6], m0, m1, m2, hm, htop, static_cast<float>(idt) == dt);
      keep = !exited;
      itra = a.itra_new;
    }
    out.x_hi[i] = x_hi;
    out.x_lo[i] = x_lo;
    out.y_hi[i] = y_hi;
    out.y_lo[i] = y_lo;
    out.z[i] = z_new;
    out.itra[i] = itra;
    out.up[i] = up;
    out.vp[i] = vp;
    out.wp[i] = wp;
    out.usig[i] = usig;
    out.vsig[i] = vsig;
    out.wsig[i] = wsig;
    out.cbt[i] = static_cast<int8_t>(cbt);
    out.active[i] = keep ? 1 : 0;
    idt_out[i] = idt;
    t_below_out[i] = t_below;
    passes_out[i] = static_cast<int>(k);
  }
  // counts[0] += particles still active, counts[1] += particles that exited
  const unsigned kept = __ballot_sync(0xFFFFFFFFu, keep);
  const unsigned gone = __ballot_sync(0xFFFFFFFFu, exited);
  if ((threadIdx.x & 31) == 0) {
    if (kept) atomicAdd(&counts[0], __popc(kept));
    if (gone) atomicAdd(&counts[1], __popc(gone));
  }
}

}  // namespace

extern "C" int fp_advance_adaptive(
    const float* x_hi, const float* x_lo, const float* y_hi, const float* y_lo,
    const float* z, const int* itra, const int* itramem, const float* up,
    const float* vp, const float* wp, const float* usig, const float* vsig,
    const float* wsig, const int8_t* cbt, const uint8_t* active,
    const int* idt, float* o_x_hi, float* o_x_lo, float* o_y_hi,
    float* o_y_lo, float* o_z, int* o_itra, float* o_up, float* o_vp,
    float* o_wp, float* o_usig, float* o_vsig, float* o_wsig, int8_t* o_cbt,
    uint8_t* o_active, int* o_idt, float* t_below, int* passes,
    const void* rows, const void* rowsE, const float* height,
    const float* mass0, const float* tt, const float* rho, int* counts,
    const AdvanceArgs* args, void* stream) {
  const AdvanceArgs a = *args;
  if (a.n <= 0) return 0;
  const size_t shmem = static_cast<size_t>(a.nz) * sizeof(float);
  if (a.nz < 2 || shmem > 48 * 1024 || a.ifine < 1 || a.method != 1 ||
      !(a.mintime > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.settling && (a.nspec < 1 || a.nspec > MAX_SPECIES ||
                     mass0 == nullptr || tt == nullptr || rho == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const PIn in = {x_hi, x_lo, y_hi, y_lo, z, itra, itramem, up, vp, wp,
                  usig, vsig, wsig, cbt, active};
  const POut out = {o_x_hi, o_x_lo, o_y_hi, o_y_lo, o_z, o_itra, o_up, o_vp,
                    o_wp, o_usig, o_vsig, o_wsig, o_cbt, o_active};
  const unsigned blocks = static_cast<unsigned>((a.n + THREADS - 1) / THREADS);
  // the (table type, turbswitch, polar, settling) instantiations
  auto pick = [&](auto bf16) {
    constexpr bool B = decltype(bf16)::value;
    return a.settling
        ? (a.polar ? (a.turbswitch ? advance_adaptive_kernel<B, true, true, true>
                                   : advance_adaptive_kernel<B, false, true, true>)
                   : (a.turbswitch ? advance_adaptive_kernel<B, true, false, true>
                                   : advance_adaptive_kernel<B, false, false, true>))
        : (a.polar ? (a.turbswitch ? advance_adaptive_kernel<B, true, true, false>
                                   : advance_adaptive_kernel<B, false, true, false>)
                   : (a.turbswitch ? advance_adaptive_kernel<B, true, false, false>
                                   : advance_adaptive_kernel<B, false, false, false>));
  };
  auto kern = a.table_bf16 ? pick(std::true_type{}) : pick(std::false_type{});
  kern<<<blocks, THREADS, shmem, static_cast<cudaStream_t>(stream)>>>(
      in, idt, out, o_idt, t_below, passes, rows, rowsE, height, mass0, tt,
      rho, counts, a);
  return static_cast<int>(cudaGetLastError());
}

// K6: Emanuel convection over every grid column, one launch per step.
//
// Replaces: flexpart_tpu/physics/convection.py::make_convection_kernel(..).run
// (convection.py:379-418): build_conv_profiles (:358-376), convect_columns
// (:86-342), fmassfrac_from_fmass (:345-355) and _uvzlev (:421-450), which
// the JAX package leaves to XLA as batched array code over all columns.
// Its plain PyTorch twin is physics/convection.py::convection_plain.
//
// What a block does: one grid column.  It interpolates the two met times'
// ps, tth, qvh, tt2, td2 to the step, builds the column's profiles
// (convmix.f90), runs the scheme (parcel origin, LCL, the saturated lift,
// the CAPE scan, the cloud-base mass flux relaxation, entrainment SIJ /
// MENT, the running-minimum normalisation over j, the up- and downdraft
// fluxes), and writes the displacement matrix fmassfrac, the level masses,
// the subsidence, the half-level heights and the flux memory.  The
// (L1, L1) intermediates that the XLA version keeps in device memory (a
// dozen arrays of 177 MB at 65,341 columns and L1 = 26) live in shared
// memory here: SIJ, MENT and the normalisation weights, three L1 x L1
// tiles (SIJ's and the weights' then hold MENT's column prefix sums, and
// SIJ's at last the rows of fmassfrac), beside some thirty profiles of L1.
//
// Bound on the H100: bytes.  Per column 2 x (2 x L1 + 3) + 1 floats in
// (the L1 profile levels of tth and qvh, ps, tt2 and td2 of both met
// times, cbmf) and L1 x L1 + 6 L1 + 4 words and a byte out; at
// 361 x 181 x 30 (L1 = 26) that is 29 MB in and 219 MB out, 0.074 ms at
// 3.35 TB/s.  The work per column is some 5 x 10^4 operations, all of it
// O(L1^2): the entrainment matrix, the normalisation scan and the flux
// sums (MENT's column prefix sums, made once per block).  It is latency
// that sets the time: one warp per column, long dependent chains and
// serial level loops.
//
// Design.  Thread i owns level i and row i of every matrix; blockDim is
// 32 x ceil(L1 / 32).  What the reference does column-serially (the
// argmin / argmax over levels, the cumulative sums of gz and CAPE, the
// sums over a column) thread 0 does in level order; the running-minimum
// loop over j is a loop in each row's thread, in the order of the JAX
// lax.scan.  Every sum is added in level order from the first element on,
// and every operation is spelled as the plain version spells it (built
// with -fmad=false, true divisions, F(<the same double>) for each Python
// constant), so that the plain PyTorch twin, whose level sums are loops
// too, gives the same bits.  L1 is a run-time argument; shared memory is
// (27 L1 + 3 + 3 L1^2) floats + L1 ints, which for L1 <= MAX_LEVELS = 128
// (206 KB) fits in the 227 KB a block may have; a larger L1 is refused.
#include <cstdint>
#include <cuda_runtime.h>

#define F(x) static_cast<float>(x)

namespace {

// Emanuel scheme parameters (convect43c.f90:250-262), as doubles: every
// use is F(<the same double expression as physics/convection.py>)
constexpr double ELCRIT = 0.0011;
constexpr double TLCRIT = -55.0;
constexpr double ENTP = 1.5;
constexpr double DTMAX_C = 0.9;
constexpr double ALPHA = 0.025;
constexpr double DAMP = 0.1;
constexpr double CPD = 1005.7;
constexpr double CPV = 1870.0;
constexpr double CL_W = 2500.0;
constexpr double RV = 461.5;
constexpr double RD = 287.04;
constexpr double LV0 = 2.501e6;
constexpr double CPVMCL = CL_W - CPV;
constexpr double EPS0 = RD / RV;
constexpr double EPSI = 1.0 / EPS0;
constexpr double EPSILON = 1.0e-20;
constexpr double GA = 9.81;
constexpr double R_AIR = 287.05;
constexpr double RDDRV = 287.0 / 461.0;

// The most profile levels (L1 = nl + 1) a column may have: its shared
// memory must stay within the 232,448 bytes a block may have on sm_90
// (physics/convection.py::K6_MAX_LEVELS holds the same number)
constexpr int MAX_LEVELS = 128;

// torch.minimum / torch.maximum / clamp: a NaN operand comes through.
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float clamp01(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

// met/thermo.py::f_qvsat: enhanced Teten over water, ice below 253.15 K.
__device__ float f_qvsat(float p, float t) {
  float es;
  if (t >= F(253.15)) {
    const float f = F(3.46e-8) * p + F(1.0007);
    es = (f * F(611.21)) * expf((F(17.502) * (t - F(273.15))) / (t - F(32.18)));
  } else {
    const float f = F(4.18e-8) * p + F(1.0003);
    es = (f * F(611.15)) * expf((F(22.452) * (t - F(273.15))) / (t - F(0.6)));
  }
  const float denom = p - F(1.0 - RDDRV) * es;
  return denom == 0.0f ? 1.0f : (F(RDDRV) * es) / denom;
}

// met/thermo.py::ew (Goff-Gratch).  torch computes `scalar / tensor` as the
// tensor's reciprocal times the scalar, and so does this.
__device__ float ew(float t) {
  const float y = (1.0f / t) * F(373.16);
  const float a = (y - 1.0f) * F(-7.90298) + F(5.02808 * 0.43429) * logf(y);
  float c = (1.0f - 1.0f / y) * F(11.344);
  c = F(-1.3816e-7) * (powf(10.0f, c) - 1.0f);
  float d = (1.0f - y) * F(3.49149);
  d = F(8.1328e-3) * (powf(10.0f, d) - 1.0f);
  return F(101324.6) * powf(10.0f, (a + c) + d);
}

// Saturated-ascent parcel at one level, 2 Newton iterations (TLIFT,
// convect43c.f90:1041-1060; convection.py::_tlift_sat).
__device__ void tlift_sat(float t, float qs, float p, float gz, float q_nk,
                          float ah0, float& tvp, float& tpk, float& clw) {
  float tg = t;
  float qg = qs;
  const float alv = F(LV0) - F(CPVMCL) * (t - F(273.15));
  for (int it = 0; it < 2; ++it) {
    const float s = 1.0f / (F(CPD) + ((alv * alv) * qg) / ((F(RV) * t) * t));
    const float ahg = ((F(CPD) * tg + (F(CL_W - CPD) * q_nk) * t) + alv * qg) + gz;
    tg = tmax(tg + s * (ah0 - ahg), 35.0f);
    const float tc = tg - F(273.15);
    const float es = tc >= 0.0f
        ? F(6.112) * expf((F(17.67) * tc) / (tc + F(243.5)))
        : expf((F(23.33086) - F(6111.72784) / tg) + F(0.15215) * logf(tg));
    qg = (F(EPS0) * es) / tmax(p - es * F(1.0 - EPS0), F(1e-6));
  }
  tpk = (((ah0 - (F(CL_W - CPD) * q_nk) * t) - gz) - alv * qg) / F(CPD);
  clw = tmax(q_nk - qg, 0.0f);
  tvp = tpk * (1.0f + (qg / (1.0f - q_nk)) * F(EPSI));
}

// One step of the hypsometric integration (convection.py::_uvzlev.hyps).
__device__ __forceinline__ float hyps(float tv_lo, float tv_hi, float p_lo,
                                      float p_hi) {
  const float dlnp = logf(tmax(p_lo, F(1e-3)) / tmax(p_hi, F(1e-3)));
  const float ratio = fabsf(tv_hi - tv_lo) > F(0.2)
      ? (tv_hi - tv_lo) / logf(tmax(tv_hi, 1.0f) / tmax(tv_lo, 1.0f))
      : tv_hi;
  return (F(R_AIR / GA) * dlnp) * ratio;
}

struct Inputs {
  const float *ps0, *tth0, *qvh0, *tt20, *td20;
  const float *ps1, *tth1, *qvh1, *tt21, *td21;
  const float *akz, *bkz, *akm, *bkm;
  const float* cbmf0;
};

struct Outputs {
  float* fmassfrac;   // (C, L1, L1)
  float* rlevmass;    // (C, L1)
  float* phconv;      // (C, L1 + 1) hPa
  float* pconv;       // (C, L1) hPa
  float* tconv;       // (C, L1)
  float* sub;         // (C, L1)
  float* uvzlev;      // (C, L1 + 1)
  uint8_t* lconv;     // (C,)
  int* nctop;         // (C,)
  float* cbmf;        // (C,)
};

// The column's scalars, made by thread 0 and read by all.
struct Column {
  int nk, icb, inb, inb1;
  bool ok, stable, valid;
  float t_nk, q_nk, plcl, gz_nk, ah0, cpp, h_nk, cbmf0, cbmf, dbo_sum;
};

constexpr int NVEC = 24;   // profiles of L1 floats in shared memory

__global__ void __launch_bounds__(128)
convection_kernel(const Inputs in, const Outputs out, int C, int nl,
                  float tw0, float tw1, float delt) {
  extern __shared__ float sh[];
  __shared__ Column col;
  const int L1 = nl + 1;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  float* p = sh;               // full-level pressure [hPa]
  float* t = p + L1;
  float* q = t + L1;
  float* qs = q + L1;
  float* tv = qs + L1;
  float* cpn = tv + L1;
  float* lv = cpn + L1;
  float* gz = lv + L1;         // dgz, then its cumulative sum
  float* h = gz + L1;
  float* hm = h + L1;
  float* dph = hm + L1;
  float* tvp = dph + L1;
  float* tp = tvp + L1;
  float* clw = tp + L1;
  float* ep = clw + L1;
  float* by = ep + L1;
  float* hp = by + L1;
  float* mflux = hp + L1;      // dbo, then the updraft mass flux
  float* qti = mflux + L1;
  float* scrit = qti + L1;
  float* fup = scrit + L1;
  float* fdown = fup + L1;
  float* dpr = fdown + L1;     // level thickness [Pa]
  float* tvfull = dpr + L1;
  float* ph = tvfull + L1;     // half-level pressure [hPa], L1 + 1
  float* phpa = ph + L1 + 1;   // the same in Pa, L1 + 1
  float* uvz = phpa + L1 + 1;  // half-level heights, L1 + 1
  float* sij = uvz + L1 + 1;   // L1 x L1; the fmassfrac rows at the end
  float* ment = sij + L1 * L1;
  float* wd = ment + L1 * L1;
  int* rowtop = reinterpret_cast<int*>(wd + L1 * L1);

  // ---- the step's fields (convection.py:395-399) and the profiles
  // (build_conv_profiles, convmix.f90:168-189) ----
  const float ps = in.ps0[c] * tw0 + in.ps1[c] * tw1;
  for (int k = tid; k < L1 + 1; k += nthr) {
    const float v = k == 0 ? ps : in.akm[k] + in.bkm[k] * ps;
    phpa[k] = v;
    ph[k] = v / 100.0f;
  }
  for (int k = tid; k < L1; k += nthr) {
    const size_t e = static_cast<size_t>(k + 1) * C + c;
    const float pk = (in.akz[k + 1] + in.bkz[k + 1] * ps) / 100.0f;
    const float tk = in.tth0[e] * tw0 + in.tth1[e] * tw1;
    const float qk = in.qvh0[e] * tw0 + in.qvh1[e] * tw1;
    p[k] = pk;
    t[k] = tk;
    q[k] = qk;
    qs[k] = f_qvsat(pk * 100.0f, tk);
    tv[k] = tk * ((qk * F(EPSI) + 1.0f) - qk);
    cpn[k] = F(CPD) * (1.0f - qk) + F(CPV) * qk;
    lv[k] = F(LV0) - F(CPVMCL) * (tk - F(273.15));
    tvfull[k] = tk * (F(0.608) * qk + 1.0f);
  }
  __syncthreads();
  for (int k = tid; k < L1; k += nthr) {
    dph[k] = ph[k] - ph[k + 1];
    dpr[k] = phpa[k] - phpa[k + 1];
    gz[k] = k == 0 ? 0.0f
                   : ((F(0.5 * RD) * (tv[k] + tv[k - 1])) * (p[k - 1] - p[k])) / ph[k];
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 1; k < L1; ++k) gz[k] = gz[k - 1] + gz[k];
  __syncthreads();
  for (int k = tid; k < L1; k += nthr) {
    h[k] = t[k] * cpn[k] + gz[k];
    hm[k] = k == 0 ? lv[0] * q[0]
                   : ((F(CPD) * (1.0f - q[k]) + F(CL_W) * q[k]) * (t[k] - t[0])
                      + lv[k] * q[k]) + gz[k];
  }
  __syncthreads();

  // ---- parcel origin, LCL, cloud base (convect43c.f90:398-455) ----
  if (tid == 0) {
    // ihmin: the first minimum of hm over the levels where hm decreases
    int ihmin = 0;
    bool any = false;
    float best = __int_as_float(0x7f800000);
    for (int k = 1; k < L1; ++k) {
      if (hm[k] < hm[k - 1]) {
        any = true;
        if (hm[k] < best) { best = hm[k]; ihmin = k; }
      }
    }
    if (!any) ihmin = nl - 1;
    ihmin = min(ihmin, nl - 2);
    // nk: the first maximum of hm at or below ihmin
    int nk = 0;
    float top = hm[0];
    for (int k = 1; k <= ihmin; ++k)
      if (hm[k] > top) { top = hm[k]; nk = k; }
    const float t_nk = t[nk];
    const float q_nk = q[nk];
    const bool ok0 = (t_nk >= 250.0f) && (q_nk > 0.0f) && (ihmin < nl - 2);
    const float rh = clamp01(q_nk / tmax(qs[nk], F(1e-10)), F(1e-6), 1.0f);
    const float chi = t_nk / ((F(1669.0) - F(122.0) * rh) - t_nk);
    const float plcl = p[nk] * powf(rh, chi);
    const bool ok2 = (plcl >= 200.0f) && (plcl < 2000.0f);
    int icb = nl - 2;
    for (int k = nk + 1; k < L1; ++k)
      if (p[k] < plcl) { icb = k; break; }
    icb = min(icb, nl - 2);
    const bool ok3 = icb < nl - 2;
    const float gz_nk = gz[nk];
    col.nk = nk;
    col.icb = icb;
    col.ok = ok0 && ok2 && ok3;
    col.t_nk = t_nk;
    col.q_nk = q_nk;
    col.plcl = plcl;
    col.gz_nk = gz_nk;
    col.ah0 = ((F(CPD) * (1.0f - q_nk) + F(CL_W) * q_nk) * t_nk
               + q_nk * (F(LV0) - F(CPVMCL) * (t_nk - F(273.15)))) + gz_nk;
    col.cpp = F(CPD) * (1.0f - q_nk) + q_nk * F(CPV);
    col.h_nk = h[nk];
    col.cbmf0 = in.cbmf0[c];
  }
  __syncthreads();

  // ---- the lifted parcel, precipitation efficiency, buoyancy ----
  {
    const int nk = col.nk, icb = col.icb;
    const float q_nk = col.q_nk;
    for (int k = tid; k < L1; k += nthr) {
      const float tpk_dry = col.t_nk - (gz[k] - col.gz_nk) / col.cpp;
      const float tvp_dry = tpk_dry * (q_nk * F(EPSI) + 1.0f);
      float tvp_s, tpk_s, clw_s;
      tlift_sat(t[k], qs[k], p[k], gz[k], q_nk, col.ah0, tvp_s, tpk_s, clw_s);
      const bool sat = k >= icb;
      const float tpk = sat ? tpk_s : tpk_dry;
      const float clwk = sat ? clw_s : 0.0f;
      const float tvpk = (sat ? tvp_s : tvp_dry) - tpk * q_nk;
      tvp[k] = tvpk;
      tp[k] = tpk;
      clw[k] = clwk;
      const float tca = tpk - F(273.15);
      const float elacrit = tca >= 0.0f
          ? F(ELCRIT) : tmax(F(ELCRIT) * (1.0f - tca / F(TLCRIT)), 0.0f);
      const float epk = clamp01(F(0.999) * (1.0f - elacrit / tmax(clwk, F(1e-8))),
                                0.0f, F(0.999));
      ep[k] = k <= nk ? 0.0f : epk;
      by[k] = ((tvpk - tv[k]) * dph[k]) / p[k];
    }
  }
  __syncthreads();

  // ---- CAPE scan -> INB / INB1, cloud-base mass flux (:556-614) ----
  if (tid == 0) {
    const int nk = col.nk, icb = col.icb;
    const float plcl = col.plcl;
    const float tvp_icb = tvp[icb];
    const float tv_icb = tv[icb];
    const bool stable = (col.cbmf0 == 0.0f) && (tvp_icb <= tv_icb - F(DTMAX_C));
    int inb1 = 0, last_pos = -1;
    float cape = 0.0f;
    for (int k = 0; k < L1; ++k) {
      const bool in_scan = (k >= icb + 1) && (k <= nl - 2);
      const float bm = in_scan ? by[k] : 0.0f;
      cape = k == 0 ? bm : cape + bm;
      if (in_scan && by[k] >= 0.0f) inb1 = k + 1;
      if (in_scan && cape > 0.0f) last_pos = k;
    }
    inb1 = max(inb1, icb + 1);
    int inb = max(last_pos >= 0 ? last_pos + 1 : icb + 1, inb1);
    inb = min(inb, nl - 1);
    const int icbm = max(icb - 1, 0);
    const float tvp_icbm = tvp[icbm];
    const float p_icbm = p[icbm];
    const float tvpplcl = tvp_icbm - ((F(RD) * tvp_icbm) * (p_icbm - plcl))
                                         / (cpn[icbm] * p_icbm);
    const float p_icb = p[icb];
    const int icb1 = min(icb + 1, nl);
    const float tvaplcl = tv_icb + ((tvp_icb - tvp[icb1]) * (plcl - p_icb))
                                       / tmax(p_icb - p[icb1], F(1e-3));
    float spbl = 0.0f;
    for (int k = 0; k < L1; ++k) {
      const float w = (k >= nk && k < icb) ? (tvp[k] - tv[k]) * dph[k] : 0.0f;
      spbl = k == 0 ? w : spbl + w;
    }
    const float dtpbl = spbl / tmax(ph[nk] - ph[icb], F(1e-3));
    const float dtma = ((tvpplcl - tvaplcl) + F(DTMAX_C)) + dtpbl;
    const float cbmf0 = col.cbmf0;
    const float cbmf = tmax(F(1.0 - DAMP * 3.0) * cbmf0 + F(0.1 * ALPHA) * dtma,
                            0.0f);
    const bool any_flux = (cbmf > 0.0f) || (cbmf0 > 0.0f);
    col.inb = inb;
    col.inb1 = inb1;
    col.stable = stable;
    col.valid = col.ok && !stable && any_flux;
    col.cbmf = cbmf;
  }
  __syncthreads();

  // ---- lifted static energy, updraft mass fractions (:586-634) ----
  {
    const int icb = col.icb, inb = col.inb, inb1 = col.inb1;
    for (int k = tid; k < L1; k += nthr) {
      const bool in_cloud = (k >= icb) && (k <= inb);
      hp[k] = in_cloud
          ? col.h_nk + (((lv[k] + F(CPD - CPV) * t[k]) * ep[k]) * clw[k])
          : h[k];
      const int kk = min(k, inb1);
      const float dbo = fabsf(tv[kk] - tvp[kk]) + F(ENTP * 0.02) * dph[kk];
      const bool m_zone = (k >= icb + 1) && (k <= inb);
      mflux[k] = m_zone ? dbo : 0.0f;
      qti[k] = col.q_nk - ep[k] * clw[k];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = mflux[0];
    for (int k = 1; k < L1; ++k) s = s + mflux[k];
    col.dbo_sum = tmax(s, F(1e-30));
  }
  __syncthreads();
  for (int k = tid; k < L1; k += nthr) {
    mflux[k] = (col.cbmf * mflux[k]) / col.dbo_sum;
    // SCRIT of the normalisation (convect43c.f90:717-730)
    const float qp1 = qti[k];
    const float anum_s = (h[k] - hp[k]) - lv[k] * (qp1 - qs[k]);
    float denom_s = (h[k] - hp[k]) + lv[k] * (q[k] - qp1);
    denom_s = fabsf(denom_s) < F(0.01) ? F(0.01) : denom_s;
    const float sc = anum_s / denom_s;
    const float alt = (qp1 - qs[k]) + sc * (q[k] - qp1);
    scrit[k] = tmax(alt < 0.0f ? 1.0f : sc, 0.0f);
  }
  __syncthreads();

  // ---- row i: entrainment SIJ / MENT (:640-711), normalisation with the
  // running minimum over j (:717-769) ----
  const int icb = col.icb, inb = col.inb, nk = col.nk;
  for (int i = tid; i < L1; i += nthr) {
    float* srow = sij + i * L1;
    float* mrow = ment + i * L1;
    float* wrow = wd + i * L1;
    const bool m_zone_i = (i >= icb + 1) && (i <= inb);
    const float hi_hp = h[i] - hp[i];
    const float q_qti = q[i] - qti[i];
    int nent = 0;
    for (int j = 0; j < L1; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const float bf2 = 1.0f + ((lv[j] * lv[j]) * qs[j]) / (((F(RV) * t[j]) * t[j]) * F(CPD));
      const float anum = (h[j] - hp[i]) + (F(CPV - CPD) * t[j]) * (qti[i] - q[j]);
      const float denom = hi_hp + (F(CPD - CPV) * q_qti) * t[j];
      const float dei = fabsf(denom) < F(0.01) ? F(0.01) : denom;
      float s = anum / dei;
      s = s * (1.0f - eye) + eye;
      const float altem = ((s * q[i] + (1.0f - s) * qti[i]) - qs[j]) / bf2;
      const float cwat = clw[j] * (1.0f - ep[j]);
      const bool redo = ((s < 0.0f) || (s > 1.0f) || (altem > cwat)) && (j > i);
      const float anum2 = anum - lv[j] * ((qti[i] - qs[j]) - cwat * bf2);
      float denom2 = denom + lv[j] * q_qti;
      denom2 = fabsf(denom2) < F(0.01) ? F(0.01) : denom2;
      if (redo) s = anum2 / denom2;
      const bool in_cloud_j = (j >= icb) && (j <= inb);
      const bool mixed = (s > 0.0f) && (s < F(0.9)) && m_zone_i && in_cloud_j
                         && (i != j);
      mrow[j] = mixed ? mflux[i] / (1.0f - s) : 0.0f;
      nent += mixed ? 1 : 0;
      s = clamp01(s, 0.0f, 1.0f);
      srow[j] = s * (1.0f - eye) + eye;
    }
    // detrain-at-level fallback (convect43c.f90:704-711)
    if (nent == 0 && m_zone_i) mrow[i] = mflux[i];

    const float sc = scrit[i];
    float smin = 1.0f;
    float asij = 0.0f;
    for (int j = 0; j < L1; ++j) {
      const float s_j = srow[j];
      const float s_jp = j + 1 < L1 ? srow[j + 1] : 0.0f;
      const float s_jm = j > 0 ? srow[j - 1] : 0.0f;
      const bool in_range = (s_j > 0.0f) && (s_j < F(0.9));
      const bool gt = j > i;
      float smid, sjmax, sjmin;
      if (gt) {
        const float smid_g = tmin(s_j, sc);
        const bool new_min = (smid_g < smin) && (s_jp < smid_g);
        sjmax = new_min ? tmin(tmin(s_jp, s_j), sc) : smid_g;
        sjmin = new_min ? tmin(tmax(s_jm, s_j), sc) : smid_g;
        if (in_range && new_min) smin = smid_g;
        smid = smid_g;
      } else {
        smid = tmax(s_j, sc);
        sjmax = tmax(s_jp, sc);
        sjmin = tmax(s_jm, sc);
      }
      const float w = in_range ? fabsf(sjmax - smid) + fabsf(sjmin - smid) : 0.0f;
      const bool in_cloud_j = (j >= icb) && (j <= inb);
      const float wdj = (w * dph[j]) * (in_cloud_j ? 1.0f : 0.0f);
      wrow[j] = wdj;
      asij = j == 0 ? wdj : asij + wdj;
    }
    asij = tmax(asij, F(1e-21));
    if (nent != 0)
      for (int j = 0; j < L1; ++j) mrow[j] = (mrow[j] * wrow[j]) / asij;
    float bsum = 0.0f;
    for (int j = 0; j < L1; ++j) {
      const bool in_cloud_j = (j >= icb) && (j <= inb);
      const float v = in_cloud_j ? mrow[j] : 0.0f;
      bsum = j == 0 ? v : bsum + v;
    }
    if (nent != 0 && bsum < F(1e-18) && m_zone_i)
      for (int j = 0; j < L1; ++j) mrow[j] = i == j ? mflux[i] : 0.0f;
  }
  __syncthreads();

  // ---- up/downdraft fluxes (:879-917), displacement matrix (:1009-1032),
  // fmassfrac (calcmatrix.f90:118-135) ----
  // MENT's column prefix sums, one column per thread, into the free tiles:
  // below[i][j] = sum over k <= i of MENT(k, j), added from k = 0 up, and
  // above[i][j] = sum over k >= i of MENT(k, j), added from k = L1 - 1 down
  // (the plain version's cumsum over the first index and its flipped twin)
  float* below = wd;
  float* above = sij;
  for (int j = tid; j < L1; j += nthr) {
    float b = ment[j];
    below[j] = b;
    for (int k = 1; k < L1; ++k) {
      b = b + ment[k * L1 + j];
      below[k * L1 + j] = b;
    }
    float a = ment[(L1 - 1) * L1 + j];
    above[(L1 - 1) * L1 + j] = a;
    for (int k = L1 - 2; k >= 0; --k) {
      a = a + ment[k * L1 + j];
      above[k * L1 + j] = a;
    }
  }
  __syncthreads();
  const bool valid = col.valid;
  for (int i = tid; i < L1; i += nthr) {
    float ma = 0.0f;
    for (int j = 0; j < L1; ++j) {
      const float v = j > i ? mflux[j] : 0.0f;
      ma = j == 0 ? v : ma + v;
    }
    if (i < nk) ma = 0.0f;
    float su = 0.0f, sd = 0.0f;
    for (int j = 0; j < L1; ++j) {
      const float up = j > i ? below[i * L1 + j] : 0.0f;
      const float dn = j < i ? above[i * L1 + j] : 0.0f;
      su = j == 0 ? up : su + up;
      sd = j == 0 ? dn : sd + dn;
    }
    fup[i] = ma + su;
    fdown[i] = sd;
  }
  __syncthreads();   // the prefix tiles have been read: sij takes fmassfrac
  for (int i = tid; i < L1; i += nthr) {
    const float onehot = i == nk ? 1.0f : 0.0f;
    const bool box_i = i <= inb + 1;
    float* frow = sij + i * L1;
    int top = 0;
    float rowsum = 0.0f;
    for (int j = 0; j < L1; ++j) {
      float fm = ment[i * L1 + j] + onehot * mflux[j];
      fm = (box_i && j <= inb + 1 && valid) ? fm : 0.0f;
      if (fm > F(EPSILON)) top = max(top, max(i, j));
      const float f = delt * fm;
      frow[j] = f;
      rowsum = j == 0 ? f : rowsum + f;
    }
    const float diag = dpr[i] / F(GA) - rowsum;
    for (int j = 0; j < L1; ++j)
      frow[j] = frow[j] + (i == j ? 1.0f : 0.0f) * diag;
    rowtop[i] = top;
  }

  // ---- half-level heights (redist.f90:46-100; convection.py::_uvzlev) ----
  if (tid == 0) {
    const float tt2 = in.tt20[c] * tw0 + in.tt21[c] * tw1;
    const float td2 = in.td20[c] * tw0 + in.td21[c] * tw1;
    const float tvold = tt2 * ((F(0.378) * ew(td2)) / (ps / 100.0f) + 1.0f);
    float tv_lo = tvold;
    float z = 0.0f;
    uvz[0] = 0.0f;
    for (int k = 0; k + 1 < L1; ++k) {
      const float tv_half = tvfull[k] + ((tvfull[k + 1] - tvfull[k]) * (p[k] - ph[k + 1]))
                                            / (p[k] - p[k + 1]);
      const float dz = hyps(tv_lo, tv_half, ph[k], ph[k + 1]);
      z = k == 0 ? dz : z + dz;
      uvz[k + 1] = z;
      tv_lo = tv_half;
    }
    uvz[L1] = uvz[L1 - 1] + hyps(tv_lo, tvfull[L1 - 1], ph[L1 - 1], ph[L1]);
  }
  __syncthreads();

  // ---- write: the matrix as one coalesced block, then the profiles ----
  float* fm_out = out.fmassfrac + static_cast<size_t>(c) * L1 * L1;
  for (int e = tid; e < L1 * L1; e += nthr) fm_out[e] = sij[e];
  const size_t o1 = static_cast<size_t>(c) * L1;
  const size_t o2 = static_cast<size_t>(c) * (L1 + 1);
  for (int k = tid; k < L1; k += nthr) {
    out.rlevmass[o1 + k] = dpr[k] / F(GA);
    out.pconv[o1 + k] = p[k];
    out.tconv[o1 + k] = t[k];
    out.sub[o1 + k] = (valid && k > 0) ? fup[k - 1] - fdown[k] : 0.0f;
  }
  for (int k = tid; k < L1 + 1; k += nthr) {
    out.phconv[o2 + k] = ph[k];
    out.uvzlev[o2 + k] = uvz[k];
  }
  if (tid == 0) {
    int top = 0;
    for (int i = 0; i < L1; ++i) top = max(top, rowtop[i]);
    out.nctop[c] = min(top + 1, nl - 1);
    out.lconv[c] = valid ? 1 : 0;
    const float cbmf0 = col.cbmf0;
    out.cbmf[c] = col.ok ? (col.stable ? cbmf0 : col.cbmf) : 0.0f;
  }
}

size_t shared_bytes(int L1) {
  return static_cast<size_t>(NVEC * L1 + 3 * (L1 + 1) + 3 * L1 * L1) * sizeof(float)
         + static_cast<size_t>(L1) * sizeof(int);
}

}  // namespace

extern "C" int fp_convection(
    const float* ps0, const float* tth0, const float* qvh0, const float* tt20,
    const float* td20, const float* ps1, const float* tth1, const float* qvh1,
    const float* tt21, const float* td21, const float* akz, const float* bkz,
    const float* akm, const float* bkm, const float* cbmf0, int C, int nlev,
    int nl, float tw0, float tw1, float delt, float* fmassfrac,
    float* rlevmass, float* phconv, float* pconv, float* tconv, float* sub,
    float* uvzlev, uint8_t* lconv, int* nctop, float* cbmf, void* stream) {
  if (C <= 0) return 0;
  const int L1 = nl + 1;
  if (nl < 2 || L1 > nlev - 1 || L1 > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = shared_bytes(L1);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        convection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Inputs in = {ps0, tth0, qvh0, tt20, td20, ps1, tth1, qvh1, tt21, td21,
                     akz, bkz, akm, bkm, cbmf0};
  const Outputs out = {fmassfrac, rlevmass, phconv, pconv, tconv, sub,
                       uvzlev, lconv, nctop, cbmf};
  const int threads = min(128, 32 * ((L1 + 31) / 32));
  convection_kernel<<<C, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      in, out, C, nl, tw0, tw1, delt);
  return static_cast<int>(cudaGetLastError());
}

// K14: the regional domain fill's boundary condition, one step: particles
// outside the window destroyed; per boundary site (one layer of one
// boundary column) the air mass that flowed in, accumulated; where a
// site has gathered particle masses, up to KMAX_EMIT = 4 new particles on
// its face, the k-th wish in (round, site) order in the k-th free slot.
//
// Replaces: flexpart_tpu/core/domainfill.py::boundcond_domainfill
// (:319-447; boundcond_domainfill.f90), which JAX leaves to XLA as a
// masked kill, eight gathers per site, and four rounds each of two cumsums
// over every slot, a scatter of the free slots' ranks and 22 masked
// scatters.
//
// The reference ranks free slots by slot index.  The port keeps its
// particles in met-cell order, so the free slots are ranked by their
// schedule origin (``_origin``), as K13 ranks them; each new particle is
// written into a port slot in place.  The four rounds are one ranking: a
// round takes the first free slots that the rounds before it left, and a
// site's wish in a round depends on nothing taken before, so the k-th wish
// in (round, site) order takes the k-th free slot of the step (proved in
// core/domainfill.py's docstring; the plain version ranks so too).
//
// Passes (no CUB or Thrust):
//  1. kill: per slot, destroy an active particle outside the window (its
//     itra unscheduled), then write its free flag (inactive and no future
//     release) and slot number at its origin, into origin order; the
//     killed count by a warp ballot;
//  2. sites: per site, the wind normal to its face and the density at
//     both met times (four gathers each, linear in height), the mass flux
//     and the accumulator, the integer emission count, and per round the
//     draws (Philox of counter (site, round, 0, 0), or injected), the new
//     particle's position, mass and class, and the wish (MDOMAINFILL=2:
//     only above 3 km and where the PV at the site's column exceeds
//     pvcrit, the mass the ozone proxy's);
//  3. tile sums: per tile of 4096 origins the free count, per tile of 4096
//     wishes (in (round, site) order) the wish count;
//  4. scan: one block scans both tile counts (exclusive) and writes the
//     counts: killed, free, wanted, granted = min(free, wanted);
//  5. ranks: per tile, the slot of the r-th free origin, r < granted;
//  6. emit: per tile of wishes, each wish's rank (a block-wide scan plus
//     its tile's offset); a granted wish writes its 22 fields into the
//     free slot of its rank.
//
// Arithmetic: the plain version's float32 operations in its order
// (-fmad=false); the ranking is integer.  So the kernel and its plain
// version agree bit for bit, and two runs of one seed do.
//
// Bound on the H100: every slot's active, itra, itramem, x and y (hi and
// lo) and the int64 origin (29 B, 37 B with the origin), the free flags
// and slot numbers written and read back (5 B); per site its 15 table
// entries (53 B) and 16 gathers (64 B; 32 more with MDOMAINFILL=2); per
// granted wish one slot's fields (70 + 12 nspec B).
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "philox_normal.cuh"

namespace {

using fp::block_scan2;
using fp::byte_sum;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                  // origins per thread: one uint4
constexpr int TILE = THREADS * ITEMS;      // origins per tile
constexpr int SCAN_THREADS = 1024;
constexpr int KMAX_EMIT = 4;               // core/domainfill.py KMAX_EMIT
constexpr int ITRA_INACTIVE = -999999999;
constexpr int MAX_MET_LEVELS = 256;
// met/fields.py: the f3d planes of the wind components, density and PV
constexpr int F3_U = 0, F3_V = 1, F3_RHO = 3, F3_PV = 7;
constexpr float PVCRIT = 2.0f;
constexpr float OZONESCALE = 60.0f;

struct Fields {
  float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  int *itra, *itramem, *npoint, *nclass, *idt, *itrasplit;
  float *up, *vp, *wp, *usig, *vsig, *wsig;
  int8_t* cbt;
  float *mass, *mass0, *xscav;             // (n, nspec)
  bool* active;
};

struct Table {                             // the sites, (S,) each
  const float* acc;
  const int* col_flat;
  const bool* is_we;
  const float *sgn, *area;
  const int* kz;
  const float *wlo, *whi, *x_base, *x_span, *y_base, *y_span, *z_base,
      *z_span;
  const bool* valid;
};

struct Step {
  const float *f3d0, *f3d1, *height;
  int nz, ny, nx;
  float w0, w1, lsync, xpp, xlo, xhi, ylo, yhi;
  int check_x, mdomainfill;
  float ylat0, dy;
  int itime, itrasplit, nclassunc;
  uint32_t k0, k1;
  const float *u1, *u2;                    // injected (KMAX_EMIT, S), or NULL
  const int* ncls;
};

struct Scratch {
  uint8_t* free_o;                         // (tiles * TILE,) zeroed
  int* slot_at_origin;                     // (n,)
  int* tile_free;                          // (tiles,)
  uint8_t* want;                           // (wtiles * TILE,) zeroed
  int* tile_want;                          // (wtiles,)
  int *free_slot, *cand_ncls;              // (KMAX_EMIT * S,)
  float *cand_x, *cand_y, *cand_z, *cand_m;
  int* counts;                             // killed, free, wanted, granted
};

__global__ void __launch_bounds__(THREADS)
boundary_kill_kernel(Fields f, const long long* __restrict__ origin,
                     int n, const Step st, Scratch s) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  bool kill = false;
  if (k < n) {
    bool active = f.active[k];
    int itra = f.itra[k];
    if (active) {
      const float x = f.x_hi[k] + f.x_lo[k];
      const float y = f.y_hi[k] + f.y_lo[k];
      bool outside = y < st.ylo || y > st.yhi;
      if (st.check_x) outside = outside || x < st.xlo || x > st.xhi;
      if (outside) {
        kill = true;
        active = false;
        itra = ITRA_INACTIVE;
        f.active[k] = false;
        f.itra[k] = ITRA_INACTIVE;
      }
    }
    const long long o = origin == nullptr ? k : origin[k];
    if (o >= 0 && o < n) {
      const bool is_free =
          !active && (itra == ITRA_INACTIVE || itra != f.itramem[k]);
      s.free_o[o] = is_free ? 1 : 0;
      s.slot_at_origin[o] = k;
    }
  }
  const unsigned killed = __ballot_sync(0xffffffffu, kill);
  if ((threadIdx.x & 31) == 0 && killed != 0u)
    atomicAdd(s.counts, __popc(killed));
}

// f3d[field][klev] at a column
__device__ __forceinline__ float sample(const float* f3d, int field, int klev,
                                        long long col, const Step& st) {
  const long long nyx = static_cast<long long>(st.ny) * st.nx;
  return f3d[(static_cast<long long>(field) * st.nz + klev) * nyx + col];
}

__global__ void __launch_bounds__(THREADS)
boundary_sites_kernel(const Table t, int sites,
                      float* __restrict__ acc_out, const Step st,
                      Scratch s) {
  __shared__ float height[MAX_MET_LEVELS];
  for (int i = threadIdx.x; i < st.nz; i += THREADS) height[i] = st.height[i];
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= sites) return;
  const long long col = t.col_flat[i];
  const int kz = t.kz[i];
  const int fidx = t.is_we[i] ? F3_U : F3_V;
  const float wlo = t.wlo[i], whi = t.whi[i];
  const float at0 = wlo * sample(st.f3d0, fidx, kz, col, st) +
                    whi * sample(st.f3d0, fidx, kz + 1, col, st);
  const float at1 = wlo * sample(st.f3d1, fidx, kz, col, st) +
                    whi * sample(st.f3d1, fidx, kz + 1, col, st);
  const float windx = st.w0 * at0 + st.w1 * at1;
  const float rho0 = wlo * sample(st.f3d0, F3_RHO, kz, col, st) +
                     whi * sample(st.f3d0, F3_RHO, kz + 1, col, st);
  const float rho1 = wlo * sample(st.f3d1, F3_RHO, kz, col, st) +
                     whi * sample(st.f3d1, F3_RHO, kz + 1, col, st);
  const float rhox = st.w0 * rho0 + st.w1 * rho1;
  const float flux = t.sgn[i] * windx * rhox * t.area[i] * st.lsync;
  const bool valid = t.valid[i];
  float a = flux >= 0.0f ? t.acc[i] + flux : 0.0f;
  a = valid ? a : 0.0f;
  // the integer emission count (boundcond_domainfill.f90:135-142)
  const float half = st.xpp * 0.5f;
  const float mmass = a >= half ? floorf((a + half) / st.xpp) : 0.0f;
  a = a - mmass * st.xpp;
  const float emit = fminf(mmass, static_cast<float>(KMAX_EMIT));
  a = a + (mmass - emit) * st.xpp;
  acc_out[i] = a;
  for (int r = 0; r < KMAX_EMIT; ++r) {
    const int w = r * sites + i;
    float u1, u2;
    int ncls;
    if (st.u1 != nullptr) {
      u1 = st.u1[w];
      u2 = st.u2[w];
      ncls = st.ncls[w];
    } else {
      uint32_t c[4] = {static_cast<uint32_t>(i), static_cast<uint32_t>(r),
                       0u, 0u};
      fp::philox4x32_10(c, st.k0, st.k1);
      u1 = fp::uniform24(c[0]);
      u2 = fp::uniform24(c[1]);
      ncls = static_cast<int>(
          (static_cast<unsigned long long>(c[2] >> 8) *
           static_cast<unsigned long long>(st.nclassunc)) >> 24);
    }
    const float xnew = t.x_base[i] + u1 * t.x_span[i];
    const float ynew = t.y_base[i] + u1 * t.y_span[i];
    const float znew = t.z_base[i] + u2 * t.z_span[i];
    bool want = valid && emit > static_cast<float>(r);
    float m = st.xpp;
    if (st.mdomainfill == 2) {
      // the stratospheric ozone proxy: PV at the site's column
      int kzp = 0;
      for (int l = 0; l < st.nz; ++l) kzp += height[l] < znew ? 1 : 0;
      kzp = kzp < 1 ? 1 : (kzp > st.nz - 1 ? st.nz - 1 : kzp);
      const float dz1p = znew - height[kzp - 1];
      const float dz2p = height[kzp] - znew;
      const float dzi = 1.0f / fmaxf(dz1p + dz2p, 1e-6f);
      const float pvlo = sample(st.f3d0, F3_PV, kzp - 1, col, st) * st.w0 +
                         sample(st.f3d1, F3_PV, kzp - 1, col, st) * st.w1;
      const float pvhi = sample(st.f3d0, F3_PV, kzp, col, st) * st.w0 +
                         sample(st.f3d1, F3_PV, kzp, col, st) * st.w1;
      float pvpart = (pvlo * dz2p + pvhi * dz1p) * dzi;
      const float lat = ynew * st.dy + st.ylat0;
      if (lat < 0.0f) pvpart = -pvpart;
      want = want && znew > 3000.0f && pvpart > PVCRIT;
      m = st.xpp * pvpart * 48.0f / 29.0f * OZONESCALE / 1.0e9f;
    }
    s.want[w] = want ? 1 : 0;
    s.cand_x[w] = xnew;
    s.cand_y[w] = ynew;
    s.cand_z[w] = znew;
    s.cand_m[w] = m;
    s.cand_ncls[w] = ncls;
  }
}

// per tile of 4096 flags, their count: block b < tiles of the free flags,
// block b < wtiles of the wishes (one launch for both)
__global__ void __launch_bounds__(THREADS)
boundary_tile_sums_kernel(Scratch s, int tiles, int wtiles) {
  __shared__ int part[2][THREADS / 32];
  const size_t at = static_cast<size_t>(blockIdx.x) * TILE +
                    static_cast<size_t>(threadIdx.x) * ITEMS;
  const bool fr = blockIdx.x < tiles, wi = blockIdx.x < wtiles;
  int a = fr ? byte_sum(*reinterpret_cast<const uint4*>(s.free_o + at)) : 0;
  int b = wi ? byte_sum(*reinterpret_cast<const uint4*>(s.want + at)) : 0;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = a;
    part[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ta = 0, tb = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      ta += part[0][i];
      tb += part[1][i];
    }
    if (fr) s.tile_free[blockIdx.x] = ta;
    if (wi) s.tile_want[blockIdx.x] = tb;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
boundary_scan_kernel(Scratch s, int tiles, int wtiles) {
  // the tiles' free and wish counts side by side, exclusive
  int carry_a = 0, carry_b = 0;
  const int len = tiles > wtiles ? tiles : wtiles;
  for (int base = 0; base < len; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    int a = i < tiles ? s.tile_free[i] : 0;
    int b = i < wtiles ? s.tile_want[i] : 0;
    int ta, tb;
    block_scan2<SCAN_THREADS>(a, b, &ta, &tb);
    if (i < tiles) s.tile_free[i] = carry_a + a;
    if (i < wtiles) s.tile_want[i] = carry_b + b;
    carry_a += ta;
    carry_b += tb;
  }
  if (threadIdx.x == 0) {
    s.counts[1] = carry_a;                 // free
    s.counts[2] = carry_b;                 // wanted
    s.counts[3] = carry_b < carry_a ? carry_b : carry_a;   // granted
  }
}

__global__ void __launch_bounds__(THREADS)
boundary_ranks_kernel(Scratch s) {
  const size_t at = static_cast<size_t>(blockIdx.x) * TILE +
                    static_cast<size_t>(threadIdx.x) * ITEMS;
  const uint4 fv = *reinterpret_cast<const uint4*>(s.free_o + at);
  int a = byte_sum(fv), b = 0;
  int ta, tb;
  block_scan2<THREADS>(a, b, &ta, &tb);
  const int granted = s.counts[3];
  int rf = s.tile_free[blockIdx.x] + a;
  if (ta == 0 || rf >= granted) return;
  const uint8_t* fb = reinterpret_cast<const uint8_t*>(&fv);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (fb[i]) {
      if (rf < granted) s.free_slot[rf] = s.slot_at_origin[at + i];
      ++rf;
    }
  }
}

// one new particle: the wish w takes the free slot of its rank
__device__ __forceinline__ void emit(Fields& f, int nspec, int w, int rank,
                                     const Step& st, const Scratch& s) {
  const int c = s.free_slot[rank];
  f.x_hi[c] = s.cand_x[w];
  f.x_lo[c] = 0.0f;
  f.y_hi[c] = s.cand_y[w];
  f.y_lo[c] = 0.0f;
  f.z[c] = s.cand_z[w];
  f.itra[c] = st.itime;
  f.itramem[c] = st.itime;
  f.itrasplit[c] = st.itrasplit;
  f.npoint[c] = 0;
  f.nclass[c] = s.cand_ncls[w];
  f.idt[c] = 0;
  f.up[c] = f.vp[c] = f.wp[c] = 0.0f;
  f.usig[c] = f.vsig[c] = f.wsig[c] = 0.0f;
  f.cbt[c] = 1;
  const float m = s.cand_m[w];
  const long long row = static_cast<long long>(c) * nspec;
  for (int k = 0; k < nspec; ++k) {
    f.mass[row + k] = m;
    f.mass0[row + k] = m;
  }
  f.active[c] = true;
}

// per tile of 4096 wishes (16 a thread), each wish's rank in (round, site)
// order: its tile's offset and a block-wide exclusive scan; the granted
// ones emit
__global__ void __launch_bounds__(THREADS)
boundary_emit_kernel(Fields f, int nspec, const Step st, Scratch s) {
  const size_t at = static_cast<size_t>(blockIdx.x) * TILE +
                    static_cast<size_t>(threadIdx.x) * ITEMS;
  const uint4 wv = *reinterpret_cast<const uint4*>(s.want + at);
  int a = byte_sum(wv), b = 0;
  int ta, tb;
  block_scan2<THREADS>(a, b, &ta, &tb);
  const int granted = s.counts[3];
  int rank = s.tile_want[blockIdx.x] + a;
  if (ta == 0 || rank >= granted) return;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(&wv);
  for (int i = 0; i < ITEMS && rank < granted; ++i) {
    if (wb[i]) {
      emit(f, nspec, static_cast<int>(at) + i, rank, st, s);
      ++rank;
    }
  }
}

}  // namespace

// fields: the 22 pointers of Particles in core/state.py FIELDS order, each
// updated in place; origin (n,) int64, a permutation of 0..n-1, or NULL
// (the identity); table: the 15 site pointers of core/domainfill.py
// BOUNDARY_FIELDS[:15], (S,) each; acc_out (S,) f32; f3d0, f3d1 (NF3, nz,
// ny, nx) f32 and height (nz,) f32; injected draws u1, u2 (4, S) f32 and
// ncls (4, S) i32, or all NULL; scratch: free_o (tiles * 4096,) u8 zeroed,
// slot_at_origin (n,), tile_free (tiles,) i32, want (wtiles * 4096,) u8
// zeroed, wtiles = ceil(4 S / 4096), tile_want (wtiles,) i32, free_slot,
// cand_ncls (4 S,) i32, cand_x, cand_y, cand_z, cand_m (4 S,) f32; counts
// (4,) i32 zeroed, out (killed, free, wanted, granted)
extern "C" int fp_domainfill(
    void* const* fields, const long long* origin, int n, int nspec,
    void* const* table, int sites, float* acc_out, const float* f3d0,
    const float* f3d1, const float* height, int nz, int ny, int nx, float w0,
    float w1, float lsync, float xpp, float xlo, float xhi, float ylo,
    float yhi, int check_x, int mdomainfill, float ylat0, float dy,
    int itime, int itrasplit, int nclassunc, uint32_t k0, uint32_t k1,
    const float* u1, const float* u2, const int* ncls, uint8_t* free_o,
    int* slot_at_origin, int* tile_free, uint8_t* want, int* tile_want,
    int* free_slot, int* cand_ncls, float* cand_x, float* cand_y,
    float* cand_z, float* cand_m, int* counts, int sms, void* stream) {
  if (n <= 0 || sites <= 0) return 0;
  if (nspec < 1 || nz < 2 || nz > MAX_MET_LEVELS || nclassunc < 1 ||
      sms < 1 || (mdomainfill != 1 && mdomainfill != 2) ||
      (u1 == nullptr) != (u2 == nullptr) ||
      (u1 == nullptr) != (ncls == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Fields f;
  f.x_hi = static_cast<float*>(fields[0]);
  f.x_lo = static_cast<float*>(fields[1]);
  f.y_hi = static_cast<float*>(fields[2]);
  f.y_lo = static_cast<float*>(fields[3]);
  f.z = static_cast<float*>(fields[4]);
  f.itra = static_cast<int*>(fields[5]);
  f.itramem = static_cast<int*>(fields[6]);
  f.npoint = static_cast<int*>(fields[7]);
  f.nclass = static_cast<int*>(fields[8]);
  f.idt = static_cast<int*>(fields[9]);
  f.itrasplit = static_cast<int*>(fields[10]);
  f.up = static_cast<float*>(fields[11]);
  f.vp = static_cast<float*>(fields[12]);
  f.wp = static_cast<float*>(fields[13]);
  f.usig = static_cast<float*>(fields[14]);
  f.vsig = static_cast<float*>(fields[15]);
  f.wsig = static_cast<float*>(fields[16]);
  f.cbt = static_cast<int8_t*>(fields[17]);
  f.mass = static_cast<float*>(fields[18]);
  f.mass0 = static_cast<float*>(fields[19]);
  f.xscav = static_cast<float*>(fields[20]);
  f.active = static_cast<bool*>(fields[21]);
  Table t;
  t.acc = static_cast<const float*>(table[0]);
  t.col_flat = static_cast<const int*>(table[1]);
  t.is_we = static_cast<const bool*>(table[2]);
  t.sgn = static_cast<const float*>(table[3]);
  t.area = static_cast<const float*>(table[4]);
  t.kz = static_cast<const int*>(table[5]);
  t.wlo = static_cast<const float*>(table[6]);
  t.whi = static_cast<const float*>(table[7]);
  t.x_base = static_cast<const float*>(table[8]);
  t.x_span = static_cast<const float*>(table[9]);
  t.y_base = static_cast<const float*>(table[10]);
  t.y_span = static_cast<const float*>(table[11]);
  t.z_base = static_cast<const float*>(table[12]);
  t.z_span = static_cast<const float*>(table[13]);
  t.valid = static_cast<const bool*>(table[14]);
  const Step st = {f3d0, f3d1, height, nz, ny, nx, w0, w1, lsync, xpp, xlo,
                   xhi, ylo, yhi, check_x, mdomainfill, ylat0, dy, itime,
                   itrasplit, nclassunc, k0, k1, u1, u2, ncls};
  const Scratch s = {free_o, slot_at_origin, tile_free, want, tile_want,
                     free_slot, cand_ncls, cand_x, cand_y, cand_z, cand_m,
                     counts};
  const int tiles = (n + TILE - 1) / TILE;
  const int wtiles = (KMAX_EMIT * sites + TILE - 1) / TILE;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  boundary_kill_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, cs>>>(
      f, origin, n, st, s);
  boundary_sites_kernel<<<(sites + THREADS - 1) / THREADS, THREADS, 0, cs>>>(
      t, sites, acc_out, st, s);
  boundary_tile_sums_kernel<<<tiles > wtiles ? tiles : wtiles, THREADS, 0,
                              cs>>>(s, tiles, wtiles);
  boundary_scan_kernel<<<1, SCAN_THREADS, 0, cs>>>(s, tiles, wtiles);
  boundary_ranks_kernel<<<tiles, THREADS, 0, cs>>>(s);
  boundary_emit_kernel<<<wtiles, THREADS, 0, cs>>>(f, nspec, st, s);
  return static_cast<int>(cudaGetLastError());
}

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
// Design (origin_rank.cuh): the free flags in origin order and the wishes
// in (round, site) order are two bitmaps (1.4 MB and 0.35 MB at 11 x 2**20
// slots and 694,479 sites), zeroed with the killed count by one memset.
//  1. sites and kill, one launch over two ranges of blocks: per slot, in
//     slot order, destroy an active particle outside the window
//     (its itra unscheduled), then set its free bit (inactive and no
//     future release) at its origin (atomicOr, the lanes of one word
//     sending one; a warp's ballot where the origin is the identity) and
//     in slot order, the killed count by a warp ballot; per site the wind
//     normal to its face and the density at both met times (four gathers
//     each, linear in height), the mass flux and the accumulator, the
//     integer emission count, and per round the draws (Philox of counter
//     (site, round, 0, 0), or injected), the new particle's position, mass
//     and class, and the wish (MDOMAINFILL=2: only above 3 km and where
//     the PV at the site's column exceeds pvcrit, the mass the ozone
//     proxy's), a warp's 32 wishes of a round set as one run of bits;
//  2. scan: both bitmaps' words, one pass with a decoupled look-back; the
//     last tile writes the counts: killed, free, wanted, granted =
//     min(free, wanted);
//  3. ranks: per free slot (the kill pass's bitmap in slot order), in
//     slot order, its rank among the free ones from its word; the slot of
//     rank r < granted into a list;
//  4. emit: one thread per wish, in (round, site) order: a granted wish
//     (its rank from its word below granted) writes its 22 fields into the
//     free slot of its rank.  Walking the ranks instead (the wish of each
//     rank listed by pass 3) measured 1.20x slower with 993,289 new
//     particles (NVIDIA H100).
//
// A rank of a data-parallel run holds the group's free slots of ranks
// free_base .. free_base + free - 1 (the ranks before it hold the lower
// ones) and the same sites and draws as every rank: it writes the wishes
// whose rank falls there, each into its free slot of rank (wish rank -
// free_base).  Alone free_base is 0 and the step is the one above.
//
// Arithmetic: the plain version's float32 operations in its order
// (-fmad=false); the ranking is integer.  So the kernel and its plain
// version agree bit for bit, and two runs of one seed do.
//
// Bound on the H100: by bytes, what the step needs of the slots (every
// active flag; a live slot's x and y, hi and lo; a dead one's itra, and
// its itramem where itra is scheduled; a free one's int64 origin), per
// site its 15 table entries and accumulator (62 B) and 16 gathers (64 B;
// 32 more with MDOMAINFILL=2), per killed slot its active and itra, per
// new particle its fields (70 + 8 nspec B); by 32 B sectors the same,
// each access set by its distinct sectors (chip_smoke.k14_bounds).  At
// 11 x 2**20 slots, 10.5 M of them live, 0.08-0.11 ms by bytes, 0.07-0.10
// by sectors; the launch of the kill and the sites alone takes about
// twice that (0.16-0.17 ms).  Loading the position or itra only where the
// slot is live or dead (a chain of two loads) measured 8-9% slower in that
// launch than loading them at once; the live slots' origins are not read.
//
// The first K14: flags as bytes and each slot's number scattered
// into origin order (two scattered writes a slot), six launches, a rank
// pass and an emission walking 16 flags a thread, scratch made by the
// wrapper on every call.
#include <cstdint>
#include <cuda_runtime.h>

#include "origin_rank.cuh"
#include "philox_normal.cuh"

namespace {

constexpr int THREADS = 256;
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
  fp::Ranking r;                           // a: free slots; b: wishes
  long long want_base;                     // b's first word
  int* killed;                             // zeroed
  uint32_t* free_at_slot;                  // the free bits in slot order
  int* free_slot;                          // (KMAX_EMIT * S,): by rank
  int* cand_ncls;                          // (KMAX_EMIT * S,)
  float *cand_x, *cand_y, *cand_z, *cand_m;
  int* counts;                             // killed, free, wanted, granted
  const long long* free_base;              // a rank's first free rank, or NULL
};

// the group's free rank of this rank's first free slot (a data-parallel
// run: the free slots of the ranks before it; alone 0)
__device__ __forceinline__ long long first_free(const Scratch& s) {
  return s.free_base == nullptr ? 0 : *s.free_base;
}

// per slot of block b: the kill, the free bit at its origin, the killed
// count
__device__ __forceinline__ void kill_slots(int b, Fields& f,
                                           const long long* origin, int n,
                                           const Step& st, Scratch& s) {
  const int k = b * THREADS + threadIdx.x;
  bool kill = false, is_free = false;
  long long o = -1;
  if (k < n) {
    // active, itra and the position loaded at once (x only where the
    // window is checked in x); itramem only where itra is scheduled, and
    // the origin only of a free slot, a killed one included (its itra
    // unscheduled): the live slots' origins are not read
    const bool active = f.active[k];
    const int itra = f.itra[k];
    const float y = f.y_hi[k] + f.y_lo[k];
    bool outside = y < st.ylo || y > st.yhi;
    if (st.check_x) {
      const float x = f.x_hi[k] + f.x_lo[k];
      outside = outside || x < st.xlo || x > st.xhi;
    }
    if (active) {
      kill = outside;
      if (kill) {
        f.active[k] = false;
        f.itra[k] = ITRA_INACTIVE;
      }
      is_free = kill;
    } else {
      is_free = itra == ITRA_INACTIVE || itra != f.itramem[k];
    }
    if (is_free) {
      o = fp::origin_of(origin, k, n);
      is_free = o >= 0;
    }
  }
  const unsigned killed = __ballot_sync(0xffffffffu, kill);
  if ((threadIdx.x & 31) == 0 && killed != 0u)
    atomicAdd(s.killed, __popc(killed));
  if (origin == nullptr)                   // uniform over the grid
    fp::write_warp_word(s.r.bits, k >> 5, is_free);
  else
    fp::set_flag(s.r.bits, o, is_free);
  fp::write_warp_word(s.free_at_slot, k >> 5, is_free);
}

// f3d[field][klev] at a column
__device__ __forceinline__ float sample(const float* f3d, int field, int klev,
                                        long long col, const Step& st) {
  const long long nyx = static_cast<long long>(st.ny) * st.nx;
  return f3d[(static_cast<long long>(field) * st.nz + klev) * nyx + col];
}

// per site of block sb: the flux, the accumulator, the count and the wishes
__device__ __forceinline__ void boundary_sites(int sb, const Table& t,
                                               int sites,
                                               float* __restrict__ acc_out,
                                               const Step& st, Scratch& s) {
  __shared__ float height[MAX_MET_LEVELS];
  for (int i = threadIdx.x; i < st.nz; i += THREADS) height[i] = st.height[i];
  __syncthreads();
  const int i = sb * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in = i < sites;
  long long col = 0;
  bool valid = false;
  float emit = 0.0f;
  if (in) {
    col = t.col_flat[i];
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
    valid = t.valid[i];
    float a = flux >= 0.0f ? t.acc[i] + flux : 0.0f;
    a = valid ? a : 0.0f;
    // the integer emission count (boundcond_domainfill.f90:135-142)
    const float half = st.xpp * 0.5f;
    const float mmass = a >= half ? floorf((a + half) / st.xpp) : 0.0f;
    a = a - mmass * st.xpp;
    emit = fminf(mmass, static_cast<float>(KMAX_EMIT));
    a = a + (mmass - emit) * st.xpp;
    acc_out[i] = a;
  }
  for (int r = 0; r < KMAX_EMIT; ++r) {
    const long long w = static_cast<long long>(r) * sites + i;
    bool want = false;
    if (in) {
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
      want = valid && emit > static_cast<float>(r);
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
      s.cand_x[w] = xnew;
      s.cand_y[w] = ynew;
      s.cand_z[w] = znew;
      s.cand_m[w] = m;
      s.cand_ncls[w] = ncls;
    }
    // the warp's wishes of this round: flags w - lane .. w - lane + 31
    const unsigned run = __ballot_sync(0xffffffffu, want);
    if (lane == 0) fp::set_run(s.r.bits + s.want_base, w, run);
  }
}

// the sites' blocks, then the slots' (the other order measured the same)
__global__ void __launch_bounds__(THREADS)
boundary_kill_sites_kernel(Fields f, const long long* __restrict__ origin,
                           int n, int site_blocks, const Table t, int sites,
                           float* __restrict__ acc_out, const Step st,
                           Scratch s) {
  if (blockIdx.x < site_blocks)
    boundary_sites(blockIdx.x, t, sites, acc_out, st, s);
  else
    kill_slots(blockIdx.x - site_blocks, f, origin, n, st, s);
}

__global__ void __launch_bounds__(fp::RANK_THREADS)
boundary_scan_kernel(Scratch s) {
  int n_free, n_want;
  if (fp::rank_scan_tile(s.r, &n_free, &n_want)) {
    s.counts[0] = *s.killed;
    s.counts[1] = n_free;
    s.counts[2] = n_want;
    // granted: the wishes that land in this rank's free slots, the group's
    // wishes first_free .. first_free + free - 1 (alone min(free, wanted))
    const long long left = n_want - first_free(s);
    s.counts[3] = left < 0 ? 0 : (left < n_free ? static_cast<int>(left)
                                                : n_free);
  }
}

// the free slot of each rank below granted: per free slot (the kill
// pass's bitmap in slot order), its rank among the free ones
__global__ void __launch_bounds__(fp::RANK_THREADS)
boundary_ranks_kernel(const long long* __restrict__ origin, int n,
                      Scratch s) {
  const int granted = s.counts[3];
  if (granted == 0) return;
  fp::rank_flagged_slots(origin, n, s.free_at_slot, [&](int k, long long o) {
    fp::list_by_rank(s.r, 0, o, k, granted, s.free_slot);
  });
}

// one new particle: wish w into free slot c (the wish's loads issued
// before the first store, as K13's copy_pair)
__device__ __forceinline__ void emit_into(Fields& f, int nspec, int w, int c,
                                          const Step& st, const Scratch& s) {
  const float x = s.cand_x[w], y = s.cand_y[w], z = s.cand_z[w],
              m = s.cand_m[w];
  const int ncls = s.cand_ncls[w];
  f.x_hi[c] = x;
  f.x_lo[c] = 0.0f;
  f.y_hi[c] = y;
  f.y_lo[c] = 0.0f;
  f.z[c] = z;
  f.itra[c] = st.itime;
  f.itramem[c] = st.itime;
  f.itrasplit[c] = st.itrasplit;
  f.npoint[c] = 0;
  f.nclass[c] = ncls;
  f.idt[c] = 0;
  f.up[c] = f.vp[c] = f.wp[c] = 0.0f;
  f.usig[c] = f.vsig[c] = f.wsig[c] = 0.0f;
  f.cbt[c] = 1;
  const long long row = static_cast<long long>(c) * nspec;
  for (int k = 0; k < nspec; ++k) {
    f.mass[row + k] = m;
    f.mass0[row + k] = m;
  }
  f.active[c] = true;
}

// one thread per wish, in (round, site) order
__global__ void __launch_bounds__(THREADS)
boundary_emit_kernel(Fields f, int nspec, int wishes, const Step st,
                     Scratch s) {
  const int granted = s.counts[3];
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= wishes) return;
  const int rw = fp::flag_rank(s.r, s.want_base, w);
  if (rw < 0) return;
  const long long local = rw - first_free(s);
  if (local >= 0 && local < granted)
    emit_into(f, nspec, w, s.free_slot[local], st, s);
}

}  // namespace

// fields: the 22 pointers of Particles in core/state.py FIELDS order, each
// updated in place; origin (n,) int64, a permutation of 0..n-1, or NULL
// (the identity); table: the 15 site pointers of core/domainfill.py
// BOUNDARY_FIELDS[:15], (S,) each; acc_out (S,) f32; f3d0, f3d1 (NF3, nz,
// ny, nx) f32 and height (nz,) f32; injected draws u1, u2 (4, S) f32 and
// ncls (4, S) i32, or all NULL; scratch (core/origin_rank.py::rank_plan,
// with flags n and 4 S): bits and prefix, the free flags' tiles_a tiles
// then the wishes', status (tiles,) u64, ticket, killed, zero_bytes from
// bits on zeroed here (the bits, status, ticket and killed), free_at_slot
// (ceil(n / 256) * 8,) u32 (the free bits in slot order), free_slot,
// cand_ncls (4 S,) i32, cand_x, cand_y, cand_z, cand_m (4 S,)
// f32; free_base (1,) i64, the group's free rank of this rank's first
// free slot (a data-parallel run's rank; parallel/sharding.py), or NULL
// (0: the slots alone); counts (4,) i32 out (killed, free, wanted,
// granted: the new particles written here)
extern "C" int fp_domainfill(
    void* const* fields, const long long* origin, int n, int nspec,
    void* const* table, int sites, float* acc_out, const float* f3d0,
    const float* f3d1, const float* height, int nz, int ny, int nx, float w0,
    float w1, float lsync, float xpp, float xlo, float xhi, float ylo,
    float yhi, int check_x, int mdomainfill, float ylat0, float dy,
    int itime, int itrasplit, int nclassunc, uint32_t k0, uint32_t k1,
    const float* u1, const float* u2, const int* ncls, uint32_t* bits,
    int* prefix, unsigned long long* status, int* ticket, int* killed,
    long long zero_bytes, int tiles_a, int tiles, uint32_t* free_at_slot,
    int* free_slot, int* cand_ncls, float* cand_x, float* cand_y,
    float* cand_z, float* cand_m, const long long* free_base, int* counts,
    void* stream) {
  if (n <= 0) return 0;
  const long long wishes = static_cast<long long>(KMAX_EMIT) * sites;
  const long long flags_a = static_cast<long long>(tiles_a) *
                            fp::RANK_TILE_WORDS * 32;
  if (nspec < 1 || nz < 2 || nz > MAX_MET_LEVELS || nclassunc < 1 ||
      sites < 0 || (mdomainfill != 1 && mdomainfill != 2) ||
      (u1 == nullptr) != (u2 == nullptr) ||
      (u1 == nullptr) != (ncls == nullptr) || tiles_a < 1 ||
      tiles <= tiles_a || flags_a < n ||
      (tiles - tiles_a) * static_cast<long long>(fp::RANK_TILE_WORDS) * 32 <
          wishes)
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
  const fp::Ranking r = {bits, prefix, status, ticket, tiles_a, tiles};
  const Scratch s = {r, static_cast<long long>(tiles_a) *
                            fp::RANK_TILE_WORDS,
                     killed, free_at_slot, free_slot, cand_ncls, cand_x,
                     cand_y, cand_z, cand_m, counts, free_base};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bits, 0, static_cast<size_t>(zero_bytes),
                                    cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slot_blocks = (n + THREADS - 1) / THREADS;
  const int wish_blocks = static_cast<int>((wishes + THREADS - 1) / THREADS);
  const int site_blocks = (sites + THREADS - 1) / THREADS;
  boundary_kill_sites_kernel<<<site_blocks + slot_blocks, THREADS, 0, cs>>>(
      f, origin, n, site_blocks, t, sites, acc_out, st, s);
  boundary_scan_kernel<<<tiles, fp::RANK_THREADS, 0, cs>>>(s);
  boundary_ranks_kernel<<<fp::rank_blocks(n), fp::RANK_THREADS, 0, cs>>>(
      origin, n, s);
  if (wish_blocks > 0)
    boundary_emit_kernel<<<wish_blocks, THREADS, 0, cs>>>(
        f, nspec, static_cast<int>(wishes), st, s);
  return static_cast<int>(cudaGetLastError());
}

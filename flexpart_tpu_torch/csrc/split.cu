// K13: particle splitting, every live particle whose next-split time has
// passed duplicated into a free slot, parent and child each with half the
// mass and the doubled split interval.
//
// Replaces: flexpart_tpu/core/split.py::split_particles (:26-70;
// timemanager.f90:473-504), which JAX leaves to XLA as two cumsums, a
// scatter of the free slots' ranks and one masked scatter per field.  The
// reference ranks the free slots and the due particles by slot index and
// gives the r-th due particle the r-th free slot, while free slots last
// (its maxpart guard).  The port keeps its particles in met-cell order, so
// both are ranked by the slot's schedule origin (``_origin``: the
// reference's slot index of the particle in each port slot): the same
// parents are granted as in the reference, each child goes to the port
// slot that holds the reference's child slot, and ``_origin`` stays a
// permutation.  A slot is free if inactive and not a future release (its
// itra unscheduled or not its release time); a particle is due if active,
// its itrasplit scheduled and ldirect * itime >= ldirect * itrasplit.
//
// Design (origin_rank.cuh): the free and the due flags are two bitmaps in
// origin order (3 MB at 12 x 2**20 slots, in L2), zeroed by one memset.
//  1. flags: per slot, in slot order, its free and due bits set at its
//     origin (atomicOr; a warp's ballot where the origin is the identity);
//  2. scan: the bitmaps' words, one pass with a decoupled look-back; the
//     last tile writes the counts: due, free, granted = min(due, free);
//  3. ranks: per flagged slot (the flags pass's bitmap in slot order), in
//     slot order, its rank among the free and among the due ones from its
//     word (prefix + popcount below); the r-th free slot and the r-th due
//     one, r < granted, into two lists;
//  4. copy: one thread per granted rank (a grid-stride loop over a
//     resident grid) copies every field of the r-th due particle into the
//     r-th free slot, halves both masses, sets both split times to 2 *
//     (itrasplit - itramem) + itramem (clipped into int32 as the reference
//     clips) and the child active.  Walking the parents in slot order
//     instead, each finding its rank again, measured 1.70x slower after a
//     sort (12 x 2**20 slots, NVIDIA H100).
// A rank of a data-parallel run splits its share of the group's split
// (Share): its due particles and free slots keep their ranks, offset by the
// group's counts on the ranks before it; a parent whose child lands on
// another rank is updated here and its row sent by the caller.  Alone
// (granted -1) both offsets are 0 and the kernel is the split above.
// The particle fields are updated in place: parents and children are
// disjoint (active, inactive), so no slot is read and written by two
// threads.  The counts stay on the card.
//
// Arithmetic: integer ranks and copies; the halved mass is one float
// multiplication, so the kernel and its plain version agree bit for bit.
//
// Bound on the H100: by 32 B sectors, what the split needs of the slots
// (every active flag; a live slot's itrasplit; a dead one's itra, and its
// itramem where itra is scheduled; a due or free one's origin) and, per
// access set of the pairs, its distinct sectors: a parent's 21 fields
// read and 2 written, a child's 22 written, 45 sectors a pair where
// parents and children lie apart; at 12 x 2**20 slots with 1.3 to 3.1 M
// pairs 0.23-0.53 ms (0.64 ms were each access a sector of its own), by
// bytes 0.10-0.20 ms (chip_smoke.k13_bounds).  The copy, whose pairs lie
// at random after a sort, takes most of the time.
//
// The first K13: flags as bytes and each slot's number scattered
// into origin order (three scattered writes a slot), tile sums, a
// one-block scan, a rank pass walking 16 origins a thread, the copy.
#include <cstdint>
#include <cuda_runtime.h>

#include "origin_rank.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COPY_BLOCKS_PER_SM = 8;      // the copy's resident grid
constexpr int ITRA_INACTIVE = -999999999;

struct Fields {
  float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  int *itra, *itramem, *npoint, *nclass, *idt, *itrasplit;
  float *up, *vp, *wp, *usig, *vsig, *wsig;
  int8_t* cbt;
  float *mass, *mass0, *xscav;             // (n, nspec)
  bool* active;
};

__global__ void __launch_bounds__(THREADS)
split_flags_kernel(const Fields f, const long long* __restrict__ origin,
                   int n, int itime, int ldirect, fp::Ranking r,
                   long long due_words, uint32_t* __restrict__ flagged) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  bool due = false, is_free = false;
  long long o = -1;
  if (k < n) {
    // every slot's origin, active, itra and split time loaded at once:
    // loading the origin only for a due or free slot, and the split time
    // or itra only for a live or dead one, chains two or three loads and
    // measured 13-24% slower in this pass (NVIDIA H100)
    o = fp::origin_of(origin, k, n);
    const bool active = f.active[k];
    const int itra = f.itra[k];
    const int split = f.itrasplit[k];
    due = o >= 0 && active && split != ITRA_INACTIVE &&
          static_cast<long long>(ldirect) * itime >=
              static_cast<long long>(ldirect) * split;
    is_free = o >= 0 && !active &&
              (itra == ITRA_INACTIVE || itra != f.itramem[k]);
  }
  if (origin == nullptr) {                 // uniform over the grid
    fp::write_warp_word(r.bits, k >> 5, is_free);
    fp::write_warp_word(r.bits + due_words, k >> 5, due);
  } else {
    fp::set_flag(r.bits, o, is_free);
    fp::set_flag(r.bits + due_words, o, due);
  }
  fp::write_warp_word(flagged, k >> 5, is_free || due);
}

// A rank's share of a split over a process group (a data-parallel run;
// parallel/sharding.py::split_sharded): the global due rank of its first
// due particle and the global free rank of its first free slot, in the
// group's origin order (rank-major), and the group's granted count.  The
// rank's due particle j is the group's due particle due_base + j; its child
// goes to the group's free slot of that rank, which lies on this rank as
// its free slot j + due_base - free_base where that falls in 0 .. free - 1,
// else on another rank (its row sent there by the caller).  granted < 0 is
// a split of this rank alone: both bases 0 and granted = min(due, free).
struct Share {
  long long due_base, free_base, granted;
};

// from the counts of the scan: the due particles granted a child, the free
// slots that take one, and the due ranks [lo, hi) whose child lands here
struct Limits {
  int parents, takers, lo, hi;
};

__device__ __forceinline__ long long clamp_to(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ Limits share_limits(const Share& sh,
                                               const int* counts) {
  const int due = counts[0], n_free = counts[1];
  Limits l;
  if (sh.granted < 0) {
    l.parents = l.takers = l.hi = due < n_free ? due : n_free;
    l.lo = 0;
    return l;
  }
  l.parents = static_cast<int>(clamp_to(sh.granted - sh.due_base, due));
  l.takers = static_cast<int>(clamp_to(sh.granted - sh.free_base, n_free));
  const long long shift = sh.due_base - sh.free_base;
  l.lo = static_cast<int>(clamp_to(-shift, l.parents));
  l.hi = static_cast<int>(clamp_to(l.takers - shift, l.parents));
  if (l.hi < l.lo) l.hi = l.lo;
  return l;
}

__global__ void __launch_bounds__(fp::RANK_THREADS)
split_scan_kernel(const fp::Ranking r, const Share sh, int* counts) {
  int n_free, n_due;
  if (fp::rank_scan_tile(r, &n_free, &n_due)) {
    counts[0] = n_due;
    counts[1] = n_free;
    // granted: the parents that get a child (a share's, wherever the child
    // lands)
    counts[2] = share_limits(sh, counts).parents;
  }
}

// per slot free or due, its rank among the free and among the due ones;
// the free slots that take a child and the due particles granted one into
// their lists, by rank
__global__ void __launch_bounds__(fp::RANK_THREADS)
split_ranks_kernel(const long long* __restrict__ origin, int n,
                   const fp::Ranking r, long long due_words,
                   const uint32_t* __restrict__ flagged,
                   int* __restrict__ free_slot, int* __restrict__ due_slot,
                   const Share sh, const int* __restrict__ counts) {
  const Limits l = share_limits(sh, counts);
  if (l.parents == 0 && l.takers == 0) return;
  fp::rank_flagged_slots(origin, n, flagged, [&](int k, long long o) {
    fp::list_by_rank(r, 0, o, k, l.takers, free_slot);
    fp::list_by_rank(r, due_words, o, k, l.parents, due_slot);
  });
}

// parent p's fields into child c, both masses halved, both split times
// doubled.  Each load next to its store: issuing every load first needs
// 64 registers, half the warps an SM holds, and ran 9% slower after a sort.
__device__ __forceinline__ void copy_pair(const Fields& f, int nspec, int p,
                                          int c) {
  f.x_hi[c] = f.x_hi[p];
  f.x_lo[c] = f.x_lo[p];
  f.y_hi[c] = f.y_hi[p];
  f.y_lo[c] = f.y_lo[p];
  f.z[c] = f.z[p];
  f.itra[c] = f.itra[p];
  const int itramem = f.itramem[p];
  f.itramem[c] = itramem;
  f.npoint[c] = f.npoint[p];
  f.nclass[c] = f.nclass[p];
  f.idt[c] = f.idt[p];
  f.up[c] = f.up[p];
  f.vp[c] = f.vp[p];
  f.wp[c] = f.wp[p];
  f.usig[c] = f.usig[p];
  f.vsig[c] = f.vsig[p];
  f.wsig[c] = f.wsig[p];
  f.cbt[c] = f.cbt[p];
  f.active[c] = true;
  // the doubled interval, clipped before doubling so that 2 dt + itramem
  // stays in int32 (split.py:48-50)
  long long dt = static_cast<long long>(f.itrasplit[p]) - itramem;
  dt = dt < -499999999LL ? -499999999LL : (dt > 499999999LL ? 499999999LL : dt);
  long long next = 2 * dt + itramem;
  next = next < -999999998LL ? -999999998LL
                             : (next > 999999999LL ? 999999999LL : next);
  f.itrasplit[p] = f.itrasplit[c] = static_cast<int>(next);
  const long long rp = static_cast<long long>(p) * nspec;
  const long long rc = static_cast<long long>(c) * nspec;
  for (int k = 0; k < nspec; ++k) {
    const float half = f.mass[rp + k] * 0.5f;
    f.mass[rp + k] = half;
    f.mass[rc + k] = half;
    f.mass0[rc + k] = f.mass0[rp + k];
    f.xscav[rc + k] = f.xscav[rp + k];
  }
}

// a parent whose child lands on another rank: both masses halved and the
// split time doubled here, the child's row taken from it by the caller
__device__ __forceinline__ void update_parent(const Fields& f, int nspec,
                                              int p) {
  const int itramem = f.itramem[p];
  long long dt = static_cast<long long>(f.itrasplit[p]) - itramem;
  dt = dt < -499999999LL ? -499999999LL : (dt > 499999999LL ? 499999999LL : dt);
  long long next = 2 * dt + itramem;
  next = next < -999999998LL ? -999999998LL
                             : (next > 999999999LL ? 999999999LL : next);
  f.itrasplit[p] = static_cast<int>(next);
  const long long rp = static_cast<long long>(p) * nspec;
  for (int k = 0; k < nspec; ++k) f.mass[rp + k] = f.mass[rp + k] * 0.5f;
}

__global__ void __launch_bounds__(THREADS)
split_copy_kernel(Fields f, int nspec, const int* __restrict__ free_slot,
                  const int* __restrict__ due_slot, const Share sh,
                  const int* __restrict__ counts) {
  const Limits l = share_limits(sh, counts);
  const long long shift = sh.granted < 0 ? 0 : sh.due_base - sh.free_base;
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < l.parents;
       q += gridDim.x * THREADS) {
    if (q >= l.lo && q < l.hi)
      copy_pair(f, nspec, due_slot[q], free_slot[static_cast<int>(q + shift)]);
    else
      update_parent(f, nspec, due_slot[q]);
  }
}

}  // namespace

// fields: the 22 pointers of Particles in core/state.py FIELDS order, each
// updated in place; origin (n,) int64, a permutation of 0..n-1, or NULL
// (the identity); scratch (core/origin_rank.py::rank_plan, with flags n
// and n): bits and prefix (2 tiles * RANK_TILE_WORDS,) each, status
// (2 tiles,) u64, ticket, zero_bytes from bits on zeroed here (the bits,
// status and ticket), flagged (ceil(n / 256) * 8,) u32 (per slot in slot
// order, free or due), free_slot and due_slot, i32, by rank (n / 2 + 1,)
// each alone, (n,) each in a share; due_base, free_base, granted: the
// rank's share of a group's split (Share; granted -1: the split of these
// slots alone); counts (3,) i32 out (due, free, granted: the parents
// granted a child)
extern "C" int fp_split(void* const* fields, const long long* origin, int n,
                        int nspec, int itime, int ldirect, uint32_t* bits,
                        int* prefix, unsigned long long* status, int* ticket,
                        long long zero_bytes, int tiles, uint32_t* flagged,
                        int* free_slot, int* due_slot, long long due_base,
                        long long free_base, long long granted, int* counts,
                        int sms, void* stream) {
  if (n <= 0) return 0;
  if (nspec < 1 || sms < 1 || tiles < 1 ||
      static_cast<long long>(tiles) * fp::RANK_TILE_WORDS * 32 < n)
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
  if (granted >= 0 && (due_base < 0 || free_base < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Share sh = {due_base, free_base, granted};
  const fp::Ranking r = {bits, prefix, status, ticket, tiles, 2 * tiles};
  const long long due_words = static_cast<long long>(tiles) *
                              fp::RANK_TILE_WORDS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bits, 0, static_cast<size_t>(zero_bytes),
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slot_blocks = (n + THREADS - 1) / THREADS;
  split_flags_kernel<<<slot_blocks, THREADS, 0, st>>>(
      f, origin, n, itime, ldirect, r, due_words, flagged);
  split_scan_kernel<<<2 * tiles, fp::RANK_THREADS, 0, st>>>(r, sh, counts);
  split_ranks_kernel<<<fp::rank_blocks(n), fp::RANK_THREADS, 0, st>>>(
      origin, n, r, due_words, flagged, free_slot, due_slot, sh, counts);
  split_copy_kernel<<<sms * COPY_BLOCKS_PER_SM, THREADS, 0, st>>>(
      f, nspec, free_slot, due_slot, sh, counts);
  return static_cast<int>(cudaGetLastError());
}

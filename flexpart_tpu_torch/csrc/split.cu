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
// Passes (no CUB or Thrust):
//  1. flags: per slot, its free and due flags (bytes) and its slot number
//     written at its origin, into origin order;
//  2. tile sums: per tile of 4096 origins, the free and the due count;
//  3. tile scan: one block scans the tile counts (exclusive, in place) and
//     writes the totals: due, free and granted = min(due, free);
//  4. ranks: per tile, each origin's rank among the free and among the
//     due ones (a block-wide exclusive scan plus its tile's offset); the
//     slot of the r-th free origin and of the r-th due one, for r <
//     granted, are written to two lists;
//  5. copy: one thread per granted rank copies every field of the r-th
//     due particle into the r-th free slot, halves both masses, sets both
//     split times to 2 * (itrasplit - itramem) + itramem (clipped into
//     int32 as the reference clips) and the child active.
// The particle fields are updated in place: parents and children are
// disjoint (active, inactive), so no slot is read and written by two
// threads.  The counts (due, free, granted) stay on the card.
//
// Arithmetic: integer ranks and copies; the halved mass is one float
// multiplication, so the kernel and its plain version agree bit for bit.
//
// Bound on the H100: the flags read 21 B a slot (active, itra, itramem,
// itrasplit, the int64 origin): 0.08 ms for 12 x 2**20 slots, and each
// granted pair reads its parent's 70 + 12 nspec B and writes them to the
// child, with the parent's mass and split time.
//
// Design: the flags are bytes in origin order, read by passes 2 and 4 as
// one 16-byte load a thread (16 origins), so that the scans touch 2 B an
// origin; pass 4 rereads the flags rather than storing per-origin ranks
// (reduce, then scan).
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using fp::block_scan2;
using fp::byte_sum;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                  // origins per thread: one uint4
constexpr int TILE = THREADS * ITEMS;      // origins per tile
constexpr int SCAN_THREADS = 1024;
constexpr int COPY_THREADS = 256;
constexpr int ITRA_INACTIVE = -999999999;

struct Fields {
  float *x_hi, *x_lo, *y_hi, *y_lo, *z;
  int *itra, *itramem, *npoint, *nclass, *idt, *itrasplit;
  float *up, *vp, *wp, *usig, *vsig, *wsig;
  int8_t* cbt;
  float *mass, *mass0, *xscav;             // (n, nspec)
  bool* active;
};

struct Scratch {
  uint8_t *free_o, *due_o;                 // (tiles * TILE,) zeroed
  int* slot_at_origin;                     // (n,)
  int *tile_free, *tile_due;               // (tiles,)
  int *free_slot, *due_slot;               // (n,): by rank
  int* counts;                             // (3,): due, free, granted
};

__global__ void __launch_bounds__(THREADS)
flags_kernel(const Fields f, const long long* __restrict__ origin, int n,
             int itime, int ldirect, Scratch s) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= n) return;
  const long long o = origin == nullptr ? k : origin[k];
  if (o < 0 || o >= n) return;
  const bool active = f.active[k];
  const int itra = f.itra[k];
  const int split = f.itrasplit[k];
  const bool due = active && split != ITRA_INACTIVE &&
                   static_cast<long long>(ldirect) * itime >=
                       static_cast<long long>(ldirect) * split;
  const bool is_free =
      !active && (itra == ITRA_INACTIVE || itra != f.itramem[k]);
  s.free_o[o] = is_free ? 1 : 0;
  s.due_o[o] = due ? 1 : 0;
  s.slot_at_origin[o] = k;
}

__global__ void __launch_bounds__(THREADS)
tile_sums_kernel(Scratch s) {
  __shared__ int part[2][THREADS / 32];
  const size_t at = static_cast<size_t>(blockIdx.x) * TILE +
                    static_cast<size_t>(threadIdx.x) * ITEMS;
  int a = byte_sum(*reinterpret_cast<const uint4*>(s.free_o + at));
  int b = byte_sum(*reinterpret_cast<const uint4*>(s.due_o + at));
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ta = 0, tb = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      ta += part[0][i];
      tb += part[1][i];
    }
    s.tile_free[blockIdx.x] = ta;
    s.tile_due[blockIdx.x] = tb;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles_kernel(Scratch s, int tiles) {
  int carry_a = 0, carry_b = 0;
  for (int base = 0; base < tiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    int a = i < tiles ? s.tile_free[i] : 0;
    int b = i < tiles ? s.tile_due[i] : 0;
    int ta, tb;
    block_scan2<SCAN_THREADS>(a, b, &ta, &tb);
    if (i < tiles) {
      s.tile_free[i] = carry_a + a;
      s.tile_due[i] = carry_b + b;
    }
    carry_a += ta;
    carry_b += tb;
  }
  if (threadIdx.x == 0) {
    s.counts[0] = carry_b;                 // due
    s.counts[1] = carry_a;                 // free
    s.counts[2] = carry_b < carry_a ? carry_b : carry_a;   // granted
  }
}

__global__ void __launch_bounds__(THREADS)
ranks_kernel(Scratch s) {
  const size_t at = static_cast<size_t>(blockIdx.x) * TILE +
                    static_cast<size_t>(threadIdx.x) * ITEMS;
  const uint4 fv = *reinterpret_cast<const uint4*>(s.free_o + at);
  const uint4 dv = *reinterpret_cast<const uint4*>(s.due_o + at);
  int a = byte_sum(fv), b = byte_sum(dv);
  int ta, tb;
  block_scan2<THREADS>(a, b, &ta, &tb);
  if (ta == 0 && tb == 0) return;
  const int granted = s.counts[2];
  int rf = s.tile_free[blockIdx.x] + a;
  int rd = s.tile_due[blockIdx.x] + b;
  const uint8_t* fb = reinterpret_cast<const uint8_t*>(&fv);
  const uint8_t* db = reinterpret_cast<const uint8_t*>(&dv);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (fb[i]) {
      if (rf < granted) s.free_slot[rf] = s.slot_at_origin[at + i];
      ++rf;
    }
    if (db[i]) {
      if (rd < granted) s.due_slot[rd] = s.slot_at_origin[at + i];
      ++rd;
    }
  }
}

__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(Fields f, int nspec, Scratch s) {
  const int granted = s.counts[2];
  for (int r = blockIdx.x * COPY_THREADS + threadIdx.x; r < granted;
       r += gridDim.x * COPY_THREADS) {
    const int p = s.due_slot[r];
    const int c = s.free_slot[r];
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
}

}  // namespace

// fields: the 22 pointers of Particles in core/state.py FIELDS order, each
// updated in place; origin (n,) int64, a permutation of 0..n-1, or NULL
// (the identity); scratch: free_o and due_o (tiles * 4096,) uint8 zeroed,
// slot_at_origin, free_slot, due_slot (n,) int32, tile_free, tile_due
// (tiles,) int32, counts (3,) int32 out (due, free, granted)
extern "C" int fp_split(void* const* fields, const long long* origin, int n,
                        int nspec, int itime, int ldirect, uint8_t* free_o,
                        uint8_t* due_o, int* slot_at_origin, int* tile_free,
                        int* tile_due, int* free_slot, int* due_slot,
                        int* counts, int sms, void* stream) {
  if (n <= 0) return 0;
  if (nspec < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  const Scratch s = {free_o, due_o, slot_at_origin, tile_free, tile_due,
                     free_slot, due_slot, counts};
  const int tiles = (n + TILE - 1) / TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flags_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      f, origin, n, itime, ldirect, s);
  tile_sums_kernel<<<tiles, THREADS, 0, st>>>(s);
  scan_tiles_kernel<<<1, SCAN_THREADS, 0, st>>>(s, tiles);
  ranks_kernel<<<tiles, THREADS, 0, st>>>(s);
  copy_kernel<<<sms * 8, COPY_THREADS, 0, st>>>(f, nspec, s);
  return static_cast<int>(cudaGetLastError());
}

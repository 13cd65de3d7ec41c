// Ranking flagged slots by their schedule origin, shared by the kernels
// that hand free slots out in that order: K13's splitting and K14's
// boundary step.
//
// A ranking holds two bitmaps ("segments"), a and b, each one bit a flag
// (K13: a slot free at origin o, a slot due at origin o; K14: a slot free
// at origin o, the w-th wish in (round, site) order), padded to whole
// scan tiles of RANK_TILE_WORDS 32-bit words and laid one after the other.
// The flags are set by atomicOr at their origin (a warp's ballot where
// the origin is the identity); one pass scans the words' popcounts, tiles
// in the order of a ticket, each tile's prefix found by a decoupled
// look-back over the tiles before it in its segment (a warp reads 32 of
// their states at a time); it writes, per word, the set bits of its
// segment before it.  A flag's rank is then that prefix plus the set bits
// below it in its word.  The bitmaps, the tiles' states and the ticket are
// zeroed by the launcher (one cudaMemsetAsync) before the flags are set.
// No CUB.
#pragma once
#include <cstdint>

namespace fp {

constexpr int RANK_THREADS = 256;
constexpr int RANK_ITEMS = 16;             // words a thread scans
constexpr int RANK_TILE_WORDS = RANK_THREADS * RANK_ITEMS;   // 131,072 flags
constexpr int RANK_SLOTS = 8;              // slots a thread of a ranks pass

// a tile's state: its count in the low 32 bits, above them whether it is
// the tile's own (AGGREGATE) or the segment's up to and with it (PREFIX)
constexpr unsigned long long RANK_AGGREGATE = 1ull << 32;
constexpr unsigned long long RANK_PREFIX = 2ull << 32;

struct Ranking {
  uint32_t* bits;                          // segment a's words, then b's
  int* prefix;                             // out: per word, as bits
  unsigned long long* status;              // (tiles,) zeroed
  int* ticket;                             // zeroed
  int tiles_a;                             // a: tiles [0, tiles_a)
  int tiles;                               // b: tiles [tiles_a, tiles)
};

// flag o of a bitmap, set by any thread in any order; every lane of the
// warp calls it (flag false where it sets nothing).  Twice, the lanes that
// set bits of the first pending lane's word OR them together and that lane
// sends one atomicOr; the rest send their own.  Where origins run in
// order (a fill's never-used slots) a warp's flags lie in one or two
// words, and 32 atomics on one address would queue at its L2 slice.
__device__ __forceinline__ void set_flag(uint32_t* bits, long long o,
                                         bool flag) {
  const int lane = threadIdx.x & 31;
  const long long w = o >> 5;
  const unsigned bit = 1u << (o & 31);
  unsigned left = __ballot_sync(0xffffffffu, flag);
  for (int round = 0; round < 2 && left != 0u; ++round) {
    const int lead = __ffs(left) - 1;
    const long long lw = __shfl_sync(0xffffffffu, w, lead);
    const bool mine = ((left >> lane) & 1u) != 0u && w == lw;
    const unsigned word = __reduce_or_sync(0xffffffffu, mine ? bit : 0u);
    if (lane == lead) atomicOr(bits + lw, word);
    left &= ~__ballot_sync(0xffffffffu, mine);
  }
  if (((left >> lane) & 1u) != 0u) atomicOr(bits + w, bit);
}

// the 32 flags of a warp whose lane l holds flag 32 w + l: word w, written
// whole (every lane calls it; no other warp writes word w)
__device__ __forceinline__ void write_warp_word(uint32_t* bits, long long w,
                                                bool flag) {
  const unsigned word = __ballot_sync(0xffffffffu, flag);
  if ((threadIdx.x & 31) == 0) bits[w] = word;
}

// flag k of a bitmap written by write_warp_word
__device__ __forceinline__ bool slot_bit(const uint32_t* bits, int k) {
  return ((__ldg(bits + (k >> 5)) >> (k & 31)) & 1u) != 0u;
}

// flags start .. start + 31, bit j of run the flag start + j (one thread)
__device__ __forceinline__ void set_run(uint32_t* bits, long long start,
                                        unsigned run) {
  if (run == 0u) return;
  const int s = static_cast<int>(start & 31);
  atomicOr(bits + (start >> 5), run << s);
  if (s != 0 && (run >> (32 - s)) != 0u)
    atomicOr(bits + (start >> 5) + 1, run >> (32 - s));
}

// the rank of flag o in the segment whose words start at word base, -1
// where it is not set
__device__ __forceinline__ int flag_rank(const Ranking& r, long long base,
                                         long long o) {
  const long long w = base + (o >> 5);
  const uint32_t word = __ldg(r.bits + w);
  const uint32_t bit = 1u << (o & 31);
  if ((word & bit) == 0u) return -1;
  return __ldg(r.prefix + w) + __popc(word & (bit - 1u));
}

// slot k's origin, -1 where it lies outside 0..n-1 (origin NULL: the
// identity)
__device__ __forceinline__ long long origin_of(const long long* origin,
                                               int k, int n) {
  const long long o = origin == nullptr ? k : origin[k];
  return o >= 0 && o < n ? o : -1;
}

// the slot of flag o's rank in the segment at word base, where that rank
// is below granted, into list
__device__ __forceinline__ void list_by_rank(const Ranking& r, long long base,
                                             long long o, int k, int granted,
                                             int* list) {
  const int rank = flag_rank(r, base, o);
  if (rank >= 0 && rank < granted) list[rank] = k;
}

// rank(k, o) for every slot k set in ``flagged`` (a bitmap in slot order)
// whose origin o lies in 0..n-1: a ranks pass of blocks of RANK_THREADS,
// RANK_SLOTS slots a thread, 32 apart (a warp's lanes in order), so that a
// pass over every slot launches few blocks
template <class Rank>
__device__ __forceinline__ void rank_flagged_slots(const long long* origin,
                                                   int n,
                                                   const uint32_t* flagged,
                                                   Rank rank) {
  const int first = ((blockIdx.x * RANK_THREADS + threadIdx.x) >> 5) * 32 *
                        RANK_SLOTS + (threadIdx.x & 31);
  for (int i = 0; i < RANK_SLOTS; ++i) {
    const int k = first + 32 * i;
    if (k >= n) return;
    if (!slot_bit(flagged, k)) continue;
    const long long o = origin_of(origin, k, n);
    if (o >= 0) rank(k, o);
  }
}

// the blocks of a ranks pass over n slots
inline int rank_blocks(int n) {
  const int per_block = RANK_THREADS * RANK_SLOTS;
  return (n + per_block - 1) / per_block;
}

// exclusive sum of v over the block of RANK_THREADS; the block's total in
// *total
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_sum[RANK_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;                             // inclusive within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += x;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < RANK_THREADS / 32 ? warp_sum[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += x;
    }
    if (lane < RANK_THREADS / 32) warp_sum[lane] = s;   // inclusive
  }
  __syncthreads();
  *total = warp_sum[RANK_THREADS / 32 - 1];
  const int before = warp > 0 ? warp_sum[warp - 1] : 0;
  __syncthreads();                         // warp_sum is reused by a caller
  return before + inc - v;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* s) {
  return *reinterpret_cast<const volatile unsigned long long*>(s);
}

__device__ __forceinline__ void store_status(unsigned long long* s,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(s) = v;
  __threadfence();
}

// One tile of the scan, by a block of RANK_THREADS threads: the tile of
// the block's ticket, its words' prefixes written.  Returns true in
// thread 0 of the block that took the last ticket, with both segments'
// totals in *total_a, *total_b.
__device__ __forceinline__ bool rank_scan_tile(const Ranking& r,
                                               int* total_a, int* total_b) {
  __shared__ int s_tile, s_before;
  if (threadIdx.x == 0) s_tile = atomicAdd(r.ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int first = tile < r.tiles_a ? 0 : r.tiles_a;   // its segment's
  const size_t at = static_cast<size_t>(tile) * RANK_TILE_WORDS +
                    static_cast<size_t>(threadIdx.x) * RANK_ITEMS;
  uint4 w[RANK_ITEMS / 4];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < RANK_ITEMS / 4; ++i) {
    w[i] = *reinterpret_cast<const uint4*>(r.bits + at + 4 * i);
    mine += __popc(w[i].x) + __popc(w[i].y) + __popc(w[i].z) +
            __popc(w[i].w);
  }
  int total;
  int excl = block_exclusive_sum(mine, &total);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int before = 0;
    if (tile == first) {
      if (lane == 0)
        store_status(r.status + tile,
                     RANK_PREFIX | static_cast<unsigned>(total));
    } else {
      if (lane == 0)
        store_status(r.status + tile,
                     RANK_AGGREGATE | static_cast<unsigned>(total));
      // look back 32 tiles at a time, nearest first, to a tile that holds
      // its segment's prefix (the segment's start counts as one of 0)
      for (int j = tile - 1;; j -= 32) {
        const int t = j - lane;
        unsigned long long st = RANK_PREFIX;
        if (t >= first) {
          do {
            st = load_status(r.status + t);
          } while ((st >> 32) == 0);
        }
        const unsigned found =
            __ballot_sync(0xffffffffu, (st >> 32) == (RANK_PREFIX >> 32));
        const int stop = found != 0u ? __ffs(found) - 1 : 31;
        int v = lane <= stop ? static_cast<int>(st & 0xffffffffu) : 0;
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        before += __shfl_sync(0xffffffffu, v, 0);
        if (found != 0u) break;
      }
      if (lane == 0)
        store_status(r.status + tile,
                     RANK_PREFIX | static_cast<unsigned>(before + total));
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  excl += s_before;
#pragma unroll
  for (int i = 0; i < RANK_ITEMS / 4; ++i) {
    int4 out;
    out.x = excl;
    excl += __popc(w[i].x);
    out.y = excl;
    excl += __popc(w[i].y);
    out.z = excl;
    excl += __popc(w[i].z);
    out.w = excl;
    excl += __popc(w[i].w);
    *reinterpret_cast<int4*>(r.prefix + at + 4 * i) = out;
  }
  if (tile != r.tiles - 1 || threadIdx.x != 0) return false;
  // the last tile: segment b's total is its prefix; a's is its last tile's
  *total_b = s_before + total;
  unsigned long long st;
  do {
    st = load_status(r.status + r.tiles_a - 1);
  } while ((st >> 32) != (RANK_PREFIX >> 32));
  *total_a = static_cast<int>(st & 0xffffffffu);
  return true;
}

}  // namespace fp

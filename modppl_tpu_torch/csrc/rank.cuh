// The rank step both resampling kernels share (fused_resample.cu,
// grid_rank.cu): the ancestor of output slot i is #{j : S_j <= i} for the
// sorted first-child slot positions S (m entries in [0, num]).
//
// What bounds it on the card: bytes, S read once and the parents written
// once. A per-slot binary search over S reads its 4 MB (N = 2^20) from L2
// about 21 times over, as a chain of dependent loads per thread, so it runs
// at L2 latency, not at a memory rate. Here the rank step is a merge: the
// num slots and the m entries of S form one sorted sequence of num + m
// items, S_j before slot i when S_j <= i, and a slot's rank is the count of
// S entries merged before it. That sequence is cut into equal tiles of
// kRankTile items, one CTA a tile (merge path):
//   1. the tile's split of S at its first and last diagonal is found by a
//      32-way search of one warp each (a ballot over 32 probes cuts the
//      range 32-fold a round: 4 dependent L2 round trips at m = 2^20),
//      while the other warps zero the marks in shared memory;
//   2. its threads read the window of S between the splits (< one tile,
//      coalesced) and the last entry of each run of equal values marks its
//      slot with its count within the window;
//   3. a running maximum over the tile's slots turns the marks into ranks
//      (a slot's rank is the count of S entries before the window plus the
//      largest mark at or before it): each thread takes a group of
//      kRankItems slots aligned to kRankItems in the output, scans it in
//      registers, then a warp scan by shuffles and one barrier;
//   4. each thread writes its group's parents from registers as whole
//      16-byte words (kernel 3 then stages them for its copy).
// Every CTA takes the same number of items whatever the weights: runs of
// equal S (concentrated or degenerate weights) spread over the tiles they
// fill. No atomics, one launch. At N = 2^20 the whole merge is in flight at
// once (one wave of CTAs), so issue slots and shared-memory wavefronts
// count beside the latency of the search: a thread-by-thread walk of the
// merge (each thread binary-searching its split of a window staged in
// shared memory, then stepping through its items, the parents staged for
// coalesced stores) computes the same ranks ~30% slower
// (csrc/probes/rank_cost.py: walk_rank_kernel).
#pragma once

#include <cuda_runtime.h>

// The tile. ops/resample.py reads these two #define lines for the CPU
// model of the merge path (merge_path_parents), so they stay the one place
// it is set; probes rebuild with -D to measure others.
#ifndef MODPPL_RANK_THREADS
#define MODPPL_RANK_THREADS 256
#endif
#ifndef MODPPL_RANK_ITEMS
#define MODPPL_RANK_ITEMS 8
#endif

namespace modppl {

constexpr int kRankThreads = MODPPL_RANK_THREADS;
constexpr int kRankItems = MODPPL_RANK_ITEMS;
// slots a CTA's marks cover: kRankItems a thread, in groups aligned to
// kRankItems slots of the output
constexpr int kRankSlots = kRankThreads * kRankItems;
// merge items a CTA takes: one group fewer than it covers, so that its
// slots, from b0 rounded down to a group, always fit
constexpr int kRankTile = kRankSlots - kRankItems;
// the marks in shared memory, 4 words of padding after every 32: a
// thread's group of kRankItems is one run of 16-byte words, and a quarter
// warp's loads of them fall on distinct banks
constexpr int kRankPadded = kRankSlots + kRankSlots / 8;
// CTAs an SM must hold at once (the launch bounds cap registers to fit): a
// full SM, so that N = 2^20 runs in one wave
constexpr int kRankBlocksPerSm = 2048 / kRankThreads;
static_assert(kRankThreads >= 128 && kRankThreads % 32 == 0,
              "two warps search the tile's two splits while the rest zero "
              "the marks");
static_assert(kRankItems % 4 == 0 && 32 % kRankItems == 0,
              "a group is whole 16-byte words within 32 slots");

__device__ __forceinline__ int padded(int y) { return y + ((y >> 5) << 2); }

// The CTA's part of the merge: S entries [a0, a0 + na) and output slots
// [b0, b0 + nb); na + nb <= kRankTile. Its groups start at base, b0
// rounded down to kRankItems: thread t's group is base + t kRankItems.
struct RankTile {
  int a0, na, b0, nb, base;
};

// CTAs over the merged sequence of num slots and m entries of S.
inline long long rank_blocks(int num, int m) {
  return (static_cast<long long>(num) + m + kRankTile - 1) / kRankTile;
}

// #{j : S_j + j < d}: the number of S entries merged before diagonal d
// (S_j + j is strictly increasing; with num, m < 2^31 all of it fits 32
// unsigned bits). Called by a whole warp; each round probes 32 positions
// spread over [lo, hi) and keeps the gap between the last probe that
// passed and the first that failed.
__device__ __forceinline__ unsigned merge_split(const int* __restrict__ s,
                                                unsigned m, unsigned num,
                                                unsigned d) {
  // S in [0, num]: S_j + j < d for j < d - num, and >= d for j >= d
  unsigned lo = d > num ? d - num : 0u;
  unsigned hi = d < m ? d : m;
  const unsigned lane = threadIdx.x & 31;
  while (lo < hi) {
    const unsigned step = (hi - lo + 31) >> 5;
    const unsigned p = lo + (lane + 1) * step - 1;
    const bool before =
        p < hi && static_cast<unsigned>(__ldg(s + p)) + p < d;
    const unsigned c = __popc(__ballot_sync(0xffffffffu, before));
    const unsigned next_hi = lo + (c + 1) * step - 1;
    lo += c * step;
    hi = next_hi < hi ? next_hi : hi;
  }
  return lo;
}

// The CTA's tile: warps 0 and 1 search the splits at its first and last
// diagonal. Ends with a barrier.
__device__ __forceinline__ RankTile tile_splits(const int* __restrict__ s,
                                                int m, int num) {
  __shared__ unsigned split[2];
  const unsigned total = static_cast<unsigned>(num) + m;
  const unsigned d0 = blockIdx.x * static_cast<unsigned>(kRankTile);
  const unsigned d1 =
      total - d0 > static_cast<unsigned>(kRankTile) ? d0 + kRankTile : total;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const unsigned a = merge_split(s, m, num, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) split[warp] = a;
  }
  __syncthreads();
  RankTile t;
  t.a0 = static_cast<int>(split[0]);
  t.na = static_cast<int>(split[1] - split[0]);
  t.b0 = static_cast<int>(d0 - split[0]);
  t.nb = static_cast<int>(d1 - split[1]) - t.b0;
  t.base = t.b0 - t.b0 % kRankItems;
  return t;
}

// The marks start at 0 (no entry): warps 2 and up zero them while warps 0
// and 1 search (tile_splits' barrier orders it before the marks).
__device__ __forceinline__ void zero_marks(int* buf) {
  constexpr int kZeroing = kRankThreads - 64;
  if (threadIdx.x < 64) return;
  int4* words = reinterpret_cast<int4*>(buf);
  for (int i = threadIdx.x - 64; i < kRankPadded / 4; i += kZeroing) {
    words[i] = make_int4(0, 0, 0, 0);
  }
}

// Marks the end of each run of equal values among the window's S entries
// S_(a0+x), x < na: the run's last entry writes its count within the
// window, x + 1, at its slot S - base when that slot is in the tile. One
// writer a slot. The entries are >= b0 (the tile's split), so the index is
// never negative. Warp w reads entries [w, w + 1) x 32 kRankItems (na <
// kRankThreads x kRankItems), 32 consecutive a load, all its loads issued
// before any is used; each entry's successor comes from the next lane, or
// from lane 0 of the next load, and one more load past the warp's last.
// No barrier.
__device__ __forceinline__ void mark_runs(const int* __restrict__ s,
                                          const RankTile& t, int* marks) {
  const int lane = threadIdx.x & 31;
  const int x0 = (threadIdx.x - lane) * kRankItems + lane;
  if (x0 - lane >= t.na) return;  // the whole warp past the window
  const int* w = s + t.a0 + x0;
  int v[kRankItems];
#pragma unroll
  for (int r = 0; r < kRankItems; ++r) {
    v[r] = x0 + 32 * r < t.na ? __ldg(w + 32 * r) : 0;
  }
  const int last = x0 + 32 * (kRankItems - 1);
  const int after = lane == 31 && last + 1 < t.na
      ? __ldg(w + 32 * (kRankItems - 1) + 1) : 0;
#pragma unroll
  for (int r = 0; r < kRankItems; ++r) {
    const int x = x0 + 32 * r;
    int next = __shfl_down_sync(0xffffffffu, v[r], 1);
    const int first = __shfl_sync(0xffffffffu, v[(r + 1) % kRankItems], 0);
    if (lane == 31) next = r + 1 < kRankItems ? first : after;
    if (x < t.na && (x + 1 == t.na || next != v[r]) && v[r] - t.b0 < t.nb) {
      marks[padded(v[r] - t.base)] = x + 1;
    }
  }
}

// Turns the marks into parents: slot base + y's rank is a0 + the running
// maximum of marks[0..y] (the count of window entries <= it), clipped to
// [0, n_in - 1]. Thread t scans its group in registers, then a warp scan
// by shuffles and one barrier for the warps before it. Warps whose groups
// all lie past the tile's slots skip the work (not the barrier) and set
// par to 0.
__device__ __forceinline__ void scan_marks(const int* marks, const RankTile& t,
                                           int n_in, int (&par)[kRankItems]) {
  __shared__ int warp_max[kRankThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool live = warp * 32 * kRankItems < t.b0 - t.base + t.nb;
  int before = 0;
  if (live) {
    const int4* mine = reinterpret_cast<const int4*>(
        marks + padded(threadIdx.x * kRankItems));
    int hi = 0;
#pragma unroll
    for (int q = 0; q < kRankItems / 4; ++q) {
      const int4 v = mine[q];
      par[4 * q] = hi = max(hi, v.x);
      par[4 * q + 1] = hi = max(hi, v.y);
      par[4 * q + 2] = hi = max(hi, v.z);
      par[4 * q + 3] = hi = max(hi, v.w);
    }
    int upto = hi;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, upto, o);
      if (lane >= o) upto = max(upto, u);
    }
    before = __shfl_up_sync(0xffffffffu, upto, 1);
    if (lane == 0) before = 0;
    if (lane == 31) warp_max[warp] = upto;
  }
  __syncthreads();
  if (!live) {
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) par[k] = 0;
    return;
  }
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int k = 0; k < kRankItems; ++k) {
    par[k] = max(0, min(t.a0 + max(before, par[k]), n_in - 1));
  }
}

// Ranks this CTA's tile of the merge: thread t's par[k] is the parent of
// slot base + t kRankItems + k, clipped to [0, n_in - 1], where that slot
// is in [b0, b0 + nb) (the others are a neighbouring tile's). buf holds
// kRankPadded ints, 16-byte aligned. Launch with kRankThreads threads and
// rank_blocks(num, m) blocks.
__device__ __forceinline__ RankTile rank_tile(const int* __restrict__ s,
                                              int m, int num, int n_in,
                                              int* buf,
                                              int (&par)[kRankItems]) {
  zero_marks(buf);
  const RankTile t = tile_splits(s, m, num);
  mark_runs(s, t, buf);
  __syncthreads();
  scan_marks(buf, t, n_in, par);
  return t;
}

// Puts this thread's group of parents back in buf at its slots' padded
// places (two 16-byte words: a quarter warp's fall on distinct banks). The
// barrier in scan_marks has ordered every thread's reads of the marks
// before it.
__device__ __forceinline__ void stage_group(int* buf,
                                            const int (&par)[kRankItems]) {
  int4* mine = reinterpret_cast<int4*>(buf + padded(threadIdx.x * kRankItems));
#pragma unroll
  for (int q = 0; q < kRankItems / 4; ++q) {
    mine[q] = make_int4(par[4 * q], par[4 * q + 1], par[4 * q + 2],
                        par[4 * q + 3]);
  }
}

// out[k] = v[k] for the k in [lo, hi) (the rest belong to a neighbouring
// tile): as 16-byte words when that is all of [0, N) (out is then 16-byte
// aligned: a group starts on a multiple of kRankItems), else one by one.
template <int N>
__device__ __forceinline__ void write_run(int* __restrict__ out,
                                          const int (&v)[N], int lo, int hi) {
  static_assert(N % 4 == 0, "whole 16-byte words");
  if (lo <= 0 && hi >= N) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      reinterpret_cast<int4*>(out)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= lo && k < hi) out[k] = v[k];
    }
  }
}

}  // namespace modppl

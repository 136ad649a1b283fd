// Floors and alternatives around kernels 3 and 4 (csrc/fused_resample.cu,
// csrc/grid_rank.cu), built by rank_cost.py beside this file into libraries
// of their own, never into the kernel library (ops/_build.py builds only
// csrc/*.cu). It includes both kernels' sources, so each library also holds
// the kernels themselves, built with the merge-path tile that the -D flags
// give (MODPPL_RANK_THREADS, MODPPL_RANK_ITEMS).
//
// - empty_rank_kernel: the rank step's grid and block, and no work.
// - copy_kernel: a coalesced 16-byte copy of the bytes a kernel must move
//   (S to parents; for kernel 3 also the state to the new state).
// - tree_rank_kernel, design alternative (a): today's per-slot binary
//   search, but each CTA first stages 2^kTreeLevels evenly spaced entries
//   of S (the top levels of the search, 8 KB) in shared memory, so only the
//   last log2(M) - kTreeLevels hops go to L2. Each thread ranks
//   kTreeSlots slots, kRankThreads apart.
// - scatter_rank_kernel, alternative (b): thread j writes j to the slots
//   [S_(j-1), S_j) (S_(-1) = 0, S_M = num), clipped; unbalanced when the
//   weights are.
// - legacy_rank_kernel / legacy_resample_kernel: the design the merge path
//   replaced (one thread a slot, an upper_bound over all of S in L2), as a
//   reference.
// - walk_rank_kernel: kernel 4 with the merge path's per-thread walk in
//   place of rank.cuh's run marks and scan: the window of S staged in
//   shared memory, each thread's split of it by binary search, then a walk
//   of its kRankItems items (an S entry advances the count, a slot takes
//   it).
// - group_copy_kernel: kernel 3 at C = 2 in the (N, C) layout with each
//   thread copying its own group of rows from registers (two 16-byte
//   words a row pair, the group's rows 8 apart across a warp) in place of
//   the CTA striding its rows through shared memory.
// - phase_kernel<P>: kernel 4 cut after a phase of rank.cuh (1: the marks
//   zeroed and the two warp searches; 2: + the window's run marks, stored
//   as they are), storing what it has so that nothing is optimised away.
#include "../fused_resample.cu"
#include "../grid_rank.cu"

namespace {

constexpr int kTreeLevels = 11;
constexpr int kTreeSize = 1 << kTreeLevels;
constexpr int kTreeSlots = 8;

__global__ void __launch_bounds__(kRankThreads)
empty_rank_kernel(const int*, int, int, int, int*) {}

__global__ void copy_kernel(const int4* __restrict__ s, int4* __restrict__ p,
                            long long ni4, const float4* __restrict__ x,
                            float4* __restrict__ y, long long nf4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < ni4;
       i += stride) {
    p[i] = __ldg(s + i);
  }
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < nf4;
       i += stride) {
    y[i] = __ldg(x + i);
  }
}

// #{j : s[j] <= i} by binary search over all of s (the replaced design)
__device__ __forceinline__ int upper_bound_l2(const int* __restrict__ s,
                                              int lo, int hi, int i) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(s + mid) <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void tree_rank_kernel(const int* __restrict__ s, int m, int num,
                                 int n_in, int* __restrict__ parents) {
  __shared__ int top[kTreeSize];
  // top[k] = S at the k-th of kTreeSize even cuts of [0, m)
  for (int k = threadIdx.x; k < kTreeSize; k += blockDim.x) {
    const long long pos = static_cast<long long>(k) * m / kTreeSize;
    top[k] = pos < m ? __ldg(s + pos) : num + 1;
  }
  __syncthreads();
  const int base = blockIdx.x * blockDim.x * kTreeSlots + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kTreeSlots; ++r) {
    const int i = base + r * blockDim.x;
    if (i >= num) break;
    // the last cut whose S is <= i, then the gap to the next cut in L2
    int lo = 0;
    int hi = kTreeSize;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (top[mid] <= i) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int from = lo == 0
        ? 0
        : static_cast<int>(static_cast<long long>(lo - 1) * m / kTreeSize);
    const int to = lo == kTreeSize
        ? m
        : static_cast<int>(static_cast<long long>(lo) * m / kTreeSize);
    parents[i] = max(0, min(upper_bound_l2(s, from, to, i), n_in - 1));
  }
}

__global__ void scatter_rank_kernel(const int* __restrict__ s, int m, int num,
                                    int n_in, int* __restrict__ parents) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > m) return;
  const int from = j == 0 ? 0 : min(__ldg(s + j - 1), num);
  const int to = j == m ? num : min(__ldg(s + j), num);
  const int p = max(0, min(j, n_in - 1));
  for (int i = from; i < to; ++i) parents[i] = p;
}

__global__ void legacy_rank_kernel(const int* __restrict__ s, int m, int num,
                                   int n_in, int* __restrict__ parents) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num) return;
  parents[i] = max(0, min(upper_bound_l2(s, 0, m, i), n_in - 1));
}

__global__ void legacy_resample_kernel(const int* __restrict__ s,
                                       const float* __restrict__ state,
                                       float* __restrict__ out,
                                       int* __restrict__ parents, int n,
                                       int c, long long sp, long long sc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = min(upper_bound_l2(s, 0, n, i), n - 1);
  parents[i] = p;
  const float* src = state + p * sp;
  float* dst = out + i * sp;
  for (int k = 0; k < c; ++k) dst[k * sc] = src[k * sc];
}

template <int kPhase>
__global__ void __launch_bounds__(kRankThreads, modppl::kRankBlocksPerSm)
phase_kernel(const int* __restrict__ s, int m, int num, int n_in,
             int* __restrict__ parents) {
  __shared__ __align__(16) int buf[modppl::kRankPadded];
  modppl::zero_marks(buf);
  const modppl::RankTile t = modppl::tile_splits(s, m, num);
  if (kPhase == 1) {
    if (threadIdx.x == 0) parents[blockIdx.x] = t.a0 + t.nb + n_in + buf[0];
    return;
  }
  modppl::mark_runs(s, t, buf);
  __syncthreads();
  for (int y = threadIdx.x; y < t.nb; y += kRankThreads) {
    parents[t.b0 + y] = buf[modppl::padded(y)];
  }
}

__global__ void __launch_bounds__(kRankThreads, modppl::kRankBlocksPerSm)
group_copy_kernel(const int* __restrict__ s, const float2* __restrict__ state,
                  float* __restrict__ out, int* __restrict__ parents, int n) {
  __shared__ __align__(16) int buf[modppl::kRankPadded];
  int par[kRankItems];
  const modppl::RankTile t = modppl::rank_tile(s, n, n, n, buf, par);
  const int g = t.base + threadIdx.x * kRankItems;
  modppl::write_run(parents + g, par, t.b0 - g, t.b0 + t.nb - g);
  if (g >= t.b0 + t.nb || g + kRankItems <= t.b0) return;
  int v[2 * kRankItems];  // the rows' bits
#pragma unroll
  for (int k = 0; k < kRankItems; ++k) {
    const float2 r = __ldg(state + par[k]);
    v[2 * k] = __float_as_int(r.x);
    v[2 * k + 1] = __float_as_int(r.y);
  }
  modppl::write_run(reinterpret_cast<int*>(out) + 2 * static_cast<long long>(g),
                    v, 2 * (t.b0 - g), 2 * (t.b0 + t.nb - g));
}

// the window's entries merged before the tile's local diagonal dl
__device__ __forceinline__ int thread_split(const int* buf,
                                            const modppl::RankTile& t,
                                            int dl) {
  int lo = dl - t.nb > 0 ? dl - t.nb : 0;
  int hi = dl < t.na ? dl : t.na;
  const long long target = static_cast<long long>(t.b0) + dl;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(buf[mid]) + mid < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kRankThreads, modppl::kRankBlocksPerSm)
walk_rank_kernel(const int* __restrict__ s, int m, int num, int n_in,
                 int* __restrict__ parents) {
  __shared__ int buf[modppl::kRankTile];
  const modppl::RankTile t = modppl::tile_splits(s, m, num);
  for (int x = threadIdx.x; x < t.na; x += kRankThreads) {
    buf[x] = __ldg(s + t.a0 + x);
  }
  __syncthreads();
  const int len = t.na + t.nb;
  const int dl = threadIdx.x * kRankItems;
  int* staged = buf + t.na;
  if (dl < len) {
    int al = thread_split(buf, t, dl);
    int bl = dl - al;
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) {
      if (dl + k < len) {
        if (al < t.na && (bl >= t.nb || buf[al] <= t.b0 + bl)) {
          ++al;
        } else {
          staged[bl] = max(0, min(t.a0 + al, n_in - 1));
          ++bl;
        }
      }
    }
  }
  __syncthreads();
  for (int y = threadIdx.x; y < t.nb; y += kRankThreads) {
    parents[t.b0 + y] = staged[y];
  }
}

int blocks_of(long long count, int threads) {
  return static_cast<int>((count + threads - 1) / threads);
}

}  // namespace

extern "C" int probe_empty_rank(const int* s, int m, int num, int n_in,
                                int* parents, cudaStream_t stream) {
  empty_rank_kernel<<<static_cast<unsigned>(modppl::rank_blocks(num, m)),
                      kRankThreads, 0, stream>>>(s, m, num, n_in, parents);
  return static_cast<int>(cudaGetLastError());
}

// ni4 int4s of s into p, nf4 float4s of x into y (pointers 16-byte aligned)
extern "C" int probe_copy(const void* s, void* p, long long ni4,
                          const void* x, void* y, long long nf4,
                          cudaStream_t stream) {
  copy_kernel<<<132 * 8, 256, 0, stream>>>(
      static_cast<const int4*>(s), static_cast<int4*>(p), ni4,
      static_cast<const float4*>(x), static_cast<float4*>(y), nf4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_tree_rank(const int* s, int m, int num, int n_in,
                               int* parents, cudaStream_t stream) {
  tree_rank_kernel<<<blocks_of(num, 256 * kTreeSlots), 256, 0, stream>>>(
      s, m, num, n_in, parents);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_scatter_rank(const int* s, int m, int num, int n_in,
                                  int* parents, cudaStream_t stream) {
  scatter_rank_kernel<<<blocks_of(static_cast<long long>(m) + 1, 256), 256, 0,
                        stream>>>(s, m, num, n_in, parents);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_legacy_rank(const int* s, int m, int num, int n_in,
                                 int* parents, cudaStream_t stream) {
  legacy_rank_kernel<<<blocks_of(num, 256), 256, 0, stream>>>(s, m, num, n_in,
                                                              parents);
  return static_cast<int>(cudaGetLastError());
}

// (N, C) layout: particle stride c, column stride 1
extern "C" int probe_legacy_resample(const int* s, const float* state,
                                     float* out, int* parents, int n, int c,
                                     cudaStream_t stream) {
  legacy_resample_kernel<<<blocks_of(n, 256), 256, 0, stream>>>(
      s, state, out, parents, n, c, c, 1);
  return static_cast<int>(cudaGetLastError());
}

// phase_kernel<phase> (1 or 2) with kernel 4's grid and arguments
extern "C" int probe_phase(int phase, const int* s, int m, int num, int n_in,
                           int* parents, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(modppl::rank_blocks(num, m));
  if (phase == 1) {
    phase_kernel<1><<<grid, kRankThreads, 0, stream>>>(s, m, num, n_in,
                                                       parents);
  } else if (phase == 2) {
    phase_kernel<2><<<grid, kRankThreads, 0, stream>>>(s, m, num, n_in,
                                                       parents);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_walk_rank(const int* s, int m, int num, int n_in,
                               int* parents, cudaStream_t stream) {
  walk_rank_kernel<<<static_cast<unsigned>(modppl::rank_blocks(num, m)),
                     kRankThreads, 0, stream>>>(s, m, num, n_in, parents);
  return static_cast<int>(cudaGetLastError());
}

// (N, 2) states (16-byte aligned)
extern "C" int probe_group_copy(const int* s, const float* state, float* out,
                                int* parents, int n, int c,
                                cudaStream_t stream) {
  if (c != 2) return static_cast<int>(cudaErrorInvalidValue);
  group_copy_kernel<<<static_cast<unsigned>(modppl::rank_blocks(n, n)),
                      kRankThreads, 0, stream>>>(
      s, reinterpret_cast<const float2*>(state), out, parents, n);
  return static_cast<int>(cudaGetLastError());
}

// Systematic-resampling ancestors from the sorted slot positions S: kernel 4.
//
// Replaces modppl_tpu/ops/resample_pallas.py:grid_rank (entry
// systematic_parents_pallas).
//
// Contract: S (M,) int32 sorted, values in [0, num]; for each of the num
// output slots, parents[i] = #{j : S_j <= i} clipped to [0, n_in - 1].
// Identical to the reference's integer scatter-add + cumsum
// (parallel/resample.py:_grid_parents) on the same S: pure integer counting.
//
// What bounds it on the card: bytes, M * 4 read and num * 4 written. The
// TPU kernel searched only the block boundaries (one searchsorted outside
// the kernel, passed as scalar prefetch), then streamed each block's S
// entries through VMEM and counted them with vector compares, because a
// scatter or a gather serialises on the TPU's scalar core. Its partition by
// blocks of slots would hand one CTA a whole run of equal S. Here the rank
// step is rank.cuh's merge path: each CTA takes an equal share of the
// merged slots and S entries, finds its split with one warp a diagonal,
// marks the ends of its window's runs of equal S in shared memory and
// turns them into ranks by a running maximum; each thread writes its group
// of parents as 16-byte words. No atomics, one launch, any N (the
// reference's N % 1024 == 0 was its tiling's).
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

using modppl::kRankItems;
using modppl::kRankThreads;

__global__ void __launch_bounds__(kRankThreads, modppl::kRankBlocksPerSm)
grid_rank_kernel(const int* __restrict__ s, int m, int num, int n_in,
                 int* __restrict__ parents) {
  __shared__ __align__(16) int buf[modppl::kRankPadded];
  int par[kRankItems];
  const modppl::RankTile t = modppl::rank_tile(s, m, num, n_in, buf, par);
  const int g = t.base + threadIdx.x * kRankItems;
  modppl::write_run(parents + g, par, t.b0 - g, t.b0 + t.nb - g);
}

}  // namespace

// s (m,) int32 sorted in [0, num] -> parents (num,) int32 clipped to
// [0, n_in - 1].
extern "C" int modppl_grid_rank_i32(const int* s, int m, int num, int n_in,
                                    int* parents, cudaStream_t stream) {
  if (num <= 0 || m < 0 || n_in <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = modppl::rank_blocks(num, m);
  grid_rank_kernel<<<static_cast<unsigned>(blocks), kRankThreads, 0,
                     stream>>>(s, m, num, n_in, parents);
  return static_cast<int>(cudaGetLastError());
}

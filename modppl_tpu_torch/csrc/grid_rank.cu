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
// What bounds it on the card: bytes. It writes num * 4 bytes of parents and
// reads S (4 MB at N = 2^20) by binary search, so S stays in the 50 MB L2
// and is fetched from device memory about once. The TPU kernel searched
// only the block boundaries (one searchsorted outside the kernel), then
// streamed each block's S entries through VMEM by manual DMA and counted
// them with (W x 128) vector compares, because a scatter or a gather
// serialises on the TPU's scalar core. None of that applies here: one
// thread per output slot runs an upper_bound of its slot index over S and
// writes its ancestor. No atomics, no scan, one launch, any N (the
// reference's N % 1024 == 0 was its tiling's).
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

using modppl::rank_upper_bound;

__global__ void grid_rank_kernel(const int* __restrict__ s, int m, int num,
                                 int n_in, int* __restrict__ parents) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num) return;
  parents[i] = max(0, min(rank_upper_bound(s, m, i), n_in - 1));
}

}  // namespace

// s (m,) int32 sorted in [0, num] -> parents (num,) int32 clipped to
// [0, n_in - 1].
extern "C" int modppl_grid_rank_i32(const int* s, int m, int num, int n_in,
                                    int* parents, cudaStream_t stream) {
  constexpr int kThreads = 256;
  if (num <= 0 || m < 0 || n_in <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (num + kThreads - 1) / kThreads;
  grid_rank_kernel<<<blocks, kThreads, 0, stream>>>(s, m, num, n_in, parents);
  return static_cast<int>(cudaGetLastError());
}

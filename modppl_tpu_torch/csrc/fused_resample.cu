// Fused ancestors + state gather from the sorted slot positions S: kernel 3.
//
// Replaces modppl_tpu/ops/fused_resample_pallas.py:_fused_gather (entries
// resample_fused_from_s and systematic_resample_fused).
//
// Contract: S (N,) int32 sorted in [0, N]; parents[i] = #{j : S_j <= i}
// clipped to [0, N-1], and out[i, :] is a bitwise copy of state[parents[i], :]
// for C f32 columns. Identical to the reference's integer scatter+cumsum
// (sharded_smc._parents_from_s) followed by a take.
//
// What bounds it on the card: bytes. It reads C*N*4 bytes of state and
// writes C*N*4 + N*4; S (4 MB at N = 2^20) is read by binary search and
// stays in the 50 MB L2. The TPU kernel avoided binary search because its
// gathers serialise on the scalar core, and contracted one-hot matrices on
// the MXU instead (with bf16 splits to keep copies exact). None of that
// applies here: one thread per output slot runs an upper_bound of its slot
// index over S and copies its ancestor's C values. No atomics, no scan, one
// launch; a copy through registers is exact.
//
// Strides make one kernel serve both layouts: (C, N) as the JAX entry takes
// it (particle stride 1, column stride N) and (N, C) as the filter keeps its
// state (particle stride C, column stride 1). With C = 0 it writes parents
// only; the port of grid_rank (csrc/grid_rank.cu) is a kernel of its own that
// shares rank_upper_bound (rank.cuh).
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

using modppl::rank_upper_bound;

__global__ void resample_from_s_kernel(const int* __restrict__ s,
                                       const float* __restrict__ state,
                                       float* __restrict__ out,
                                       int* __restrict__ parents, int n, int c,
                                       long long sp, long long sc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = min(rank_upper_bound(s, n, i), n - 1);
  parents[i] = p;
  const float* src = state + p * sp;
  float* dst = out + i * sp;
  for (int k = 0; k < c; ++k) dst[k * sc] = src[k * sc];
}

}  // namespace

// s (n,) int32 sorted; state/new_state with element (particle p, column k)
// at p*sp + k*sc; parents (n,) int32.
extern "C" int modppl_resample_from_s_f32(const int* s, const float* state,
                                          float* new_state, int* parents,
                                          int n, int c, long long sp,
                                          long long sc, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  resample_from_s_kernel<<<blocks, kThreads, 0, stream>>>(
      s, state, new_state, parents, n, c, sp, sc);
  return static_cast<int>(cudaGetLastError());
}

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
// What bounds it on the card: bytes. It reads S (N * 4) and C*N*4 bytes of
// state and writes N * 4 + C*N*4. The TPU kernel avoided gathers, which
// serialise on its scalar core, and contracted one-hot matrices on the MXU
// instead (with bf16 splits to keep copies exact). None of that applies
// here. Each CTA ranks its tile of the merged slots and S entries
// (rank.cuh's merge path, shared with grid_rank.cu), which leaves each
// thread the parents of a group of kRankItems output rows in registers; it
// writes them out as 16-byte words and puts them back in shared memory,
// then the CTA's threads copy its output rows [b0, b0 + nb) through
// registers (exact), with coalesced stores:
// - "nc", the filter's (N, C) state: those rows are one contiguous range
//   of out, so the threads stride it, one float a step, or one float2 row
//   a step at the filter's C = 2; the reads state[parents[i]] climb with i
//   (ancestors never decrease), so they too fall on few lines;
// - "cn", the JAX entry's (C, N): the same, one column at a time.
// Copying each thread's own group of rows from registers instead (stores
// of whole 16-byte words, but a group apart across a warp) is slower at
// C = 2 (csrc/probes/rank_cost.py: group_copy_kernel). No atomics, one
// launch.
#include <cstdint>

#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

using modppl::kRankItems;
using modppl::kRankThreads;
using modppl::padded;

// out rows [b0, b0 + nb), the parents staged in shared memory (par(r) =
// par[padded(r + off)]): rows of one V (the filter's C = 2 as float2;
// nb < kRankThreads x kRankItems, so each thread issues all its loads
// before its stores) when kRowVector, else c floats a row.
template <typename V, bool kRowVector>
__device__ __forceinline__ void copy_rows(const V* __restrict__ state,
                                          V* __restrict__ out,
                                          const int* par, int off, int b0,
                                          int nb, int c) {
  if constexpr (kRowVector) {
    V v[kRankItems];
#pragma unroll
    for (int r = 0; r < kRankItems; ++r) {
      const int e = threadIdx.x + r * kRankThreads;
      if (e < nb) v[r] = __ldg(state + par[padded(e + off)]);
    }
#pragma unroll
    for (int r = 0; r < kRankItems; ++r) {
      const int e = threadIdx.x + r * kRankThreads;
      if (e < nb) out[b0 + e] = v[r];
    }
  } else {
    V* dst = out + static_cast<long long>(b0) * c;
    const int count = nb * c;
    for (int e = threadIdx.x; e < count; e += kRankThreads) {
      const int r = e / c;
      const int k = e - r * c;
      dst[e] = __ldg(state + static_cast<long long>(par[padded(r + off)]) * c
                     + k);
    }
  }
}

// out[k, b0 + r] = state[k, par(r)] for each of the c columns of length n
__device__ __forceinline__ void copy_columns(const float* __restrict__ state,
                                             float* __restrict__ out,
                                             const int* par, int off, int b0,
                                             int nb, int n, int c) {
  for (int k = 0; k < c; ++k) {
    const float* src = state + static_cast<long long>(k) * n;
    float* dst = out + static_cast<long long>(k) * n + b0;
    for (int r = threadIdx.x; r < nb; r += kRankThreads) {
      dst[r] = __ldg(src + par[padded(r + off)]);
    }
  }
}

// kColumns: the (C, N) layout, one column at a time; else (N, C) rows,
// as copy_rows<V, kRowVector> takes them.
template <typename V, bool kRowVector, bool kColumns>
__global__ void __launch_bounds__(kRankThreads, modppl::kRankBlocksPerSm)
resample_from_s_kernel(const int* __restrict__ s,
                       const float* __restrict__ state,
                       float* __restrict__ out, int* __restrict__ parents,
                       int n, int c) {
  __shared__ __align__(16) int buf[modppl::kRankPadded];
  int par[kRankItems];
  const modppl::RankTile t = modppl::rank_tile(s, n, n, n, buf, par);
  const int g = t.base + threadIdx.x * kRankItems;
  modppl::write_run(parents + g, par, t.b0 - g, t.b0 + t.nb - g);
  // each thread's group back over its own marks, for the whole tile's rows
  modppl::stage_group(buf, par);
  __syncthreads();
  const int off = t.b0 - t.base;
  if constexpr (kColumns) {
    copy_columns(state, out, buf, off, t.b0, t.nb, n, c);
  } else {
    copy_rows<V, kRowVector>(reinterpret_cast<const V*>(state),
                             reinterpret_cast<V*>(out), buf, off, t.b0, t.nb,
                             c);
  }
}

bool aligned8(const void* a, const void* b) {
  return reinterpret_cast<std::uintptr_t>(a) % sizeof(float2) == 0 &&
         reinterpret_cast<std::uintptr_t>(b) % sizeof(float2) == 0;
}

}  // namespace

// s (n,) int32 sorted; state/new_state (C, n) when nc == 0 or (n, C) when
// nc != 0; parents (n,) int32.
extern "C" int modppl_resample_from_s_f32(const int* s, const float* state,
                                          float* new_state, int* parents,
                                          int n, int c, int nc,
                                          cudaStream_t stream) {
  if (n <= 0 || c < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(modppl::rank_blocks(n, n)));
  const dim3 block(kRankThreads);
  if (!nc && c > 1) {
    resample_from_s_kernel<float, false, true>
        <<<grid, block, 0, stream>>>(s, state, new_state, parents, n, c);
  } else if (c == 2 && aligned8(state, new_state)) {
    resample_from_s_kernel<float2, true, false>
        <<<grid, block, 0, stream>>>(s, state, new_state, parents, n, c);
  } else {
    resample_from_s_kernel<float, false, false>
        <<<grid, block, 0, stream>>>(s, state, new_state, parents, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

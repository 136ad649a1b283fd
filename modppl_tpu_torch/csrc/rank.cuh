// The rank step both resampling kernels share (fused_resample.cu,
// grid_rank.cu): the ancestor of output slot i is #{j : S_j <= i} for the
// sorted first-child slot positions S.
#pragma once

#include <cuda_runtime.h>

namespace modppl {

// #{j : s[j] <= i} for sorted s of length n: an upper_bound by binary
// search. S is read through the read-only cache; at N = 2^20 it is 4 MB and
// stays in L2 while every slot searches it.
__device__ __forceinline__ int rank_upper_bound(const int* __restrict__ s,
                                                int n, int i) {
  int lo = 0;
  int hi = n;
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

}  // namespace modppl

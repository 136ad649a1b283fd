// Blocked systematic-resampling grid positions: kernels 1 and 2.
//
// Replaces modppl_tpu/ops/grid_positions_pallas.py:stats_cumsum (Pallas body
// _stats_kernel) and :positions_cummax (Pallas body _positions_kernel).
//
// What bounds them on the card: bytes. Each reads its (nb, bw) input once
// and writes its (nb, bw) output once, a few flops per element. The design
// keeps every Hillis-Steele level of a row in shared memory, so the scan's
// log2(bw) passes never touch device memory (the plain PyTorch version makes
// one device-memory round trip per level).
//
// One CUDA block per row, one thread per element, bw a power of two <= 1024
// (bw = _cdf_block(N): 1024 for N >= 2^16, smaller below).
//
// Exactness contract, so that results are bitwise those of the reference's
// XLA path on the same inputs:
// - the scan is the reference's Hillis-Steele order (sharded_smc.py:51-64):
//   at levels k = 1, 2, ..., bw/2, x[i] += x[i-k] (x[i] + 0 for i < k), with
//   a barrier between levels. No CUB and no warp shuffles: those change the
//   add tree.
// - e = expf(lw - m) with the accurate expf (the build does not use
//   --use_fast_math).
// - sum(e^2) is the scanned row total of e*e, as the reference's CPU path
//   computes it (sharded_smc.py:142-148). The TPU kernel takes a plain
//   jnp.sum there instead (grid_positions_pallas.py:55); the port follows the
//   CPU path so the CPU tests stay bitwise against the reference.
// - positions use round-to-nearest intrinsics in the reference's order:
//   cdf = cum + offs, then / total, then * n, then - u. Written as plain
//   operators nvcc would contract the multiply and subtract into an FMA,
//   which rounds once and moves S by one slot at boundaries.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kMaxWidth = 1024;

__global__ void stats_cumsum_kernel(const float* __restrict__ lw,
                                    const float* __restrict__ m,
                                    float* __restrict__ cum,
                                    float* __restrict__ tot,
                                    float* __restrict__ sqtot, int bw) {
  __shared__ float sa[kMaxWidth];
  __shared__ float sb[kMaxWidth];
  const int i = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t idx = row * bw + i;
  const float e = expf(__fsub_rn(lw[idx], *m));
  sa[i] = e;
  sb[i] = __fmul_rn(e, e);
  __syncthreads();
  for (int k = 1; k < bw; k <<= 1) {
    const float xa = sa[i];
    const float xb = sb[i];
    const float ya = i >= k ? sa[i - k] : 0.0f;
    const float yb = i >= k ? sb[i - k] : 0.0f;
    __syncthreads();
    sa[i] = __fadd_rn(xa, ya);
    sb[i] = __fadd_rn(xb, yb);
    __syncthreads();
  }
  cum[idx] = sa[i];
  if (i == bw - 1) {
    tot[row] = sa[i];
    sqtot[row] = sb[i];
  }
}

__global__ void positions_cummax_kernel(const float* __restrict__ cum,
                                        const float* __restrict__ offs,
                                        const float* __restrict__ total,
                                        const float* __restrict__ u,
                                        int* __restrict__ s_rows,
                                        int* __restrict__ mx, int bw,
                                        float n) {
  __shared__ int ss[kMaxWidth];
  const int i = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t idx = row * bw + i;
  const float cdf = __fadd_rn(cum[idx], offs[row]);
  float v = ceilf(__fsub_rn(__fmul_rn(__fdiv_rn(cdf, *total), n), *u));
  v = fminf(fmaxf(v, 0.0f), n);
  ss[i] = static_cast<int>(v);
  __syncthreads();
  for (int k = 1; k < bw; k <<= 1) {
    const int x = ss[i];
    const int y = i >= k ? ss[i - k] : INT_MIN;
    __syncthreads();
    ss[i] = max(x, y);
    __syncthreads();
  }
  s_rows[idx] = ss[i];
  if (i == bw - 1) mx[row] = ss[i];
}

}  // namespace

// lw (nb, bw) f32, m a device scalar -> cum (nb, bw), tot (nb,), sqtot (nb,)
extern "C" int modppl_stats_cumsum_f32(const float* lw, const float* m,
                                       float* cum, float* tot, float* sqtot,
                                       int nb, int bw, cudaStream_t stream) {
  stats_cumsum_kernel<<<nb, bw, 0, stream>>>(lw, m, cum, tot, sqtot, bw);
  return static_cast<int>(cudaGetLastError());
}

// cum (nb, bw) f32, offs (nb,) f32, total and u device scalars, n = N
// -> s_rows (nb, bw) int32 (in-row cummax only), mx (nb,) int32 row maxima
extern "C" int modppl_positions_cummax_f32(const float* cum, const float* offs,
                                           const float* total, const float* u,
                                           int* s_rows, int* mx, int nb,
                                           int bw, int n,
                                           cudaStream_t stream) {
  positions_cummax_kernel<<<nb, bw, 0, stream>>>(
      cum, offs, total, u, s_rows, mx, bw, static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}

// Pieces hmc_small.cu and hmc_chunk.cu share: the round-to-nearest
// arithmetic helpers, the 4-byte cp.async their stream prefetches use, the
// fixed-order tree sums that pool statistics over chains in both whole
// warmups (tile rows and tile partials one warp a row, warp_rows; more than
// 256 partials through shared memory, reduce_partials; both in the
// adjacent-pairing tree's order), and the dual-averaging step-size update.
#pragma once

#include <cuda_runtime.h>

namespace modppl {

constexpr int kMaxWindows = 32;   // ops/_hmc_common.MAX_WINDOWS

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// 4 bytes from device memory into shared memory, asynchronously (cp.async,
// cached in L1); zero-filled where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(valid ? 4 : 0));
}

// In-place adjacent-pairing tree sums of `rows` rows of x ([rows][P], P a
// power of two): row r's total ends in x[r * P]. The whole block calls it.
__device__ inline void tree_rows(float* x, int rows, int P) {
  for (int s = 1; s < P; s <<= 1) {
    const int pairs = P / (2 * s);
    for (int idx = threadIdx.x; idx < rows * pairs; idx += blockDim.x) {
      const int r = idx / pairs;
      const int i = r * P + (idx - r * pairs) * 2 * s;
      x[i] = add(x[i], x[i + s]);
    }
    __syncthreads();
  }
}

// Totals over tiles of `rows` rows of tile partials ([row][ptiles] in device
// memory; tiles past the last are 0), by the same tree in tile order, using
// `cap` floats of shared scratch `red`; into out[0..rows). Every block that
// calls it gets the same bits. The whole block calls it.
__device__ inline void reduce_partials(const float* part, int rows, int ptiles,
                                       float* red, int cap, float* out) {
  const int per_pass = cap / ptiles;
  for (int r0 = 0; r0 < rows; r0 += per_pass) {
    const int rr = min(per_pass, rows - r0);
    for (int i = threadIdx.x; i < rr * ptiles; i += blockDim.x)
      red[i] = part[static_cast<size_t>(r0) * ptiles + i];
    __syncthreads();
    tree_rows(red, rr, ptiles);
    for (int r = threadIdx.x; r < rr; r += blockDim.x)
      out[r0 + r] = red[r * ptiles];
    __syncthreads();
  }
}

// Row totals of `rows` rows of x ([rows][P], P a power of two <= 256) by
// the adjacent-pairing tree, tree_rows' order, one warp a row: lane l sums
// entries [l E, (l + 1) E) (E = P / 32) by the tree, then the lanes pair up
// by shuffles (over the first P lanes when P < 32). Row r's total goes to
// out[r * ostride]. Rows go 4 at a time, so that a warp has 4 E loads in
// flight. The whole block calls it; one __syncthreads at the end.
__device__ inline void warp_rows(const float* x, int rows, int P, float* out,
                                 int ostride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int E = P > 32 ? P / 32 : 1;
  const int span = P < 32 ? P : 32;
  for (int r0 = 4 * warp; r0 < rows; r0 += 4 * warps) {
    float v[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int t = lane * E + m;
        v[q][m] = (r0 + q < rows && m < E && t < P)
                      ? x[static_cast<size_t>(r0 + q) * P + t] : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int st = 1; st < 8; st <<= 1) {
        if (st < E) {
#pragma unroll
          for (int m = 0; m < 8; m += 2 * st)
            v[q][m] = add(v[q][m], v[q][m + st]);
        }
      }
      float t = v[q][0];
      for (int st = 1; st < span; st <<= 1)
        t = add(t, __shfl_down_sync(0xffffffffu, t, st));
      if (lane == 0 && r0 + q < rows)
        out[static_cast<size_t>(r0 + q) * ostride] = t;
    }
  }
  __syncthreads();
}

// Totals over tiles of tile partials into out (reduce_partials' result,
// bit for bit): by warps when ptiles <= 256, else through the shared
// scratch `red` of `cap` floats.
__device__ inline void pooled_totals(const float* part, int rows, int ptiles,
                                     float* red, int cap, float* out) {
  if (ptiles <= 256)
    warp_rows(part, rows, ptiles, out, 1);
  else
    reduce_partials(part, rows, ptiles, red, cap, out);
}

// Whether iteration t lies in a slow window, and whether a slow window ends
// just before it; sch holds nwin starts, then (at kMaxWindows) the ends.
__device__ inline void window_flags(const int* sch, int nwin, int t,
                                    bool& in_slow, bool& at_end) {
  in_slow = at_end = false;
  for (int w = 0; w < nwin; ++w) {
    in_slow |= sch[w] <= t && t < sch[kMaxWindows + w];
    at_end |= t == sch[kMaxWindows + w];
  }
}

// The scalar adaptation state every block keeps its own copy of.
struct DualAveraging {
  float log_eps, leb, hbar, mu, t_da, nw;

  __device__ void init(float eps0, float eps0x10) {
    log_eps = leb = logf(eps0);
    mu = logf(eps0x10);
    hbar = t_da = nw = 0.0f;
  }

  // restart around the averaged step size (at a slow window's end)
  __device__ void restart() {
    log_eps = leb;
    mu = add(logf(10.0f), leb);
    hbar = t_da = nw = 0.0f;
  }

  // Nesterov dual averaging on the pooled accept mean (inference/hmc.py
  // da_update: gamma 0.05, t0 10, kappa 0.75)
  __device__ void update(float a_mean, float target) {
    t_da = add(t_da, 1.0f);
    const float eta_h = quo(1.0f, add(t_da, 10.0f));
    hbar = add(mul(sub(1.0f, eta_h), hbar), mul(eta_h, sub(target, a_mean)));
    log_eps = sub(mu, mul(mul(sqrtf(t_da), 20.0f), hbar));
    const float eta = expf(mul(-0.75f, logf(t_da)));
    leb = add(mul(eta, log_eps), mul(sub(1.0f, eta), leb));
  }
};

// The regularized pooled variance of a finished window: the new inverse
// mass entry (Stan's inv_metric).
__device__ __forceinline__ float window_variance(float m2, float nw) {
  const float shrink = quo(nw, add(nw, 5.0f));
  float var = quo(m2, fmaxf(sub(nw, 1.0f), 1.0f));
  var = add(mul(shrink, var), mul(sub(1.0f, shrink), 1e-3f));
  return fminf(fmaxf(var, 1e-8f), 1e8f);
}

// Chan-Welford merge of one batch (mean bmean, squared deviations bm2, c
// chains) into a window that holds nw draws.
__device__ __forceinline__ void welford_merge(float& mean, float& m2,
                                              float bmean, float bm2,
                                              float nw, float c) {
  const float n_new = add(nw, c);
  const float delta = sub(bmean, mean);
  mean = add(mean, quo(mul(delta, c), n_new));
  m2 = add(add(m2, bm2), quo(mul(mul(mul(delta, delta), nw), c), n_new));
}

// Cooperative launch on as many blocks as fit co-resident (at most
// `tiles`): the whole-warmup kernels' grid.sync() needs every block
// resident at once.
template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int tiles, int threads,
                               size_t smem, void** args,
                               cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                  threads, args, smem, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return cudaGetLastError();
}

}  // namespace modppl

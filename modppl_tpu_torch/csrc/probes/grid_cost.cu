// Floors and alternatives around kernels 1 and 2 (csrc/grid_positions.cu),
// built by grid_cost.py beside this file into libraries of their own, never
// into the kernel library (ops/_build.py builds only csrc/*.cu). It includes
// the kernels' source, so each library also holds the kernels themselves,
// built with the warps a CTA that -DMODPPL_GRID_WARPS gives.
//
// - empty_grid_kernel: the kernels' grid and block at bw = 1024, and no work.
// - copy_kernel: a coalesced 16-byte copy of the bytes each kernel moves
//   (n floats in, n words out).
// - contig_stats_kernel: kernel 1 in the contiguous layout (lane l holds
//   elements l R ... l R + R - 1, 16-byte loads and stores): scan
//   levels k < R in registers plus one shuffle of the previous lane's tail,
//   levels k >= R a shuffle-up of every register by k / R lanes; the tree
//   of e*e in registers, then over the lanes.
// - twoscan_stats_kernel: kernel 1 with sum(e^2) from a second full strided
//   scan of e*e (its last element) in place of square_tree, the two scans
//   level by level as the replaced kernel ran them.
// - strided_positions_kernel: kernel 2 with kernel 1's strided layout
//   (coalesced 4-byte loads and stores): a shuffle-up max scan of each
//   register over the lanes, carried across the registers.
// - contig_positions_kernel: kernel 2 with lane l holding the contiguous
//   elements 32 l ... 32 l + 31 (eight 16-byte loads and stores, 128 bytes
//   apart across a warp): their running max, then one shuffle-up scan of
//   the lane maxima.
// - legacy_stats_kernel / legacy_positions_kernel: the design these
//   replaced (one CTA of bw threads a row, the Hillis-Steele levels in
//   shared memory with two barriers a level), as a reference.
// - stats_phase_kernel<P> / positions_phase_kernel<P>: the kernels cut
//   after a phase, storing what they have so that nothing is optimised
//   away. Kernel 1: 0 the loads stored back; 1 + e = expf(lw - m); 2 + the
//   tree of e*e; 3 + the scan of e, no tree. Kernel 2 (its 16-byte words):
//   0 the loads stored back as their bits; 1 + the positions; 2 + each
//   word's running max, no lane scan.
// Every alternative but the legacy pair runs at bw = 1024 only.
#include "../grid_positions.cu"

namespace {

constexpr int kWidth = 1024;
constexpr int kRegs = kWidth / 32;
constexpr int kWords = kRegs / 4;

// lane l's R contiguous floats from p / ints to p, as 16-byte words (p
// 16-byte aligned)
template <int R>
__device__ __forceinline__ void load_run(const float* __restrict__ p,
                                         float (&v)[R]) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p) + q);
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

// element l + 32 j of a row at p - l in v[j], or 0 when the row is not live
template <int R>
__device__ __forceinline__ void load_strided(const float* __restrict__ p,
                                             bool live, float (&v)[R]) {
  if (live) {
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = __ldg(p + 32 * j);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = 0.0f;
  }
}

template <int R>
__device__ __forceinline__ void store_run(int* __restrict__ p,
                                          const int (&v)[R]) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    reinterpret_cast<int4*>(p)[q] =
        make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

__global__ void __launch_bounds__(kGridThreads)
empty_grid_kernel(const float*, const float*, float*, float*, float*, int) {}

__global__ void copy_kernel(const float4* __restrict__ x,
                            float4* __restrict__ y, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    y[i] = __ldg(x + i);
  }
}

__global__ void __launch_bounds__(kGridThreads)
contig_stats_kernel(const float* __restrict__ lw, const float* __restrict__ m,
                    float* __restrict__ cum, float* __restrict__ tot,
                    float* __restrict__ sqtot, int nb) {
  constexpr int R = kRegs;
  int l;
  const long long row = lane_row<32>(l);
  const bool live = row < nb;
  const long long at = row * kWidth + static_cast<long long>(l) * R;
  float x[R];
  if (live) {
    load_run<R>(lw + at, x);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = 0.0f;
  }
  const float mm = __ldg(m);
  float sq[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    x[j] = expf(__fsub_rn(x[j], mm));
    sq[j] = __fmul_rn(x[j], x[j]);
  }
  // the tree: adjacent registers, then the lanes
#pragma unroll
  for (int d = 1; d < R; d <<= 1) {
#pragma unroll
    for (int j = 0; j < R; j += 2 * d) sq[j] = __fadd_rn(sq[j], sq[j + d]);
  }
  float sqt = sq[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    sqt = __fadd_rn(sqt, __shfl_xor_sync(kFull, sqt, o));
  }
  // levels k < R: x[j-k] in this lane, or register j-k+R of lane l-1
#pragma unroll
  for (int k = 1; k < R; k <<= 1) {
    float old[R];
#pragma unroll
    for (int j = 0; j < R; ++j) old[j] = x[j];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j >= k) {
        x[j] = __fadd_rn(old[j], old[j >= k ? j - k : 0]);
      } else {
        const float y = __shfl_up_sync(kFull, old[j - k + R], 1);
        x[j] = __fadd_rn(old[j], l == 0 ? 0.0f : y);
      }
    }
  }
  // levels k >= R: x[i-k] is register j of lane l - k/R
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float y = __shfl_up_sync(kFull, x[j], d);
      x[j] = __fadd_rn(x[j], l >= d ? y : 0.0f);
    }
  }
  if (!live) return;
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    reinterpret_cast<float4*>(cum + at)[q] =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
  if (l == 31) {
    tot[row] = x[R - 1];
    sqtot[row] = sqt;
  }
}

__global__ void __launch_bounds__(kGridThreads)
twoscan_stats_kernel(const float* __restrict__ lw, const float* __restrict__ m,
                     float* __restrict__ cum, float* __restrict__ tot,
                     float* __restrict__ sqtot, int nb) {
  constexpr int R = kRegs;
  int l;
  const long long row = lane_row<32>(l);
  const bool live = row < nb;
  const long long at = row * kWidth + l;
  float x[R];
  load_strided(lw + at, live, x);
  const float mm = __ldg(m);
  float sq[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    x[j] = expf(__fsub_rn(x[j], mm));
    sq[j] = __fmul_rn(x[j], x[j]);
  }
  // both scans level by level, as the replaced kernel ran them
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int src = (l - k) & 31;
    float before = 0.0f;
    float before_sq = 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float r = __shfl_sync(kFull, x[j], src);
      const float r_sq = __shfl_sync(kFull, sq[j], src);
      x[j] = __fadd_rn(x[j], l >= k ? r : before);
      sq[j] = __fadd_rn(sq[j], l >= k ? r_sq : before_sq);
      before = r;
      before_sq = r_sq;
    }
  }
#pragma unroll
  for (int d = 1; d < R; d <<= 1) {
#pragma unroll
    for (int j = R - 1; j >= d; --j) {
      x[j] = __fadd_rn(x[j], x[j - d]);
      sq[j] = __fadd_rn(sq[j], sq[j - d]);
    }
  }
  if (!live) return;
  cum += at;
#pragma unroll
  for (int j = 0; j < R; ++j) cum[32 * j] = x[j];
  if (l == 31) {
    tot[row] = x[R - 1];
    sqtot[row] = sq[R - 1];
  }
}

__global__ void __launch_bounds__(kGridThreads)
strided_positions_kernel(const float* __restrict__ cum,
                         const float* __restrict__ offs,
                         const float* __restrict__ total,
                         const float* __restrict__ u, int* __restrict__ s_rows,
                         int* __restrict__ mx, int nb, float n) {
  constexpr int R = kRegs;
  int l;
  const long long row = lane_row<32>(l);
  const bool live = row < nb;
  const long long at = row * kWidth + l;
  float c[R];
  load_strided(cum + at, live, c);
  const float off = live ? __ldg(offs + row) : 0.0f;
  const float t = __ldg(total);
  const float uu = __ldg(u);
  int carry = INT_MIN;  // the max of the registers before j
  int s[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float v = ceilf(__fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(c[j], off), t),
                                        n), uu));
    v = fminf(fmaxf(v, 0.0f), n);
    int upto = static_cast<int>(v);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, upto, o);
      if (l >= o) upto = max(upto, y);
    }
    s[j] = max(upto, carry);
    carry = max(carry, __shfl_sync(kFull, upto, 31));
  }
  if (!live) return;
  s_rows += at;
#pragma unroll
  for (int j = 0; j < R; ++j) s_rows[32 * j] = s[j];
  if (l == 31) mx[row] = carry;
}

__global__ void __launch_bounds__(kGridThreads)
contig_positions_kernel(const float* __restrict__ cum,
                        const float* __restrict__ offs,
                        const float* __restrict__ total,
                        const float* __restrict__ u, int* __restrict__ s_rows,
                        int* __restrict__ mx, int nb, float n) {
  constexpr int R = kRegs;
  int l;
  const long long row = lane_row<32>(l);
  if (row >= nb) return;
  const long long at = row * kWidth + static_cast<long long>(l) * R;
  float c[R];
  load_run<R>(cum + at, c);
  const float off = __ldg(offs + row);
  const float t = __ldg(total);
  const float uu = __ldg(u);
  int s[R];
  int run = INT_MIN;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float v = ceilf(__fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(c[j], off), t),
                                        n), uu));
    v = fminf(fmaxf(v, 0.0f), n);
    s[j] = run = max(run, static_cast<int>(v));
  }
  int upto = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, upto, o);
    if (l >= o) upto = max(upto, y);
  }
  int before = __shfl_up_sync(kFull, upto, 1);
  if (l == 0) before = INT_MIN;
#pragma unroll
  for (int j = 0; j < R; ++j) s[j] = max(s[j], before);
  store_run<R>(s_rows + at, s);
  if (l == 31) mx[row] = upto;
}

__global__ void legacy_stats_kernel(const float* __restrict__ lw,
                                    const float* __restrict__ m,
                                    float* __restrict__ cum,
                                    float* __restrict__ tot,
                                    float* __restrict__ sqtot, int bw) {
  __shared__ float sa[kWidth];
  __shared__ float sb[kWidth];
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

__global__ void legacy_positions_kernel(const float* __restrict__ cum,
                                        const float* __restrict__ offs,
                                        const float* __restrict__ total,
                                        const float* __restrict__ u,
                                        int* __restrict__ s_rows,
                                        int* __restrict__ mx, int bw,
                                        float n) {
  __shared__ int ss[kWidth];
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

template <int P>
__global__ void __launch_bounds__(kGridThreads)
stats_phase_kernel(const float* __restrict__ lw, const float* __restrict__ m,
                   float* __restrict__ cum, float* __restrict__ tot,
                   float* __restrict__ sqtot, int nb) {
  constexpr int R = kRegs;
  int l;
  const long long row = lane_row<32>(l);
  const bool live = row < nb;
  const long long at = row * kWidth + l;
  float x[R];
  load_strided(lw + at, live, x);
  float sqt = 0.0f;
  if constexpr (P >= 1) {
    const float mm = __ldg(m);
    float sq[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      x[j] = expf(__fsub_rn(x[j], mm));
      sq[j] = __fmul_rn(x[j], x[j]);
    }
    if constexpr (P == 2) sqt = square_tree<32, R>(sq, l);
    if constexpr (P == 3) strided_scan<32, R>(x, l);
  }
  if (!live) return;
  cum += at;
#pragma unroll
  for (int j = 0; j < R; ++j) cum[32 * j] = x[j];
  if (l == 31) {
    tot[row] = x[R - 1];
    sqtot[row] = sqt;
  }
}

template <int P>
__global__ void __launch_bounds__(kGridThreads)
positions_phase_kernel(const float* __restrict__ cum,
                       const float* __restrict__ offs,
                       const float* __restrict__ total,
                       const float* __restrict__ u, int* __restrict__ s_rows,
                       int* __restrict__ mx, int nb, float n) {
  int l;
  const long long row = lane_row<32>(l);
  if (row >= nb) return;
  const long long at = row * kWidth + 4 * l;
  float c[kWords][4];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    load_word<4, true>(cum + at + 128 * q, c[q]);
  }
  int s[kWords][4];
  const float off = __ldg(offs + row);
  const float t = __ldg(total);
  const float uu = __ldg(u);
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    int run = INT_MIN;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (P == 0) {
        s[q][k] = __float_as_int(c[q][k]);
      } else {
        const float cdf = __fadd_rn(c[q][k], off);
        float v = ceilf(__fsub_rn(__fmul_rn(__fdiv_rn(cdf, t), n), uu));
        v = fminf(fmaxf(v, 0.0f), n);
        s[q][k] = static_cast<int>(v);
        if constexpr (P == 2) s[q][k] = run = max(run, s[q][k]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    store_word<4, true>(s_rows + at + 128 * q, s[q]);
  }
  if (l == 31) mx[row] = s[kWords - 1][3];
}

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// kernel 1's arguments (modppl_stats_cumsum_f32), bw = 1024
extern "C" int probe_empty_grid(const float* lw, const float* m, float* cum,
                                float* tot, float* sqtot, int nb, int bw,
                                cudaStream_t stream) {
  if (bw != kWidth) return static_cast<int>(cudaErrorInvalidValue);
  empty_grid_kernel<<<grid_blocks(nb, 32), kGridThreads, 0, stream>>>(
      lw, m, cum, tot, sqtot, nb);
  return done();
}

// n4 16-byte words from x to y (both 16-byte aligned)
extern "C" int probe_copy(const void* x, void* y, long long n4,
                          cudaStream_t stream) {
  copy_kernel<<<132 * 8, 256, 0, stream>>>(static_cast<const float4*>(x),
                                           static_cast<float4*>(y), n4);
  return done();
}

extern "C" int probe_contig_stats(const float* lw, const float* m, float* cum,
                                  float* tot, float* sqtot, int nb, int bw,
                                  cudaStream_t stream) {
  if (bw != kWidth || !aligned16(lw, cum)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  contig_stats_kernel<<<grid_blocks(nb, 32), kGridThreads, 0, stream>>>(
      lw, m, cum, tot, sqtot, nb);
  return done();
}

extern "C" int probe_twoscan_stats(const float* lw, const float* m,
                                   float* cum, float* tot, float* sqtot,
                                   int nb, int bw, cudaStream_t stream) {
  if (bw != kWidth) return static_cast<int>(cudaErrorInvalidValue);
  twoscan_stats_kernel<<<grid_blocks(nb, 32), kGridThreads, 0, stream>>>(
      lw, m, cum, tot, sqtot, nb);
  return done();
}

extern "C" int probe_legacy_stats(const float* lw, const float* m, float* cum,
                                  float* tot, float* sqtot, int nb, int bw,
                                  cudaStream_t stream) {
  legacy_stats_kernel<<<nb, bw, 0, stream>>>(lw, m, cum, tot, sqtot, bw);
  return done();
}

// kernel 2's arguments (modppl_positions_cummax_f32), bw = 1024
extern "C" int probe_strided_positions(const float* cum, const float* offs,
                                       const float* total, const float* u,
                                       int* s_rows, int* mx, int nb, int bw,
                                       int n, cudaStream_t stream) {
  if (bw != kWidth) return static_cast<int>(cudaErrorInvalidValue);
  strided_positions_kernel<<<grid_blocks(nb, 32), kGridThreads, 0, stream>>>(
      cum, offs, total, u, s_rows, mx, nb, static_cast<float>(n));
  return done();
}

extern "C" int probe_contig_positions(const float* cum, const float* offs,
                                      const float* total, const float* u,
                                      int* s_rows, int* mx, int nb, int bw,
                                      int n, cudaStream_t stream) {
  if (bw != kWidth || !aligned16(cum, s_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  contig_positions_kernel<<<grid_blocks(nb, 32), kGridThreads, 0, stream>>>(
      cum, offs, total, u, s_rows, mx, nb, static_cast<float>(n));
  return done();
}

extern "C" int probe_legacy_positions(const float* cum, const float* offs,
                                      const float* total, const float* u,
                                      int* s_rows, int* mx, int nb, int bw,
                                      int n, cudaStream_t stream) {
  legacy_positions_kernel<<<nb, bw, 0, stream>>>(
      cum, offs, total, u, s_rows, mx, bw, static_cast<float>(n));
  return done();
}

// the phase kernels with their kernel's arguments, bw = 1024
extern "C" int probe_stats_phase(int phase, const float* lw, const float* m,
                                 float* cum, float* tot, float* sqtot, int nb,
                                 int bw, cudaStream_t stream) {
  if (bw != kWidth) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = grid_blocks(nb, 32);
  switch (phase) {
    case 0: stats_phase_kernel<0><<<grid, kGridThreads, 0, stream>>>(
        lw, m, cum, tot, sqtot, nb); break;
    case 1: stats_phase_kernel<1><<<grid, kGridThreads, 0, stream>>>(
        lw, m, cum, tot, sqtot, nb); break;
    case 2: stats_phase_kernel<2><<<grid, kGridThreads, 0, stream>>>(
        lw, m, cum, tot, sqtot, nb); break;
    case 3: stats_phase_kernel<3><<<grid, kGridThreads, 0, stream>>>(
        lw, m, cum, tot, sqtot, nb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return done();
}

extern "C" int probe_positions_phase(int phase, const float* cum,
                                     const float* offs, const float* total,
                                     const float* u, int* s_rows, int* mx,
                                     int nb, int bw, int n,
                                     cudaStream_t stream) {
  if (bw != kWidth || !aligned16(cum, s_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = grid_blocks(nb, 32);
  const float fn = static_cast<float>(n);
  switch (phase) {
    case 0: positions_phase_kernel<0><<<grid, kGridThreads, 0, stream>>>(
        cum, offs, total, u, s_rows, mx, nb, fn); break;
    case 1: positions_phase_kernel<1><<<grid, kGridThreads, 0, stream>>>(
        cum, offs, total, u, s_rows, mx, nb, fn); break;
    case 2: positions_phase_kernel<2><<<grid, kGridThreads, 0, stream>>>(
        cum, offs, total, u, s_rows, mx, nb, fn); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return done();
}

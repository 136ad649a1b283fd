// Blocked systematic-resampling grid positions: kernels 1 and 2.
//
// Replaces modppl_tpu/ops/grid_positions_pallas.py:stats_cumsum (Pallas body
// _stats_kernel) and :positions_cummax (Pallas body _positions_kernel).
//
// What bounds them on the card: bytes. Each reads its (nb, bw) input once
// and writes its (nb, bw) output once, a few flops per element. A row is
// one warp's work (bw a power of two <= 1024; bw = _cdf_block(N): 1024 for
// N >= 2^16, smaller below), held in registers from its loads to its
// stores: the scans run in registers and warp shuffles, with no shared
// memory and no barrier. A row narrower than a warp takes bw lanes, and a
// warp takes 32 / bw rows; a CTA takes kGridWarps warps. At N = 2^20 the
// 1024 rows are 1024 warps, all resident at once.
//
// Exactness contract, so that results are bitwise those of the reference's
// XLA path on the same inputs (and of the plain versions in
// ops/grid_positions.py):
// - kernel 1's scan adds the same pairs as the reference's Hillis-Steele
//   order (sharded_smc.py:51-64: at levels k = 1, 2, ..., bw/2,
//   x[i] += x[i-k], x[i] + 0 for i < k). Lane l's register j holds element
//   i = l + W j (W lanes a row, R = bw / W registers a lane), so at a level
//   k < W, x[i-k] is lane l-k's register j, or for l < k lane l-k+W's
//   register j-1 (0 before the row): one rotate shuffle a register, and a
//   select. At k >= W it is this lane's register j - k/W. Every addition
//   has the reference's two operands, so the bits are the same by
//   construction. No CUB: its scans add in another tree.
// - sum(e^2) is the last element of the Hillis-Steele scan of e*e, as the
//   reference's CPU path computes it (sharded_smc.py:142-148; the TPU
//   kernel takes a plain jnp.sum, grid_positions_pallas.py:55, and the
//   port follows the CPU path so the CPU tests stay bitwise against the
//   reference). That last element is the balanced tree of adjacent pairs,
//   ((x0 + x1) + (x2 + x3)) + ..., and its cone holds no zero pad, so the
//   kernel takes the tree alone (square_tree: 36 shuffles a row at
//   bw = 1024), not a second scan.
// - e = expf(lw - m) with the accurate expf (the build does not use
//   --use_fast_math); every add and product is a round-to-nearest
//   intrinsic, so nvcc contracts nothing.
// - kernel 2's cummax is an integer max, exact in any order: lane l holds
//   words of 4 contiguous elements, its q-th word 4 (32 q + l) ... + 3, so
//   that a warp's loads and stores of a word are coalesced 16-byte lines;
//   each word's running max, a shuffle scan of the word maxima over the
//   lanes, and a carry across the words give each element its prefix
//   maximum. (Lane l holding elements 32 l ... 32 l + 31 instead needs
//   fewer shuffles, but its 16-byte accesses lie 128 bytes apart across a
//   warp and its loads and stores alone cost more than this whole kernel:
//   csrc/probes/grid_cost.py.) The positions keep the reference's order as
//   round-to-nearest intrinsics: cdf = cum + offs, then / total, then * n,
//   then - u. Written as plain operators nvcc would contract the multiply
//   and subtract into an FMA, which rounds once and moves S by one slot at
//   boundaries.
#include <cstdint>

#include <cuda_runtime.h>
#include <climits>

// The launch. ops/grid_positions.py reads these two #define lines for its
// CPU models and layout (grid_layout), so they stay the one place it is
// set; probes rebuild with -DMODPPL_GRID_WARPS to measure others.
// Warps a CTA:
#ifndef MODPPL_GRID_WARPS
#define MODPPL_GRID_WARPS 1
#endif
// Lanes a row of bw >= 32 (one warp; a narrower row takes bw lanes):
#define MODPPL_GRID_LANES 32

namespace {

constexpr int kGridWarps = MODPPL_GRID_WARPS;
constexpr int kGridThreads = 32 * kGridWarps;
constexpr unsigned kFull = 0xffffffffu;
static_assert(MODPPL_GRID_LANES == 32, "a row's shuffles span one warp");
static_assert(kGridWarps >= 1 && kGridWarps <= 32, "1-32 warps a CTA");

// The row of this thread's group of W lanes, and its lane l in the row.
template <int W>
__device__ __forceinline__ long long lane_row(int& l) {
  const int t = threadIdx.x & 31;
  l = t & (W - 1);
  return (static_cast<long long>(blockIdx.x) * kGridWarps + (threadIdx.x >> 5))
      * (32 / W) + t / W;
}

// The last element of the Hillis-Steele scan of v, returned to every lane
// of the row: the tree of adjacent pairs. Element level first, over the
// lanes (offsets 1, 2, ..., W/2), transposing while a lane holds more than
// one register: at offset o the lane with bit o clear keeps register 2q
// and the other keeps 2q+1, each adding the partner's copy of the same
// register, so the registers halve and lane l ends with the whole of
// register j = l mod R. Then the register level over the lanes
// (offsets 1, ..., R/2). Adds are commutative, so each sum has the tree's
// bits whichever lane computes it.
template <int W, int R>
__device__ __forceinline__ float square_tree(float (&v)[R], int l) {
  int held = R;  // registers still holding partial sums
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const bool upper = (l & o) != 0;
    if (held > 1) {
#pragma unroll
      for (int q = 0; q < R / 2; ++q) {
        if (2 * q + 1 < held) {
          const float keep = upper ? v[2 * q + 1] : v[2 * q];
          const float give = upper ? v[2 * q] : v[2 * q + 1];
          v[q] = __fadd_rn(keep, __shfl_xor_sync(kFull, give, o, W));
        }
      }
      held >>= 1;
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], o, W));
    }
  }
#pragma unroll
  for (int o = 1; o < R; o <<= 1) {
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], o, W));
  }
  return v[0];
}

// The inclusive Hillis-Steele scan of the row in x (lane l's register j is
// element l + W j), in the reference's add order.
template <int W, int R>
__device__ __forceinline__ void strided_scan(float (&x)[R], int l) {
#pragma unroll
  for (int k = 1; k < W; k <<= 1) {
    const int src = (l - k) & (W - 1);
    float before = 0.0f;  // register j-1 of lane l-k+W: 0 before the row
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float r = __shfl_sync(kFull, x[j], src, W);
      x[j] = __fadd_rn(x[j], l >= k ? r : before);
      before = r;
    }
  }
  // level k = W d; every inner loop runs R - 1 times so that nvcc unrolls
  // it whole (a trip count that depends on d left a loop of predicated
  // moves)
#pragma unroll
  for (int d = 1; d < R; d <<= 1) {
#pragma unroll
    for (int j = R - 1; j > 0; --j) {
      if (j >= d) x[j] = __fadd_rn(x[j], x[j >= d ? j - d : 0]);
    }
  }
}

template <int W, int R>
__global__ void __launch_bounds__(kGridThreads)
stats_cumsum_kernel(const float* __restrict__ lw, const float* __restrict__ m,
                    float* __restrict__ cum, float* __restrict__ tot,
                    float* __restrict__ sqtot, int nb) {
  int l;
  const long long row = lane_row<W>(l);
  const bool live = row < nb;
  const long long at = row * (W * R) + l;
  float x[R];
  if (live) {
    const float* in = lw + at;
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = __ldg(in + W * j);
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
  const float sqt = square_tree<W, R>(sq, l);
  strided_scan<W, R>(x, l);
  if (!live) return;
  float* out = cum + at;
#pragma unroll
  for (int j = 0; j < R; ++j) out[W * j] = x[j];
  if (l == W - 1) {
    tot[row] = x[R - 1];
    sqtot[row] = sqt;
  }
}

// V floats from p, one word of V = 1, 2 or 4 when kVec (p is then aligned
// to it).
template <int V, bool kVec>
__device__ __forceinline__ void load_word(const float* __restrict__ p,
                                          float (&v)[V]) {
  if constexpr (kVec && V == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (kVec && V == 2) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(p + k);
  }
}

template <int V, bool kVec>
__device__ __forceinline__ void store_word(int* __restrict__ p,
                                           const int (&v)[V]) {
  if constexpr (kVec && V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec && V == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

// Kernel 2's layout: lane l's word q (V = min(R, 4) elements, Q = R / V
// words a lane) holds elements V (W q + l) ... V (W q + l) + V - 1, so that
// each load and store of a word is one coalesced line across the row's
// lanes. An element's prefix maximum is the largest of its word's running
// max, the shuffle-up scan of word q over the lanes before l, and the
// carry, the maximum of the row's words before q.
template <int W, int R, bool kVec>
__global__ void __launch_bounds__(kGridThreads)
positions_cummax_kernel(const float* __restrict__ cum,
                        const float* __restrict__ offs,
                        const float* __restrict__ total,
                        const float* __restrict__ u, int* __restrict__ s_rows,
                        int* __restrict__ mx, int nb, float n) {
  constexpr int V = R < 4 ? R : 4;
  constexpr int Q = R / V;
  int l;
  const long long row = lane_row<W>(l);
  const bool live = row < nb;
  const long long at = row * (W * R) + static_cast<long long>(l) * V;
  float c[Q][V];
  float off = 0.0f;
  if (live) {
    const float* in = cum + at;
#pragma unroll
    for (int q = 0; q < Q; ++q) load_word<V, kVec>(in + q * W * V, c[q]);
    off = __ldg(offs + row);
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int k = 0; k < V; ++k) c[q][k] = 0.0f;
    }
  }
  const float t = __ldg(total);
  const float uu = __ldg(u);
  int s[Q][V];
  int upto[Q];  // the max of word q over lanes 0..l
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int run = INT_MIN;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float cdf = __fadd_rn(c[q][k], off);
      float v = ceilf(__fsub_rn(__fmul_rn(__fdiv_rn(cdf, t), n), uu));
      v = fminf(fmaxf(v, 0.0f), n);
      s[q][k] = run = max(run, static_cast<int>(v));
    }
    upto[q] = run;
  }
  // the words' lane scans side by side, so that their shuffles overlap
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int y = __shfl_up_sync(kFull, upto[q], o, W);
      if (l >= o) upto[q] = max(upto[q], y);
    }
  }
  int carry = INT_MIN;  // the max of the row's words before q
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int y = __shfl_up_sync(kFull, upto[q], 1, W);
    const int before = max(carry, l == 0 ? INT_MIN : y);
#pragma unroll
    for (int k = 0; k < V; ++k) s[q][k] = max(s[q][k], before);
    carry = max(carry, __shfl_sync(kFull, upto[q], W - 1, W));
  }
  if (!live) return;
  int* out = s_rows + at;
#pragma unroll
  for (int q = 0; q < Q; ++q) store_word<V, kVec>(out + q * W * V, s[q]);
  if (l == W - 1) mx[row] = carry;
}

// Calls f with the (lanes a row, registers a lane) of width bw, a power of
// two <= 1024; false for any other bw.
template <int W, int R>
struct Shape {
  static constexpr int kW = W;
  static constexpr int kR = R;
};

template <typename F>
bool by_width(int bw, F&& f) {
  switch (bw) {
    case 1: f(Shape<1, 1>{}); return true;
    case 2: f(Shape<2, 1>{}); return true;
    case 4: f(Shape<4, 1>{}); return true;
    case 8: f(Shape<8, 1>{}); return true;
    case 16: f(Shape<16, 1>{}); return true;
    case 32: f(Shape<32, 1>{}); return true;
    case 64: f(Shape<32, 2>{}); return true;
    case 128: f(Shape<32, 4>{}); return true;
    case 256: f(Shape<32, 8>{}); return true;
    case 512: f(Shape<32, 16>{}); return true;
    case 1024: f(Shape<32, 32>{}); return true;
    default: return false;
  }
}

// CTAs for nb rows of W lanes
inline unsigned grid_blocks(int nb, int w) {
  const long long rows = static_cast<long long>(kGridWarps) * (32 / w);
  return static_cast<unsigned>((nb + rows - 1) / rows);
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<std::uintptr_t>(a) |
          reinterpret_cast<std::uintptr_t>(b)) % 16 == 0;
}

}  // namespace

// lw (nb, bw) f32, m a device scalar -> cum (nb, bw), tot (nb,), sqtot (nb,)
extern "C" int modppl_stats_cumsum_f32(const float* lw, const float* m,
                                       float* cum, float* tot, float* sqtot,
                                       int nb, int bw, cudaStream_t stream) {
  const bool ok = by_width(bw, [&](auto shape) {
    using S = decltype(shape);
    stats_cumsum_kernel<S::kW, S::kR>
        <<<grid_blocks(nb, S::kW), kGridThreads, 0, stream>>>(
            lw, m, cum, tot, sqtot, nb);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// cum (nb, bw) f32, offs (nb,) f32, total and u device scalars, n = N
// -> s_rows (nb, bw) int32 (in-row cummax only), mx (nb,) int32 row maxima
extern "C" int modppl_positions_cummax_f32(const float* cum, const float* offs,
                                           const float* total, const float* u,
                                           int* s_rows, int* mx, int nb,
                                           int bw, int n,
                                           cudaStream_t stream) {
  const bool vec = aligned16(cum, s_rows);
  const bool ok = by_width(bw, [&](auto shape) {
    using S = decltype(shape);
    const unsigned blocks = grid_blocks(nb, S::kW);
    const float fn = static_cast<float>(n);
    if (vec) {
      positions_cummax_kernel<S::kW, S::kR, true>
          <<<blocks, kGridThreads, 0, stream>>>(cum, offs, total, u, s_rows,
                                                mx, nb, fn);
    } else {
      positions_cummax_kernel<S::kW, S::kR, false>
          <<<blocks, kGridThreads, 0, stream>>>(cum, offs, total, u, s_rows,
                                                mx, nb, fn);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

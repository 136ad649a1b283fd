// Whole-phase HMC chunks for quadratic targets at d >= 13: kernels 6 and 7;
// the leapfrog integration alone, at any d that fits: kernel 5.
//
// Replaces modppl_tpu/ops/leapfrog_pallas.py:hmc_sample_chunk (Pallas body
// _chunk_kernel_mxu), :hmc_warmup_chunk (Pallas body _warmup_kernel_mxu) and
// :fused_leapfrog (Pallas body _kernel). The target is
// logp(u) = b.u - u.Λu/2, grad g = b - uΛ. Kernel 5 shares the tile layout,
// the tile product and the leapfrog loop; its product's input is the
// position itself, not clamped (leapfrog_steps' template flag).
//
// What bounds them on the card: operations. A transition of one chain is
// (L + 1) products of a d-vector with the (d, d) Λ, 2 d^2 flops each; at
// d = 128, N = 4096, L = 32 the sampling phase does ~1.1e12 FP32 flops
// against ~1.1 GB of streams and outputs. The design: one CTA per tile of
// TC chains (32, or fewer where Λ and the tiles would not fit), with Λ
// (64 KB at d = 128) in dynamic shared memory and the tile's positions,
// momenta and gradients resident there across all L steps (the sampling
// kernel keeps them across all T transitions too). The gradient is a SIMT
// tile product in full FP32: each thread owns a 4-chain x 4-coordinate
// block, FFMA over k with Λ's row read as a float4. No TF32: the accept
// ratio is computed from these gradients, and the reference pins
// Precision.HIGHEST for that reason (leapfrog_pallas.py:48-55). The TPU's
// G = 128/s lane packing, its block-diagonal Λ and the B/Bt/C 0/1 matrices
// are not carried over: a chain owns its row, so nothing needs them.
//
// Per-chain energies follow the reference kernel: elementwise
// e = -u(b+g)/2 + im p^2/2, dH the sum of finite (e0 - e1) terms with any
// non-finite term flagging the chain divergent, logp by the identity
// u.(b+g)/2 (leapfrog_pallas.py:357), and the product's input clamped to
// +-1e30. Chains never share a product row, so a diverging chain leaves
// every other chain's results bitwise unchanged.
//
// Arithmetic order, so that the plain versions in ops/leapfrog.py can
// reproduce it: each gradient entry is one FFMA chain over k = 0..d-1 from
// 0 (the plain version's torch.addcmul chain); every other add, multiply
// and divide is a round-to-nearest intrinsic in the plain version's order;
// sums over a chain's coordinates are the adjacent-pairing tree over the
// coordinates zero-padded to a power of two (warp_tree_sum). Each run
// repeats bitwise. The warmup pools over all chains as hmc_small.cu's does:
// one cooperative launch, tile partials, grid.sync(), the same fixed-order
// tree in every block, no atomics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hmc_pooled.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace modppl;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared-memory carve-up, in floats; ops/leapfrog.py:smem_bytes mirrors
// its size. Rows of the (TC, dp) tiles are chains, dp = d rounded up to 4;
// padded coordinates are 0 in Λ, b, im, u and p, so they stay 0.
struct Tile {
  float *lam, *b, *im, *mean, *m2, *sums;
  float *u0, *u, *uc, *p, *g, *e0, *lpe;
  float *eps, *u01, *lp, *ap, *dv;
};

__host__ __device__ inline size_t tile_floats(int dp, int tc) {
  return static_cast<size_t>(dp) * dp + 6 * dp + 1 +
         7 * static_cast<size_t>(tc) * dp + 6 * tc;
}

__device__ inline Tile carve(float* s, int dp, int tc) {
  Tile t;
  const int m = tc * dp;
  t.lam = s;
  t.b = t.lam + dp * dp;
  t.im = t.b + dp;
  t.mean = t.im + dp;
  t.m2 = t.mean + dp;
  t.sums = t.m2 + dp;              // 1 + 2 dp
  t.u0 = t.sums + 2 * dp + 1;
  t.u = t.u0 + m;
  t.uc = t.u + m;
  t.p = t.uc + m;
  t.g = t.p + m;
  t.e0 = t.g + m;
  t.lpe = t.e0 + m;
  t.eps = t.lpe + m;
  t.u01 = t.eps + tc;
  t.lp = t.u01 + tc;
  t.ap = t.lp + tc;
  t.dv = t.ap + tc;
  return t;
}

// torch.clamp(v, -1e30, 1e30): NaN stays NaN
__device__ __forceinline__ float clip(float v) {
  return v != v ? v : fminf(fmaxf(v, -1e30f), 1e30f);
}

// -logp + kinetic of one coordinate: (-u/2)(b + g) + ((im/2) p) p
__device__ __forceinline__ float energy(float u, float b, float g, float im,
                                        float p) {
  return add(mul(mul(-0.5f, u), add(b, g)), mul(mul(mul(0.5f, im), p), p));
}

// Λ, b (and im, when given) into shared memory, zero-padded to dp.
__device__ void load_quadratic(const Tile& s, const float* lam,
                               const float* b, const float* im, int d,
                               int dp) {
  for (int i = threadIdx.x; i < dp * dp; i += blockDim.x) {
    const int k = i / dp, j = i - k * dp;
    s.lam[i] = (k < d && j < d) ? lam[k * d + j] : 0.0f;
  }
  for (int j = threadIdx.x; j < dp; j += blockDim.x) {
    s.b[j] = j < d ? b[j] : 0.0f;
    if (im != nullptr) s.im[j] = j < d ? im[j] : 0.0f;
  }
}

// g = b - clip(u) Λ for the thread's 4x4 blocks, then p += he * g there.
template <int TC>
__device__ void gradient_kick(const Tile& s, int d, int dp, bool kick) {
  const int njg = dp / 4;
  for (int tt = threadIdx.x; tt < (TC / 4) * njg; tt += blockDim.x) {
    const int c0 = (tt / njg) * 4, j0 = (tt % njg) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < d; ++k) {
      const float4 l = *reinterpret_cast<const float4*>(&s.lam[k * dp + j0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float uk = s.uc[(c0 + i) * dp + k];
        acc[i][0] = fmaf(uk, l.x, acc[i][0]);
        acc[i][1] = fmaf(uk, l.y, acc[i][1]);
        acc[i][2] = fmaf(uk, l.z, acc[i][2]);
        acc[i][3] = fmaf(uk, l.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      const float he = mul(0.5f, s.eps[c]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int idx = c * dp + j0 + jj;
        const float gv = sub(s.b[j0 + jj], acc[i][jj]);
        s.g[idx] = gv;
        if (kick) s.p[idx] = add(s.p[idx], mul(he, gv));
      }
    }
  }
}

// Adjacent-pairing tree sum over a chain's coordinates zero-padded to a
// power of two P <= 256 (the plain versions' _tree_sum over the coordinate
// axis): lane l holds coordinates [l E, (l + 1) E), E = max(1, P / 32), sums
// them by the same tree, then the lanes pair up; lane 0 gets the total.
// `term(j)` gives coordinate j's term.
template <typename Term>
__device__ __forceinline__ float warp_tree_sum(int d, Term term) {
  int P = 1;
  while (P < d) P <<= 1;
  const int E = P > 32 ? P / 32 : 1;
  const int lane = threadIdx.x & 31;
  float v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int j = lane * E + m;
    v[m] = (m < E && j < d) ? term(j) : 0.0f;
  }
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
    for (int m = 0; m < 8; m += 2 * s) v[m] = add(v[m], v[m + s]);
  }
  float t = v[0];
#pragma unroll
  for (int s = 1; s < 32; s <<= 1)
    t = add(t, __shfl_down_sync(0xffffffffu, t, s));
  return t;
}

// The product's input: clamped to +-1e30 in the chunk kernels (the
// reference's chunk kernels clamp), the position itself in the plain
// leapfrog (fused_leapfrog's gradient is b - uΛ, unclamped).
template <bool kClamp>
__device__ __forceinline__ float product_input(float v) {
  return kClamp ? clip(v) : v;
}

// `steps` leapfrog steps of the tile from s.u, s.p and their gradient s.g:
// half kick, drift, gradient, half kick, in the reference's order.
template <int TC, bool kClamp>
__device__ void leapfrog_steps(const Tile& s, int d, int dp, int steps) {
  const int m = TC * dp;
  for (int step = 0; step < steps; ++step) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int c = i / dp, j = i - c * dp;
      const float e = s.eps[c];
      const float p = add(s.p[i], mul(mul(0.5f, e), s.g[i]));
      const float u = add(s.u[i], mul(mul(e, s.im[j]), p));
      s.p[i] = p;
      s.u[i] = u;
      s.uc[i] = product_input<kClamp>(u);
    }
    __syncthreads();
    gradient_kick<TC>(s, d, dp, true);
    __syncthreads();
  }
}

// One HMC transition of the tile: s.u0 (positions) and s.p (momenta),
// s.eps and s.u01 per chain in; s.u0 becomes the post-accept positions and
// s.lp / s.ap / s.dv the chain's logp, accept probability and divergence.
template <int TC>
__device__ void tile_transition(const Tile& s, int d, int dp, int steps) {
  const int m = TC * dp;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s.u[i] = s.u0[i];
    s.uc[i] = clip(s.u0[i]);
  }
  __syncthreads();
  gradient_kick<TC>(s, d, dp, false);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int j = i % dp;
    s.e0[i] = energy(s.u0[i], s.b[j], s.g[i], s.im[j], s.p[i]);
    s.lpe[i] = mul(s.u0[i], add(s.b[j], s.g[i]));
  }
  __syncthreads();
  leapfrog_steps<TC, true>(s, d, dp, steps);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < TC; c += kWarps) {
    const float* u = s.u + c * dp;
    const float* g = s.g + c * dp;
    const float* p = s.p + c * dp;
    const float* e0 = s.e0 + c * dp;
    bool bad = false;
    const float dh = warp_tree_sum(d, [&](int j) {
      const float ed = sub(e0[j], energy(u[j], s.b[j], g[j], s.im[j], p[j]));
      const bool fin = isfinite(ed);
      bad |= !fin;
      return fin ? ed : 0.0f;
    });
    bad = __any_sync(0xffffffffu, bad);
    const float dh0 = __shfl_sync(0xffffffffu, dh, 0);
    const bool div = bad || !isfinite(dh0) || dh0 < -1000.0f;
    const float ap = div ? 0.0f : fminf(expf(fminf(dh0, 0.0f)), 1.0f);
    const bool acc = s.u01[c] < ap;
    const float* lpe = s.lpe + c * dp;
    const float lp = warp_tree_sum(d, [&](int j) {
      const float le = mul(0.5f, acc ? mul(u[j], add(s.b[j], g[j])) : lpe[j]);
      return isfinite(le) ? le : 0.0f;
    });
    if (acc) {
      for (int j = lane; j < d; j += 32) s.u0[c * dp + j] = u[j];
    }
    if (lane == 0) {
      s.lp[c] = lp;
      s.ap[c] = ap;
      s.dv[c] = div ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ u0, const float* __restrict__ mom,
              const float* __restrict__ epsj, const float* __restrict__ u01,
              const float* __restrict__ lam, const float* __restrict__ b,
              const float* __restrict__ im, int n, int d, int dp, int num,
              int steps, float* __restrict__ us, float* __restrict__ lps,
              float* __restrict__ aps, bool* __restrict__ dvs) {
  extern __shared__ float4 smem4[];
  const Tile s = carve(reinterpret_cast<float*>(smem4), dp, TC);
  load_quadratic(s, lam, b, im, d, dp);
  const int cb = blockIdx.x * TC;
  for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
    const int c = i / dp, j = i - c * dp;
    s.u0[i] = (cb + c < n && j < d) ? u0[static_cast<size_t>(cb + c) * d + j]
                                    : 0.0f;
  }
  for (int t = 0; t < num; ++t) {
    const size_t row = static_cast<size_t>(t) * n + cb;
    for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
      const int c = i / dp, j = i - c * dp;
      s.p[i] = (cb + c < n && j < d) ? mom[(row + c) * d + j] : 0.0f;
    }
    for (int c = threadIdx.x; c < TC; c += blockDim.x) {
      const bool live = cb + c < n;
      s.eps[c] = live ? epsj[row + c] : 0.0f;
      s.u01[c] = live ? u01[row + c] : 2.0f;   // a padded chain never moves
    }
    __syncthreads();
    tile_transition<TC>(s, d, dp, steps);
    for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
      const int c = i / dp, j = i - c * dp;
      if (cb + c < n && j < d) us[(row + c) * d + j] = s.u0[i];
    }
    for (int c = threadIdx.x; c < TC; c += blockDim.x) {
      if (cb + c < n) {
        lps[row + c] = s.lp[c];
        aps[row + c] = s.ap[c];
        dvs[row + c] = s.dv[c] != 0.0f;
      }
    }
  }
}

// fused_leapfrog (kernel 5): L leapfrog steps of a tile of chains with Λ
// and the tile resident in shared memory, returning (u_L, p_L). No clamp,
// no energies, no accept: those run as plain torch around it, as XLA runs
// them around the reference kernel.
template <int TC>
__global__ void __launch_bounds__(kThreads)
leapfrog_kernel(const float* __restrict__ u0, const float* __restrict__ p0,
                const float* __restrict__ eps, const float* __restrict__ lam,
                const float* __restrict__ b, const float* __restrict__ im,
                int n, int d, int dp, int steps, float* __restrict__ u_out,
                float* __restrict__ p_out) {
  extern __shared__ float4 smem4[];
  const Tile s = carve(reinterpret_cast<float*>(smem4), dp, TC);
  load_quadratic(s, lam, b, im, d, dp);
  const int cb = blockIdx.x * TC;
  for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
    const int c = i / dp, j = i - c * dp;
    const bool live = cb + c < n && j < d;
    const size_t g = static_cast<size_t>(cb + c) * d + j;
    s.u[i] = live ? u0[g] : 0.0f;
    s.uc[i] = s.u[i];
    s.p[i] = live ? p0[g] : 0.0f;
  }
  for (int c = threadIdx.x; c < TC; c += blockDim.x)
    s.eps[c] = cb + c < n ? eps[cb + c] : 0.0f;
  __syncthreads();
  gradient_kick<TC>(s, d, dp, false);
  __syncthreads();
  leapfrog_steps<TC, false>(s, d, dp, steps);
  for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
    const int c = i / dp, j = i - c * dp;
    if (cb + c < n && j < d) {
      const size_t g = static_cast<size_t>(cb + c) * d + j;
      u_out[g] = s.u[i];
      p_out[g] = s.p[i];
    }
  }
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
warmup_kernel(float* __restrict__ u, const float* __restrict__ z,
              const float* __restrict__ jit, const float* __restrict__ u01,
              const float* __restrict__ lam, const float* __restrict__ b,
              int n, int d, int dp, int num, int steps, float eps0,
              float eps0x10, float target, int nwin,
              const int* __restrict__ sch, float* __restrict__ part,
              int ntiles, int ptiles, float* __restrict__ eps_out,
              float* __restrict__ im_out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const Tile s = carve(reinterpret_cast<float*>(smem4), dp, TC);
  __shared__ DualAveraging da;
  // reduction scratch: the tile arrays from uc on, free between
  // transitions (u0 and the per-chain outputs are read while it fills)
  float* red = s.uc;
  const int cap = 5 * TC * dp;
  load_quadratic(s, lam, b, nullptr, d, dp);
  for (int j = threadIdx.x; j < dp; j += blockDim.x) {
    s.im[j] = j < d ? 1.0f : 0.0f;
    s.mean[j] = s.m2[j] = 0.0f;
  }
  if (threadIdx.x == 0) da.init(eps0, eps0x10);
  __syncthreads();
  const float c_live = static_cast<float>(n);
  const int rows = 1 + 2 * d;

  for (int t = 0; t < num; ++t) {
    bool in_slow, at_end;
    window_flags(sch, nwin, t, in_slow, at_end);
    if (at_end) {
      for (int j = threadIdx.x; j < d; j += blockDim.x) {
        s.im[j] = window_variance(s.m2[j], da.nw);
        s.mean[j] = s.m2[j] = 0.0f;
      }
      __syncthreads();
      if (threadIdx.x == 0) da.restart();
    }
    __syncthreads();
    float* pb = part + static_cast<size_t>(t & 1) * rows * ptiles;
    const int r1 = in_slow ? 1 + d : 1;
    const float eps_t = expf(da.log_eps);

    // pass 1: the tiles' transitions; tile sums of aprob (and of u)
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int cb = tile * TC;
      const size_t row = static_cast<size_t>(t) * n + cb;
      for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
        const int c = i / dp, j = i - c * dp;
        const bool live = cb + c < n && j < d;
        s.u0[i] = live ? u[static_cast<size_t>(cb + c) * d + j] : 0.0f;
        s.p[i] = live ? mul(z[(row + c) * d + j], rsqrtf(s.im[j])) : 0.0f;
      }
      for (int c = threadIdx.x; c < TC; c += blockDim.x) {
        const bool live = cb + c < n;
        s.eps[c] = live ? mul(eps_t, jit[row + c]) : 0.0f;
        s.u01[c] = live ? u01[row + c] : 2.0f;
      }
      __syncthreads();
      tile_transition<TC>(s, d, dp, steps);
      for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
        const int c = i / dp, j = i - c * dp;
        if (cb + c < n && j < d) u[static_cast<size_t>(cb + c) * d + j] = s.u0[i];
      }
      __syncthreads();
      // red rows: [0] aprob, [1 + j] coordinate j, each over the TC chains
      for (int i = threadIdx.x; i < r1 * TC; i += blockDim.x) {
        const int r = i / TC, c = i - r * TC;
        const bool live = cb + c < n;
        red[i] = !live ? 0.0f : r == 0 ? s.ap[c] : s.u0[c * dp + r - 1];
      }
      __syncthreads();
      tree_rows(red, r1, TC);
      for (int r = threadIdx.x; r < r1; r += blockDim.x)
        pb[r * ptiles + tile] = red[r * TC];
      __syncthreads();
    }
    grid.sync();
    reduce_partials(pb, r1, ptiles, red, cap, s.sums);
    if (threadIdx.x == 0) da.update(quo(s.sums[0], c_live), target);
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      s.sums[1 + j] = quo(s.sums[1 + j], c_live);
    __syncthreads();
    if (!in_slow) continue;

    // pass 2 (slow windows): squared deviations from the batch mean
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int cb = tile * TC;
      for (int i = threadIdx.x; i < d * TC; i += blockDim.x) {
        const int j = i / TC, c = i - j * TC;
        float sq = 0.0f;
        if (cb + c < n) {
          const float dv =
              sub(u[static_cast<size_t>(cb + c) * d + j], s.sums[1 + j]);
          sq = mul(dv, dv);
        }
        red[i] = sq;
      }
      __syncthreads();
      tree_rows(red, d, TC);
      for (int j = threadIdx.x; j < d; j += blockDim.x)
        pb[(1 + d + j) * ptiles + tile] = red[j * TC];
      __syncthreads();
    }
    grid.sync();
    reduce_partials(pb + (1 + d) * ptiles, d, ptiles, red, cap,
                    s.sums + 1 + d);
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      welford_merge(s.mean[j], s.m2[j], s.sums[1 + j], s.sums[1 + d + j],
                    da.nw, c_live);
    __syncthreads();
    if (threadIdx.x == 0) da.nw = add(da.nw, c_live);
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) *eps_out = expf(da.leb);
    for (int j = threadIdx.x; j < d; j += blockDim.x) im_out[j] = s.im[j];
  }
}

template <int TC>
cudaError_t launch_sample(const float* u0, const float* mom, const float* epsj,
                          const float* u01, const float* lam, const float* b,
                          const float* im, int n, int d, int num, int steps,
                          float* us, float* lps, float* aps, bool* dvs,
                          cudaStream_t stream) {
  const int dp = (d + 3) / 4 * 4;
  const size_t smem = tile_floats(dp, TC) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sample_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = (n + TC - 1) / TC;
  sample_kernel<TC><<<grid, kThreads, smem, stream>>>(
      u0, mom, epsj, u01, lam, b, im, n, d, dp, num, steps, us, lps, aps, dvs);
  return cudaGetLastError();
}

template <int TC>
cudaError_t launch_leapfrog(const float* u, const float* p, const float* eps,
                            const float* lam, const float* b, const float* im,
                            int n, int d, int steps, float* u_out,
                            float* p_out, cudaStream_t stream) {
  const int dp = (d + 3) / 4 * 4;
  const size_t smem = tile_floats(dp, TC) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      leapfrog_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = (n + TC - 1) / TC;
  leapfrog_kernel<TC><<<grid, kThreads, smem, stream>>>(
      u, p, eps, lam, b, im, n, d, dp, steps, u_out, p_out);
  return cudaGetLastError();
}

template <int TC>
cudaError_t launch_warmup(float* u, const float* z, const float* jit,
                          const float* u01, const float* lam, const float* b,
                          int n, int d, int num, int steps, float eps0,
                          float eps0x10, float target, int nwin,
                          const int* sch, float* part, float* eps_out,
                          float* im_out, cudaStream_t stream) {
  int dp = (d + 3) / 4 * 4;
  int ntiles = (n + TC - 1) / TC;
  int ptiles = 1;
  while (ptiles < ntiles) ptiles <<= 1;
  if (nwin > kMaxWindows || ptiles > 5 * TC * dp) return cudaErrorInvalidValue;
  const size_t smem = tile_floats(dp, TC) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      warmup_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  void* args[] = {&u,      &z,       &jit,    &u01,   &lam,    &b,
                  &n,      &d,       &dp,     &num,   &steps,  &eps0,
                  &eps0x10, &target, &nwin,   &sch,   &part,   &ntiles,
                  &ptiles, &eps_out, &im_out};
  return launch_cooperative(warmup_kernel<TC>, ntiles, kThreads, smem, args,
                            stream);
}

}  // namespace

#define MODPPL_DISPATCH_TILE(tc, CALL) \
  switch (tc) {                        \
    case 32: return CALL(32);          \
    case 16: return CALL(16);          \
    case 8: return CALL(8);            \
    case 4: return CALL(4);            \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// u (n, d), mom (num, n, d), epsj and u01 (num, n), Λ (d, d), b and
// inv_mass (d,), all f32; tc chains per CTA -> us (num, n, d), lps and aps
// (num, n) f32, dvs (num, n) bool
extern "C" int modppl_hmc_sample_chunk_f32(
    const float* u, const float* mom, const float* epsj, const float* u01,
    const float* lam, const float* b, const float* im, int n, int d, int num,
    int steps, int tc, float* us, float* lps, float* aps, bool* dvs,
    cudaStream_t stream) {
#define MODPPL_SAMPLE(TC)                                                   \
  static_cast<int>(launch_sample<TC>(u, mom, epsj, u01, lam, b, im, n, d,   \
                                     num, steps, us, lps, aps, dvs, stream))
  MODPPL_DISPATCH_TILE(tc, MODPPL_SAMPLE)
#undef MODPPL_SAMPLE
}

// us (n, d) f32: the start positions, overwritten with the final ones;
// z (num, n, d), jit and u01 (num, n), Λ (d, d), b (d,) f32; sch int32
// (2, 32): slow-window starts and ends, nwin of them; part f32
// (2, 1 + 2d, ptiles) zeroed scratch; tc chains per CTA
// -> eps_out (), im_out (d,)
extern "C" int modppl_hmc_warmup_chunk_f32(
    float* us, const float* z, const float* jit, const float* u01,
    const float* lam, const float* b, int n, int d, int num, int steps,
    float eps0, float eps0x10, float target, int nwin, const int* sch,
    float* part, int tc, float* eps_out, float* im_out, cudaStream_t stream) {
#define MODPPL_WARMUP(TC)                                                     \
  static_cast<int>(launch_warmup<TC>(us, z, jit, u01, lam, b, n, d, num,      \
                                     steps, eps0, eps0x10, target, nwin, sch, \
                                     part, eps_out, im_out, stream))
  MODPPL_DISPATCH_TILE(tc, MODPPL_WARMUP)
#undef MODPPL_WARMUP
}

// u, p (n, d), eps (n,), Λ (d, d), b and inv_mass (d,), all f32; tc chains
// per CTA -> u_out, p_out (n, d) f32 after `steps` leapfrog steps
extern "C" int modppl_fused_leapfrog_f32(
    const float* u, const float* p, const float* eps, const float* lam,
    const float* b, const float* im, int n, int d, int steps, int tc,
    float* u_out, float* p_out, cudaStream_t stream) {
#define MODPPL_LEAPFROG(TC)                                                  \
  static_cast<int>(launch_leapfrog<TC>(u, p, eps, lam, b, im, n, d, steps,   \
                                       u_out, p_out, stream))
  MODPPL_DISPATCH_TILE(tc, MODPPL_LEAPFROG)
#undef MODPPL_LEAPFROG
}

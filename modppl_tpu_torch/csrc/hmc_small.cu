// Whole-phase HMC chunks for quadratic targets at d <= 12: kernels 9 and 10;
// one whole transition at d <= 7: kernel 8.
//
// Replaces modppl_tpu/ops/leapfrog_vpu_pallas.py:hmc_sample_chunk_small
// (Pallas body _chunk_kernel), :hmc_warmup_chunk_small (Pallas body
// _warmup_kernel) and :hmc_transition_small (Pallas body _kernel over
// _transition_core). The target is logp(u) = b.u - u.Λu/2, grad = b - Λu.
//
// What bounds them on the card: latency. Per chain and transition the work
// is L leapfrog steps of d^2 multiply-adds, a few hundred flops, against
// (2d + 5) floats of traffic, and the T transitions of a chain are a strict
// sequence; at N = 10^4 chains there are fewer threads than the card holds,
// one warp a scheduler at most, so nothing hides one chain's latency behind
// another's. Every chain is one thread, its state (positions, momenta,
// gradients) in registers, with a template on d so the d^2 gradient terms
// unroll. The TPU kernel's (8d, N/8) sublane packing and its parameter tile
// have no counterpart: a thread per chain needs neither.
//
// Kernel 9 loops over all T transitions in one launch. A transition's
// dependent chain is ~450-600 cycles at d = 3, L = 8 (eight steps of about
// ten dependent FP32 operations, the Hamiltonians, expf, the select), so a
// load issued when the transition starts would stall it for a whole DRAM
// round trip (~0.6-0.8 us: the streams are new each transition and never
// in L2). So each thread copies its own chain's streams (the momenta, the
// step size, the accept uniform) into a ring of kStages slots in shared
// memory with cp.async, kStages - 1 transitions ahead of the one it
// computes. A thread only ever reads the slots it filled, so
// cp.async.wait_group alone guards a slot, and no block barrier does; the
// slot refilled at transition t was read at t - 1, before t's wait (a
// compiler memory barrier), and its values fed t - 1's arithmetic. Three
// transitions ahead (kStages = 4, ~1 us of arithmetic at the measured
// ~0.35 us a transition) cover the round trip: at the hierarchical leg's
// shapes a ring of 4 or 8 gives the same time, 1.24x that of the same loop
// with no DRAM traffic at all, and a ring of 2 is 37% slower. 32 chains a
// block run ~30% faster than 64 or 128, and ~25% faster with no DRAM
// traffic, though no SM holds more than four warps, one for each of its
// schedulers, either way (csrc/probes/small_cost.py; PERF.md §6). Λ, b and
// the inverse mass are read once into registers (__ldg, every lane the same
// address): at d = 12 that is 168 floats and the kernel takes 241
// registers, with no spills.
//
// Kernel 8 is one launch per transition (hmc_quadratic runs one a
// transition), so at 10^4 chains and d = 3 its time is launch latency plus
// one chain's transition. It makes one memory round trip: every load (u, p,
// eps, u01 and the coefficients into registers) is issued at entry, with
// no shared-memory staging and no block barrier.
//
// Exactness contract, so that results are bitwise those of the plain
// versions in ops/leapfrog_small.py on the same inputs: every add, multiply
// and divide is a round-to-nearest intrinsic in the plain version's order
// (no FMA contraction); sums over coordinates run in index order; exp, log,
// sqrt and rsqrt are CUDA's accurate expf, logf, sqrtf and rsqrtf, as
// PyTorch's CUDA kernels call them. Pooled sums over chains are the
// adjacent-pairing tree over the chain axis zero-padded to a power of two
// (the plain versions' _tree_sum): a tree inside each 256-chain tile, then
// the same tree over the tile totals. The tree over 2^k entries splits at
// any aligned power-of-two boundary, so that is the one tree over all
// chains.
//
// The warmup pools statistics over ALL chains every iteration (the accept
// mean for dual averaging; in slow windows the batch mean, then the
// squared deviations from it), and the next iteration's step size depends
// on them. Blocks run in no order, so the warmup is ONE cooperative launch:
// blocks loop over chain tiles, write tile partials, and meet at
// grid.sync(); then every block reduces the partials in the same fixed
// order and updates its own copy of the dual-averaging, Welford and
// inverse-mass state, so no scalar is ever broadcast and no float atomic
// is used: a run repeats bitwise. Partials are double-buffered by
// iteration parity, so one sync per reduction suffices, and a slow
// iteration's squared deviations are pooled after the next iteration's
// grid.sync() (merge_batch): one grid.sync() an iteration, plus one at the
// end of each slow window, where the inverse mass needs them at once. The
// tile sums and the sums over tile partials are each one warp a row
// (hmc_pooled.cuh: warp_rows, one __syncthreads; reduce_partials above 256
// tiles), not a __syncthreads a tree level. When every block holds one
// tile, each chain's position stays in its thread's registers for the
// whole warmup, and the next iteration's streams are loaded before the
// grid.sync().
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hmc_pooled.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace modppl;

constexpr int kMaxDim = 12;
// Kernel 9's chains a block and ring depth, kernel 8's chains a block
// (ops/leapfrog_small.SAMPLE_BLOCK, SAMPLE_STAGES, TRANSITION_BLOCK). The
// probe csrc/probes/small_cost.py builds this file with other values to
// time them; the kernel library never does.
#ifndef MODPPL_SAMPLE_BLOCK
#define MODPPL_SAMPLE_BLOCK 32
#endif
#ifndef MODPPL_SAMPLE_STAGES
#define MODPPL_SAMPLE_STAGES 4
#endif
#ifndef MODPPL_TRANSITION_BLOCK
#define MODPPL_TRANSITION_BLOCK 128
#endif
constexpr int kSampleBlock = MODPPL_SAMPLE_BLOCK;
constexpr int kStages = MODPPL_SAMPLE_STAGES;
constexpr int kTransitionBlock = MODPPL_TRANSITION_BLOCK;
static_assert(kStages >= 2 && (kStages & (kStages - 1)) == 0,
              "kStages is a power of two, at least 2");
constexpr int kTile = 256;        // ops/leapfrog_small.WARMUP_TILE
constexpr int kMaxTiles = 1024;   // ops/leapfrog_small.MAX_WARMUP_TILES
constexpr int kRedRows = 2 * kMaxDim + 1;

// g = b - Λu, the sum over k in order
template <int D>
__device__ __forceinline__ void grad(const float* lam, const float* b,
                                     const float (&u)[D], float (&g)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float acc = mul(u[0], lam[j * D]);
#pragma unroll
    for (int k = 1; k < D; ++k) acc = add(acc, mul(u[k], lam[j * D + k]));
    g[j] = sub(b[j], acc);
  }
}

// b.u - 0.5 * sum_jk (Λjk u_j) u_k, both sums in index order
template <int D>
__device__ __forceinline__ float logp(const float* lam, const float* b,
                                      const float (&u)[D]) {
  float quad = mul(mul(lam[0], u[0]), u[0]);
#pragma unroll
  for (int jk = 1; jk < D * D; ++jk)
    quad = add(quad, mul(mul(lam[jk], u[jk / D]), u[jk % D]));
  float lin = mul(b[0], u[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) lin = add(lin, mul(b[j], u[j]));
  return sub(lin, mul(0.5f, quad));
}

template <int D>
__device__ __forceinline__ float kinetic(const float* im, const float (&p)[D]) {
  float s = mul(mul(im[0], p[0]), p[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) s = add(s, mul(mul(im[j], p[j]), p[j]));
  return mul(0.5f, s);
}

// One HMC transition of one chain: u is replaced by the post-accept
// position, p by the trajectory's end momentum; h0 and h1 are the
// Hamiltonians at its start and end.
template <int D>
__device__ __forceinline__ void transition(const float* lam, const float* b,
                                           const float* im, float (&u)[D],
                                           float (&p)[D], float eps,
                                           float u01, int steps, float& lp,
                                           float& ap, bool& dv, float& h0,
                                           float& h1) {
  float u0[D], ei[D], g[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    u0[j] = u[j];
    ei[j] = mul(eps, im[j]);
  }
  const float logp0 = logp<D>(lam, b, u0);
  h0 = add(-logp0, kinetic<D>(im, p));
  const float he = mul(0.5f, eps);
  grad<D>(lam, b, u, g);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = add(p[j], mul(he, g[j]));
#pragma unroll
    for (int j = 0; j < D; ++j) u[j] = add(u[j], mul(ei[j], p[j]));
    grad<D>(lam, b, u, g);
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = add(p[j], mul(he, g[j]));
  }
  const float logp1 = logp<D>(lam, b, u);
  h1 = add(-logp1, kinetic<D>(im, p));
  const float delta = sub(h0, h1);
  dv = !isfinite(delta) || delta < -1000.0f;
  ap = dv ? 0.0f : fminf(expf(fminf(delta, 0.0f)), 1.0f);
  const bool acc = u01 < ap;
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = acc ? u[j] : u0[j];
  lp = acc ? logp1 : logp0;
}

// Λ, b and the inverse mass of dimension D packed as [Λ | b | im].
template <int D>
constexpr int kQuad = D * D + 2 * D;

// The packed coefficients into q, every load issued before any is used;
// all lanes of a warp read the same address, one broadcast a load.
template <int D>
__device__ __forceinline__ void load_coefficients(const float* lam,
                                                  const float* b,
                                                  const float* im, float* q) {
#pragma unroll
  for (int i = 0; i < D * D; ++i) q[i] = __ldg(lam + i);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    q[D * D + j] = __ldg(b + j);
    q[D * D + D + j] = __ldg(im + j);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Kernel 9's ring: slot s holds one transition's streams of the block's
// chains, field f (momenta 0..D-1, step size D, accept uniform D + 1) of
// thread i at ring[(s * (D + 2) + f) * kSampleBlock + i].
template <int D>
__device__ __forceinline__ float* ring_slot(float* ring, int t) {
  return ring + (t & (kStages - 1)) * (D + 2) * kSampleBlock + threadIdx.x;
}

// Transition t's streams of chain c into its ring slot, asynchronously.
template <int D>
__device__ __forceinline__ void fetch_streams(float* ring, const float* mom,
                                              const float* epsj,
                                              const float* u01, int n, int t,
                                              int c) {
  const size_t r = static_cast<size_t>(t) * n + c;
  float* slot = ring_slot<D>(ring, t);
#pragma unroll
  for (int j = 0; j < D; ++j)
    cp_async4(slot + j * kSampleBlock, mom + r * D + j, true);
  cp_async4(slot + D * kSampleBlock, epsj + r, true);
  cp_async4(slot + (D + 1) * kSampleBlock, u01 + r, true);
}

template <int D>
__global__ void __launch_bounds__(kSampleBlock)
sample_small_kernel(const float* __restrict__ u0, const float* __restrict__ mom,
                    const float* __restrict__ epsj,
                    const float* __restrict__ u01,
                    const float* __restrict__ lam_g,
                    const float* __restrict__ b_g,
                    const float* __restrict__ im_g, int n, int num, int steps,
                    float* __restrict__ us, float* __restrict__ lps,
                    float* __restrict__ aps, bool* __restrict__ dvs) {
  extern __shared__ float ring[];
  const int c = blockIdx.x * kSampleBlock + threadIdx.x;
  if (c >= n) return;
  float q[kQuad<D>];
  load_coefficients<D>(lam_g, b_g, im_g, q);
  // one commit group a transition, empty past the last: before transition
  // t's wait, groups 0 .. t + kStages - 2 are committed, so group t is
  // complete once at most kStages - 2 are pending
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < num) fetch_streams<D>(ring, mom, epsj, u01, n, t, c);
    cp_async_commit();
  }
  float u[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = u0[static_cast<size_t>(c) * D + j];
  for (int t = 0; t < num; ++t) {
    cp_async_wait<kStages - 2>();
    const float* slot = ring_slot<D>(ring, t);
    float p[D];
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = slot[j * kSampleBlock];
    const float e = slot[D * kSampleBlock], a01 = slot[(D + 1) * kSampleBlock];
    // refills the slot read at t - 1, before this wait
    if (t + kStages - 1 < num)
      fetch_streams<D>(ring, mom, epsj, u01, n, t + kStages - 1, c);
    cp_async_commit();
    float lp, ap, h0, h1;
    bool dv;
    transition<D>(q, q + D * D, q + D * D + D, u, p, e, a01, steps, lp, ap,
                  dv, h0, h1);
    const size_t r = static_cast<size_t>(t) * n + c;
#pragma unroll
    for (int j = 0; j < D; ++j) us[r * D + j] = u[j];
    lps[r] = lp;
    aps[r] = ap;
    dvs[r] = dv;
  }
}

// One whole transition of every chain (kernel 8): one thread per chain,
// the same transition<D> as the chunk kernels, and every output the
// reference's single-transition kernel returns.
template <int D>
__global__ void __launch_bounds__(kTransitionBlock)
transition_small_kernel(const float* __restrict__ u0,
                        const float* __restrict__ p0,
                        const float* __restrict__ eps,
                        const float* __restrict__ u01,
                        const float* __restrict__ lam_g,
                        const float* __restrict__ b_g,
                        const float* __restrict__ im_g, int n, int steps,
                        float* __restrict__ u_out, float* __restrict__ p_out,
                        float* __restrict__ lps, float* __restrict__ aps,
                        bool* __restrict__ dvs, float* __restrict__ h0s,
                        float* __restrict__ h1s) {
  const int c = blockIdx.x * kTransitionBlock + threadIdx.x;
  if (c >= n) return;
  const size_t r = static_cast<size_t>(c) * D;
  float q[kQuad<D>], u[D], p[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    u[j] = u0[r + j];
    p[j] = p0[r + j];
  }
  const float e = eps[c], a01 = u01[c];
  load_coefficients<D>(lam_g, b_g, im_g, q);
  float lp, ap, h0, h1;
  bool dv;
  transition<D>(q, q + D * D, q + D * D + D, u, p, e, a01, steps, lp, ap, dv,
                h0, h1);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    u_out[r + j] = u[j];
    p_out[r + j] = p[j];
  }
  lps[c] = lp;
  aps[c] = ap;
  dvs[c] = dv;
  h0s[c] = h0;
  h1s[c] = h1;
}

struct WarmupState {
  DualAveraging da;
  float mean[kMaxDim], m2[kMaxDim], im[kMaxDim];
  float sums[kRedRows];   // this iteration's pooled sums
};

// One chain's streams of warmup iteration t: standard normals z, the step
// size's jitter and the accept uniform.
template <int D>
__device__ __forceinline__ void load_streams(const float* z, const float* jit,
                                             const float* u01, int n, int t,
                                             int c, float (&zc)[D], float& jc,
                                             float& uc01) {
  const size_t r = static_cast<size_t>(t) * n + c;
#pragma unroll
  for (int j = 0; j < D; ++j) zc[j] = z[r * D + j];
  jc = jit[r];
  uc01 = u01[r];
}

// A slow iteration's batch into the window's Chan-Welford moments, after a
// grid.sync(): the pooled squared deviations from partials buffer pbuf
// ([row][ptiles], rows 1 + D .. 2 D), with the batch's mean still in
// st.sums[1 .. D]. The whole block calls it.
template <int D>
__device__ void merge_batch(const float* pbuf, int ptiles, float* red,
                            WarmupState& st, float c_live) {
  pooled_totals(pbuf + (1 + D) * ptiles, D, ptiles, red, kRedRows * kTile,
                st.sums + 1 + D);
  if (threadIdx.x == 0) {
    for (int j = 0; j < D; ++j)
      welford_merge(st.mean[j], st.m2[j], st.sums[1 + j], st.sums[1 + D + j],
                    st.da.nw, c_live);
    st.da.nw = add(st.da.nw, c_live);
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kTile)
warmup_small_kernel(float* __restrict__ u, const float* __restrict__ z,
                    const float* __restrict__ jit,
                    const float* __restrict__ u01,
                    const float* __restrict__ lam_g,
                    const float* __restrict__ b_g, int n, int num, int steps,
                    float eps0, float eps0x10, float target, int nwin,
                    const int* __restrict__ sch, float* __restrict__ part,
                    int ntiles, int ptiles, float* __restrict__ eps_out,
                    float* __restrict__ im_out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float lam[D * D], b[D];
  __shared__ float red[kRedRows * kTile];
  __shared__ WarmupState st;
  const int tid = threadIdx.x;
  for (int i = tid; i < D * D; i += blockDim.x) lam[i] = lam_g[i];
  if (tid < D) b[tid] = b_g[tid];
  if (tid == 0) {
    st.da.init(eps0, eps0x10);
    for (int j = 0; j < D; ++j) {
      st.mean[j] = st.m2[j] = 0.0f;
      st.im[j] = 1.0f;
    }
  }
  const float c_live = static_cast<float>(n);
  const int rows = 1 + 2 * D;
  // One tile a block: each thread keeps its chain's position in registers
  // from one iteration to the next (written to u at the end), and loads the
  // next iteration's streams before the grid.sync(), which hides their
  // latency. Otherwise blocks walk several tiles, each chain's position
  // goes through u, and its streams are loaded where they are used.
  const bool resident = gridDim.x >= ntiles;
  float uc[D], zc[D], jc = 0.0f, uc01 = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) uc[j] = zc[j] = 0.0f;
  const int c_res = blockIdx.x * kTile + tid;
  bool pending = false;   // a merge_batch waits for the next grid.sync()
  if (resident && c_res < n) {
#pragma unroll
    for (int j = 0; j < D; ++j) uc[j] = u[static_cast<size_t>(c_res) * D + j];
    load_streams<D>(z, jit, u01, n, 0, c_res, zc, jc, uc01);
  }
  __syncthreads();

  for (int t = 0; t < num; ++t) {
    bool in_slow, at_end;
    window_flags(sch, nwin, t, in_slow, at_end);
    if (at_end && tid == 0) {
      // slow window ended: the regularized variance becomes the inverse
      // mass, dual averaging restarts around the averaged step size
      for (int j = 0; j < D; ++j) {
        st.im[j] = window_variance(st.m2[j], st.da.nw);
        st.mean[j] = st.m2[j] = 0.0f;
      }
      st.da.restart();
    }
    __syncthreads();
    float* pb = part + static_cast<size_t>(t & 1) * rows * ptiles;
    const int r1 = in_slow ? 1 + D : 1;
    const float eps_t = expf(st.da.log_eps);

    // pass 1: every chain's transition; tile sums of aprob (and of u)
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int c = tile * kTile + tid;
      float ap = 0.0f;
      if (c < n) {
        if (!resident) {
#pragma unroll
          for (int j = 0; j < D; ++j) uc[j] = u[static_cast<size_t>(c) * D + j];
          load_streams<D>(z, jit, u01, n, t, c, zc, jc, uc01);
        }
        float p[D];
#pragma unroll
        for (int j = 0; j < D; ++j) p[j] = mul(zc[j], rsqrtf(st.im[j]));
        float lp, h0, h1;
        bool dv;
        transition<D>(lam, b, st.im, uc, p, mul(eps_t, jc), uc01, steps, lp,
                      ap, dv, h0, h1);
        if (!resident) {
#pragma unroll
          for (int j = 0; j < D; ++j) u[static_cast<size_t>(c) * D + j] = uc[j];
        } else if (t + 1 < num) {
          load_streams<D>(z, jit, u01, n, t + 1, c, zc, jc, uc01);
        }
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) uc[j] = 0.0f;
      }
      red[tid] = ap;
      if (in_slow) {
#pragma unroll
        for (int j = 0; j < D; ++j) red[(1 + j) * kTile + tid] = uc[j];
      }
      __syncthreads();
      warp_rows(red, r1, kTile, pb + tile, ptiles);
    }
    grid.sync();
    if (pending) {
      merge_batch<D>(part + static_cast<size_t>((t - 1) & 1) * rows * ptiles,
                     ptiles, red, st, c_live);
      pending = false;
    }
    pooled_totals(pb, r1, ptiles, red, kRedRows * kTile, st.sums);

    if (tid == 0) {
      st.da.update(quo(st.sums[0], c_live), target);
      for (int j = 0; j < D; ++j) st.sums[1 + j] = quo(st.sums[1 + j], c_live);
    }
    __syncthreads();
    if (!in_slow) continue;

    // pass 2 (slow windows): squared deviations from the batch mean
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int c = tile * kTile + tid;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float sq = 0.0f;
        if (c < n) {
          const float x = resident ? uc[j] : u[static_cast<size_t>(c) * D + j];
          const float dv = sub(x, st.sums[1 + j]);
          sq = mul(dv, dv);
        }
        red[j * kTile + tid] = sq;
      }
      __syncthreads();
      warp_rows(red, D, kTile, pb + (1 + D) * ptiles + tile, ptiles);
    }
    // These partials ride on the next iteration's grid.sync() and are
    // merged right after it, before that iteration's totals overwrite this
    // batch mean. At a window's last iteration (the next one takes the
    // inverse mass from m2) and at the warmup's last, they merge at once.
    bool next_slow, next_end;
    window_flags(sch, nwin, t + 1, next_slow, next_end);
    if (next_end || t + 1 == num) {
      grid.sync();
      merge_batch<D>(pb, ptiles, red, st, c_live);
    } else {
      pending = true;
    }
  }
  if (resident && c_res < n) {
#pragma unroll
    for (int j = 0; j < D; ++j) u[static_cast<size_t>(c_res) * D + j] = uc[j];
  }
  if (blockIdx.x == 0 && tid == 0) {
    *eps_out = expf(st.da.leb);
    for (int j = 0; j < D; ++j) im_out[j] = st.im[j];
  }
}

template <int D>
cudaError_t launch_sample(const float* u0, const float* mom, const float* epsj,
                          const float* u01, const float* lam, const float* b,
                          const float* im, int n, int num, int steps,
                          float* us, float* lps, float* aps, bool* dvs,
                          cudaStream_t stream) {
  const int ring = kStages * (D + 2) * kSampleBlock * sizeof(float);
  if (ring > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_small_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ring);
    if (e != cudaSuccess) return e;
  }
  const int grid = (n + kSampleBlock - 1) / kSampleBlock;
  sample_small_kernel<D><<<grid, kSampleBlock, ring, stream>>>(
      u0, mom, epsj, u01, lam, b, im, n, num, steps, us, lps, aps, dvs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_transition(const float* u, const float* p, const float* eps,
                              const float* u01, const float* lam,
                              const float* b, const float* im, int n,
                              int steps, float* u_out, float* p_out,
                              float* lps, float* aps, bool* dvs, float* h0s,
                              float* h1s, cudaStream_t stream) {
  const int grid = (n + kTransitionBlock - 1) / kTransitionBlock;
  transition_small_kernel<D><<<grid, kTransitionBlock, 0, stream>>>(
      u, p, eps, u01, lam, b, im, n, steps, u_out, p_out, lps, aps, dvs, h0s,
      h1s);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_warmup(float* u, const float* z, const float* jit,
                          const float* u01, const float* lam, const float* b,
                          int n, int num, int steps, float eps0,
                          float eps0x10, float target, int nwin,
                          const int* sch, float* part, float* eps_out,
                          float* im_out, cudaStream_t stream) {
  int ntiles = (n + kTile - 1) / kTile;
  int ptiles = 1;
  while (ptiles < ntiles) ptiles <<= 1;
  if (ntiles > kMaxTiles || nwin > kMaxWindows) return cudaErrorInvalidValue;
  void* args[] = {&u,    &z,    &jit,   &u01,    &lam,     &b,      &n,
                  &num,  &steps, &eps0, &eps0x10, &target, &nwin,   &sch,
                  &part, &ntiles, &ptiles, &eps_out, &im_out};
  return launch_cooperative(warmup_small_kernel<D>, ntiles, kTile, 0, args,
                            stream);
}

}  // namespace

#define MODPPL_DISPATCH_DIM(d, CALL) \
  switch (d) {                       \
    case 1: return CALL(1);          \
    case 2: return CALL(2);          \
    case 3: return CALL(3);          \
    case 4: return CALL(4);          \
    case 5: return CALL(5);          \
    case 6: return CALL(6);          \
    case 7: return CALL(7);          \
    case 8: return CALL(8);          \
    case 9: return CALL(9);          \
    case 10: return CALL(10);        \
    case 11: return CALL(11);        \
    case 12: return CALL(12);        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// u (n, d), mom (num, n, d), epsj and u01 (num, n), Λ (d, d), b and
// inv_mass (d,), all f32 -> us (num, n, d), lps and aps (num, n) f32,
// dvs (num, n) bool
extern "C" int modppl_hmc_sample_small_f32(
    const float* u, const float* mom, const float* epsj, const float* u01,
    const float* lam, const float* b, const float* im, int n, int d, int num,
    int steps, float* us, float* lps, float* aps, bool* dvs,
    cudaStream_t stream) {
#define MODPPL_SAMPLE(D)                                                   \
  static_cast<int>(launch_sample<D>(u, mom, epsj, u01, lam, b, im, n, num, \
                                    steps, us, lps, aps, dvs, stream))
  MODPPL_DISPATCH_DIM(d, MODPPL_SAMPLE)
#undef MODPPL_SAMPLE
}

// us (n, d) f32: the start positions, overwritten with the final ones;
// z (num, n, d), jit and u01 (num, n), Λ (d, d), b (d,) f32; sch int32
// (2, 32): slow-window starts and ends, nwin of them; part f32
// (2, 1 + 2d, ptiles) zeroed scratch -> eps_out (), im_out (d,)
extern "C" int modppl_hmc_warmup_small_f32(
    float* us, const float* z, const float* jit, const float* u01,
    const float* lam, const float* b, int n, int d, int num, int steps,
    float eps0, float eps0x10, float target, int nwin, const int* sch,
    float* part, float* eps_out, float* im_out, cudaStream_t stream) {
#define MODPPL_WARMUP(D)                                                    \
  static_cast<int>(launch_warmup<D>(us, z, jit, u01, lam, b, n, num, steps, \
                                    eps0, eps0x10, target, nwin, sch, part, \
                                    eps_out, im_out, stream))
  MODPPL_DISPATCH_DIM(d, MODPPL_WARMUP)
#undef MODPPL_WARMUP
}

// u, p (n, d), eps and u01 (n,), Λ (d, d), b and inv_mass (d,), all f32,
// d <= 7 -> u_out, p_out (n, d), lps, aps, h0s, h1s (n,) f32, dvs (n,) bool
extern "C" int modppl_hmc_transition_small_f32(
    const float* u, const float* p, const float* eps, const float* u01,
    const float* lam, const float* b, const float* im, int n, int d,
    int steps, float* u_out, float* p_out, float* lps, float* aps, bool* dvs,
    float* h0s, float* h1s, cudaStream_t stream) {
#define MODPPL_TRANSITION(D)                                                \
  static_cast<int>(launch_transition<D>(u, p, eps, u01, lam, b, im, n,      \
                                        steps, u_out, p_out, lps, aps, dvs, \
                                        h0s, h1s, stream))
  switch (d) {
    case 1: return MODPPL_TRANSITION(1);
    case 2: return MODPPL_TRANSITION(2);
    case 3: return MODPPL_TRANSITION(3);
    case 4: return MODPPL_TRANSITION(4);
    case 5: return MODPPL_TRANSITION(5);
    case 6: return MODPPL_TRANSITION(6);
    case 7: return MODPPL_TRANSITION(7);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MODPPL_TRANSITION
}

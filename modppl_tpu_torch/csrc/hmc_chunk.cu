// Whole-phase HMC chunks for quadratic targets at d >= 13: kernels 6 and 7;
// the leapfrog integration alone, at any d to 224: kernel 5. All three run
// one product, block_gradient.
//
// Replaces modppl_tpu/ops/leapfrog_pallas.py:hmc_sample_chunk (Pallas body
// _chunk_kernel_mxu), :hmc_warmup_chunk (Pallas body _warmup_kernel_mxu) and
// :fused_leapfrog (Pallas body _kernel). The target is
// logp(u) = b.u - u.Λu/2, grad g = b - uΛ.
//
// What bounds them on the card: operations. A transition of one chain is
// (L + 1) products of a d-vector with the (d, d) Λ, 2 d^2 flops each; at
// d = 128, N = 4096, L = 32 the sampling phase does ~1.1e12 FP32 flops
// against ~1.1 GB of streams and outputs. The product runs in full FP32 on
// the FFMA pipes. No TF32: the accept ratio is computed from these
// gradients, and the reference pins Precision.HIGHEST for that reason
// (leapfrog_pallas.py:48-55). No 3xTF32 tensor-core split either: it would
// change each gradient entry's add order, and the warmup's dual averaging
// multiplies one rounding-flipped accept decision by sqrt(t)/gamma (the
// d = 13 step size then misses its tolerance by 3e-3). The TPU's
// G = 128/s lane packing, its block-diagonal Λ and the B/Bt/C 0/1 matrices
// are not carried over: a chain owns its row, so nothing needs them.
//
// Kernels 6, 7 and 5 (sample_kernel, warmup_kernel, leapfrog_kernel): one
// CTA of 256 threads per tile of TC chains (64 at d <= 64, 32 to d = 128,
// 16 or 8 above), with Λ (64 KB at d = 128) in dynamic shared memory. The
// columns are split across threads, not the chains: each thread owns a
// 4-chain x 4-coordinate block, and a warp owns all TC chains of
// 32 / (TC / 4) column groups (at TC = 32, 16 columns). The product's
// input is kept k-major in shared memory (uT[k][chain]); per k a thread
// reads one float4 of uT (its 4 chains) and one float4 of Λ's row (its 4
// columns) and does 16 FFMA, so the SM reads Λ once per gradient, not once
// per warp. What is left to
// bound the product is shared memory's return path: on the H100 an
// LDS.128 costs a warp about 2.5 SM cycles when each quarter warp reads at
// most 64 distinct bytes, about 4 when it reads 128 (equal addresses merge
// within a quarter warp only; csrc/probes/lds128.cu), so lanes are laid
// out to keep each quarter warp at 2 chain groups x 4 column groups
// (owner()): per k and warp the product's two loads then hold shared
// memory about 5 SM cycles, against 4 for its 16 FFMA on the SM's four
// schedulers. Each
// thread keeps its block's u, p, g, the start point u0, the start energies
// e0 and logp terms in registers across all L steps, and does the half
// kick, the drift and the half kick in the product's epilogue; it writes
// only the new clamped position into uT, which is double-buffered, so a
// leapfrog step costs one __syncthreads. The per-coordinate (e0 - e1) and
// logp terms are staged in shared memory (over the uT buffers) only at the
// end of a transition, for the per-chain warp_tree_sum. The next
// transition's streams (momenta or standard normals, step sizes or
// jitters, uniforms) are copied into shared memory with cp.async while the
// current transition runs. The warmup pools its tile sums and partials one
// warp a row (warp_rows), and when every block holds one tile its chains
// stay in registers between iterations.
//
// Kernel 5 runs the same leapfrog steps (block_leapfrog) from given momenta
// and step sizes, its block's u, p and g in registers across all L steps,
// and stores u_L and p_L at the end; its product's input is the position
// itself, not clamped (write_input<TC, false>), as the reference kernel's.
// It takes the chunk kernels' tile and carve-up (chunk_floats) and leaves
// their stream and per-chain regions unused.
//
// Per-chain energies follow the reference kernel: elementwise
// e = -u(b+g)/2 + im p^2/2, dH the sum of finite (e0 - e1) terms with any
// non-finite term flagging the chain divergent, logp by the identity
// u.(b+g)/2 (leapfrog_pallas.py:357), and (kernels 6 and 7) the product's
// input clamped to +-1e30. Chains never share a product row, so a
// diverging chain leaves every other chain's results bitwise unchanged.
//
// Arithmetic order, so that the plain versions in ops/leapfrog.py can
// reproduce it bitwise: each gradient entry is one FFMA chain over
// k = 0..d-1 from 0 (the plain version's torch.addcmul chain), never split
// or reordered; every other add, multiply and divide is a round-to-nearest
// intrinsic in the plain version's order; sums over a chain's coordinates
// are the adjacent-pairing tree over the coordinates zero-padded to a power
// of two (warp_tree_sum). Each run repeats bitwise. The warmup pools over
// all chains as hmc_small.cu's does: one cooperative launch, tile partials,
// grid.sync(), the same fixed-order tree in every block, no atomics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hmc_pooled.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace modppl;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// torch.clamp(v, -1e30, 1e30): NaN stays NaN
__device__ __forceinline__ float clip(float v) {
  return v != v ? v : fminf(fmaxf(v, -1e30f), 1e30f);
}

// -logp + kinetic of one coordinate: (-u/2)(b + g) + ((im/2) p) p
__device__ __forceinline__ float energy(float u, float b, float g, float im,
                                        float p) {
  return add(mul(mul(-0.5f, u), add(b, g)), mul(mul(mul(0.5f, im), p), p));
}

// Λ, b (and im, when given) into shared memory, zero-padded to dp; Λ's
// rows ls >= dp floats apart. Each thread has 16 loads of Λ in flight at a
// time: kernel 5's whole launch is only L + 1 products long, so a load a
// round trip would show in it.
template <typename Smem>
__device__ void load_quadratic(const Smem& s, const float* lam,
                               const float* b, const float* im, int d,
                               int dp, int ls) {
  constexpr int kBatch = 16;
  const int m = dp * dp;
  for (int i0 = threadIdx.x; i0 < m; i0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * blockDim.x, k = i / dp, j = i - k * dp;
      v[q] = (i < m && k < d && j < d) ? lam[k * d + j] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * blockDim.x, k = i / dp, j = i - k * dp;
      if (i < m) s.lam[k * ls + j] = v[q];
    }
  }
  for (int j = threadIdx.x; j < dp; j += blockDim.x) {
    s.b[j] = j < d ? b[j] : 0.0f;
    if (im != nullptr) s.im[j] = j < d ? im[j] : 0.0f;
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

// --------------------------------------------------------------------------
// kernels 6 and 7: column-split product, chain state in registers
// --------------------------------------------------------------------------

// Shared-memory carve-up, in floats; ops/leapfrog.py:chunk_smem_bytes
// mirrors its size. Padded coordinates are 0 in Λ, b and im.
struct Chunk {
  float *lam, *ut, *pz, *b, *im, *mean, *m2, *sums;
  float *pjit, *pu01, *u01, *ap, *dv, *lp, *acc;
};

// Floats in a row (one coordinate k) of a uT buffer: TC chains, padded by
// 4 at TC >= 32 so that a quarter warp's stores of 4 rows fall in 2 bank
// groups instead of 1.
__host__ __device__ constexpr int ut_row(int tc) {
  return tc >= 32 ? tc + 4 : tc;
}

// Floats in a row of Λ: a constant at the tiles the wide legs run (TC = 64
// takes d <= 64, TC = 32 d <= 128), so that the unrolled product's loads
// of the next rows take immediate offsets, not an integer multiply each;
// dp at the narrower tiles.
__host__ __device__ constexpr int lam_row(int tc, int dp) {
  return tc == 64 ? 64 : tc == 32 ? 128 : dp;
}

__host__ __device__ inline size_t chunk_floats(int dp, int tc) {
  return static_cast<size_t>(dp) * lam_row(tc, dp) +
         2 * static_cast<size_t>(dp) * ut_row(tc) +
         static_cast<size_t>(tc) * dp + 6 * dp + 4 + 7 * tc;
}

__device__ inline Chunk carve_chunk(float* s, int dp, int tc) {
  Chunk t;
  t.lam = s;
  t.ut = t.lam + dp * lam_row(tc, dp);   // two (dp, ut_row) input buffers
  t.pz = t.ut + 2 * dp * ut_row(tc);   // (tc, dp): next transition's momenta
  t.b = t.pz + tc * dp;
  t.im = t.b + dp;
  t.mean = t.im + dp;
  t.m2 = t.mean + dp;
  t.sums = t.m2 + dp;          // 1 + 2 dp, padded to 2 dp + 4
  t.pjit = t.sums + 2 * dp + 4;
  t.pu01 = t.pjit + tc;        // the next transition's per-chain streams
  t.u01 = t.pu01 + tc;
  t.ap = t.u01 + tc;
  t.dv = t.ap + tc;
  t.lp = t.dv + tc;
  t.acc = t.lp + tc;
  return t;
}

// The 4-chain x 4-coordinate block one thread owns, held in registers
// across a transition: [i][jj] is chain c0 + i, coordinate j0 + jj.
struct Block {
  float u0[4][4], u[4][4], p[4][4], g[4][4], e0[4][4], lpe[4][4];
  float ei[4][4];   // eps * inv_mass
  float he[4];      // eps / 2
  float b[4], im[4];
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One transition's streams of the tile's first `live` chains (row `row` of
// the (T, N) streams) into s.pz, s.pjit and s.pu01, asynchronously;
// coordinates past d and chains past `live` are zero-filled.
template <int TC>
__device__ void prefetch_streams(const Chunk& s, const float* z,
                                 const float* jit, const float* u01,
                                 size_t row, int live, int d, int dp) {
  for (int i = threadIdx.x; i < TC * dp; i += blockDim.x) {
    const int c = i / dp, j = i - c * dp;
    const bool v = c < live && j < d;
    cp_async4(s.pz + i, v ? z + (row + c) * d + j : z, v);
  }
  for (int c = threadIdx.x; c < TC; c += blockDim.x) {
    cp_async4(s.pjit + c, c < live ? jit + row + c : jit, c < live);
    cp_async4(s.pu01 + c, c < live ? u01 + row + c : u01, c < live);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// g = b - x Λ over the thread's block, x the (k-major) product input in
// uT buffer `buf`: each entry one FFMA chain over k = 0..d-1 from 0. Row
// k + 1 is loaded while row k is used; the one row read past the last lies
// inside the carve-up (Λ is followed by uT, each uT buffer by the next
// region). Both operands are addressed from the carve-up's own pointers,
// so that they stay shared-memory loads (LDS), not generic ones.
template <int TC>
__device__ __forceinline__ void block_gradient(const Chunk& s, int buf, int d,
                                               int dp, int cgi, int jg,
                                               Block& r) {
  const float4* l4 = reinterpret_cast<const float4*>(s.lam) + jg;
  constexpr int S = ut_row(TC);
  const float4* x4 =
      reinterpret_cast<const float4*>(s.ut + buf * dp * S) + cgi;
  const int ls = lam_row(TC, dp) / 4;
  constexpr int xs = S / 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
  }
  float4 l = l4[0], x = x4[0];
#pragma unroll 32
  for (int k = 0; k < d; ++k) {
    const float4 ln = l4[(k + 1) * ls], xn = x4[(k + 1) * xs];
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(xv[i], l.x, acc[i][0]);
      acc[i][1] = fmaf(xv[i], l.y, acc[i][1]);
      acc[i][2] = fmaf(xv[i], l.z, acc[i][2]);
      acc[i][3] = fmaf(xv[i], l.w, acc[i][3]);
    }
    l = ln;
    x = xn;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) r.g[i][jj] = sub(r.b[jj], acc[i][jj]);
  }
}

// The product's input, clip(u) of the block (u itself without kClamp),
// into the k-major uT buffer `buf`
template <int TC, bool kClamp>
__device__ __forceinline__ void write_input(const Chunk& s, int buf, int dp,
                                            const float (&u)[4][4], int c0,
                                            int j0) {
  constexpr int S = ut_row(TC);
  float* ut = s.ut + buf * dp * S;
  const auto in = [](float v) { return kClamp ? clip(v) : v; };
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    *reinterpret_cast<float4*>(&ut[(j0 + jj) * S + c0]) = make_float4(
        in(u[0][jj]), in(u[1][jj]), in(u[2][jj]), in(u[3][jj]));
  }
}

// `steps` leapfrog steps of each owner's block from r.u, r.p and their
// gradient r.g, whose input is in uT buffer 0: half kick, drift, gradient,
// half kick, in the reference's order. Step s writes and then reads buffer
// (s + 1) & 1, so a step costs one __syncthreads. The whole block calls it.
template <int TC, bool kClamp>
__device__ __forceinline__ void block_leapfrog(const Chunk& s, Block& r,
                                               int d, int dp, int steps,
                                               bool own, int cgi, int jg) {
  const int c0 = 4 * cgi, j0 = 4 * jg;
  for (int step = 0; step < steps; ++step) {
    const int cur = (step + 1) & 1;
    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          r.p[i][jj] = add(r.p[i][jj], mul(r.he[i], r.g[i][jj]));
          r.u[i][jj] = add(r.u[i][jj], mul(r.ei[i][jj], r.p[i][jj]));
        }
      }
      write_input<TC, kClamp>(s, cur, dp, r.u, c0, j0);
    }
    __syncthreads();
    if (own) {
      block_gradient<TC>(s, cur, d, dp, cgi, jg, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          r.p[i][jj] = add(r.p[i][jj], mul(r.he[i], r.g[i][jj]));
      }
    }
  }
}

// One HMC transition of the tile. In: each owner's r.u0, r.p, r.ei, r.he,
// r.b, r.im; s.u01 per chain. Out: r.u0 the post-accept positions, s.lp /
// s.ap / s.dv the chain's logp, accept probability and divergence. The
// whole block calls it; `own` says whether the thread owns a block.
template <int TC>
__device__ void chunk_transition(const Chunk& s, Block& r, int d, int dp,
                                 int steps, bool own, int cgi, int jg) {
  const int c0 = 4 * cgi, j0 = 4 * jg;
  if (own) write_input<TC, true>(s, 0, dp, r.u0, c0, j0);
  __syncthreads();
  if (own) {
    block_gradient<TC>(s, 0, d, dp, cgi, jg, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        r.u[i][jj] = r.u0[i][jj];
        r.e0[i][jj] = energy(r.u0[i][jj], r.b[jj], r.g[i][jj], r.im[jj],
                             r.p[i][jj]);
        r.lpe[i][jj] = mul(r.u0[i][jj], add(r.b[jj], r.g[i][jj]));
      }
    }
  }
  block_leapfrog<TC, true>(s, r, d, dp, steps, own, cgi, jg);
  // the per-coordinate terms go over the uT buffers, rows of S floats
  const int S = dp + 4;
  float* const st = s.ut;
  __syncthreads();
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ed[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ed[jj] = sub(r.e0[i][jj], energy(r.u[i][jj], r.b[jj], r.g[i][jj],
                                         r.im[jj], r.p[i][jj]));
      *reinterpret_cast<float4*>(&st[(c0 + i) * S + j0]) =
          make_float4(ed[0], ed[1], ed[2], ed[3]);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < TC; c += kWarps) {
    const float* e = st + c * S;
    bool bad = false;
    const float dh = warp_tree_sum(d, [&](int j) {
      const float ed = e[j];
      const bool fin = isfinite(ed);
      bad |= !fin;
      return fin ? ed : 0.0f;
    });
    bad = __any_sync(0xffffffffu, bad);
    const float dh0 = __shfl_sync(0xffffffffu, dh, 0);
    const bool div = bad || !isfinite(dh0) || dh0 < -1000.0f;
    const float ap = div ? 0.0f : fminf(expf(fminf(dh0, 0.0f)), 1.0f);
    if (lane == 0) {
      s.ap[c] = ap;
      s.dv[c] = div ? 1.0f : 0.0f;
      s.acc[c] = s.u01[c] < ap ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool acc = s.acc[c0 + i] != 0.0f;
      float le[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        le[jj] = mul(0.5f, acc ? mul(r.u[i][jj], add(r.b[jj], r.g[i][jj]))
                               : r.lpe[i][jj]);
        if (acc) r.u0[i][jj] = r.u[i][jj];
      }
      *reinterpret_cast<float4*>(&st[(c0 + i) * S + j0]) =
          make_float4(le[0], le[1], le[2], le[3]);
    }
  }
  __syncthreads();
  for (int c = warp; c < TC; c += kWarps) {
    const float* e = st + c * S;
    const float lp = warp_tree_sum(d, [&](int j) {
      const float le = e[j];
      return isfinite(le) ? le : 0.0f;
    });
    if (lane == 0) s.lp[c] = lp;
  }
  __syncthreads();
}

// The thread's block: (chain group, column group) and whether it has one
// (at most 256 blocks of 4x4 a tile: TC dp <= 4096). A warp covers all
// A = TC / 4 chain groups and B = 32 / A column groups; a quarter warp
// (the lanes one LDS.128 wavefront serves) covers a x 8/a of them, so that
// per k it reads 2-4 distinct float4s of uT and of Λ (LDS.128 reaches its
// floor of about 2.5 cycles a warp at 64 bytes a quarter; 128 bytes take
// about 4: csrc/probes/lds128.cu on the H100).
template <int TC>
__device__ __forceinline__ bool owner(int dp, int& cgi, int& jg) {
  constexpr int A = TC / 4, B = 32 / A;
  constexpr int a = A >= 16 ? 4 : 2, b = 8 / a;
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  cgi = (q % (A / a)) * a + r % a;
  jg = (threadIdx.x >> 5) * B + (q / (A / a)) * b + r / a;
  return jg < dp / 4;
}

// The block's 4 x 4 of x (n, d) of the tile at chain cb (0 past the last
// chain and coordinate).
__device__ __forceinline__ void load_block(float (&v)[4][4], const float* x,
                                           int cb, int live, int d, int c0,
                                           int j0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + i, j = j0 + jj;
      v[i][jj] = (c < live && j < d)
                     ? x[static_cast<size_t>(cb + c) * d + j] : 0.0f;
    }
  }
}

// The block's 4 x 4 into x (n, d) of the tile at chain cb.
__device__ __forceinline__ void store_block(const float (&v)[4][4], float* x,
                                            int cb, int live, int d, int c0,
                                            int j0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + i, j = j0 + jj;
      if (c < live && j < d) x[static_cast<size_t>(cb + c) * d + j] = v[i][jj];
    }
  }
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
  const Chunk s = carve_chunk(reinterpret_cast<float*>(smem4), dp, TC);
  const int cb = blockIdx.x * TC, live = min(TC, n - cb);
  prefetch_streams<TC>(s, mom, epsj, u01, cb, live, d, dp);
  load_quadratic(s, lam, b, im, d, dp, lam_row(TC, dp));
  int cgi, jg;
  const bool own = owner<TC>(dp, cgi, jg);
  const int c0 = 4 * cgi, j0 = 4 * jg;
  Block r;
  if (own) load_block(r.u0, u0, cb, live, d, c0, j0);
  __syncthreads();
  if (own) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      r.b[jj] = s.b[j0 + jj];
      r.im[jj] = s.im[j0 + jj];
    }
  }
  for (int t = 0; t < num; ++t) {
    const size_t row = static_cast<size_t>(t) * n + cb;
    cp_async_wait_all();
    __syncthreads();
    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = s.pjit[c0 + i];   // 0 past the last chain
        r.he[i] = mul(0.5f, e);
        const float4 p4 =
            *reinterpret_cast<const float4*>(&s.pz[(c0 + i) * dp + j0]);
        r.p[i][0] = p4.x;
        r.p[i][1] = p4.y;
        r.p[i][2] = p4.z;
        r.p[i][3] = p4.w;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) r.ei[i][jj] = mul(e, r.im[jj]);
      }
    }
    for (int c = threadIdx.x; c < TC; c += blockDim.x)
      s.u01[c] = c < live ? s.pu01[c] : 2.0f;   // a padded chain never moves
    __syncthreads();
    if (t + 1 < num)
      prefetch_streams<TC>(s, mom, epsj, u01, row + n, live, d, dp);
    chunk_transition<TC>(s, r, d, dp, steps, own, cgi, jg);
    if (own) store_block(r.u0, us + row * d, 0, live, d, c0, j0);
    for (int c = threadIdx.x; c < live; c += blockDim.x) {
      lps[row + c] = s.lp[c];
      aps[row + c] = s.ap[c];
      dvs[row + c] = s.dv[c] != 0.0f;
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
  const Chunk s = carve_chunk(reinterpret_cast<float*>(smem4), dp, TC);
  __shared__ DualAveraging da;
  // reduction scratch: the two uT buffers, free between transitions
  float* red = s.ut;
  const int cap = 2 * TC * dp;
  // the first work item's streams: iteration 0, this block's first tile
  prefetch_streams<TC>(s, z, jit, u01, static_cast<size_t>(blockIdx.x) * TC,
                       min(TC, n - static_cast<int>(blockIdx.x) * TC), d, dp);
  load_quadratic(s, lam, b, nullptr, d, dp, lam_row(TC, dp));
  for (int j = threadIdx.x; j < dp; j += blockDim.x) {
    s.im[j] = j < d ? 1.0f : 0.0f;
    s.mean[j] = s.m2[j] = 0.0f;
  }
  if (threadIdx.x == 0) da.init(eps0, eps0x10);
  __syncthreads();
  const float c_live = static_cast<float>(n);
  const int rows = 1 + 2 * d;
  // one tile a block: its positions stay in the owners' registers from one
  // iteration to the next (they are also written to u, for pass 2 and the
  // caller)
  const bool resident = gridDim.x >= ntiles;
  int cgi, jg;
  const bool own = owner<TC>(dp, cgi, jg);
  const int c0 = 4 * cgi, j0 = 4 * jg;
  Block r;
  if (own) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) r.b[jj] = s.b[j0 + jj];
  }

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
      const int cb = tile * TC, live = min(TC, n - cb);
      cp_async_wait_all();
      __syncthreads();
      if (own) {
        if (!resident || t == 0) load_block(r.u0, u, cb, live, d, c0, j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) r.im[jj] = s.im[j0 + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + i;
          const float e = c < live ? mul(eps_t, s.pjit[c]) : 0.0f;
          r.he[i] = mul(0.5f, e);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + jj;
            r.ei[i][jj] = mul(e, r.im[jj]);
            r.p[i][jj] = (c < live && j < d)
                             ? mul(s.pz[c * dp + j], rsqrtf(r.im[jj])) : 0.0f;
          }
        }
      }
      for (int c = threadIdx.x; c < TC; c += blockDim.x)
        s.u01[c] = c < live ? s.pu01[c] : 2.0f;
      __syncthreads();
      // the next work item's streams: the block's next tile, else
      // iteration t + 1's first
      int nt = t, ntile = tile + gridDim.x;
      if (ntile >= ntiles) {
        nt = t + 1;
        ntile = blockIdx.x;
      }
      if (nt < num)
        prefetch_streams<TC>(s, z, jit, u01,
                             static_cast<size_t>(nt) * n + ntile * TC,
                             min(TC, n - ntile * TC), d, dp);
      chunk_transition<TC>(s, r, d, dp, steps, own, cgi, jg);
      // red rows: [0] aprob, [1 + j] coordinate j, each over the TC chains
      if (own) {
        store_block(r.u0, u, cb, live, d, c0, j0);
        if (in_slow) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int c = c0 + i, j = j0 + jj;
              if (j < d) red[(1 + j) * TC + c] = c < live ? r.u0[i][jj] : 0.0f;
            }
          }
        }
      }
      for (int c = threadIdx.x; c < TC; c += blockDim.x)
        red[c] = c < live ? s.ap[c] : 0.0f;
      __syncthreads();
      warp_rows(red, r1, TC, pb + tile, ptiles);
    }
    grid.sync();
    pooled_totals(pb, r1, ptiles, red, cap, s.sums);
    if (threadIdx.x == 0) da.update(quo(s.sums[0], c_live), target);
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      s.sums[1 + j] = quo(s.sums[1 + j], c_live);
    __syncthreads();
    if (!in_slow) continue;

    // pass 2 (slow windows): squared deviations from the batch mean, from
    // the owners' registers when the tile is resident
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int cb = tile * TC;
      if (resident) {
        if (own) {
          const int live = min(TC, n - cb);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int c = c0 + i, j = j0 + jj;
              if (j < d) {
                const float dv = sub(r.u0[i][jj], s.sums[1 + j]);
                red[j * TC + c] = c < live ? mul(dv, dv) : 0.0f;
              }
            }
          }
        }
      } else {
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
      }
      __syncthreads();
      warp_rows(red, d, TC, pb + (1 + d) * ptiles + tile, ptiles);
    }
    grid.sync();
    pooled_totals(pb + (1 + d) * ptiles, d, ptiles, red, cap,
                  s.sums + 1 + d);
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      welford_merge(s.mean[j], s.m2[j], s.sums[1 + j], s.sums[1 + d + j],
                    da.nw, c_live);
    __syncthreads();
    if (threadIdx.x == 0) da.nw = add(da.nw, c_live);
    __syncthreads();
  }
  cp_async_wait_all();
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) *eps_out = expf(da.leb);
    for (int j = threadIdx.x; j < d; j += blockDim.x) im_out[j] = s.im[j];
  }
}

// fused_leapfrog (kernel 5): `steps` leapfrog steps of a tile of TC chains
// from the given momenta and per-chain step sizes, returning (u_L, p_L).
// The product's input is the position itself, not clamped. No energies, no
// accept: those run as plain torch around it, as XLA runs them around the
// reference kernel.
template <int TC>
__global__ void __launch_bounds__(kThreads)
leapfrog_kernel(const float* __restrict__ u0, const float* __restrict__ p0,
                const float* __restrict__ eps, const float* __restrict__ lam,
                const float* __restrict__ b, const float* __restrict__ im,
                int n, int d, int dp, int steps, float* __restrict__ u_out,
                float* __restrict__ p_out) {
  extern __shared__ float4 smem4[];
  const Chunk s = carve_chunk(reinterpret_cast<float*>(smem4), dp, TC);
  const int cb = blockIdx.x * TC, live = min(TC, n - cb);
  int cgi, jg;
  const bool own = owner<TC>(dp, cgi, jg);
  const int c0 = 4 * cgi, j0 = 4 * jg;
  Block r;
  if (own) {
    load_block(r.u, u0, cb, live, d, c0, j0);
    load_block(r.p, p0, cb, live, d, c0, j0);
  }
  load_quadratic(s, lam, b, im, d, dp, lam_row(TC, dp));
  __syncthreads();
  if (own) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      r.b[jj] = s.b[j0 + jj];
      r.im[jj] = s.im[j0 + jj];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = c0 + i < live ? eps[cb + c0 + i] : 0.0f;
      r.he[i] = mul(0.5f, e);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) r.ei[i][jj] = mul(e, r.im[jj]);
    }
    write_input<TC, false>(s, 0, dp, r.u, c0, j0);
  }
  __syncthreads();
  if (own) block_gradient<TC>(s, 0, d, dp, cgi, jg, r);
  block_leapfrog<TC, false>(s, r, d, dp, steps, own, cgi, jg);
  if (own) {
    store_block(r.u, u_out, cb, live, d, c0, j0);
    store_block(r.p, p_out, cb, live, d, c0, j0);
  }
}

// A tile of TC chains fits the block's threads (TC dp / 16 blocks of 4x4)
// and shared memory.
template <int TC>
cudaError_t chunk_smem(int dp, size_t& smem) {
  smem = chunk_floats(dp, TC) * sizeof(float);
  if ((TC / 4) * (dp / 4) > kThreads) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int TC>
cudaError_t launch_sample(const float* u0, const float* mom, const float* epsj,
                          const float* u01, const float* lam, const float* b,
                          const float* im, int n, int d, int num, int steps,
                          float* us, float* lps, float* aps, bool* dvs,
                          cudaStream_t stream) {
  const int dp = (d + 3) / 4 * 4;
  size_t smem;
  cudaError_t e = chunk_smem<TC>(dp, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(sample_kernel<TC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = (n + TC - 1) / TC;
  sample_kernel<TC><<<grid, kThreads, smem, stream>>>(
      u0, mom, epsj, u01, lam, b, im, n, d, dp, num, steps, us, lps, aps, dvs);
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
  if (nwin > kMaxWindows || ptiles > 2 * TC * dp) return cudaErrorInvalidValue;
  size_t smem;
  cudaError_t e = chunk_smem<TC>(dp, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(warmup_kernel<TC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  void* args[] = {&u,      &z,       &jit,    &u01,   &lam,    &b,
                  &n,      &d,       &dp,     &num,   &steps,  &eps0,
                  &eps0x10, &target, &nwin,   &sch,   &part,   &ntiles,
                  &ptiles, &eps_out, &im_out};
  return launch_cooperative(warmup_kernel<TC>, ntiles, kThreads, smem, args,
                            stream);
}

template <int TC>
cudaError_t launch_leapfrog(const float* u, const float* p, const float* eps,
                            const float* lam, const float* b, const float* im,
                            int n, int d, int steps, float* u_out,
                            float* p_out, cudaStream_t stream) {
  const int dp = (d + 3) / 4 * 4;
  size_t smem;
  cudaError_t e = chunk_smem<TC>(dp, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(leapfrog_kernel<TC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = (n + TC - 1) / TC;
  leapfrog_kernel<TC><<<grid, kThreads, smem, stream>>>(
      u, p, eps, lam, b, im, n, d, dp, steps, u_out, p_out);
  return cudaGetLastError();
}

}  // namespace

// chain tiles of kernels 5, 6 and 7 (ops/leapfrog.py:CHUNK_TILES)
#define MODPPL_DISPATCH_CHUNK(tc, CALL) \
  switch (tc) {                         \
    case 64: return CALL(64);           \
    case 32: return CALL(32);           \
    case 16: return CALL(16);           \
    case 8: return CALL(8);             \
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
  MODPPL_DISPATCH_CHUNK(tc, MODPPL_SAMPLE)
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
  MODPPL_DISPATCH_CHUNK(tc, MODPPL_WARMUP)
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
  MODPPL_DISPATCH_CHUNK(tc, MODPPL_LEAPFROG)
#undef MODPPL_LEAPFROG
}

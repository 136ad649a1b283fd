// Floors under kernels 8 and 9 (csrc/hmc_small.cu), built by
// small_cost.py beside this file into libraries of their own, never into
// the kernel library (ops/_build.py builds only csrc/*.cu). It includes
// hmc_small.cu, so each library also holds the kernels themselves, built
// with the chains a block and ring depth that the -D flags give
// (MODPPL_SAMPLE_BLOCK, MODPPL_SAMPLE_STAGES, MODPPL_TRANSITION_BLOCK).
//
// - empty_transition_kernel: kernel 8's grid, block and argument list, and
//   no work: what a launch costs the way hmc_quadratic makes it.
// - chain_floor_kernel: kernel 9's loop with every transition's streams
//   read from one fixed slot (the chain's transition 0, copied into every
//   ring slot once) and its outputs written to one slot: no DRAM traffic
//   inside the loop, so its time is the dependent chain of T transitions.
#include "../hmc_small.cu"

namespace {

__global__ void __launch_bounds__(kTransitionBlock)
empty_transition_kernel(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, int, int, float*, float*, float*,
                        float*, bool*, float*, float*) {}

template <int D>
__global__ void __launch_bounds__(kSampleBlock)
chain_floor_kernel(const float* __restrict__ u0, const float* __restrict__ mom,
                   const float* __restrict__ epsj,
                   const float* __restrict__ u01,
                   const float* __restrict__ lam_g,
                   const float* __restrict__ b_g,
                   const float* __restrict__ im_g, int n, int num, int steps,
                   float* __restrict__ us, float* __restrict__ lps,
                   float* __restrict__ aps, bool* __restrict__ dvs) {
  extern __shared__ float ring[];
  float q[kQuad<D>];
  load_coefficients<D>(lam_g, b_g, im_g, q);
  const int c = blockIdx.x * kSampleBlock + threadIdx.x;
  if (c >= n) return;
  for (int s = 0; s < kStages; ++s) {
    float* slot = ring_slot<D>(ring, s);
#pragma unroll
    for (int j = 0; j < D; ++j)
      slot[j * kSampleBlock] = mom[static_cast<size_t>(c) * D + j];
    slot[D * kSampleBlock] = epsj[c];
    slot[(D + 1) * kSampleBlock] = u01[c];
  }
  float u[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = u0[static_cast<size_t>(c) * D + j];
  for (int t = 0; t < num; ++t) {
    const float* slot = ring_slot<D>(ring, t);
    float p[D];
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = slot[j * kSampleBlock];
    float lp, ap, h0, h1;
    bool dv;
    transition<D>(q, q + D * D, q + D * D + D, u, p, slot[D * kSampleBlock],
                  slot[(D + 1) * kSampleBlock], steps, lp, ap, dv, h0, h1);
#pragma unroll
    for (int j = 0; j < D; ++j) us[static_cast<size_t>(c) * D + j] = u[j];
    lps[c] = lp;
    aps[c] = ap;
    dvs[c] = dv;
  }
}

}  // namespace

// modppl_hmc_transition_small_f32's arguments; launches the empty kernel
extern "C" int probe_empty_transition(
    const float* u, const float* p, const float* eps, const float* u01,
    const float* lam, const float* b, const float* im, int n, int d,
    int steps, float* u_out, float* p_out, float* lps, float* aps, bool* dvs,
    float* h0s, float* h1s, cudaStream_t stream) {
  (void)d;
  const int grid = (n + kTransitionBlock - 1) / kTransitionBlock;
  empty_transition_kernel<<<grid, kTransitionBlock, 0, stream>>>(
      u, p, eps, u01, lam, b, im, n, steps, u_out, p_out, lps, aps, dvs, h0s,
      h1s);
  return static_cast<int>(cudaGetLastError());
}

// modppl_hmc_sample_small_f32's arguments at d = 3 (the hierarchical
// leg's); only transition 0's streams are read, only row 0 of the outputs
// written
extern "C" int probe_chain_floor(const float* u, const float* mom,
                                 const float* epsj, const float* u01,
                                 const float* lam, const float* b,
                                 const float* im, int n, int d, int num,
                                 int steps, float* us, float* lps, float* aps,
                                 bool* dvs, cudaStream_t stream) {
  if (d != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int ring = kStages * (3 + 2) * kSampleBlock * sizeof(float);
  const int grid = (n + kSampleBlock - 1) / kSampleBlock;
  chain_floor_kernel<3><<<grid, kSampleBlock, ring, stream>>>(
      u, mom, epsj, u01, lam, b, im, n, num, steps, us, lps, aps, dvs);
  return static_cast<int>(cudaGetLastError());
}

// What one grid.sync() costs a cooperative launch, by the number of
// 256-thread blocks: a floor under each iteration of the whole-warmup
// kernels (csrc/hmc_small.cu, csrc/hmc_chunk.cu), which meet at a
// grid.sync() once or twice an iteration. Not part of the kernel library
// (ops/_build.py builds only csrc/*.cu).
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//       -o grid_sync modppl_tpu_torch/csrc/probes/grid_sync.cu && ./grid_sync
//
// Each launch runs n grid.sync() and nothing else. One sync costs
// (t(1001) - t(1)) / 1000, each t the median of 5 launches timed by CUDA
// events.
#include <algorithm>
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void syncs(int n, int* out) {
  cg::grid_group g = cg::this_grid();
  int k = 0;
  for (int i = 0; i < n; ++i) {
    g.sync();
    ++k;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = k;
}

static float launch_ms(int blocks, int n, int* out) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  void* args[] = {&n, &out};
  float ms[5];
  for (int r = -1; r < 5; ++r) {   // r = -1: warm-up
    cudaEventRecord(a);
    cudaLaunchCooperativeKernel(reinterpret_cast<void*>(syncs), blocks, 256,
                                args, 0, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    if (r >= 0) cudaEventElapsedTime(&ms[r], a, b);
  }
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  std::sort(ms, ms + 5);
  return ms[2];
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, syncs, 256, 0);
  int* out;
  cudaMalloc(&out, sizeof(int));
  std::printf("# %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  for (int blocks : {40, 132, 264, 391}) {
    if (blocks > per_sm * prop.multiProcessorCount) continue;
    const float t1 = launch_ms(blocks, 1, out);
    const float t2 = launch_ms(blocks, 1001, out);
    std::printf("grid.sync %d blocks x 256: %.3f us a sync\n", blocks,
                (t2 - t1) / 1000.0f * 1e3f);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    std::printf("error: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}

// What one warp's LDS.128 (a float4 load from shared memory) costs the SM,
// by how many distinct float4s each quarter warp reads: the measurement
// behind the lane layout of kernels 6 and 7 (csrc/hmc_chunk.cu, owner()).
// Not part of the kernel library (ops/_build.py builds only csrc/*.cu).
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//       -o lds128 modppl_tpu_torch/csrc/probes/lds128.cu && ./lds128
//
// One block per SM, 8 or 32 warps each; every warp issues 16 dependent-free
// LDS.128 per iteration. Prints SM cycles per warp-instruction (elapsed
// time x clock rate / instructions per SM) for each lane pattern.
#include <cstdio>
#include <cuda_runtime.h>

// lane -> float4 index within a 32-float4 window
template <int PAT>
__device__ __forceinline__ int pattern(int lane) {
  switch (PAT) {
    case 0: return 0;                 // one address for the whole warp
    case 1: return lane >> 3;         // one per quarter warp, 4 per warp
    case 2: return lane & 1;          // 2 per quarter, the same in each
    case 3: return (lane & 7) >> 1;   // 4 per quarter, the same in each
    case 4: return lane & 7;          // 8 per quarter, the same in each
    default: return lane;             // 32 distinct
  }
}

template <int PAT>
__global__ void lds(float* out, int iters) {
  extern __shared__ float4 sm4[];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    sm4[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  int idx = pattern<PAT>(threadIdx.x & 31);
  float4 a = make_float4(0, 0, 0, 0);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 v = sm4[(idx + r * 32) & 4095];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    idx = (idx + static_cast<int>(a.x * 0.0f)) & 4095;   // keeps the loads
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a.x + a.y + a.z + a.w;
}

template <int PAT>
double cycles(float* out, int sms, int warps, int iters, double ghz) {
  const int threads = 32 * warps;
  cudaFuncSetAttribute(lds<PAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       65536);
  lds<PAT><<<sms, threads, 65536>>>(out, iters);   // warm-up
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  lds<PAT><<<sms, threads, 65536>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  if (cudaGetLastError() != cudaSuccess) return -1.0;
  return ms * 1e-3 * ghz * 1e9 / (16.0 * iters * warps);
}

int main() {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const double ghz = khz * 1e-6;
  float* out = nullptr;
  if (cudaMalloc(&out, 1 << 24) != cudaSuccess) return 1;
  printf("%s, %d SMs, clock %.3f GHz: SM cycles per warp LDS.128\n",
         prop.name, sms, ghz);
  printf("warps/SM  1-per-warp  1-per-quarter  2-per-quarter  4-per-quarter"
         "  8-per-quarter  32-distinct\n");
  const int iters = 100000;
  for (int warps : {8, 32}) {
    printf("%8d  %10.3f  %13.3f  %13.3f  %13.3f  %13.3f  %11.3f\n", warps,
           cycles<0>(out, sms, warps, iters, ghz),
           cycles<1>(out, sms, warps, iters, ghz),
           cycles<2>(out, sms, warps, iters, ghz),
           cycles<3>(out, sms, warps, iters, ghz),
           cycles<4>(out, sms, warps, iters, ghz),
           cycles<5>(out, sms, warps, iters, ghz));
  }
  cudaFree(out);
  return 0;
}

// Error strings for the CUDA error codes the kernel entries return.
#include <cuda_runtime.h>

extern "C" const char* modppl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Helpers shared by the kernel wrappers of libarrow_tpu_torch.
#include <cuda_runtime.h>

extern "C" const char* arrow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

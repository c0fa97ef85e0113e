// Error text for the status codes the kernel entries return.
#include <cuda_runtime.h>

extern "C" const char* kaolin_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

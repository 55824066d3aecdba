// Shared C entry point of the kernel library: the text of a CUDA error code,
// for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

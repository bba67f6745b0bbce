// Host helpers of the kernel library: the CUDA runtime's message for an
// error code that an entry point returned (ops/build.py check).
#include <cuda_runtime.h>

extern "C" const char* ev_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

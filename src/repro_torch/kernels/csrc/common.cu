// Error-string export for the ctypes wrappers (kernels/cuda_lib.py).
#include "common.cuh"

ADAPARSE_EXPORT const char* adaparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

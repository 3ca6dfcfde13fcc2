// Error-string export for the ctypes wrappers (kernels/cuda_lib.py), and
// a kernel that does nothing: its device time at a kernel's grid is the
// floor under that kernel's time (chip_smoke.py reports it beside the
// small kernels; no path launches it).
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

ADAPARSE_EXPORT const char* adaparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// blocks x threads of empty_kernel on `stream`. Returns cudaGetLastError().
ADAPARSE_EXPORT int adaparse_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

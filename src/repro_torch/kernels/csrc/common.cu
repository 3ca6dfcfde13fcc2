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

// blocks x threads of empty_kernel on `stream`, as a cooperative launch
// when `cooperative` is not 0. Returns the launch's error.
ADAPARSE_EXPORT int adaparse_empty(int blocks, int threads, int cooperative,
                                   void* stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative != 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Block-level helpers shared by the port's hand-written kernels.
//
// Every kernel of the port is exported through a plain C function that
// launches on the caller's stream and returns cudaGetLastError(), so the
// Python wrapper (kernels/cuda_lib.py, ctypes) can raise on a refused
// launch. Blocks are 1-D with blockDim.x a multiple of 32, at most 1024.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ADAPARSE_EXPORT extern "C" __attribute__((visibility("default")))

namespace adaparse {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// Sum of `v` over the block; every thread receives the total.
// `scratch` holds at least 32 ints of shared memory. Contains
// __syncthreads(): all threads of the block must call it.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  v = warp_sum(v);
  __syncthreads();                       // scratch may be in use by a prior call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int t = (threadIdx.x < n_warps) ? scratch[threadIdx.x] : 0;
  if (warp == 0) {
    t = warp_sum(t);
    if (lane == 0) scratch[0] = t;
  }
  __syncthreads();
  return scratch[0];
}

// Exclusive prefix sum of `v` in thread order over the block; `*total`
// receives the block sum. `scratch` holds at least 33 ints of shared
// memory. Contains __syncthreads(): all threads must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  int incl = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    int up = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += up;
  }
  __syncthreads();
  if (lane == kWarp - 1) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = (lane < n_warps) ? scratch[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      int up = __shfl_up_sync(kFullMask, wi, o);
      if (lane >= o) wi += up;
    }
    scratch[lane] = wi - w;              // exclusive warp offsets
    if (lane == kWarp - 1) scratch[kWarp] = wi;
  }
  __syncthreads();
  *total = scratch[kWarp];
  return scratch[warp] + incl - v;
}

// A float32 subnormal (|x| < 2^-126) as a zero of its sign; every other
// value unchanged. Comparing flushed values compares as XLA does (it
// flushes subnormals in float compares). Explicit, so the library needs
// no -ftz flag, which would change every kernel's arithmetic.
__device__ __forceinline__ float flush_subnormal(float x) {
  const unsigned bits = __float_as_uint(x);
  return (bits & 0x7f800000u) ? x : __uint_as_float(bits & 0x80000000u);
}

// ------------------------------------------------ asynchronous copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N-byte asynchronous copy (N = 4, 8 or 16) from global memory to the
// shared address `dst`; bytes past `src_bytes` (0..N) are zeroed. Both
// addresses are N-byte aligned. 16-byte copies bypass L1 (.cg).
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes = N) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 B");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most `Pending` of this thread's committed groups are
// still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

}  // namespace adaparse

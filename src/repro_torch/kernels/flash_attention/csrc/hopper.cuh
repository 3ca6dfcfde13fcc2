// Hopper building blocks of the tensor-core flash-attention body: wgmma
// shared-memory descriptors for tiles kept as 8 x 8 core matrices
// without swizzle, and the two m64n64k16 bf16 wgmma forms the kernel
// issues (A and B from shared memory; A from registers with B
// transposed). sm_90a only. The cp.async copies are in common.cuh.
//
// Tile layout. A tile of R rows x DP bf16 columns is stored as core
// matrices of 8 rows x 8 columns (8 rows of 16 bytes, 128 contiguous
// bytes); core matrix (row group g, column chunk c) starts at byte
// (g * DP / 8 + c) * 128. Two core matrices adjacent along the columns
// are 128 bytes apart and two adjacent along the rows DP * 16 bytes
// apart. A K-major operand (Q, and K for Q K^T) reads the columns as its
// k dimension; V for P V is read MN-major (trans-b): its rows are k.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "../../csrc/common.cuh"

namespace adaparse {
namespace hopper {

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices adjacent along k) and stride byte
// offset (between core matrices adjacent along m or n), all >> 4.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ADAPARSE_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define ADAPARSE_D32_OPS(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64, float32) (+)= A (64 x 16, K-major) * B (16 x 64, stored
// n x k, K-major), both from shared memory. scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ADAPARSE_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ADAPARSE_D32_OPS(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, float32) += A (64 x 16 from registers, the mma.sync A
// fragment of each warp's 16 rows) * B (16 x 64, stored k x n, read
// MN-major through trans-b) from shared memory.
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ADAPARSE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ADAPARSE_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ADAPARSE_D32
#undef ADAPARSE_D32_OPS

// 2^x with the SFU's ex2 (relative error ~2^-22; flushes denormal
// results to zero, and 2^-huge to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace hopper
}  // namespace adaparse

// alpha-budget select-and-compact: keep every row scoring above tau, let
// ties at tau fill the remaining slots in row order, and gather the kept
// token rows into a dense (capacity, D) buffer.
//
// Replaces: src/repro/kernels/budget_route/kernel.py :: budget_route_kernel
// (body _route_kernel), the Pallas TPU kernel behind ops.budget_route.
//
// Bound on the H100: bytes. The scores (N floats) are read twice (once per
// pass) and only the kept rows' tokens are moved: capacity * D * 4 bytes
// read and written (12 x 512 int32 on the main path, 3276 x 512 at
// route_64k). The work is latency- and launch-bound at the main-path N of
// 256; the design keeps the data passes coalesced and moves each kept row
// with one warp of 16-byte loads.
//
// Design. The TPU grid runs in order and carries the running output
// offset and tie count in SMEM from block to block; Hopper blocks run in
// no order, so the selection takes two launches on the caller's stream:
//   1. route_count: per block of kBlock rows, the counts of score > tau
//      and score == tau.
//   2. route_compact: each block sums the counts of the blocks before it
//      (and of all blocks, for the tie budget tie_cap = capacity - #gt),
//      block-scans its rows for tie ranks and output positions, and
//      copies each kept row. Block 0 writes count and the -1 tail of idx.
// Selection rule (shared with ref.py and scheduler.plan_batch): a row is
// kept iff score > tau, or score == tau and its tie rank < tie_cap, and
// its output position < capacity. Both compares take score and tau with
// subnormals flushed to zero, as XLA's compare does (the JAX package's
// route keeps both rows of [0.0, 1e-38] as ties at a tau of 1e-38).
#include <stdint.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kBlock = 1024;

__global__ void __launch_bounds__(kBlock)
route_count(const float* __restrict__ scores, const float* __restrict__ tau_p,
            int n, int* __restrict__ counts) {
  __shared__ int scratch[adaparse::kWarp + 1];
  const float tau = adaparse::flush_subnormal(*tau_p);
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const float s = r < n ? adaparse::flush_subnormal(scores[r]) : 0.0f;
  const int gt = adaparse::block_sum(r < n && s > tau, scratch);
  const int eq = adaparse::block_sum(r < n && s == tau, scratch);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = gt;
    counts[2 * blockIdx.x + 1] = eq;
  }
}

__global__ void __launch_bounds__(kBlock)
route_compact(const float* __restrict__ scores, const float* __restrict__ tau_p,
              const char* __restrict__ tokens, int n, int row_bytes,
              int capacity, int vec16, const int* __restrict__ counts,
              char* __restrict__ out, int* __restrict__ idx,
              int* __restrict__ count) {
  __shared__ int scratch[adaparse::kWarp + 1];
  __shared__ int kept_rows[kBlock];
  __shared__ int kept_pos[kBlock];
  const float tau = adaparse::flush_subnormal(*tau_p);
  const int b = blockIdx.x;

  // totals over all blocks and over the blocks before this one
  int gt_all = 0, eq_all = 0, gt_before = 0, eq_before = 0;
  for (int j = threadIdx.x; j < gridDim.x; j += blockDim.x) {
    const int g = counts[2 * j], e = counts[2 * j + 1];
    gt_all += g;
    eq_all += e;
    if (j < b) {
      gt_before += g;
      eq_before += e;
    }
  }
  gt_all = adaparse::block_sum(gt_all, scratch);
  eq_all = adaparse::block_sum(eq_all, scratch);
  gt_before = adaparse::block_sum(gt_before, scratch);
  eq_before = adaparse::block_sum(eq_before, scratch);
  const int tie_cap = capacity - gt_all;
  // ties kept before this block: the first tie_cap ties in row order
  const int ties_kept_before = max(0, min(eq_before, tie_cap));
  const int kept_before = gt_before + ties_kept_before;

  const int r = b * kBlock + threadIdx.x;
  const float s = r < n ? adaparse::flush_subnormal(scores[r]) : 0.0f;
  const int gt = r < n && s > tau;
  const int eq = r < n && s == tau;
  int eq_total;
  const int tie_rank = eq_before + adaparse::block_exclusive_scan(eq, scratch, &eq_total);
  const int keep = gt || (eq && tie_rank < tie_cap);
  int kept_in_block;
  const int pos = kept_before + adaparse::block_exclusive_scan(keep, scratch, &kept_in_block);
  const int write = keep && pos < capacity;

  // compact this block's written rows into a list (positions are
  // increasing in thread order, so slot = pos - kept_before)
  if (write) {
    kept_rows[pos - kept_before] = r;
    kept_pos[pos - kept_before] = pos;
    idx[pos] = r;
  }
  const int n_write = max(0, min(kept_in_block, capacity - kept_before));
  __syncthreads();

  // one warp per kept row: 16-byte loads when the rows allow it
  const int lane = threadIdx.x % adaparse::kWarp;
  const int warp = threadIdx.x / adaparse::kWarp;
  const int n_warps = blockDim.x / adaparse::kWarp;
  for (int k = warp; k < n_write; k += n_warps) {
    const char* src = tokens + static_cast<size_t>(kept_rows[k]) * row_bytes;
    char* dst = out + static_cast<size_t>(kept_pos[k]) * row_bytes;
    if (vec16) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (int w = lane; w < row_bytes / 16; w += adaparse::kWarp) d4[w] = s4[w];
    } else {
      const int* s1 = reinterpret_cast<const int*>(src);
      int* d1 = reinterpret_cast<int*>(dst);
      for (int w = lane; w < row_bytes / 4; w += adaparse::kWarp) d1[w] = s1[w];
    }
  }

  if (b == 0) {
    const int total = gt_all + max(0, min(eq_all, tie_cap));
    const int c = min(total, capacity);
    if (threadIdx.x == 0) *count = c;
    for (int j = c + threadIdx.x; j < capacity; j += blockDim.x) idx[j] = -1;
  }
}

}  // namespace

// scores (n,) float32; tau (1,) float32 on the device; tokens (n, D) of a
// 4-byte element type, row_bytes = 4 * D; counts (2 * ceil(n / 1024),)
// int32 scratch; out (capacity, D); idx (capacity,) int32; count (1,)
// int32. vec16 = rows and base pointers are 16-byte aligned. Unused out
// rows are left as the caller allocated them. Returns cudaGetLastError().
ADAPARSE_EXPORT int adaparse_budget_route(const void* scores, const void* tau,
                                          const void* tokens, int n,
                                          int row_bytes, int capacity,
                                          int vec16, void* counts, void* out,
                                          void* idx, void* count,
                                          void* stream) {
  const int n_blocks = (n + kBlock - 1) / kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  route_count<<<n_blocks, kBlock, 0, st>>>(
      static_cast<const float*>(scores), static_cast<const float*>(tau), n,
      static_cast<int*>(counts));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  route_compact<<<n_blocks, kBlock, 0, st>>>(
      static_cast<const float*>(scores), static_cast<const float*>(tau),
      static_cast<const char*>(tokens), n, row_bytes, capacity, vec16,
      static_cast<const int*>(counts), static_cast<char*>(out),
      static_cast<int*>(idx), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// alpha-budget select-and-compact in one launch: keep every row scoring
// above tau, let ties at tau fill the remaining slots in row order,
// gather the kept token rows into a dense (capacity, D) buffer, and write
// the unused rows (zeros), the unused idx slots (-1) and the count.
//
// Replaces: src/repro/kernels/budget_route/kernel.py :: budget_route_kernel
// (body _route_kernel), the Pallas TPU kernel behind ops.budget_route.
//
// Bound on the H100: bytes. The scores (N floats) are read once and the
// kept rows' tokens read and written once: capacity * D * 4 bytes each
// way (12 x 512 int32 on the main path, 3276 x 512 at route_64k). At the
// main path's N of 256 the time is the launch and two memory round trips.
//
// Selection (shared with ref.py and scheduler.plan_batch). With
// gt_before(r) and eq_before(r) the rows before r scoring above and at
// tau, and tie_cap = capacity - #{score > tau}, row r is kept iff
// score > tau, or score == tau and eq_before(r) < tie_cap; its output
// position is gt_before(r) + max(0, min(eq_before(r), tie_cap)), and it
// is written iff that is below capacity. So one prefix count of the
// (gt, eq) pair decides every row: there is no scan of the keep mask.
// Both compares take score and tau with subnormals flushed to zero, as
// XLA's compare does (the JAX package keeps both rows of [0.0, 1e-38] as
// ties at a tau of 1e-38).
//
// Design. A thread holds R consecutive rows (R = 4 read as one float4
// when aligned). A warp's prefix counts come from __ballot_sync of
// score > tau and score == tau with __popc over the lanes below; only the
// per-warp totals go through shared memory, so a block's selection costs
// one barrier and its compaction list a second. Up to 1024 rows run in
// one block of ceil(N/32)*32 threads (R = 1), up to 4096 in one block
// with R = 4. Beyond that the TPU grid's running offset, carried from
// block to block, becomes one cooperative launch of at most one block an
// SM, every block resident at once: 128 threads, four rows a thread, and
// several chunks of 512 rows a block when N needs them. The tie budget
// needs the count over all rows
// before any block can place a row, so each block counts its rows,
// writes its (gt, eq) pair to a scratch of two ints a block, and after
// one grid-wide barrier (cooperative_groups::this_grid().sync()) reads
// every block's pair from L2: the sums before it and over the grid. Kept
// rows go to a shared list in output order and the whole block copies
// them, neighbouring threads on neighbouring 16 bytes of a row, with up
// to eight 16-byte loads a thread in flight (4-byte ones when a row or
// base pointer is not 16-byte aligned). The blocks then share out the
// zero rows past the count and the -1 tail of idx, so the wrapper
// allocates every output with torch.empty. Candidates timed against the
// cooperative grid on an H100 (PERF.md): thread block clusters swapping
// counts through distributed shared memory, with or without every
// cluster re-counting the rows outside it.
#include <cooperative_groups.h>
#include <stdint.h>

#include "../../csrc/common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmallThreads = 256;  // a block this small has registers to spare

// (gt, eq) counts of at most 4096 rows in one int: gt in the low 16
// bits, eq in the high 16; sums of packed counts stay packed.
__device__ __forceinline__ int pack(int gt, int eq) { return gt | (eq << 16); }
__device__ __forceinline__ int gt_of(int p) { return p & 0xffff; }
__device__ __forceinline__ int eq_of(int p) { return p >> 16; }

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Score of row r, or NaN past the end (NaN compares false both ways).
__device__ __forceinline__ float score_at(const float* scores, long long r,
                                          int n) {
  return r < n ? scores[r] : nan_f();
}

// This thread's R rows from row `first` (NaN past n): the bits of
// score > tau and score == tau, bit j for row first + j.
template <int R>
__device__ __forceinline__ void row_bits(const float* scores, long long first,
                                         int n, bool aligned, float tau,
                                         unsigned& gbits, unsigned& ebits) {
  float s[R];
  bool loaded = false;
  if constexpr (R == 4) {
    if (aligned && first + 3 < n) {
      const float4 v = *reinterpret_cast<const float4*>(scores + first);
      s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int j = 0; j < R; ++j) s[j] = score_at(scores, first + j, n);
  }
  gbits = ebits = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float x = adaparse::flush_subnormal(s[j]);
    gbits |= static_cast<unsigned>(x > tau) << j;
    ebits |= static_cast<unsigned>(x == tau) << j;
  }
}

// kept[0 .. n_write) source rows to output rows first_pos + k, by the
// whole block: thread t moves elements t, t + T, ... of the rows laid end
// to end (neighbouring threads on neighbouring 16 bytes of a row), kBatch
// loads issued before their stores. The row and element of a thread's
// next element follow by adding T's quotient and remainder by the row
// length, so the loop divides once.
template <typename V, int kBatch>
__device__ __forceinline__ void copy_rows(const char* __restrict__ tokens,
                                          char* __restrict__ out,
                                          size_t row_bytes, const int* kept,
                                          int first_pos, int n_write) {
  const int per_row = static_cast<int>(row_bytes / sizeof(V));
  if (per_row == 0) return;
  const int threads = blockDim.x;
  const long long total = static_cast<long long>(n_write) * per_row;
  const int dk = threads / per_row, dw = threads % per_row;
  int k = threadIdx.x / per_row, w = threadIdx.x % per_row;
  for (long long i = threadIdx.x; i < total; i += kBatch * threads) {
    V a[kBatch];
    int ks[kBatch], ws[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      ks[b] = k;
      ws[b] = w;
      if (i + static_cast<long long>(b) * threads < total)
        a[b] = reinterpret_cast<const V*>(
            tokens + static_cast<size_t>(kept[k]) * row_bytes)[w];
      k += dk;
      w += dw;
      if (w >= per_row) {
        w -= per_row;
        ++k;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i + static_cast<long long>(b) * threads < total)
        reinterpret_cast<V*>(
            out + static_cast<size_t>(first_pos + ks[b]) * row_bytes)[ws[b]] = a[b];
  }
}

// Output rows [from, to) set to zero, one warp of the grid a row.
template <typename V>
__device__ __forceinline__ void zero_rows(char* __restrict__ out,
                                          size_t row_bytes, int from, int to) {
  const int lane = threadIdx.x % adaparse::kWarp;
  const int n_warps = blockDim.x / adaparse::kWarp;
  const int per_row = static_cast<int>(row_bytes / sizeof(V));
  const V z{};
  for (long long k = from + static_cast<long long>(blockIdx.x) * n_warps +
                     threadIdx.x / adaparse::kWarp;
       k < to; k += static_cast<long long>(gridDim.x) * n_warps) {
    V* d = reinterpret_cast<V*>(out + static_cast<size_t>(k) * row_bytes);
    for (int w = lane; w < per_row; w += adaparse::kWarp) d[w] = z;
  }
}

// R rows a thread, at most kThreads threads a block; `chunks` chunks of
// blockDim.x * R rows a block.
template <int R, int kThreads>
__global__ void __launch_bounds__(kThreads)
route_kernel(const float* __restrict__ scores, const float* __restrict__ tau_p,
             const char* __restrict__ tokens, int n, int row_bytes,
             int capacity, int vec16, char* __restrict__ out,
             int* __restrict__ idx, int* __restrict__ count,
             int* __restrict__ scratch, int chunks) {
  constexpr int kWarps = kThreads / adaparse::kWarp;
  // 16-byte loads in flight a thread: eight where registers allow
  constexpr int kBatch = kThreads <= kSmallThreads ? 8 : 4;
  __shared__ int warp_own[kWarps];           // packed (gt, eq) a warp
  __shared__ int warp_sum[2][kWarps];        // the block's counts, a warp
  __shared__ int kept[R * kThreads];         // source rows, output order

  constexpr unsigned kFull = adaparse::kFullMask;
  const int t = threadIdx.x;
  const int lane = t % adaparse::kWarp, warp = t / adaparse::kWarp;
  const int n_warps = blockDim.x / adaparse::kWarp;
  const unsigned below = (1u << lane) - 1u;
  const bool aligned = reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  const bool multi = gridDim.x > 1;
  const float tau = adaparse::flush_subnormal(*tau_p);
  const long long chunk = static_cast<long long>(blockDim.x) * R;
  const long long first = blockIdx.x * chunk * chunks;

  unsigned gbits, ebits;                     // the first chunk's rows
  row_bits<R>(scores, first + static_cast<long long>(t) * R, n, aligned, tau,
              gbits, ebits);

  // 1. a grid: this block's counts to the scratch, one grid-wide barrier,
  // then every block's counts: the sums before this block and overall
  int gt_before = 0, eq_before = 0, gt_all = 0, eq_all = 0;
  if (multi) {
    int g = __popc(gbits), e = __popc(ebits);
    for (int c = 1; c < chunks; ++c) {
      unsigned gb, eb;
      row_bits<R>(scores, first + c * chunk + static_cast<long long>(t) * R,
                  n, aligned, tau, gb, eb);
      g += __popc(gb);
      e += __popc(eb);
    }
    g = __reduce_add_sync(kFull, g);
    e = __reduce_add_sync(kFull, e);
    if (lane == 0) {
      warp_sum[0][warp] = g;
      warp_sum[1][warp] = e;
    }
    __syncthreads();
    if (warp == 0) {
      g = __reduce_add_sync(kFull, lane < n_warps ? warp_sum[0][lane] : 0);
      e = __reduce_add_sync(kFull, lane < n_warps ? warp_sum[1][lane] : 0);
      if (lane == 0) {
        scratch[2 * blockIdx.x] = g;
        scratch[2 * blockIdx.x + 1] = e;
      }
    }
    cg::this_grid().sync();
    int gb = 0, eb = 0, ga = 0, ea = 0;
    for (int j = lane; j < static_cast<int>(gridDim.x); j += adaparse::kWarp) {
      const int gj = __ldcg(scratch + 2 * j), ej = __ldcg(scratch + 2 * j + 1);
      ga += gj;
      ea += ej;
      if (j < static_cast<int>(blockIdx.x)) {
        gb += gj;
        eb += ej;
      }
    }
    gt_before = __reduce_add_sync(kFull, gb);
    eq_before = __reduce_add_sync(kFull, eb);
    gt_all = __reduce_add_sync(kFull, ga);
    eq_all = __reduce_add_sync(kFull, ea);
  }

  // 2. chunk by chunk: the warps' prefix counts by ballots, the block's
  // by one barrier; output positions; kept rows to idx and to the list,
  // then copied by the whole block
  int tie_cap = capacity - gt_all;
  for (int c = 0; c < chunks; ++c) {
    const long long mine = first + c * chunk + static_cast<long long>(t) * R;
    if (c > 0) {
      __syncthreads();                     // the last chunk's list is copied
      row_bits<R>(scores, mine, n, aligned, tau, gbits, ebits);
    }
    int lane_before = 0, warp_total = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned g = __ballot_sync(kFull, (gbits >> j) & 1u);
      const unsigned e = __ballot_sync(kFull, (ebits >> j) & 1u);
      lane_before += pack(__popc(g & below), __popc(e & below));
      warp_total += pack(__popc(g), __popc(e));
    }
    if (lane == 0) warp_own[warp] = warp_total;
    __syncthreads();
    const int v = lane < n_warps ? warp_own[lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < adaparse::kWarp; o <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    const int warp_before = __shfl_sync(kFull, incl - v, warp);
    const int own = __shfl_sync(kFull, incl, adaparse::kWarp - 1);
    if (!multi) {                          // one block, one chunk
      gt_all = gt_of(own);
      eq_all = eq_of(own);
      tie_cap = capacity - gt_all;
    }
    const int first_pos = gt_before + max(0, min(eq_before, tie_cap));
    int before = warp_before + lane_before;   // packed, within the chunk
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int g = (gbits >> j) & 1u, e = (ebits >> j) & 1u;
      const int gb = gt_before + gt_of(before), eb = eq_before + eq_of(before);
      const int pos = gb + max(0, min(eb, tie_cap));
      if ((g || (e && eb < tie_cap)) && pos < capacity) {
        const int r = static_cast<int>(mine + j);
        idx[pos] = r;
        kept[pos - first_pos] = r;
      }
      before += pack(g, e);
    }
    gt_before += gt_of(own);
    eq_before += eq_of(own);
    const int last_pos = gt_before + max(0, min(eq_before, tie_cap));
    const int n_write = max(0, min(last_pos, capacity) - first_pos);
    __syncthreads();
    if (vec16)
      copy_rows<int4, kBatch>(tokens, out, row_bytes, kept, first_pos, n_write);
    else
      copy_rows<int, kBatch>(tokens, out, row_bytes, kept, first_pos, n_write);
  }

  // 3. the rows and idx slots past the count, and the count
  const int total = min(gt_all + max(0, min(eq_all, tie_cap)), capacity);
  if (vec16)
    zero_rows<int4>(out, row_bytes, total, capacity);
  else
    zero_rows<int>(out, row_bytes, total, capacity);
  for (long long j = total + static_cast<long long>(blockIdx.x) * blockDim.x + t;
       j < capacity; j += static_cast<long long>(gridDim.x) * blockDim.x)
    idx[j] = -1;
  if (blockIdx.x == 0 && t == 0) *count = total;
}

}  // namespace

// scores (n,) float32; tau (1,) float32 on the device; tokens (n, D) of a
// 4-byte element type, row_bytes = 4 * D; out (capacity, D); idx
// (capacity,) int32; count (1,) int32; scratch: 2 * blocks int32 when
// blocks > 1. vec16 = rows and both base pointers are 16-byte aligned.
// Writes every element of out, idx and count. The launch: `blocks`
// blocks of `threads` threads (a multiple of 32, at most 1024), `rows` =
// 1 or 4 rows a thread, `chunks` chunks of threads * rows rows a block
// (1 for one block), blocks * threads * rows * chunks >= n; more than one
// block is a cooperative launch, refused (cudaErrorCooperativeLaunchTooLarge)
// when the blocks cannot all be resident. Returns cudaErrorInvalidValue
// for another launch, else the launch's error (cudaGetLastError()).
ADAPARSE_EXPORT int adaparse_budget_route(const void* scores, const void* tau,
                                          const void* tokens, int n,
                                          int row_bytes, int capacity,
                                          int vec16, void* out, void* idx,
                                          void* count, void* scratch,
                                          int blocks, int threads, int rows,
                                          int chunks, void* stream) {
  if (n < 0 || capacity < 0 || row_bytes < 0 || threads < adaparse::kWarp ||
      threads > kMaxThreads || threads % adaparse::kWarp != 0 ||
      (rows != 1 && rows != 4) || blocks < 1 || chunks < 1 ||
      (blocks == 1 && chunks != 1) || (blocks > 1 && scratch == nullptr) ||
      static_cast<long long>(blocks) * threads * rows * chunks < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool small = threads <= kSmallThreads;
  auto kernel = rows == 4 ? (small ? route_kernel<4, kSmallThreads>
                                   : route_kernel<4, kMaxThreads>)
                          : (small ? route_kernel<1, kSmallThreads>
                                   : route_kernel<1, kMaxThreads>);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = blocks > 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(scores),
      static_cast<const float*>(tau), static_cast<const char*>(tokens), n,
      row_bytes, capacity, vec16, static_cast<char*>(out),
      static_cast<int*>(idx), static_cast<int*>(count),
      static_cast<int*>(scratch), chunks);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

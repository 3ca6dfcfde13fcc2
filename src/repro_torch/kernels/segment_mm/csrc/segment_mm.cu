// Fused edge-GEMM + segment scatter (GNN message passing):
// out[d] = sum_{e: dst_e = d} xg[e] @ W over edges sorted by dst, into a
// (n_nodes, D_out) float32 output of which the kernel writes every row.
//
// Replaces: src/repro/kernels/segment_mm/kernel.py ::
// segment_matmul_kernel (body _segmm_kernel), the Pallas TPU kernel
// behind ops.segment_matmul.
//
// Bound on the H100: bytes. Reading xg once (24.7 GB at ogb_products:
// E = 61,859,140, D_in = 100) and writing out take 7.9 ms at 3.35 TB/s.
// The function needs few operations: by linearity out[d] is the sum of
// d's rows of xg times W, E * D_in adds and one GEMV per node, ~6.9e10
// at D_out = 128, 1.0 ms at the 67 TFLOP/s FP32 peak. This kernel does
// the 2 * E * D_in * D_out = 1.584e12 FLOPs of one GEMV per edge
// instead (23.6 ms at that peak), the TPU kernel's work; summing first
// is left for a redesign. The arithmetic stays in float32 on the CUDA
// cores (no TF32: the contract's tolerance is 1e-5).
//
// Design. The TPU grid walks the edges in order and carries the last
// dst row across tiles in SMEM, accumulating into one VMEM-resident
// output. Hopper blocks run in no order, so here each block owns a range
// of kNodesPerBlock output nodes instead, finds its edges in the sorted
// dst with two binary searches (no CSR copy on the host), and is the
// only writer of its rows: no atomics, and the same bits every run.
// The block stages its (D_in, cw) slice of W in shared memory once, then
// walks its edges kTileE at a time: the tile's xg rows go to shared
// memory, each thread (one output column) computes the tile's kTileE
// messages with float32 FMAs (W from shared memory, xg as float4
// broadcasts), and adds them in edge order to a register accumulator
// that is stored when dst changes. Rows of the range with no edge are
// written as zeros, so the wrapper needs no memset. Edges whose dst lies
// outside [0, n_nodes) are never in a block's range, so they are dropped,
// as ref.py (jax.ops.segment_sum) drops them; the TPU kernel clamps them
// onto the last node. All offsets are 64-bit (E * D_in passes 2^31).
#include <stdint.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kThreads = 128;        // one output column per thread
constexpr int kTileE = 16;           // edges staged per step
constexpr int kNodesPerBlock = 128;  // output rows one block owns

// First index i in [0, n) with a[i] >= key (n if none); a is ascending.
template <typename IdT>
__device__ long long lower_bound(const IdT* __restrict__ a, long long n,
                                 long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (static_cast<long long>(a[mid]) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
segmm_kernel(const float* __restrict__ xg, const float* __restrict__ w,
             const IdT* __restrict__ dst, long long n_edges, int d_in,
             int d_in4, int d_out, long long n_nodes, int cw,
             float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);       // d_in4 x cw
  float* xs = ws + static_cast<long long>(d_in4) * cw;  // kTileE x d_in4
  long long* ds = reinterpret_cast<long long*>(xs + kTileE * d_in4);
  __shared__ long long range[2];

  const long long n0 = static_cast<long long>(blockIdx.x) * kNodesPerBlock;
  const long long n1 = min(n0 + kNodesPerBlock, n_nodes);
  const int col0 = blockIdx.y * cw;
  const int ncol = min(cw, d_out - col0);
  if (threadIdx.x == 0) range[0] = lower_bound(dst, n_edges, n0);
  if (threadIdx.x == 1) range[1] = lower_bound(dst, n_edges, n1);
  for (int i = threadIdx.x; i < d_in4 * cw; i += kThreads) {
    const int k = i / cw, c = i - k * cw;
    ws[i] = (k < d_in && c < ncol)
                ? w[static_cast<long long>(k) * d_out + col0 + c]
                : 0.0f;
  }
  __syncthreads();
  const long long e0 = range[0], e1 = range[1];

  const int j = threadIdx.x;
  const bool active = j < ncol;
  float* out_col = out + col0 + j;
  long long next_row = n0;   // rows before it are written
  long long run = -1;        // node of the open run of edges
  float acc = 0.0f;

  for (long long t0 = e0; t0 < e1; t0 += kTileE) {
    const int te = static_cast<int>(min(static_cast<long long>(kTileE),
                                        e1 - t0));
    // the tile's rows are contiguous in xg: te * d_in floats from t0
    const float* src = xg + t0 * d_in;
    for (int i = threadIdx.x; i < kTileE * d_in4; i += kThreads) {
      const int r = i / d_in4, k = i - r * d_in4;
      xs[i] = (r < te && k < d_in) ? src[static_cast<long long>(r) * d_in + k]
                                   : 0.0f;
    }
    if (threadIdx.x < kTileE)
      ds[threadIdx.x] = threadIdx.x < te
                            ? static_cast<long long>(dst[t0 + threadIdx.x])
                            : -1;
    __syncthreads();
    if (active) {
      float m[kTileE];
#pragma unroll
      for (int r = 0; r < kTileE; ++r) m[r] = 0.0f;
      for (int k = 0; k < d_in4; k += 4) {
        const float w0 = ws[(k + 0) * cw + j];
        const float w1 = ws[(k + 1) * cw + j];
        const float w2 = ws[(k + 2) * cw + j];
        const float w3 = ws[(k + 3) * cw + j];
#pragma unroll
        for (int r = 0; r < kTileE; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xs + r * d_in4 + k);
          m[r] = fmaf(xv.x, w0, m[r]);
          m[r] = fmaf(xv.y, w1, m[r]);
          m[r] = fmaf(xv.z, w2, m[r]);
          m[r] = fmaf(xv.w, w3, m[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kTileE; ++r) {
        if (r < te) {
          const long long d = ds[r];
          if (d != run) {
            if (run >= 0) {
              for (; next_row < run; ++next_row) out_col[next_row * d_out] = 0.0f;
              out_col[run * d_out] = acc;
              next_row = run + 1;
            }
            run = d;
            acc = 0.0f;
          }
          acc += m[r];
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    if (run >= 0) {
      for (; next_row < run; ++next_row) out_col[next_row * d_out] = 0.0f;
      out_col[run * d_out] = acc;
      next_row = run + 1;
    }
    for (; next_row < n1; ++next_row) out_col[next_row * d_out] = 0.0f;
  }
}

template <typename IdT>
cudaError_t launch(const float* xg, const float* w, const void* dst,
                   long long n_edges, int d_in, int d_out, long long n_nodes,
                   int cw, float* out, cudaStream_t stream) {
  const int d_in4 = (d_in + 3) / 4 * 4;
  const size_t smem = sizeof(float) * (static_cast<size_t>(d_in4) * cw +
                                       static_cast<size_t>(kTileE) * d_in4) +
                      sizeof(long long) * kTileE;
  cudaError_t err = cudaFuncSetAttribute(
      segmm_kernel<IdT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long gx = (n_nodes + kNodesPerBlock - 1) / kNodesPerBlock;
  const int gy = (d_out + cw - 1) / cw;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidConfiguration;
  segmm_kernel<IdT><<<dim3(static_cast<unsigned>(gx), gy), kThreads, smem,
                      stream>>>(xg, w, static_cast<const IdT*>(dst), n_edges,
                                d_in, d_in4, d_out, n_nodes, cw, out);
  return cudaGetLastError();
}

}  // namespace

// dst64: dst is int64 (else int32), ascending. cw: output columns a
// block computes (<= kThreads; the wrapper sizes it to shared memory).
ADAPARSE_EXPORT int adaparse_segment_mm(const float* xg, const float* w,
                                        const void* dst, int dst64,
                                        long long n_edges, int d_in,
                                        int d_out, long long n_nodes, int cw,
                                        float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cw < 1 || cw > kThreads) return cudaErrorInvalidValue;
  return dst64 ? launch<long long>(xg, w, dst, n_edges, d_in, d_out, n_nodes,
                                   cw, out, s)
               : launch<int>(xg, w, dst, n_edges, d_in, d_out, n_nodes, cw,
                             out, s);
}

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
// exactly that work (the TPU kernel does one GEMV per edge, 23x more).
// The arithmetic stays in float32 on the CUDA cores (no TF32: the
// contract's tolerance is 1e-5).
//
// Design. The TPU grid walks the edges in order and carries the last
// dst row across tiles in SMEM, accumulating into one VMEM-resident
// output. Hopper blocks run in no order, so here each block owns a range
// of `nb` output nodes instead, finds its edges in the sorted dst with
// two binary searches (no CSR copy on the host), and is the only writer
// of its rows: no atomics, and the same bits every run. Its edges are one
// contiguous slab of xg.
//
// Phase 1 streams the slab once through a two-stage shared-memory ring
// of `nb` rows, with 16-byte cp.async (the dst ids ride along in the same
// groups), so tile t+1 loads while tile t is summed; a slab whose rows
// are not 16-byte aligned (D_in % 4 != 0) is copied element by element.
// Each node's rows are summed in float32, in edge order, into an
// (nb x D_in) tile in shared memory: one warp finds the tile's runs of
// equal dst (ballots), and a thread owns one float4 column of every
// lanes-th run, whose rows it sums in a register before adding that
// partial to the node's running sum: within a tile, edge order; across
// tiles, tile order (the syncs between tiles order them). Phase 2 multiplies that tile by W, `cw` columns of W
// at a time staged in the ring's space, each thread computing 4 nodes x
// 4 columns with float32 FMAs (k in order), and writes the block's rows.
// xg is read once whatever D_out is. Rows of the range with no edge are
// written as zeros, so the wrapper needs no memset. Edges whose dst lies
// outside [0, n_nodes) are never in a block's range, so they are dropped,
// as ref.py (jax.ops.segment_sum) drops them; the TPU kernel clamps them
// onto the last node. All offsets are 64-bit (E * D_in passes 2^31).
#include <stdint.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNodes = 64;        // nodes (and ring rows) a block owns
constexpr int kMaxSmem = 232448 - 1024;  // dynamic shared memory a block
//                                          may use, less the static arrays

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

__device__ __forceinline__ void add4(float4* a, float4 x) {
  float4 s = *a;
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
  *a = s;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Shared memory of a block that owns nb nodes: the node-sum tile, a
// ring of two stages of nb rows (which holds a chunk of W in phase 2)
// and the ring's dst ids.
__host__ __device__ __forceinline__ size_t smem_bytes(int d_in, int nb) {
  return sizeof(float) * static_cast<size_t>(round4(nb) + 2 * nb) *
             round4(d_in) +
         sizeof(long long) * 2 * nb;
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
segmm_kernel(const float* __restrict__ xg, const float* __restrict__ w,
             const IdT* __restrict__ dst, long long n_edges, int d_in,
             int d_out, long long n_nodes, int nb, int cw, int vec,
             float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int d_in4 = round4(d_in);                 // row stride in shared memory
  const int c4 = d_in4 / 4;                       // float4 columns
  const int nb4 = round4(nb);
  const int te = nb;                              // rows a ring stage holds
  float* acc = reinterpret_cast<float*>(smem4);   // nb4 x d_in4
  float4* acc4 = smem4;
  float* ring = acc + static_cast<long long>(nb4) * d_in4;  // 2 x te x d_in4
  IdT* ids = reinterpret_cast<IdT*>(ring + 2LL * te * d_in4);  // 2 x te
  __shared__ long long range[2];
  __shared__ int run_start[kMaxNodes + 1];        // runs of the current tile
  __shared__ int n_runs;

  const long long n0 = static_cast<long long>(blockIdx.x) * nb;
  const long long n1 = min(n0 + nb, n_nodes);
  // run lanes: a thread sums float4 column `col` of the runs of lane
  // `lane` (run % lanes); with more columns than threads, one lane sums
  // every run and a thread takes columns tid, tid + kThreads, ...
  const int lanes = c4 <= kThreads ? kThreads / c4 : 1;
  const int lane = c4 <= kThreads ? threadIdx.x / c4 : 0;
  const int col = c4 <= kThreads ? threadIdx.x % c4 : threadIdx.x;
  const int col_step = c4 <= kThreads ? c4 : kThreads;
  if (threadIdx.x == 0) range[0] = lower_bound(dst, n_edges, n0);
  if (threadIdx.x == 1) range[1] = lower_bound(dst, n_edges, n1);
  for (int i = threadIdx.x; i < nb4 * d_in4; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  const long long e0 = range[0], e1 = range[1];
  const int n_tiles = static_cast<int>((e1 - e0 + te - 1) / te);

  // ---- phase 1: node sums, in edge order
  auto issue = [&](int t) {
    const long long eb = e0 + static_cast<long long>(t) * te;
    const int cnt = static_cast<int>(min(static_cast<long long>(te), e1 - eb));
    float* buf = ring + static_cast<long long>(t & 1) * te * d_in4;
    if (vec) {                                    // cnt contiguous rows, d_in4 == d_in
      const float4* src = reinterpret_cast<const float4*>(xg + eb * d_in);
      for (int i = threadIdx.x; i < cnt * c4; i += kThreads)
        adaparse::cp_async<16>(adaparse::smem_addr(buf + 4 * i), src + i);
    } else {
      for (int i = threadIdx.x; i < cnt * d_in4; i += kThreads) {
        const int r = i / d_in4, k = i - r * d_in4;
        buf[i] = k < d_in ? xg[(eb + r) * d_in + k] : 0.0f;
      }
    }
    IdT* id_buf = ids + (t & 1) * te;
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      adaparse::cp_async<sizeof(IdT)>(adaparse::smem_addr(id_buf + i),
                                      dst + eb + i);
  };
  if (n_tiles > 0) issue(0);
  adaparse::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    adaparse::cp_async_commit();
    adaparse::cp_async_wait<1>();
    __syncthreads();
    const long long eb = e0 + static_cast<long long>(t) * te;
    const int cnt = static_cast<int>(min(static_cast<long long>(te), e1 - eb));
    const float4* buf = reinterpret_cast<const float4*>(
        ring + static_cast<long long>(t & 1) * te * d_in4);
    const IdT* id_buf = ids + (t & 1) * te;
    if (threadIdx.x < adaparse::kWarp) {          // runs of equal dst (te <= 64)
      const int e = threadIdx.x;
      const bool s0 = e < cnt && (e == 0 || id_buf[e] != id_buf[e - 1]);
      const bool s1 = e + 32 < cnt && id_buf[e + 32] != id_buf[e + 31];
      const unsigned m0 = __ballot_sync(adaparse::kFullMask, s0);
      const unsigned m1 = __ballot_sync(adaparse::kFullMask, s1);
      const unsigned below = (1u << e) - 1;
      if (s0) run_start[__popc(m0 & below)] = e;
      if (s1) run_start[__popc(m0) + __popc(m1 & below)] = e + 32;
      if (e == 0) {
        n_runs = __popc(m0) + __popc(m1);
        run_start[n_runs] = cnt;
      }
    }
    __syncthreads();
    // a run's rows are summed in a register, in edge order, then added to
    // its node's running sum once (a two-level sum: a hub's error grows
    // with its tiles, not with its edges); runs go round the lanes
    if (lane < lanes) {
      for (int j = lane; j < n_runs; j += lanes) {
        const int a = run_start[j], z = run_start[j + 1];
        const int node = static_cast<int>(static_cast<long long>(id_buf[a]) - n0);
        for (int c = col; c < c4; c += col_step) {
          float4 s = buf[a * c4 + c];
#pragma unroll 4
          for (int e = a + 1; e < z; ++e) {
            const float4 x = buf[e * c4 + c];
            s.x += x.x;
            s.y += x.y;
            s.z += x.z;
            s.w += x.w;
          }
          add4(acc4 + node * c4 + c, s);
        }
      }
    }
    __syncthreads();                              // the stage may be refilled
  }

  // ---- phase 2: out rows = node sums @ W, cw columns at a time
  const int cg = cw / 4;                          // 4-column groups
  const int items = (nb4 / 4) * cg;
  for (int col0 = 0; col0 < d_out; col0 += cw) {
    const int ncol = min(cw, d_out - col0);
    float* ws = ring;                             // d_in x cw
    for (int i = threadIdx.x; i < d_in * cw; i += kThreads) {
      const int k = i / cw, c = i - k * cw;
      ws[i] = c < ncol ? w[static_cast<long long>(k) * d_out + col0 + c] : 0.0f;
    }
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int tc = it % cg, tn = it / cg;
      const float* a = acc + static_cast<long long>(tn) * 4 * d_in4;
      float r[4][4] = {};
      for (int k = 0; k < d_in; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + k * cw + 4 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = a[i * d_in4 + k];
          r[i][0] = fmaf(x, wv.x, r[i][0]);
          r[i][1] = fmaf(x, wv.y, r[i][1]);
          r[i][2] = fmaf(x, wv.z, r[i][2]);
          r[i][3] = fmaf(x, wv.w, r[i][3]);
        }
      }
      const int c = col0 + 4 * tc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long node = n0 + 4 * tn + i;
        if (node >= n1) break;
        float* orow = out + node * d_out;
        if (!(d_out & 3) && c + 3 < d_out) {
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < col0 + ncol) orow[c + j] = r[i][j];
        }
      }
    }
    __syncthreads();                              // ws may be refilled
  }
}

template <typename IdT>
cudaError_t launch(const float* xg, const float* w, const void* dst,
                   long long n_edges, int d_in, int d_out, long long n_nodes,
                   int nb, int cw, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(d_in, nb);
  cudaError_t err = cudaFuncSetAttribute(
      segmm_kernel<IdT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long gx = (n_nodes + nb - 1) / nb;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int vec = !(d_in & 3) && reinterpret_cast<uintptr_t>(xg) % 16 == 0;
  segmm_kernel<IdT><<<static_cast<unsigned>(gx), kThreads, smem, stream>>>(
      xg, w, static_cast<const IdT*>(dst), n_edges, d_in, d_out, n_nodes, nb,
      cw, vec, out);
  return cudaGetLastError();
}

}  // namespace

// dst64: dst is int64 (else int32), ascending. nb: nodes a block owns,
// also the rows a ring stage holds (2 <= nb <= 64); cw: columns of W a
// phase-2 pass stages (a multiple of 4, <= 2 nb). The wrapper sizes them
// to shared memory (ops.block_plan).
ADAPARSE_EXPORT int adaparse_segment_mm(const float* xg, const float* w,
                                        const void* dst, int dst64,
                                        long long n_edges, int d_in,
                                        int d_out, long long n_nodes, int nb,
                                        int cw, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 2 || nb > kMaxNodes || cw < 4 || cw % 4 || cw > 2 * nb ||
      d_in < 1 || d_out < 1 ||
      smem_bytes(d_in, nb) > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  return dst64 ? launch<long long>(xg, w, dst, n_edges, d_in, d_out, n_nodes,
                                   nb, cw, out, s)
               : launch<int>(xg, w, dst, n_edges, d_in, d_out, n_nodes, nb,
                             cw, out, s);
}

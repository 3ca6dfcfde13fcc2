// EmbeddingBag: out[b] = combine_{l < L} w[b, l] * table[ids[b, l]], the
// fused gather + weighted bag reduce (sum, or mean over sum(w)).
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py ::
// embedding_bag_kernel (body _bag_kernel), the Pallas TPU kernel behind
// ops.embedding_bag.
//
// Bound on the H100: bytes. Each bag reads L table rows once and writes
// one row; the ids (and weights) are read once. At the DLRM-MLPerf
// serve_bulk lookup (262,144 x 26 bags of one, D=128, bf16) that is
// 1.745 GB of rows read, 1.745 GB written and 27 MB of ids: ~1.05 ms at
// 3.35 TB/s. The rows are scattered over a 48 GB table, so every row is
// a cold 256-byte gather; the design keeps many independent 16-byte
// loads in flight and does no other work.
//
// Design. The TPU kernel walks a block of bags row by row with dynamic
// loads out of HBM and accumulates in VMEM. Here a group of G lanes
// (G = the row's count of 16-byte vectors, rounded up to a power of two
// and at most 32; a 128-wide bf16 row is 16 vectors, two bags a warp)
// owns one bag: each lane loads its 16-byte slice of every row of the
// bag, accumulates w * row in float32 registers over the L ids, divides
// for mean, and narrows once. Rows whose byte width is not a multiple of
// 16 take a scalar path (one element a lane). No shared memory and no
// atomics: a bag is summed by one lane per column in id order, so the
// output is the same bits every run.
//
// Semantics shared with ref.py (jnp.take): an id in [-R, 0) counts from
// the end, an id >= R or < -R reads a NaN row. The TPU kernel clamps
// such an id onto the last row instead; its own oracle (jnp.take)
// returns NaN, and this kernel follows the oracle. The product w * x and
// the sum are rounded separately (no FMA contraction), as the plain
// version rounds them. Row offsets are 64-bit (id * row_stride passes
// 2^31 on the 187.8M-row table).
#include <stdint.h>

#include <cuda_bf16.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct Row;

template <>
struct Row<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    x[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    p[0] = x[0];
  }
};

template <>
struct Row<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned float_to_bf16_bits(float f) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

template <>
struct Row<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    x[0] = bf16_bits_to_float(
        __ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(float_to_bf16_bits(x[0]));
  }
};

template <>
struct Row<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);     // little endian:
      x[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);     // low half first
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = float_to_bf16_bits(x[2 * i]) |
             (float_to_bf16_bits(x[2 * i + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, typename IdT, int V>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, long long n_rows,
           long long row_stride, int d, const IdT* __restrict__ ids,
           const float* __restrict__ weights, long long n_bags, int bag,
           int mean, int group_log2, T* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long b = t >> group_log2;
  if (b >= n_bags) return;
  const int group = 1 << group_log2;
  const int lane = static_cast<int>(t & (group - 1));
  const IdT* bid = ids + b * bag;
  const float* bw = weights ? weights + b * bag : nullptr;

  float denom = 1.0f;
  if (mean) {
    denom = 0.0f;
    for (int l = 0; l < bag; ++l) denom = __fadd_rn(denom, bw ? bw[l] : 1.0f);
    denom = denom < 1e-9f ? 1e-9f : denom;     // NaN stays NaN
  }
  const float nan = __int_as_float(0x7fc00000);
  const int n_vec = d / V;
  for (int v = lane; v < n_vec; v += group) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int l = 0; l < bag; ++l) {
      long long id = static_cast<long long>(bid[l]);
      const float wl = bw ? bw[l] : 1.0f;
      if (id < 0) id += n_rows;
      float x[V];
      if (id < 0 || id >= n_rows) {
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = nan;
      } else {
        Row<T, V>::load(table + id * row_stride + static_cast<long long>(v) * V,
                        x);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(x[i], wl));
    }
    if (mean) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fdiv_rn(acc[i], denom);
    }
    Row<T, V>::store(out + b * d + static_cast<long long>(v) * V, acc);
  }
}

template <typename T, typename IdT, int V>
cudaError_t launch(const void* table, long long n_rows, long long row_stride,
                   int d, const void* ids, const float* weights,
                   long long n_bags, int bag, int mean, void* out,
                   cudaStream_t stream) {
  const int n_vec = d / V;
  int group_log2 = 0;
  while ((1 << group_log2) < n_vec && group_log2 < 5) ++group_log2;
  const long long threads = n_bags << group_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bag_kernel<T, IdT, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(table), n_rows, row_stride, d,
      static_cast<const IdT*>(ids), weights, n_bags, bag, mean, group_log2,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_ids(const void* table, long long n_rows,
                       long long row_stride, int d, const void* ids,
                       int ids64, const float* weights, long long n_bags,
                       int bag, int mean, int vec16, void* out,
                       cudaStream_t stream) {
  if (vec16) {
    return ids64 ? launch<T, long long, VEC>(table, n_rows, row_stride, d,
                                              ids, weights, n_bags, bag, mean,
                                              out, stream)
                 : launch<T, int, VEC>(table, n_rows, row_stride, d, ids,
                                       weights, n_bags, bag, mean, out,
                                       stream);
  }
  return ids64 ? launch<T, long long, 1>(table, n_rows, row_stride, d, ids,
                                          weights, n_bags, bag, mean, out,
                                          stream)
               : launch<T, int, 1>(table, n_rows, row_stride, d, ids,
                                   weights, n_bags, bag, mean, out, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. ids64: ids are int64 (else int32).
// weights may be null (every weight 1). vec16: the row width in bytes,
// the row stride in bytes and both base pointers are multiples of 16.
ADAPARSE_EXPORT int adaparse_embedding_bag(
    const void* table, int dtype, long long n_rows, long long row_stride,
    int d, const void* ids, int ids64, const float* weights,
    long long n_bags, int bag, int mean, int vec16, void* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ids<float, 4>(table, n_rows, row_stride, d, ids, ids64,
                                weights, n_bags, bag, mean, vec16, out, s);
  if (dtype == 1)
    return launch_ids<__nv_bfloat16, 8>(table, n_rows, row_stride, d, ids,
                                        ids64, weights, n_bags, bag, mean,
                                        vec16, out, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// EmbeddingBag backward, bags of one: the dense table gradient
//   out[r] = ((0 + g[p0]) + g[p1]) + ...   over the positions p0 < p1 < ...
// whose id is r, every add rounded to the table's dtype.
//
// Replaces no Pallas kernel: the JAX package trains through jnp.take, and
// its gradient is the gather's transpose, XLA's scatter-add, which adds
// an id's rows one at a time in position order in the table's dtype (in
// bf16, rounding after every add). This kernel copies that order bit for
// bit, so a bf16 training on the card takes the reference's steps; the
// F.embedding backward accumulates in float32 and rounds once, and
// index_add_ adds with atomics in a varying order.
//
// Bound on the H100: bytes. The grad rows are read once, the ids once,
// and the dense (R, D) gradient is written once. At DeepFM's train_batch
// lookup (65,536 x 39 ids, D = 10, bf16, 33.76M rows) that is 51 MB of
// grad, 10 MB of ids and 675 MB written: ~0.22 ms at 3.35 TB/s.
//
// Design. The wrapper wraps the ids (jnp.take's semantics; an id outside
// [-R, R) is dropped), sorts them stably with torch.sort and cuts the
// sorted keys into runs (torch.unique_consecutive): plumbing that gives
// each touched row a run of sorted positions whose source positions
// ascend. The entry zeroes the output (memset), then launches one warp
// per run. The warp walks its run in chunks of 32 positions: each lane
// loads one position (coalesced; the next chunk's is prefetched while
// this one is added), the positions go round by shuffle, and each lane
// owns one 16-byte vector of the row (or one element on the scalar
// path) and loads its slice of the chunk's U rows at once (independent
// loads, held raw), then adds them in order. No atomics and no shared
// memory: each output element is one lane's serial sum, the same bits
// every run. The longest run (a field with a vocabulary of 3 takes a
// third of the batch) is the critical path. Two earlier designs, one
// group of lanes per run whose every lane computed each position's
// address itself, spent ~0.2-0.4 us an id on it (PERF.md).
namespace {

template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return bf16_bits_to_float(float_to_bf16_bits(x));
}

// A row slice of V elements as loaded (raw bits), then widened.
template <typename T, int V>
struct Raw;

template <>
struct Raw<float, 1> {
  using type = float;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void widen(type r, float* x) {
    x[0] = r;
  }
};

template <>
struct Raw<float, 4> {
  using type = float4;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void widen(type r, float* x) {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
};

template <>
struct Raw<__nv_bfloat16, 1> {
  using type = unsigned;
  static __device__ __forceinline__ type load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void widen(type r, float* x) {
    x[0] = bf16_bits_to_float(r);
  }
};

template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
  static __device__ __forceinline__ type load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(type r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
      x[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
    }
  }
};

template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads, 2)
bag_backward_kernel(const T* __restrict__ grad, int d,
                    const long long* __restrict__ run_key,
                    const long long* __restrict__ run_start,
                    const long long* __restrict__ perm, long long n_runs,
                    T* __restrict__ out) {
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  if (r >= n_runs) return;                    // whole warps: r is uniform
  const int lane = threadIdx.x & 31;
  const long long key = __ldg(run_key + r);
  const long long first = __ldg(run_start + r);
  const long long end = __ldg(run_start + r + 1);
  const int n_vec = d / V;
  for (int v0 = 0; v0 < n_vec; v0 += 32) {
    const bool mine = v0 + lane < n_vec;
    const long long col = static_cast<long long>(mine ? v0 + lane : 0) * V;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    long long next = first + lane < end ? __ldg(perm + first + lane) : 0;
    for (long long j = first; j < end; j += 32) {
      const long long src = next;
      const int m = static_cast<int>(end - j < 32 ? end - j : 32);
      if (j + 32 < end)
        next = j + 32 + lane < end ? __ldg(perm + j + 32 + lane) : 0;
#pragma unroll
      for (int h = 0; h < 32; h += U) {
        typename Raw<T, V>::type raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long p = __shfl_sync(0xffffffffu, src, h + u);
          if (mine && h + u < m) raw[u] = Raw<T, V>::load(grad + p * d + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (h + u < m) {                    // uniform over the warp
            float x[V];
            Raw<T, V>::widen(raw[u], x);
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[e] = round_to<T>(__fadd_rn(acc[e], x[e]));
          }
        }
      }
    }
    if (mine) Row<T, V>::store(out + key * d + col, acc);
  }
}

template <typename T, int V, int U>
cudaError_t launch_backward(const void* grad, long long n_rows, int d,
                            const long long* run_key,
                            const long long* run_start,
                            const long long* perm, long long n_runs,
                            void* out, cudaStream_t stream) {
  const cudaError_t z = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_rows) * d * sizeof(T), stream);
  if (z != cudaSuccess) return z;
  if (n_runs == 0) return cudaGetLastError();
  const long long blocks = (n_runs * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bag_backward_kernel<T, V, U><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const T*>(grad), d, run_key, run_start, perm, n_runs,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// grad (n, d) contiguous rows, dtype 0 float32 or 1 bfloat16; perm the
// positions of the sorted valid ids; n_runs runs of equal ids: run i is
// row run_key[i], positions perm[run_start[i] .. run_start[i + 1]) (so
// run_start has n_runs + 1 entries); out (n_rows, d) contiguous, zeroed
// here. vec16: the row width in bytes and both base pointers are
// multiples of 16.
ADAPARSE_EXPORT int adaparse_embedding_bag_backward(
    const void* grad, int dtype, long long n_rows, int d,
    const long long* run_key, const long long* run_start,
    const long long* perm, long long n_runs, int vec16, void* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec16 ? launch_backward<float, 4, 16>(grad, n_rows, d, run_key,
                                                 run_start, perm, n_runs,
                                                 out, s)
                 : launch_backward<float, 1, 32>(grad, n_rows, d, run_key,
                                                 run_start, perm, n_runs,
                                                 out, s);
  if (dtype == 1)
    return vec16 ? launch_backward<__nv_bfloat16, 8, 16>(
                       grad, n_rows, d, run_key, run_start, perm, n_runs,
                       out, s)
                 : launch_backward<__nv_bfloat16, 1, 32>(
                       grad, n_rows, d, run_key, run_start, perm, n_runs,
                       out, s);
  return cudaErrorInvalidValue;
}

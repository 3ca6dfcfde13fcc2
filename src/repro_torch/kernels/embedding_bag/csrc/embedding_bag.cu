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
// a cold 256-byte gather; the design keeps many independent loads in
// flight and does no other work.
//
// Design. The TPU kernel walks a block of bags row by row with dynamic
// loads out of HBM and accumulates in VMEM. Here the threads are laid
// flat over (bag, vector): a vector is the widest of 16, 8, 4 or 2 bytes
// that divides the row's byte width, the row stride and both base
// addresses (the wrapper picks it), so a D = 10 bf16 row is five 4-byte
// words and a D = 18 f32 row nine 8-byte ones. A warp takes Q x 32
// consecutive (bag, vector) elements (Q = 1 for 16-byte vectors, which
// is the earlier design's access pattern, else 2: 1 and 4 measured
// slower), so its stores run contiguously across bags (128 bytes a warp
// at 4-byte vectors), and each lane keeps Q independent row loads in
// flight. Each lane accumulates w * row over the bag's L ids in float32
// registers in id order, divides for mean, and narrows once. No shared
// memory and no atomics: the same bits every run.
//
// What bounded the earlier design, and what this one does about it: a
// row whose byte width was not a multiple of 16 took one 2-byte element
// a lane, so DeepFM's 20-byte rows were ten 2-byte loads by 10 lanes of
// a 16-lane group (6 idle) and 2-byte stores (0.2014 ms against a
// 0.0336 ms byte bound); now five 4-byte loads and 128-byte warp stores.
// ptxas (sm_90a): 32-48 registers, no shared memory, no spills but 4
// bytes in one of the 14 variants (bf16, 4-byte vectors, int64 ids).
//
// Semantics shared with ref.py (jnp.take): an id in [-R, 0) counts from
// the end, an id >= R or < -R reads a NaN row. The TPU kernel clamps
// such an id onto the last row instead; its own oracle (jnp.take)
// returns NaN, and this kernel follows the oracle. The product w * x and
// the sum are rounded separately (no FMA contraction), as the plain
// version rounds them. Row offsets are 64-bit (id * row_stride passes
// 2^31 on the 187.8M-row table).
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include <cuda_bf16.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned float_to_bf16_bits(float f) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

template <int VB>
struct RawOf;
template <>
struct RawOf<2> {
  using type = unsigned short;
};
template <>
struct RawOf<4> {
  using type = unsigned;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<16> {
  using type = uint4;
};

__device__ __forceinline__ void to_words(unsigned short r, unsigned* w) {
  w[0] = r;
}
__device__ __forceinline__ void to_words(unsigned r, unsigned* w) { w[0] = r; }
__device__ __forceinline__ void to_words(uint2 r, unsigned* w) {
  w[0] = r.x;
  w[1] = r.y;
}
__device__ __forceinline__ void to_words(uint4 r, unsigned* w) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}

template <int VB>
__device__ __forceinline__ typename RawOf<VB>::type from_words(
    const unsigned* w) {
  if constexpr (VB == 2)
    return static_cast<unsigned short>(w[0]);
  else if constexpr (VB == 4)
    return w[0];
  else if constexpr (VB == 8)
    return make_uint2(w[0], w[1]);
  else
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// A row slice of VB bytes of element type T: loaded raw (held as loaded,
// so a batch of loads is in flight before any is used), widened to
// float32 (little endian: the low half of a word is the first bf16),
// narrowed back with round-to-nearest-even.
template <typename T, int VB>
struct Vec {
  static constexpr int E = VB / static_cast<int>(sizeof(T));
  static constexpr int NW = VB >= 4 ? VB / 4 : 1;
  using raw = typename RawOf<VB>::type;
  static __device__ __forceinline__ raw ldg(const char* p) {
    return __ldg(reinterpret_cast<const raw*>(p));
  }
  static __device__ __forceinline__ raw lds(const char* p) {
    return *reinterpret_cast<const raw*>(p);
  }
  static __device__ __forceinline__ void st(char* p, raw r) {
    *reinterpret_cast<raw*>(p) = r;
  }
  static __device__ __forceinline__ raw zero() { return raw{}; }
  static __device__ __forceinline__ void widen(raw r, float* x) {
    unsigned w[NW];
    to_words(r, w);
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < NW; ++i) x[i] = __uint_as_float(w[i]);
    } else if constexpr (VB == 2) {
      x[0] = bf16_bits_to_float(w[0]);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        x[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
        x[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
      }
    }
  }
  static __device__ __forceinline__ raw narrow(const float* x) {
    unsigned w[NW];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = __float_as_uint(x[i]);
    } else if constexpr (VB == 2) {
      w[0] = float_to_bf16_bits(x[0]);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i)
        w[i] = float_to_bf16_bits(x[2 * i]) |
               (float_to_bf16_bits(x[2 * i + 1]) << 16);
    }
    return from_words<VB>(w);
  }
};

template <typename T, typename IdT, int VB, int Q>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const char* __restrict__ table, long long n_rows,
           long long row_stride, int w, const IdT* __restrict__ ids,
           const float* __restrict__ weights, long long n_bags, int bag,
           int mean, int bags_per_warp, char* __restrict__ out) {
  using V = Vec<T, VB>;
  constexpr int E = V::E;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long b0 = warp * bags_per_warp;
  if (b0 >= n_bags) return;
  const int nb = static_cast<int>(
      min(static_cast<long long>(bags_per_warp), n_bags - b0));
  const int n_el = nb * w;
  const float nan = __int_as_float(0x7fc00000);
  for (int f0 = 0; f0 < n_el; f0 += 32 * Q) {
    long long b[Q];
    int v[Q];
    bool ok[Q];
    float acc[Q][E], denom[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int f = f0 + 32 * q + lane;
      ok[q] = f < n_el;
      const int lb = !ok[q] ? 0 : w == 1 ? f : f / w;
      v[q] = ok[q] ? f - lb * w : 0;
      b[q] = b0 + lb;
      denom[q] = 1.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[q][e] = 0.0f;
    }
    if (mean) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float dn = 0.0f;
        for (int l = 0; l < bag; ++l)
          dn = __fadd_rn(dn, weights ? __ldg(weights + b[q] * bag + l) : 1.0f);
        denom[q] = dn < 1e-9f ? 1e-9f : dn;    // NaN stays NaN
      }
    }
    for (int l = 0; l < bag; ++l) {
      long long id[Q];
      float wl[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        id[q] = ok[q] ? static_cast<long long>(__ldg(ids + b[q] * bag + l))
                      : 0;
        wl[q] = weights && ok[q] ? __ldg(weights + b[q] * bag + l) : 1.0f;
      }
      typename V::raw r[Q];
      bool bad[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        long long x = id[q];
        if (x < 0) x += n_rows;
        bad[q] = x < 0 || x >= n_rows;
        r[q] = ok[q] && !bad[q]
                   ? V::ldg(table + x * row_stride +
                            static_cast<long long>(v[q]) * VB)
                   : V::zero();
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float x[E];
        V::widen(r[q], x);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[q][e] = __fadd_rn(acc[q][e], __fmul_rn(bad[q] ? nan : x[e],
                                                     wl[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (!ok[q]) continue;
      if (mean) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[q][e] = __fdiv_rn(acc[q][e], denom[q]);
      }
      V::st(out + (b[q] * w + v[q]) * static_cast<long long>(VB),
            V::narrow(acc[q]));
    }
  }
}

template <typename T, typename IdT, int VB>
cudaError_t launch(const void* table, long long n_rows, long long row_stride,
                   int d, const void* ids, const float* weights,
                   long long n_bags, int bag, int mean, void* out,
                   cudaStream_t stream) {
  constexpr int Q = VB == 16 ? 1 : 2;
  const int w = static_cast<int>(d * sizeof(T) / VB);
  const int bags_per_warp = w >= 32 * Q ? 1 : 32 * Q / w;
  const long long warps = (n_bags + bags_per_warp - 1) / bags_per_warp;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bag_kernel<T, IdT, VB, Q><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
      static_cast<const char*>(table), n_rows,
      row_stride * static_cast<long long>(sizeof(T)), w,
      static_cast<const IdT*>(ids), weights, n_bags, bag, mean,
      bags_per_warp, static_cast<char*>(out));
  return cudaGetLastError();
}

template <typename T, int VB>
cudaError_t launch_ids(const void* table, long long n_rows,
                       long long row_stride, int d, const void* ids,
                       int ids64, const float* weights, long long n_bags,
                       int bag, int mean, void* out, cudaStream_t stream) {
  return ids64 ? launch<T, long long, VB>(table, n_rows, row_stride, d, ids,
                                          weights, n_bags, bag, mean, out,
                                          stream)
               : launch<T, int, VB>(table, n_rows, row_stride, d, ids,
                                    weights, n_bags, bag, mean, out, stream);
}

template <typename T>
cudaError_t launch_vec(const void* table, long long n_rows,
                       long long row_stride, int d, const void* ids,
                       int ids64, const float* weights, long long n_bags,
                       int bag, int mean, int vec_bytes, void* out,
                       cudaStream_t stream) {
  switch (vec_bytes) {
    case 16:
      return launch_ids<T, 16>(table, n_rows, row_stride, d, ids, ids64,
                               weights, n_bags, bag, mean, out, stream);
    case 8:
      return launch_ids<T, 8>(table, n_rows, row_stride, d, ids, ids64,
                              weights, n_bags, bag, mean, out, stream);
    case 4:
      return launch_ids<T, 4>(table, n_rows, row_stride, d, ids, ids64,
                              weights, n_bags, bag, mean, out, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_ids<T, 2>(table, n_rows, row_stride, d, ids, ids64,
                                weights, n_bags, bag, mean, out, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. ids64: ids are int64 (else int32).
// weights may be null (every weight 1). vec_bytes: 16, 8, 4 or 2 (2 for
// bfloat16 only), dividing the row width in bytes, the row stride in
// bytes (row_stride is in elements) and both base addresses.
ADAPARSE_EXPORT int adaparse_embedding_bag(
    const void* table, int dtype, long long n_rows, long long row_stride,
    int d, const void* ids, int ids64, const float* weights,
    long long n_bags, int bag, int mean, int vec_bytes, void* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float>(table, n_rows, row_stride, d, ids, ids64,
                             weights, n_bags, bag, mean, vec_bytes, out, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(table, n_rows, row_stride, d, ids, ids64,
                                     weights, n_bags, bag, mean, vec_bytes,
                                     out, s);
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
// index_add_ adds with atomics in a varying order. The same kernel is
// ops.segment_sum, the GNN's deterministic sum by index.
//
// Bound on the H100: bytes. The grad rows are read once, the ids once,
// and the dense (R, D) gradient is written once. At DeepFM's train_batch
// lookup (65,536 x 39 ids, D = 10, bf16, 33.76M rows) that is 51 MB of
// grad, 10 MB of ids and 675 MB written: ~0.22 ms at 3.35 TB/s.
//
// Plumbing (the wrapper, no host synchronisation): the ids wrapped as
// jnp.take wraps them (an id outside [-R, R) becomes R, which sorts last
// and adds nothing) and stably sorted (keys, and perm, the positions they
// came from), then tile_ptr = searchsorted(keys, t * tile): the first
// sorted position of each tile of `tile` output rows, and of R at the
// end. Dense row offsets (tile = 1) would be a 135 MB array at DeepFM's
// 33.76M rows, a search of every row written and read back here; the
// tile pointers are 1 MB, and each tile finds its rows' starts among its
// own keys. PERF.md has both plumbings' times.
//
// What bounded the earlier design (one warp a run after a memset), and
// what this one does about each:
// 1. The longest run (21,947 ids on one DeepFM row) was a chain waiting
//    on memory: a chunk of 32 rows loaded, then added, then the next
//    loaded. Now a run of more than kLongRun ids is a long run, summed
//    by a pair of warps (bag_long_kernel): a producer streams its rows
//    into a ring of kStages chunks in shared memory with cp.async (4, 8
//    or 16-byte pieces; a row of odd bf16 width as the 4-byte words that
//    cover it), its positions riding kStages chunks further ahead, and a
//    consumer adds them, the two handing the slots over through mbarriers
//    (full: the copies landed; empty: the consumer has read it), so the
//    chain waits on neither the loads nor their issue. The long runs are
//    found on the card: sample j looks at sorted position j * kLongRun
//    and owns the run there when position (j - 1) * kLongRun holds another
//    row (every run of more than kLongRun holds a sample, and exactly one
//    owns it); the run's ends come from warp ballots. A block (one pair)
//    takes 32 samples and sums the runs it owns one after another.
// 2. Every output byte of a touched row was written twice (a memset of
//    the whole (R, D) output, then the run). Now every output element is
//    written exactly once: each tile stores its rows, zeros for a row
//    with no ids (16-byte stores where the tile's bytes allow), and skips
//    only the long runs, which their pairs store.
// 3. Short runs wasted their warp: a warp walked its run once for every
//    32 column vectors, reloading the run's positions on every pass.
//    Now a warp takes a tile of consecutive rows (bag_tiles_kernel). Its
//    rows' starts: a tile of at most kScatterKeys keys loads them all at
//    once and scatters each run's start, then a suffix minimum (one load
//    latency); a larger one binary-searches, 8 rows a lane at once. Rows
//    of at most 32 vectors: its rows of 1 .. kLongRun ids are compacted,
//    the lanes lie flat over their (row, vector) elements, so stores run
//    contiguously across rows, each lane takes U elements at once with
//    the next K positions loaded while the current K rows are in flight
//    (U x K independent row loads a lane), and the empty rows' zeros go
//    out while the first positions are in flight. Wider rows: one row at
//    a time, its positions loaded once into registers (at most kLongRun)
//    and shuffled to the lanes, 4 vectors a lane a pass, K positions at a
//    time (8 independent 16-byte loads a lane). __launch_bounds__(256, 4).
// 4. The wrapper stopped the host twice a call (a count of the valid ids
//    and unique_consecutive's size). The tile pointers have a fixed size
//    and need no count; the valid ids end at tile_ptr's last entry.
//
// The two kernels run side by side: the long kernel first, on a second
// stream forked from the caller's and joined back into it, so that the
// long chains start on an idle card and the tiles fill it around them
// (in one grid, a block of long runs held its slot from the tiles for
// the length of its longest chain, and the two together took far longer
// than either alone). The C entry is one launch of the op.
//
// Each output element is still one lane's serial sum in position order
// (no float atomics; an integer ballot or shared-memory bit mask changes
// no sum), so two runs give the same bits. The adds are the card's own:
// a float32 add, and for bf16 the packed bf16 add (add.rn.bf16x2, two
// elements a lane), which rounds the exact sum to nearest-even once. That
// equals the float32 add followed by a round to bf16 (the earlier
// round_to): float32 keeps 24 bits, at least twice bf16's 8 plus one, so
// the double rounding of a sum cannot differ from the single one
// (Figueroa's bound), subnormals included, as the two formats share
// their exponent range.
//
// ptxas (sm_90a): bag_tiles_kernel 64 registers at __launch_bounds__(256,
// 4), so 32 warps an SM (half the card's 64), with 4-28 bytes of spills
// by vector width, and 25,088 bytes of shared memory a block (8 warps of
// kTileSmem); bag_long_kernel 56-72 registers, no spills, 12,288 bytes
// a block of 64 threads (kPairSmem), up to 18 blocks an SM.
namespace {

// A run longer than this is a long run (the wrapper's LONG_RUN, and the
// sample spacing of the warps that find the long runs; the owner's start
// search probes 2 x 32 positions, so it is 64).
constexpr int kLongRun = 64;
// Chunks in flight in a long run's ring (a compile-time wait count).
constexpr int kStages = 8;
// Shared memory of a long run's pair of warps (its barriers and two
// rings), and of a tile's warp (its rows' starts, at most 257 of 8
// bytes, its list of touched rows and its empty-row mask).
constexpr int kPairSmem = 12288;
constexpr int kTileSmem = 3136;
constexpr int kMaxTile = 256;
// A tile with at most this many keys finds its rows' starts by scatter
// (one load of every key at once), a larger one by binary search.
constexpr int kScatterKeys = 256;

// acc += x, element by element, in the dtype (raw bits in and out).
template <typename T, int VB>
__device__ __forceinline__ void add_to(typename RawOf<VB>::type& acc,
                                       typename RawOf<VB>::type x) {
  constexpr int NW = VB >= 4 ? VB / 4 : 1;
  if constexpr (VB == 2) {                     // one bf16
    unsigned short r;
    asm("add.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(acc), "h"(x));
    acc = r;
  } else {
    unsigned a[NW], b[NW];
    to_words(acc, a);
    to_words(x, b);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (std::is_same<T, float>::value)
        a[i] = __float_as_uint(__fadd_rn(__uint_as_float(a[i]),
                                         __uint_as_float(b[i])));
      else
        asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(a[i]) : "r"(a[i]), "r"(b[i]));
    }
    acc = from_words<VB>(a);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Arrive (release: this thread's earlier shared-memory stores are seen by
// the waiter).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}
// Arrive once this thread's cp.async copies issued so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A long run, summed by a pair of warps of one block: the producer
// (odd warp) streams the run's rows into a ring of kStages chunks of `ch`
// rows in shared memory with cp.async, the consumer (even warp) adds
// them. Chunk g of the pair's runs (counted across runs and column
// groups, `g0` on entry) lives in row slot g % kStages; full[slot]
// completes a phase when its copies have landed (32 cp.async arrivals,
// and 32 plain ones that release the producer's misalignment bytes),
// empty[slot] when the consumer has read it. The producer's positions
// come through a ring of their own, kStages chunks ahead, with
// commit/wait groups: position group x carries chunk x + kStages's
// positions. Producer lane r copies row r of a chunk (ch <= 32), piece
// by piece; a slot keeps piece c of its rows together, so a consumer
// lane (its piece: vector v0 + lane) reads 16 / VB rows with one 16-byte
// load. 2-byte vectors keep whole rows (the words that cover them).
template <typename T, int VB>
__device__ void long_pair(const char* __restrict__ grad, int w,
                          const long long* __restrict__ pos, long long len,
                          int group_vecs, bool producer, char* pair,
                          long long& g0, char* out_row) {
  using V = Vec<T, VB>;
  constexpr int CP = VB < 4 ? 4 : VB;          // bytes of one copy
  constexpr int R = 16 / CP;                     // rows a consumer load
  const int lane = threadIdx.x & 31;
  const long long row_bytes = static_cast<long long>(w) * VB;
  // copies a row: nv vectors, or the 4-byte words that cover nv bf16
  const int cmax = VB < 4 ? (2 * group_vecs + 5) / 4 : group_vecs;
  const int rb = cmax * CP;
  const int ch = min(32, (kPairSmem - 16 * kStages) /
                             (kStages * (rb + 9))) & ~3;
  const uint32_t full = adaparse::smem_addr(pair);
  const uint32_t empty = full + 8 * kStages;
  long long* pring = reinterpret_cast<long long*>(pair + 16 * kStages);
  char* ring = pair + 16 * kStages + kStages * ch * 8;
  unsigned char* mis = reinterpret_cast<unsigned char*>(ring) +
                       kStages * ch * rb;      // 2-byte vectors: byte offset
  const long long n_chunks = (len + ch - 1) / ch;
  for (int v0 = 0; v0 < w; v0 += group_vecs, g0 += n_chunks) {
    const int nv = min(group_vecs, w - v0);
    const char* gsrc = grad + static_cast<long long>(v0) * VB;
    if (producer) {
      auto issue_pos = [&](long long x) {
        if (x < n_chunks &&
            lane < min(static_cast<long long>(ch), len - x * ch))
          adaparse::cp_async<8>(
              adaparse::smem_addr(pring + (x % kStages) * ch + lane),
              pos + x * ch + lane);
      };
      auto issue_rows = [&](long long x) {
        if (x >= n_chunks) return;
        const long long g = g0 + x;
        const int slot = static_cast<int>(g % kStages);
        if (g >= kStages)                        // the consumer freed it
          mbar_wait(empty + 8 * slot,
                    static_cast<unsigned>((g / kStages - 1) & 1));
        // lane r copies row r of the chunk, all its pieces
        if (lane < min(static_cast<long long>(ch), len - x * ch)) {
          const char* a = gsrc + pring[(x % kStages) * ch + lane] * row_bytes;
          if constexpr (VB >= 4) {
            char* dst = ring + (slot * cmax * ch + lane) * VB;
            for (int c = 0; c < nv; ++c)
              adaparse::cp_async<VB>(
                  adaparse::smem_addr(dst + c * ch * VB), a + c * VB);
          } else {
            char* dst = ring + (slot * ch + lane) * rb;
            const uintptr_t ua = reinterpret_cast<uintptr_t>(a);
            const char* a0 = reinterpret_cast<const char*>(ua & ~uintptr_t{3});
            mis[slot * ch + lane] = static_cast<unsigned char>(ua & 3);
            for (int c = 0; a0 + 4 * c < a + 2 * nv; ++c)   // covering words
              adaparse::cp_async<4>(adaparse::smem_addr(dst + 4 * c),
                                    a0 + 4 * c);
          }
        }
        mbar_arrive(full + 8 * slot);
        mbar_arrive_copies(full + 8 * slot);
      };
      for (int x = 0; x < kStages; ++x) issue_pos(x);
      adaparse::cp_async_commit();
      adaparse::cp_async_wait<0>();
      __syncwarp();
      for (long long x = 0; x < n_chunks; ++x) {
        if (x >= kStages) {
          adaparse::cp_async_wait<kStages - 1>();   // chunk x's positions
          __syncwarp();
        }
        issue_rows(x);
        __syncwarp();                // slot x's positions read before reuse
        issue_pos(x + kStages);
        adaparse::cp_async_commit();
      }
      adaparse::cp_async_wait<0>();
      __syncwarp();                  // the position ring is free again
    } else {
      typename V::raw acc = V::zero();
      const bool adder = lane < nv;
      for (long long c = 0; c < n_chunks; ++c) {
        const long long g = g0 + c;
        const int slot = static_cast<int>(g % kStages);
        mbar_wait(full + 8 * slot, static_cast<unsigned>((g / kStages) & 1));
        const int m = static_cast<int>(min(static_cast<long long>(ch),
                                           len - c * ch));
        if (adder) {
          if constexpr (VB >= 4) {
            const char* col = ring + (slot * cmax + lane) * ch * VB;
            for (int r = 0; r < m; r += 4 * R) {
              uint4 q[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (r + u * R < m)
                  q[u] = *reinterpret_cast<const uint4*>(col +
                                                         (r + u * R) * VB);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const typename V::raw* x =
                    reinterpret_cast<const typename V::raw*>(&q[u]);
#pragma unroll
                for (int i = 0; i < R; ++i)
                  if (r + u * R + i < m) add_to<T, VB>(acc, x[i]);
              }
            }
          } else {
            const char* base = ring + slot * ch * rb;
            for (int r = 0; r < m; r += 8) {
              typename V::raw x[8];
#pragma unroll
              for (int u = 0; u < 8; ++u)
                if (r + u < m)
                  x[u] = V::lds(base + (r + u) * rb +
                                mis[slot * ch + r + u] + 2 * lane);
#pragma unroll
              for (int u = 0; u < 8; ++u)
                if (r + u < m) add_to<T, VB>(acc, x[u]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * slot);
      }
      if (adder) V::st(out_row + static_cast<long long>(v0 + lane) * VB, acc);
    }
  }
}

// One block = one pair of warps (64 threads, kPairSmem bytes of shared
// memory) a unit u = blockIdx.x of 32 samples: the long runs at the
// sorted positions j * kLongRun, j in [32u, 32u + 32) (lane: j), that it
// owns (see the note above), one after another, column group by column
// group. Warp 1 is the producer.
template <typename T, int VB>
__global__ void __launch_bounds__(64)
bag_long_kernel(const char* __restrict__ grad, long long n_rows, int w,
                const long long* __restrict__ keys,
                const long long* __restrict__ perm, long long n_ids,
                int group_vecs, char* __restrict__ out) {
  extern __shared__ __align__(16) char pair_smem[];
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  const long long u = blockIdx.x;
  const long long pl = (32 * u + lane) * kLongRun;
  const long long kl = pl < n_ids ? __ldg(keys + pl) : n_rows;
  const bool own = kl < n_rows &&
                   (pl < kLongRun || __ldg(keys + pl - kLongRun) != kl);
  unsigned owners = __ballot_sync(adaparse::kFullMask, own);
  if (!owners) return;                           // the same in both warps
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(adaparse::smem_addr(pair_smem) + 8 * i, 64);
      mbar_init(adaparse::smem_addr(pair_smem) + 8 * (kStages + i), 1);
    }
  }
  __syncthreads();
  long long g0 = 0;
  while (owners) {
    const int o = __ffs(owners) - 1;
    owners &= owners - 1;
    const long long p = __shfl_sync(adaparse::kFullMask, pl, o);
    const long long k = __shfl_sync(adaparse::kFullMask, kl, o);
    // the run's start: in [lo, p], where the row's positions are a suffix
    const long long lo = p >= kLongRun ? p - kLongRun + 1 : 0;
    const long long q0 = lo + lane, q1 = lo + 32 + lane;
    const unsigned b0 =
        __ballot_sync(adaparse::kFullMask, q0 <= p && __ldg(keys + q0) == k);
    const unsigned b1 =
        __ballot_sync(adaparse::kFullMask, q1 <= p && __ldg(keys + q1) == k);
    const long long s = b0 ? lo + __ffs(b0) - 1 : lo + 32 + __ffs(b1) - 1;
    // its end: gallop up by 32-way probes, then narrow down
    long long base = p, stride = kLongRun, e;
    for (;;) {
      const long long q = base + stride * (lane + 1);
      const int t = __popc(__ballot_sync(adaparse::kFullMask,
                                         q < n_ids && __ldg(keys + q) == k));
      base += stride * t;                        // keys[base] == k
      if (t == 32) {
        stride *= 32;
      } else if (stride == 1) {
        e = base + 1;
        break;
      } else {
        stride = (stride + 31) / 32;
      }
    }
    if (e - s > kLongRun)                        // else a tile's warp has it
      long_pair<T, VB>(grad, w, perm + s, e - s, group_vecs, producer,
                       pair_smem, g0,
                       out + k * static_cast<long long>(w) * VB);
  }
}

// Zeros for the empty rows of a tile (rows_here rows of row_bytes at
// `obase`; bit r % 32 of emask[r / 32] marks row r empty), each byte
// stored once. Where the tile's bytes are 16-byte aligned, lanes lie flat
// over its 16-byte words: a word that holds only empty rows is one
// 16-byte store, another its empty rows' VB-byte vectors. Else lanes lie
// flat over the VB-byte vectors.
template <int VB>
__device__ __forceinline__ void zero_empty_rows(char* obase, int row_bytes,
                                                int rows_here,
                                                const unsigned* emask) {
  using Raw = typename RawOf<VB>::type;
  const int lane = threadIdx.x & 31;
  const int tb = rows_here * row_bytes;
  auto empty_row = [&](int r) {
    return ((emask[r >> 5] >> (r & 31)) & 1u) != 0;
  };
  if (((reinterpret_cast<uintptr_t>(obase) | static_cast<uintptr_t>(tb)) &
       15) == 0) {
    for (int b = 16 * lane; b < tb; b += 512) {
      const int first = b / row_bytes, last = (b + 15) / row_bytes;
      bool all = true;
      for (int r = first; r <= last; ++r) all = all && empty_row(r);
      if (all) {
        *reinterpret_cast<uint4*>(obase + b) = make_uint4(0, 0, 0, 0);
      } else {
        for (int i = 0; i < 16; i += VB)
          if (empty_row((b + i) / row_bytes))
            *reinterpret_cast<Raw*>(obase + b + i) = Raw{};
      }
    }
  } else {
    for (int f = lane; f < tb / VB; f += 32)
      if (empty_row(f * VB / row_bytes))
        *reinterpret_cast<Raw*>(obase + f * VB) = Raw{};
  }
}

// Rows of at most 32 vectors (sp[i]: row i's first sorted position,
// sp[rows_here] the tile's end): its rows of 1 .. kLongRun ids (a long
// run has its pair of warps) compacted into `list`, lanes flat over
// their (row, vector) elements: U elements a lane at once, K positions
// at a time with the next K loaded while the rows are in flight. The
// empty rows (emask) get their zeros (zero_empty_rows) while the first
// round's positions are in flight.
template <typename T, int VB>
__device__ void narrow_tile(const char* __restrict__ grad, int w,
                            const long long* __restrict__ perm,
                            const long long* sp, int* list, unsigned* emask,
                            long long r0, int rows_here,
                            char* __restrict__ out) {
  using V = Vec<T, VB>;
  constexpr int U = VB == 16 ? 2 : 4;
  constexpr int K = 2;
  const int lane = threadIdx.x & 31;
  const long long row_bytes = static_cast<long long>(w) * VB;
  char* obase = out + r0 * row_bytes;
  int n_t = 0;
  for (int g = 0; 32 * g < rows_here; ++g) {
    const int i = 32 * g + lane;
    const long long n = i < rows_here ? sp[i + 1] - sp[i] : -1;
    const unsigned e = __ballot_sync(adaparse::kFullMask, n == 0);
    if (lane == 0) emask[g] = e;
    const bool on = n > 0 && n <= kLongRun;
    const unsigned bal = __ballot_sync(adaparse::kFullMask, on);
    if (on) list[n_t + __popc(bal & ((1u << lane) - 1))] = i;
    n_t += __popc(bal);
  }
  __syncwarp();
  const int n_el = n_t * w;
  for (int f0 = 0; f0 < max(n_el, 1); f0 += 32 * U) {  // at least once
    long long s[U], fe[U];
    int len[U], v[U];
    int maxlen = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + 32 * u + lane;
      const bool ok = f < n_el;
      const int ti = ok ? f / w : 0;
      const int i = ok ? list[ti] : 0;
      v[u] = ok ? f - ti * w : 0;
      fe[u] = static_cast<long long>(i) * w + v[u];
      s[u] = sp[i];
      len[u] = ok ? static_cast<int>(sp[i + 1] - s[u]) : 0;
      maxlen = max(maxlen, len[u]);
    }
    typename V::raw acc[U];
    long long pc[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = V::zero();
#pragma unroll
      for (int k = 0; k < K; ++k)
        pc[u][k] = k < len[u] ? __ldg(perm + s[u] + k) : 0;
    }
    if (f0 == 0) zero_empty_rows<VB>(obase, w * VB, rows_here, emask);
    for (int j = 0; j < maxlen; j += K) {
      long long pn[U][K];
      typename V::raw x[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          pn[u][k] = j + K + k < len[u] ? __ldg(perm + s[u] + j + K + k) : 0;
          x[u][k] = j + k < len[u]
                        ? V::ldg(grad + pc[u][k] * row_bytes +
                                 static_cast<long long>(v[u]) * VB)
                        : V::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (j + k < len[u]) add_to<T, VB>(acc[u], x[u][k]);
          pc[u][k] = pn[u][k];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (len[u] > 0) V::st(obase + fe[u] * VB, acc[u]);
  }
}

// Rows of more than 32 vectors: one row at a time, its positions loaded
// once into registers (at most kLongRun: 2 a lane) and shuffled out,
// each pass 4 vectors a lane with K positions at a time.
template <typename T, int VB>
__device__ void wide_tile(const char* __restrict__ grad, int w,
                          const long long* __restrict__ perm,
                          const long long* sp, long long r0, int rows_here,
                          char* __restrict__ out) {
  using V = Vec<T, VB>;
  constexpr int Q = 4;
  constexpr int K = 2;
  const int lane = threadIdx.x & 31;
  const long long row_bytes = static_cast<long long>(w) * VB;
  for (int i = 0; i < rows_here; ++i) {
    const long long a = sp[i];
    const long long n = sp[i + 1] - a;
    if (n > kLongRun) continue;                  // a long run has its warp
    const int len = static_cast<int>(n);
    const long long pos0 = lane < len ? __ldg(perm + a + lane) : 0;
    const long long pos1 = lane + 32 < len ? __ldg(perm + a + 32 + lane) : 0;
    char* orow = out + (r0 + i) * row_bytes;
    for (int v0 = 0; v0 < w; v0 += 32 * Q) {
      typename V::raw acc[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = V::zero();
      for (int j = 0; j < len; j += K) {
        long long p[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int jj = j + k;                  // uniform over the warp
          p[k] = __shfl_sync(adaparse::kFullMask, jj < 32 ? pos0 : pos1,
                             jj & 31);
        }
        typename V::raw x[Q][K];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int vec = v0 + 32 * q + lane;
#pragma unroll
          for (int k = 0; k < K; ++k)
            x[q][k] = vec < w && j + k < len
                          ? V::ldg(grad + p[k] * row_bytes +
                                   static_cast<long long>(vec) * VB)
                          : V::zero();
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (j + k < len) add_to<T, VB>(acc[q], x[q][k]);
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int vec = v0 + 32 * q + lane;
        if (vec < w) V::st(orow + static_cast<long long>(vec) * VB, acc[q]);
      }
    }
  }
}

// A tile: rows [r0, r0 + rows_here), rows_here <= kMaxTile, keys
// [lo, hi).
template <typename T, int VB>
__device__ void row_tile(const char* __restrict__ grad, int w,
                         const long long* __restrict__ keys,
                         const long long* __restrict__ perm, long long lo,
                         long long hi, long long r0, int rows_here, char* ws,
                         char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  // sp[i]: row r0 + i's first sorted position, the lower bound of r0 + i
  // among the tile's keys [lo, hi); sp[rows_here] = hi
  const long long n = hi - lo;
  long long* sp = reinterpret_cast<long long*>(ws);
  if (n <= kScatterKeys) {
    // a few keys (a sparse table's tile): each run start writes its row's
    // entry (all loads at once), then a suffix minimum fills the rest
    for (int i = lane; i <= rows_here; i += 32) sp[i] = hi;
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kScatterKeys / 32; ++g) {
      const long long j = lo + lane + 32 * g;
      if (j < hi) {
        const long long k = __ldg(keys + j);
        if (j == lo || __ldg(keys + j - 1) != k) sp[k - r0] = j;
      }
    }
    __syncwarp();
    const int m = rows_here + 1, per = (m + 31) >> 5;
    const int b = min(m, lane * per), e = min(m, b + per);
    long long suf = hi;
    for (int i = e - 1; i >= b; --i) suf = min(suf, sp[i]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_down_sync(adaparse::kFullMask, suf, o);
      if (lane + o < 32) suf = min(suf, up);
    }
    long long cur = __shfl_down_sync(adaparse::kFullMask, suf, 1);
    if (lane == 31) cur = hi;
    for (int i = e - 1; i >= b; --i) {
      cur = min(cur, sp[i]);
      sp[i] = cur;
    }
  } else {
    // many keys: binary lifting, 8 rows a lane at once
    long long c[kMaxTile / 32];
#pragma unroll
    for (int g = 0; g < kMaxTile / 32; ++g) c[g] = 0;
    for (long long step = 1LL << (63 - __clzll(n)); step > 0; step >>= 1) {
#pragma unroll
      for (int g = 0; g < kMaxTile / 32; ++g) {
        const int i = lane + 32 * g;
        if (i < rows_here && c[g] + step <= n &&
            __ldg(keys + lo + c[g] + step - 1) < r0 + i)
          c[g] += step;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxTile / 32; ++g)
      if (lane + 32 * g < rows_here) sp[lane + 32 * g] = lo + c[g];
    if (lane == 0) sp[rows_here] = hi;
  }
  __syncwarp();
  if (w <= 32) {
    int* list = reinterpret_cast<int*>(sp + kMaxTile + 2);
    narrow_tile<T, VB>(grad, w, perm, sp, list,
                       reinterpret_cast<unsigned*>(list + kMaxTile), r0,
                       rows_here, out);
  } else {
    wide_tile<T, VB>(grad, w, perm, sp, r0, rows_here, out);
  }
}

// Warp t takes the output rows [t * tile, (t + 1) * tile), with
// kTileSmem bytes of shared memory.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, 4)
bag_tiles_kernel(const char* __restrict__ grad, long long n_rows, int w,
                 const long long* __restrict__ keys,
                 const long long* __restrict__ perm,
                 const long long* __restrict__ tile_ptr, int tile,
                 char* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const long long t = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) >> 5;
  const long long r0 = t * tile;
  if (r0 >= n_rows) return;
  row_tile<T, VB>(grad, w, keys, perm, __ldg(tile_ptr + t),
                  __ldg(tile_ptr + t + 1), r0,
                  static_cast<int>(min(static_cast<long long>(tile),
                                       n_rows - r0)),
                  smem + (threadIdx.x >> 5) * kTileSmem, out);
}

// The long kernel runs on a second stream beside the tiles, forked from
// and joined back into the caller's stream (a lock keeps the events of
// two callers apart).
struct SideStream {
  std::mutex lock;
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

SideStream& side_stream(int dev) {
  static SideStream sides[64];
  return sides[dev & 63];
}

template <typename T, int VB>
cudaError_t launch_backward(const void* grad, long long n_rows, int d,
                            const long long* keys, const long long* perm,
                            long long n_ids, const long long* tile_ptr,
                            int tile, void* out, cudaStream_t stream) {
  if (tile < 1 || tile > kMaxTile) return cudaErrorInvalidValue;
  const int w = static_cast<int>(d * sizeof(T) / VB);
  // a long run's column groups: about 64 bytes each, so its ring holds
  // ~80-200 rows (2-byte vectors: at most 30 bf16, 16 covering words)
  const int gmax = VB >= 4 ? 64 / VB : 30;
  const int n_groups = (w + gmax - 1) / gmax;
  const int group_vecs = (w + n_groups - 1) / n_groups;
  const long long n_units = (n_ids + 32LL * kLongRun - 1) / (32LL * kLongRun);
  const long long n_tiles = (n_rows + tile - 1) / tile;
  const long long tile_blocks =
      (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (n_units > 0x7fffffffLL || tile_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const char* g = static_cast<const char*>(grad);
  char* o = static_cast<char*>(out);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  SideStream& side = side_stream(dev);
  std::lock_guard<std::mutex> hold(side.lock);
  if (n_units > 0) {
    if (!side.stream) {
      err = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
      if (err != cudaSuccess) return err;
    }
    // first, so that the long chains take the card before the tiles
    err = cudaEventRecord(side.fork, stream);
    if (err == cudaSuccess)
      err = cudaStreamWaitEvent(side.stream, side.fork, 0);
    if (err != cudaSuccess) return err;
    bag_long_kernel<T, VB><<<static_cast<unsigned>(n_units), 64, kPairSmem,
                             side.stream>>>(g, n_rows, w, keys, perm, n_ids,
                                            group_vecs, o);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventRecord(side.join, side.stream);
    if (err != cudaSuccess) return err;
  }
  if (tile_blocks > 0) {
    bag_tiles_kernel<T, VB><<<static_cast<unsigned>(tile_blocks), kThreads,
                              kWarpsPerBlock * kTileSmem, stream>>>(
        g, n_rows, w, keys, perm, tile_ptr, tile, o);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_units > 0) return cudaStreamWaitEvent(stream, side.join, 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward_vec(const void* grad, long long n_rows, int d,
                                const long long* keys, const long long* perm,
                                long long n_ids, const long long* tile_ptr,
                                int tile, int vec_bytes, void* out,
                                cudaStream_t stream) {
  switch (vec_bytes) {
    case 16:
      return launch_backward<T, 16>(grad, n_rows, d, keys, perm, n_ids,
                                    tile_ptr, tile, out, stream);
    case 8:
      return launch_backward<T, 8>(grad, n_rows, d, keys, perm, n_ids,
                                   tile_ptr, tile, out, stream);
    case 4:
      return launch_backward<T, 4>(grad, n_rows, d, keys, perm, n_ids,
                                   tile_ptr, tile, out, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_backward<T, 2>(grad, n_rows, d, keys, perm, n_ids,
                                     tile_ptr, tile, out, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// grad (n_ids, d) contiguous rows, dtype 0 float32 or 1 bfloat16; keys
// (n_ids,) the ids wrapped into [0, n_rows] (n_rows: dropped) and sorted
// stably, perm (n_ids,) the positions they came from; tile_ptr
// (ceil(n_rows / tile) + 1,) the first sorted position whose key is at
// least min(t * tile, n_rows), 1 <= tile <= 256; out (n_rows, d)
// contiguous, every element written here. vec_bytes: 16, 8, 4 or 2 (2
// for bfloat16 only), dividing the row width in bytes and both base
// addresses.
ADAPARSE_EXPORT int adaparse_embedding_bag_backward(
    const void* grad, int dtype, long long n_rows, int d,
    const long long* keys, const long long* perm, long long n_ids,
    const long long* tile_ptr, int tile, int vec_bytes, void* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward_vec<float>(grad, n_rows, d, keys, perm, n_ids,
                                      tile_ptr, tile, vec_bytes, out, s);
  if (dtype == 1)
    return launch_backward_vec<__nv_bfloat16>(grad, n_rows, d, keys, perm,
                                              n_ids, tile_ptr, tile,
                                              vec_bytes, out, s);
  return cudaErrorInvalidValue;
}

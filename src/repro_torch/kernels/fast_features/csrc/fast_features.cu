// CLS-I fast features + first-page token/mask assembly, one block per
// document.
//
// Replaces: src/repro/kernels/fast_features/kernel.py :: fast_features_kernel
// (body _ff_kernel), the Pallas TPU kernel of the prepare stage.
//
// Bound on the H100: bytes. A document's padded stream is W int32 tokens
// (W = 2048..4096 on the main path), of which its n_tok valid ones are
// read once, plus 8 floats and an optional max_len-wide token/mask pair
// written once: a few MB per batch of 256 documents, under a microsecond
// of HBM time. What keeps a kernel this small from that floor is the
// chain of latencies inside a block: loads whose address waits on another
// load, atomics whose result a thread waits for, barriers, and float64
// arithmetic after the last barrier. The design shortens each link.
//
// Design. The TPU kernel counts distinct tokens with an O(W^2) blocked
// first-occurrence scan; here each block keeps a presence bitmap of
// ceil(vocab_size/32) words in shared memory (1.25 KB at the corpus
// vocabulary of 10000), every valid token sets its bit, and the distinct
// count is the bitmap's popcount, exact in O(W).
//   - Loads: the per-document scalars and each thread's first 16-byte
//     word of the row are issued together at the start (the word lies
//     inside the row whatever n_tok is); the rest of a thread's share
//     (up to kVec words, 4096 tokens a round for the block) is issued
//     before its first atomic, so the loads are in flight together.
//   - Atomics: a thread sets bits with atomicOr and never reads the result
//     (a fire-and-forget reduction), so no thread waits on the shared-memory
//     unit, however many lanes hit one word; after a barrier each thread
//     popcounts its share of the bitmap. Collapsing equal tokens within a
//     warp with __match_any_sync first, and counting a token as new when
//     its leader lane finds the bit clear, ran slower on the H100 at the
//     probe batch: match.any cost more than the serialised atomics it
//     saved.
//   - Counts: the six per-document counts (whitespace, scramble, mangled,
//     LaTeX, new, out of range) are reduced together: one redux.sync per
//     count in each warp, one barrier, then eight threads assemble one
//     feature each. The three features that need no count are computed
//     before the scan, while its loads are in flight.
//   - The first-page token/mask pair comes from the words already in
//     registers (the token before each word by a shuffle), written with
//     16-byte stores before the counting starts.
// The eight ratios and log1p are computed in double and rounded to float
// once, exactly as the float64 host oracle
// (src/repro/kernels/fast_features/ref.py) assembles them, so the kernel
// agrees with the plain version bit for bit. A token outside
// [0, vocab_size) sets *err; the wrapper reads it and raises.
//
// Launch shape: 256 threads per document. The probe batch's 256 blocks
// give each SM about two, so every block of the batch is resident at
// once and the kernel takes about one block's chain of latencies (512
// threads a block measured slower).
#include <stdint.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / adaparse::kWarp;
constexpr int kVec = 4;              // 16-byte words a thread loads a round
constexpr int kFeatures = 8;
// per-document counts: ws, scramble, mangled, latex, new, out of range
constexpr int kCounts = 6;

// Word q of a row of n ints: 16-byte load when aligned, else four loads
// of which those past n read -1. Words at or past n_words read -1s.
__device__ __forceinline__ int4 load_word(const int* __restrict__ row, int q,
                                          int n, int n_words, bool vec) {
  if (q >= n_words) return make_int4(-1, -1, -1, -1);
  if (vec) return reinterpret_cast<const int4*>(row)[q];
  const int p = 4 * q;
  return make_int4(row[p], p + 1 < n ? row[p + 1] : -1,
                   p + 2 < n ? row[p + 2] : -1, p + 3 < n ? row[p + 3] : -1);
}

__global__ void __launch_bounds__(kThreads)
fast_features_kernel(const int* __restrict__ tok, const int* __restrict__ n_tok,
                     const int* __restrict__ first_len,
                     const int* __restrict__ n_pages,
                     const int* __restrict__ n_empty, int width, int max_len,
                     int ws, int scramble, int mangled, int latex_lo,
                     int ident_lo, int vocab_size, int bos,
                     float* __restrict__ fast, int* __restrict__ toks,
                     float* __restrict__ mask, int* __restrict__ err) {
  extern __shared__ unsigned int present[];     // ceil(vocab/32) words
  __shared__ int warp_counts[kWarps][kCounts];
  const int doc = blockIdx.x;
  const int lane = threadIdx.x % adaparse::kWarp;
  const int warp = threadIdx.x / adaparse::kWarp;
  const int* row = tok + static_cast<size_t>(doc) * width;
  // rows are 16-byte aligned when the base is and width % 4 == 0
  const bool vec = (width % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(tok) % 16 == 0);

  // issued together: the per-document scalars and each thread's first
  // word of the row (inside the row, whatever n_tok is)
  const int f = threadIdx.x;                     // thread f < 8: feature f
  const int nt = n_tok[doc];
  const int fl = max_len > 0 ? first_len[doc] : 0;
  const int pg = f == 6 || f == 7 ? n_pages[doc] : 0;
  const int ne = f == 6 ? n_empty[doc] : 0;
  int4 v[kVec];
  v[0] = load_word(row, threadIdx.x, width, (width + 3) / 4, vec);
  const int n_words = (vocab_size + 31) / 32;
  for (int w = threadIdx.x; w < n_words; w += kThreads) present[w] = 0u;

  if (max_len > 0) {
    // stream head (= the first page, truncated) shifted one right under
    // BOS: toks[j] = row[j - 1] for 1 <= j <= m, BOS at 0, zero past m
    const int m = fl < max_len - 1 ? fl : max_len - 1;
    int* trow = toks + static_cast<size_t>(doc) * max_len;
    float* mrow = mask + static_cast<size_t>(doc) * max_len;
    // the words in registers cover the head: width >= max_len - 1 and
    // both multiples of 4 make width >= max_len
    const bool vec_out = vec && (max_len % 4 == 0) &&
                         (max_len <= 4 * kThreads) &&
                         ((reinterpret_cast<uintptr_t>(toks) |
                           reinterpret_cast<uintptr_t>(mask)) % 16 == 0);
    if (vec_out) {
      const int q = threadIdx.x, j = 4 * q;
      int prev = __shfl_up_sync(adaparse::kFullMask, v[0].w, 1);
      if (q < max_len / 4) {
        if (j == 0)
          prev = bos;
        else if (lane == 0)
          prev = row[j - 1];
        const int4 t = make_int4(j <= m ? prev : 0, j + 1 <= m ? v[0].x : 0,
                                 j + 2 <= m ? v[0].y : 0,
                                 j + 3 <= m ? v[0].z : 0);
        const float4 k = make_float4(j <= m, j + 1 <= m, j + 2 <= m,
                                     j + 3 <= m);
        reinterpret_cast<int4*>(trow)[q] = t;
        reinterpret_cast<float4*>(mrow)[q] = k;
      }
    } else {
      for (int j = threadIdx.x; j < max_len; j += kThreads) {
        const bool keep = j <= m;
        trow[j] = !keep ? 0 : (j == 0 ? bos : row[j - 1]);
        mrow[j] = keep ? 1.0f : 0.0f;
      }
    }
  }

  // the features that need no count, while the loads are in flight
  double x = 0.0;
  if (f == 0)
    x = log1p(static_cast<double>(nt)) / 10.0;
  else if (f == 6)
    x = ne / static_cast<double>(pg > 1 ? pg : 1);
  else if (f == 7)
    x = pg / 10.0;

  const int n_valid = min(max(nt, 0), width);    // the plain version's mask
  const int n_quads = (n_valid + 3) / 4;
  int c[kCounts] = {0, 0, 0, 0, 0, 0};
  __syncthreads();                               // bitmap zeroed
  for (int q0 = 0; q0 < n_quads; q0 += kThreads * kVec) {
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (u > 0 || q0 > 0)               // round 0's first word is in v[0]
        v[u] = load_word(row, q0 + u * kThreads + threadIdx.x, n_valid,
                         n_quads, vec);
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if (q0 + u * kThreads >= n_quads) break;
      const int q = q0 + u * kThreads + threadIdx.x;
      const int t4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t4[e];
        const bool valid = 4 * q + e < n_valid;
        c[0] += valid && t == ws;
        c[1] += valid && t == scramble;
        c[2] += valid && t == mangled;
        c[3] += valid && t >= latex_lo && t < ident_lo;
        const bool in_vocab = valid && t >= 0 && t < vocab_size;
        c[5] |= valid && !in_vocab;
        if (in_vocab) atomicOr(&present[t >> 5], 1u << (t & 31));
      }
    }
  }
  __syncthreads();                               // every bit set
  for (int w = threadIdx.x; w < n_words; w += kThreads)
    c[4] += __popc(present[w]);
#pragma unroll
  for (int k = 0; k < kCounts; ++k) {
    const int s = __reduce_add_sync(adaparse::kFullMask, c[k]);
    if (lane == 0) warp_counts[warp][k] = s;
  }
  __syncthreads();

  // thread f assembles feature f; thread 0 also raises the flag
  if (f < kFeatures) {
    if (f >= 1 && f <= 5) {
      int c_f = 0;
      for (int w = 0; w < kWarps; ++w) c_f += warp_counts[w][f - 1];
      x = c_f / static_cast<double>(nt > 1 ? nt : 1);
    } else if (f == 0) {
      int bad = 0;
      for (int w = 0; w < kWarps; ++w) bad += warp_counts[w][5];
      if (bad) atomicOr(err, 1);
    }
    fast[static_cast<size_t>(doc) * kFeatures + f] =
        nt == 0 ? 0.0f : static_cast<float>(x);  // empty: the zero row
  }
}

}  // namespace

// tok (n, width) int32; n_tok/first_len/n_pages/n_empty (n,) int32;
// fast (n, 8) float32; toks/mask (n, max_len) (unused when max_len == 0);
// err (1,) int32, zeroed by the caller. Returns cudaGetLastError().
ADAPARSE_EXPORT int adaparse_fast_features(
    const void* tok, const void* n_tok, const void* first_len,
    const void* n_pages, const void* n_empty, int n, int width, int max_len,
    int ws, int scramble, int mangled, int latex_lo, int ident_lo,
    int vocab_size, int bos, void* fast, void* toks, void* mask, void* err,
    void* stream) {
  const size_t smem = static_cast<size_t>((vocab_size + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fast_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fast_features_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const int*>(n_tok),
      static_cast<const int*>(first_len), static_cast<const int*>(n_pages),
      static_cast<const int*>(n_empty), width, max_len, ws, scramble, mangled,
      latex_lo, ident_lo, vocab_size, bos, static_cast<float*>(fast),
      static_cast<int*>(toks), static_cast<float*>(mask),
      static_cast<int*>(err));
  return static_cast<int>(cudaGetLastError());
}

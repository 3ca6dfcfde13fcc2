// Per-document BLEU of a padded (B, L) batch of hypothesis/reference
// token streams: the quality probe's scorer.
//
// Replaces: src/repro/kernels/ngram_score/kernel.py :: ngram_bleu_kernel
// (bodies _ngram_bleu_kernel and _score_one), the Pallas TPU kernel behind
// ops.ngram_bleu.
//
// Bound on the H100: operations. Each document reads 2 * L int32 once
// (2 KB at the probe's L = 256) but tests every hypothesis start against
// every reference start and every earlier hypothesis start: about
// 1.5 * L^2 start pairs (~10^5 per document), all from shared memory. The
// card's floor for that work is far below a microsecond; what bounds the
// kernel is the SMs' integer issue rate (64 lanes a clock on Hopper for
// compares, selects and adds), so the design spends as few instructions
// per start pair as it can and keeps every warp busy to the end.
//
// Design. The TPU kernel materialises the (L, L) hyp-hyp and hyp-ref
// equality matrices and extends them per order by a shifted AND. Here the
// 32 lanes of a warp take 32 consecutive starts j, and the warp scans them
// for kStarts = 4 hypothesis starts i at once, their grams h[i .. i+N-1]
// in registers: one shared-memory load of s[j] serves all four. Lane j
// tests the order-1 match h[i] == s[j] for each start, packs the four
// results into one byte each of a word, and one redux.sync sums the word
// over the warp: four counts (at most 32 each) for one instruction, where
// a __ballot_sync and a __popc would give one. Longer orders are tested
// only while some lane still matches (a warp-uniform test, so the lanes
// never diverge); text's sparse matches make the unigram test most of the
// work. Words that lie wholly inside every bound skip the bound tests.
// The scan of the reference gives rc[n] (an order n + 1 gram at j fits
// iff j + n < lr); the scan of the earlier hypothesis starts j < i gives
// occ[n], and is skipped when no unigram of the four occurs in the
// reference (every rc[n] is 0 then). Lane 8g + o keeps the counts of
// order o + 1 for start g, so a warp's counts are two registers a lane.
// The occurrence at i is creditable iff occ[n] < rc[n] (the clipped-count
// rule of the TPU kernel). Both rows sit in shared memory with kPad ints
// after them: a lane past a stream's end reads there, or the next row,
// under a false predicate, so the -1 padding never counts.
//
// Launch shape: one document per block of 24 warps, N = max_n a template
// argument. The warps take starts four at a time from a shared counter,
// the latest first: their hyp-hyp scans are the longest, so the warps
// finish together however the matches fall. The probe's 256 documents put
// two blocks on each of 124 SMs (one on the other 8): 48 resident warps
// an SM, which __launch_bounds__(768, 2) pays for with at most 40
// registers a thread (N <= 4; longer orders take one block an SM). More
// warps (32 a block, 64 an SM) would cap registers at 32 and spill the
// four grams; the integer pipes, not latency, set the pace at 48. The
// credits of all orders are reduced together (one shared atomic per
// order and lane group, one barrier); thread 0 assembles log precision,
// the brevity penalty and the empty-hypothesis zero in float32 in the
// order the TPU kernel does.
#include <stdint.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kMaxN = 8;
constexpr int kThreads = 768;
// hypothesis starts a warp scans at once: lane 8g + o counts order o + 1
// of start g, a byte g of each packed sum
constexpr int kStarts = 4;
static_assert(kStarts * kMaxN == adaparse::kWarp, "a lane per start and order");
// ints of shared memory past the hyp row: a lane past a stream's end
// reads up to 32 + kMaxN - 2 ints beyond it (under a false predicate)
constexpr int kPad = 40;
constexpr float kSmooth = 1e-9f;

// Copies n ints of a global row into shared memory, 16 bytes a thread
// when both rows and n allow it.
__device__ __forceinline__ void load_row(int* __restrict__ dst,
                                         const int* __restrict__ src, int n,
                                         bool vec4) {
  if (vec4) {
    const int n4 = (n + 3) / 4;
    for (int q = threadIdx.x; q < n4; q += kThreads)
      reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(src)[q];
  } else {
    for (int p = threadIdx.x; p < n; p += kThreads) dst[p] = src[p];
  }
}

// One 32-start word of the scan of stream s (length len) for the warp's
// kStarts hypothesis starts, whose grams are w[g][0 .. N-1]. Lane j takes
// start base + lane; start g counts the starts j < lim[g] (lr against the
// reference, the start itself against the earlier hypothesis starts),
// and an order n + 1 gram at j fits iff j + n < len. Each order's matches
// of all kStarts starts are summed in one redux.sync of a packed word (a
// byte per start, at most 32 each); lane 8g + o adds its start g's count
// of order o + 1. Longer orders are tested only while some lane still
// matches (a warp-uniform test). Full: every start of the word and its
// longest gram lie inside every bound, so no bound is tested.
template <int N, bool Full>
__device__ __forceinline__ void scan_word(const int* __restrict__ s, int len,
                                          int base, const int (&lim)[kStarts],
                                          const int (&w)[kStarts][N],
                                          int lane, int& count) {
  const int j = base + lane;
  const int o = lane % 8;
  // byte lane / 8 of a packed sum, as a __byte_perm selector
  const unsigned pick = 0x4440u + lane / 8;
  const int t = s[j];
  bool m[kStarts];
  unsigned packed = 0u;
#pragma unroll
  for (int g = 0; g < kStarts; ++g) {
    m[g] = t == w[g][0] && (Full || j < lim[g]);
    packed += m[g] ? 1u << (8 * g) : 0u;
  }
  unsigned sum = __reduce_add_sync(adaparse::kFullMask, packed);
  if (o == 0) count += __byte_perm(sum, 0u, pick);
#pragma unroll
  for (int n = 1; n < N; ++n) {
    if (sum == 0u) break;
    const int tn = s[j + n];
    packed = 0u;
#pragma unroll
    for (int g = 0; g < kStarts; ++g) {
      m[g] = m[g] && tn == w[g][n] && (Full || j + n < len);
      packed += m[g] ? 1u << (8 * g) : 0u;
    }
    sum = __reduce_add_sync(adaparse::kFullMask, packed);
    if (o == n) count += __byte_perm(sum, 0u, pick);
  }
}

// Scan of the starts [0, max lim) of stream s in 32-start words: whole
// words without bound tests, then the tail.
template <int N>
__device__ __forceinline__ void scan(const int* __restrict__ s, int len,
                                     const int (&lim)[kStarts],
                                     const int (&w)[kStarts][N], int lane,
                                     int& count) {
  int lo = lim[0], hi = lim[0];
#pragma unroll
  for (int g = 1; g < kStarts; ++g) {
    lo = min(lo, lim[g]);
    hi = max(hi, lim[g]);
  }
  const int full = min(lo, len - N + 1);
  int base = 0;
  for (; base + adaparse::kWarp <= full; base += adaparse::kWarp)
    scan_word<N, true>(s, len, base, lim, w, lane, count);
  for (; base < hi; base += adaparse::kWarp)
    scan_word<N, false>(s, len, base, lim, w, lane, count);
}

template <int N>
__global__ void __launch_bounds__(kThreads, N <= 4 ? 2 : 1)
ngram_bleu_kernel(const int* __restrict__ ref, const int* __restrict__ hyp,
                  const int* __restrict__ lr_p, const int* __restrict__ lh_p,
                  int max_len, float* __restrict__ out) {
  extern __shared__ int4 rows4[];          // ref row, hyp row, kPad ints
  __shared__ int clipped[kMaxN];
  __shared__ int taken;                    // starts handed out so far
  int* r = reinterpret_cast<int*>(rows4);
  int* h = r + max_len;
  const int doc = blockIdx.x;
  const int lr = min(max(lr_p[doc], 0), max_len);
  const int lh = min(max(lh_p[doc], 0), max_len);
  // 16-byte copies read whole words up to 3 ints past a length, never
  // past max_len (a multiple of 4 there)
  const bool vec4 = (max_len % 4 == 0) &&
                    ((reinterpret_cast<uintptr_t>(ref) |
                      reinterpret_cast<uintptr_t>(hyp)) % 16 == 0);
  load_row(r, ref + static_cast<size_t>(doc) * max_len, lr, vec4);
  load_row(h, hyp + static_cast<size_t>(doc) * max_len, lh, vec4);
  if (threadIdx.x < kMaxN) clipped[threadIdx.x] = 0;
  if (threadIdx.x == 0) taken = 0;
  __syncthreads();

  const int lane = threadIdx.x % adaparse::kWarp;
  const int o = lane % 8;                  // this lane counts order o + 1
  const int mine = lane / 8;               // ... of the warp's start `mine`
  int credit = 0;
  for (;;) {
    // the next kStarts starts, latest first: i0, i0 - 1, ...
    int t = 0;
    if (lane == 0) t = atomicAdd(&taken, kStarts);
    const int i0 = lh - 1 - __shfl_sync(adaparse::kFullMask, t, 0);
    if (i0 < 0) break;
    int start[kStarts], lim_r[kStarts];
    int w[kStarts][N];                     // orders past a start's kmax
#pragma unroll                             // are never credited
    for (int g = 0; g < kStarts; ++g) {
      start[g] = max(i0 - g, 0);           // a start < 0 repeats start 0
      lim_r[g] = lr;
#pragma unroll
      for (int n = 0; n < N; ++n) w[g][n] = h[start[g] + n];
    }
    int rc = 0, occ = 0;                   // this lane's order at its start
    scan<N>(r, lr, lim_r, w, lane, rc);
    if (__any_sync(adaparse::kFullMask, o == 0 && rc != 0))
      scan<N>(h, lh, start, w, lane, occ); // else every rc is 0: no credit
    const int kmax = min(N, lh - (i0 - mine));
    credit += i0 - mine >= 0 && o < kmax && occ < rc;
  }
  if (o < N) atomicAdd(&clipped[o], credit);
  __syncthreads();

  if (threadIdx.x == 0) {
    float log_p = 0.0f;
    for (int n = 0; n < N; ++n) {
      const int total = max(lh - n, 0);     // lh - (n + 1) + 1
      log_p += logf((static_cast<float>(clipped[n]) + kSmooth)
                    / static_cast<float>(max(total, 1)));
    }
    log_p /= static_cast<float>(N);
    const float bp = fminf(1.0f, expf(1.0f - static_cast<float>(lr)
                                      / static_cast<float>(max(lh, 1))));
    out[doc] = lh > 0 ? bp * expf(log_p) : 0.0f;
  }
}

template <int N>
int launch(const void* ref, const void* hyp, const void* lr, const void* lh,
           int b, int max_len, void* out, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(max_len) + kPad) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ngram_bleu_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ngram_bleu_kernel<N><<<b, kThreads, smem, stream>>>(
      static_cast<const int*>(ref), static_cast<const int*>(hyp),
      static_cast<const int*>(lr), static_cast<const int*>(lh), max_len,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ref, hyp (b, max_len) int32; lr, lh (b,) int32; out (b,) float32.
// 1 <= max_n <= 8; 2 * max_len int32 must fit the block's shared memory.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another max_n).
ADAPARSE_EXPORT int adaparse_ngram_bleu(const void* ref, const void* hyp,
                                        const void* lr, const void* lh,
                                        int b, int max_len, int max_n,
                                        void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (max_n) {
    case 1: return launch<1>(ref, hyp, lr, lh, b, max_len, out, st);
    case 2: return launch<2>(ref, hyp, lr, lh, b, max_len, out, st);
    case 3: return launch<3>(ref, hyp, lr, lh, b, max_len, out, st);
    case 4: return launch<4>(ref, hyp, lr, lh, b, max_len, out, st);
    case 5: return launch<5>(ref, hyp, lr, lh, b, max_len, out, st);
    case 6: return launch<6>(ref, hyp, lr, lh, b, max_len, out, st);
    case 7: return launch<7>(ref, hyp, lr, lh, b, max_len, out, st);
    case 8: return launch<8>(ref, hyp, lr, lh, b, max_len, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Per-document BLEU-4 of a padded (B, L) batch of hypothesis/reference
// token streams: the quality probe's scorer.
//
// Replaces: src/repro/kernels/ngram_score/kernel.py :: ngram_bleu_kernel
// (bodies _ngram_bleu_kernel and _score_one), the Pallas TPU kernel behind
// ops.ngram_bleu.
//
// Bound on the H100: operations. Each document reads 2 * L int32 once
// (2 KB at the probe's L = 256) but compares every hypothesis start with
// every reference start and every earlier hypothesis start: about
// 1.5 * L^2 integer comparisons (~10^5 per document), all from shared
// memory. The design keeps both rows in shared memory, where the inner
// loop's reference/earlier-hypothesis reads are warp-wide broadcasts.
//
// Design. The TPU kernel materialises the (L, L) hyp-hyp and hyp-ref
// equality matrices and extends them per n-gram order by a shifted AND.
// Here thread i owns hypothesis start i and, for every start j, computes
// the common-prefix length k (capped at max_n) of hyp[i:] against ref[j:]
// and, for j < i, against hyp[j:]; every order n <= k matches. Prefixes
// never read past a stream's length, so the -1 padding is never compared.
// rc[n] counts reference occurrences of the hypothesis n-gram at i (j <=
// lr - n) and occ[n] its earlier hypothesis occurrences (j <= lh - n); the
// occurrence at i is creditable iff occ[n] < rc[n] (the clipped-count
// rule of the TPU kernel). A block reduction sums the credits per order,
// and thread 0 assembles log precision, the brevity penalty and the
// empty-hypothesis zero in float32, as the TPU kernel does.
#include "../../csrc/common.cuh"

namespace {

constexpr int kMaxN = 8;
constexpr float kSmooth = 1e-9f;

__global__ void ngram_bleu_kernel(const int* __restrict__ ref,
                                  const int* __restrict__ hyp,
                                  const int* __restrict__ lr_p,
                                  const int* __restrict__ lh_p, int max_len,
                                  int max_n, float* __restrict__ out) {
  extern __shared__ int rows[];            // ref row, then hyp row
  __shared__ int scratch[adaparse::kWarp + 1];
  int* r = rows;
  int* h = rows + max_len;
  const int doc = blockIdx.x;
  const int lr = min(max(lr_p[doc], 0), max_len);
  const int lh = min(max(lh_p[doc], 0), max_len);
  for (int p = threadIdx.x; p < max_len; p += blockDim.x) {
    r[p] = ref[static_cast<size_t>(doc) * max_len + p];
    h[p] = hyp[static_cast<size_t>(doc) * max_len + p];
  }
  __syncthreads();

  int credit[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) credit[n] = 0;

  for (int i = threadIdx.x; i < lh; i += blockDim.x) {
    int rc[kMaxN], occ[kMaxN];
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) rc[n] = occ[n] = 0;
    const int kmax_i = min(max_n, lh - i);    // longest gram starting at i
    for (int j = 0; j < lr; ++j) {
      const int kmax = min(kmax_i, lr - j);
      int k = 0;
      while (k < kmax && h[i + k] == r[j + k]) ++k;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) rc[n] += n < k;
    }
    for (int j = 0; j < i; ++j) {             // j < i <= lh - k
      int k = 0;
      while (k < kmax_i && h[i + k] == h[j + k]) ++k;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) occ[n] += n < k;
    }
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) credit[n] += (n < kmax_i) && (occ[n] < rc[n]);
  }

  float log_p = 0.0f;
  for (int n = 0; n < max_n; ++n) {
    const int clipped = adaparse::block_sum(credit[n], scratch);
    const int total = max(lh - n, 0);         // lh - (n + 1) + 1
    log_p += logf((static_cast<float>(clipped) + kSmooth)
                  / static_cast<float>(max(total, 1)));
  }
  if (threadIdx.x == 0) {
    log_p /= static_cast<float>(max_n);
    const float bp = fminf(1.0f, expf(1.0f - static_cast<float>(lr)
                                      / static_cast<float>(max(lh, 1))));
    out[doc] = lh > 0 ? bp * expf(log_p) : 0.0f;
  }
}

}  // namespace

// ref, hyp (b, max_len) int32; lr, lh (b,) int32; out (b,) float32.
// 1 <= max_n <= 8. Returns cudaGetLastError().
ADAPARSE_EXPORT int adaparse_ngram_bleu(const void* ref, const void* hyp,
                                        const void* lr, const void* lh,
                                        int b, int max_len, int max_n,
                                        void* out, void* stream) {
  int threads = ((max_len + adaparse::kWarp - 1) / adaparse::kWarp) * adaparse::kWarp;
  threads = threads < 1024 ? threads : 1024;
  const size_t smem = 2 * static_cast<size_t>(max_len) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ngram_bleu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ngram_bleu_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ref), static_cast<const int*>(hyp),
      static_cast<const int*>(lr), static_cast<const int*>(lh), max_len,
      max_n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// CLS-I fast features + first-page token/mask assembly, one block per
// document.
//
// Replaces: src/repro/kernels/fast_features/kernel.py :: fast_features_kernel
// (body _ff_kernel), the Pallas TPU kernel of the prepare stage.
//
// Bound on the H100: bytes. A document's padded stream is W int32 tokens
// (W = 2048..4096 on the main path) read once, plus 8 floats and an
// optional max_len-wide token/mask pair written once: a few MB per batch
// of 256 documents, well under a microsecond of HBM time, so at the
// main-path size the launch itself dominates. The design keeps every
// token read coalesced (threads stride the row) and never re-reads it.
//
// Design. The TPU kernel counts distinct tokens with an O(W^2) blocked
// first-occurrence scan; here each block keeps a presence bitmap of
// ceil(vocab_size/32) words in shared memory (1.25 KB at the corpus
// vocabulary of 10000) and a token is new iff atomicOr finds its bit
// clear, so the count is exact in O(W). Per-document integer counts come
// from block reductions. The eight ratios and log1p are computed in
// double and rounded to float once, exactly as the float64 host oracle
// (src/repro/kernels/fast_features/ref.py) assembles them, so the kernel
// agrees with the plain version bit for bit. A token outside
// [0, vocab_size) sets *err; the wrapper reads it and raises.
#include "../../csrc/common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFeatures = 8;

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
  __shared__ int scratch[adaparse::kWarp + 1];
  const int doc = blockIdx.x;
  const int n_words = (vocab_size + 31) / 32;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) present[w] = 0u;
  __syncthreads();

  const int nt = n_tok[doc];
  const int* row = tok + static_cast<size_t>(doc) * width;
  int c_ws = 0, c_scr = 0, c_man = 0, c_latex = 0, c_new = 0, bad = 0;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int t = row[i];
    c_ws += (t == ws);
    c_scr += (t == scramble);
    c_man += (t == mangled);
    c_latex += (t >= latex_lo) & (t < ident_lo);
    if (t < 0 || t >= vocab_size) {
      bad = 1;
    } else {
      const unsigned bit = 1u << (t & 31);
      const unsigned old = atomicOr(&present[t >> 5], bit);
      c_new += (old & bit) == 0u;
    }
  }
  c_ws = adaparse::block_sum(c_ws, scratch);
  c_scr = adaparse::block_sum(c_scr, scratch);
  c_man = adaparse::block_sum(c_man, scratch);
  c_latex = adaparse::block_sum(c_latex, scratch);
  c_new = adaparse::block_sum(c_new, scratch);
  bad = adaparse::block_sum(bad, scratch);

  if (threadIdx.x == 0) {
    if (bad) atomicOr(err, 1);
    float* out = fast + static_cast<size_t>(doc) * kFeatures;
    if (nt == 0) {                     // empty-extraction signature row
      for (int f = 0; f < kFeatures; ++f) out[f] = 0.0f;
    } else {
      const double denom = static_cast<double>(nt);   // nt >= 1 here
      const int pg = n_pages[doc];
      const double pg_denom = static_cast<double>(pg > 1 ? pg : 1);
      out[0] = static_cast<float>(log1p(static_cast<double>(nt)) / 10.0);
      out[1] = static_cast<float>(c_ws / denom);
      out[2] = static_cast<float>(c_scr / denom);
      out[3] = static_cast<float>(c_man / denom);
      out[4] = static_cast<float>(c_latex / denom);
      out[5] = static_cast<float>(c_new / denom);
      out[6] = static_cast<float>(n_empty[doc] / pg_denom);
      out[7] = static_cast<float>(pg / 10.0);
    }
  }

  if (max_len > 0) {
    // stream head (= the first page, truncated) shifted one right under BOS
    const int fl = first_len[doc];
    const int m = fl < max_len - 1 ? fl : max_len - 1;
    int* trow = toks + static_cast<size_t>(doc) * max_len;
    float* mrow = mask + static_cast<size_t>(doc) * max_len;
    for (int j = threadIdx.x; j < max_len; j += blockDim.x) {
      const bool keep = j <= m;
      trow[j] = !keep ? 0 : (j == 0 ? bos : row[j - 1]);
      mrow[j] = keep ? 1.0f : 0.0f;
    }
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

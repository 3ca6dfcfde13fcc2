// Forward flash attention with GQA, causal and sliding-window masks: the
// dense LM's prefill attention (attention_impl="pallas").
//
// Replaces: src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_kernel (body _fa_kernel), the Pallas TPU kernel behind
// ops.flash_attention.
//
// Semantics, as the TPU kernel and ref.py compute them: q (B, Sq, H, D),
// k and v (B, Skv, Hk, D), read through their strides in that layout;
// query head h reads KV head h / (H / Hk) (contiguous groups). Positions
// start at 0 for queries and keys alike, also when Sq != Skv; key kpos is
// visible to query qpos iff kpos < Skv, (not causal or qpos >= kpos) and
// (no window or qpos - kpos < window). Scores are the float32 sums of
// the q.k products, scaled by 1/sqrt(D); masked scores are the finite
// -1e30, the softmax weights p stay float32 through the PV product, and
// the normaliser is floored at 1e-30. Only the output is rounded to q's
// type.
//
// Bound on the H100: operations. At the LM's prefill shape (B=4, S=4096,
// H=16, Hk=8, D=128, causal, bf16) the function does 4*D FLOPs for each
// of the B*H*S(S+1)/2 visible (query, key) pairs, 2.75e11 in all, against
// 201 MB moved: 0.28 ms at the bf16 tensor-core peak and 0.06 ms at HBM
// rate.
//
// Two bodies, chosen by dtype (a dtype always takes the same body):
//
// bfloat16: tensor cores (wgmma, sm_90a). One block of two warpgroups
// (8 warps) per (128-row query tile, query head, batch); each warpgroup
// owns 64 rows, both read the same K and V tiles, and two blocks fit an
// SM (96 KB of shared memory and 128 registers a thread at D <= 128).
// Q is copied once into shared memory and K and V tiles of 64 keys go
// through a two-stage ring, all with 16-byte cp.async (zero-filled past
// D and past the sequence); one barrier a tile, after which the copies
// of tile t+1 are issued while tile t's S = Q K^T runs. A view whose rows
// are not 16-byte aligned is copied element by element instead. The
// tiles are kept as 8 x 8 core matrices (hopper.cuh), with D zero-padded
// to the instantiation's width DP (64, 128, 192 or 256). S is m64n64k16
// wgmmas with both operands in shared memory (bf16 products are exact
// in float32, so only the order of the sum differs from the TPU kernel's
// float32 dot), scaled in float32 afterwards. The online softmax runs on
// the accumulator fragments: each thread holds two rows' 16 scores, row
// maxima are reduced across the quad with shuffles, and a masked entry
// gets p = 0 outright; a tile inside the causal, window and sequence
// bounds for all its rows takes a mask-free body. A row with no visible
// key yet keeps m hugely negative (-1e30 times the scale), l = 0 and a
// zero accumulator, never the NaN of exp(-inf - -inf); once a visible
// key arrives the result is the reference's, whose masked terms are
// exp(-1e30 - m) = 0 exactly; a row with no visible key at all gets
// zeros (the reference's uniform average over masked keys is outside the
// kernel's contract, as it is the TPU kernel's). l sums the float32 p.
// O += P V keeps p at float32 precision: p_hi = bf16(p) and
// p_lo = bf16(p - p_hi) are the register A operands of two wgmmas over
// the same V tile (read MN-major, trans-b), so the output stays within
// the bf16 rounding of the float32-p result at 1.5x the tensor work of a
// bf16-p design; each 16-key slice's wgmmas are issued as soon as its p
// is split, so the tensor cores start on P V while later slices are
// split. O accumulates in float32 registers and is rounded to bf16 once,
// as o / max(l, 1e-30).
//
// float32: the CUDA cores, float32 FMAs (TF32 would break the 2e-5 bar).
// One block of 4 warps per (64-row query tile, query head, batch); each
// warp owns 16 query rows. K tiles are staged transposed and V tiles as
// they are in shared memory, with keys past Skv and dims past D
// zero-filled. Per tile, lane j scores keys j and j + 32 for the warp's
// 16 rows, the online softmax keeps m and l per row in registers, p goes
// through shared memory, and lane j accumulates output dims j + 32 * i.
//
// Both bodies walk only the 64-key tiles that the block's rows can see
// (the causal and window bounds give the range), and visit query tiles
// heaviest first (last query tile first) to shorten the causal tail; a
// warpgroup skips the tiles that none of its own rows can see.
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../csrc/common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;                       // query rows of a warpgroup
//                                                   (tensor cores), of a block (f32)
constexpr int kBlockK = 64;                       // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * adaparse::kWarp;
constexpr int kRowsPerWarp = kBlockQ / kWarps;    // 16
constexpr int kMaxHeadDim = 256;
constexpr int kKtStride = kBlockK + 1;            // padded row of K^T
constexpr float kNegInf = -1e30f;                 // the reference's mask value
constexpr float kMinDenom = 1e-30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv, h, hk, d, dp;                      // dp: d rounded up to 4
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;                             // window 0: none
  float scale;
  int vec;                                        // rows 16-byte aligned
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = adaparse::kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(adaparse::kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = adaparse::kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(adaparse::kFullMask, v, o);
  return v;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.skv && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

size_t smem_bytes_f32(int dp) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * dp + kBlockQ * kBlockK +
                          static_cast<size_t>(dp) * kKtStride + kBlockK * dp);
}

// NJ = ceil(D / 32): output dims held per lane.
template <int NJ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = p.dp;
  float* qs = reinterpret_cast<float*>(smem);              // [kBlockQ][dp]
  float* ps = qs + kBlockQ * dp;                           // [kBlockQ][kBlockK]
  float* kt = ps + kBlockQ * kBlockK;                      // [dp][kKtStride]
  float* vs = kt + dp * kKtStride;                         // [kBlockK][dp]

  const int lane = threadIdx.x % adaparse::kWarp;
  const int row0 = (threadIdx.x / adaparse::kWarp) * kRowsPerWarp;
  const int b = blockIdx.z, hh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;   // heaviest first
  const int kvh = hh / (p.h / p.hk);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = threadIdx.x; i < kBlockQ * dp; i += kThreads) {
    const int r = i / dp, c = i - r * dp;
    const int qpos = q0 + r;
    qs[i] = (qpos < p.sq && c < p.d) ? qg[qpos * p.q_ss + c] : 0.f;
  }

  // key tiles any row of this query tile can see
  const int q_last = min(q0 + kBlockQ, p.sq) - 1;
  const int k_hi = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / kBlockK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBlockK - 1) / kBlockK : t_lo;

  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][NJ];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[r][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();                     // last tile's kt/vs reads are done
    for (int i = threadIdx.x; i < kBlockK * dp; i += kThreads) {
      const int c = i / dp, dd = i - c * dp;
      const int kpos = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kpos < p.skv && dd < p.d) {
        kx = kg[kpos * p.k_ss + dd];
        vx = vg[kpos * p.v_ss + dd];
      }
      kt[dd * kKtStride + c] = kx;
      vs[c * dp + dd] = vx;
    }
    __syncthreads();

    // scores: lane owns keys k0 + lane and k0 + lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int dd = 0; dd < dp; dd += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = kt[(dd + i) * kKtStride + lane];
        kb[i] = kt[(dd + i) * kKtStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[(row0 + r) * dp + dd]);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kb[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kb[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kb[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kb[3], s[r][1]);
      }
    }

    // online softmax; masked entries get p = 0
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + row0 + r;
      const bool ok0 = visible(p, qpos, k0 + lane);
      const bool ok1 = visible(p, qpos, k0 + lane + 32);
      const float s0 = ok0 ? s[r][0] * p.scale : kNegInf;
      const float s1 = ok1 ? s[r][1] * p.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[r] - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[r][j] *= alpha;
      ps[(row0 + r) * kBlockK + lane] = p0;
      ps[(row0 + r) * kBlockK + lane + 32] = p1;
    }
    __syncwarp();                        // the warp's p rows are written

    // o += p @ v: lane owns dims lane + 32 * j
    for (int c = 0; c < kBlockK; c += 4) {
      float vv[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int dd = lane + 32 * j;
          vv[i][j] = dd < dp ? vs[(c + i) * dp + dd] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&ps[(row0 + r) * kBlockK + c]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          o[r][j] = fmaf(pv.x, vv[0][j], o[r][j]);
          o[r][j] = fmaf(pv.y, vv[1][j], o[r][j]);
          o[r][j] = fmaf(pv.z, vv[2][j], o[r][j]);
          o[r][j] = fmaf(pv.w, vv[3][j], o[r][j]);
        }
      }
    }
  }

  float* og = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= p.sq) continue;
    const float denom = fmaxf(l[r], kMinDenom);
    float* orow = og + ((static_cast<long long>(b) * p.sq + qpos) * p.h + hh) * p.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int dd = lane + 32 * j;
      if (dd < p.d) orow[dd] = o[r][j] / denom;
    }
  }
}


// ---------------------------------------------------------------- bf16

namespace tc {

namespace hw = adaparse::hopper;
using bf16 = __nv_bfloat16;

constexpr int kWG = 2;                            // consumer warpgroups
constexpr int kThreads = kWG * 128;               // each owns 64 query rows
constexpr int kBlockQT = kWG * kBlockQ;           // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

// Key tiles [lo, hi) that rows [q0, q0 + rows) can see (causal and
// window bounds); an empty range when q0 >= Sq.
__device__ __forceinline__ void tile_range(const Params& p, int q0, int rows,
                                           int* lo, int* hi) {
  const int q_last = min(q0 + rows, p.sq) - 1;
  const int k_hi = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *lo = k_lo / kBlockK;
  *hi = q0 < p.sq && k_hi > k_lo ? (k_hi + kBlockK - 1) / kBlockK : *lo;
}

template <int DP>
__host__ __device__ constexpr int tile_bytes() { return kBlockQ * DP * 2; }

// Q (one 64 x DP tile per warpgroup), and two stages each of K and V
template <int DP>
constexpr size_t smem_bytes() {
  return (kWG + 4) * static_cast<size_t>(tile_bytes<DP>());
}

// Copies rows [row0, row0 + 64) of a (rows, D) bf16 matrix with row
// stride `ss` into a 64 x DP core-matrix tile at shared address `dst`,
// zero past D and past `nrows`. Thread i of the block copies 16-byte
// pieces i, i + kThreads, ...; piece j lands at byte 16 j.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g,
                                          int row0, int nrows, long long ss,
                                          int d, bool vec) {
  constexpr int kChunks = DP / 8;
  constexpr int kIters = kBlockQ * kChunks / kThreads;
  static_assert(kIters * kThreads == kBlockQ * kChunks, "DP % 32 != 0");
  // piece i: row (i >> 3) / kChunks * 8 + (i & 7), chunk (i >> 3) % kChunks
  auto piece = [&](int i, int* n) {
    const int rest = i >> 3;
    const int col = (rest % kChunks) * 8;
    const int pos = row0 + (rest / kChunks) * 8 + (i & 7);
    *n = pos < nrows ? max(0, min(8, d - col)) : 0;
    return g + (*n ? pos * ss + col : 0);
  };
  if (vec) {
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = threadIdx.x + j * kThreads;
      int n;
      const bf16* src = piece(i, &n);
      adaparse::cp_async<16>(dst + 16 * i, src, 2 * n);
    }
  } else {
    for (int j = 0; j < kIters; ++j) {
      const int i = threadIdx.x + j * kThreads;
      int n;
      const bf16* src = piece(i, &n);
      alignas(16) bf16 x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = e < n ? src[e] : __float2bfloat16(0.f);
      const uint4 u = *reinterpret_cast<const uint4*>(x);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + 16 * i),
                   "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
                   : "memory");
    }
  }
}

// One tile of the online softmax on a thread's S fragment (value 4 j + e
// is row row0 + 8 (e >> 1), key col0 + 8 j + (e & 1)), first part:
// masks S (kMask: test each entry's visibility; a masked score becomes
// -1e30), updates the row maxima m (log2 domain) and rescales this
// thread's part of l; returns the accumulator's rescale alpha.
template <bool kMask>
__device__ __forceinline__ void softmax_max(const Params& p, float (&s)[32],
                                            float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], int row0,
                                            int col0, float scale2) {
  float mx[2] = {kNegInf, kNegInf};               // raw row maxima
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (kMask && !visible(p, row0 + 8 * ((i & 3) >> 1),
                          col0 + 8 * (i >> 2) + (i & 1)))
      s[i] = kNegInf;
    mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(adaparse::kFullMask, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(adaparse::kFullMask, mx[r], 2));
    // the scale is positive, so the scaled maximum is the maximum of the
    // scaled scores; a row with no visible key yet stays hugely negative
    // (l and o stay 0)
    mx[r] = fmaxf(m[r], mx[r] * scale2);
    alpha[r] = hw::exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
}

// Second part, for key slice kk (16 keys: n chunks 2 kk and 2 kk + 1):
// p = 2^(s scale2 - m), 0 for a masked score, added to l and split into
// bf16 hi and lo halves, the A fragments of two P V products.
template <bool kMask>
__device__ __forceinline__ void softmax_split(const float (&s)[32],
                                              const float (&m)[2],
                                              float (&l)[2], int kk,
                                              uint32_t (&phi)[4],
                                              uint32_t (&plo)[4],
                                              float scale2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = 2 * kk + h;
    float pj[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = hw::exp2_approx(fmaf(s[4 * j + e], scale2, -m[e >> 1]));
      pj[e] = kMask && s[4 * j + e] == kNegInf ? 0.f : x;
      l[e >> 1] += pj[e];
    }
    const __nv_bfloat162 hi0 = __floats2bfloat162_rn(pj[0], pj[1]);
    const __nv_bfloat162 hi1 = __floats2bfloat162_rn(pj[2], pj[3]);
    phi[2 * h] = *reinterpret_cast<const uint32_t*>(&hi0);
    phi[2 * h + 1] = *reinterpret_cast<const uint32_t*>(&hi1);
    plo[2 * h] = hw::pack_bf16(pj[0] - __low2float(hi0),
                               pj[1] - __high2float(hi0));
    plo[2 * h + 1] = hw::pack_bf16(pj[2] - __low2float(hi1),
                                   pj[3] - __high2float(hi1));
  }
}

// P V for one tile: each key slice's p is split, then its two wgmmas per
// 64-wide output group are issued while the next slice's p is computed.
template <bool kMask, int DP>
__device__ __forceinline__ void pv_tile(const float (&s)[32],
                                        const float (&m)[2], float (&l)[2],
                                        float (&o)[DP / 64][32], uint32_t v,
                                        float scale2) {
  constexpr uint32_t kRowGroup = DP * 16;
  uint32_t phi[4][4], plo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    softmax_split<kMask>(s, m, l, kk, phi[kk], plo[kk], scale2);
    hw::wgmma_fence();
#pragma unroll
    for (int g = 0; g < DP / 64; ++g) {
      const uint64_t dv = hw::desc(v + 2 * kk * kRowGroup + g * 8 * 128,
                                   kRowGroup, 128);
      hw::wgmma_rs_n64_tb(o[g], phi[kk], dv);
      hw::wgmma_rs_n64_tb(o[g], plo[kk], dv);
    }
  }
  hw::wgmma_commit();
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    flash_fwd_tc_kernel(Params p) {
  constexpr int kTile = tile_bytes<DP>();
  constexpr int kNG = DP / 64;                    // 64-wide output groups
  constexpr uint32_t kRowGroup = DP * 16;         // bytes between 8-row groups
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = adaparse::smem_addr(smem);  // one tile per warpgroup
  const uint32_t ks = qs + kWG * kTile;           // two stages
  const uint32_t vs = ks + 2 * kTile;             // two stages

  const int wg = threadIdx.x / 128;               // warpgroup
  const int warp = threadIdx.x % 128 / adaparse::kWarp;   // warp in it
  const int lane = threadIdx.x % adaparse::kWarp;
  const int b = blockIdx.z, hh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQT;  // heaviest first
  const int kvh = hh / (p.h / p.hk);
  const bool vec = p.vec;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // key tiles any row of the block can see, and those of this
  // warpgroup's rows (an empty range for rows past Sq)
  int t_lo, t_hi, w_lo, w_hi;
  tile_range(p, q0, kBlockQT, &t_lo, &t_hi);
  const int qw = q0 + wg * kBlockQ;               // this warpgroup's first row
  tile_range(p, qw, kBlockQ, &w_lo, &w_hi);

#pragma unroll
  for (int w = 0; w < kWG; ++w)
    load_tile<DP>(qs + w * kTile, qg, q0 + w * kBlockQ, p.sq, p.q_ss, p.d, vec);
  if (t_lo < t_hi) {
    load_tile<DP>(ks, kg, t_lo * kBlockK, p.skv, p.k_ss, p.d, vec);
    load_tile<DP>(vs, vg, t_lo * kBlockK, p.skv, p.v_ss, p.d, vec);
  }
  adaparse::cp_async_commit();

  // this thread's rows (of the block's 64) and columns of each 8-wide
  // n chunk of an accumulator fragment: value 4 j + e is row
  // r0 + 8 (e >> 1), column 8 j + c0 + (e & 1)
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float scale2 = p.scale * kLog2e;          // exp(x) = exp2(x log2 e)
  float o[kNG][32];
#pragma unroll
  for (int g = 0; g < kNG; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[g][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's part

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    adaparse::cp_async_wait<0>();                 // tile t (and Q) landed
    hw::fence_proxy_async();
    // one barrier a tile: tile t is in shared memory for both warpgroups,
    // and both are done with tile t - 1, whose stage is refilled next
    __syncthreads();
    auto prefetch = [&] {                         // tile t + 1 into the other stage
      if (t + 1 < t_hi) {
        load_tile<DP>(ks + (stage ^ 1) * kTile, kg, (t + 1) * kBlockK, p.skv,
                      p.k_ss, p.d, vec);
        load_tile<DP>(vs + (stage ^ 1) * kTile, vg, (t + 1) * kBlockK, p.skv,
                      p.v_ss, p.d, vec);
      }
      adaparse::cp_async_commit();
    };
    if (t < w_lo || t >= w_hi) {                  // no visible key for our rows
      prefetch();
      continue;
    }
    // S = Q K^T (64 x 64), float32, while the next tile's copies are issued
    float s[32];
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hw::wgmma_ss_n64(s, hw::desc(qs + wg * kTile + kk * 256, 128, kRowGroup),
                       hw::desc(ks + stage * kTile + kk * 256, 128, kRowGroup),
                       kk > 0);
    hw::wgmma_commit();
    hw::fence_regs(s);
    prefetch();
    hw::wgmma_wait_all();
    hw::fence_regs(s);

    // online softmax on the fragment, in the log2 domain; a tile that
    // every row sees whole takes the mask-free body
    const int k0 = t * kBlockK;
    const bool full = k0 + kBlockK <= p.skv &&
                      (!p.causal || qw >= k0 + kBlockK - 1) &&
                      (p.window <= 0 || qw + kBlockQ - 1 - k0 < p.window);
    float alpha[2];
    if (full)
      softmax_max<false>(p, s, m, l, alpha, qw + r0, k0 + c0, scale2);
    else
      softmax_max<true>(p, s, m, l, alpha, qw + r0, k0 + c0, scale2);
#pragma unroll
    for (int g = 0; g < kNG; ++g)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[g][i] *= alpha[(i & 3) >> 1];

    // O += P_hi V + P_lo V
    if (full)
      pv_tile<false, DP>(s, m, l, o, vs + stage * kTile, scale2);
    else
      pv_tile<true, DP>(s, m, l, o, vs + stage * kTile, scale2);
    hw::wgmma_wait_all();
#pragma unroll
    for (int g = 0; g < kNG; ++g) hw::fence_regs(o[g]);
  }

  // o / max(l, 1e-30), rounded to bf16 once
  bf16* og = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(adaparse::kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(adaparse::kFullMask, l[r], 2);
    const int qpos = qw + r0 + 8 * r;
    if (qpos >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[r], kMinDenom);
    bf16* orow = og + ((static_cast<long long>(b) * p.sq + qpos) * p.h + hh) * p.d;
#pragma unroll
    for (int g = 0; g < kNG; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * g + 8 * j + c0;
        const float x0 = o[g][4 * j + 2 * r] * inv;
        const float x1 = o[g][4 * j + 2 * r + 1] * inv;
        if (col + 1 < p.d && !(p.d & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < p.d) orow[col] = __float2bfloat16(x0);
          if (col + 1 < p.d) orow[col + 1] = __float2bfloat16(x1);
        }
      }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)     // all of L1 as shared memory: 2 blocks an SM
    err = cudaFuncSetAttribute(flash_fwd_tc_kernel<DP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockQT - 1) / kBlockQT, p.h, b);
  flash_fwd_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

size_t dynamic_smem(int d) {
  switch ((d + 63) / 64) {
    case 1: return smem_bytes<64>();
    case 2: return smem_bytes<128>();
    case 3: return smem_bytes<192>();
    case 4: return smem_bytes<256>();
    default: return 0;
  }
}

cudaError_t dispatch(const Params& p, int b, cudaStream_t stream) {
  switch ((p.d + 63) / 64) {
    case 1: return launch<64>(p, b, stream);
    case 2: return launch<128>(p, b, stream);
    case 3: return launch<192>(p, b, stream);
    case 4: return launch<256>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------- float32 launch

template <int NJ>
cudaError_t launch_f32(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32(p.dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.h, b);
  flash_fwd_kernel<NJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, int b, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch_f32<1>(p, b, stream);
    case 2: return launch_f32<2>(p, b, stream);
    case 3: return launch_f32<3>(p, b, stream);
    case 4: return launch_f32<4>(p, b, stream);
    case 5: return launch_f32<5>(p, b, stream);
    case 6: return launch_f32<6>(p, b, stream);
    case 7: return launch_f32<7>(p, b, stream);
    case 8: return launch_f32<8>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, long long a, long long b, long long c) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && a % 8 == 0 &&
         b % 8 == 0 && c % 8 == 0;
}

}  // namespace

// dtype: 0 float32 (the CUDA-core body), 1 bfloat16 (the tensor-core
// body); q, k, v and out alike. Strides are in elements, for the batch,
// sequence and head axes; the head dim is contiguous. out is a contiguous
// (B, Sq, H, D) buffer. window 0 means none. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
ADAPARSE_EXPORT int adaparse_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int b,
    int sq, int skv, int h, int hk, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || skv <= 0 || h <= 0 || h > 65535 ||
      hk <= 0 || h % hk || d <= 0 || d > kMaxHeadDim || window < 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int vec = aligned16(q, q_sb, q_ss, q_sh) &&
                  aligned16(k, k_sb, k_ss, k_sh) &&
                  aligned16(v, v_sb, v_ss, v_sh);
  Params p{q, k, v, out, sq, skv, h, hk, d, (d + 3) / 4 * 4,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           causal, window, scale, vec};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_f32(p, b, st) : tc::dispatch(p, b, st);
}

// Dynamic shared memory, in bytes, that a launch of the body for `dtype`
// (as above) asks for at head dim d; 0 for a d the kernel does not take.
ADAPARSE_EXPORT long long adaparse_flash_attention_smem(int dtype, int d) {
  if (d <= 0 || d > kMaxHeadDim) return 0;
  return static_cast<long long>(dtype == 0 ? smem_bytes_f32((d + 3) / 4 * 4)
                                           : tc::dynamic_smem(d));
}

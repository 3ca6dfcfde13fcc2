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
// (no window or qpos - kpos < window). q, k and v are taken to float32,
// scores are scaled by 1/sqrt(D), masked scores are the finite -1e30, the
// softmax weights p stay float32 through the PV product, and the
// normaliser is floored at 1e-30. Only the output is rounded to q's type.
//
// Bound on the H100: operations. At the LM's prefill shape (B=4, S=4096,
// H=16, Hk=8, D=128, causal, bf16) the function does 4*D FLOPs for each
// of the B*H*S(S+1)/2 visible (query, key) pairs, 2.75e11 in all, against
// 201 MB moved: 0.28 ms at the bf16 tensor-core peak and 0.06 ms at HBM
// rate.
//
// Design (a first, simple kernel on the CUDA cores, float32 FMAs; it runs
// far from that bound, and tensor cores are later work). One block of 4
// warps per (64-row query tile, query head, batch); each warp owns 16
// query rows. The block walks only the 64-key tiles that its rows can see
// (the causal and window bounds give the range), staging each K tile
// transposed and each V tile in shared memory, with keys past Skv and
// dims past D zero-filled, so the ragged edges need no padded copies. Per
// tile, lane j scores keys j and j + 32 for the warp's 16 rows (query
// rows are float4 broadcasts from shared memory), the online softmax
// keeps m and l per row in registers, p goes through shared memory, and
// lane j accumulates output dims j + 32 * i in registers. A masked entry
// contributes p = 0 outright: a row that meets a tile in which all its
// keys are masked keeps m = -1e30, l = 0 and a zero accumulator, never
// the NaN of exp(-inf - -inf); once a visible key arrives the result is
// the reference's, whose masked terms are exp(-1e30 - m) = 0 exactly. A
// row with no visible key at all gets zeros (the reference's uniform
// average over masked keys is outside the kernel's contract, as it is
// the TPU kernel's). Tiles are visited heaviest first (last query tile
// first) to shorten the causal tail.
#include <cuda_bf16.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kBlockQ = 64;                       // query rows per block
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
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);                     // round to nearest even
}

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

template <typename T>
size_t smem_bytes(int dp) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * dp + kBlockQ * kBlockK) +
         sizeof(T) * (static_cast<size_t>(dp) * kKtStride + kBlockK * dp);
}

// NJ = ceil(D / 32): output dims held per lane.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = p.dp;
  float* qs = reinterpret_cast<float*>(smem);              // [kBlockQ][dp]
  float* ps = qs + kBlockQ * dp;                           // [kBlockQ][kBlockK]
  T* kt = reinterpret_cast<T*>(ps + kBlockQ * kBlockK);    // [dp][kKtStride]
  T* vs = kt + dp * kKtStride;                             // [kBlockK][dp]

  const int lane = threadIdx.x % adaparse::kWarp;
  const int row0 = (threadIdx.x / adaparse::kWarp) * kRowsPerWarp;
  const int b = blockIdx.z, hh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;   // heaviest first
  const int kvh = hh / (p.h / p.hk);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = threadIdx.x; i < kBlockQ * dp; i += kThreads) {
    const int r = i / dp, c = i - r * dp;
    const int qpos = q0 + r;
    qs[i] = (qpos < p.sq && c < p.d) ? to_float(qg[qpos * p.q_ss + c]) : 0.f;
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
      T kx = from_float<T>(0.f), vx = from_float<T>(0.f);
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
        ka[i] = to_float(kt[(dd + i) * kKtStride + lane]);
        kb[i] = to_float(kt[(dd + i) * kKtStride + lane + 32]);
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
          vv[i][j] = dd < dp ? to_float(vs[(c + i) * dp + dd]) : 0.f;
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

  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= p.sq) continue;
    const float denom = fmaxf(l[r], kMinDenom);
    T* orow = og + ((static_cast<long long>(b) * p.sq + qpos) * p.h + hh) * p.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int dd = lane + 32 * j;
      if (dd < p.d) orow[dd] = from_float<T>(o[r][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.h, b);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int b, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<T, 1>(p, b, stream);
    case 2: return launch<T, 2>(p, b, stream);
    case 3: return launch<T, 3>(p, b, stream);
    case 4: return launch<T, 4>(p, b, stream);
    case 5: return launch<T, 5>(p, b, stream);
    case 6: return launch<T, 6>(p, b, stream);
    case 7: return launch<T, 7>(p, b, stream);
    case 8: return launch<T, 8>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike). Strides are in
// elements, for the batch, sequence and head axes; the head dim is
// contiguous. out is a contiguous (B, Sq, H, D) buffer. window 0 means
// none. Launches on `stream`, allocates nothing, returns cudaGetLastError().
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
  Params p{q, k, v, out, sq, skv, h, hk, d, (d + 3) / 4 * 4,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           causal, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(p, b, st)
                    : dispatch<__nv_bfloat16>(p, b, st);
}

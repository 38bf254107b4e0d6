// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (fedml_tpu/ops/flash_attention.py:32, launched by `_flash_forward` at
// :68 through pl.pallas_call at :83). Same function: scaled-dot-product
// attention over [B, T, H, D] inputs with an online softmax carried in
// f32 across key tiles, causal masking with -1e30, fully masked key tiles
// skipped, and two outputs: O [B, T, H, D] in the input dtype and the
// per-row log-sum-exp lse = m + log(max(l, 1e-30)) as f32 [B, H, T].
//
// Bound on an H100: causal attention at the serving shapes (T 4096, D 64)
// does ~2*T*D flops per byte it must move, far above the card's balance
// point, so it is bound by operations. f32 inputs are computed in full
// f32 on the CUDA cores (67 TFLOP/s peak; TF32 would lose the precision
// the JAX kernel keeps); bf16 inputs could reach the tensor cores, which
// this first version does not use.
//
// Design (simple and right first): one 256-thread block per
// (64-row query tile, batch*head). The query tile, one 64-key K/V tile and
// the 64x64 score tile live in shared memory as f32; each thread owns a
// 4x4 patch of scores and a 4x(D/16) patch of the output accumulator; four
// threads share each row's softmax state (running max m, normaliser l)
// and reduce with warp shuffles. Inputs are read through their strides
// (last stride 1), so q/k/v views cut from one fused qkv projection need
// no copy. wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, t, h;  // element strides of batch, time and head; D is unit-stride
};

template <int D>
struct Smem {
  static constexpr int kQ = D + 1;        // padded rows: conflict-free column reads
  static constexpr int kK = D + 1;
  static constexpr int kS = kBlockK + 1;
  static constexpr int kFloats =
      kBlockQ * kQ + kBlockK * kK + kBlockK * D + kBlockQ * kS + kBlockQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Copies rows [t0, t0 + 64) of one (batch, head) slice into shared memory
// as f32, zero-filling rows past the end of the sequence (a zero V row
// keeps 0 * garbage from turning into NaN).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int t0, int seq_len) {
  for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int t = t0 + r;
    dst[r * ld + c] = t < seq_len ? to_f32(src[t * row_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq_len, int heads,
                 Strides qs, Strides ks, Strides vs, float scale, int causal) {
  using S = Smem<D>;
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                         // [64][D+1]
  float* k_s = q_s + kBlockQ * S::kQ;        // [64][D+1]
  float* v_s = k_s + kBlockK * S::kK;        // [64][D]
  float* s_s = v_s + kBlockK * D;            // [64][65] scores, then probabilities
  float* row_s = s_s + kBlockQ * S::kS;      // [64] per-row rescale, then normaliser

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  // score / output mapping: rows ty*4 .. ty*4+3, columns tx + 16*j
  const int ty = tid >> 4, tx = tid & 15;
  // softmax mapping: four threads per row, adjacent lanes
  const int srow = tid >> 2, spart = tid & 3;

  load_tile<T, D>(q_s, S::kQ, qb, qs.t, q0, seq_len);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  float m_i = kNegInf, l_i = 0.f;

  int n_kt = (seq_len + kBlockK - 1) / kBlockK;
  if (causal) n_kt = min(n_kt, (q0 + kBlockQ + kBlockK - 1) / kBlockK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile's readers are done with k_s / v_s / s_s
    load_tile<T, D>(k_s, S::kK, kb, ks.t, k0, seq_len);
    load_tile<T, D>(v_s, D, vb, vs.t, k0, seq_len);
    __syncthreads();

    // scores: s = (q . k) * scale, masked
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * S::kQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * S::kK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool masked = kpos >= seq_len || (causal && kpos > q0 + r);
        s_s[r * S::kS + c] = masked ? kNegInf : s[i][j] * scale;
      }
    }
    __syncthreads();

    // online softmax over this tile, one row per four lanes
    {
      float* row = s_s + srow * S::kS;
      float mx = kNegInf;
      for (int j = spart; j < kBlockK; j += 4) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      float sum = 0.f;
      for (int j = spart; j < kBlockK; j += 4) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_i - m_new);
      l_i = l_i * corr + sum;
      m_i = m_new;
      if (spart == 0) row_s[srow] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty * 4 + i) * S::kS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_s[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  __syncthreads();  // every reader of row_s's rescale factors is done
  if (spart == 0) {
    const float l = fmaxf(l_i, 1e-30f);
    row_s[srow] = l;
    const int t = q0 + srow;
    if (t < seq_len) lse[(long long)bh * seq_len + t] = m_i + logf(l);
  }
  __syncthreads();

  // O is allocated contiguous [B, T, H, D]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = q0 + r;
    if (t >= seq_len) continue;
    const float l = row_s[r];
    T* orow = o + (((long long)b * seq_len + t) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(orow + tx + 16 * c, acc[i][c] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int seq_len, int heads, Strides qs, Strides ks, Strides vs, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq_len, heads, qs, ks, vs, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v, void* o,
                 float* lse, int batch, int seq_len, int heads, Strides qs, Strides ks,
                 Strides vs, float scale, int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code of the
// launch (0 = cudaSuccess); the caller raises on anything else.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int dtype, int batch, int seq_len, int heads, int head_dim,
                        long long q_sb, long long q_st, long long q_sh, long long k_sb,
                        long long k_st, long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(head_dim, q, k, v, o, lse_f, batch, seq_len, heads, qs, ks,
                               vs, scale, causal, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, lse_f, batch, seq_len, heads,
                                       qs, ks, vs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash attention for head dims above 128, forward and backward, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// The route of `_flash_kernel` (fedml_tpu/ops/flash_attention.py:32,
// pl.pallas_call at :83) and of its backward `_bwd` (:140-175) for the
// head dims the tensor-core kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) do not take: 129 to 512. Same function and
// outputs: O [B, T, H, D] in the input dtype and lse = m + log(max(l,
// 1e-30)) as f32 [B, H, T]; dQ, dK, dV from the saved lse by the
// FlashAttention-2 recompute. f32 or bf16 inputs; every product and sum
// in f32; no atomics, so two runs agree bitwise.
//
// The design is the simple one: one warp per row, each lane holding
// kNE = ceil(D / 32) of the row's elements (element d in lane d % 32, slot
// d / 32, so a warp's loads of a row are coalesced) in registers, and
// every dot product finished by a butterfly of shuffles.
// - Forward (`rows_fwd_kernel`): a warp per query row walks the keys up to
//   the causal end with an online softmax, one key at a time.
// - Backward: `rows_dq_kernel`, a warp per query row, computes the row's
//   delta = dO . O (kept for the next kernel) and dQ over the keys;
//   `rows_dkdv_kernel`, a warp per key row, computes dK and dV over the
//   queries from the causal start.
// K and V rows (Q and dO rows in dK/dV) are read from global memory by
// every warp that needs them, through L1 and L2; nothing is staged in
// shared memory and no tensor core runs. Its speed is far below the
// tensor-core kernels'; it exists so that every D the reference takes up
// to 512 runs on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps (rows) per block
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, t, h;  // element strides of batch, time and head; D is unit-stride
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// The kNE elements of this lane of one row (zero past D)
template <int kNE, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int D, int lane,
                                         float (&x)[kNE]) {
#pragma unroll
  for (int i = 0; i < kNE; ++i) {
    const int d = lane + 32 * i;
    x[i] = d < D ? load1(row + d) : 0.f;
  }
}

template <int kNE, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ row, int D, int lane,
                                          const float (&x)[kNE], float mul) {
#pragma unroll
  for (int i = 0; i < kNE; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store1(row + d, x[i] * mul);
  }
}

template <int kNE, typename T>
__device__ __forceinline__ float dot_row(const T* __restrict__ row, int D, int lane,
                                         const float (&x)[kNE]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kNE; ++i) {
    const int d = lane + 32 * i;
    if (d < D) acc = fmaf(x[i], load1(row + d), acc);
  }
  return warp_sum(acc);
}

template <int kNE, typename T>
__device__ __forceinline__ void axpy_row(const T* __restrict__ row, int D, int lane, float a,
                                         float (&acc)[kNE]) {
#pragma unroll
  for (int i = 0; i < kNE; ++i) {
    const int d = lane + 32 * i;
    if (d < D) acc[i] = fmaf(a, load1(row + d), acc[i]);
  }
}

struct Shape {
  int batch, seq_len, heads, head_dim;
};

// The (b, h, t) of this warp's row, rows ordered (b, h) major, t fastest;
// false past the last row
__device__ __forceinline__ bool warp_row(const Shape& s, int& b, int& h, int& t) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)s.batch * s.heads * s.seq_len) return false;
  t = (int)(row % s.seq_len);
  const long long bh = row / s.seq_len;
  h = (int)(bh % s.heads);
  b = (int)(bh / s.heads);
  return true;
}

template <typename T, int kNE>
__global__ void __launch_bounds__(kThreads)
rows_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, Shape s, Strides qs, Strides ks,
                Strides vs, float scale, int causal) {
  int b, h, t;
  if (!warp_row(s, b, h, t)) return;
  const int lane = threadIdx.x & 31, D = s.head_dim;
  float qr[kNE], acc[kNE];
  load_row<kNE>(q + b * qs.b + t * qs.t + h * qs.h, D, lane, qr);
#pragma unroll
  for (int i = 0; i < kNE; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  const int n_keys = causal ? t + 1 : s.seq_len;
  const T* krow = k + b * ks.b + h * ks.h;
  const T* vrow = v + b * vs.b + h * vs.h;
  for (int j = 0; j < n_keys; ++j) {
    const float sc = dot_row<kNE>(krow + j * ks.t, D, lane, qr) * scale;
    const float m_new = fmaxf(m, sc);
    const float corr = expf(m - m_new), p = expf(sc - m_new);
    l = l * corr + p;
#pragma unroll
    for (int i = 0; i < kNE; ++i) acc[i] *= corr;
    axpy_row<kNE>(vrow + j * vs.t, D, lane, p, acc);
    m = m_new;
  }
  const float lr = fmaxf(l, 1e-30f);
  T* out = o + (((long long)b * s.seq_len + t) * s.heads + h) * D;
  store_row<kNE>(out, D, lane, acc, 1.f / lr);
  if (lane == 0) lse[((long long)b * s.heads + h) * s.seq_len + t] = m + logf(lr);
}

// dQ of one query row, and its delta = dO . O for rows_dkdv_kernel
template <typename T, int kNE>
__global__ void __launch_bounds__(kThreads)
rows_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ o, const float* __restrict__ lse,
               const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
               Shape s, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
               float scale, int causal) {
  int b, h, t;
  if (!warp_row(s, b, h, t)) return;
  const int lane = threadIdx.x & 31, D = s.head_dim;
  float qr[kNE], gr[kNE], acc[kNE];
  load_row<kNE>(q + b * qs.b + t * qs.t + h * qs.h, D, lane, qr);
  load_row<kNE>(dout + b * dos.b + t * dos.t + h * dos.h, D, lane, gr);
  const float dl = dot_row<kNE>(o + b * os.b + t * os.t + h * os.h, D, lane, gr);
  const long long lrow = ((long long)b * s.heads + h) * s.seq_len + t;
  if (lane == 0) delta[lrow] = dl;
  const float lr = lse[lrow];
#pragma unroll
  for (int i = 0; i < kNE; ++i) acc[i] = 0.f;
  const int n_keys = causal ? t + 1 : s.seq_len;
  const T* krow = k + b * ks.b + h * ks.h;
  const T* vrow = v + b * vs.b + h * vs.h;
  for (int j = 0; j < n_keys; ++j) {
    const float p = expf(dot_row<kNE>(krow + j * ks.t, D, lane, qr) * scale - lr);
    const float dp = dot_row<kNE>(vrow + j * vs.t, D, lane, gr);
    axpy_row<kNE>(krow + j * ks.t, D, lane, p * (dp - dl) * scale, acc);
  }
  store_row<kNE>(dq + (((long long)b * s.seq_len + t) * s.heads + h) * D, D, lane, acc, 1.f);
}

// dK and dV of one key row, over the queries from the causal start
template <typename T, int kNE>
__global__ void __launch_bounds__(kThreads)
rows_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ lse, const T* __restrict__ dout,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 Shape s, Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                 int causal) {
  int b, h, j;
  if (!warp_row(s, b, h, j)) return;
  const int lane = threadIdx.x & 31, D = s.head_dim;
  float kr[kNE], vr[kNE], dk_acc[kNE], dv_acc[kNE];
  load_row<kNE>(k + b * ks.b + j * ks.t + h * ks.h, D, lane, kr);
  load_row<kNE>(v + b * vs.b + j * vs.t + h * vs.h, D, lane, vr);
#pragma unroll
  for (int i = 0; i < kNE; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const long long lrow = ((long long)b * s.heads + h) * s.seq_len;
  const T* qrow = q + b * qs.b + h * qs.h;
  const T* grow = dout + b * dos.b + h * dos.h;
  for (int i = causal ? j : 0; i < s.seq_len; ++i) {
    const float p = expf(dot_row<kNE>(qrow + i * qs.t, D, lane, kr) * scale - lse[lrow + i]);
    axpy_row<kNE>(grow + i * dos.t, D, lane, p, dv_acc);
    const float dp = dot_row<kNE>(grow + i * dos.t, D, lane, vr);
    axpy_row<kNE>(qrow + i * qs.t, D, lane, p * (dp - delta[lrow + i]) * scale, dk_acc);
  }
  const long long out = (((long long)b * s.seq_len + j) * s.heads + h) * D;
  store_row<kNE>(dk + out, D, lane, dk_acc, 1.f);
  store_row<kNE>(dv + out, D, lane, dv_acc, 1.f);
}

unsigned blocks(const Shape& s) {
  return (unsigned)(((long long)s.batch * s.heads * s.seq_len + kWarps - 1) / kWarps);
}

template <typename T, int kNE>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, const Shape& s,
        Strides qs, Strides ks, Strides vs, float scale, int causal, cudaStream_t stream) {
  rows_fwd_kernel<T, kNE><<<blocks(s), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, qs, ks, vs, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int kNE>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
        const void* dout, void* dq, void* dk, void* dv, void* delta, const Shape& s,
        Strides qs, Strides ks, Strides vs, Strides os, Strides dos, float scale, int causal,
        cudaStream_t stream) {
  rows_dq_kernel<T, kNE><<<blocks(s), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(delta), s, qs, ks, vs, os, dos, scale, causal);
  rows_dkdv_kernel<T, kNE><<<blocks(s), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s, qs, ks,
      vs, dos, scale, causal);
  return (int)cudaGetLastError();
}

// Elements a lane holds: D up to 256, 384 or 512. 0 = a D this route
// does not take.
int lane_elements(int head_dim) {
  if (head_dim <= 128 || head_dim > 512) return 0;
  return head_dim <= 256 ? 8 : head_dim <= 384 ? 12 : 16;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 129 to 512. q, k, v are
// [B, T, H, D] views with unit-stride D (element strides given); o is
// contiguous [B, T, H, D] in the input dtype, lse contiguous f32
// [B, H, T]. Returns 0 on success, else a CUDA error code.
int flash_rows_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                   int batch, int seq_len, int heads, int head_dim, long long q_sb,
                   long long q_st, long long q_sh, long long k_sb, long long k_st,
                   long long k_sh, long long v_sb, long long v_st, long long v_sh, float scale,
                   int causal, void* stream) {
  const Shape s{batch, seq_len, heads, head_dim};
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ne = lane_elements(head_dim);
  if (dtype == 0 && ne == 8) return fwd<float, 8>(q, k, v, o, lse, s, qs, ks, vs, scale, causal, st);
  if (dtype == 0 && ne == 12) return fwd<float, 12>(q, k, v, o, lse, s, qs, ks, vs, scale, causal, st);
  if (dtype == 0 && ne == 16) return fwd<float, 16>(q, k, v, o, lse, s, qs, ks, vs, scale, causal, st);
  using bf16 = __nv_bfloat16;
  if (dtype == 1 && ne == 8) return fwd<bf16, 8>(q, k, v, o, lse, s, qs, ks, vs, scale, causal, st);
  if (dtype == 1 && ne == 12) return fwd<bf16, 12>(q, k, v, o, lse, s, qs, ks, vs, scale, causal, st);
  if (dtype == 1 && ne == 16) return fwd<bf16, 16>(q, k, v, o, lse, s, qs, ks, vs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: q, k, v, o and dout [B, T, H, D] views (unit-stride D),
// lse f32 contiguous [B, H, T]; delta f32 [B, H, T] is scratch; dq, dk, dv
// contiguous [B, T, H, D] in the input dtype. Two kernels on the stream:
// dQ (and delta), then dK and dV.
int flash_rows_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, void* dq, void* dk, void* dv, void* delta, int dtype,
                   int batch, int seq_len, int heads, int head_dim, long long q_sb,
                   long long q_st, long long q_sh, long long k_sb, long long k_st,
                   long long k_sh, long long v_sb, long long v_st, long long v_sh,
                   long long o_sb, long long o_st, long long o_sh, long long do_sb,
                   long long do_st, long long do_sh, float scale, int causal, void* stream) {
  const Shape s{batch, seq_len, heads, head_dim};
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      os{o_sb, o_st, o_sh}, dos{do_sb, do_st, do_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ne = lane_elements(head_dim);
#define ROWS_BWD(T, NE)                                                                    \
  if (dtype == (sizeof(T) == 4 ? 0 : 1) && ne == NE)                                      \
    return bwd<T, NE>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, qs, ks, vs, os, dos, scale, \
                      causal, st);
  ROWS_BWD(float, 8)
  ROWS_BWD(float, 12)
  ROWS_BWD(float, 16)
  ROWS_BWD(__nv_bfloat16, 8)
  ROWS_BWD(__nv_bfloat16, 12)
  ROWS_BWD(__nv_bfloat16, 16)
#undef ROWS_BWD
  return (int)cudaErrorInvalidValue;
}

const char* flash_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

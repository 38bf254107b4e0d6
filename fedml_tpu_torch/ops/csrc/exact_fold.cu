// The exact aggregation fold, CUDA C++ for Hopper (sm_90a).
//
// Replaces XLA-generated code of the JAX package, not a Pallas kernel:
// `_fold_leaf` / `_fold_tree` (fedml_tpu/core/aggregation.py:201-230),
// the 3-limb Knuth two-sum fold of the streaming accumulator, and
// `exact_weighted_mean` (:233-270), the per-client term
// t = fl32(w_c * x_c) folded in client order and collapsed as
// (s0 + s1) + s2.
//
// The fold's guarantee (order independence, tree == flat bitwise)
// rests on every add being rounded on its own: a compiler that
// contracts `s + w * x` into an FMA re-introduces order dependence at
// full f32 ulp scale (the reference records the trap at :185-190).
// nvcc contracts by default (--fmad=true), so every add, subtract and
// multiply below is written with __fadd_rn, __fsub_rn and __fmul_rn,
// which nvcc never contracts or reassociates, whatever --fmad says.
//
// Both entries are bound by bytes on an H100 (3.35 TB/s): `exact_fold`
// reads and writes the three limbs and reads K terms, (6 + K) * N * 4
// bytes, for 13 * K flops an element; `exact_weighted_mean` reads the
// C client rows once and writes one row, for 14 flops a client and
// element. Each thread keeps its elements' limbs in registers across
// the K terms (or C clients) and moves 16 bytes a load where the
// operands are aligned (a grid-stride loop over groups of 4 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

// Knuth two-sum: s + e == a + b exactly under round-to-nearest, for any
// magnitudes, branch-free.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// _fold_leaf: s0, e = two_sum(s0, t); s1, e = two_sum(s1, e); s2 += e.
__device__ __forceinline__ void fold_one(float& s0, float& s1, float& s2, float t) {
  float s, e, e2;
  two_sum(s0, t, s, e);
  s0 = s;
  two_sum(s1, e, s, e2);
  s1 = s;
  s2 = __fadd_rn(s2, e2);
}

template <int W>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// limbs [3, ld_l] f32 (rows s0, s1, s2), terms [K, ld_t] f32: fold the K
// terms in index order into the limbs, in place. W = 4 needs 16-byte
// aligned bases and row strides that are multiples of 4; the ragged
// tail (n % 4 elements) runs one element a thread.
template <int W>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(float* __restrict__ limbs, long long ld_l, const float* __restrict__ terms,
                long long ld_t, int k, long long n) {
  const long long groups = n / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const long long i = g * W;
    float s0[W], s1[W], s2[W], t[W];
    Vec<W>::load(limbs + i, s0);
    Vec<W>::load(limbs + ld_l + i, s1);
    Vec<W>::load(limbs + 2 * ld_l + i, s2);
    for (int r = 0; r < k; ++r) {
      Vec<W>::load(terms + r * ld_t + i, t);
#pragma unroll
      for (int j = 0; j < W; ++j) fold_one(s0[j], s1[j], s2[j], t[j]);
    }
    Vec<W>::store(limbs + i, s0);
    Vec<W>::store(limbs + ld_l + i, s1);
    Vec<W>::store(limbs + 2 * ld_l + i, s2);
  }
  const long long tail = (long long)blockIdx.x * blockDim.x + threadIdx.x + groups * W;
  if constexpr (W > 1) {
    if (tail >= n) return;
    float s0 = limbs[tail], s1 = limbs[ld_l + tail], s2 = limbs[2 * ld_l + tail];
    for (int r = 0; r < k; ++r) fold_one(s0, s1, s2, terms[r * ld_t + tail]);
    limbs[tail] = s0, limbs[ld_l + tail] = s1, limbs[2 * ld_l + tail] = s2;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

// 4 consecutive elements of type T as one aligned load or store
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* v) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& r, float* v) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v[0] = __low2float(a), v[1] = __high2float(a), v[2] = __low2float(b), v[3] = __high2float(b);
  }
  static __device__ __forceinline__ Raw pack(const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    Raw r;
    r.x = *reinterpret_cast<const uint32_t*>(&a);
    r.y = *reinterpret_cast<const uint32_t*>(&b);
    return r;
  }
};

// x [C, ld_x] of T, w [C] f32, out [n] of T: out = (s0 + s1) + s2 of the
// terms fl32(w_c * x_c) folded in client order from zero limbs, rounded
// to T (round-to-nearest-even).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    weighted_mean_kernel(const T* __restrict__ x, long long ld_x, const float* __restrict__ w,
                         int c, T* __restrict__ out, long long n) {
  const long long groups = n / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const long long i = g * W;
    float s0[W], s1[W], s2[W], v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s0[j] = s1[j] = s2[j] = 0.f;
    for (int r = 0; r < c; ++r) {
      const float wr = __ldg(w + r);
      if constexpr (W == 4) {
        Quad<T>::unpack(*reinterpret_cast<const typename Quad<T>::Raw*>(x + r * ld_x + i), v);
      } else {
        v[0] = to_float(x[r * ld_x + i]);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) fold_one(s0[j], s1[j], s2[j], __fmul_rn(wr, v[j]));
    }
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = __fadd_rn(__fadd_rn(s0[j], s1[j]), s2[j]);
    if constexpr (W == 4) {
      *reinterpret_cast<typename Quad<T>::Raw*>(out + i) = Quad<T>::pack(v);
    } else {
      from_float(v[0], out + i);
    }
  }
  const long long tail = (long long)blockIdx.x * blockDim.x + threadIdx.x + groups * W;
  if constexpr (W > 1) {
    if (tail >= n) return;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < c; ++r) fold_one(s0, s1, s2, __fmul_rn(__ldg(w + r), to_float(x[r * ld_x + tail])));
    from_float(__fadd_rn(__fadd_rn(s0, s1), s2), out + tail);
  }
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

template <typename T>
int launch_mean(const void* x, long long ld_x, const float* w, int c, void* out, long long n,
                cudaStream_t st) {
  const bool vec = sizeof(T) == 4 ? aligned16(x) && aligned16(out) : aligned8(x) && aligned8(out);
  if (vec && ld_x % 4 == 0) {
    weighted_mean_kernel<T, 4><<<blocks_for(n / 4), kThreads, 0, st>>>(
        static_cast<const T*>(x), ld_x, w, c, static_cast<T*>(out), n);
  } else {
    weighted_mean_kernel<T, 1><<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<const T*>(x), ld_x, w, c, static_cast<T*>(out), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Fold terms [k, n] (row stride ld_t floats) in index order into limbs
// [3, n] (row stride ld_l floats), in place. Returns 0 or a CUDA error
// code of the launch.
int exact_fold(void* limbs, long long ld_l, const void* terms, long long ld_t, int k,
               long long n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(limbs);
  const float* t = static_cast<const float*>(terms);
  if (aligned16(l) && aligned16(t) && ld_l % 4 == 0 && ld_t % 4 == 0) {
    fold_kernel<4><<<blocks_for(n / 4 + 1), kThreads, 0, st>>>(l, ld_l, t, ld_t, k, n);
  } else {
    fold_kernel<1><<<blocks_for(n), kThreads, 0, st>>>(l, ld_l, t, ld_t, k, n);
  }
  return (int)cudaGetLastError();
}

// x [c, n] (row stride ld_x elements) of dtype (0 = float32, 1 =
// bfloat16), w [c] float32, out [n] of x's dtype: the exact weighted
// sum over clients. Returns 0, a CUDA error code, or -1 for a dtype it
// does not take.
int exact_weighted_mean(const void* x, long long ld_x, const void* w, int c, void* out,
                        long long n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) return launch_mean<float>(x, ld_x, wf, c, out, n, st);
  if (dtype == 1) return launch_mean<__nv_bfloat16>(x, ld_x, wf, c, out, n, st);
  return -1;
}

const char* exact_fold_error_string(int code) {
  if (code == -1) return "dtype not taken (float32 or bfloat16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

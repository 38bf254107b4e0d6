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
// One fold kernel and one entry, `exact_fold`, each call a single
// launch. It folds, in place:
// - terms [K, N] into one limb set [3, N] (a streaming accumulator's
//   fold);
// - the rows [R, N] of every edge a bitmask names of a buffer [E, R, N],
//   edge by edge in index order, into one limb set: an edge tree's root
//   merge (R = 3) and a flat fold of a group's edge terms (R = 1);
// - per edge, terms [E, N] into limbs [E, 3, N], edge e into its own
//   limbs, for the edges of a bitmask (grid y = one edge each): an edge
//   tree's folds of one group.
// Each folds its terms in the order the one-term-at-a-time fold would,
// so one launch is bitwise the folds it replaces.
//
// The fold is bound by bytes on an H100 (3.35 TB/s): it reads and writes
// the three limbs and reads K terms, (6 + K) * N * 4 bytes, for 13 * K
// f32 adds an element. Its design: one group of 4 elements a thread
// (16-byte loads), a grid that covers N at once (no grid-stride loop
// over a capped grid: the block scheduler keeps every SM full to the
// end), and a chunk of up to 4 terms loaded before its fold chain.
// `exact_weighted_mean` reads the C client rows once and writes one row,
// 4 elements of every row a thread on a capped grid: for f32 it is
// bound by bytes; for bf16, whose rows are half the bytes, its ~20
// instructions an element and row (13 adds, a multiply, the unpack,
// addressing) take about as long to issue on the card as its bytes take
// to move (PERF.md). Loading rows ahead, in chunks, two pieces a thread
// or 8 bf16 a thread measured no faster on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the weighted mean's grid cap, threads striding over the rest: ~3.5%
// less device time in bf16 than a grid covering N, ~1.3% more in f32
// (PERF.md); the fold's grid covers N
constexpr long long kMeanMaxBlocks = 4096;
// terms of the fold loaded before their fold chain
constexpr int kTermChunk = 4;

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

// W consecutive f32: one 16-byte or one 4-byte access
template <int W>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void ld(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void st(float* p, const float* v) { *p = v[0]; }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void ld(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  static __device__ __forceinline__ void st(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// bit `nth` (counting set bits from the lowest) of m
__device__ __forceinline__ int nth_set_bit(unsigned long long m, int nth) {
  for (; nth > 0; --nth) m &= m - 1;
  return __ffsll(static_cast<long long>(m)) - 1;
}

// One fold launch. The limb set [3, ld_l] sits at `limbs`, plus
// blockIdx.y's edge times `edge_l` when `per_edge`. The terms are the
// `rows` rows (stride ld_t) at terms + e * edge_t for e over the edges
// of `edges` in index order, or over blockIdx.y's edge alone when
// `per_edge`. W = 4 needs 16-byte aligned bases and strides that are
// multiples of 4; the ragged tail (n % 4 elements) runs one element a
// thread.
template <int W>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(float* __restrict__ limbs, long long ld_l, long long edge_l,
                const float* __restrict__ terms, long long ld_t, long long edge_t, int rows,
                unsigned long long edges, bool per_edge, long long n) {
  if (per_edge) {
    const int e = nth_set_bit(edges, blockIdx.y);
    limbs += e * edge_l;
    terms += e * edge_t;
    edges = 1;
  }
  const long long groups = n / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const long long i = g * W;
    float s0[W], s1[W], s2[W];
    Vec<W>::ld(limbs + i, s0);
    Vec<W>::ld(limbs + ld_l + i, s1);
    Vec<W>::ld(limbs + 2 * ld_l + i, s2);
    for (unsigned long long m = edges; m; m &= m - 1) {
      const float* base = terms + (__ffsll(static_cast<long long>(m)) - 1) * edge_t + i;
      for (int r0 = 0; r0 < rows; r0 += kTermChunk) {
        float t[kTermChunk][W];
#pragma unroll
        for (int c = 0; c < kTermChunk; ++c) {
          if (r0 + c < rows) Vec<W>::ld(base + (r0 + c) * ld_t, t[c]);
        }
#pragma unroll
        for (int c = 0; c < kTermChunk; ++c) {
          if (r0 + c < rows) {
#pragma unroll
            for (int j = 0; j < W; ++j) fold_one(s0[j], s1[j], s2[j], t[c][j]);
          }
        }
      }
    }
    Vec<W>::st(limbs + i, s0);
    Vec<W>::st(limbs + ld_l + i, s1);
    Vec<W>::st(limbs + 2 * ld_l + i, s2);
  }
  const long long tail = (long long)blockIdx.x * blockDim.x + threadIdx.x + groups * W;
  if constexpr (W > 1) {
    if (tail >= n) return;
    float s0 = limbs[tail], s1 = limbs[ld_l + tail], s2 = limbs[2 * ld_l + tail];
    for (unsigned long long m = edges; m; m &= m - 1) {
      const float* base = terms + (__ffsll(static_cast<long long>(m)) - 1) * edge_t;
      for (int r = 0; r < rows; ++r) fold_one(s0, s1, s2, base[r * ld_t + tail]);
    }
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

// Blocks that give each of `items` thread-items its own thread, at most
// `cap` (the kernels' grid-stride loops take the rest).
int blocks_for(long long items, long long cap = 0x7fffffffLL) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

int launch_fold(float* limbs, long long ld_l, long long edge_l, const float* terms,
                long long ld_t, long long edge_t, int rows, unsigned long long edges,
                bool per_edge, long long n, cudaStream_t st) {
  if (n <= 0 || edges == 0 || rows <= 0) return 0;
  const unsigned grid_y = per_edge ? (unsigned)__builtin_popcountll(edges) : 1u;
  const bool vec = aligned16(limbs) && aligned16(terms) && ld_l % 4 == 0 && ld_t % 4 == 0 &&
                   edge_l % 4 == 0 && edge_t % 4 == 0;
  if (vec) {
    fold_kernel<4><<<dim3(blocks_for(n / 4 + 1), grid_y), kThreads, 0, st>>>(
        limbs, ld_l, edge_l, terms, ld_t, edge_t, rows, edges, per_edge, n);
  } else {
    fold_kernel<1><<<dim3(blocks_for(n), grid_y), kThreads, 0, st>>>(
        limbs, ld_l, edge_l, terms, ld_t, edge_t, rows, edges, per_edge, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mean(const void* x, long long ld_x, const float* w, int c, void* out, long long n,
                cudaStream_t st) {
  const bool vec = sizeof(T) == 4 ? aligned16(x) && aligned16(out) : aligned8(x) && aligned8(out);
  if (vec && ld_x % 4 == 0) {
    weighted_mean_kernel<T, 4><<<blocks_for(n / 4, kMeanMaxBlocks), kThreads, 0, st>>>(
        static_cast<const T*>(x), ld_x, w, c, static_cast<T*>(out), n);
  } else {
    weighted_mean_kernel<T, 1><<<blocks_for(n, kMeanMaxBlocks), kThreads, 0, st>>>(
        static_cast<const T*>(x), ld_x, w, c, static_cast<T*>(out), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One fold launch, in place, of f32 rows with n elements. Without
// `per_edge`: into the limb set [3, n] at `limbs` (row stride ld_l
// floats), the `rows` rows (row stride ld_t floats) at terms + e *
// edge_t of every edge e whose bit is set in `edges`, edges in index
// order and rows in order within an edge (one limb set += terms [K, n]
// is edges = 1, rows = K). With `per_edge`: for every edge e of
// `edges`, its rows at terms + e * edge_t into its own limb set at
// limbs + e * edge_l; the other edges' limbs are not touched (one grid
// row an edge). Returns 0 or a CUDA error code of the launch.
int exact_fold(void* limbs, long long edge_l, long long ld_l, const void* terms,
               long long edge_t, long long ld_t, int rows, unsigned long long edges,
               int per_edge, long long n, void* stream) {
  return launch_fold(static_cast<float*>(limbs), ld_l, edge_l, static_cast<const float*>(terms),
                     ld_t, edge_t, rows, edges, per_edge != 0, n,
                     static_cast<cudaStream_t>(stream));
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

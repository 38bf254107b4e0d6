// K3, the robust aggregation term, CUDA C++ for Hopper (sm_90a).
//
// Replaces XLA-generated code of the JAX package, not a Pallas kernel:
// the clip of `RobustAggregator.clip_updates`
// (fedml_tpu/core/aggregation.py:709-720) and the six per-upload terms
// `_weighted_term_encoded` ... `_weighted_delta_term_decoded_clipped`
// (:281-406). All of them are one elementwise formula over the flat
// layout of a model's leaves, one row an upload:
//
//   out[r, i] = w_r * (base_i + src[r, i] * s_r)
//
// - src is an f32 delta (the clip's theta - g, laid out by the caller as
//   it flattens the cohort, which also takes its norm; or a decoded
//   top-k payload), or q * scale of the element's leaf (int8 uploads: one
//   f32 scale a leaf, found from the leaves' offsets in the flat layout,
//   so a launch covers every leaf);
// - base is g or nothing (delta-only terms);
// - s_r = min(1, bound / max(||delta_r||, 1e-12)) or nothing (unclipped);
// - w_r is the upload's weight or nothing (the stacked clip).
// The norms are not computed here: the caller's torch reduction makes
// s_r on the card, the same code for this kernel and its plain version.
//
// The reference keeps every multiply out of the add-only exact fold
// (:168-189); the fold then rests on each term being a pure function of
// its upload. This kernel's result must be bitwise its plain version's
// (eager torch ops, each rounded on its own), so no step may be
// contracted: nvcc turns a*b + c into an FMA by default (--fmad=true),
// and every step below is __fmul_rn or __fadd_rn, in the plain version's
// order: d (or q * scale); d * s; g + .; w * .
//
// Bound: bytes on an H100 (3.35 TB/s). Each row reads its source (4 B
// an element, 1 B for int8) and writes 4 B; g is read once per row but
// counts once (L2 keeps it for the rows that follow). Design (first
// version, right before fast): one grid row a row of the upload set,
// 4 elements a thread with 16-byte f32 loads and 4-byte int8 loads (the
// wrapper hands over rows on 16-byte boundaries), one leaf search a
// 4-element group; the ragged tail (n % 4 elements) one a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535;

enum Src { kF32 = 1, kInt8 = 2 };

// the leaf of element i: offsets[l] <= i < offsets[l + 1]
__device__ __forceinline__ int leaf_of(const long long* __restrict__ offsets, int leaves,
                                       long long i) {
  int lo = 0, hi = leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offsets + mid) <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct Row {
  const float* s;  // [rows] or null
  const float* w;  // [rows] or null
  bool base;
};

__device__ __forceinline__ float term(float d, float gv, float sr, float wr, const Row& f) {
  if (f.s) d = __fmul_rn(d, sr);
  if (f.base) d = __fadd_rn(gv, d);
  if (f.w) d = __fmul_rn(wr, d);
  return d;
}

template <int SRC>
__global__ void __launch_bounds__(kThreads)
    robust_term_kernel(const void* __restrict__ src, long long ld_src,
                       const float* __restrict__ g, const long long* __restrict__ offsets,
                       const float* __restrict__ scales, int leaves, Row f,
                       float* __restrict__ out, long long ld_out, int rows, long long n) {
  const long long groups = n / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float sr = f.s ? __ldg(f.s + r) : 1.f;
    const float wr = f.w ? __ldg(f.w + r) : 1.f;
    float* o = out + r * ld_out;
    if (t < groups) {
      const long long i = t * 4;
      float d[4], gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (f.base) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(g + i));
        gv[0] = q.x, gv[1] = q.y, gv[2] = q.z, gv[3] = q.w;
      }
      if constexpr (SRC == kInt8) {
        const char4 c = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(src) +
                                                        r * ld_src + i);
        const int8_t v[4] = {c.x, c.y, c.z, c.w};
        int l = leaf_of(offsets, leaves, i);
        const float* sc = scales + (long long)r * leaves;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          while (i + j >= __ldg(offsets + l + 1)) ++l;
          d[j] = __fmul_rn(static_cast<float>(v[j]), __ldg(sc + l));
        }
      } else {
        const float4 q = *reinterpret_cast<const float4*>(static_cast<const float*>(src) +
                                                          r * ld_src + i);
        d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = term(d[j], gv[j], sr, wr, f);
      *reinterpret_cast<float4*>(o + i) = make_float4(d[0], d[1], d[2], d[3]);
    }
    // the ragged tail, n % 4 elements, one a thread
    const long long i = groups * 4 + t;
    if (t < n - groups * 4) {
      const float gv = f.base ? g[i] : 0.f;
      float d;
      if constexpr (SRC == kInt8) {
        const int8_t q = static_cast<const int8_t*>(src)[r * ld_src + i];
        d = __fmul_rn(static_cast<float>(q),
                      scales[(long long)r * leaves + leaf_of(offsets, leaves, i)]);
      } else {
        d = static_cast<const float*>(src)[r * ld_src + i];
      }
      o[i] = term(d, gv, sr, wr, f);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// out [rows, n] f32 (row stride ld_out) = w_r * (base + src_r * s_r), as
// the header says. src_kind: 1 = src is an f32 delta; 2 = src is int8 q
// with leaf l's scale at scales[r * leaves + l] and leaf l spanning
// [offsets[l], offsets[l+1]). g [n] f32 is read only with has_base; s
// and w are [rows] f32 or null. Every row of src, out and g starts on a
// 16-byte boundary (4 for int8 src; the row stride counts only when rows
// > 1). Returns 0, a CUDA error code, or a negative code for arguments
// it does not take.
int robust_term(const void* src, long long ld_src, int src_kind, const void* g, int has_base,
                const void* offsets, const void* scales, int leaves, const void* s,
                const void* w, void* out, long long ld_out, int rows, long long n,
                void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (src_kind != kF32 && src_kind != kInt8) return -1;
  if (has_base && g == nullptr) return -2;
  if (src_kind == kInt8 && (offsets == nullptr || scales == nullptr || leaves < 1)) return -3;
  const bool int8 = src_kind == kInt8;
  if (!aligned(src, int8 ? 4 : 16) || !aligned(out, 16) || (has_base && !aligned(g, 16)) ||
      (rows > 1 && (ld_src % 4 != 0 || ld_out % 4 != 0)))
    return -4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Row f{static_cast<const float*>(s), static_cast<const float*>(w), has_base != 0};
  const unsigned grid_y = rows < (int)kMaxGridY ? (unsigned)rows : kMaxGridY;
  const long long items = n / 4 > n % 4 ? n / 4 : n % 4;
  const dim3 grid((unsigned)((items + kThreads - 1) / kThreads), grid_y);
  const float* gf = static_cast<const float*>(g);
  const long long* off = static_cast<const long long*>(offsets);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (int8)
    robust_term_kernel<kInt8><<<grid, kThreads, 0, st>>>(src, ld_src, gf, off, sc, leaves, f, o,
                                                         ld_out, rows, n);
  else
    robust_term_kernel<kF32><<<grid, kThreads, 0, st>>>(src, ld_src, gf, off, sc, leaves, f, o,
                                                        ld_out, rows, n);
  return (int)cudaGetLastError();
}

const char* robust_term_error_string(int code) {
  if (code == -1) return "source kind not taken (1 f32 delta, 2 int8)";
  if (code == -2) return "g missing for a term with base";
  if (code == -3) return "int8 source without leaf offsets and scales";
  if (code == -4) return "rows not on 16-byte boundaries (4 for an int8 source)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

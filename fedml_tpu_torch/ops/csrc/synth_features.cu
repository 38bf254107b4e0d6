// Per-client keyed synthetic features, CUDA C++ for Hopper (sm_90a).
//
// Replaces XLA-generated code of the JAX package, not a Pallas kernel:
// `_gen_per_client_impl` behind
// `synthetic_classification_device_per_client`
// (fedml_tpu/data/synthetic.py:150-225), which draws each row of a
// registry cohort group's features as means[y] + sigma * noise, the
// noise keyed by (client seed, sample index) so that a client's
// features do not depend on its slot, its group's shape or its cohort.
//
// The port keys its own stream (the bits are not jax's threefry):
// element d of sample s of client c is
//   Philox4x32-10(key = (seed[c], 0), counter = (s, d / 4, 0, 0))
// -> 4 words -> two Box-Muller pairs -> 4 normals, of which word pair
// (0, 1) gives dims 4j, 4j + 1 and pair (2, 3) dims 4j + 2, 4j + 3:
//   u = ((a >> 8) + 1) * 2^-24 in (0, 1], v = (b >> 8) * 2^-24 in [0, 1),
//   r = sqrt(-2 ln u), n = (r cos 2 pi v, r sin 2 pi v).
// Every float operation is written rounded on its own (no FMA), as the
// plain PyTorch version computes it op by op.
//
// What bounds it. One launch writes a group's [C, S, dim] features: at
// the planet path's [4096, 128, 60] f32 that is 126 MB, 0.038 ms at the
// H100's 3.35 TB/s, against 7.9 M Philox blocks of 4 outputs. So the
// instructions a block costs decide whether the bytes can bound it: at
// the card's issue rate (132 SMs x 4 warp-instructions a clock at its
// 1.98 GHz maximum) the 0.038 ms leaves ~165 instructions a block. The
// first design ran at 33% of the bound. In its SASS (`sass_count.py`,
// f32 with 4-wide stores) the loop that makes one Philox block is 614
// instructions and the routines it calls 105 more, slow paths included
// (this design: 484 and 21); what it spent beyond the arithmetic:
// - three 64-bit integer divisions or remainders a block (the item's
//   dim block, its row, the row's client): each a called software
//   routine of dozens of instructions;
// - sinf and cosf of one angle, each with its own range reduction and
//   the slow path's stack frame;
// - the label read as int64 once per block of 4 outputs, by a grid-stride
//   loop over a 64-bit item index capped at 8,192 blocks.
// This design: a block is (G, 256 / G) threads, G = min(dim blocks, 256);
// threadIdx.y picks one (client, sample) row and rows run on gridDim.x
// (up to 2^31 - 1 rows: the planet group's 524,288 rows are past
// gridDim.y's 65,535), so a thread's dim block is its threadIdx.x and no
// division is left but the row's client, one 32-bit multiply-high by a
// constant the host computes (`RowDiv`). The row's seed and label are
// read once a row (one broadcast transaction a warp), both as the int64
// the path holds them in (the seed's low 32 bits are its key, so the
// wrapper launches nothing to convert them), and the Box-Muller
// pair's sine and cosine come from one `sincosf`: one range reduction,
// and no stack frame (the first design's sinf and cosf kept 32 bytes).
// What is left a block is the arithmetic itself: 10 Philox rounds, two
// logf, two sqrtf and two sincosf, whose slow paths (never taken at
// these arguments) the static count still holds.
// Philox keeps its words bitwise (the keyed stream is what keeps a tree
// fold equal to the flat one and a resumed run equal to the straight
// one), and the features keep the plain version's formula.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// n / s for n < 2^31 by a multiply-high: q = (umulhi(m, n) + n) >> l with
// l = ceil(log2 s) and m = floor(2^32 (2^l - s) / s) + 1 (computed on the
// host; the sum stays below 2^32 because umulhi(m, n) <= n < 2^31)
struct RowDiv {
  uint32_t m;
  int l;
  uint32_t s;
};

RowDiv row_div(uint32_t s) {
  int l = 0;
  while ((1ull << l) < s) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - s)) / s + 1;
  return RowDiv{(uint32_t)m, l, s};
}

// (client, sample) of a row of the [C * S] rows
__device__ __forceinline__ void row_split(uint32_t row, RowDiv d, uint32_t& ci, uint32_t& si) {
  ci = (__umulhi(d.m, row) + row) >> d.l;
  si = row - ci * d.s;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& n0, float& n1) {
  const float u = __fmul_rn((float)((a >> 8) + 1u), 5.9604644775390625e-08f);  // 2^-24
  const float v = __fmul_rn((float)(b >> 8), 5.9604644775390625e-08f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u)));
  float sn, cs;
  sincosf(__fmul_rn(6.28318530717958647692f, v), &sn, &cs);  // one range reduction
  n0 = __fmul_rn(r, cs);
  n1 = __fmul_rn(r, sn);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&a);
  r.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// y [rows] int64 labels (rows = C x S, client-major), means [classes,
// dim] f32, seeds [C] int64 (the key is the low 32 bits), out [rows,
// dim] of T. Thread (x, y) of
// block bx makes row bx * blockDim.y + y, dim blocks x, x + blockDim.x,
// ... VEC: dim % 4 == 0 and out aligned for a 4-wide store.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    synth_kernel(const long long* __restrict__ y, const float* __restrict__ means,
                 const long long* __restrict__ seeds, float sigma, T* __restrict__ out, RowDiv rd,
                 int rows, int dim) {
  const uint32_t row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= (uint32_t)rows) return;
  uint32_t ci, si;
  row_split(row, rd, ci, si);
  const uint32_t key = (uint32_t)__ldg(seeds + ci);
  const float* m = means + __ldg(y + row) * dim;
  T* o = out + (size_t)row * dim;
  const int blocks4 = (dim + 3) >> 2;
  for (int j = threadIdx.x; j < blocks4; j += blockDim.x) {
    const uint4 w = philox4x32_10(make_uint4(si, (uint32_t)j, 0u, 0u), key, 0u);
    float v[4];
    box_muller(w.x, w.y, v[0], v[1]);
    box_muller(w.z, w.w, v[2], v[3]);
    if constexpr (VEC) {
      float mv[4];
      load4(m + 4 * j, mv);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fadd_rn(mv[k], __fmul_rn(sigma, v[k]));
      store4(o + 4 * j, v);
    } else {
      for (int k = 0; k < 4 && 4 * j + k < dim; ++k)
        store(o + 4 * j + k, __fadd_rn(__ldg(m + 4 * j + k), __fmul_rn(sigma, v[k])));
    }
  }
}

// the raw Philox words of every (client, sample, block of 4 dims), with
// synth_kernel's grid
__global__ void __launch_bounds__(kThreads)
    words_kernel(const long long* __restrict__ seeds, uint4* __restrict__ out, RowDiv rd,
                 int rows, int blocks4) {
  const uint32_t row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= (uint32_t)rows) return;
  uint32_t ci, si;
  row_split(row, rd, ci, si);
  const uint32_t key = (uint32_t)__ldg(seeds + ci);
  for (int j = threadIdx.x; j < blocks4; j += blockDim.x)
    out[(size_t)row * blocks4 + j] = philox4x32_10(make_uint4(si, (uint32_t)j, 0u, 0u), key, 0u);
}

// Error codes beside cudaError_t's (which are >= 0)
constexpr int kErrDtype = -1;
constexpr int kErrShape = -2;

// The launch shape for rows of `blocks4` dim blocks: G threads a row,
// kThreads / G rows a block, rows on gridDim.x. Returns false past the
// limits: rows up to 2^31 - 1, at least one dim block.
bool grid_for(long long rows, int blocks4, dim3& grid, dim3& block) {
  if (rows < 1 || rows > 0x7fffffffLL || blocks4 < 1) return false;
  const int g = blocks4 < kThreads ? blocks4 : kThreads;
  block = dim3(g, kThreads / g);
  grid = dim3((unsigned)((rows + block.y - 1) / block.y));
  return true;
}

template <typename T>
int launch(const void* y, const void* means, const void* seeds, float sigma, void* out, int c,
           long long s, int dim, cudaStream_t st) {
  const long long rows = (long long)c * s;
  dim3 grid, block;
  if (s < 1 || !grid_for(rows, (dim + 3) / 4, grid, block)) return kErrShape;
  const size_t align = 4 * sizeof(T);
  const bool vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(out) % align == 0 &&
                   reinterpret_cast<uintptr_t>(means) % 16 == 0;
  const auto* yy = static_cast<const long long*>(y);
  const auto* mm = static_cast<const float*>(means);
  const auto* ss = static_cast<const long long*>(seeds);
  const RowDiv rd = row_div((uint32_t)s);
  if (vec) {
    synth_kernel<T, true><<<grid, block, 0, st>>>(yy, mm, ss, sigma, static_cast<T*>(out), rd,
                                                  (int)rows, dim);
  } else {
    synth_kernel<T, false><<<grid, block, 0, st>>>(yy, mm, ss, sigma, static_cast<T*>(out), rd,
                                                   (int)rows, dim);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y [c, s] int64, means [classes, dim] float32, seeds [c] int64, out
// [c, s, dim] of dtype (0 = float32, 1 = bfloat16), all contiguous; c * s
// at most 2^31 - 1 rows. Returns 0, a CUDA error code, or kErrDtype /
// kErrShape for a dtype or a shape it does not take.
int synth_features(const void* y, const void* means, const void* seeds, float sigma, void* out,
                   int c, long long s, int dim, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(y, means, seeds, sigma, out, c, s, dim, st);
  if (dtype == 1) return launch<__nv_bfloat16>(y, means, seeds, sigma, out, c, s, dim, st);
  return kErrDtype;
}

// out [c, s, blocks4, 4] uint32: the Philox words synth_features draws.
int synth_philox_words(const void* seeds, void* out, int c, long long s, int blocks4,
                       void* stream) {
  const long long rows = (long long)c * s;
  dim3 grid, block;
  if (s < 1 || !grid_for(rows, blocks4, grid, block)) return kErrShape;
  words_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seeds), static_cast<uint4*>(out), row_div((uint32_t)s),
      (int)rows, blocks4);
  return (int)cudaGetLastError();
}

const char* synth_features_error_string(int code) {
  if (code == kErrDtype) return "dtype not taken (float32 or bfloat16)";
  if (code == kErrShape) return "shape not taken (1 to 2^31 - 1 rows of at least one dim)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
